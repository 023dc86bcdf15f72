"""The native host-IO library (counterpart of the JAX package's
``data/native_io.py``): the threaded WAV decoder (:func:`load_wav_batch`),
the threaded uint8 ``.npy`` loader (:func:`load_npy_u8_batch`) and the
in-order background prefetcher that streams a dataset
(:class:`NativePrefetcher`, under ``data/grain_loader.NativeStreamingDataset``).

The decoder is the repo's ``native/mlt_io.cpp``, read as it is: at first use
it is compiled with

    g++ -O3 -std=c++17 -fPIC -pthread -shared -o <lib> native/mlt_io.cpp

into ``build/native/libmlt_io-<hash>.so`` under the checkout's root (the
hash covers the source and the flags, so an edited source is rebuilt and a
stale library never loaded; the build writes a temporary name and renames
it into place) and bound with ``ctypes``. Nothing is written into
``native/``. If the library cannot be built or loaded, :func:`get_lib`
raises: there is no quiet switch to the Python decoder. Per file, a WAV
that is not plain PCM16 at the expected rate, or a ``.npy`` that is not a
C-ordered uint8 array of the expected size, is reported back to the caller
(``pipelines.common.decode_waveforms`` sends it to the Python path; the
prefetcher's :attr:`NativePrefetcher.first_error` names it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

REPO_DIR = Path(__file__).resolve().parents[2]
SOURCE = REPO_DIR / "native" / "mlt_io.cpp"
BUILD_DIR = REPO_DIR / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
BUILD_TIMEOUT_S = 300
# native/mlt_io.cpp::mlt_io_version() of the source this binding declares
EXPECTED_VERSION = 3
DEFAULT_THREADS = min(16, os.cpu_count() or 4)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def compiler() -> str:
    """``$CXX``, else ``g++`` on ``PATH``."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (set CXX or put g++ on PATH) to build native/mlt_io.cpp")
    return cxx


def library_path(source: Optional[Path] = None) -> Path:
    """Where ``source`` (default ``native/mlt_io.cpp``) builds to, keyed by
    its content and the flags."""
    source = source or SOURCE
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libmlt_io-{digest.hexdigest()[:12]}.so"


def build(source: Optional[Path] = None, timeout: float = BUILD_TIMEOUT_S) -> Path:
    """Compile ``source`` (default ``native/mlt_io.cpp``) unless it is built
    already; returns the library. Raises ``RuntimeError`` with the
    compiler's output when the build fails."""
    source = source or SOURCE
    path = library_path(source)
    if path.is_file():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"building {source} timed out after {timeout:.0f} s") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {source} failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _bind(lib: ctypes.CDLL) -> None:
    lib.mlt_io_version.restype = ctypes.c_int
    lib.mlt_io_version.argtypes = []
    lib.mlt_load_wav_batch.restype = ctypes.c_longlong
    lib.mlt_load_wav_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.mlt_load_npy_u8_batch.restype = ctypes.c_longlong
    lib.mlt_load_npy_u8_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_float, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.mlt_prefetch_create.restype = ctypes.c_void_p
    lib.mlt_prefetch_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ]
    lib.mlt_prefetch_start.restype = None
    lib.mlt_prefetch_start.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong]
    lib.mlt_prefetch_next.restype = ctypes.c_longlong
    lib.mlt_prefetch_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
    lib.mlt_prefetch_first_error.restype = ctypes.c_longlong
    lib.mlt_prefetch_first_error.argtypes = [ctypes.c_void_p]
    lib.mlt_prefetch_destroy.restype = None
    lib.mlt_prefetch_destroy.argtypes = [ctypes.c_void_p]


def get_lib() -> ctypes.CDLL:
    """The native library, built and loaded at first use; raises if it
    cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            version = lib.mlt_io_version()
            if version != EXPECTED_VERSION:
                raise RuntimeError(f"{SOURCE}: mlt_io_version {version}, this binding expects {EXPECTED_VERSION}")
            _lib = lib
        return _lib


def load_wav_batch(
    paths: Sequence[str],
    target_samples: int = 20000,
    sample_rate: int = 16000,
    n_threads: int = DEFAULT_THREADS,
) -> Tuple[np.ndarray, int]:
    """Threaded decode of PCM16 WAVs → ``(waves, failed)``: waves
    (N, target_samples) float32 in int16 range, zero-padded or truncated,
    and the index of a file that is not a plain PCM16 WAV at
    ``sample_rate`` (the first the threads met; every failed file's row is
    zeros), or -1 when every file decoded."""
    lib = get_lib()
    out = np.empty((len(paths), target_samples), np.float32)
    if not paths:
        return out, -1
    status = lib.mlt_load_wav_batch(
        _paths_array(paths), len(paths), target_samples, sample_rate,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads,
    )
    return out, int(status) - 1


def load_npy_u8_batch(
    paths: Sequence[str],
    shape: Sequence[int],
    scale: float = 1.0 / 255.0,
    n_threads: int = DEFAULT_THREADS,
) -> Tuple[np.ndarray, int]:
    """Threaded load of uint8 ``.npy`` files → ``(arrays, failed)``: the
    arrays (N, *shape) as float32 times ``scale`` (with ``scale=1.0`` the
    uint8 values exactly), and the index of a file that is not a C-ordered
    uint8 array of ``prod(shape)`` elements (the first the threads met;
    every failed file's row is zeros), or -1 when every file loaded."""
    lib = get_lib()
    elems = int(np.prod(shape))
    out = np.empty((len(paths), elems), np.float32)
    if not paths:
        return out.reshape((0,) + tuple(shape)), -1
    status = lib.mlt_load_npy_u8_batch(
        _paths_array(paths), len(paths), elems, scale,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads,
    )
    return out.reshape((len(paths),) + tuple(shape)), int(status) - 1


class NativePrefetcher:
    """In-order background prefetcher over a fixed file list (the C++
    thread pool and bounded ring of ``native/mlt_io.cpp``).

    One per dataset split. Each epoch, :meth:`start_epoch` takes the
    (shuffled, sharded) index order, then :meth:`next_batch` is drained
    until it returns ``None``. A failed read is zero-filled and reported by
    :attr:`first_error`, which the caller checks.

    ``kind='npy_u8'``: raw uint8 ``.npy`` records of ``record_shape``;
    ``kind='wav'``: float32 waveforms of ``record_shape=(samples,)`` from
    PCM16 WAVs at ``sample_rate`` (channels averaged)."""

    def __init__(
        self,
        paths: Sequence[str],
        kind: str,
        record_shape: Sequence[int],
        sample_rate: int = 16000,
        capacity: int = 256,
        n_threads: int = DEFAULT_THREADS,
    ):
        if kind not in ("npy_u8", "wav"):
            raise ValueError(f"unknown prefetch kind: {kind!r}")
        self._lib = get_lib()
        self.kind = kind
        self.record_shape = tuple(int(s) for s in record_shape)
        self.dtype = np.uint8 if kind == "npy_u8" else np.float32
        # every C call on the handle holds this lock: close() must not free
        # the prefetcher while another thread is inside next_batch
        self._op_lock = threading.Lock()
        # the C side copies the paths during create
        self._handle = self._lib.mlt_prefetch_create(
            _paths_array(paths), len(paths), 0 if kind == "npy_u8" else 1,
            int(np.prod(self.record_shape)), sample_rate, capacity, n_threads,
        )
        if not self._handle:
            raise RuntimeError(f"mlt_prefetch_create failed for {len(paths)} files")
        self.n_files = len(paths)

    def _require_handle(self) -> int:
        if not self._handle:
            raise RuntimeError("NativePrefetcher is closed")
        return self._handle

    def start_epoch(self, order: np.ndarray) -> None:
        """Begin an epoch that reads ``paths[order[0]], paths[order[1]], ...``."""
        order = np.ascontiguousarray(order, np.int64)
        # the C workers index the paths without a bounds check
        if order.size and (order.min() < 0 or order.max() >= self.n_files):
            raise ValueError(f"epoch order indices must be in [0, {self.n_files}); got "
                             f"range [{order.min()}, {order.max()}]")
        with self._op_lock:
            self._lib.mlt_prefetch_start(
                self._require_handle(), order.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), order.size,
            )

    def next_batch(self, k: int) -> Optional[np.ndarray]:
        """The next ≤ ``k`` records in epoch order; ``None`` when the epoch is done."""
        out = np.empty((k,) + self.record_shape, self.dtype)
        with self._op_lock:
            got = self._lib.mlt_prefetch_next(self._require_handle(), out.ctypes.data_as(ctypes.c_void_p), k)
        return out[:got] if got else None

    @property
    def first_error(self) -> int:
        """Index (into the paths) of the first failed read this epoch, or -1."""
        with self._op_lock:
            return int(self._lib.mlt_prefetch_first_error(self._require_handle()))

    def close(self) -> None:
        with self._op_lock:
            if self._handle:
                self._lib.mlt_prefetch_destroy(self._handle)
                self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()


def _paths_array(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
