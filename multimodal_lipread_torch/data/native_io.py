"""The threaded native WAV decoder (counterpart of the JAX package's
``data/native_io.py``, for its ``load_wav_batch``).

The decoder is the repo's ``native/mlt_io.cpp``, read as it is: at first use
it is compiled with

    g++ -O3 -std=c++17 -fPIC -pthread -shared -o <lib> native/mlt_io.cpp

into ``build/native/libmlt_io-<hash>.so`` under the checkout's root (the
hash covers the source and the flags, so an edited source is rebuilt and a
stale library never loaded; the build writes a temporary name and renames
it into place) and bound with ``ctypes``. Nothing is written into
``native/``. If the library cannot be built or loaded, :func:`get_lib`
raises: there is no quiet switch to the Python decoder. Per file, a WAV
that is not plain PCM16 at the expected rate is reported back to the caller
(``pipelines.common.decode_waveforms`` sends it to the Python path).
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
    arr = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
    status = lib.mlt_load_wav_batch(
        arr, len(paths), target_samples, sample_rate,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads,
    )
    return out, int(status) - 1
