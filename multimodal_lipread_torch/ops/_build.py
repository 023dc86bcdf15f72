"""Build and load the port's CUDA kernels: plain ``nvcc`` and ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` interface and is
compiled, at first use, into ``build/torch_kernels/lib<name>-<hash>.so``
under the checkout's root with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib> csrc/<name>.cu

The file name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded. A build writes to a
temporary name and renames it into place, so processes that build at once
do not see half-written files, and nothing waits on a lock. The build runs
under a ``subprocess`` timeout. PyTorch's extension builder is not used: it
includes PyTorch's headers and needs ``ninja``, and takes minutes where this
takes seconds.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 300
# every kernel source under csrc/, by name
KERNELS = ("logmel", "crop_resize")


@dataclasses.dataclass
class BuildResult:
    """One kernel library: where it is, how long its build took (0.0 when
    it was already built) and what ``nvcc`` printed."""

    name: str
    path: Path
    seconds: float
    log: str

    def ptxas_lines(self) -> List[str]:
        """The ``-Xptxas -v`` report: registers, shared memory, spills."""
        keys = ("registers", "smem", "spill", "Compiling entry")
        return [ln.strip() for ln in self.log.splitlines() if any(k in ln for k in keys)]


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``
    or ``nvcc`` on ``PATH``."""
    candidates = [
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc") if os.environ.get("CUDA_HOME") else None,
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH): "
        "the port's CUDA kernels are built with the CUDA toolkit on the machine with the card"
    )


def source_path(name: str) -> Path:
    path = CSRC_DIR / f"{name}.cu"
    if not path.is_file():
        raise FileNotFoundError(f"no kernel source {path}")
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its content and flags."""
    digest = hashlib.sha256(source_path(name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(source_path(name))]


def build_all(names: Iterable[str], timeout: float = BUILD_TIMEOUT_S) -> Dict[str, BuildResult]:
    """Build every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Raises if any build fails or times out."""
    names = list(names)
    results: Dict[str, BuildResult] = {}
    pending = []
    for name in names:
        path = library_path(name)
        if path.is_file():
            results[name] = BuildResult(name, path, 0.0, "")
        else:
            pending.append((name, path))
    if not pending:
        return results
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for name, path in pending:
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            nvcc_command(nvcc, name, tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        procs.append((name, path, tmp, proc))
    failures = []
    for name, path, tmp, proc in procs:
        remaining = max(1.0, timeout - (time.perf_counter() - t0))
        try:
            log, _ = proc.communicate(timeout=remaining)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            failures.append(f"{name}: nvcc timed out after {timeout:.0f} s")
            continue
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, path)
        results[name] = BuildResult(name, path, seconds, log)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, building it first if need be."""
    return ctypes.CDLL(str(build_all([name])[name].path))
