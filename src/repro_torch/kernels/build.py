"""Build and bind the port's hand-written CUDA kernels.

Each kernel source under ``kernels/*/csrc/*.cu`` exports plain-C launch
functions. A `CudaSource` compiles its file with ``nvcc`` for ``sm_90a``
into a shared library under ``build/kernels/`` at the repository root
(first use only; the file name carries a hash of the source, so an
edited source rebuilds) and loads it with `ctypes`; a `CudaKernel` calls
one entry point of it. Nothing is built when a module is imported:
CPU-only hosts import every module of the port and never reach
`CudaKernel.__call__`.

Conventions every entry point follows: pointers and the stream are
``void*`` (bound as `ctypes.c_void_p`, so 64-bit addresses survive),
integers ``int``, the launch goes on the caller's stream, the kernel
allocates nothing, and the function returns ``cudaGetLastError()`` —
a refused launch (too many threads, too much shared memory) is raised
here, right after the call, instead of surfacing at a later sync.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """Path of nvcc (PATH, then $CUDA_HOME, then /usr/local/cuda);
    raises when the toolkit is absent — the port has no fallback."""
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


class CudaSource:
    """One ``.cu`` source, built with nvcc into one shared library at
    first use and loaded once; every `CudaKernel` of the source shares
    it, so each source builds once per process."""

    def __init__(self, path: Path) -> None:
        self.path = Path(path)
        self.build_log = ""
        self._lib = None
        self._lock = threading.RLock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.path.read_bytes()).hexdigest()[:12]
        return BUILD_DIR / f"{self.path.stem}-{digest}.so"

    def build(self) -> Path:
        """Compile the source if its library is not built yet (safe to
        call from several threads; one nvcc per source). Returns the
        library path; raises with nvcc's output when the build fails."""
        with self._lock:
            out = self.library_path()
            if out.exists():
                return out
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(".tmp%d.so" % os.getpid())
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.path)]
            r = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError("nvcc failed for %s:\n%s"
                                   % (self.path, self.build_log))
            os.replace(tmp, out)
            return out

    def library(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:       # kept: the library stays mapped
                self._lib = ctypes.CDLL(str(self.build()))
            return self._lib


class CudaKernel:
    """One C entry point of a `CudaSource`, bound lazily.

    `launches` counts successful launches through `__call__` — the only
    place the kernel is launched — so a caller can zero it, run a path
    and read whether the path went through the kernel."""

    def __init__(self, source: CudaSource, symbol: str,
                 argtypes: Sequence[type]) -> None:
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            fn = getattr(self.source.library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        err = self._load()(*args)
        if err != 0:
            raise RuntimeError("%s launch failed: cudaError %d"
                               % (self.symbol, err))
        self.launches += 1


class LaunchCount:
    """The launch count of a wrapper that launches another entry point's
    kernel (each such launch counts there too): the wrapper adds one
    right after that kernel's launch returns."""

    def __init__(self) -> None:
        self.launches = 0


def stream_handle(device) -> Optional[int]:
    """Raw handle of the current CUDA stream on `device` (a Python int
    for the ``void*`` stream argument)."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
