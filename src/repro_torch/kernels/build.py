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
from typing import Sequence

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


# every launch counter of the process (`CudaKernel`, `LaunchCount`), in
# creation order: a CUDA graph's capture moves them without launching
# and its replays launch without moving them, so the graph accounts for
# both (`serving.step_graph`)
LAUNCH_COUNTERS: list = []


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
        LAUNCH_COUNTERS.append(self)

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
        LAUNCH_COUNTERS.append(self)


SPLIT_TILE = 32      # keys per tile of the split-KV kernels (decode_attn.cu
                     # TS, flash_prefill.cu VK): a split is whole tiles
CTAS_PER_SM = 4      # the split count aims at this many CTAs an SM
SPLIT_MAX = 64       # their merges hold at most this many splits


def decode_splits(B: int, Hkv: int, n_keys: int, n_sm: int):
    """Split of a key axis of `n_keys` keys for the split-KV kernels
    (decode attention, with B sequences; speculative verify, with B
    sequences x row tiles): (n_split, split_len). As many splits as keep
    B*Hkv*n_split CTAs within one wave of CTAS_PER_SM on each of `n_sm`
    SMs (a second, partial wave would double the time), each split a
    whole number of SPLIT_TILE-key tiles, at most SPLIT_MAX; the splits
    cover [0, n_keys) and none is empty (a cache of one tile or less gets
    one split). The launchers refuse a split_len that is not whole tiles
    or more than SPLIT_MAX splits."""
    want = min(SPLIT_MAX, max(1, CTAS_PER_SM * n_sm // (B * Hkv)))
    per = max(SPLIT_TILE, -(-n_keys // want))
    per = -(-per // SPLIT_TILE) * SPLIT_TILE
    return -(-n_keys // per), per


def _device_index(device) -> int:
    import torch
    return device.index if device.index is not None \
        else torch.cuda.current_device()


_SM_COUNT: dict = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of the CUDA `device` (read once per
    device): the split-KV kernels size their grids to one wave of it."""
    import torch
    idx = _device_index(device)
    n = _SM_COUNT.get(idx)
    if n is None:
        n = _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


class ShapePlans:
    """A wrapper's launch constants per operand shape: `plans(key, *args)`
    returns `make(*args)` as made at the first call with `key` (checks
    run there, once) and kept. A plan holds host constants only — grid,
    offsets, int arguments, no device memory — so nothing is evicted: the
    cache grows by one small tuple per distinct shape a process
    launches."""

    def __init__(self, make) -> None:
        self._make = make
        self._plans: dict = {}

    def __call__(self, key, *args):
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = self._make(*args)
        return plan


class DeviceScratch:
    """One buffer per device, grown to the largest request and reused by
    every launch: `scratch(device, n)` is a buffer of at least `n`
    elements. Safe because the launches on a device are ordered on its
    compute stream and each launch is done with the buffer when it ends —
    a partials scratch is consumed by the same launch; `zeroed` buffers
    (ticket counters) are made zero and each launch leaves them so. A
    buffer never grows inside a CUDA graph's capture: it would come from
    the graph's private pool and the buffer it replaces would be freed
    under graphs captured before, so an eager step of the same shapes
    sizes it first (`serving.step_graph`) and a growth there raises."""

    def __init__(self, dtype_name: str, zeroed: bool = False) -> None:
        self.dtype_name = dtype_name
        self.zeroed = zeroed
        self._bufs: dict = {}

    def __call__(self, device, n: int):
        import torch
        idx = _device_index(device)
        buf = self._bufs.get(idx)
        if buf is None or buf.numel() < n:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"DeviceScratch({self.dtype_name}) would grow to {n} "
                    "elements inside a CUDA graph capture; run a step of "
                    "these shapes eagerly first")
            make = torch.zeros if self.zeroed else torch.empty
            buf = self._bufs[idx] = make(
                n, dtype=getattr(torch, self.dtype_name), device=device)
        return buf


def stream_handle(device) -> int:
    """Raw handle of the current CUDA stream on `device` (a Python int
    for the ``void*`` stream argument), through PyTorch's raw-stream
    getter: ~0.2 us a call, where building a Stream object
    (`torch.cuda.current_stream`) costs ~11 us (H100 host, PERF.md)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(_device_index(device))
