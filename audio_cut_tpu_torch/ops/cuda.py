"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C launch function and is compiled on
first use with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xptxas -v`` into ``audio_cut_tpu_torch/_build/`` (listed in ``.gitignore``),
then loaded with ``ctypes``; nvcc's output, with ptxas's report of each
kernel's registers and spills, is kept in ``BUILD_LOGS``. The library's file
name carries a hash of its source, so an edited kernel is rebuilt and a stale
one never loaded. nvcc writes to a name of its own process and thread, which
is then renamed onto the library's (``os.replace``): a library on disk is
always a whole file, and builds of one source in several threads or processes
at once all succeed. Nothing is compiled or loaded when a module is imported:
the CPU tests import every module, and the CPU has no ``nvcc``.

A ``CudaKernel`` counts its launches in a plain integer (``launches``); a run
resets it to 0 to show that its path went through the kernel.

Kernel K0 (``csrc/probe.cu``, x * 2 on one (8, 128) float32 tile) is the
library's build-and-launch check, the counterpart of the JAX package's
Pallas probe (``audio_cut_tpu/ops/pallas/probe.py``). Before the first launch
of any other kernel on a card, ``CudaKernel.launch`` builds and launches K0
once on that card and holds its result to ``probe_reference`` exactly; a
mismatch or a CUDA error raises. It is a check that fails loudly, not a gate:
nothing switches to a plain version.

``CudaKernel.launch`` takes the device of the tensors it launches on, makes
it the current device for the launch (the C functions launch on the current
device's context) and runs the library check on that device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# source name -> nvcc's output of the build this process made
BUILD_LOGS: Dict[str, str] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): "
                           "the port's CUDA kernels are built from csrc/ at first use")
    return found


def _library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def _nvcc_command(source: Path, target: Path) -> List[str]:
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(target), str(source)]


def build_library(name: str) -> float:
    """Compile ``csrc/<name>.cu`` unless it is built already. Returns the
    seconds the build took (0.0 for one already built). Raises on a failed
    build.

    nvcc writes ``<stem>-<digest>.<pid>.<thread>.tmp.so``, which is renamed
    onto the library when nvcc succeeds and removed when it fails. The
    library itself is never written in place nor removed: another process
    may have it loaded, or may have just finished it."""
    source = CSRC / f"{name}.cu"
    target = _library_path(source)
    if target.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(_nvcc_command(source, tmp), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
        if proc.returncode != 0:
            raise RuntimeError(f"CUDA kernel build failed: {name}.cu: nvcc exit {proc.returncode}\n"
                               f"{proc.stdout.decode(errors='replace')}")
        os.replace(tmp, target)
        BUILD_LOGS[name] = proc.stdout.decode(errors="replace")
    finally:
        tmp.unlink(missing_ok=True)
    return time.perf_counter() - t0


class CudaKernel:
    """One C launch function of one ``csrc/*.cu`` library, loaded on first use."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence) -> None:
        self.source = source
        self.symbol = symbol
        self._argtypes = list(argtypes)
        self._fn: Optional[Callable[..., int]] = None
        self.launches = 0

    def _load(self):
        if self._fn is None:
            build_library(self.source)
            lib = ctypes.CDLL(str(_library_path(CSRC / f"{self.source}.cu")))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Call the C launch function with ``device`` current; raise on a
        non-zero CUDA error code. The first launch on ``device`` of a kernel
        other than K0 runs the library check there. One call counts one
        launch, whatever number of kernels the C function starts."""
        if self is not K0 and device.index not in LIBRARY_CHECK:
            check_kernel_library(device)
        fn = self._load()
        with torch.cuda.device(device):
            rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.source}.cu:{self.symbol} failed with CUDA error {rc}")
        self.launches += 1


K0 = CudaKernel("probe", "probe_launch",
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
PROBE_SHAPE = (8, 128)
# the library check of each card it passed on: device index -> K0's
# max |kernel - plain| there
LIBRARY_CHECK: Dict[int, float] = {}


def probe_reference(x: torch.Tensor) -> torch.Tensor:
    """K0's plain version."""
    return x * 2.0


def probe_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch K0 on ``torch.cuda.current_stream()``: x * 2 for float32 ``x``."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"K0 takes a contiguous float32 CUDA tensor, got {x.dtype} on {x.device}")
    if x.numel() == 0:
        raise ValueError("K0 takes at least one element")
    out = torch.empty_like(x)
    K0.launch(x.device, x.data_ptr(), out.data_ptr(), x.numel(),
              torch.cuda.current_stream(x.device).cuda_stream)
    return out


def check_kernel_library(device: Optional[torch.device] = None) -> None:
    """Build and launch K0 on ``device`` (the current CUDA device if None)
    and hold its result to x * 2 exactly; record it in ``LIBRARY_CHECK``.
    Raises on a failed build, a CUDA error or a mismatch."""
    index = torch.cuda.current_device() if device is None or device.index is None else device.index
    x = (torch.arange(PROBE_SHAPE[0] * PROBE_SHAPE[1], dtype=torch.float32) / 7.0 - 50.0)
    x = x.reshape(PROBE_SHAPE).to(torch.device("cuda", index))
    got = probe_cuda(x)
    torch.cuda.synchronize(x.device)
    err = float((got - probe_reference(x)).abs().max())
    if err != 0.0:
        raise RuntimeError(f"kernel library check (K0, csrc/probe.cu) on cuda:{index}: "
                           f"x * 2 is off by {err}")
    LIBRARY_CHECK[index] = err
