"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C launch function and is compiled on
first use with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``
into ``audio_cut_tpu_torch/_build/`` (listed in ``.gitignore``), then loaded
with ``ctypes``. The library's file name carries a hash of its source, so an
edited kernel is rebuilt and a stale one never loaded. Nothing is compiled or
loaded when a module is imported: the CPU tests import every module, and the
CPU has no ``nvcc``.

A ``CudaKernel`` counts its launches in a plain integer (``launches``); a run
resets it to 0 to show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


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
    build."""
    source = CSRC / f"{name}.cu"
    target = _library_path(source)
    if target.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(_nvcc_command(source, target), stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        target.unlink(missing_ok=True)
        raise RuntimeError(f"CUDA kernel build failed: {name}.cu: nvcc exit {proc.returncode}\n"
                           f"{proc.stdout.decode(errors='replace')}")
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

    def launch(self, *args) -> None:
        """Call the C launch function; raise on a non-zero CUDA error code."""
        rc = self._load()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.source}.cu:{self.symbol} failed with CUDA error {rc}")
        self.launches += 1
