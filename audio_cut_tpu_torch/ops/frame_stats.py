"""Kernel K2: per-frame spectral flatness and onset flux.

Counterpart of the TPU kernel ``audio_cut_tpu/ops/pallas/frame_stats.py``
(``spectral_stats_pallas``). For a magnitude spectrogram mag [T, F]:

    flatness[t] = exp(mean_f log(mag^2 + 1e-10)) / (mean_f mag^2 + 1e-10)
    onset[t]    = mean_f relu(log1p(1000 mag[t]) - log1p(1000 mag[t-1])),  onset[0] = 0

``spectral_stats`` launches the hand-written CUDA kernel (``csrc/frame_stats.cu``)
for a CUDA tensor and takes the plain PyTorch version,
``spectral_stats_reference``, only for a CPU tensor. There is no fallback
from the kernel: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from audio_cut_tpu_torch.ops.cuda import CudaKernel

_EPS = 1e-10

K2 = CudaKernel(
    "frame_stats", "spectral_stats_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)

_MAX_GRID_X = 2 ** 31 - 1  # the kernel puts the frames on grid.x


def spectral_stats_reference(mag: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the same math as the JAX package's
    ``spectral_stats_reference``."""
    power = mag * mag
    geo = torch.exp(torch.mean(torch.log(power + _EPS), dim=-1))
    flat = geo / (torch.mean(power, dim=-1) + _EPS)
    logmag = torch.log1p(1000.0 * mag)
    flux = torch.diff(logmag, dim=-2, prepend=logmag[..., :1, :])
    onset = torch.mean(torch.clamp(flux, min=0.0), dim=-1)
    return flat.to(torch.float32), onset.to(torch.float32)


def spectral_stats_cuda(mag: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 on ``torch.cuda.current_stream()``. mag [T, F] float32."""
    if mag.device.type != "cuda":
        raise ValueError(f"K2 takes a CUDA tensor, got {mag.device}")
    if mag.dtype != torch.float32:
        raise TypeError(f"K2 takes float32, got {mag.dtype}")
    if mag.ndim != 2:
        raise ValueError(f"K2 takes [T, F], got shape {tuple(mag.shape)}")
    if not mag.is_contiguous():
        raise ValueError("K2 takes a contiguous spectrogram")
    t, f = mag.shape
    if t == 0 or f == 0 or t > _MAX_GRID_X:
        raise ValueError(f"K2 takes 1..{_MAX_GRID_X} frames of >= 1 bin, got {t} x {f}")
    flat = torch.empty(t, dtype=torch.float32, device=mag.device)
    onset = torch.empty(t, dtype=torch.float32, device=mag.device)
    K2.launch(mag.device, mag.data_ptr(), flat.data_ptr(), onset.data_ptr(), t, f,
              torch.cuda.current_stream(mag.device).cuda_stream)
    return flat, onset


def spectral_stats(mag: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 for a CUDA tensor, the plain version for a CPU tensor."""
    if mag.device.type == "cpu":
        return spectral_stats_reference(mag)
    return spectral_stats_cuda(mag)
