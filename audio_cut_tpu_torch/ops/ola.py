"""Kernel K1: fused window-multiply + overlap-add (the iSTFT tail).

Counterpart of the TPU kernel ``audio_cut_tpu/ops/pallas/ola.py``
(``windowed_ola_pallas``). frames [..., N, L] times window [L], overlap-added
at ``hop`` (hop | L) -> [..., (N-1)*hop + L].

``windowed_ola`` launches the hand-written CUDA kernel (``csrc/ola.cu``) for
a CUDA tensor and takes the plain PyTorch version, ``windowed_ola_reference``,
only for a CPU tensor. There is no fallback from the kernel: a CUDA tensor
the kernel does not take raises. The serving path needs no backward; the
backward kernel (``_ola_bwd`` in the JAX package) belongs to the training
slice.
"""

from __future__ import annotations

import ctypes

import torch

from audio_cut_tpu_torch.ops.cuda import CudaKernel
from audio_cut_tpu_torch.ops.stft import overlap_add

K1 = CudaKernel(
    "ola", "windowed_ola_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)

_MAX_GRID_Y = 65535  # the kernel puts the batch on grid.y


def windowed_ola_reference(frames: torch.Tensor, window: torch.Tensor, hop: int) -> torch.Tensor:
    """Plain PyTorch version: ``frames * window`` then ``overlap_add``."""
    return overlap_add(frames * window, hop)


def windowed_ola_cuda(frames: torch.Tensor, window: torch.Tensor, hop: int) -> torch.Tensor:
    """Launch K1 on ``torch.cuda.current_stream()``. frames [N, L] or [B, N, L]."""
    if frames.device.type != "cuda" or window.device != frames.device:
        raise ValueError(f"K1 takes frames and window on one CUDA device, got "
                         f"{frames.device} and {window.device}")
    if frames.dtype != torch.float32 or window.dtype != torch.float32:
        raise TypeError(f"K1 takes float32, got {frames.dtype} and {window.dtype}")
    if frames.ndim not in (2, 3):
        raise ValueError(f"K1 takes [N, L] or [B, N, L] frames, got shape {tuple(frames.shape)}")
    if not (frames.is_contiguous() and window.is_contiguous()):
        raise ValueError("K1 takes contiguous frames and window")
    n, L = frames.shape[-2], frames.shape[-1]
    batch = frames.shape[0] if frames.ndim == 3 else 1
    if hop <= 0 or L % hop:
        raise ValueError(f"K1 needs hop ({hop}) to divide the frame length ({L})")
    if window.shape != (L,):
        raise ValueError(f"window shape {tuple(window.shape)} != ({L},)")
    if n == 0 or batch == 0 or batch > _MAX_GRID_Y:
        raise ValueError(f"K1 takes 1..{_MAX_GRID_Y} rows of >= 1 frame, got {batch} x {n}")
    total = (n - 1) * hop + L
    out = torch.empty(frames.shape[:-2] + (total,), dtype=torch.float32, device=frames.device)
    K1.launch(frames.data_ptr(), window.data_ptr(), out.data_ptr(),
              batch, n, L, hop, torch.cuda.current_stream(frames.device).cuda_stream)
    return out


def windowed_ola(frames: torch.Tensor, window: torch.Tensor, hop: int) -> torch.Tensor:
    """K1 for a CUDA tensor, the plain version for a CPU tensor."""
    if frames.device.type == "cpu":
        return windowed_ola_reference(frames, window, hop)
    return windowed_ola_cuda(frames, window, hop)
