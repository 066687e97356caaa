"""STFT / iSTFT primitives in PyTorch.

Counterpart of ``audio_cut_tpu/ops/stft.py``, with the same conventions: a
periodic Hann window, centred frames with reflect padding, float32 in and
out, complex64 spectra shaped [..., n_frames, n_bins]. The signal is framed
directly (``Tensor.unfold``) instead of through ``torch.stft``, whose padding
and normalisation differ from the JAX package's. The FFTs are
``torch.fft.rfft``/``irfft``, as the JAX package leaves them to XLA.

The window-multiply + overlap-add at the end of every iSTFT goes through
``ops/ola.py``: the hand-written CUDA kernel for a CUDA tensor, its plain
version for a CPU tensor.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window, computed in float32 as ``jnp`` does."""
    k = torch.arange(n, dtype=torch.float32, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * np.pi * k / n)).to(dtype)


def _hann_np(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float64)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int, center: bool = True) -> torch.Tensor:
    """Slice ``x`` [..., T] into overlapping frames [..., n_frames, frame_length]."""
    if center:
        pad = frame_length // 2
        lead = x.shape[:-1]
        # reflect padding of the last axis wants a (N, C, W) input
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
        x = x.reshape(lead + x.shape[-1:])
    # (T - L) // hop + 1 frames, as every path of the JAX package gives
    return x.unfold(-1, frame_length, hop)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """OLA of ``frames`` [..., n, L] -> [..., (n-1)*hop + L]."""
    n, L = frames.shape[-2], frames.shape[-1]
    total = (n - 1) * hop + L
    batch = frames.shape[:-2]
    out = frames.new_zeros(batch + (total,))
    if L % hop == 0:
        # r dense shifted adds, in the JAX package's order (r ascending)
        ratio = L // hop
        blocks = frames.reshape(batch + (n, ratio, hop))
        for r in range(ratio):
            flat = blocks[..., :, r, :].reshape(batch + (n * hop,))
            out[..., r * hop:r * hop + n * hop] += flat
        return out
    for i in range(n):
        out[..., i * hop:i * hop + L] += frames[..., i, :]
    return out


def stft(x: torch.Tensor, n_fft: int, hop: int, center: bool = True) -> torch.Tensor:
    """STFT of ``x`` [..., T] -> complex64 [..., n_frames, n_fft//2+1]."""
    window = hann_window(n_fft, x.dtype, x.device)
    frames = frame_signal(x, n_fft, hop, center=center)
    return torch.fft.rfft(frames * window, n=n_fft, dim=-1)


def _ola_window_sq(n: int, n_fft: int, hop: int) -> np.ndarray:
    """Sum of squared hann windows over the OLA grid (float64 sums, f32 out)."""
    w2 = _hann_np(n_fft) ** 2
    total = (n - 1) * hop + n_fft
    wsq = np.zeros(total, dtype=np.float64)
    for i in range(n):
        wsq[i * hop:i * hop + n_fft] += w2
    return np.maximum(wsq, 1e-10).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _ola_norm(n: int, n_fft: int, hop: int, device: str) -> torch.Tensor:
    """``_ola_window_sq`` on ``device``, made and copied once per shape: a
    copy from pageable host memory on every call would also wait for the
    device to drain. Made outside inference mode, so autograd may save it."""
    with torch.inference_mode(False):
        return torch.from_numpy(_ola_window_sq(n, n_fft, hop)).to(device)


def istft(
    spec: torch.Tensor,
    n_fft: int,
    hop: int,
    length: Optional[int] = None,
    center: bool = True,
) -> torch.Tensor:
    """Inverse STFT with windowed overlap-add and COLA normalization.

    ``spec``: complex [..., n_frames, n_fft//2+1] -> real [..., out_length].
    """
    from audio_cut_tpu_torch.ops.ola import windowed_ola

    window = hann_window(n_fft, torch.float32, spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1).to(torch.float32)

    n = frames.shape[-2]
    total = (n - 1) * hop + n_fft
    lead = frames.shape[:-2]
    out = windowed_ola(frames.reshape((-1,) + frames.shape[-2:]).contiguous(), window, hop)
    out = out.reshape(lead + out.shape[-1:])
    out = out / _ola_norm(n, n_fft, hop, str(out.device))

    if center:
        pad = n_fft // 2
        out = out[..., pad:total - pad]
    if length is not None:
        cur = out.shape[-1]
        if cur >= length:
            out = out[..., :length]
        else:
            out = F.pad(out, (0, length - cur))
    return out
