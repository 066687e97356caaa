"""Framewise envelopes on the feature grid, in PyTorch.

Counterpart of the parts of ``audio_cut_tpu/ops/frames.py`` that the
detection bundle runs: ``frame_rms`` (centred per-frame RMS), ``normalize01``
and ``mdd_series`` (the Musical Dynamic Density). The other envelopes of that
module (``moving_rms_db``, ``smooth``) serve paths that this slice of the
port does not run.

NUMERICS NOTE (as in the JAX package): a windowed sum is never the
difference of a global float32 prefix sum. On a loud multi-minute track the
prefix reaches 1e4-1e5 while a quiet window's energy is about 1e-7, so the
subtraction cancels to nothing or below zero. Each window is summed from the
per-bin cumulative sums of its own bins and a direct sum of the whole bins in
between, so its error scales with its own energy. No ``conv1d`` with a ones
kernel either: on the card cuDNN would run it in TF32.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

_EPS = 1e-10


def _strided_window_sums(x: torch.Tensor, window: int, stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums, counts) of centred ``[i*stride - window//2, +window)`` windows.

    x: [..., T]; outputs [..., T//stride + 1]. Zero-padded at the edges; the
    counts are the true in-bounds sample counts (``_window_counts``).

    The signal is binned at the stride. Window i starts at a constant offset
    ``o`` inside bin i and ends at offset ``e`` inside bin i+m, so it is the
    suffix of bin i from ``o``, plus the whole bins i+1 .. i+m-1, plus the
    prefix of bin i+m up to ``e``: static slices of per-bin cumulative sums
    and one sliding sum over the bin totals.
    """
    t = x.shape[-1]
    n = t // stride + 1
    half = window // 2
    s = stride
    lead = x.shape[:-1]
    p_left = -(-half // s) * s
    o = p_left - half
    m = (o + window) // s
    e = (o + window) % s
    nb = n + m + 1
    xp = torch.nn.functional.pad(x, (p_left, max(0, nb * s - p_left - t)))
    xb = xp[..., :nb * s].reshape(lead + (nb, s))
    suf = torch.flip(torch.cumsum(torch.flip(xb, (-1,)), dim=-1), (-1,))  # sum x[k:]
    if m == 0:
        top = (suf[..., :n, o + window] if o + window < s
               else torch.zeros(lead + (n,), dtype=x.dtype, device=x.device))
        sums = suf[..., :n, o] - top
    else:
        pref = torch.cumsum(xb, dim=-1)  # sum x[:k+1]
        left = suf[..., :n, o]
        right = (pref[..., m:n + m, e - 1] if e > 0
                 else torch.zeros(lead + (n,), dtype=x.dtype, device=x.device))
        sums = left + right
        if m >= 2:
            # whole bins i+1 .. i+m-1: a direct sliding sum of m-1 bin totals
            totals = pref[..., -1]
            mid = totals.unfold(-1, m - 1, 1).sum(-1)[..., 1:n + 1]
            sums = sums + mid
    return sums, _window_counts(t, window, stride, str(x.device))


@functools.lru_cache(maxsize=32)
def _window_counts(t: int, window: int, stride: int, device: str) -> torch.Tensor:
    """In-bounds sample counts of the centred windows: host numpy, built once
    per (length, window, stride, device) as the JAX package builds them once
    per compile, so a warm call neither recomputes nor uploads them."""
    n = t // stride + 1
    half = window // 2
    centers = np.arange(n) * stride
    lo = np.clip(centers - half, 0, t)
    hi = np.clip(centers - half + window, 0, t)
    return torch.from_numpy(np.maximum(hi - lo, 1).astype(np.float32)).to(device)


def frame_rms(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Centred per-frame RMS: [..., T // hop + 1], frame i centred at i*hop."""
    sq = torch.square(x.to(torch.float32))
    sums, counts = _strided_window_sums(sq, frame_length, hop)
    return torch.sqrt(torch.clamp(sums, min=0.0) / counts + _EPS)


def normalize01(x: torch.Tensor) -> torch.Tensor:
    lo = torch.amin(x, dim=-1, keepdim=True)
    hi = torch.amax(x, dim=-1, keepdim=True)
    return (x - lo) / torch.clamp(hi - lo, min=_EPS)


def mdd_series(rms: torch.Tensor, flatness: torch.Tensor, onset: torch.Tensor) -> torch.Tensor:
    """Musical Dynamic Density: clip(0.5*rms^ + 0.3*(1-flat) + 0.2*onset^, 0, 1),
    with ^ the min-max normalisation over all frames."""
    r = normalize01(rms)
    o = normalize01(onset)
    return torch.clamp(0.5 * r + 0.3 * (1.0 - flatness) + 0.2 * o, 0.0, 1.0)
