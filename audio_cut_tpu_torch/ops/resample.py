"""Polyphase resampler as one dense matrix product.

Counterpart of ``audio_cut_tpu/ops/resample.py``. One matrix folds the
anti-alias FIR and the per-phase linear interpolation, so a whole-track
resample is frames-of-x @ W. The JAX package computes this product outside
any Pallas kernel (``Precision.HIGHEST``); here it is one float32
``torch.matmul``, which runs in full float32 under torch's default matmul
precision (``"highest"``). The port sets no global setting of torch.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def lowpass_taps(sr_in: int, cutoff_hz: float, n_taps: int = 127) -> np.ndarray:
    """Windowed-sinc anti-alias FIR."""
    m = np.arange(n_taps) - (n_taps - 1) / 2.0
    h = 2.0 * cutoff_hz / sr_in * np.sinc(2.0 * cutoff_hz / sr_in * m)
    h *= np.hamming(n_taps)
    return (h / h.sum()).astype(np.float32)


@functools.lru_cache(maxsize=8)
def resample_matrix(sr_in: int, sr_out: int) -> Tuple[np.ndarray, int, int, int]:
    """(W, up, down, left_pad): x_out[up*q + p] = sum_c W[c, p] *
    x[down*q - left_pad + c]."""
    # anti-alias below the lower of the two Nyquist rates
    cutoff_hz = 0.47 * min(sr_in, sr_out)
    taps = lowpass_taps(sr_in, cutoff_hz).astype(np.float64)
    n_taps = taps.size
    half = (n_taps - 1) // 2
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    width = down + n_taps - 1 + 1  # interpolation needs base and base+1
    W = np.zeros((width, up), dtype=np.float64)
    for p in range(up):
        pos = p * down / up
        base = int(pos)
        frac = pos - base
        for k in range(n_taps):
            W[base + k, p] += taps[k] * (1.0 - frac)
            W[base + 1 + k, p] += taps[k] * frac
    return W.astype(np.float32), up, down, half


@functools.lru_cache(maxsize=8)
def _matrix_on(sr_in: int, sr_out: int, device: str) -> torch.Tensor:
    """``resample_matrix`` on a device, uploaded once per device."""
    return torch.from_numpy(resample_matrix(sr_in, sr_out)[0]).to(device)


def resample_graph(x: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """Whole-waveform resample: [n] f32 at sr_in -> [round(n*sr_out/sr_in)] f32."""
    in_len = int(x.shape[-1])
    out_len = int(round(in_len * sr_out / sr_in))
    w_np, up, down, half = resample_matrix(sr_in, sr_out)
    w = _matrix_on(sr_in, sr_out, str(x.device))
    width = w_np.shape[0]
    n_frames = -(-out_len // up)
    n_shift = -(-width // down)  # shifted reshapes that cover `width`
    xp = torch.nn.functional.pad(
        x, (half, max(0, (n_frames + n_shift - 1) * down + width - half - in_len)))
    # shift j supplies columns [j*down, (j+1)*down) of each width-wide frame
    parts = [xp[j * down:(n_frames + j) * down].reshape(n_frames, down) for j in range(n_shift)]
    frames = torch.cat(parts, dim=1)[:, :width]
    full = torch.matmul(frames, w).reshape(-1)
    return full[:out_len]
