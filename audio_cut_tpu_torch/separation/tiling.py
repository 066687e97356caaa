"""Model-window helpers shared by neural backends.

Counterpart of ``audio_cut_tpu/separation/tiling.py``: ``mapped_forward``
(there a ``lax.map`` over groups of windows, here a Python loop),
``shift_averaged`` (the ``shifts`` offsets of each window in one batched
forward) and ``stft_engine_geometry``. The re-tiling helpers
``tiled_forward``/``tiled_separate``/``tiled_forward_batch`` are not in the
port (ROADMAP.md, queue 1, 'other separator tiers (waveunet, onnx)'): every
engine window of the port's backends is a model window.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F


def shift_averaged(forward: Callable[[torch.Tensor], torch.Tensor], hop: int, shifts: int):
    """Wrap a [n, W] -> [n, W] stem forward with sub-hop shift averaging.

    Row k of the batched input is the window delayed by ``k * max(1, hop //
    shifts)`` samples (zeros in front); all ``shifts`` rows of every window
    go through ONE forward; the delays are undone and the outputs summed and
    divided by the per-sample vote count. The last samples of a window get
    fewer votes; the engine's halo trim discards that edge. The sums run in
    the JAX package's order. ``shifts <= 1`` returns ``forward`` itself.
    """
    shifts = int(shifts)
    if shifts <= 1:
        return forward

    def wrapped(windows: torch.Tensor) -> torch.Tensor:
        b, w = windows.shape
        step = max(1, hop // shifts)
        xs = [windows]
        for k in range(1, shifts):
            xs.append(F.pad(windows[:, :-k * step], (k * step, 0)))
        y = forward(torch.cat(xs, dim=0))
        acc = y[:b]
        wts = torch.ones(w, dtype=torch.float32, device=y.device)
        idx = torch.arange(w, device=y.device)
        for k in range(1, shifts):
            s = k * step
            acc = acc + F.pad(y[k * b:(k + 1) * b, s:], (0, s))
            wts = wts + (idx < (w - s)).to(torch.float32)
        return acc / wts

    return wrapped


def mapped_forward(
    forward: Callable[[torch.Tensor], Tuple[torch.Tensor, ...]],
    windows: torch.Tensor,
    group: int,
) -> Tuple[torch.Tensor, ...]:
    """Run ``forward`` ([g, W] -> tuple of [g, W]) over ``windows`` [N, W] in
    groups of ``group`` windows, so activation memory stays bounded; returns
    the tuple of [N, W] outputs. Each window is computed on its own, so the
    last group runs with the windows it has instead of zero padding."""
    outs = [forward(windows[i:i + group]) for i in range(0, windows.shape[0], max(1, int(group)))]
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def stft_engine_geometry(sr: float, window_samples: int, n_fft: int, hop: int):
    """Native engine schedule for an STFT-domain mask net: engine windows ==
    model windows, halo = n_fft/2 iSTFT edge spread (recomputed by the
    neighbour), short cross-fade ramp, align = hop so every window start sits
    on the STFT frame grid."""
    sr = float(sr)
    target = int(window_samples)
    halo = n_fft // 2
    ramp = 8 * hop
    # overlap must stay well under the window for a positive stride
    overlap = min(2 * halo + ramp, (target // (2 * hop)) * hop)
    return {
        "chunk_s": target / sr,
        "overlap_s": overlap / sr,
        "halo_s": min(halo, overlap // 3) / sr,
        "align": hop,
    }
