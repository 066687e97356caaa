"""Model-window helpers shared by neural backends.

Counterpart of ``audio_cut_tpu/separation/tiling.py``: ``mapped_forward``
(there a ``lax.map`` over groups of windows, here a Python loop) and
``stft_engine_geometry``. ``tiled_forward``/``tiled_forward_batch`` and
``shift_averaged`` are not in this slice of the port (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


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
