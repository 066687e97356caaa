"""Cases and inputs that the card tests (``tests/test_torch_cuda.py``) and
``chip_smoke.py`` share, so that both hold a kernel at the same edges in the
same way."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from audio_cut_tpu_torch.ops.ola import WindowPlan, windowed_ola_backward_reference
from audio_cut_tpu_torch.ops.stft import frame_signal

# K1's shapes, (what, batch, n_frames, frame_len, hop): every shape a path
# launches it at. The ConvTDF serving path (n_fft 6144, hop 1024) in pieces
# of 2 windows and its last piece of 1 (the default piece upload), in pieces
# of 3 (a YAML config's, and the whole-track path's last group) and of 4 (the
# whole-track path); under shift averaging a forward holds windows x shifts
# rows (shifts 2: pieces of 2 give 4 rows, the last piece 2; shifts 3: one
# window a forward, 3 rows); the batch's groups of 4 windows and its last
# group of 2; a piece of the spectral backend (n_fft 2048, hop 512); the
# training forward of ConvTDF-large at batch 4.
K1_SHAPES = [
    ("a piece of 2 windows; shifts 2: the last piece; the batch's last group",
     2, 256, 6144, 1024),
    ("the last piece, 1 window", 1, 256, 6144, 1024),
    ("pieces of 3; shifts 3: a window", 3, 256, 6144, 1024),
    ("the whole-track path's groups of 4; shifts 2: a piece; the batch's groups",
     4, 256, 6144, 1024),
    ("a spectral piece", 2, 865, 2048, 512),
    ("the training forward", 4, 128, 6144, 1024),
]
# the terms whose loads a K1 thread issues together (csrc/ola.cu:kMaxRatio)
K1_MAX_RATIO = 6
# K1's edges: (what, batch, n_frames, frame_len, hop, offset of the frames
# from a 16 B boundary in floats). The first two take the scalar form.
K1_EDGE_SHAPES = [
    ("scalar path: 4 B off 16 B alignment", 2, 256, 6144, 1024, 1),
    ("scalar path: hop not a multiple of 4", 2, 9, 18, 6, 0),
    ("r = 1: hop equals L", 2, 9, 512, 512, 0),
    ("r above kMaxRatio", 2, 21, 2048, 128, 0),
    ("a single frame", 2, 1, 2048, 512, 0),
    ("fewer frames than r", 2, 3, 6144, 1024, 0),
]


def k1_edge_holds(edge: str, batch: int, n: int, frame_len: int, hop: int, offset: int) -> bool:
    """Whether the case ``edge`` of ``K1_EDGE_SHAPES`` is that edge."""
    r = frame_len // hop
    return {"scalar path: 4 B off 16 B alignment": offset % 4 != 0,
            "scalar path: hop not a multiple of 4": hop % 4 != 0,
            "r = 1: hop equals L": r == 1,
            "r above kMaxRatio": r > K1_MAX_RATIO,
            "a single frame": n == 1,
            "fewer frames than r": 1 < n < r}[edge]


# K1W's edges: (what, batch, n_frames, frame_len, hop, offset of the inputs
# from a 16 B boundary in floats). The last two are the scalar path: a hop
# that is no multiple of 4, and the training shape [4, 128, 6144] hop 1024
# on a view 4 B off alignment.
K1W_EDGE_SHAPES = [
    ("one frame", 1, 1, 6144, 1024, 0),
    ("fewer rows than the cluster", 1, 5, 512, 128, 0),
    ("rows the cluster does not divide", 3, 7, 6144, 1024, 0),
    ("L not a multiple of the tile", 2, 9, 1000, 250, 0),
    ("scalar path: hop not a multiple of 4", 2, 7, 90, 30, 0),
    ("scalar path: 4 B off 16 B alignment", 4, 128, 6144, 1024, 1),
]


def k1w_edge_holds(edge: str, batch: int, n: int, frame_len: int, hop: int, offset: int,
                   plan: WindowPlan) -> bool:
    """Whether the case ``edge`` of ``K1W_EDGE_SHAPES`` is that edge under ``plan``."""
    rows = batch * n
    return {"one frame": rows == 1,
            "fewer rows than the cluster": rows < plan.cluster,
            "rows the cluster does not divide": rows % plan.cluster != 0,
            "L not a multiple of the tile": frame_len % plan.tile_cols != 0,
            "scalar path: hop not a multiple of 4": hop % 4 != 0,
            "scalar path: 4 B off 16 B alignment": offset % 4 != 0}[edge]


def _normal(shape: Tuple[int, ...], rng: np.random.Generator, device,
            offset: int) -> torch.Tensor:
    """Standard normal of ``shape`` from ``rng``, on ``device``, as a view
    starting ``offset`` floats into its storage."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    buf = torch.empty(x.numel() + offset, device=device)
    buf[offset:] = x.reshape(-1)
    return buf[offset:].view(shape)


def k1_inputs(shape: Tuple[int, ...], seed: int, device, offset: int = 0) -> torch.Tensor:
    """K1's frames of ``shape``, standard normal from ``seed``, starting
    ``offset`` floats into their storage."""
    return _normal(shape, np.random.default_rng(seed), device, offset)


def k1w_inputs(shape: Tuple[int, ...], hop: int, seed: int, device,
               offset: int = 0) -> List[torch.Tensor]:
    """frames of ``shape`` and their cotangent g, standard normal from ``seed``,
    each starting ``offset`` floats into its storage."""
    n, frame_len = shape[-2], shape[-1]
    rng = np.random.default_rng(seed)
    return [_normal(x_shape, rng, device, offset)
            for x_shape in (shape, shape[:-2] + ((n - 1) * hop + frame_len,))]


def k1w_error(got: torch.Tensor, g: torch.Tensor, frames: torch.Tensor,
              hop: int) -> Tuple[float, float]:
    """max |got - plain| of a window's gradient over its columns, and the
    largest share of a column's sum |g * frames| that it reaches. Raises if
    ``got`` has another shape than the plain backward's."""
    n, frame_len = frames.shape[-2], frames.shape[-1]
    _, want = windowed_ola_backward_reference(g, frames, None, hop, frames_shape=frames.shape,
                                              want_frames=False)
    if got.shape != want.shape:
        raise ValueError(f"K1W gave shape {tuple(got.shape)}, the plain backward "
                         f"{tuple(want.shape)}")
    raw = frame_signal(g, frame_len, hop, center=False)[..., :n, :]
    scale = (raw * frames).abs().sum(dim=tuple(range(raw.ndim - 1)))
    err = (got - want).abs()
    return float(err.max()), float((err / scale.clamp_min(1e-30)).max())


def _onset64(mag: np.ndarray) -> np.ndarray:
    """K2's onset of a magnitude spectrogram [T, F] (the plain version's
    formula), in float64."""
    logmag = np.log1p(1000.0 * np.asarray(mag, np.float64))
    flux = np.diff(logmag, axis=-2, prepend=logmag[..., :1, :])
    return np.clip(flux, 0.0, None).mean(axis=-1)


def onset_allowed(mag_a: np.ndarray, mag_b: np.ndarray) -> np.ndarray:
    """Per frame, how far the onsets (K2's: the mean over bins of
    clamp(diff over frames of log1p(1000 |X|), 0)) of two magnitude
    spectrograms [T, F] of one signal differ: the onset of each, in
    float64, and their difference. Two libraries' FFTs of one signal round
    differently, and log1p(1000 |X|) magnifies that up to 1000-fold in
    near-silent bins; this follows the spectrograms' own difference instead
    of a fixed tolerance, and leaves to the caller only the rounding of the
    onset itself (K2's against its plain version)."""
    return np.abs(_onset64(mag_a) - _onset64(mag_b))
