"""Chorus (high-energy) region detection.

Counterpart of ``audio_cut_tpu/analysis/chorus.py``: per-bar multi-feature
fusion with coefficient-of-variation-adaptive weights (flat dynamics
CV < 0.15 lean on spectral features; dynamic CV > 0.4 lean on energy) and a
continuity filter (>= min_bars consecutive bars form a region). The bar
statistics come from the TrackFeatures grid: RMS, and (1 - flatness) as the
spectral-salience proxy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from audio_cut_tpu_torch.analysis.features import TrackFeatures


@dataclass(frozen=True)
class ChorusRegion:
    start_bar: int
    end_bar: int          # exclusive
    start_s: float
    end_s: float


def bar_feature_matrix(features: TrackFeatures, bar_times: np.ndarray) -> np.ndarray:
    """[n_bars, 2] matrix of per-bar (mean RMS, mean spectral salience)."""
    n_bars = max(0, bar_times.size - 1)
    out = np.zeros((n_bars, 2))
    for i in range(n_bars):
        sl = features.frame_slice(float(bar_times[i]), float(bar_times[i + 1]))
        if sl.stop > sl.start:
            out[i, 0] = float(features.rms[sl].mean())
            out[i, 1] = 1.0 - float(features.flatness[sl].mean())
    return out


def detect_chorus_regions(
    features: TrackFeatures,
    bar_times: np.ndarray,
    energy_percentile: float = 60.0,
    min_bars: int = 4,
) -> Tuple[List[ChorusRegion], np.ndarray]:
    """Returns (regions, per-bar high-energy mask)."""
    bars = bar_feature_matrix(features, np.asarray(bar_times, dtype=np.float64))
    n = bars.shape[0]
    if n == 0:
        return [], np.zeros(0, dtype=bool)

    energy = bars[:, 0]
    spectral = bars[:, 1]
    mean_e = float(energy.mean())
    cv = float(energy.std() / mean_e) if mean_e > 1e-9 else 0.0
    # CV-adaptive fusion: CV < 0.15 spectral-heavy, > 0.4 energy-heavy
    if cv < 0.15:
        w_energy, w_spec = 0.3, 0.7
    elif cv > 0.4:
        w_energy, w_spec = 0.8, 0.2
    else:
        w_energy, w_spec = 0.6, 0.4

    def norm(x: np.ndarray) -> np.ndarray:
        span = x.max() - x.min()
        return (x - x.min()) / span if span > 1e-12 else np.zeros_like(x)

    fused = w_energy * norm(energy) + w_spec * norm(spectral)
    thr = float(np.percentile(fused, energy_percentile))
    mask = fused >= thr

    regions: List[ChorusRegion] = []
    edges = np.diff(mask.astype(np.int8), prepend=0, append=0)
    for s, e in zip(np.nonzero(edges == 1)[0], np.nonzero(edges == -1)[0]):
        if e - s >= min_bars:
            regions.append(ChorusRegion(
                start_bar=int(s), end_bar=int(e),
                start_s=float(bar_times[s]), end_s=float(bar_times[min(e, bar_times.size - 1)]),
            ))
    continuous = np.zeros(n, dtype=bool)
    for r in regions:
        continuous[r.start_bar:r.end_bar] = True
    return regions, continuous
