"""Weak beat-aligned candidates inside continuous high-energy bars.

Counterpart of ``audio_cut_tpu/cutting/beat_candidates.py``: bars from beats
(time-signature grouping), chorus-gated, a candidate every ``bars_per_cut``
bars with ``base_score`` (default 0.3), each carrying a vocal_cut_risk
feature (windowed vocal RMS / peak).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from audio_cut_tpu_torch.analysis.chorus import detect_chorus_regions
from audio_cut_tpu_torch.analysis.features import TrackFeatures
from audio_cut_tpu_torch.cutting.candidates import CandidateSource, CutCandidate


def generate_beat_candidates(
    features: TrackFeatures,
    *,
    vocal_rms: Optional[np.ndarray] = None,
    time_signature: int = 4,
    bars_per_cut: int = 2,
    base_score: float = 0.3,
    energy_percentile: float = 60.0,
    risk_window_s: float = 0.08,
) -> List[CutCandidate]:
    beats = np.asarray(features.beat_times, dtype=np.float64)
    if beats.size < time_signature + 1:
        return []
    bar_times = beats[::time_signature]
    if bar_times.size < 2:
        return []

    _, high_mask = detect_chorus_regions(features, bar_times, energy_percentile=energy_percentile)

    rms = np.asarray(vocal_rms if vocal_rms is not None else features.rms, dtype=np.float64)
    peak = float(rms.max()) if rms.size else 0.0
    half = max(1, int(round(risk_window_s / features.hop_s)))

    out: List[CutCandidate] = []
    for bar_idx in range(0, bar_times.size - 1, max(1, bars_per_cut)):
        if bar_idx >= high_mask.size or not high_mask[bar_idx]:
            continue
        t = float(bar_times[bar_idx])
        if t <= 0.0 or t >= features.duration_s:
            continue
        risk = 0.0
        if peak > 1e-9:
            c = features.frame_index(t)
            window = rms[max(0, c - half):c + half + 1]
            risk = float(np.clip(window.mean() / peak, 0.0, 1.0)) if window.size else 0.0
        out.append(CutCandidate(
            t=t,
            score=base_score,
            source=CandidateSource.BEAT,
            reasons=["beat_bar", "chorus_gated"],
            features={"vocal_cut_risk": risk},
            meta={"bar_index": bar_idx},
        ))
    return out
