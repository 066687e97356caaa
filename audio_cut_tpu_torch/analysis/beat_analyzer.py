"""Beat and bar analysis for hybrid beat-aligned cutting.

Counterpart of ``audio_cut_tpu/analysis/beat_analyzer.py``: the BPM and the
bar starts (the beats grouped by the time signature), each bar's mean RMS
and the high-energy (chorus) bars by percentile. It reads the beat grid and
the BPM of the bundle's TrackFeatures and tracks no beats of its own.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from audio_cut_tpu_torch.analysis.chorus import ChorusRegion, detect_chorus_regions
from audio_cut_tpu_torch.analysis.features import TrackFeatures


@dataclass
class BeatAnalysisResult:
    bpm: float
    beat_times: np.ndarray
    bar_times: np.ndarray           # bar START times (incl. the grid end point)
    bar_energies: np.ndarray
    high_energy_mask: np.ndarray    # per bar
    chorus_regions: List[ChorusRegion] = field(default_factory=list)
    time_signature: int = 4

    def to_meta(self) -> Dict[str, object]:
        return {
            "bpm": float(self.bpm),
            "beat_count": int(self.beat_times.size),
            "bar_count": max(0, int(self.bar_times.size) - 1),
            "high_energy_bars": int(self.high_energy_mask.sum()),
            "time_signature": self.time_signature,
            "chorus_regions": [
                {"start_s": r.start_s, "end_s": r.end_s} for r in self.chorus_regions
            ],
        }


class BeatAnalyzer:
    def __init__(self, time_signature: int = 4, energy_percentile: float = 60.0) -> None:
        self.time_signature = int(time_signature)
        self.energy_percentile = float(energy_percentile)

    def analyze(self, features: TrackFeatures) -> BeatAnalysisResult:
        beats = np.asarray(features.beat_times, dtype=np.float64)
        if beats.size < self.time_signature + 1:
            return BeatAnalysisResult(
                bpm=features.bpm,
                beat_times=beats,
                bar_times=np.zeros(0),
                bar_energies=np.zeros(0),
                high_energy_mask=np.zeros(0, dtype=bool),
                time_signature=self.time_signature,
            )
        bar_times = beats[::self.time_signature]
        if bar_times[-1] < features.duration_s - 1e-6:
            bar_times = np.append(bar_times, features.duration_s)

        n_bars = bar_times.size - 1
        energies = np.zeros(n_bars)
        for i in range(n_bars):
            sl = features.frame_slice(float(bar_times[i]), float(bar_times[i + 1]))
            energies[i] = float(features.rms[sl].mean()) if sl.stop > sl.start else 0.0

        regions, high_mask = detect_chorus_regions(
            features, bar_times, energy_percentile=self.energy_percentile
        )
        return BeatAnalysisResult(
            bpm=features.bpm,
            beat_times=beats,
            bar_times=bar_times,
            bar_energies=energies,
            high_energy_mask=high_mask,
            chorus_regions=regions,
            time_signature=self.time_signature,
        )
