"""Voice-activity results, the energy gate and the focus windows.

Counterpart of ``audio_cut_tpu/detection/vad.py``. The learned detector is
``models/vad.py:ConvVAD``; ``EnergyGateDetector`` is the RMS-dB gate with
min-voice/min-silence hysteresis that ``vad.backend: energy_gate`` selects.
The port runs it from the detection bundle's 10 ms vocal envelope only: the
host-waveform branch of the JAX package serves paths without a bundle, which
the port does not have.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class VadResult:
    segments: List[Tuple[float, float]] = field(default_factory=list)  # speech (start_s, end_s)
    frame_rate: float = 100.0


def _runs_from_mask(mask: np.ndarray) -> np.ndarray:
    """[n_runs, 2] start/end frame indices of True runs."""
    edges = np.diff(mask.astype(np.int8), prepend=0, append=0)
    starts = np.nonzero(edges == 1)[0]
    ends = np.nonzero(edges == -1)[0]
    return np.stack([starts, ends], axis=1) if starts.size else np.zeros((0, 2), dtype=np.int64)


def merge_intervals(intervals: List[Tuple[float, float]], max_gap: float) -> List[Tuple[float, float]]:
    if not intervals:
        return []
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a - out[-1][1] <= max_gap:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class EnergyGateDetector:
    def __init__(
        self,
        sample_rate: int,
        threshold_db: float = -40.0,
        min_voice_s: float = 0.1,
        min_silence_s: float = 0.15,
        hop_s: float = 0.01,
        relative_floor_db: Optional[float] = 20.0,
    ) -> None:
        self.sr = int(sample_rate)
        self.threshold_db = float(threshold_db)
        self.min_voice_s = float(min_voice_s)
        self.min_silence_s = float(min_silence_s)
        self.hop = max(1, int(round(hop_s * sample_rate)))
        self.relative_floor_db = relative_floor_db

    def detect(self, rms_env: np.ndarray) -> VadResult:
        """Speech segments from an RMS envelope on this detector's hop grid
        (the bundle's ``vocal_rms_fine``)."""
        rms = np.asarray(rms_env)
        if rms.size == 0:
            return VadResult([], self.sr / self.hop)
        db = 20.0 * np.log10(rms + 1e-12)
        thr = self.threshold_db
        if self.relative_floor_db is not None:
            # adaptive: at least `relative_floor_db` above the quietest decile
            floor = float(np.percentile(db, 10))
            thr = max(thr, floor + self.relative_floor_db)
        mask = db > thr

        fps = self.sr / self.hop
        min_sil = max(1, int(round(self.min_silence_s * fps)))
        min_voice = max(1, int(round(self.min_voice_s * fps)))

        # close short silences, then drop short voice runs
        for start, end in _runs_from_mask(~mask):
            if end - start <= min_sil:
                mask[start:end] = True
        segments: List[Tuple[float, float]] = []
        for start, end in _runs_from_mask(mask):
            if end - start >= min_voice:
                segments.append((start / fps, end / fps))
        return VadResult(segments, fps)


def to_focus_windows(
    segments: List[Tuple[float, float]],
    duration_s: float,
    pad_s: float = 0.2,
    merge_gap_s: float = 0.12,
    min_width_s: float = 0.0,
) -> List[Tuple[float, float]]:
    """Padded and merged speech windows for the downstream valley scan."""
    padded = [
        (max(0.0, a - pad_s), min(duration_s, b + pad_s))
        for a, b in segments
        if b > a
    ]
    merged = merge_intervals(padded, merge_gap_s)
    return [(a, b) for a, b in merged if b - a >= min_width_s]
