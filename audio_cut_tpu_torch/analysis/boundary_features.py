"""Boundary feature extraction for VPBD scoring.

Counterpart of ``audio_cut_tpu/analysis/boundary_features.py``: ten
normalized features per candidate time: acoustic_pause (passed through),
asr_gap (gap/1.5 s), sentence_end (confidence x proximity within 0.25 s),
inside_word_penalty (confidence-scaled, softened within 60 ms of word
edges), singing_penalty, beat/mdd affinity (1 - d/0.12 s), vocal_cut_risk
(local RMS / p99), beat_conflict (d/0.12 s).

Extraction is vectorised over all candidate times at once (numpy
searchsorted and interval indexing over the RMS grid of TrackFeatures).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from audio_cut_tpu_torch.lyrics.models import LyricsTimeline

_FEATURE_NAMES = (
    "acoustic_pause", "asr_gap", "sentence_end", "inside_word_penalty",
    "singing_penalty", "beat_affinity", "mdd_affinity", "breath",
    "vocal_cut_risk", "beat_conflict",
)


@dataclass
class BoundaryFeatures:
    acoustic_pause: float = 0.0
    asr_gap: float = 0.0
    sentence_end: float = 0.0
    inside_word_penalty: float = 0.0
    singing_penalty: float = 0.0
    beat_affinity: float = 0.0
    mdd_affinity: float = 0.0
    breath: float = 0.0
    vocal_cut_risk: float = 0.0
    beat_conflict: float = 0.0

    def __post_init__(self) -> None:
        for name in _FEATURE_NAMES:
            setattr(self, name, float(np.clip(float(getattr(self, name)), 0.0, 1.0)))

    def to_dict(self) -> Dict[str, float]:
        return {name: getattr(self, name) for name in _FEATURE_NAMES}


@dataclass
class BoundaryFeatureExtractor:
    timeline: LyricsTimeline
    beat_times: Sequence[float] = field(default_factory=list)
    mdd_times: Sequence[float] = field(default_factory=list)
    rms_series: Sequence[float] = field(default_factory=list)
    hop_s: float = 0.0
    high_confidence: float = 0.85
    word_gap_norm_s: float = 1.5
    sentence_tolerance_s: float = 0.25
    word_edge_tolerance_ms: float = 60.0
    affinity_tolerance_s: float = 0.12
    vocal_risk_window_s: float = 0.08

    def __post_init__(self) -> None:
        words = self.timeline.words
        self._w_start = np.asarray([w.start_s for w in words])
        self._w_end = np.asarray([w.end_s for w in words])
        self._w_conf = np.asarray([
            (-1.0 if w.confidence is None else w.confidence) for w in words
        ])
        self._s_end = np.asarray([s.end_s for s in self.timeline.sentences])
        self._s_conf = np.asarray([
            (1.0 if s.confidence is None else s.confidence) for s in self.timeline.sentences
        ])
        sing = [r for r in self.timeline.vad_regions if r.kind == "singing"]
        self._r_start = np.asarray([r.start_s for r in sing])
        self._r_end = np.asarray([r.end_s for r in sing])
        self._r_conf = np.asarray([(-1.0 if r.confidence is None else r.confidence) for r in sing])
        self._beats = np.asarray(sorted(float(b) for b in self.beat_times))
        self._mdd = np.asarray(sorted(float(m) for m in self.mdd_times))
        self._rms = np.asarray(list(self.rms_series), dtype=np.float32)
        self._rms_p99 = float(np.percentile(self._rms, 99)) if self._rms.size else 0.0

    # -- vectorised batch API ------------------------------------------------

    def extract_batch(
        self,
        times: Sequence[float],
        acoustic_pause: Optional[Sequence[float]] = None,
        breath: Optional[Sequence[float]] = None,
    ) -> List[BoundaryFeatures]:
        t = np.asarray(list(times), dtype=np.float64)
        n = t.size
        ap = np.asarray(list(acoustic_pause), dtype=np.float64) if acoustic_pause is not None else np.zeros(n)
        br = np.asarray(list(breath), dtype=np.float64) if breath is not None else np.zeros(n)

        out: Dict[str, np.ndarray] = {
            "acoustic_pause": ap,
            "breath": br,
            "asr_gap": self._asr_gap(t),
            "sentence_end": self._sentence_end(t),
            "inside_word_penalty": self._inside_word(t),
            "singing_penalty": self._singing(t),
            "beat_affinity": self._affinity(t, self._beats),
            "mdd_affinity": self._affinity(t, self._mdd),
            "vocal_cut_risk": self._vocal_risk(t),
            "beat_conflict": self._beat_conflict(t),
        }
        return [
            BoundaryFeatures(**{name: float(out[name][i]) for name in _FEATURE_NAMES})
            for i in range(n)
        ]

    def extract(self, t: float, *, acoustic_pause: float = 0.0, breath: float = 0.0) -> BoundaryFeatures:
        return self.extract_batch([t], [acoustic_pause], [breath])[0]

    # -- vector kernels -------------------------------------------------------

    def _inside_word(self, t: np.ndarray) -> np.ndarray:
        if self._w_start.size == 0:
            return np.zeros_like(t)
        inside = (t[:, None] > self._w_start[None, :]) & (t[:, None] < self._w_end[None, :])
        conf = np.where(self._w_conf < 0, 0.5, np.where(self._w_conf >= self.high_confidence, 1.0, 0.3))
        edge_tol = max(0.0, self.word_edge_tolerance_ms / 1000.0)
        edge_dist = np.minimum(t[:, None] - self._w_start[None, :], self._w_end[None, :] - t[:, None])
        soften = np.clip(edge_dist / max(edge_tol, 1e-9), 0.0, 1.0) if edge_tol > 0 else 1.0
        penalty = np.where(inside, conf[None, :] * soften, 0.0)
        return penalty.max(axis=1, initial=0.0)

    def _singing(self, t: np.ndarray) -> np.ndarray:
        if self._r_start.size == 0:
            return np.zeros_like(t)
        inside = (t[:, None] > self._r_start[None, :]) & (t[:, None] < self._r_end[None, :])
        conf = np.where(self._r_conf < 0, 0.5, np.where(self._r_conf >= self.high_confidence, 1.0, 0.3))
        return np.where(inside, conf[None, :], 0.0).max(axis=1, initial=0.0)

    def _asr_gap(self, t: np.ndarray) -> np.ndarray:
        if self._w_start.size < 2:
            return np.zeros_like(t)
        # gap i spans [w_end[i], w_start[i+1]]
        gap_lo = self._w_end[:-1]
        gap_hi = self._w_start[1:]
        idx = np.clip(np.searchsorted(gap_lo, t, side="right") - 1, 0, gap_lo.size - 1)
        in_gap = (t >= gap_lo[idx]) & (t <= gap_hi[idx])
        width = np.maximum(gap_hi[idx] - gap_lo[idx], 0.0)
        return np.where(in_gap, np.clip(width / max(self.word_gap_norm_s, 1e-6), 0.0, 1.0), 0.0)

    def _sentence_end(self, t: np.ndarray) -> np.ndarray:
        if self._s_end.size == 0:
            return np.zeros_like(t)
        d = np.abs(t[:, None] - self._s_end[None, :])
        prox = 1.0 - d / max(self.sentence_tolerance_s, 1e-6)
        score = np.where(d <= self.sentence_tolerance_s, self._s_conf[None, :] * prox, 0.0)
        return np.clip(score.max(axis=1, initial=0.0), 0.0, 1.0)

    def _affinity(self, t: np.ndarray, anchors: np.ndarray) -> np.ndarray:
        if anchors.size == 0:
            return np.zeros_like(t)
        idx = np.clip(np.searchsorted(anchors, t), 0, anchors.size - 1)
        left = np.clip(idx - 1, 0, anchors.size - 1)
        d = np.minimum(np.abs(anchors[idx] - t), np.abs(anchors[left] - t))
        return np.clip(1.0 - d / max(self.affinity_tolerance_s, 1e-6), 0.0, 1.0)

    def _beat_conflict(self, t: np.ndarray) -> np.ndarray:
        if self._beats.size == 0:
            return np.zeros_like(t)
        idx = np.clip(np.searchsorted(self._beats, t), 0, self._beats.size - 1)
        left = np.clip(idx - 1, 0, self._beats.size - 1)
        d = np.minimum(np.abs(self._beats[idx] - t), np.abs(self._beats[left] - t))
        return np.clip(d / max(self.affinity_tolerance_s, 1e-6), 0.0, 1.0)

    def _vocal_risk(self, t: np.ndarray) -> np.ndarray:
        if self._rms.size == 0 or self.hop_s <= 0 or self._rms_p99 <= 1e-9:
            return np.zeros_like(t)
        center = np.round(t / self.hop_s).astype(np.int64)
        half = max(1, int(round(self.vocal_risk_window_s / self.hop_s)))
        lo = np.clip(center - half, 0, self._rms.size - 1)
        hi = np.clip(center + half + 1, 1, self._rms.size)
        cs = np.concatenate([[0.0], np.cumsum(self._rms, dtype=np.float64)])
        mean = (cs[hi] - cs[lo]) / np.maximum(hi - lo, 1)
        return np.clip(mean / self._rms_p99, 0.0, 1.0)
