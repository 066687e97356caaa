"""Segment layout refinement: duration shaping after the guards.

Counterpart of ``audio_cut_tpu/cutting/layout.py``, all of it, host numpy
as there: micro-merge of fragments with a soft-max-aware direction choice
(skipping beat-aligned ``_lib`` segments), the soft-min merge with the
kind-aware neighbour cost, soft-max rescue splits that prefer NMS-suppressed
candidates (scored base + 0.5 * ASR-boundary affinity - 0.75 * inside-word),
then an acoustic valley on the feature grid's RMS (threshold min(p25,
0.75 * median), ASR boundaries as bonus candidates), then the midpoint if
allowed; the post-split kind-aware micro merge, min-gap enforcement and the
beat snap within ``beat_snap_ms``. Segments are cut points, so boundaries
stay continuous by construction.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from audio_cut_tpu_torch.analysis.features import TrackFeatures

logger = logging.getLogger(__name__)

_TOL = 1e-3


@dataclass
class LayoutConfig:
    enable: bool = True
    micro_merge_s: float = 2.0
    soft_min_s: float = 5.0
    soft_max_s: float = 12.0
    min_gap_s: float = 1.0
    beat_snap_ms: float = 50.0
    allow_midpoint_fallback: bool = True

    @classmethod
    def from_mapping(cls, data: Optional[Dict[str, Any]]) -> "LayoutConfig":
        d = data or {}
        return cls(
            enable=bool(d.get("enable", True)),
            micro_merge_s=float(d.get("micro_merge_s", 2.0)),
            soft_min_s=float(d.get("soft_min_s", 5.0)),
            soft_max_s=float(d.get("soft_max_s", 12.0)),
            min_gap_s=float(d.get("min_gap_s", 1.0)),
            beat_snap_ms=float(d.get("beat_snap_ms", 50.0)),
            allow_midpoint_fallback=bool(d.get("allow_midpoint_fallback", True)),
        )


@dataclass
class RescueCandidate:
    t: float
    score: float
    inside_word: bool = False
    boundary_affinity: float = 0.0


@dataclass
class LayoutResult:
    cut_times: List[float]
    cut_kinds: List[str]
    meta: Dict[str, int] = field(default_factory=dict)


def _word_hit(t: float, word_intervals: Optional[Sequence[Tuple[float, float]]]) -> bool:
    if not word_intervals:
        return False
    return any(a < t < b for a, b in word_intervals)


def _boundary_affinity(t: float, boundaries: np.ndarray, tol_s: float = 0.75) -> float:
    """1 at an ASR boundary, linear to 0 at tol_s away (reference :~affinity)."""
    if boundaries.size == 0:
        return 0.0
    d = float(np.min(np.abs(boundaries - t)))
    return max(0.0, 1.0 - d / max(tol_s, 1e-6)) if d <= tol_s else 0.0


class _State:
    """Cuts + per-cut kinds + per-segment kinds, kept consistent through
    merges/splits (the reference's Segment-list form, as point boundaries)."""

    def __init__(self, cuts: List[float], ckinds: List[str], skinds: List[str],
                 duration: float):
        self.cuts = cuts
        self.ckinds = ckinds
        self.skinds = skinds  # len(cuts) + 1
        self.duration = duration

    def seg_bounds(self, i: int) -> Tuple[float, float]:
        a = 0.0 if i == 0 else self.cuts[i - 1]
        b = self.duration if i == len(self.cuts) else self.cuts[i]
        return a, b

    def seg_dur(self, i: int) -> float:
        a, b = self.seg_bounds(i)
        return b - a

    @property
    def n_segs(self) -> int:
        return len(self.cuts) + 1

    def cut_removable(self, ci: int) -> bool:
        return 0 <= ci < len(self.cuts) and self.ckinds[ci] != "beat"

    def remove_cut(self, ci: int, absorb_kind: str) -> None:
        """Merge segments ci and ci+1; the merged segment takes absorb_kind."""
        del self.cuts[ci]
        del self.ckinds[ci]
        self.skinds[ci:ci + 2] = [absorb_kind]

    def insert_cut(self, t: float, kind: str = "rescue") -> None:
        idx = int(np.searchsorted(self.cuts, t))
        seg_kind = self.skinds[idx]
        self.cuts.insert(idx, t)
        self.ckinds.insert(idx, kind)
        self.skinds[idx:idx + 1] = [seg_kind, seg_kind]


class LayoutRefiner:
    def __init__(
        self,
        config: LayoutConfig,
        duration_s: float,
        features: Optional[TrackFeatures] = None,
        vocal_rms_db: Optional[np.ndarray] = None,   # on the features frame grid
        beat_times: Optional[np.ndarray] = None,
        word_intervals: Optional[Sequence[Tuple[float, float]]] = None,
        asr_boundaries: Optional[Sequence[float]] = None,
    ) -> None:
        self.cfg = config
        self.duration = float(duration_s)
        self.features = features
        self.vocal_rms_db = vocal_rms_db
        self.beat_times = np.asarray(beat_times) if beat_times is not None else None
        self.word_intervals = list(word_intervals or [])
        self.asr_boundaries = np.asarray(list(asr_boundaries or []), dtype=np.float64)

    # -- public -------------------------------------------------------------

    def refine(
        self,
        cut_times: Sequence[float],
        cut_kinds: Optional[Sequence[str]] = None,
        suppressed: Optional[Sequence[RescueCandidate]] = None,
        segment_kinds: Optional[Sequence[str]] = None,
    ) -> LayoutResult:
        cuts = sorted(float(t) for t in cut_times if 0.0 < t < self.duration)
        ckinds = list(cut_kinds) if cut_kinds and len(cut_kinds) == len(cuts) else ["pause"] * len(cuts)
        skinds = (list(segment_kinds) if segment_kinds and len(segment_kinds) == len(cuts) + 1
                  else ["human"] * (len(cuts) + 1))
        meta = {"micro_merged": 0, "soft_min_merged": 0, "rescued": 0,
                "min_gap_dropped": 0, "beat_snapped": 0}
        if not self.cfg.enable:
            return LayoutResult(cuts, ckinds, meta)

        st = _State(cuts, ckinds, skinds, self.duration)
        meta["micro_merged"] += self._micro_merge(st, kind_aware=False)
        meta["soft_min_merged"] += self._soft_min_merge(st)
        meta["rescued"] += self._soft_max_split(st, list(suppressed or []))
        meta["micro_merged"] += self._micro_merge(st, kind_aware=True)
        meta["min_gap_dropped"] += self._enforce_min_gap(st)
        meta["beat_snapped"] += self._beat_snap(st)
        return LayoutResult(st.cuts, st.ckinds, meta)

    # -- merge passes ---------------------------------------------------------

    def _merge_directions(self, st: _State, i: int) -> Dict[str, Tuple[int, float, str]]:
        """Available merges for segment i: name -> (cut index, combined, kind)."""
        out: Dict[str, Tuple[int, float, str]] = {}
        a, b = st.seg_bounds(i)
        if i > 0 and st.cut_removable(i - 1):
            la, _ = st.seg_bounds(i - 1)
            out["left"] = (i - 1, b - la, st.skinds[i - 1])
        if i + 1 < st.n_segs and st.cut_removable(i):
            _, rb = st.seg_bounds(i + 1)
            out["right"] = (i, rb - a, st.skinds[i + 1])
        return out

    def _micro_merge(self, st: _State, kind_aware: bool) -> int:
        """Absorb fragments < micro_merge_s into a neighbour.

        Plain pass (reference :137-193): prefer the smaller combined segment,
        a combination exceeding soft-max is chosen only if the other side
        also exceeds it. Post-split pass (reference :257-310, kind_aware):
        prefer the same-kind neighbour, then minimal soft-max overage.
        """
        limit = self.cfg.micro_merge_s
        if limit <= 0:
            return 0
        merged = 0
        i = 0
        while st.n_segs > 1 and i < st.n_segs:
            if "_lib" in st.skinds[i] or st.seg_dur(i) >= limit:
                i += 1
                continue
            dirs = self._merge_directions(st, i)
            if not dirs:
                i += 1
                continue
            soft_max = self.cfg.soft_max_s

            if kind_aware:
                def cost(item):
                    _, combined, kind = item
                    penalty = 0.0 if kind == st.skinds[i] else 10.0
                    overage = max(0.0, combined - soft_max) if soft_max > 0 else 0.0
                    if overage > 0 and (kind != st.skinds[i] or overage > limit):
                        penalty += 100.0 + overage
                    return (penalty, overage, combined)
            else:
                def cost(item):
                    _, combined, _ = item
                    return (np.inf if 0 < soft_max < combined else combined,)

            name = min(dirs, key=lambda k: cost(dirs[k]))
            ci, _, kind = dirs[name]
            st.remove_cut(ci, kind)
            merged += 1
            i = max(i - 1, 0) if name == "left" else i
        return merged

    def _soft_min_merge(self, st: _State) -> int:
        """Merge sub-soft-min segments into the cheaper neighbour.

        Cost (reference :196-254): combined length, infinite when the merge
        would exceed soft-max, plus combined+1 when the neighbour's kind
        differs; ties resolve to the same-kind side.
        """
        if self.cfg.soft_min_s <= 0:
            return 0
        merged = 0
        i = 0
        while st.n_segs > 1 and i < st.n_segs:
            kind = st.skinds[i]
            if "_lib" in kind or st.seg_dur(i) >= self.cfg.soft_min_s:
                i += 1
                continue
            dirs = self._merge_directions(st, i)
            if not dirs:
                i += 1
                continue

            def cost(item) -> float:
                _, combined, nkind = item
                over = np.inf if 0 < self.cfg.soft_max_s < combined else combined
                return over + (0.0 if nkind == kind else combined + 1.0)

            costs = {name: cost(v) for name, v in dirs.items()}
            if len(costs) == 2 and costs["left"] == costs["right"]:
                name = "left" if dirs["left"][2] == kind else "right"
            else:
                name = min(costs, key=costs.get)
            if not np.isfinite(costs[name]):
                i += 1
                continue
            ci, _, nkind = dirs[name]
            st.remove_cut(ci, nkind)
            merged += 1
            i = max(i - 1, 0) if name == "left" else i
        return merged

    # -- soft-max splits ---------------------------------------------------------

    def _soft_max_split(self, st: _State, pool: List[RescueCandidate]) -> int:
        if self.cfg.soft_max_s <= 0:
            return 0
        rescued = 0
        i = 0
        guard = 0
        while i < st.n_segs and guard < 1024:
            guard += 1
            a, b = st.seg_bounds(i)
            if b - a <= self.cfg.soft_max_s:
                i += 1
                continue
            t = self._pick_split(a, b, pool)
            if t is None:
                i += 1
                continue
            left, right = t - a, b - t
            if left <= 0 or right <= 0 or (
                self.cfg.min_gap_s > 0
                and (left < self.cfg.min_gap_s or right < self.cfg.min_gap_s)
            ):
                i += 1
                continue
            st.insert_cut(t)
            rescued += 1
            # re-check the (possibly still over-long) left half at the same index
        return rescued

    def _pick_split(self, a: float, b: float, pool: List[RescueCandidate]) -> Optional[float]:
        # 1) best NMS-suppressed candidate inside the segment (consumed)
        in_range = [c for c in pool if a + _TOL < c.t < b - _TOL]
        if in_range:
            best = max(in_range, key=self._candidate_score)
            pool.remove(best)
            return float(best.t)
        # 2) acoustic valley on the cached RMS grid
        t = self._valley_split(a, b)
        if t is not None:
            return t
        # 3) midpoint fallback
        if self.cfg.allow_midpoint_fallback:
            return (a + b) / 2.0
        return None

    def _candidate_score(self, cand: RescueCandidate) -> float:
        """base + 0.5*ASR-boundary affinity − 0.75*inside-word (reference :391-399)."""
        score = float(cand.score) + 0.5 * max(
            _boundary_affinity(cand.t, self.asr_boundaries), cand.boundary_affinity
        )
        if cand.inside_word or _word_hit(cand.t, self.word_intervals):
            score -= 0.75
        return score

    def _valley_split(self, a: float, b: float) -> Optional[float]:
        """Quiet local-minimum search scored with ASR affinity (reference :402-470).

        Threshold = min(p25, 0.75*median); ASR boundary times are additional
        candidates with a +0.65 bonus; accept only when the best score >= 0.5.
        """
        feats = self.features
        if feats is None or feats.rms.size <= 2:
            return None
        lo = a + max(0.0, self.cfg.min_gap_s)
        hi = b - max(0.0, self.cfg.min_gap_s)
        if hi <= lo:
            return None
        sl = feats.frame_slice(lo, hi)
        rms = np.asarray(feats.rms[sl], dtype=np.float64)
        if rms.size < 3 or not np.all(np.isfinite(rms)):
            return None
        median = float(np.median(rms))
        spread = float(np.percentile(rms, 75) - np.percentile(rms, 5))
        if median <= 1e-12 or spread <= max(1e-9, median * 0.02):
            return None
        threshold = min(float(np.percentile(rms, 25)), median * 0.75)

        # vectorised local-minimum scan
        interior = (
            (rms[1:-1] <= threshold)
            & (rms[1:-1] <= rms[:-2])
            & (rms[1:-1] <= rms[2:])
        )
        best_t: Optional[float] = None
        best_score = -1.0
        for li in np.nonzero(interior)[0] + 1:
            t = (sl.start + li) * feats.hop_s
            if not (lo < t < hi):
                continue
            quiet = max(0.0, (median - float(rms[li])) / median)
            score = quiet + 0.5 * _boundary_affinity(t, self.asr_boundaries)
            if _word_hit(t, self.word_intervals):
                score -= 0.75
            if score > best_score:
                best_score, best_t = score, float(t)

        # ASR boundaries as first-class candidates with a bonus
        for t in self.asr_boundaries:
            t = float(t)
            if not (lo < t < hi) or _word_hit(t, self.word_intervals):
                continue
            li = int(round(t / feats.hop_s)) - int(sl.start)
            if not (0 <= li < rms.size):
                continue
            v = float(np.min(rms[max(0, li - 2):min(rms.size, li + 3)]))
            if v > median:
                continue
            score = max(0.0, (median - v) / median) + 0.65
            if score > best_score:
                best_score, best_t = score, t

        if best_t is None or best_score < 0.5:
            return None
        return best_t

    # -- tail passes ---------------------------------------------------------------

    def _enforce_min_gap(self, st: _State) -> int:
        dropped = 0
        i = 0
        while i < len(st.cuts):
            t = st.cuts[i]
            prev = 0.0 if i == 0 else st.cuts[i - 1]
            if t - prev < self.cfg.min_gap_s or self.duration - t < self.cfg.min_gap_s:
                st.remove_cut(i, st.skinds[i])
                dropped += 1
            else:
                i += 1
        return dropped

    def _beat_snap(self, st: _State) -> int:
        if self.beat_times is None or self.beat_times.size == 0 or self.cfg.beat_snap_ms <= 0:
            return 0
        tol = self.cfg.beat_snap_ms / 1000.0
        snapped = 0
        for i, t in enumerate(st.cuts):
            j = int(np.argmin(np.abs(self.beat_times - t)))
            bt = float(self.beat_times[j])
            if 0 < abs(bt - t) <= tol and 0.0 < bt < self.duration:
                st.cuts[i] = bt
                snapped += 1
        # snapping can reorder/duplicate; drop duplicates keeping order
        order = np.argsort(st.cuts)
        st.cuts[:] = [st.cuts[k] for k in order]
        st.ckinds[:] = [st.ckinds[k] for k in order]
        i = 0
        while i + 1 < len(st.cuts):
            if st.cuts[i + 1] - st.cuts[i] <= 1e-6:
                st.remove_cut(i + 1, st.skinds[i + 1])
            else:
                i += 1
        return snapped


def refine_layout(
    cut_times: Sequence[float],
    duration_s: float,
    config: Optional[Dict[str, Any]] = None,
    features: Optional[TrackFeatures] = None,
    vocal_rms_db: Optional[np.ndarray] = None,
    beat_times: Optional[np.ndarray] = None,
    suppressed: Optional[Sequence[RescueCandidate]] = None,
    cut_kinds: Optional[Sequence[str]] = None,
    segment_kinds: Optional[Sequence[str]] = None,
    word_intervals: Optional[Sequence[Tuple[float, float]]] = None,
    asr_boundaries: Optional[Sequence[float]] = None,
) -> LayoutResult:
    refiner = LayoutRefiner(
        LayoutConfig.from_mapping(config),
        duration_s,
        features=features,
        vocal_rms_db=vocal_rms_db,
        beat_times=beat_times,
        word_intervals=word_intervals,
        asr_boundaries=asr_boundaries,
    )
    return refiner.refine(
        cut_times, cut_kinds=cut_kinds, suppressed=suppressed, segment_kinds=segment_kinds
    )
