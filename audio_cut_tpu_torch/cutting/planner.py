"""Global DP cut planner.

Counterpart of ``audio_cut_tpu/cutting/planner.py``: per-second top-K
candidate pruning, an O(N^2) DP over candidate times with hard_min/hard_max
feasibility, node value = score - 0.25*vocal_risk - 0.15*beat_conflict,
duration reward (+0.1 in the target band, linear penalty outside), the
backtracked path, even-division rescue when infeasible, and the guard-shift
metadata joiner that the manifest's final-cut enrichment reads. The DP
transition is vectorised per node (numpy over all predecessors). It runs on
the host, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from audio_cut_tpu_torch.cutting.candidates import CutCandidate
from audio_cut_tpu_torch.cutting.refine import CutAdjustment, CutPoint


@dataclass(frozen=True)
class GlobalCutPlannerConfig:
    hard_min_s: float = 2.0
    hard_max_s: float = 18.0
    target_min_s: float = 5.0
    target_max_s: float = 12.0
    duration_penalty_weight: float = 0.15
    vocal_risk_weight: float = 0.25
    beat_conflict_weight: float = 0.15
    max_candidates_per_second: float = 2.0
    rescue_enabled: bool = True

    @classmethod
    def from_config(cls) -> "GlobalCutPlannerConfig":
        from audio_cut_tpu_torch.config import get_config

        g = get_config("global_planner", {}) or {}
        return cls(
            hard_min_s=float(g.get("hard_min_s", 2.0)),
            hard_max_s=float(g.get("hard_max_s", 18.0)),
            target_min_s=float(g.get("target_min_s", 5.0)),
            target_max_s=float(g.get("target_max_s", 12.0)),
            vocal_risk_weight=float(g.get("vocal_risk_weight", 0.25)),
            beat_conflict_weight=float(g.get("beat_conflict_weight", 0.15)),
            max_candidates_per_second=float(g.get("max_candidates_per_second", 2.0)),
            rescue_enabled=bool(g.get("rescue_enabled", True)),
        )


@dataclass(frozen=True)
class GlobalCutPlanResult:
    cut_times: List[float]
    selected_candidates: List[CutCandidate]
    suppressed_candidates: List[CutCandidate] = field(default_factory=list)
    rescue_points: List[float] = field(default_factory=list)
    feasible: bool = True
    metadata: Dict[str, object] = field(default_factory=dict)


class GlobalCutPlanner:
    def __init__(self, config: Optional[GlobalCutPlannerConfig] = None) -> None:
        self.config = config or GlobalCutPlannerConfig()

    # -- public ---------------------------------------------------------------

    def plan(self, candidates: Sequence[CutCandidate], *, duration_s: float) -> GlobalCutPlanResult:
        duration_s = float(duration_s)
        if duration_s <= 0.0:
            return GlobalCutPlanResult([0.0], [], metadata={"planner": "empty", "selected_count": 0, "suppressed_count": 0})

        kept, suppressed = self._prune(candidates, duration_s)
        path = self._dp(kept, duration_s)
        if path is None:
            if not self.config.rescue_enabled:
                return GlobalCutPlanResult(
                    [0.0, duration_s], [], list(candidates), feasible=False,
                    metadata={"planner": "dynamic_programming", "selected_count": 0,
                              "suppressed_count": len(candidates)},
                )
            return self._rescue(duration_s, list(candidates))

        selected, cut_times = path
        sel_ids = {id(c) for c in selected}
        suppressed.extend(c for c in kept if id(c) not in sel_ids)
        return GlobalCutPlanResult(
            cut_times=cut_times,
            selected_candidates=selected,
            suppressed_candidates=sorted(suppressed, key=lambda c: (c.t, c.score)),
            metadata={"planner": "dynamic_programming",
                      "selected_count": len(selected),
                      "suppressed_count": len(suppressed)},
        )

    # -- internals ---------------------------------------------------------------

    def _value(self, c: CutCandidate) -> float:
        risk = float(np.clip(c.features.get("vocal_cut_risk", c.meta.get("vocal_cut_risk", 0.0)), 0, 1))
        conflict = float(np.clip(c.features.get("beat_conflict", c.meta.get("beat_conflict", 0.0)), 0, 1))
        return c.score - self.config.vocal_risk_weight * risk - self.config.beat_conflict_weight * conflict

    def _prune(
        self, candidates: Sequence[CutCandidate], duration_s: float
    ) -> Tuple[List[CutCandidate], List[CutCandidate]]:
        cap = max(1, int(math.floor(self.config.max_candidates_per_second)))
        buckets: Dict[int, List[CutCandidate]] = {}
        suppressed: List[CutCandidate] = []
        for c in candidates:
            if c.t <= 0.0 or c.t >= duration_s:
                suppressed.append(c)
                continue
            buckets.setdefault(int(c.t), []).append(c)
        kept: List[CutCandidate] = []
        for group in buckets.values():
            ordered = sorted(group, key=self._value, reverse=True)
            kept.extend(ordered[:cap])
            suppressed.extend(ordered[cap:])
        return sorted(kept, key=lambda c: c.t), suppressed

    def _duration_scores(self, seg: np.ndarray) -> np.ndarray:
        in_band = (seg >= self.config.target_min_s) & (seg <= self.config.target_max_s)
        dist = np.where(
            seg < self.config.target_min_s,
            self.config.target_min_s - seg,
            seg - self.config.target_max_s,
        )
        penalty = -self.config.duration_penalty_weight * dist / max(self.config.target_max_s, 1e-6)
        return np.where(in_band, 0.1, penalty)

    def _dp(
        self, candidates: Sequence[CutCandidate], duration_s: float
    ) -> Optional[Tuple[List[CutCandidate], List[float]]]:
        times = np.asarray([0.0, *(c.t for c in candidates), duration_s])
        node_vals = np.asarray([0.0, *(self._value(c) for c in candidates), 0.0])
        n = times.size
        tiny = duration_s <= self.config.hard_min_s

        best = np.full(n, -np.inf)
        parent = np.full(n, -1, dtype=np.int64)
        best[0] = 0.0
        for i in range(1, n):
            seg = times[i] - times[:i]
            ok = np.ones(i, dtype=bool) if tiny else (
                (seg >= self.config.hard_min_s) & (seg <= self.config.hard_max_s)
            )
            totals = np.where(ok, best[:i] + node_vals[i] + self._duration_scores(seg), -np.inf)
            j = int(np.argmax(totals))
            if np.isfinite(totals[j]):
                best[i] = totals[j]
                parent[i] = j

        if parent[-1] < 0:
            return None
        path: List[int] = []
        idx = n - 1
        while idx > 0:
            path.append(idx)
            idx = int(parent[idx])
            if idx < 0:
                return None
        path.append(0)
        path.reverse()
        selected = [candidates[i - 1] for i in path if 0 < i < n - 1]
        return selected, [float(times[i]) for i in path]

    def _rescue(self, duration_s: float, suppressed: List[CutCandidate]) -> GlobalCutPlanResult:
        count = max(1, int(math.ceil(duration_s / max(self.config.hard_max_s, 1e-6))))
        step = duration_s / count
        if step < self.config.hard_min_s and count > 1:
            count = max(1, int(math.floor(duration_s / max(self.config.hard_min_s, 1e-6))))
            step = duration_s / count
        cut_times = [round(i * step, 9) for i in range(count + 1)]
        cut_times[-1] = duration_s
        return GlobalCutPlanResult(
            cut_times=cut_times,
            selected_candidates=[],
            suppressed_candidates=suppressed,
            rescue_points=cut_times[1:-1],
            metadata={"planner": "rescue", "selected_count": 0, "suppressed_count": len(suppressed)},
        )


def planner_result_to_cut_points(result: GlobalCutPlanResult) -> List[CutPoint]:
    return [CutPoint(t=c.t, score=c.score, kind=c.source.value) for c in result.selected_candidates]


def apply_guard_shift_metadata(
    result: GlobalCutPlanResult, adjustments: Sequence[CutAdjustment]
) -> GlobalCutPlanResult:
    metadata = dict(result.metadata)
    metadata["guard_shift_ms_by_raw_time"] = {a.raw_time: a.guard_shift_ms for a in adjustments}
    metadata["final_time_by_raw_time"] = {a.raw_time: a.final_time for a in adjustments}
    return dataclasses.replace(result, metadata=metadata)
