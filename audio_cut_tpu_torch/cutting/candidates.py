"""Cut candidate model + adapters.

Counterpart of ``audio_cut_tpu/cutting/candidates.py``: the CandidateSource
enum, CutCandidate with its score clamp and dict round trip, the adapter from
detected pauses to candidates (breath-length pauses rerouted to the BREATH
source and rescaled), and the pool merge.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple


class CandidateSource(str, Enum):
    ACOUSTIC_PAUSE = "acoustic_pause"
    MDD_VALLEY = "mdd_valley"
    BREATH = "breath"
    LYRICS_GAP = "lyrics_gap"
    SENTENCE_END = "sentence_end"
    MVAD_BOUNDARY = "mvad_boundary"
    BEAT = "beat"
    RESCUE = "rescue"


@dataclass
class CutCandidate:
    t: float
    score: float
    source: CandidateSource
    reasons: List[str] = field(default_factory=list)
    features: Dict[str, float] = field(default_factory=dict)
    meta: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.t = float(self.t)
        self.score = min(1.0, max(0.0, float(self.score)))
        if not isinstance(self.source, CandidateSource):
            self.source = CandidateSource(str(self.source))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "t": self.t,
            "score": self.score,
            "source": self.source.value,
            "reasons": list(self.reasons),
            "features": dict(self.features),
            "meta": dict(self.meta),
        }


def adapt_acoustic_pauses(
    pauses: Iterable[Any],
    *,
    breath_range: Tuple[float, float] = (0.1, 0.3),
    breath_score_scale: float = 0.6,
) -> List[CutCandidate]:
    """PureVocalPause objects -> candidates; short pauses become BREATH.

    A pause whose duration falls inside ``breath_range`` is treated as a
    breath candidate with score scaled by ``breath_score_scale`` (scale 0
    drops breaths entirely).
    """
    out: List[CutCandidate] = []
    lo, hi = breath_range
    for p in pauses:
        t = float(getattr(p, "cut_point", 0.0)) or (p.start_time + p.end_time) / 2.0
        duration = float(getattr(p, "duration", 0.0))
        score = float(getattr(p, "confidence", 0.5))
        is_breath = lo <= duration <= hi
        if is_breath:
            if breath_score_scale <= 0.0:
                continue
            out.append(CutCandidate(
                t=t,
                score=score * breath_score_scale,
                source=CandidateSource.BREATH,
                reasons=["breath_pause"],
                meta={"duration_s": duration, "pause_type": getattr(p, "pause_type", "")},
            ))
        else:
            out.append(CutCandidate(
                t=t,
                score=score,
                source=CandidateSource.ACOUSTIC_PAUSE,
                reasons=["acoustic_pause"],
                meta={"duration_s": duration, "pause_type": getattr(p, "pause_type", "")},
            ))
    return out


def merge_candidate_pool(
    pools: Sequence[List[CutCandidate]],
    cluster_ms: float = 120.0,
) -> List[CutCandidate]:
    """Merge candidates from all sources, clustering within ±cluster_ms.

    The merged candidate keeps the strongest member's time/score/source and records every
    contributing source in meta["sources"] (provenance).
    """
    flat = sorted((c for pool in pools for c in pool), key=lambda c: c.t)
    if not flat:
        return []
    radius = cluster_ms / 1000.0
    clusters: List[List[CutCandidate]] = [[flat[0]]]
    for c in flat[1:]:
        if c.t - clusters[-1][-1].t <= radius:
            clusters[-1].append(c)
        else:
            clusters.append([c])

    merged: List[CutCandidate] = []
    for group in clusters:
        best = max(group, key=lambda c: c.score)
        sources = sorted({c.source.value for c in group})
        reasons = sorted({r for c in group for r in c.reasons})
        meta = dict(best.meta)
        meta["sources"] = sources
        if len(group) > 1:
            meta["cluster_size"] = len(group)
            # multi-source agreement is weak evidence of a real boundary
            bonus = 0.05 * (len(sources) - 1)
        else:
            bonus = 0.0
        merged.append(CutCandidate(
            t=best.t,
            score=min(1.0, best.score + bonus),
            source=best.source,
            reasons=reasons,
            features=dict(best.features),
            meta=meta,
        ))
    return merged
