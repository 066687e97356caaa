"""Phrase-boundary scorer.

Counterpart of ``audio_cut_tpu/cutting/scorer.py``: a weighted linear
combination of the normalized BoundaryFeatures with the penalties
(inside_word_penalty, singing_penalty) subtracted, clamped to [0, 1]; and
the candidate debug JSON writer.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, Mapping, Optional, Union

from audio_cut_tpu_torch.analysis.boundary_features import BoundaryFeatures
from audio_cut_tpu_torch.cutting.candidates import CutCandidate

DEFAULT_BOUNDARY_WEIGHTS: Dict[str, float] = {
    "acoustic_pause": 0.35,
    "asr_gap": 0.20,
    "sentence_end": 0.15,
    "beat_affinity": 0.08,
    "mdd_affinity": 0.10,
    "breath": 0.12,
    "inside_word_penalty": 0.80,
    "singing_penalty": 0.50,
}
_PENALTIES = frozenset({"inside_word_penalty", "singing_penalty"})


class PhraseBoundaryScorer:
    def __init__(self, weights: Optional[Mapping[str, float]] = None) -> None:
        self.weights = dict(DEFAULT_BOUNDARY_WEIGHTS)
        if weights:
            self.weights.update({k: float(v) for k, v in weights.items()})

    @classmethod
    def from_config(cls) -> "PhraseBoundaryScorer":
        from audio_cut_tpu_torch.config import get_config

        return cls(get_config("phrase_boundary.weights", DEFAULT_BOUNDARY_WEIGHTS))

    def score(self, features: BoundaryFeatures) -> float:
        total = 0.0
        for name, value in features.to_dict().items():
            w = self.weights.get(name, 0.0)
            total += (-w if name in _PENALTIES else w) * value
        return min(1.0, max(0.0, total))

    def score_candidate(self, candidate: CutCandidate, features: BoundaryFeatures) -> CutCandidate:
        reasons = list(candidate.reasons)
        if "vpbd_score" not in reasons:
            reasons.append("vpbd_score")
        return dataclasses.replace(
            candidate,
            score=self.score(features),
            features=features.to_dict(),
            reasons=reasons,
        )


def write_candidate_debug_json(candidates: Iterable[CutCandidate], path: Union[str, Path]) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(
        json.dumps({"candidates": [c.to_dict() for c in candidates]}, indent=2, ensure_ascii=False),
        encoding="utf-8",
    )
