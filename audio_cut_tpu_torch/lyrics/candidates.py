"""Lyrics-derived boundary candidates.

Counterpart of ``audio_cut_tpu/lyrics/candidates.py``: word gaps of at least
0.35 s (score gap / 1.5 s, cut at the gap's midpoint), sentence ends (0.75,
+0.1 for closing punctuation, times the confidence), and mVAD region starts
and ends (0.45 times the confidence).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from audio_cut_tpu_torch.cutting.candidates import CandidateSource, CutCandidate
from audio_cut_tpu_torch.lyrics.models import LyricsTimeline

_SENTENCE_PUNCTUATION = tuple(".!?。！？")


@dataclass
class LyricsBoundaryCandidateGenerator:
    min_word_gap_s: float = 0.35
    max_word_gap_s: float = 1.5
    sentence_end_score: float = 0.75
    mvad_boundary_score: float = 0.45

    def generate(self, timeline: LyricsTimeline) -> List[CutCandidate]:
        out: List[CutCandidate] = []

        for left, right in zip(timeline.words, timeline.words[1:]):
            gap = right.start_s - left.end_s
            if gap < self.min_word_gap_s:
                continue
            out.append(CutCandidate(
                t=(left.end_s + right.start_s) / 2.0,
                score=min(1.0, gap / max(self.max_word_gap_s, self.min_word_gap_s)),
                source=CandidateSource.LYRICS_GAP,
                reasons=["word_gap"],
                meta={"gap_s": gap, "left_word": left.text, "right_word": right.text},
            ))

        for sentence in timeline.sentences:
            score = self.sentence_end_score
            reasons = ["sentence_end"]
            if sentence.text.strip().endswith(_SENTENCE_PUNCTUATION):
                score = min(1.0, score + 0.1)
                reasons.append("punctuation_end")
            if sentence.confidence is not None:
                score *= sentence.confidence
            out.append(CutCandidate(
                t=sentence.end_s,
                score=score,
                source=CandidateSource.SENTENCE_END,
                reasons=reasons,
                meta={"sentence": sentence.text[:60]},
            ))

        for region in timeline.vad_regions:
            conf = region.confidence if region.confidence is not None else 1.0
            for t, which in ((region.start_s, "region_start"), (region.end_s, "region_end")):
                out.append(CutCandidate(
                    t=t,
                    score=self.mvad_boundary_score * conf,
                    source=CandidateSource.MVAD_BOUNDARY,
                    reasons=[which],
                    meta={"kind": region.kind},
                ))

        return sorted(out, key=lambda c: (c.t, c.source.value))
