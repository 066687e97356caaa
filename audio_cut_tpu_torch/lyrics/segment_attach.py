"""Attach lyrics words to exported segments.

Counterpart of ``audio_cut_tpu/lyrics/segment_attach.py``: a word belongs to
a segment when at least half of its span overlaps it; words are joined
without spaces between CJK characters.
"""

from __future__ import annotations

import unicodedata
from typing import Any, Dict, List

from audio_cut_tpu_torch.lyrics.models import LyricsTimeline, Word

_MIN_OVERLAP_RATIO = 0.5


def _is_cjk(ch: str) -> bool:
    if not ch:
        return False
    name = unicodedata.name(ch[0], "")
    return any(tag in name for tag in ("CJK", "HIRAGANA", "KATAKANA", "HANGUL"))


def join_words(words: List[str]) -> str:
    out: List[str] = []
    for word in words:
        if not word:
            continue
        if out and not (_is_cjk(out[-1][-1:]) and _is_cjk(word[:1])):
            out.append(" ")
        out.append(word)
    return "".join(out)


def _overlap_ratio(word: Word, start: float, end: float) -> float:
    span = word.end_s - word.start_s
    if span <= 0:
        return 0.0
    inter = min(word.end_s, end) - max(word.start_s, start)
    return max(0.0, inter) / span


def attach_lyrics_to_segments(
    segments: List[Dict[str, Any]],
    timeline: LyricsTimeline,
) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    for seg in segments:
        entry = dict(seg)
        start = float(seg.get("start") or 0.0)
        end = float(seg.get("end") or start)
        hits = [w for w in timeline.words if _overlap_ratio(w, start, end) >= _MIN_OVERLAP_RATIO]
        if hits:
            entry["lyrics"] = {
                "text": join_words([w.text for w in hits]),
                "words": [w.to_dict() for w in hits],
            }
        out.append(entry)
    return out
