"""Lyrics timeline data models.

Counterpart of ``audio_cut_tpu/lyrics/models.py``: Word / Sentence /
VadRegion / LyricsTimeline with strict interval validation, confidence in
[0,1], millisecond-rounding tail clamp, sorted storage, and dict round-trip
with the same key names (start_s/end_s/text/confidence/kind). The boundary
features and the phrase-boundary detector take a timeline; with lyrics
alignment off it is empty.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from audio_cut_tpu_torch.exceptions import TimelineValidationError

_EPS = 1e-9
_TAIL_TOLERANCE_S = 0.005  # ms-rounding slack at the track tail


def _check_conf(conf: Optional[float], name: str) -> Optional[float]:
    if conf is None:
        return None
    c = float(conf)
    if not 0.0 <= c <= 1.0:
        raise TimelineValidationError(f"{name}.confidence must be in [0,1], got {c}")
    return c


def _check_interval(start_s: float, end_s: float, name: str) -> None:
    if start_s < 0.0:
        raise TimelineValidationError(f"{name}.start_s must be >= 0")
    if end_s <= start_s + _EPS:
        raise TimelineValidationError(f"{name}: end_s must exceed start_s")


@dataclass
class Word:
    text: str
    start_s: float
    end_s: float
    confidence: Optional[float] = None

    def __post_init__(self) -> None:
        self.start_s = float(self.start_s)
        self.end_s = float(self.end_s)
        _check_interval(self.start_s, self.end_s, "word")
        self.confidence = _check_conf(self.confidence, "word")

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Word":
        return cls(
            text=str(data.get("text", "")),
            start_s=float(data["start_s"]),
            end_s=float(data["end_s"]),
            confidence=data.get("confidence"),
        )

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"text": self.text, "start_s": self.start_s, "end_s": self.end_s}
        if self.confidence is not None:
            d["confidence"] = self.confidence
        return d


@dataclass
class Sentence:
    text: str
    start_s: float
    end_s: float
    confidence: Optional[float] = None

    def __post_init__(self) -> None:
        self.start_s = float(self.start_s)
        self.end_s = float(self.end_s)
        _check_interval(self.start_s, self.end_s, "sentence")
        self.confidence = _check_conf(self.confidence, "sentence")

    from_dict = classmethod(lambda cls, data: cls(
        text=str(data.get("text", "")),
        start_s=float(data["start_s"]),
        end_s=float(data["end_s"]),
        confidence=data.get("confidence"),
    ))

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"text": self.text, "start_s": self.start_s, "end_s": self.end_s}
        if self.confidence is not None:
            d["confidence"] = self.confidence
        return d


@dataclass
class VadRegion:
    start_s: float
    end_s: float
    kind: str = "singing"
    confidence: Optional[float] = None

    def __post_init__(self) -> None:
        self.start_s = float(self.start_s)
        self.end_s = float(self.end_s)
        _check_interval(self.start_s, self.end_s, "vad_region")
        self.confidence = _check_conf(self.confidence, "vad_region")

    from_dict = classmethod(lambda cls, data: cls(
        start_s=float(data["start_s"]),
        end_s=float(data["end_s"]),
        kind=str(data.get("kind", "singing")),
        confidence=data.get("confidence"),
    ))

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"start_s": self.start_s, "end_s": self.end_s, "kind": self.kind}
        if self.confidence is not None:
            d["confidence"] = self.confidence
        return d


@dataclass
class LyricsTimeline:
    words: List[Word] = field(default_factory=list)
    sentences: List[Sentence] = field(default_factory=list)
    vad_regions: List[VadRegion] = field(default_factory=list)
    duration_s: Optional[float] = None
    language: Optional[str] = None
    source: Optional[str] = None
    forbidden_cut_times_s: List[float] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.words = sorted(self.words, key=lambda w: (w.start_s, w.end_s))
        self.sentences = sorted(self.sentences, key=lambda s: (s.start_s, s.end_s))
        self.vad_regions = sorted(self.vad_regions, key=lambda r: (r.start_s, r.end_s))
        self.forbidden_cut_times_s = sorted(float(t) for t in self.forbidden_cut_times_s)
        if self.duration_s is not None:
            self._clamp_tails(float(self.duration_s))

    def _clamp_tails(self, duration_s: float) -> None:
        """Clamp ms-rounded tails slightly past the end; reject bigger overruns."""
        for group_name, items in (("word", self.words), ("sentence", self.sentences), ("vad_region", self.vad_regions)):
            for item in items:
                if item.end_s <= duration_s + _EPS:
                    continue
                if item.end_s <= duration_s + _TAIL_TOLERANCE_S and item.start_s < duration_s:
                    item.end_s = duration_s
                else:
                    raise TimelineValidationError(
                        f"{group_name} end {item.end_s} exceeds duration {duration_s}"
                    )

    @classmethod
    def from_dict(cls, data: Dict[str, Any], strict: bool = True) -> "LyricsTimeline":
        def build(factory, items):
            out = []
            for item in items or []:
                try:
                    out.append(factory(dict(item)))
                except (TimelineValidationError, KeyError, TypeError, ValueError):
                    if strict:
                        raise
            return out

        return cls(
            words=build(Word.from_dict, data.get("words")),
            sentences=build(Sentence.from_dict, data.get("sentences")),
            vad_regions=build(VadRegion.from_dict, data.get("vad_regions")),
            duration_s=data.get("duration_s"),
            language=data.get("language"),
            source=data.get("source"),
            forbidden_cut_times_s=list(data.get("forbidden_cut_times_s") or []),
        )

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "words": [w.to_dict() for w in self.words],
            "sentences": [s.to_dict() for s in self.sentences],
            "vad_regions": [r.to_dict() for r in self.vad_regions],
        }
        for key in ("duration_s", "language", "source"):
            if getattr(self, key) is not None:
                d[key] = getattr(self, key)
        if self.forbidden_cut_times_s:
            d["forbidden_cut_times_s"] = list(self.forbidden_cut_times_s)
        return d

    def word_intervals(self) -> List[tuple]:
        return [(w.start_s, w.end_s) for w in self.words]

    def shift(self, offset_s: float) -> "LyricsTimeline":
        """New timeline with every time shifted by offset_s (chunk -> global)."""
        return LyricsTimeline(
            words=[Word(w.text, w.start_s + offset_s, w.end_s + offset_s, w.confidence) for w in self.words],
            sentences=[Sentence(s.text, s.start_s + offset_s, s.end_s + offset_s, s.confidence) for s in self.sentences],
            vad_regions=[VadRegion(r.start_s + offset_s, r.end_s + offset_s, r.kind, r.confidence) for r in self.vad_regions],
            language=self.language,
            source=self.source,
            forbidden_cut_times_s=[t + offset_s for t in self.forbidden_cut_times_s],
        )
