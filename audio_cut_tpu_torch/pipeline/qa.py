"""QA report derived from a SegmentManifest.

Counterpart of ``audio_cut_tpu/pipeline/qa.py``: the same metric names and
semantics."""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

_EPS = 1e-9


def _f(value: Any) -> Optional[float]:
    if value is None:
        return None
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


def _final_cut_items(manifest: Mapping[str, Any]) -> List[Mapping[str, Any]]:
    cuts = manifest.get("cuts")
    if not isinstance(cuts, Mapping):
        return []
    return [x for x in (cuts.get("final") or []) if isinstance(x, Mapping)]


def _duration(manifest: Mapping[str, Any]) -> Optional[float]:
    audio = manifest.get("audio")
    return _f(audio.get("duration")) if isinstance(audio, Mapping) else None


def _internal_cut_entries(manifest: Mapping[str, Any]) -> List[Tuple[float, Mapping[str, Any]]]:
    """(t, item) pairs for cuts strictly inside (0, duration)."""
    dur = _duration(manifest)
    out: List[Tuple[float, Mapping[str, Any]]] = []
    cuts = manifest.get("cuts")
    if not isinstance(cuts, Mapping):
        return out
    for item in cuts.get("final") or []:
        t = _f(item.get("t")) if isinstance(item, Mapping) else _f(item)
        if t is None or t <= _EPS:
            continue
        if dur is not None and t >= dur - _EPS:
            continue
        out.append((t, item if isinstance(item, Mapping) else {}))
    return out


def _has_source(item: Mapping[str, Any], source: str) -> bool:
    if str(item.get("source", "")) == source:
        return True
    meta = item.get("meta")
    if isinstance(meta, Mapping):
        sources = meta.get("sources")
        if isinstance(sources, Iterable) and not isinstance(sources, (str, bytes)):
            return source in {str(s) for s in sources}
    return False


def _intervals(items: Iterable[Mapping[str, Any]]) -> List[Tuple[float, float]]:
    out = []
    for item in items:
        s, e = _f(item.get("start_s")), _f(item.get("end_s"))
        if s is not None and e is not None and e > s:
            out.append((s, e))
    return out


def _inside_rate(cuts: List[float], ranges: List[Tuple[float, float]]) -> float:
    if not cuts:
        return 0.0
    inside = sum(1 for t in cuts if any(a < t < b for a, b in ranges))
    return round(inside / len(cuts), 12)


def _coverage(ranges: List[Tuple[float, float]], dur: Optional[float]) -> Optional[float]:
    if dur is None or dur <= 0:
        return None
    clipped = [(max(0.0, a), min(dur, b)) for a, b in ranges if b > a]
    if not clipped:
        return 0.0
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(clipped):
        if not merged or a > merged[-1][1]:
            merged.append((a, b))
        else:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
    return round(sum(b - a for a, b in merged) / dur, 12)


def build_qa_report(manifest: Mapping[str, Any]) -> Dict[str, Any]:
    dur = _duration(manifest)
    segments = [s for s in (manifest.get("segments") or []) if isinstance(s, Mapping)]
    seg_durs = [d for d in (_f(s.get("duration")) for s in segments) if d is not None]

    entries = _internal_cut_entries(manifest)
    cuts = [t for t, _ in entries]
    items = [item for _, item in entries]

    lyrics = manifest.get("lyrics_alignment")
    timeline = lyrics.get("timeline") if isinstance(lyrics, Mapping) else None
    timeline = timeline if isinstance(timeline, Mapping) else {}
    words = [w for w in (timeline.get("words") or []) if isinstance(w, Mapping)]
    vad = [v for v in (timeline.get("vad_regions") or []) if isinstance(v, Mapping)]

    scores = [s for s in (_f(i.get("score")) for i in _final_cut_items(manifest)) if s is not None]
    shifts = [abs(s) for s in (_f(i.get("guard_shift_ms")) for i in _final_cut_items(manifest)) if s is not None]
    confs = [c for c in (_f(w.get("confidence")) for w in words) if c is not None]

    beat_aligned = 0
    breath = 0
    for item in items:
        features = item.get("features") if isinstance(item.get("features"), Mapping) else {}
        ba = _f(features.get("beat_affinity"))
        if _has_source(item, "beat") or (ba is not None and ba >= 0.8):
            beat_aligned += 1
        if _has_source(item, "breath"):
            breath += 1

    fallback = None
    if isinstance(lyrics, Mapping) and lyrics.get("fallback_reason") is not None:
        fallback = str(lyrics["fallback_reason"])

    def pct(vals: List[float], q: float) -> Optional[float]:
        return round(float(np.percentile(vals, q * 100)), 12) if vals else None

    return {
        "segments_count": len(segments),
        "median_segment_s": round(float(np.median(seg_durs)), 12) if seg_durs else None,
        "segment_5_15_pass_rate": round(
            sum(1 for d in seg_durs if 5.0 <= d <= 15.0) / len(seg_durs), 12
        ) if seg_durs else 0.0,
        "cut_inside_word_rate": _inside_rate(cuts, _intervals(words)),
        "cut_inside_singing_rate": _inside_rate(cuts, _intervals(vad)),
        "avg_boundary_score": round(float(np.mean(scores)), 12) if scores else None,
        "lyrics_coverage_ratio": _coverage(_intervals(words), dur),
        "asr_avg_confidence": round(float(np.mean(confs)), 12) if confs else None,
        "guard_shift_p50_ms": pct(shifts, 0.50),
        "guard_shift_p95_ms": pct(shifts, 0.95),
        "breath_cut_ratio": round(breath / len(cuts), 12) if cuts else 0.0,
        "beat_aligned_ratio": round(beat_aligned / len(cuts), 12) if cuts else 0.0,
        "fallback_reason": fallback,
    }
