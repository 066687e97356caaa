"""ASR worker wire protocol: request building and response normalization.

Counterpart of ``audio_cut_tpu/lyrics/protocol.py``: the tolerant
normalization of a worker's JSON (``_s``/``_ms`` keys, word/token aliases,
the ``global_t0`` shift) into the LyricsTimeline schema. The process
boundary is host-side JSON.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

from audio_cut_tpu_torch.lyrics.models import LyricsTimeline


def build_analyze_request(
    audio_path: str,
    sample_rate: int,
    language: Optional[str] = None,
    global_t0_s: float = 0.0,
) -> Dict[str, Any]:
    req: Dict[str, Any] = {
        "audio_path": audio_path,
        "sample_rate": int(sample_rate),
        "global_t0_s": float(global_t0_s),
    }
    if language:
        req["language"] = language
    return req


def _time_s(item: Mapping[str, Any], base: str) -> Optional[float]:
    """Read `{base}_s` or `{base}_ms` (or bare base seconds)."""
    for key, scale in ((f"{base}_s", 1.0), (base, 1.0), (f"{base}_ms", 1e-3)):
        if key in item and item[key] is not None:
            try:
                return float(item[key]) * scale
            except (TypeError, ValueError):
                continue
    return None


def _norm_items(raw: Any, text_keys: List[str]) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    for item in raw or []:
        if not isinstance(item, Mapping):
            continue
        start = _time_s(item, "start")
        end = _time_s(item, "end")
        if start is None or end is None or end <= start:
            continue
        text = ""
        for key in text_keys:
            if item.get(key):
                text = str(item[key])
                break
        entry: Dict[str, Any] = {"text": text, "start_s": start, "end_s": end}
        if item.get("confidence") is not None:
            try:
                entry["confidence"] = max(0.0, min(1.0, float(item["confidence"])))
            except (TypeError, ValueError):
                pass
        out.append(entry)
    return out


def normalize_response(payload: Mapping[str, Any], global_t0_s: float = 0.0) -> LyricsTimeline:
    """Worker response JSON -> LyricsTimeline in global track seconds."""
    words = _norm_items(payload.get("words") or payload.get("tokens"), ["text", "word", "token"])
    sentences = _norm_items(payload.get("sentences") or payload.get("segments"), ["text", "sentence"])
    regions_raw = payload.get("vad_regions") or payload.get("vad") or []
    regions: List[Dict[str, Any]] = []
    for item in regions_raw:
        if not isinstance(item, Mapping):
            continue
        start = _time_s(item, "start")
        end = _time_s(item, "end")
        if start is None or end is None or end <= start:
            continue
        entry: Dict[str, Any] = {
            "start_s": start,
            "end_s": end,
            "kind": str(item.get("kind", "singing")),
        }
        if item.get("confidence") is not None:
            entry["confidence"] = float(item["confidence"])
        regions.append(entry)

    timeline = LyricsTimeline.from_dict(
        {
            "words": words,
            "sentences": sentences,
            "vad_regions": regions,
            "language": payload.get("language"),
        },
        strict=False,
    )
    if global_t0_s:
        timeline = timeline.shift(global_t0_s)
    return timeline
