"""Sample-exact splitting with the carry-merge of tiny fragments.

Counterpart of ``audio_cut_tpu/pipeline/split.py``. Concatenating the
segments reproduces the input buffer bit for bit: the split is pure host
slicing of the final float32 buffer, never re-rounded through a device copy.
Fragments shorter than 10 ms are carried into the next segment (OR-merging
the vocal flags and merging the debug entries); a trailing carry joins the
last segment.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

MIN_KEEP_S = 0.01


def _merge_debug(base: Optional[Dict[str, Any]], extra: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    if base is None:
        return extra
    if extra is None:
        return base
    merged = dict(base)
    merged["start_s"] = min(base.get("start_s", 0.0), extra.get("start_s", base.get("start_s", 0.0)))
    merged["end_s"] = max(base.get("end_s", 0.0), extra.get("end_s", base.get("end_s", 0.0)))
    dur = float(base.get("duration_s", 0.0)) + float(extra.get("duration_s", 0.0))
    secs = float(base.get("vocal_activity_seconds", 0.0)) + float(extra.get("vocal_activity_seconds", 0.0))
    merged["duration_s"] = dur
    merged["vocal_activity_seconds"] = secs
    merged["vocal_activity_ratio"] = secs / dur if dur > 0 else 0.0
    merged["decision"] = bool(base.get("decision")) or bool(extra.get("decision"))
    reason = extra.get("decision_reason") or base.get("decision_reason")
    if reason:
        merged["decision_reason"] = reason
        merged["reason"] = reason
    src = list(base.get("merged_from_segments", [])) + list(extra.get("merged_from_segments", []))
    merged["merged_from_segments"] = sorted({s for s in src if s is not None})
    return merged


def split_at_sample_level(
    audio: np.ndarray,
    cut_samples: Sequence[int],
    sr: int,
    *,
    segment_flags: Optional[Sequence[bool]] = None,
    debug_entries: Optional[Sequence[Dict[str, Any]]] = None,
) -> Tuple[List[np.ndarray], Optional[List[bool]], Optional[List[Dict[str, Any]]]]:
    """Slice ``audio`` at ``cut_samples`` (must start 0, end len(audio))."""
    min_keep = max(1, int(MIN_KEEP_S * sr))
    segments: List[np.ndarray] = []
    out_flags: Optional[List[bool]] = [] if segment_flags is not None else None
    out_debug: Optional[List[Dict[str, Any]]] = [] if debug_entries is not None else None

    carry: Optional[np.ndarray] = None
    carry_flag: Optional[bool] = None
    carry_debug: Optional[Dict[str, Any]] = None

    def flag_at(i: int) -> bool:
        if segment_flags is not None and i < len(segment_flags):
            return bool(segment_flags[i])
        return True

    def debug_at(i: int) -> Optional[Dict[str, Any]]:
        if debug_entries is not None and i < len(debug_entries):
            e = dict(debug_entries[i])
            e.setdefault("merged_from_segments", [i])
            return e
        return None

    for i in range(len(cut_samples) - 1):
        start, end = int(cut_samples[i]), int(cut_samples[i + 1])
        chunk = audio[start:end]
        flag = flag_at(i)
        entry = debug_at(i)

        if carry is not None:
            chunk = np.concatenate((carry, chunk)) if chunk.size else carry
            flag = bool(carry_flag) or flag
            entry = _merge_debug(carry_debug, entry)
            carry = carry_flag = carry_debug = None

        if end - start >= min_keep and chunk.size:
            segments.append(chunk)
            if out_flags is not None:
                out_flags.append(flag)
            if out_debug is not None:
                out_debug.append(entry or {
                    "start_s": start / sr, "end_s": end / sr,
                    "duration_s": (end - start) / sr,
                    "decision": flag, "decision_reason": "inferred_flag",
                    "merged_from_segments": [i],
                })
        else:
            if chunk.size:
                carry = chunk
                carry_flag = flag
                carry_debug = entry
            elif entry is not None:
                carry_debug = _merge_debug(carry_debug, entry)

    if carry is not None:
        if segments:
            segments[-1] = np.concatenate((segments[-1], carry))
            if out_flags is not None:
                out_flags[-1] = bool(out_flags[-1]) or bool(carry_flag)
            if out_debug is not None:
                out_debug[-1] = _merge_debug(out_debug[-1], carry_debug)
        else:
            segments.append(carry)
            if out_flags is not None:
                out_flags.append(bool(carry_flag))
            if out_debug is not None:
                out_debug.append(carry_debug or {"decision": bool(carry_flag)})

    if out_debug is not None:
        for idx, e in enumerate(out_debug):
            if e is not None:
                e["index"] = idx

    return segments, out_flags, out_debug
