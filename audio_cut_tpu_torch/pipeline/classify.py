"""Human/music classification of segments by vocal activity.

Counterpart of ``audio_cut_tpu/pipeline/classify.py`` on its envelope path:
the per-segment fraction of 20 ms hops whose vocal RMS-dB exceeds
``segment_vocal_threshold_db``, human iff that ratio reaches
``segment_vocal_activity_ratio``; the long vocal-inactive spans; and the
merge of weak human tails into the following music segment. The activity
envelope is the detection bundle's ``act_rms``; the port has no host-waveform
branch.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from audio_cut_tpu_torch.config import get_config


def classify_segments_vocal_presence(
    cut_samples: Sequence[int],
    sr: int,
    *,
    act_rms: np.ndarray,
    n_samples: int,
) -> Tuple[List[bool], List[Dict[str, Any]]]:
    """(flags, debug entries) for the segments between ``cut_samples``, from
    the bundle's activity envelope of a track of ``n_samples``."""
    n_seg = max(len(cut_samples) - 1, 0)
    if n_seg == 0:
        return [], []
    n_wave = int(n_samples)
    if sr <= 0 or n_wave == 0:
        return [True] * n_seg, [
            {"index": i, "reason": "fallback_invalid_input", "decision": True}
            for i in range(n_seg)
        ]

    ratio_thr = float(get_config("v2_mdd.quality_control.segment_vocal_activity_ratio", 0.10))
    db_thr = float(get_config("v2_mdd.quality_control.segment_vocal_threshold_db", -50.0))
    hop = max(1, int(0.02 * sr))

    rms = np.asarray(act_rms)
    db = 20.0 * np.log10(rms + 1e-12)
    active = db > db_thr
    fps = sr / hop

    flags: List[bool] = []
    debug: List[Dict[str, Any]] = []
    for i in range(n_seg):
        a = int(np.clip(cut_samples[i], 0, n_wave))
        b = int(np.clip(cut_samples[i + 1], a, n_wave))
        fa = int(a / hop)
        fb = max(fa + 1, int(b / hop))
        window = active[fa:min(fb, active.size)]
        seg_dur = max((b - a) / sr, 1e-6)

        ratio = float(window.mean()) if window.size else 0.0
        seconds = min(seg_dur, float(window.sum()) / fps) if window.size else 0.0
        if b <= a:
            seg_db = None
        else:
            # envelope-derived segment level (a debug field only)
            seg_rms = rms[fa:min(fb, rms.size)]
            seg_db = float(20.0 * np.log10(np.sqrt(np.mean(np.square(seg_rms)) + 1e-24))) if seg_rms.size else None
        decision = ratio >= ratio_thr
        reason = (
            "vocal_activity_ratio_gte_threshold" if decision else "vocal_activity_ratio_lt_threshold"
        )
        flags.append(bool(decision))
        debug.append({
            "index": i,
            "start_s": a / sr,
            "end_s": b / sr,
            "duration_s": seg_dur,
            "vocal_activity_ratio": ratio,
            "vocal_activity_seconds": seconds,
            "activity_ratio_threshold": ratio_thr,
            "activity_threshold_db": db_thr,
            "rms_db": seg_db,
            "decision": bool(decision),
            "decision_reason": reason,
            "reason": reason,
            "threshold_source": "vocal_activity_ratio",
        })
    return flags, debug


def pure_music_spans(
    sr: int,
    *,
    act_rms: np.ndarray,
    min_duration_s: Optional[float] = None,
    threshold_db: Optional[float] = None,
) -> List[Tuple[float, float]]:
    """Long vocal-inactive spans (intros, interludes, outros) of the
    activity envelope."""
    if min_duration_s is None:
        min_duration_s = float(get_config("v2_mdd.quality_control.pure_music_min_duration", 6.0))
    if threshold_db is None:
        threshold_db = float(get_config("v2_mdd.quality_control.segment_vocal_threshold_db", -50.0))
    hop = max(1, int(0.02 * sr))
    rms = np.asarray(act_rms)
    db = 20.0 * np.log10(rms + 1e-12)
    quiet = db <= threshold_db
    fps = sr / hop
    min_frames = int(min_duration_s * fps)

    edges = np.diff(quiet.astype(np.int8), prepend=0, append=0)
    starts = np.nonzero(edges == 1)[0]
    ends = np.nonzero(edges == -1)[0]
    return [(s / fps, e / fps) for s, e in zip(starts, ends) if e - s >= min_frames]


def merge_weak_human_tails(
    cut_samples: List[int],
    flags: List[bool],
    debug: List[Dict[str, Any]],
    sr: int,
) -> Tuple[List[int], List[bool], List[Dict[str, Any]]]:
    """Merge short, weakly voiced human segments into the following music
    segment."""
    min_piece = float(get_config("v2_mdd.quality_control.segment_min_mix_piece", 2.0))
    ratio_thr = float(get_config("v2_mdd.quality_control.segment_vocal_activity_ratio", 0.10))

    changed = True
    while changed:
        changed = False
        for i in range(len(flags) - 1):
            dur = (cut_samples[i + 1] - cut_samples[i]) / sr
            weak = debug[i].get("vocal_activity_ratio", 1.0) < 2.0 * ratio_thr if i < len(debug) else False
            if flags[i] and not flags[i + 1] and dur < min_piece and weak:
                # drop the cut between i and i+1; the merged segment is music
                del cut_samples[i + 1]
                del flags[i]
                if i < len(debug):
                    nxt = debug[i + 1] if i + 1 < len(debug) else {}
                    merged = dict(nxt)
                    merged["start_s"] = debug[i].get("start_s", merged.get("start_s"))
                    merged["merged_from_segments"] = sorted(
                        set(debug[i].get("merged_from_segments", [i]))
                        | set(nxt.get("merged_from_segments", [i + 1]))
                    )
                    merged["decision_reason"] = "weak_human_tail_merged_into_music"
                    merged["reason"] = merged["decision_reason"]
                    debug[i:i + 2] = [merged]
                changed = True
                break
    return cut_samples, flags, debug
