"""Intent surface (v2.8) + AutoProfile style estimation.

Counterpart of ``audio_cut_tpu/config/auto_profile.py``: alignment stops
(lyric..beat -> 0..1), segment-density stops (few/medium/many), lyric/beat
weight poles, per-style phrase weights, resolve_smart_cut_intent with the
deprecated cut_style mapping, derive_alignment_overrides (two-pole lerp +
beat-candidate base score ramp + planner beat_conflict_weight = 0.30*a),
rule-based estimate_style from BPM/MDD/energy-CV/vocal-coverage, BPM-anchor
profile interpolation, and duration-knob derivation into planner/layout keys.

The style profiles are the packaged ``profiles.json``: for each name, what
``yaml.safe_load`` gives for the JAX package's ``config/profiles/<name>.yaml``,
so the port reads them without PyYAML.
"""

from __future__ import annotations

import json
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

from audio_cut_tpu_torch.config.derive import SchemaV3Config, build_runtime_override_map

_PROFILES = Path(__file__).resolve().parent / "profiles.json"

PROFILE_ANCHORS: Tuple[Tuple[float, str], ...] = (
    (80.0, "ballad"),
    (110.0, "pop"),
    (140.0, "rap"),
    (160.0, "edm"),
)

ALIGNMENT_STOPS: Dict[str, float] = {
    "lyric": 0.0,
    "lyric_lean": 0.25,
    "balanced": 0.5,
    "beat_lean": 0.75,
    "beat": 1.0,
}

SEGMENT_DURATION_STOPS: Dict[str, Tuple[float, float]] = {
    "few": (10.0, 18.0),
    "medium": (5.0, 12.0),
    "many": (3.0, 8.0),
}

LYRIC_POLE: Dict[str, float] = {
    "acoustic_pause": 0.38, "asr_gap": 0.26, "sentence_end": 0.22,
    "beat_affinity": 0.02, "mdd_affinity": 0.06, "breath": 0.10,
    "inside_word_penalty": 0.85, "singing_penalty": 0.50,
}
BEAT_POLE: Dict[str, float] = {
    "acoustic_pause": 0.22, "asr_gap": 0.10, "sentence_end": 0.08,
    "beat_affinity": 0.32, "mdd_affinity": 0.12, "breath": 0.10,
    "inside_word_penalty": 0.80, "singing_penalty": 0.50,
}
_WEIGHT_KEYS = tuple(LYRIC_POLE.keys())
_DEFAULT_TARGET = SEGMENT_DURATION_STOPS["medium"]

STYLE_WEIGHTS: Dict[str, Dict[str, float]] = {
    "ballad": {"acoustic_pause": 0.40, "asr_gap": 0.20, "sentence_end": 0.20,
               "beat_affinity": 0.05, "mdd_affinity": 0.05, "breath": 0.10,
               "inside_word_penalty": 0.80, "singing_penalty": 0.50},
    "pop": {"acoustic_pause": 0.35, "asr_gap": 0.20, "sentence_end": 0.15,
            "beat_affinity": 0.08, "mdd_affinity": 0.10, "breath": 0.12,
            "inside_word_penalty": 0.80, "singing_penalty": 0.50},
    "rap": {"acoustic_pause": 0.28, "asr_gap": 0.16, "sentence_end": 0.12,
            "beat_affinity": 0.14, "mdd_affinity": 0.14, "breath": 0.16,
            "inside_word_penalty": 0.85, "singing_penalty": 0.50},
    "edm": {"acoustic_pause": 0.25, "asr_gap": 0.12, "sentence_end": 0.10,
            "beat_affinity": 0.22, "mdd_affinity": 0.14, "breath": 0.17,
            "inside_word_penalty": 0.85, "singing_penalty": 0.50},
}


# -- intent resolution ------------------------------------------------------


def resolve_alignment(value: Any) -> float:
    if value is None or value == "":
        return 0.5
    if isinstance(value, str):
        key = value.strip().lower()
        if key in ALIGNMENT_STOPS:
            return ALIGNMENT_STOPS[key]
        try:
            value = float(key)
        except ValueError:
            raise ValueError(
                f"smart_cut.alignment must be one of {sorted(ALIGNMENT_STOPS)} or 0.0-1.0, got {value!r}"
            )
    a = float(value)
    if not 0.0 <= a <= 1.0:
        raise ValueError(f"smart_cut.alignment must be within 0.0-1.0, got {a}")
    return a


def resolve_segment_duration(value: Any) -> Tuple[float, float]:
    if value is None or value == "":
        return _DEFAULT_TARGET
    if isinstance(value, str):
        key = value.strip().lower()
        if key in SEGMENT_DURATION_STOPS:
            return SEGMENT_DURATION_STOPS[key]
        raise ValueError("smart_cut.segments must be few, medium, many, or [min_s, max_s]")
    if isinstance(value, Sequence) and len(value) == 2:
        lo, hi = float(value[0]), float(value[1])
        if lo <= 0 or hi <= lo:
            raise ValueError(f"invalid target duration range: {value!r}")
        return lo, hi
    raise ValueError("smart_cut.segments must be few, medium, many, or [min_s, max_s]")


def _segments_name(value: Any, target: Tuple[float, float]) -> str:
    if isinstance(value, str) and value.strip().lower() in SEGMENT_DURATION_STOPS:
        return value.strip().lower()
    for name, stops in SEGMENT_DURATION_STOPS.items():
        if stops == target:
            return name
    return "custom"


def resolve_smart_cut_intent(
    smart_cut: Mapping[str, Any],
    *,
    explicit_keys: Optional[Set[str]] = None,
) -> Dict[str, Any]:
    explicit_keys = explicit_keys or set()
    profile = str(smart_cut.get("profile", "auto") or "auto").strip().lower()
    lyrics = str(smart_cut.get("lyrics", "auto") or "auto").strip().lower()
    cut_style = str(smart_cut.get("cut_style", "") or "").strip().lower()

    alignment_raw = smart_cut.get("alignment")
    segments_raw = smart_cut.get("segments")
    target_raw = smart_cut.get("target_duration_s")

    alignment_explicit = (
        "smart_cut.alignment" in explicit_keys
        or alignment_raw not in {None, "", "balanced", 0.5}
    )
    segments_explicit = (
        "smart_cut.segments" in explicit_keys or segments_raw not in {None, "", "medium"}
    )
    target_default = target_raw is None or tuple(
        float(x) for x in (target_raw if isinstance(target_raw, Sequence) and not isinstance(target_raw, str) else _DEFAULT_TARGET)
    ) == _DEFAULT_TARGET

    if cut_style and cut_style != "natural":
        warnings.warn(
            "smart_cut.cut_style is deprecated; use smart_cut.alignment and smart_cut.segments",
            DeprecationWarning, stacklevel=2,
        )
        if cut_style == "rhythmic" and not alignment_explicit:
            alignment_raw = 0.7
        if cut_style == "dense" and not segments_explicit and target_default:
            segments_raw = "many"

    alignment = resolve_alignment(alignment_raw)
    target = _resolve_target({**smart_cut, "segments": segments_raw, "target_duration_s": target_raw},
                             explicit_keys=explicit_keys)
    return {
        "target_duration_s": [round(target[0], 4), round(target[1], 4)],
        "segments": _segments_name(segments_raw, target),
        "alignment": alignment,
        "alignment_raw": alignment_raw if alignment_raw is not None else "balanced",
        "lyrics": lyrics,
        "profile": profile,
    }


def _resolve_target(
    smart_cut: Mapping[str, Any], *, explicit_keys: Optional[Set[str]] = None
) -> Tuple[float, float]:
    explicit_keys = explicit_keys or set()
    segments_target = resolve_segment_duration(smart_cut.get("segments"))
    target_raw = smart_cut.get("target_duration_s")
    if target_raw is None:
        return segments_target
    target = resolve_segment_duration(target_raw)
    target_explicit = (
        "smart_cut.target_duration_s" in explicit_keys or target != _DEFAULT_TARGET
    )
    # an explicitly-set numeric range wins over the density name
    return target if target_explicit else segments_target


# -- alignment & duration overrides -------------------------------------------


def _lerp(a: float, b: float, t: float) -> float:
    return a + (b - a) * t


def _beat_candidate_base_score(a: float) -> float:
    if a <= 0.3:
        return 0.0
    if a <= 0.5:
        return 0.3 * ((a - 0.3) / 0.2)
    return 0.3 + 0.35 * ((a - 0.5) / 0.5)


def derive_alignment_overrides(
    alignment: Any,
    style_weights: Mapping[str, float],
    *,
    alignment_poles: Optional[Mapping[str, Any]] = None,
) -> Dict[str, Any]:
    a = resolve_alignment(alignment)
    if abs(a - 0.5) <= 1e-9:
        return {}
    poles = alignment_poles or {}
    lyric = {**LYRIC_POLE, **(poles.get("lyric") or {})}
    beat = {**BEAT_POLE, **(poles.get("beat") or {})}
    base = {k: float(style_weights.get(k, STYLE_WEIGHTS["pop"][k])) for k in _WEIGHT_KEYS}

    if a <= 0.5:
        t = a * 2.0
        weights = {k: _lerp(float(lyric[k]), base[k], t) for k in _WEIGHT_KEYS}
    else:
        t = (a - 0.5) * 2.0
        weights = {k: _lerp(base[k], float(beat[k]), t) for k in _WEIGHT_KEYS}

    out = {f"phrase_boundary.weights.{k}": round(v, 4) for k, v in weights.items()}
    out["vpbd.beat_candidates.base_score"] = round(_beat_candidate_base_score(a), 4)
    out["global_planner.beat_conflict_weight"] = round(0.30 * a, 4)
    return out


def derive_smart_cut_overrides(
    smart_cut: Mapping[str, Any], *, explicit_keys: Optional[Set[str]] = None
) -> Dict[str, float]:
    """Duration knobs -> planner/layout/quality keys."""
    tmin, tmax = _resolve_target(smart_cut, explicit_keys=explicit_keys)
    hard_min = round(max(1.0, tmin * 0.4), 4)
    hard_max = round(tmax * 1.5, 4)
    return {
        "global_planner.target_min_s": round(tmin, 4),
        "global_planner.target_max_s": round(tmax, 4),
        "global_planner.hard_min_s": hard_min,
        "global_planner.hard_max_s": hard_max,
        "v2_mdd.segment_layout.soft_min_s": round(tmin, 4),
        "v2_mdd.segment_layout.soft_max_s": round(tmax, 4),
        "v2_mdd.quality_control.segment_max_duration": hard_max,
    }


# -- style estimation ------------------------------------------------------------


@dataclass
class StyleEstimate:
    profile: str
    confidence: float
    features: Dict[str, float] = field(default_factory=dict)
    fallback_reason: Optional[str] = None


def estimate_style(features: Any) -> StyleEstimate:
    """Rule-based style estimate from TrackFeatures."""
    bpm = float(getattr(features, "bpm", 0.0) or 0.0)
    if getattr(features, "tempo_strength", 1.0) < 0.05:
        bpm = 0.0
    rms = np.asarray(getattr(features, "rms", np.zeros(0)))
    mdd = float(np.mean(getattr(features, "mdd", np.zeros(1))))
    mean_rms = float(rms.mean()) if rms.size else 0.0
    energy_cv = float(rms.std() / mean_rms) if mean_rms > 1e-9 else 0.0
    coverage = float(getattr(features, "extras", {}).get("vocal_coverage_ratio", 0.6)) \
        if isinstance(getattr(features, "extras", None), dict) else 0.6

    feat = {
        "bpm": round(max(0.0, bpm), 4),
        "global_mdd": round(float(np.clip(mdd, 0, 1)), 4),
        "energy_cv": round(max(0.0, energy_cv), 4),
        "vocal_coverage_ratio": round(float(np.clip(coverage, 0, 1)), 4),
    }
    if bpm <= 0.0:
        return StyleEstimate("pop", 0.25, feat, fallback_reason="low_confidence")
    if bpm <= 88.0 and energy_cv <= 0.25:
        return StyleEstimate("ballad", 0.78, feat)
    if bpm >= 122.0 and energy_cv >= 0.65 and coverage <= 0.55:
        return StyleEstimate("edm", 0.82, feat)
    if bpm >= 118.0 and mdd >= 0.45 and coverage >= 0.68:
        return StyleEstimate("rap", 0.82, feat)
    return StyleEstimate("pop", 0.70, feat)


# -- profiles ---------------------------------------------------------------------


def load_profile(name: str) -> SchemaV3Config:
    profiles = json.loads(_PROFILES.read_text(encoding="utf-8"))
    if name not in profiles:
        raise FileNotFoundError(f"unknown style profile {name!r}")
    data = profiles[name] or {}
    overrides = dict(data.get("overrides") or {})
    overrides.setdefault("name", data.get("profile", name))
    overrides.setdefault("comment", data.get("comment", ""))
    return SchemaV3Config.from_mapping(overrides)


def profile_override_map(name: str) -> Dict[str, Any]:
    return build_runtime_override_map(load_profile(name))


def _anchor_weights(estimate: StyleEstimate) -> Dict[str, float]:
    bpm = float(estimate.features.get("bpm", 0.0) or 0.0)
    if estimate.profile == "edm":
        return {"edm": 1.0}
    if bpm <= PROFILE_ANCHORS[0][0]:
        return {PROFILE_ANCHORS[0][1]: 1.0}
    for (lb, ln), (rb, rn) in zip(PROFILE_ANCHORS, PROFILE_ANCHORS[1:]):
        if lb <= bpm <= rb:
            rw = (bpm - lb) / max(rb - lb, 1e-9)
            weights = {ln: 1.0 - rw, rn: rw}
            return {k: round(v, 4) for k, v in weights.items() if v > 1e-4}
    return {PROFILE_ANCHORS[-1][1]: 1.0}


def build_auto_profile_overrides(estimate: StyleEstimate, *, cut_style: str = "natural") -> Dict[str, Any]:
    """Interpolated profile overrides + style phrase weights + meta echo."""
    anchors = {"pop": 1.0} if estimate.confidence < 0.6 else _anchor_weights(estimate)
    per_profile = {name: profile_override_map(name) for name in anchors}
    keys = sorted({k for ov in per_profile.values() for k in ov})
    dominant = max(anchors.items(), key=lambda kv: kv[1])[0]

    overrides: Dict[str, Any] = {}
    for key in keys:
        vals = [(name, per_profile[name].get(key)) for name in anchors if key in per_profile[name]]
        if vals and all(isinstance(v, (int, float)) and not isinstance(v, bool) for _, v in vals):
            total_w = sum(anchors[name] for name, _ in vals)
            overrides[key] = round(sum(anchors[name] * float(v) for name, v in vals) / max(total_w, 1e-9), 6)
        elif key in per_profile[dominant]:
            overrides[key] = per_profile[dominant][key]

    style = "pop" if estimate.confidence < 0.6 else estimate.profile
    weights = dict(STYLE_WEIGHTS.get(style, STYLE_WEIGHTS["pop"]))
    if cut_style == "rhythmic":
        weights["beat_affinity"] = min(0.25, weights["beat_affinity"] + 0.04)
        weights["breath"] = min(0.20, weights["breath"] + 0.02)
        weights["acoustic_pause"] = max(0.20, weights["acoustic_pause"] - 0.04)
    overrides.update({f"phrase_boundary.weights.{k}": v for k, v in weights.items()})

    overrides["meta.auto_profile"] = {
        "style": style,
        "confidence": round(float(estimate.confidence), 4),
        "bpm": estimate.features.get("bpm"),
        "mdd": estimate.features.get("global_mdd"),
        "features": dict(estimate.features),
        "anchor_weights": anchors,
        "fallback_reason": estimate.fallback_reason,
        "applied_overrides": sorted(k for k in overrides if not k.startswith("meta.")),
    }
    overrides["meta.profile"] = "auto"
    return overrides
