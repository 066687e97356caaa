"""Threshold derivation and the schema-v3 expansion.

Counterpart of ``audio_cut_tpu/config/derive.py``: the energy-valley
threshold multipliers of the pause detector (< 90 BPM slow, > 140 BPM fast,
the MDD gain, the clamps, rms_ratio = peak_ratio + 0.06), the min-pause
adaptation and the pause-stats multiplier; and the minimal schema-v3 config
that the style profiles (``config/auto_profile.py``) expand into the legacy
dotted keys.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional, Tuple

_RMS_OFFSET = 0.06


def _clamp(x: float, lo: float, hi: float) -> float:
    return max(lo, min(hi, x))


@dataclass
class AdaptStats:
    bpm: Optional[float] = None
    global_mdd: Optional[float] = None


@dataclass
class DerivedThresholds:
    peak_ratio: float
    rms_ratio: float
    slow_multiplier: float
    fast_multiplier: float
    clamp_min: float
    clamp_max: float


def derive_rms_ratio(peak_ratio: float) -> float:
    return peak_ratio + _RMS_OFFSET


def resolve_threshold(
    base_ratio: float,
    adapt_cfg: Optional[Dict[str, Any]],
    stats: AdaptStats,
) -> DerivedThresholds:
    """BPM/MDD-adaptive energy-valley thresholds."""
    cfg = adapt_cfg or {}
    bpm_cfg = cfg.get("bpm", {}) or {}
    clamp_min = float(cfg.get("clamp_min", 0.85))
    clamp_max = float(cfg.get("clamp_max", 1.15))
    slow_mult = float(bpm_cfg.get("slow_multiplier", 1.08))
    fast_mult = float(bpm_cfg.get("fast_multiplier", 0.92))

    peak = float(base_ratio)
    if stats.bpm and stats.bpm > 0:
        if stats.bpm < 90.0:
            peak *= _clamp(slow_mult, clamp_min, clamp_max)
        elif stats.bpm > 140.0:
            peak *= _clamp(fast_mult, clamp_min, clamp_max)
        peak = _clamp(peak, base_ratio * clamp_min, base_ratio * clamp_max)

    mdd_cfg = cfg.get("mdd", {}) or {}
    if stats.global_mdd is not None:
        mult = float(mdd_cfg.get("base", 1.0)) + float(mdd_cfg.get("gain", 0.2)) * stats.global_mdd
        peak *= _clamp(mult, clamp_min, clamp_max)

    peak = _clamp(peak, 0.05, 0.6)
    rms = _clamp(derive_rms_ratio(base_ratio), peak + 0.02, 0.72)
    return DerivedThresholds(peak, rms, slow_mult, fast_mult, clamp_min, clamp_max)


def resolve_min_pause(base_pause: float, adapt_strength: float, stats: AdaptStats) -> float:
    """Shrink the min pause on fast songs, grow it on slow ones."""
    if not stats.bpm or stats.bpm <= 0:
        return base_pause
    strength = _clamp(adapt_strength, 0.0, 1.5)
    normalized = _clamp((stats.bpm - 110.0) / 110.0, -1.0, 1.0)
    return max(0.3, base_pause - 0.18 * strength * normalized)


def resolve_pause_stats_multiplier(cls: str, multipliers: Optional[Dict[str, float]] = None) -> float:
    m = multipliers or {}
    defaults = {"slow": 1.08, "medium": 1.0, "fast": 0.92}
    return float(m.get(cls, defaults.get(cls, 1.0)))


# -- schema v3 -------------------------------------------------------------


@dataclass
class SchemaV3Config:
    """The 11-field minimal config of a style profile."""

    name: str = "default"
    comment: str = ""
    sample_rate: int = 44100
    channels: int = 1
    min_pause_s: float = 0.5
    threshold_base_ratio: float = 0.26
    adapt_bpm_strength: float = 1.0
    adapt_mdd_strength: float = 1.0
    min_gap_s: float = 1.2
    nms_topk: Optional[int] = None
    guard_max_shift_ms: float = 450.0
    guard_floor_db: Optional[float] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_mapping(cls, data: Dict[str, Any]) -> "SchemaV3Config":
        known = {f for f in cls.__dataclass_fields__ if f != "extra"}
        kwargs = {k: v for k, v in data.items() if k in known}
        extra = {k: v for k, v in data.items() if k not in known}
        return cls(**kwargs, extra=extra)


def _bpm_multipliers(strength: float) -> Dict[str, float]:
    s = _clamp(strength, 0.0, 1.5)
    return {
        "slow_multiplier": 1.0 + 0.08 * s,
        "medium_multiplier": 1.0,
        "fast_multiplier": 1.0 - 0.08 * s,
    }


def _bpm_clamp(strength: float) -> Tuple[float, float]:
    s = _clamp(strength, 0.0, 1.5)
    return 1.0 - 0.15 * s, 1.0 + 0.15 * s


def _mdd_params(strength: float) -> Tuple[float, float]:
    return 1.0, 0.2 * _clamp(strength, 0.0, 1.5)


def build_legacy_overrides(schema: SchemaV3Config) -> Dict[str, Any]:
    """Expand schema v3 into the legacy dotted key space."""
    mults = _bpm_multipliers(schema.adapt_bpm_strength)
    clamp_min, clamp_max = _bpm_clamp(schema.adapt_bpm_strength)
    mdd_base, mdd_gain = _mdd_params(schema.adapt_mdd_strength)
    return {
        "meta": {"schema_version": 3, "schema_name": schema.name, "schema_comment": schema.comment},
        "audio": {"sample_rate": schema.sample_rate, "channels": schema.channels},
        "v2_mdd": {
            "pure_vocal_detection": {
                "min_pause_duration": schema.min_pause_s,
                "peak_relative_threshold_ratio": schema.threshold_base_ratio,
                "rms_relative_threshold_ratio": derive_rms_ratio(schema.threshold_base_ratio),
                "relative_threshold_adaptation": {
                    "enable": True,
                    "bpm": mults,
                    "pause_stats_multipliers": {
                        "slow": mults["slow_multiplier"],
                        "medium": mults["medium_multiplier"],
                        "fast": mults["fast_multiplier"],
                    },
                    "mdd": {"base": mdd_base, "gain": mdd_gain},
                    "clamp_min": clamp_min,
                    "clamp_max": clamp_max,
                },
                "valley_scoring": {
                    "max_kept_after_nms": (schema.nms_topk * 20) if schema.nms_topk else None,
                },
            },
            "quality_control": {
                "min_split_gap": schema.min_gap_s,
                "nms_topk_per_10s": schema.nms_topk,
                "enforce_quiet_cut": {
                    "search_right_ms": schema.guard_max_shift_ms,
                    "floor_db_override": schema.guard_floor_db,
                },
            },
        },
    }


def _flatten(nested: Dict[str, Any], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for key, value in nested.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            yield from _flatten(value, path)
        else:
            yield path, value


def build_runtime_override_map(schema: SchemaV3Config) -> Dict[str, Any]:
    return {k: v for k, v in _flatten(build_legacy_overrides(schema)) if v is not None}
