"""BPM/MDD-adaptive thresholds of the pause detector.

Counterpart of the part of ``audio_cut_tpu/config/derive.py`` that
``detection/pause_detector.py`` uses: the energy-valley threshold
multipliers (< 90 BPM slow, > 140 BPM fast, the MDD gain, the clamps,
rms_ratio = peak_ratio + 0.06), the min-pause adaptation and the pause-stats
multiplier. The schema-v3 expansion serves the style profiles, which come
with the modes that use them (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

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
