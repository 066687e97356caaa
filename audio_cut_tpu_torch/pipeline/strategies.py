"""Hybrid beat-alignment strategies.

Counterpart of ``audio_cut_tpu/pipeline/strategies.py``:

* ``SegmentationContext``/``SegmentationResult``, the cut dedupe, and the
  vocal quiet-window guard against the 5th-percentile RMS floor;
* ``snap_to_beat``: snap the MDD cuts to the nearest beat only inside chorus
  regions, within min(tolerance, 0.4 * beat period); VAD protection takes
  the nearest QUIET beat; ``chorus_force_snap`` snaps everywhere with the
  whole tolerance; high density adds bar-start cuts in the chorus; snapped
  and added cuts carry the _lib flag;
* ``beat_only``: bar-boundary cuts in high-energy bars every
  ``bars_per_cut``, the MDD cuts elsewhere.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from audio_cut_tpu_torch.analysis.beat_analyzer import BeatAnalysisResult
from audio_cut_tpu_torch.analysis.features import TrackFeatures


@dataclass
class SegmentationContext:
    duration_s: float
    mdd_cuts: List[float]                 # cuts from the v2.2_mdd pass
    beat_analysis: BeatAnalysisResult
    features: TrackFeatures
    vocal_rms: Optional[np.ndarray] = None   # feature-grid RMS of the vocal stem
    config: Dict[str, object] = field(default_factory=dict)


@dataclass
class SegmentationResult:
    cuts: List[float]
    lib_flags: List[bool]                 # True where the cut is beat-aligned
    strategy: str = ""


def _dedupe(cuts: List[Tuple[float, bool]], min_gap_s: float = 0.25) -> Tuple[List[float], List[bool]]:
    out_t: List[float] = []
    out_l: List[bool] = []
    for t, lib in sorted(cuts):
        if out_t and t - out_t[-1] < min_gap_s:
            out_l[-1] = out_l[-1] or lib
            continue
        out_t.append(t)
        out_l.append(lib)
    return out_t, out_l


class _QuietGuard:
    """Vocal quiet-window check vs the 5th-percentile RMS floor."""

    def __init__(self, ctx: SegmentationContext, window_s: float = 0.1):
        self.enabled = ctx.vocal_rms is not None and ctx.vocal_rms.size > 0
        if self.enabled:
            self.rms = ctx.vocal_rms
            self.hop_s = ctx.features.hop_s
            self.floor = float(np.percentile(self.rms, 5))
            self.half = max(1, int(round(window_s / self.hop_s)))

    def is_quiet(self, t: float, tolerance: float = 3.0) -> bool:
        if not self.enabled:
            return True
        c = int(round(t / self.hop_s))
        lo = max(0, c - self.half)
        hi = min(self.rms.size, c + self.half + 1)
        if hi <= lo:
            return True
        return float(self.rms[lo:hi].mean()) <= max(self.floor * tolerance, self.floor + 1e-6)


def _in_chorus(t: float, beat_analysis: BeatAnalysisResult) -> bool:
    return any(r.start_s <= t < r.end_s for r in beat_analysis.chorus_regions)


class SnapToBeatStrategy:
    """Plan C: MDD cuts, beat-snapped inside chorus regions."""

    name = "snap_to_beat"

    def generate_cut_points(self, ctx: SegmentationContext) -> SegmentationResult:
        cfg = ctx.config
        tol_cfg = float(cfg.get("snap_tolerance_ms", 200)) / 1000.0
        force = bool(cfg.get("chorus_force_snap", False))
        vad_protect = bool(cfg.get("vad_protection", True))
        density = str(cfg.get("beat_cut_density", "medium"))
        bars_per_cut = int(cfg.get("bars_per_cut", 1))

        beats = ctx.beat_analysis.beat_times
        period = 60.0 / max(ctx.beat_analysis.bpm, 1e-6)
        tolerance = tol_cfg if force else min(tol_cfg, 0.4 * period)
        guard = _QuietGuard(ctx)

        cuts: List[Tuple[float, bool]] = []
        for t in ctx.mdd_cuts:
            snapped = t
            lib = False
            if beats.size and (force or _in_chorus(t, ctx.beat_analysis)):
                order = np.argsort(np.abs(beats - t))
                for j in order[:4]:
                    bt = float(beats[j])
                    if abs(bt - t) > tolerance:
                        break
                    if not vad_protect or guard.is_quiet(bt):
                        snapped = bt
                        lib = True
                        break
            cuts.append((snapped, lib))

        # high density: add bar-start cuts inside chorus regions
        if density == "high" and ctx.beat_analysis.bar_times.size > 1:
            for i, bar_t in enumerate(ctx.beat_analysis.bar_times[:-1]):
                if i % max(1, bars_per_cut):
                    continue
                if not _in_chorus(float(bar_t), ctx.beat_analysis):
                    continue
                if vad_protect and not guard.is_quiet(float(bar_t)):
                    continue
                if 0.0 < bar_t < ctx.duration_s:
                    cuts.append((float(bar_t), True))

        out_t, out_l = _dedupe(cuts)
        return SegmentationResult(out_t, out_l, strategy=self.name)


class BeatOnlyStrategy:
    """Plan B: bar-boundary cuts in high-energy bars, MDD cuts elsewhere."""

    name = "beat_only"

    def generate_cut_points(self, ctx: SegmentationContext) -> SegmentationResult:
        cfg = ctx.config
        bars_per_cut = int(cfg.get("bars_per_cut", 2))
        vad_protect = bool(cfg.get("vad_protection", True))
        guard = _QuietGuard(ctx)
        ba = ctx.beat_analysis

        cuts: List[Tuple[float, bool]] = []
        high_spans: List[Tuple[float, float]] = []
        if ba.bar_times.size > 1:
            for i in range(0, ba.bar_times.size - 1, max(1, bars_per_cut)):
                if i >= ba.high_energy_mask.size or not ba.high_energy_mask[i]:
                    continue
                t = float(ba.bar_times[i])
                high_spans.append((t, float(ba.bar_times[min(i + bars_per_cut, ba.bar_times.size - 1)])))
                if 0.0 < t < ctx.duration_s and (not vad_protect or guard.is_quiet(t)):
                    cuts.append((t, True))

        def in_high(t: float) -> bool:
            if ba.high_energy_mask.size == 0:
                return False
            idx = int(np.searchsorted(ba.bar_times, t, side="right")) - 1
            return 0 <= idx < ba.high_energy_mask.size and bool(ba.high_energy_mask[idx])

        for t in ctx.mdd_cuts:
            if not in_high(t):
                cuts.append((t, False))

        out_t, out_l = _dedupe(cuts)
        return SegmentationResult(out_t, out_l, strategy=self.name)


def build_strategy(name: str):
    if name == "snap_to_beat":
        return SnapToBeatStrategy()
    if name == "beat_only":
        return BeatOnlyStrategy()
    raise ValueError(f"unknown hybrid strategy {name!r}")
