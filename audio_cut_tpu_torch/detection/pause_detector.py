"""Pure-vocal pause detection: the v2.2_mdd detector.

Counterpart of ``audio_cut_tpu/detection/pause_detector.py``, fed by the
detection bundle: the relative-energy valley scan over the 10 ms vocal
envelope, gated by the VAD focus windows, with the BPM/MDD threshold
derivation, the vocal-pause-profile multiplier, merge-close compression, the
total-valley cap, the MDD confidence enhancement and the precise cut points
from the decimated dB grid. All of it is host numpy over small arrays, as in
the JAX package.

The legacy multi-feature mode (``enable_relative_energy_mode: false``) also
takes the vocal waveform: it rescores the valleys by voicing (YIN) and
formant (LPC) evidence from ``ops/voice.py``, computed on the device of the
vocal stem it is given, and its cut points take their silence floor from
the host waveform instead of the dB grid.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from audio_cut_tpu_torch.analysis.features import TrackFeatures
from audio_cut_tpu_torch.config import get_config
from audio_cut_tpu_torch.config.derive import (
    AdaptStats,
    resolve_min_pause,
    resolve_pause_stats_multiplier,
    resolve_threshold,
)

if TYPE_CHECKING:
    from audio_cut_tpu_torch.separation.engine import SeparationResult

logger = logging.getLogger(__name__)


@dataclass
class PureVocalPause:
    start_time: float
    end_time: float
    duration: float
    pause_type: str
    confidence: float
    features: Dict[str, Any] = field(default_factory=dict)
    cut_point: float = 0.0
    quality_grade: str = "A"


def _runs(mask: np.ndarray) -> np.ndarray:
    edges = np.diff(mask.astype(np.int8), prepend=0, append=0)
    starts = np.nonzero(edges == 1)[0]
    ends = np.nonzero(edges == -1)[0]
    return np.stack([starts, ends], axis=1) if starts.size else np.zeros((0, 2), dtype=np.int64)


def _fill_short_false_runs(mask: np.ndarray, max_len: int) -> np.ndarray:
    out = mask.copy()
    for s, e in _runs(~mask):
        if e - s <= max_len:
            out[s:e] = True
    return out


def _drop_short_true_runs(mask: np.ndarray, max_len: int) -> np.ndarray:
    out = mask.copy()
    for s, e in _runs(mask):
        if e - s <= max_len:
            out[s:e] = False
    return out


def _focus_mask(n: int, fps: float, windows: Optional[List[Tuple[float, float]]]) -> Optional[np.ndarray]:
    if not windows:
        return None
    t = np.arange(n) / fps
    m = np.zeros(n, dtype=bool)
    for a, b in windows:
        if b > a:
            m |= (t >= a) & (t <= b)
    return m if m.any() else None


class PureVocalPauseDetector:
    VALLEY_HOP_S = 0.01  # the grid of the bundle's vocal_rms_fine
    VALLEY_MIN_PAUSE_S = 0.2  # scan-level floor; the configured min pause applies later

    def __init__(self, sample_rate: int) -> None:
        self.sr = int(sample_rate)
        self.hop = max(1, int(round(self.VALLEY_HOP_S * self.sr)))

    def detect_pure_vocal_pauses(
        self,
        *,
        rms_env: np.ndarray,
        env_db_grid: np.ndarray,
        env_db_stride: int,
        n_samples: int,
        features: Optional[TrackFeatures] = None,
        focus_windows: Optional[List[Tuple[float, float]]] = None,
        enable_mdd: bool = True,
        stems: Optional[SeparationResult] = None,
    ) -> List[PureVocalPause]:
        """Pauses from the bundle's 10 ms vocal envelope ``rms_env`` and its
        decimated fine dB grid ``env_db_grid`` of a track of ``n_samples``.
        The legacy multi-feature mode also needs the track's ``stems``: its
        YIN/LPC analysis runs on ``stems.vocal_device`` where it lives, and
        it reads the host copy ``stems.vocal_track`` (downloaded once, on
        first use; only that mode reads it)."""
        cfg = get_config("v2_mdd.pure_vocal_detection", {}) or {}
        n_wave = int(n_samples)
        if not cfg.get("enable", True) or n_wave == 0:
            return []

        stats = AdaptStats(
            bpm=features.bpm if features else None,
            global_mdd=float(np.mean(features.mdd)) if features is not None and features.mdd.size else None,
        )
        thresholds = resolve_threshold(
            float(cfg.get("peak_relative_threshold_ratio", 0.26)),
            cfg.get("relative_threshold_adaptation", {}),
            stats,
        )
        rms = np.asarray(rms_env)
        fps = self.sr / self.hop

        # VPP multiplier from in-song rest statistics
        vpp_mult, vpp_log = (1.0, "VPP{disabled}")
        if (cfg.get("pause_stats_adaptation", {}) or {}).get("enable", True):
            vpp_mult, vpp_log = self._estimate_vpp_multiplier(rms, fps, cfg, focus_windows)
        logger.info("%s -> multiplier %.3f", vpp_log, vpp_mult)

        peak_ratio = float(np.clip(thresholds.peak_ratio * vpp_mult, 0.05, 0.6))
        rms_ratio = float(np.clip(thresholds.rms_ratio * vpp_mult, peak_ratio + 0.02, 0.72))

        pauses = self._detect_energy_valleys(rms, fps, peak_ratio, rms_ratio, cfg, features, focus_windows)
        vocal_audio = None
        if not cfg.get("enable_relative_energy_mode", True):
            if stems is None or stems.vocal_device is None:
                raise ValueError(
                    "legacy multi-feature mode (enable_relative_energy_mode=false) "
                    "needs the vocal waveform; pass the stems"
                )
            vocal_audio = stems.vocal_track
            # legacy multi-feature mode: rescore the valleys by voicing,
            # formant, spectral and duration evidence
            pauses = self._apply_multi_feature_scoring(
                pauses, vocal_audio, stems.vocal_device, cfg, features)
        pauses = self._compress(pauses, cfg)
        pauses = self._total_valley_cap(pauses, n_wave / self.sr)
        if enable_mdd and features is not None:
            pauses = self._apply_mdd_enhancement(pauses, features, focus_windows)
        pauses = self._calculate_precise_cut_points(
            pauses, vocal_audio, env_db_grid=env_db_grid, env_db_stride=env_db_stride,
            n_samples=n_wave)
        # final min-pause filter at the configured duration
        min_pause = resolve_min_pause(float(cfg.get("min_pause_duration", 0.5)), 1.0, stats)
        return [p for p in pauses if p.duration >= min(min_pause, 0.5) or p.pause_type.startswith("energy_valley")]

    # -- valley scan ---------------------------------------------------------

    def _detect_energy_valleys(
        self,
        rms: np.ndarray,
        fps: float,
        peak_ratio: float,
        rms_ratio: float,
        cfg: Dict[str, Any],
        features: Optional[TrackFeatures],
        focus_windows: Optional[List[Tuple[float, float]]],
    ) -> List[PureVocalPause]:
        if rms.size == 0:
            return []
        peak_thr = float(rms.max()) * peak_ratio
        avg_thr = float(rms.mean()) * rms_ratio
        threshold = min(peak_thr, avg_thr)

        low = rms < threshold
        fmask = _focus_mask(low.size, fps, focus_windows)
        if fmask is not None:
            low &= fmask

        vs = cfg.get("valley_scoring", {}) or {}
        w_len = float(vs.get("w_len", 0.7))
        w_quiet = float(vs.get("w_quiet", 0.3))
        w_flat = float(vs.get("w_flat", 0.5))

        min_frames = max(1, int(round(self.VALLEY_MIN_PAUSE_S * fps)))
        pauses: List[PureVocalPause] = []
        for s, e in _runs(low):
            if e - s < min_frames:
                continue
            start_t, end_t = s / fps, e / fps
            duration = end_t - start_t
            valley_energy = float(rms[s:e].mean())

            len_score = float(np.clip((duration - 0.20) / (1.50 - 0.20), 0.0, 1.0))
            quiet_score = float(np.clip(1.0 - valley_energy / max(threshold, 1e-12), 0.0, 1.0))
            flat_hint = 0.5
            if features is not None and features.flatness.size:
                st = features.window_stats("flatness", start_t, end_t)
                flat_hint = float(np.clip(1.0 - st["mean"], 0.0, 1.0))
            confidence = float(np.clip(w_len * len_score + w_quiet * quiet_score + w_flat * flat_hint, 0.1, 0.99))

            pauses.append(PureVocalPause(
                start_time=start_t,
                end_time=end_t,
                duration=duration,
                pause_type="energy_valley",
                confidence=confidence,
                features={"energy": valley_energy, "threshold": threshold},
                cut_point=(start_t + end_t) / 2.0,
            ))
        return pauses

    def _apply_multi_feature_scoring(
        self,
        pauses: List[PureVocalPause],
        vocal_audio: np.ndarray,
        vocal_stem: torch.Tensor,
        cfg: Dict[str, Any],
        features: Optional[TrackFeatures],
    ) -> List[PureVocalPause]:
        """Legacy weighted multi-feature confidence: f0 evidence = absence of
        voiced frames inside the pause (batched YIN with Viterbi pitch
        tracking), formant evidence = absence of vocal-tract resonance (LPC
        residual), spectral evidence = how noise-like (flat) the pause is,
        duration evidence = longer pauses cut better. YIN and LPC run once
        over the whole stem ``vocal_stem`` on its device, not per pause; the host vocal ``vocal_audio`` gives the
        pause lengths in samples and the formant frequencies."""
        if not pauses:
            return pauses
        from audio_cut_tpu_torch.ops.voice import (  # noqa: PLC0415 (legacy mode only)
            lpc_formant_frequencies,
            lpc_formant_strength,
            yin_f0,
        )

        w_f0 = float(cfg.get("f0_weight", 0.3))
        w_formant = float(cfg.get("formant_weight", 0.25))
        w_spectral = float(cfg.get("spectral_weight", 0.25))
        w_duration = float(cfg.get("duration_weight", 0.2))
        voiced_thr = float(cfg.get("voicing_threshold", 0.55))
        sr = self.sr

        hop_s = self.VALLEY_HOP_S
        _, voicing = yin_f0(vocal_stem, sr, hop_s=hop_s)
        formant = lpc_formant_strength(vocal_stem, sr, hop_s=hop_s)
        vfps = 1.0 / hop_s

        out: List[PureVocalPause] = []
        for p in pauses:
            a = max(0, int(p.start_time * sr))
            b = min(vocal_audio.size, int(p.end_time * sr))
            if b - a < 256:
                out.append(p)
                continue
            fa = int(p.start_time * vfps)
            fb = int(p.end_time * vfps)
            v_seg = voicing[fa:min(fb, voicing.size)]
            f_seg = formant[fa:min(fb, formant.size)]
            # fraction of pause frames where YIN finds a confident pitch
            voiced_frac = float(np.mean(v_seg >= voiced_thr)) if v_seg.size else 0.0
            f0_score = float(np.clip(1.0 - voiced_frac, 0.0, 1.0))
            # vocal-tract resonance left in the pause
            formant_score = float(np.clip(1.0 - f_seg.mean(), 0.0, 1.0)) if f_seg.size else 0.5

            flat_score = 0.5
            if features is not None and features.flatness.size:
                st = features.window_stats("flatness", p.start_time, p.end_time)
                flat_score = float(np.clip(st["mean"], 0.0, 1.0))  # noise-like pause
            dur_score = float(np.clip((p.duration - 0.2) / 1.3, 0.0, 1.0))

            confidence = float(np.clip(
                w_f0 * f0_score + w_formant * formant_score + w_spectral * flat_score
                + w_duration * dur_score,
                0.1, 0.99,
            ))
            feats = {**p.features, "f0_score": f0_score, "formant_score": formant_score,
                     "flatness_score": flat_score, "duration_score": dur_score}
            if formant_score < 0.5:
                # a suspicious pause (resonance present): its resonances, for debugging
                feats["formant_freqs_hz"] = [
                    round(float(f), 1)
                    for f in lpc_formant_frequencies(vocal_audio[a:b], sr)[:4]
                ]
            out.append(PureVocalPause(
                start_time=p.start_time, end_time=p.end_time, duration=p.duration,
                pause_type="multi_feature", confidence=confidence,
                features=feats,
                cut_point=p.cut_point, quality_grade=p.quality_grade,
            ))
        return out

    # -- compression / caps ---------------------------------------------------

    @staticmethod
    def _compress(pauses: List[PureVocalPause], cfg: Dict[str, Any]) -> List[PureVocalPause]:
        if not pauses:
            return pauses
        vs = cfg.get("valley_scoring", {}) or {}
        merge_gap = float(vs.get("merge_close_ms", 450)) / 1000.0
        max_raw = int(vs.get("max_raw_candidates", 1200))

        merged: List[PureVocalPause] = []
        for p in sorted(pauses, key=lambda x: x.start_time):
            if merged and p.start_time - merged[-1].end_time <= merge_gap:
                prev = merged[-1]
                end = max(prev.end_time, p.end_time)
                merged[-1] = PureVocalPause(
                    start_time=prev.start_time,
                    end_time=end,
                    duration=end - prev.start_time,
                    pause_type=prev.pause_type,
                    confidence=max(prev.confidence, p.confidence),
                    features=prev.features,
                )
            else:
                merged.append(p)

        if len(merged) > max_raw:
            merged = sorted(merged, key=lambda x: x.confidence, reverse=True)[:max_raw]
            merged.sort(key=lambda x: x.start_time)
        return merged

    @staticmethod
    def _total_valley_cap(pauses: List[PureVocalPause], duration_s: float) -> List[PureVocalPause]:
        """Keep at most duration/segment_min of the quietest valleys."""
        if not pauses:
            return pauses
        seg_min = float(get_config("v2_mdd.quality_control.segment_min_duration", 2.0)) or 2.0
        cap = max(1, int(duration_s // max(seg_min, 1e-6)))
        if len(pauses) <= cap:
            return pauses

        def quietness(p: PureVocalPause) -> Tuple[float, float]:
            thr = float(p.features.get("threshold", 0.0))
            eng = float(p.features.get("energy", 0.0))
            q = thr - eng
            return (q if np.isfinite(q) else 0.0, p.confidence)

        kept = sorted(pauses, key=quietness, reverse=True)[:cap]
        kept.sort(key=lambda p: p.start_time)
        return kept

    # -- MDD enhancement -------------------------------------------------------

    @staticmethod
    def _apply_mdd_enhancement(
        pauses: List[PureVocalPause],
        features: TrackFeatures,
        focus_windows: Optional[List[Tuple[float, float]]] = None,
    ) -> List[PureVocalPause]:
        if not pauses or features.rms.size == 0:
            return pauses
        mcfg = get_config("v2_mdd.musical_dynamic_density", {}) or {}
        w_e = float(mcfg.get("energy_weight", 0.5))
        w_s = float(mcfg.get("spectral_weight", 0.3))
        w_o = float(mcfg.get("onset_weight", 0.2))
        t_mult = float(mcfg.get("threshold_multiplier", 0.2))
        max_mult = float(mcfg.get("max_multiplier", 1.4))
        min_mult = float(mcfg.get("min_multiplier", 0.6))

        rms_max = float(features.rms.max()) or 1.0
        onset_med = float(np.median(features.onset)) + 1e-12
        pad_frames = 10

        fmask = _focus_mask(features.n_frames, features.fps, focus_windows)

        out: List[PureVocalPause] = []
        for p in pauses:
            lo = max(0, features.frame_index(p.start_time) - pad_frames)
            hi = min(features.n_frames, features.frame_index(p.end_time) + pad_frames)
            idx = np.arange(lo, hi)
            if fmask is not None:
                idx = idx[fmask[lo:hi]]
            if idx.size == 0:
                out.append(p)
                continue
            energy_score = float(features.rms[idx].mean()) / rms_max
            spectral_score = 1.0 - float(features.flatness[idx].mean())
            # onset density: frames whose onset is a clear peak (> 3x median),
            # saturating at 5
            onset_count = int(np.sum(features.onset[idx] > 3.0 * onset_med))
            onset_score = min(1.0, onset_count / 5.0)

            mdd_score = energy_score * w_e + spectral_score * w_s + onset_score * w_o
            mult = float(np.clip(1.0 + mdd_score * t_mult, min_mult, max_mult))
            out.append(PureVocalPause(
                start_time=p.start_time,
                end_time=p.end_time,
                duration=p.duration,
                pause_type=f"{p.pause_type}_mdd",
                confidence=p.confidence * mult,
                features={**p.features, "mdd_score": mdd_score, "confidence_multiplier": mult},
                cut_point=p.cut_point,
                quality_grade=p.quality_grade,
            ))
        return out

    # -- precise cut points -----------------------------------------------------

    def _calculate_precise_cut_points(
        self,
        pauses: List[PureVocalPause],
        vocal_audio: Optional[np.ndarray],
        *,
        env_db_grid: np.ndarray,
        env_db_stride: int,
        n_samples: int,
    ) -> List[PureVocalPause]:
        """The quietest point of each pause on the dB grid, a lookahead guard,
        and the pause midpoint where the chosen cut is not quiet relative to
        the pause's own floor: with the host vocal ``vocal_audio``, the
        sample at the cut against a percentile of the pause's 8x-decimated
        |vocal|; without it, the dB grid at the cut against its percentile."""
        n_wave = int(n_samples)
        if not pauses or n_wave == 0:
            return pauses
        sr = self.sr
        guard_ms = float(get_config("vocal_pause_splitting.lookahead_guard_ms", 120))
        floor_pct = float(get_config("vocal_pause_splitting.silence_floor_percentile", 5))
        floor_allow = float(get_config("vocal_pause_splitting.silence_floor_allowance", 0.0)) or 1.5

        env_db = np.asarray(env_db_grid)
        stride = int(env_db_stride)
        grid_sr = sr / stride
        guard = max(0, int(guard_ms / 1000.0 * grid_sr))
        n_grid = env_db.size
        # 8x-decimated |x| for the silence-floor percentile: pauses span
        # seconds, and the decimated distribution serves a floor as well
        dec = 8
        abs_dec = np.abs(vocal_audio[::dec]) if vocal_audio is not None else None
        floor_allow_db = 20.0 * np.log10(max(float(floor_allow), 1e-6))

        for p in pauses:
            a = max(0, int(round(p.start_time * grid_sr)))
            b = min(n_grid, int(round(p.end_time * grid_sr)))
            if b - a <= 1:
                continue
            cut = a + int(np.argmin(env_db[a:b]))
            if guard > 0:
                g_end = min(n_grid, cut + guard)
                if g_end > cut:
                    cut = cut + int(np.argmin(env_db[cut:g_end]))
            cut_sample = min(n_wave - 1, cut * stride)
            if abs_dec is not None:
                da = max(0, int(round(p.start_time * sr / dec)))
                db_ = min(abs_dec.size, int(round(p.end_time * sr / dec)))
                floor_val = float(np.percentile(abs_dec[da:db_], floor_pct)) if db_ > da else 0.0
                fallback = floor_val > 0.0 and abs(float(vocal_audio[cut_sample])) > floor_val * floor_allow
            else:
                # the silence-floor check in the dB domain: is the short-window
                # RMS at the cut quiet relative to this pause's own floor
                floor_db = float(np.percentile(env_db[a:b], floor_pct))
                fallback = float(env_db[cut]) > floor_db + floor_allow_db
            if fallback:
                sa = max(0, int(round(p.start_time * sr)))
                sb = min(n_wave, int(round(p.end_time * sr)))
                cut_sample = sa + (sb - sa) // 2
            p.cut_point = cut_sample / float(sr)
            p.quality_grade = "B" if fallback else "A"
        return pauses

    # -- VPP ---------------------------------------------------------------------

    def _estimate_vpp_multiplier(
        self,
        rms: np.ndarray,
        fps: float,
        cfg: Dict[str, Any],
        focus_windows: Optional[List[Tuple[float, float]]],
    ) -> Tuple[float, str]:
        """Vocal Pause Profile: classify the song's rest cadence inside
        singing blocks and derive a threshold multiplier."""
        pcfg = cfg.get("pause_stats_adaptation", {}) or {}
        db = 20.0 * np.log10(rms + 1e-12)
        floor_pct = float(get_config("v2_mdd.quality_control.enforce_quiet_cut.floor_percentile", 0.5))
        thr_db = float(np.percentile(db, max(floor_pct, 5.0))) + float(pcfg.get("delta_db", 3.0))
        mask = db > thr_db
        frame_s = 1.0 / fps

        fmask = _focus_mask(mask.size, fps, focus_windows)
        if fmask is not None:
            mask &= fmask
        if not mask.any():
            return 1.0, "VPP{no_active_frames}"

        close_k = max(1, int(float(pcfg.get("morph_close_ms", 150)) / 1000.0 / frame_s))
        open_k = max(1, int(float(pcfg.get("morph_open_ms", 50)) / 1000.0 / frame_s))
        mask = _fill_short_false_runs(mask, close_k)
        mask = _drop_short_true_runs(mask, open_k)

        block_min = max(1, int(float(pcfg.get("sing_block_min_s", 2.0)) / frame_s))
        blocks = [(s, e) for s, e in _runs(mask) if e - s >= block_min]
        if not blocks:
            return 1.0, "VPP{no_singing_blocks}"

        interlude_min = int(float(pcfg.get("interlude_min_s", 4.0)) / frame_s)
        rests: List[float] = []
        total_frames = 0
        for a, b in blocks:
            total_frames += b - a
            for s, e in _runs(~mask[a:b]):
                span = e - s
                if span >= interlude_min:
                    continue
                rests.append(span * frame_s)
        if not rests or total_frames == 0:
            return 1.0, "VPP{no_rests}"

        rests_arr = np.asarray(rests)
        block_minutes = total_frames * frame_s / 60.0
        mpd = float(np.median(rests_arr))
        p95 = float(np.percentile(rests_arr, 95))
        pr = float(rests_arr.size / max(block_minutes, 1e-9))
        rr = float(rests_arr.sum() / (total_frames * frame_s))

        th = pcfg.get("classify_thresholds", {}) or {}
        slow_th = th.get("slow", {"mpd": 0.6, "p95": 1.2, "rr": 0.35})
        fast_th = th.get("fast", {"mpd": 0.25, "pr": 18, "rr": 0.15})
        if mpd >= slow_th.get("mpd", 0.6) or p95 >= slow_th.get("p95", 1.2) or rr >= slow_th.get("rr", 0.35):
            cls = "slow"
        elif (
            mpd <= fast_th.get("mpd", 0.25)
            and pr >= fast_th.get("pr", 18)
            and rr <= fast_th.get("rr", 0.15)
        ):
            cls = "fast"
        else:
            cls = "medium"

        adapt = cfg.get("relative_threshold_adaptation", {}) or {}
        mult = resolve_pause_stats_multiplier(cls, adapt.get("pause_stats_multipliers"))
        return mult, f"VPP{{cls={cls}, mpd={mpd:.2f}, p95={p95:.2f}, pr={pr:.1f}/min, rr={rr:.2f}}}"
