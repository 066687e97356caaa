"""SmartSplitter: the mode-dispatch orchestrator.

Counterpart of ``audio_cut_tpu/pipeline/splitter.py``. The port runs
``v2.2_mdd`` (the default: pause detection, guards, layout, segments; on the
fused pass, or on the staged path with ``device_pipeline.fused_program:
false``), ``vpbd_acoustic`` and ``vpbd_asr`` (the unified candidate pool,
the phrase scorer and the DP planner before the same guards and layout;
``vpbd_asr`` adds lyric candidates when lyrics alignment is on), ``hybrid_mdd`` (the
``v2.2_mdd`` cuts snapped to beats, with _lib tags, on the sub-run's device
pass), ``vocal_separation`` (stems only) and ``librosa_onset`` (this file:
the model-free bar grid from the bpm, per-bar energy classes, silence
midpoints as forced cuts and density-controlled bar cuts, over a feature
pass on the device; the separation, where it runs, only labels the
segments). Unlike the JAX package, ``librosa_onset`` does not go on without
stems when the separation fails: it raises, as every other mode does.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from audio_cut_tpu_torch.analysis.features import TrackFeatures, build_track_features
from audio_cut_tpu_torch.config import get_config
from audio_cut_tpu_torch.io.audio import load_audio
from audio_cut_tpu_torch.io.segment_export import ExportResult, SegmentExporter
from audio_cut_tpu_torch.pipeline.result import ResultBuilder
from audio_cut_tpu_torch.pipeline.split import split_at_sample_level

KNOWN_MODES = (
    "vocal_separation",
    "v2.2_mdd",
    "librosa_onset",
    "hybrid_mdd",
    "vpbd_acoustic",
    "vpbd_asr",
)

_DENSITY_MAP = {
    "low": {"verse_bars": 8, "chorus_bars": 4},
    "medium": {"verse_bars": 4, "chorus_bars": 2},
    "high": {"verse_bars": 2, "chorus_bars": 1},
}


class SmartSplitter:
    def __init__(self, device: torch.device, sample_rate: Optional[int] = None) -> None:
        self.device = torch.device(device)
        self.sample_rate = int(sample_rate or get_config("audio.sample_rate", 44100))
        self.result_builder = ResultBuilder()
        self.segment_exporter = SegmentExporter(self.sample_rate)
        self._export_format = str(get_config("output.format", "wav"))
        self._export_options = dict(get_config("output.wav", {}) or {})
        self._separator = None  # created on first use
        # a hybrid_mdd run asks its v2.2_mdd sub-run to stash the device
        # pass (key, audio, stems, bundle) here, and pops it
        self._want_fused_pass_memo = False
        self._fused_pass_memo = None

    def split_audio_seamlessly(
        self,
        input_path: str,
        output_dir: str,
        mode: str = "v2.2_mdd",
        export_plan: Optional[Sequence[str]] = None,
    ) -> Dict[str, Any]:
        if mode not in KNOWN_MODES:
            raise ValueError(f"unknown mode {mode!r}; expected one of {KNOWN_MODES}")
        Path(output_dir).mkdir(parents=True, exist_ok=True)

        if mode == "librosa_onset":
            return self._process_librosa_onset(input_path, output_dir, export_plan=export_plan)
        if mode in ("v2.2_mdd", "vpbd_acoustic", "vpbd_asr"):
            from audio_cut_tpu_torch.pipeline.modes.pure_vocal import process_pure_vocal_split

            return process_pure_vocal_split(self, input_path, output_dir, mode=mode,
                                            export_plan=export_plan)
        if mode == "hybrid_mdd":
            from audio_cut_tpu_torch.pipeline.modes.hybrid import process_hybrid_mdd

            return process_hybrid_mdd(self, input_path, output_dir, export_plan=export_plan)
        from audio_cut_tpu_torch.pipeline.modes.separation_mode import process_vocal_separation

        return process_vocal_separation(self, input_path, output_dir, export_plan=export_plan)

    @property
    def separator(self):
        if self._separator is None:
            from audio_cut_tpu_torch.separation.engine import SeparationEngine

            self._separator = SeparationEngine(self.sample_rate, self.device)
        return self._separator

    def _load(self, input_path: str) -> np.ndarray:
        audio, _sr = load_audio(input_path, target_sr=self.sample_rate, mono=True)
        return audio

    @staticmethod
    def _normalize_export_plan(
        export_plan: Optional[Sequence[str]], default: Sequence[str]
    ) -> set:
        if export_plan is None:
            return set(default)
        plan = {str(p) for p in export_plan}
        if "none" in plan:
            return set()
        return plan

    # -- librosa_onset (smart segment v2) ---------------------------------

    def _process_librosa_onset(
        self,
        input_path: str,
        output_dir: str,
        *,
        export_plan: Optional[Sequence[str]] = None,
    ) -> Dict[str, Any]:
        """Emotion-aware model-free segmentation: the bpm's bar grid, per-bar
        energy classes by percentile, silence midpoints as forced cuts,
        density-controlled bar cuts, the short merge, the sample-exact split,
        and human/music labels from the vocal stem's RMS against the host
        complement's. The separation, where ``use_vocal_separation`` asks
        for it, runs on the splitter's device and raises on a failure."""
        t0 = time.time()
        cfg = get_config("librosa_onset", {}) or {}
        audio = self._load(input_path)
        sr = self.sample_rate

        # separation, for the labels only
        vocal = instrumental = None
        separation_result = None
        if cfg.get("use_vocal_separation", True):
            separation_result = self.separator.separate_for_detection(
                audio, need_instrumental=False)
            vocal = separation_result.vocal_track
            # the host complement: one stem download instead of two
            instrumental = separation_result.complement_instrumental(audio)

        # the feature pass on this mode's fine grid, on the device
        hop_length = int(cfg.get("energy_analysis", {}).get("hop_length", 512))
        tf = build_track_features(audio, sr, hop_s=hop_length / float(sr), device=self.device)
        plan = plan_onset_cuts(tf, len(audio), sr, cfg)
        cut_samples = plan["cut_samples"]

        # classify human/music
        flags: List[bool] = []
        for i in range(len(cut_samples) - 1):
            a, b = cut_samples[i], cut_samples[i + 1]
            if vocal is not None:
                v_rms = float(np.sqrt(np.mean(np.square(vocal[a:b])) + 1e-12))
                if instrumental is not None:
                    i_rms = float(np.sqrt(np.mean(np.square(instrumental[a:b])) + 1e-12))
                    flags.append(v_rms > i_rms * 0.3)
                else:
                    flags.append(v_rms > 0.01)
            else:
                flags.append(True)

        segments, flags_out, _ = split_at_sample_level(
            audio, cut_samples, sr, segment_flags=flags
        )
        if flags_out is None:
            flags_out = flags or [True] * len(segments)
        seg_durations = [len(s) / float(sr) for s in segments]

        export_flags = self._normalize_export_plan(export_plan, default=("mix_segments",))
        export_result = ExportResult()
        if "mix_segments" in export_flags:
            export_result.mix_segment_files = self.segment_exporter.export_segments(
                segments, output_dir,
                segment_is_vocal=flags_out,
                export_format=self._export_format,
                export_options=self._export_options,
            )
            export_result.saved_files.extend(export_result.mix_segment_files)
        if "vocal_segments" in export_flags and vocal is not None:
            vsegs, _, _ = split_at_sample_level(vocal, cut_samples, sr)
            export_result.vocal_segment_files = self.segment_exporter.export_segments(
                vsegs, output_dir,
                segment_is_vocal=flags_out,
                export_format=self._export_format,
                export_options=self._export_options,
                subdir="segments_vocal",
                file_suffix="_vocal",
            )
            export_result.saved_files.extend(export_result.vocal_segment_files)

        result = self.result_builder.build_base(
            method="smart_segment_v2",
            export_result=export_result,
            export_plan=sorted(export_flags),
            processing_time=time.time() - t0,
            input_path=input_path,
            output_dir=output_dir,
            cut_points_samples=list(cut_samples),
            cut_points_sec=[s / float(sr) for s in cut_samples],
            segment_durations=seg_durations,
            segment_vocal_flags=flags_out,
            precision_guard_ok=True,
        )
        result.update({
            "use_vocal_preprocessing": bool(cfg.get("use_vocal_separation", True)),
            "bpm": plan["bpm"],
            "bar_duration_s": plan["bar_duration_s"],
            "density": plan["density"],
            "silence_boundaries": plan["silence_boundaries"],
        })
        return self.result_builder.add_separation_metadata(result, separation_result)


def plan_onset_cuts(tf: TrackFeatures, n_samples: int, sr: int,
                    cfg: Dict[str, Any]) -> Dict[str, Any]:
    """librosa_onset's host logic over its features: the cut samples of a
    track of ``n_samples``, with the bpm, the bar duration, the density and
    the silence boundaries it used. ``cfg`` is the ``librosa_onset`` section."""
    duration = n_samples / float(sr)
    tempo = tf.bpm if tf.bpm > 1e-3 else 120.0
    time_signature = int(cfg.get("beat", {}).get("time_signature", 4))
    bar_duration = 60.0 / tempo * time_signature

    # per-bar mean RMS -> chorus/verse via percentiles
    bar_edges = np.arange(0.0, duration + bar_duration, bar_duration)
    frame_times = tf.times()
    n_bars = max(0, len(bar_edges) - 1)
    bar_energies = np.zeros(n_bars)
    for i in range(n_bars):
        m = (frame_times >= bar_edges[i]) & (frame_times < bar_edges[i + 1])
        bar_energies[i] = float(tf.rms[m].mean()) if m.any() else 0.0

    ea = cfg.get("energy_analysis", {})
    p_chorus = float(np.percentile(bar_energies, ea.get("chorus_percentile", 60))) if n_bars else 0.0
    p_peak = float(np.percentile(bar_energies, ea.get("chorus_peak_percentile", 80))) if n_bars else 0.0
    bar_types = [
        "chorus_peak" if e >= p_peak else ("chorus" if e >= p_chorus else "verse")
        for e in bar_energies
    ]

    # silence midpoints
    sil = cfg.get("silence", {})
    thr_db = float(sil.get("threshold_db", -40))
    min_dur = float(sil.get("min_duration", 0.3))
    rms_db = 20.0 * np.log10(tf.rms + 1e-10)
    silence_boundaries = _silence_midpoints(rms_db, frame_times, thr_db, min_dur)

    # density
    density = str(cfg.get("density", "low"))
    custom = cfg.get("density_custom", {}) or {}
    if custom.get("enable", False):
        dens = {
            "verse_bars": int(custom.get("verse_bars", 4)),
            "chorus_bars": int(custom.get("chorus_bars", 2)),
        }
    else:
        dens = _DENSITY_MAP.get(density, _DENSITY_MAP["medium"])

    # cuts: bar boundaries at the density's cadence, silence-forced
    cut_times: List[float] = [0.0]
    last_cut = 0.0
    bars_since = 0
    for bar_idx, bar_time in enumerate(bar_edges[1:]):
        bars_since += 1
        bar_type = bar_types[bar_idx] if bar_idx < len(bar_types) else "verse"
        required = dens["chorus_bars"] if "chorus" in bar_type else dens["verse_bars"]
        should = bars_since >= required
        if not should:
            should = any(last_cut < s <= bar_time for s in silence_boundaries)
        if should:
            cut_times.append(float(bar_time))
            last_cut = float(bar_time)
            bars_since = 0
    for s in silence_boundaries:
        if 0 < s < duration and s not in cut_times:
            cut_times.append(float(s))
    cut_times.append(duration)
    cut_times = sorted(set(cut_times))

    # merge too-short segments; the last cut moves to the end
    min_seg = float(get_config("v2_mdd.segment_layout.soft_min_s", 2.0))
    merged = [cut_times[0]]
    for t in cut_times[1:]:
        if t - merged[-1] >= min_seg:
            merged.append(t)
        elif t == cut_times[-1]:
            merged[-1] = t
    cut_times = merged

    cut_samples = sorted({0, n_samples, *(
        int(t * sr) for t in cut_times[1:-1] if 0 < int(t * sr) < n_samples
    )})
    return {
        "cut_samples": cut_samples,
        "bpm": float(tempo),
        "bar_duration_s": float(bar_duration),
        "density": density,
        "silence_boundaries": [float(s) for s in silence_boundaries],
    }


def _silence_midpoints(
    rms_db: np.ndarray, frame_times: np.ndarray, threshold_db: float, min_duration: float
) -> List[float]:
    """Midpoints of silent runs >= min_duration (vectorised run detection)."""
    mask = rms_db < threshold_db
    if not mask.any():
        return []
    edges = np.diff(mask.astype(np.int8), prepend=0, append=0)
    starts = np.nonzero(edges == 1)[0]
    ends = np.nonzero(edges == -1)[0]
    out: List[float] = []
    for s, e in zip(starts, ends):
        t0 = frame_times[s]
        t1 = frame_times[min(e, len(frame_times) - 1)]
        if t1 - t0 >= min_duration:
            out.append(float(t0 + (t1 - t0) / 2.0))
    return out
