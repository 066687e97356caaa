"""v2.2_mdd: pure-vocal pause detection -> guards -> layout -> split -> export.

Counterpart of ``audio_cut_tpu/pipeline/modes/pure_vocal.py`` for
``mode="v2.2_mdd"``: one separation-and-bundle pass on the device and one
host copy (``separation/fused.py``), then on the host the VAD focus windows,
``PureVocalPauseDetector`` with the MDD enhancement, the pure-music span
candidates, ``finalize_cut_points`` (NMS, zero-cross snap, quiet guards),
the pre-layout classification, the layout refinement, the local valley
refine, the classification and weak-tail merge, the sample-exact split and
the export.

The port has one path. The JAX package's staged bundle with its retry and
CPU-rebuild chain, and the host-waveform branches that run when no bundle
exists, are not ported: ``device_pipeline.fused_program: false`` raises. The
``vpbd_*`` modes and the ``hybrid_mdd`` memo come with those modes
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
from torch.profiler import record_function

from audio_cut_tpu_torch.config import get_config
from audio_cut_tpu_torch.cutting.layout import RescueCandidate, refine_layout
from audio_cut_tpu_torch.cutting.refine import (
    CutContext,
    CutPoint,
    QuietLookup,
    finalize_cut_points,
    guard_shift_stats,
)
from audio_cut_tpu_torch.detection.pause_detector import PureVocalPauseDetector
from audio_cut_tpu_torch.detection.vad import EnergyGateDetector, to_focus_windows
from audio_cut_tpu_torch.io.segment_export import ExportResult
from audio_cut_tpu_torch.pipeline.classify import (
    classify_segments_vocal_presence,
    merge_weak_human_tails,
    pure_music_spans,
)
from audio_cut_tpu_torch.pipeline.split import split_at_sample_level


def process_pure_vocal_split(
    splitter,
    input_path: str,
    output_dir: str,
    *,
    mode: str,
    export_plan: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    if not bool(get_config("device_pipeline.fused_program", True)):
        raise NotImplementedError(
            "device_pipeline.fused_program=false (the staged bundle path and its fallback "
            "chain) is not in the PyTorch port yet: ROADMAP.md, queue 1, 'the staged bundle "
            "path and the engine fallback chain'")
    t0 = time.time()
    sr = splitter.sample_rate
    with record_function("load"):
        audio = splitter._load(input_path)

    # -- separation + detection envelopes: one pass, one host copy ----------
    from audio_cut_tpu_torch.models.vad import ConvVAD, build_vad
    from audio_cut_tpu_torch.separation import fused

    export_flags = splitter._normalize_export_plan(export_plan, default=("mix_segments",))
    vad_detector = build_vad(sr, splitter.device)
    vad_model = vad_detector if isinstance(vad_detector, ConvVAD) else None
    qc = get_config("v2_mdd.quality_control", {}) or {}
    eqc = qc.get("enforce_quiet_cut", {}) or {}
    lbr = qc.get("local_boundary_refine", {}) or {}

    sep, bundle = fused.separate_and_detect_fused(
        splitter.separator, vad_model, audio,
        guard_win_ms=float(eqc.get("win_ms", 80)),
        refine_win_ms=float(lbr.get("window_ms", 5)),
    )
    with record_function("host_tail"):
        plan = _plan_cuts(audio, sr, bundle, vad_detector, vad_model, qc, eqc, lbr)
    cut_samples, flags, debug = plan["cut_samples"], plan["flags"], plan["debug"]
    refine_result = plan["refine_result"]

    # -- split + export ---------------------------------------------------------------
    with record_function("export"):
        segments, flags_out, debug_out = split_at_sample_level(
            audio, cut_samples, sr, segment_flags=flags, debug_entries=debug
        )
        flags_out = flags_out or flags
        seg_durations = [len(s) / float(sr) for s in segments]
        export_result = _export(splitter, sep, audio, segments, flags_out, cut_samples,
                                export_flags, input_path, output_dir)

    # -- result ----------------------------------------------------------------------
    stats = guard_shift_stats(refine_result.adjustments)
    precision_ok = splitter.result_builder.check_precision_guard(stats)
    result = splitter.result_builder.build_base(
        method=mode,
        export_result=export_result,
        export_plan=sorted(export_flags),
        processing_time=time.time() - t0,
        input_path=input_path,
        output_dir=output_dir,
        cut_points_samples=list(cut_samples),
        cut_points_sec=[s / float(sr) for s in cut_samples],
        segment_durations=seg_durations,
        segment_vocal_flags=flags_out,
        precision_guard_ok=precision_ok,
        include_precision_guard_threshold=True,
        guard_shift_stats=stats,
        guard_adjustments=[a.to_dict() for a in refine_result.adjustments],
        segment_classification_debug=debug_out,
        suppressed_cut_points_sec=plan["suppressed_sec"],
    )
    result["segment_layout_applied"] = plan["layout_applied"]
    result["vad_backend"] = plan["vad_backend"]
    if plan["note"]:
        result["note"] = plan["note"]
    return splitter.result_builder.add_separation_metadata(result, sep)


def _plan_cuts(audio: np.ndarray, sr: int, bundle, vad_detector, vad_model,
               qc: Dict[str, Any], eqc: Dict[str, Any], lbr: Dict[str, Any]) -> Dict[str, Any]:
    """The host tail from the bundle to the final cut samples, their flags
    and debug entries: VAD focus windows, pause detection, guards, layout,
    the valley refine, classification and the weak-tail merge."""
    duration = len(audio) / float(sr)
    features = bundle.features

    # -- VAD focus windows ----------------------------------------------------
    if vad_model is not None:
        vad = vad_detector.detect(bundle.vad_probs, n_true=len(audio))
    else:
        vad = vad_detector.detect(bundle.vocal_rms_fine)
    vad_backend = "conv" if not isinstance(vad_detector, EnergyGateDetector) else "energy_gate"
    acfg = get_config("v2_mdd.advanced_vad", {}) or {}
    focus = to_focus_windows(
        vad.segments,
        duration,
        pad_s=float(acfg.get("focus_window_pad_s", 0.2)),
        merge_gap_s=float(acfg.get("focus_merge_gap_s", 0.12)),
        min_width_s=float(acfg.get("focus_window_min_width_s", 0.0)),
    )

    # -- candidates -------------------------------------------------------------
    detector = PureVocalPauseDetector(sr)
    pauses = detector.detect_pure_vocal_pauses(
        features=features, focus_windows=focus, enable_mdd=True,
        rms_env=bundle.vocal_rms_fine,
        env_db_grid=bundle.vocal_db_fine,
        env_db_stride=bundle.db_stride,
        n_samples=len(audio),
    )
    raw_points = [
        CutPoint(p.cut_point if p.cut_point > 0 else (p.start_time + p.end_time) / 2.0,
                 float(np.clip(p.confidence, 0.0, 1.0)))
        for p in pauses
    ]

    # pure-music span boundaries as extra candidates (intro/interlude/outro)
    for span_start, span_end in pure_music_spans(sr, act_rms=bundle.act_rms):
        for t in (span_start, span_end):
            if 0.5 < t < duration - 0.5:
                raw_points.append(CutPoint(float(t), 0.8, kind="music_span"))

    # -- guard finalisation -------------------------------------------------------
    floor_pct = float(eqc.get("floor_percentile", 0.5))
    vcfg = get_config("v2_mdd.pure_vocal_detection.valley_scoring", {}) or {}
    vocal_lookup = QuietLookup(
        sr=sr, db_grid=bundle.vocal_db_guard, stride=bundle.db_stride,
        floor_db=eqc.get("floor_db_override"), floor_percentile=floor_pct,
    )
    mix_lookup = QuietLookup(
        sr=sr, db_grid=bundle.mix_db_guard, stride=bundle.db_stride,
        floor_db=eqc.get("floor_db_override"), floor_percentile=floor_pct,
    )
    refine_result = finalize_cut_points(
        # the zero-cross snap runs on the mix (the host input)
        CutContext(sr=sr, mix_wave=audio),
        raw_points,
        min_gap_s=float(qc.get("min_split_gap", 1.2)),
        max_keep=int(vcfg.get("max_kept_after_nms", 200)) or None,
        topk_per_10s=qc.get("nms_topk_per_10s"),
        guard_db=float(eqc.get("guard_db", 1.5)),
        search_right_ms=float(eqc.get("search_right_ms", 450)),
        enable_mix_guard=bool(eqc.get("enable", True)),
        enable_vocal_guard=bool(eqc.get("enable", True)),
        vocal_lookup=vocal_lookup,
        mix_lookup=mix_lookup,
    )
    cut_times = [p.t for p in refine_result.final_points]
    suppressed_sec = [p.t for p in refine_result.suppressed_points]

    # -- layout refinement ------------------------------------------------------
    layout_cfg = get_config("v2_mdd.segment_layout", {}) or {}
    layout_applied = False
    if layout_cfg.get("enable", True) and cut_times:
        vocal_rms_db = 20.0 * np.log10(bundle.vocal_rms_grid + 1e-12)
        rescue_pool = [
            RescueCandidate(t=p.t, score=p.score) for p in refine_result.suppressed_points
        ]
        # pre-layout segment kinds feed the kind-aware merge costs
        pre_samples = sorted({0, len(audio), *(
            int(round(t * sr)) for t in cut_times if 0 < int(round(t * sr)) < len(audio)
        )})
        pre_flags, _ = classify_segments_vocal_presence(
            pre_samples, sr, act_rms=bundle.act_rms, n_samples=len(audio))
        segment_kinds = ["human" if f else "music" for f in pre_flags]
        lres = refine_layout(
            cut_times,
            duration,
            config=layout_cfg,
            features=features,
            vocal_rms_db=vocal_rms_db,
            beat_times=features.beat_times,
            suppressed=rescue_pool,
            segment_kinds=segment_kinds,
        )
        cut_times = lres.cut_times
        layout_applied = True

    # -- local valley boundary refine ----------------------------------------------
    if lbr.get("enable", True) and cut_times:
        cut_times = _local_valley_refine(
            cut_times, sr,
            radius_ms=float(lbr.get("search_radius_ms", 500)),
            min_drop_db=float(lbr.get("min_drop_db", 5.0)),
            db_grid=bundle.mix_db_refine,
            db_stride=bundle.db_stride,
        )

    # -- classification + weak-tail merge -------------------------------------------
    cut_samples = sorted({0, len(audio), *(
        int(round(t * sr)) for t in cut_times if 0 < int(round(t * sr)) < len(audio)
    )})
    flags, debug = classify_segments_vocal_presence(
        cut_samples, sr, act_rms=bundle.act_rms, n_samples=len(audio))
    cut_samples, flags, debug = merge_weak_human_tails(list(cut_samples), flags, debug, sr)

    note: Optional[str] = None
    if len(cut_samples) < 3:  # single-segment fallback
        cut_samples = [0, len(audio)]
        if not flags:
            flags = [True]
            debug = [{"index": 0, "decision": True, "reason": "single_segment_fallback"}]
        note = "single_segment_fallback"
    return {"cut_samples": cut_samples, "flags": flags, "debug": debug,
            "refine_result": refine_result, "suppressed_sec": suppressed_sec,
            "layout_applied": layout_applied, "vad_backend": vad_backend, "note": note}



def _export(splitter, sep, audio, segments, flags_out, cut_samples, export_flags,
            input_path: str, output_dir: str) -> ExportResult:
    sr = splitter.sample_rate
    exporter = splitter.segment_exporter
    fmt, opts = splitter._export_format, splitter._export_options
    stem = Path(input_path).stem
    out = ExportResult()
    if "mix_segments" in export_flags:
        out.mix_segment_files = exporter.export_segments(
            segments, output_dir, segment_is_vocal=flags_out,
            export_format=fmt, export_options=opts,
        )
        out.saved_files.extend(out.mix_segment_files)
    if "vocal_segments" in export_flags and sep.vocal_track is not None:
        vsegs, _, _ = split_at_sample_level(sep.vocal_track, cut_samples, sr)
        out.vocal_segment_files = exporter.export_segments(
            vsegs, output_dir, segment_is_vocal=flags_out,
            export_format=fmt, export_options=opts,
            subdir="segments_vocal", file_suffix="_vocal",
        )
        out.saved_files.extend(out.vocal_segment_files)
    if "full_vocal" in export_flags and sep.vocal_track is not None:
        dur = len(sep.vocal_track) / float(sr)
        out.full_vocal_file = exporter.export_full_track(
            sep.vocal_track, Path(output_dir) / f"{stem}_vocal_{dur:.1f}",
            export_format=fmt, export_options=opts,
        )
        out.saved_files.append(out.full_vocal_file)
    if "full_instrumental" in export_flags and sep.complement_instrumental(audio) is not None:
        instrumental = sep.instrumental_track
        dur = len(instrumental) / float(sr)
        out.full_instrumental_file = exporter.export_full_track(
            instrumental, Path(output_dir) / f"{stem}_instrumental_{dur:.1f}",
            export_format=fmt, export_options=opts,
        )
        out.saved_files.append(out.full_instrumental_file)
    return out


def _local_valley_refine(
    cut_times: List[float],
    sr: int,
    *,
    radius_ms: float,
    min_drop_db: float,
    db_grid: np.ndarray,
    db_stride: int,
) -> List[float]:
    """Move each cut to a strictly quieter local valley of the mix's dB grid
    within ``radius_ms``, when it is at least ``min_drop_db`` quieter."""
    if not cut_times:
        return cut_times
    env_db = np.asarray(db_grid)
    grid_sr = sr / float(db_stride)
    radius = max(1, int(round(radius_ms / 1000.0 * grid_sr)))
    n = env_db.size

    out: List[float] = []
    for t in cut_times:
        idx = int(np.clip(round(t * grid_sr), 0, n - 1))
        lo = max(0, idx - radius)
        hi = min(n, idx + radius)
        best = int(np.argmin(env_db[lo:hi])) + lo
        if env_db[idx] - env_db[best] >= min_drop_db:
            out.append(best / grid_sr)
        else:
            out.append(t)
    return sorted(out)
