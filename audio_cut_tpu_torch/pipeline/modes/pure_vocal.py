"""v2.2_mdd / vpbd_*: candidates -> guards -> layout -> split -> export.

Counterpart of ``audio_cut_tpu/pipeline/modes/pure_vocal.py``: one
separation-and-bundle pass on the device and one host copy
(``separation/fused.py``), then on the host the VAD focus windows and the
candidates: ``PureVocalPauseDetector`` with the MDD enhancement for
``v2.2_mdd``; for ``vpbd_acoustic`` and ``vpbd_asr`` the smart-cut runtime
(intent, AutoProfile style estimate, profile interpolation) and the
``VocalPhraseBoundaryDetector`` (unified pool, scorer, DP planner), whose
candidates are snapped to the quietest point of the guard's dB grid. Then,
for every mode, the pure-music span candidates, ``finalize_cut_points``
(NMS, zero-cross snap, quiet guards), the pre-layout classification, the
layout refinement, the local valley refine, the classification and weak-tail
merge, the sample-exact split and the export.

``device_pipeline.fused_program: false`` selects the JAX package's staged
path. There it is a separate program with a retry, a rebuild from host
arrays and a CPU run; in the port it is the same pass (separation, then
``analysis/bundle.build_detection_bundle`` over the device stems) under the
engine's manifest label (``device_ola_pipelined_p<P>`` or ``device_ola``),
so both give the same bundle bit for bit. A
failed bundle raises, so the bundle is never None and the JAX package's
host-waveform fallbacks have no caller. When an enclosing ``hybrid_mdd`` run asks for it,
the pass (audio, stems, bundle) is stashed on the splitter for that run.
``vpbd_asr`` with lyrics alignment on aligns lyrics from the device vocal
stem (``detection/vpbd.py``); the timeline's words then keep the valley
snap, the guard restore and the valley refine out of recognised words, and
its sentence edges feed the layout's rescue scoring. With it off, the
default, ``vpbd_asr`` runs the acoustic path as in the JAX package. With
``v2_mdd.pure_vocal_detection.enable_relative_energy_mode: false`` the pause
detector (of ``v2.2_mdd`` and of the vpbd pool) also reads the vocal: the
stem on its device for YIN and LPC, and its host copy, downloaded once and
shared with the vocal segments' export.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence

import numpy as np
from torch.profiler import record_function

from audio_cut_tpu_torch.config import (
    get_config,
    get_config_manager,
    get_runtime_override_keys,
    set_runtime_config,
)
from audio_cut_tpu_torch.config.auto_profile import (
    build_auto_profile_overrides,
    derive_alignment_overrides,
    derive_smart_cut_overrides,
    estimate_style,
    profile_override_map,
    resolve_smart_cut_intent,
)
from audio_cut_tpu_torch.cutting.layout import RescueCandidate, refine_layout
from audio_cut_tpu_torch.cutting.planner import apply_guard_shift_metadata
from audio_cut_tpu_torch.cutting.refine import (
    CutContext,
    CutPoint,
    QuietLookup,
    finalize_cut_points,
    guard_shift_stats,
    inside_word_check,
    restore_guards_outside_words,
)
from audio_cut_tpu_torch.detection.pause_detector import PureVocalPauseDetector
from audio_cut_tpu_torch.detection.vad import EnergyGateDetector, to_focus_windows
from audio_cut_tpu_torch.detection.vpbd import VocalPhraseBoundaryDetector
from audio_cut_tpu_torch.io.segment_export import ExportResult
from audio_cut_tpu_torch.pipeline.classify import (
    classify_segments_vocal_presence,
    merge_weak_human_tails,
    pure_music_spans,
)
from audio_cut_tpu_torch.pipeline.split import split_at_sample_level

if TYPE_CHECKING:
    from audio_cut_tpu_torch.separation.engine import SeparationResult

logger = logging.getLogger(__name__)

VPBD_MODES = ("vpbd_acoustic", "vpbd_asr")


def process_pure_vocal_split(
    splitter,
    input_path: str,
    output_dir: str,
    *,
    mode: str,
    export_plan: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    t0 = time.time()
    sr = splitter.sample_rate
    with record_function("load"):
        audio = splitter._load(input_path)

    # -- separation + detection envelopes: one host copy ---------------------
    from audio_cut_tpu_torch.models.vad import ConvVAD, build_vad
    from audio_cut_tpu_torch.separation import fused

    export_flags = splitter._normalize_export_plan(export_plan, default=("mix_segments",))
    vad_detector = build_vad(sr, splitter.device)
    vad_model = vad_detector if isinstance(vad_detector, ConvVAD) else None
    qc = get_config("v2_mdd.quality_control", {}) or {}
    eqc = qc.get("enforce_quiet_cut", {}) or {}
    lbr = qc.get("local_boundary_refine", {}) or {}

    staged = not bool(get_config("device_pipeline.fused_program", True))
    sep, bundle = fused.separate_and_detect_fused(
        splitter.separator, vad_model, audio,
        guard_win_ms=float(eqc.get("win_ms", 80)),
        refine_win_ms=float(lbr.get("window_ms", 5)),
        staged=staged,
    )
    # before the host tail: the vpbd modes set runtime overrides there, which
    # bump the config generation that the memo's key holds
    if splitter._want_fused_pass_memo:
        # shared once with the enclosing hybrid_mdd run, which pops it, so
        # the stems are never pinned past that run
        key = fused_pass_key(input_path)
        if key is not None:
            splitter._fused_pass_memo = (key, audio, sep, bundle)
    if bundle.vocal_energy is not None and len(audio):
        # the confidence from the bundle's vocal energy: no stem download
        e_mix = float(np.mean(np.square(audio))) + 1e-12
        ratio = bundle.vocal_energy / e_mix
        sep.separation_confidence = float(np.clip(1.0 - abs(ratio - 0.35) / 0.65, 0.1, 0.99))
    with record_function("host_tail"):
        plan = _plan_cuts(audio, sr, bundle, vad_detector, vad_model, qc, eqc, lbr,
                          mode=mode, output_dir=output_dir, stems=sep)
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
        lyrics_alignment=plan["lyrics_alignment"],
        boundary_detection=plan["boundary_detection"],
        suppressed_cut_points_sec=plan["suppressed_sec"],
    )
    result["segment_layout_applied"] = plan["layout_applied"]
    result["vad_backend"] = plan["vad_backend"]
    if plan["note"]:
        result["note"] = plan["note"]
    if plan["auto_profile"] is not None:
        result["auto_profile"] = plan["auto_profile"]
    return splitter.result_builder.add_separation_metadata(result, sep)


def fused_pass_key(input_path: str):
    """The memo's key: the file's identity and the config's generation, or
    None when the file cannot be read."""
    try:
        st = os.stat(input_path)
    except OSError:
        return None
    return (os.path.realpath(input_path), st.st_mtime_ns, st.st_size,
            get_config_manager().generation())


def _plan_cuts(audio: np.ndarray, sr: int, bundle, vad_detector, vad_model,
               qc: Dict[str, Any], eqc: Dict[str, Any], lbr: Dict[str, Any], *,
               mode: str = "v2.2_mdd", output_dir: Optional[str] = None,
               stems: Optional[SeparationResult] = None) -> Dict[str, Any]:
    """The host tail from the bundle to the final cut samples, their flags
    and debug entries: VAD focus windows, the mode's candidates, guards,
    layout, the valley refine, classification and the weak-tail merge. For
    the vpbd modes it applies the smart-cut runtime overrides to the config,
    which the caller restores, and writes the candidate debug JSON to
    ``output_dir`` when one is given. ``stems`` are the track's separation:
    ``vpbd_asr`` reads its device vocal for the ASR copy when it aligns
    lyrics, and the legacy multi-feature detector
    (``enable_relative_energy_mode: false``) for YIN and LPC; that detector
    also reads its host vocal, which the stems copy from the device once, on
    first use."""
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
    # the real vocal coverage feeds AutoProfile's style estimate
    covered = sum(b - a for a, b in vad.segments)
    features.extras["vocal_coverage_ratio"] = min(1.0, covered / max(duration, 1e-9))

    # -- candidates -------------------------------------------------------------
    boundary_detection: Optional[Dict[str, Any]] = None
    lyrics_alignment: Optional[Dict[str, Any]] = None
    auto_profile: Optional[Dict[str, Any]] = None
    note: Optional[str] = None
    vres = None
    # the timeline's words, where vpbd_asr aligned lyrics
    words: Optional[List[tuple]] = None
    if mode in VPBD_MODES:
        auto_profile = _apply_smart_cut_runtime(features)
        vres = VocalPhraseBoundaryDetector(sr).detect(
            mode=mode, features=features, focus_windows=focus, duration_s=duration,
            bundle=bundle, output_dir=output_dir, stems=stems,
        )
        raw_points = [CutPoint(c.t, c.score, kind=c.source.value) for c in vres.selected]
        if not raw_points and vres.plan.rescue_points:
            # planner infeasible: the even-division rescue times stand in
            raw_points = [CutPoint(t, 0.5, kind="rescue") for t in vres.plan.rescue_points]
        boundary_detection = vres.to_meta()
        lyrics_alignment = vres.lyrics_alignment
        note = vres.note
        if vres.timeline is not None and vres.timeline.words:
            words = [(w.start_s, w.end_s) for w in vres.timeline.words]
    else:
        detector = PureVocalPauseDetector(sr)
        pauses = detector.detect_pure_vocal_pauses(
            features=features, focus_windows=focus, enable_mdd=True,
            rms_env=bundle.vocal_rms_fine,
            env_db_grid=bundle.vocal_db_fine,
            env_db_stride=bundle.db_stride,
            n_samples=len(audio),
            stems=stems,
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

    # -- pre-guard valley snap (vpbd) -------------------------------------------
    # Each planner candidate moves to the quietest point of the SAME dB grid
    # the quiet guard reads, within the SAME radius it searches, when that
    # point is at least min_drop_db quieter: the guard then finds nothing
    # quieter (shift 0), and on clean stems (flat silence) nothing moves.
    if vres is not None and raw_points:
        snap_ms = float(get_config("vpbd.candidate_valley_snap_ms", 450.0))
        if snap_ms > 0:
            drop_cfg = get_config("vpbd.candidate_valley_snap_min_drop_db", None)
            raw_points = _valley_snap_points(
                raw_points, bundle.vocal_db_guard, sr, bundle.db_stride,
                radius_ms=snap_ms,
                min_drop_db=(
                    float(drop_cfg) if drop_cfg is not None
                    else float(eqc.get("guard_db", 1.5))
                ),
                word_intervals=words,
            )
            # the planner bookkeeping and the manifest's final-cut enrichment
            # key on the snapped times, so the selected entries carry them
            # (the detected time kept as t_detected); raw_points[:len(selected)]
            # is 1:1 with selected, the music-span extras sit at the tail
            if boundary_detection and boundary_detection.get("selected"):
                for entry, pt in zip(boundary_detection["selected"], raw_points):
                    t_new = float(pt.t)
                    if abs(t_new - float(entry.get("t", t_new))) > 1e-9:
                        entry["t_detected"] = entry["t"]
                        entry["t"] = t_new

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

    # vpbd_asr: undo guard moves that landed inside a recognised word
    if mode == "vpbd_asr" and words:
        cut_times, restored_adj, n_restored = restore_guards_outside_words(
            cut_times,
            refine_result.adjustments,
            words,
            duration_s=duration,
            sr=sr,
            min_gap_s=float(qc.get("min_split_gap", 1.2)),
        )
        if restored_adj is not None:
            refine_result.adjustments = restored_adj
            logger.info("guard restore outside ASR words: %d boundaries", n_restored)

    if vres is not None:
        plan_with_shifts = apply_guard_shift_metadata(vres.plan, refine_result.adjustments)
        boundary_detection["planner"] = dict(plan_with_shifts.metadata)

    # ASR priors for the layout's rescue scoring (sentence edges) and the
    # local valley refine (words)
    asr_boundaries = None
    if words:
        asr_boundaries = sorted({
            *(s.start_s for s in vres.timeline.sentences),
            *(s.end_s for s in vres.timeline.sentences),
        })

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
            word_intervals=words,
            asr_boundaries=asr_boundaries,
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
            word_intervals=words,
        )

    # -- classification + weak-tail merge -------------------------------------------
    cut_samples = sorted({0, len(audio), *(
        int(round(t * sr)) for t in cut_times if 0 < int(round(t * sr)) < len(audio)
    )})
    flags, debug = classify_segments_vocal_presence(
        cut_samples, sr, act_rms=bundle.act_rms, n_samples=len(audio))
    cut_samples, flags, debug = merge_weak_human_tails(list(cut_samples), flags, debug, sr)

    if len(cut_samples) < 3:  # single-segment fallback
        cut_samples = [0, len(audio)]
        if not flags:
            flags = [True]
            debug = [{"index": 0, "decision": True, "reason": "single_segment_fallback"}]
        note = note or "single_segment_fallback"
    return {"cut_samples": cut_samples, "flags": flags, "debug": debug,
            "refine_result": refine_result, "suppressed_sec": suppressed_sec,
            "layout_applied": layout_applied, "vad_backend": vad_backend, "note": note,
            "boundary_detection": boundary_detection, "lyrics_alignment": lyrics_alignment,
            "auto_profile": auto_profile}


def _apply_smart_cut_runtime(features) -> Optional[Dict[str, Any]]:
    """Resolve the v2.8 intent surface into runtime overrides: intent ->
    AutoProfile ``estimate_style`` (``profile: auto``) or an explicit style
    profile -> alignment-pole lerp -> ``set_runtime_config``."""
    smart_cut = get_config("smart_cut", {}) or {}
    explicit = get_runtime_override_keys()
    try:
        intent = resolve_smart_cut_intent(smart_cut, explicit_keys=explicit)
    except ValueError as exc:
        logger.warning("invalid smart_cut intent (%s); using defaults", exc)
        return None

    overrides: Dict[str, Any] = {}
    meta: Dict[str, Any] = {"intent": intent}

    profile = intent["profile"]
    if profile == "auto":
        est = estimate_style(features)
        auto = build_auto_profile_overrides(est, cut_style=str(smart_cut.get("cut_style", "natural")))
        meta["auto_profile"] = auto.pop("meta.auto_profile", {})
        auto.pop("meta.profile", None)
        overrides.update(auto)
    elif profile in ("ballad", "pop", "edm", "rap"):
        try:
            overrides.update(profile_override_map(profile))
            meta["profile"] = profile
        except FileNotFoundError:
            logger.warning("unknown style profile %r", profile)

    style_weights = get_config("phrase_boundary.weights", {}) or {}
    for key, value in list(overrides.items()):
        if key.startswith("phrase_boundary.weights."):
            style_weights[key.split(".")[-1]] = value
    overrides.update(derive_alignment_overrides(
        intent["alignment"], style_weights,
        alignment_poles=get_config("phrase_boundary.alignment_poles", {}),
    ))
    overrides.update(derive_smart_cut_overrides(smart_cut, explicit_keys=explicit))

    if overrides:
        set_runtime_config(overrides)
    meta["applied_override_count"] = len(overrides)
    return meta


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


def _valley_snap_points(
    points,
    db_grid: np.ndarray,
    sr: int,
    db_stride: int,
    *,
    radius_ms: float,
    min_drop_db: float,
    word_intervals: Optional[List[tuple]] = None,
):
    """Snap each CutPoint's time to the quietest grid point within
    ``±radius_ms``, keeping score/kind. Only moves when the valley is at
    least ``min_drop_db`` quieter than the current position (clean stems
    stay untouched); a position strictly inside an ASR word is rejected.
    Run BEFORE NMS/guards — see the call site for why."""
    inside_word = inside_word_check(word_intervals)
    env_db = np.asarray(db_grid)
    grid_sr = sr / float(db_stride)
    radius = max(1, int(round(radius_ms / 1000.0 * grid_sr)))
    n = env_db.size
    out = []
    for p in points:
        idx = int(np.clip(round(p.t * grid_sr), 0, n - 1))
        lo = max(0, idx - radius)
        hi = min(n, idx + radius)
        best = int(np.argmin(env_db[lo:hi])) + lo
        t_best = best / grid_sr
        if env_db[idx] - env_db[best] >= min_drop_db and not inside_word(t_best):
            out.append(type(p)(float(t_best), p.score, kind=p.kind))
        else:
            out.append(p)
    return out


def _local_valley_refine(
    cut_times: List[float],
    sr: int,
    *,
    radius_ms: float,
    min_drop_db: float,
    db_grid: np.ndarray,
    db_stride: int,
    word_intervals: Optional[List[tuple]] = None,
) -> List[float]:
    """Move each cut to a strictly quieter local valley of the mix's dB grid
    within ``radius_ms``, when it is at least ``min_drop_db`` quieter. When
    ``word_intervals`` (recognised ASR words) is given, a refined position
    that lands strictly inside a word is rejected and the cut kept."""
    if not cut_times:
        return cut_times
    inside_word = inside_word_check(word_intervals)
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
        t_best = best / grid_sr
        if env_db[idx] - env_db[best] >= min_drop_db and not inside_word(t_best):
            out.append(t_best)
        else:
            out.append(t)
    return sorted(out)
