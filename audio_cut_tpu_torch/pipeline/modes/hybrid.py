"""hybrid_mdd: the v2.2_mdd cuts, beat-snapped by a strategy, with _lib tags.

Counterpart of ``audio_cut_tpu/pipeline/modes/hybrid.py``: a ``v2.2_mdd``
sub-run with no export gives the MDD cuts and stashes its device pass
(audio, stems, bundle) on the splitter; this run pops it when the key (the
file's identity and the config's generation) matches, so a track runs ONE
separation and bundle. On a miss it runs the pass again, with the bundle
built without the VAD model, as the JAX package's staged path does. Then,
on the host: the
``BeatAnalyzer`` over the bundle's features, the strategy (``snap_to_beat``
or ``beat_only``), the quiet guards again through ``finalize_cut_points``,
the _lib flags mapped onto the guarded cuts, the classification, the
sample-exact split and the export with the _lib suffix on every segment
whose opening cut is beat-aligned.

The bundle is never None in the port, so the JAX package's host-waveform
branches (the feature build, the vocal RMS and the classification from a
host vocal) have no caller here.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
from torch.profiler import record_function

from audio_cut_tpu_torch.analysis.beat_analyzer import BeatAnalyzer
from audio_cut_tpu_torch.config import get_config
from audio_cut_tpu_torch.cutting.refine import (
    CutContext,
    CutPoint,
    QuietLookup,
    finalize_cut_points,
    guard_shift_stats,
)
from audio_cut_tpu_torch.io.segment_export import ExportResult
from audio_cut_tpu_torch.pipeline.classify import classify_segments_vocal_presence
from audio_cut_tpu_torch.pipeline.modes.pure_vocal import fused_pass_key
from audio_cut_tpu_torch.pipeline.split import split_at_sample_level
from audio_cut_tpu_torch.pipeline.strategies import SegmentationContext, build_strategy
from audio_cut_tpu_torch.separation import fused


def process_hybrid_mdd(
    splitter,
    input_path: str,
    output_dir: str,
    *,
    export_plan: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    t0 = time.time()
    sr = splitter.sample_rate
    hcfg = get_config("hybrid_mdd", {}) or {}

    # 1. the v2.2_mdd sub-run for the MDD cuts (no export); it stashes its
    # device pass for step 2. A standalone v2.2_mdd run never stashes.
    splitter._want_fused_pass_memo = True
    base = None
    try:
        base = splitter.split_audio_seamlessly(
            input_path, output_dir, mode="v2.2_mdd", export_plan=("none",)
        )
    finally:
        splitter._want_fused_pass_memo = False
        # a sub-run that failed or raised may have stashed the track's
        # device stems: drop them, or they stay pinned on the splitter
        if base is None or not base.get("success"):
            splitter._fused_pass_memo = None
    if not base.get("success"):
        return base
    mdd_cuts = [
        float(t) for t in base.get("cut_points_sec", [])
        if 0.0 < float(t) < float(base["cut_points_sec"][-1])
    ]

    # 2. the sub-run's pass when it is for this file under this config
    audio = sep = bundle = None
    memo = splitter._fused_pass_memo
    if memo is not None:
        splitter._fused_pass_memo = None
        key = fused_pass_key(input_path)
        if key is not None and memo[0] == key:
            _, audio, sep, bundle = memo
    if audio is None:
        audio = splitter._load(input_path)
    duration = len(audio) / float(sr)
    qc = get_config("v2_mdd.quality_control", {}) or {}
    eqc = qc.get("enforce_quiet_cut", {}) or {}
    if sep is None:  # a miss: the pass again; the bundle without the VAD
        sep, bundle = fused.separate_and_detect_fused(
            splitter.separator, None, audio, guard_win_ms=float(eqc.get("win_ms", 80)),
            staged=True)
    features = bundle.features

    # 3. beat analysis and the strategy's cuts
    density = str(hcfg.get("beat_cut_density", "medium"))
    preset = (hcfg.get("density_presets", {}) or {}).get(density, {}) or {}
    with record_function("host_tail"):
        analyzer = BeatAnalyzer(
            time_signature=int((hcfg.get("beat_detection", {}) or {}).get("time_signature", 4)),
            energy_percentile=float(preset.get("energy_percentile", 60)),
        )
        beat_analysis = analyzer.analyze(features)
        strategy = build_strategy(str(hcfg.get("lib_alignment", "snap_to_beat")))
        ctx = SegmentationContext(
            duration_s=duration,
            mdd_cuts=mdd_cuts,
            beat_analysis=beat_analysis,
            features=features,
            vocal_rms=bundle.vocal_rms_grid,
            config={
                **hcfg,
                "bars_per_cut": int(preset.get("bars_per_cut", 2)),
            },
        )
        sres = strategy.generate_cut_points(ctx)

        # 4. the quiet guards again, then the _lib flags onto the guarded times
        floor_pct = float(eqc.get("floor_percentile", 0.5))
        vocal_lookup = QuietLookup(
            sr=sr, db_grid=bundle.vocal_db_guard, stride=bundle.db_stride,
            floor_db=eqc.get("floor_db_override"), floor_percentile=floor_pct,
        )
        mix_lookup = QuietLookup(
            sr=sr, db_grid=bundle.mix_db_guard, stride=bundle.db_stride,
            floor_db=eqc.get("floor_db_override"), floor_percentile=floor_pct,
        )
        refine_result = finalize_cut_points(
            CutContext(sr=sr, mix_wave=audio),
            [CutPoint(t, 0.9 if lib else 0.8, kind="beat" if lib else "pause")
             for t, lib in zip(sres.cuts, sres.lib_flags)],
            min_gap_s=float(qc.get("min_split_gap", 1.2)),
            guard_db=float(eqc.get("guard_db", 1.5)),
            search_right_ms=float(eqc.get("search_right_ms", 450)),
            vocal_lookup=vocal_lookup,
            mix_lookup=mix_lookup,
        )
        final_times = [p.t for p in refine_result.final_points]
        lib_by_raw = {round(t, 4): lib for t, lib in zip(sres.cuts, sres.lib_flags)}
        snap_remap_s = float(hcfg.get("snap_tolerance_ms", 200)) / 1000.0
        raw_arr = np.asarray(sres.cuts) if sres.cuts else np.zeros(0)
        cut_lib_flags: List[bool] = []
        for t in final_times:
            if raw_arr.size:
                j = int(np.argmin(np.abs(raw_arr - t)))
                near = abs(raw_arr[j] - t) <= snap_remap_s
                lib = lib_by_raw.get(round(float(raw_arr[j]), 4), False)
                cut_lib_flags.append(bool(near and lib))
            else:
                cut_lib_flags.append(False)

    # 5. classification, the split and the export with the _lib suffix
    with record_function("export"):
        cut_samples = sorted({0, len(audio), *(
            int(round(t * sr)) for t in final_times if 0 < int(round(t * sr)) < len(audio)
        )})
        flags, debug = classify_segments_vocal_presence(
            cut_samples, sr, act_rms=bundle.act_rms, n_samples=len(audio))
        segments, flags_out, debug_out = split_at_sample_level(
            audio, cut_samples, sr, segment_flags=flags, debug_entries=debug
        )
        flags_out = flags_out or flags
        seg_durations = [len(s) / float(sr) for s in segments]

        # a segment is _lib when its opening cut is beat-aligned
        seg_lib = [bool(cut_lib_flags[i - 1]) if 0 < i <= len(cut_lib_flags) else False
                   for i in range(len(segments))]

        lib_suffix = str((hcfg.get("labeling", {}) or {}).get("lib_suffix", "_lib"))
        export_flags = splitter._normalize_export_plan(export_plan, default=("mix_segments",))
        export_result = ExportResult()
        if "mix_segments" in export_flags:
            export_result.mix_segment_files = splitter.segment_exporter.export_segments(
                segments, output_dir,
                segment_is_vocal=flags_out,
                export_format=splitter._export_format,
                export_options=splitter._export_options,
                lib_flags=seg_lib,
                lib_suffix=lib_suffix,
            )
            export_result.saved_files.extend(export_result.mix_segment_files)

    stats = guard_shift_stats(refine_result.adjustments)
    result = splitter.result_builder.build_base(
        method="hybrid_mdd",
        export_result=export_result,
        export_plan=sorted(export_flags),
        processing_time=time.time() - t0,
        input_path=input_path,
        output_dir=output_dir,
        cut_points_samples=list(cut_samples),
        cut_points_sec=[s / float(sr) for s in cut_samples],
        segment_durations=seg_durations,
        segment_vocal_flags=flags_out,
        precision_guard_ok=splitter.result_builder.check_precision_guard(stats),
        include_precision_guard_threshold=True,
        guard_shift_stats=stats,
        segment_classification_debug=debug_out,
    )
    result = splitter.result_builder.add_hybrid_metadata(
        result,
        lib_flags=seg_lib,
        hybrid_config={
            "beat_cut_density": density,
            "lib_alignment": strategy.name,
            "snap_tolerance_ms": hcfg.get("snap_tolerance_ms", 200),
            "bars_per_cut": int(preset.get("bars_per_cut", 2)),
        },
        beat_analysis=beat_analysis.to_meta(),
        strategy=strategy.name,
    )
    return splitter.result_builder.add_separation_metadata(result, sep)
