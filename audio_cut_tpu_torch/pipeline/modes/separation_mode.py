"""vocal_separation mode: stems only, no cuts.

Counterpart of ``audio_cut_tpu/pipeline/modes/separation_mode.py``: export
naming ``{stem}_vocal_{dur:.1f}`` / ``{stem}_instrumental_{dur:.1f}`` and the
same result fields. Only the vocal crosses to the host, packed on the device
as 24-bit PCM; the instrumental is rebuilt on the host as mix - vocal.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

from audio_cut_tpu_torch.config import get_config
from audio_cut_tpu_torch.pipeline.result import (
    PRECISION_GUARD_AVG_MS,
    PRECISION_GUARD_P95_MS,
)


def process_vocal_separation(
    splitter,
    input_path: str,
    output_dir: str,
    *,
    export_plan: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    t0 = time.time()
    sr = splitter.sample_rate
    audio = splitter._load(input_path)
    # need_instrumental=False keeps both stems on the device: only the vocal
    # is downloaded, and the instrumental is rebuilt on the host as
    # mix - vocal (SeparationResult.complement_instrumental)
    sep = splitter.separator.separate_for_detection(audio, need_instrumental=False)

    if not sep.has_vocal:
        return {"success": False, "error": "vocal_separation_failed", "input_file": input_path}

    vocal_payload = None
    if (
        sep.vocal_device is not None
        and splitter._export_format == "wav"
        and str((splitter._export_options or {}).get("subtype", "PCM_24")) == "PCM_24"
        and bool(get_config("device_pipeline.pcm24_stem_download", True))
    ):
        # quantize the vocal to the export grid on the device and download 3
        # bytes a sample instead of 4; the host complement below then uses
        # exactly the values the file decodes to
        from audio_cut_tpu_torch.ops.pcm import (
            pcm24_pack_graph,
            pcm24_planes_to_float,
            pcm24_planes_to_payload,
        )

        planes = pcm24_pack_graph(sep.vocal_device).cpu().numpy()
        vocal_payload = pcm24_planes_to_payload(planes)
        sep.vocal_track = pcm24_planes_to_float(planes)
    sep.complement_instrumental(audio)

    flags = splitter._normalize_export_plan(
        export_plan, default=("full_vocal", "full_instrumental")
    )
    stem = Path(input_path).stem
    saved = []
    full_vocal = full_inst = None

    if "full_vocal" in flags:
        dur = len(sep.vocal_track) / float(sr)
        vocal_opts = dict(splitter._export_options or {})
        if vocal_payload is not None:
            vocal_opts["pcm24_payload"] = vocal_payload
        full_vocal = splitter.segment_exporter.export_full_track(
            sep.vocal_track,
            Path(output_dir) / f"{stem}_vocal_{dur:.1f}",
            export_format=splitter._export_format,
            export_options=vocal_opts,
        )
        saved.append(full_vocal)

    if "full_instrumental" in flags and sep.instrumental_track is not None:
        dur = len(sep.instrumental_track) / float(sr)
        full_inst = splitter.segment_exporter.export_full_track(
            sep.instrumental_track,
            Path(output_dir) / f"{stem}_instrumental_{dur:.1f}",
            export_format=splitter._export_format,
            export_options=splitter._export_options,
        )
        saved.append(full_inst)

    result: Dict[str, Any] = {
        "success": True,
        "method": "vocal_separation_only",
        "num_segments": 0,
        "saved_files": saved,
        "mix_segment_files": [],
        "vocal_segment_files": [],
        "full_vocal_file": full_vocal,
        "full_instrumental_file": full_inst,
        "export_plan": sorted(flags),
        "backend_used": sep.backend_used,
        "separation_confidence": sep.separation_confidence,
        "processing_time": time.time() - t0,
        "segment_durations": [],
        "guard_shift_stats": {"count": 0, "avg_ms": 0.0, "max_ms": 0.0, "p95_ms": 0.0},
        "precision_guard_ok": True,
        "precision_guard_threshold_ms": {
            "avg": PRECISION_GUARD_AVG_MS,
            "p95": PRECISION_GUARD_P95_MS,
        },
        "input_file": input_path,
        "output_dir": output_dir,
    }
    result.update(dict(sep.device_meta or {}))
    return result
