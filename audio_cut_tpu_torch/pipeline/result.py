"""The result dictionary of a mode run.

Counterpart of ``audio_cut_tpu/pipeline/result.py``: the same keys, so the
manifest builder reads either package's results. The precision guard
passes when the cut shifts average at most 150 ms and their 95th percentile
is at most 220 ms. The per-segment lyrics come with the lyrics providers
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from audio_cut_tpu_torch.io.segment_export import ExportResult

PRECISION_GUARD_AVG_MS = 150.0
PRECISION_GUARD_P95_MS = 220.0


class ResultBuilder:
    def __init__(
        self,
        *,
        precision_guard_avg_ms: float = PRECISION_GUARD_AVG_MS,
        precision_guard_p95_ms: float = PRECISION_GUARD_P95_MS,
    ) -> None:
        self.thresholds = {
            "avg": float(precision_guard_avg_ms),
            "p95": float(precision_guard_p95_ms),
        }

    def check_precision_guard(self, guard_shift_stats: Optional[Dict[str, float]]) -> bool:
        if not guard_shift_stats or not guard_shift_stats.get("count"):
            return True
        return (
            guard_shift_stats.get("avg_ms", 0.0) <= self.thresholds["avg"]
            and guard_shift_stats.get("p95_ms", 0.0) <= self.thresholds["p95"]
        )

    def build_base(
        self,
        *,
        method: str,
        export_result: ExportResult,
        export_plan: Sequence[str],
        processing_time: float,
        input_path: str,
        output_dir: str,
        cut_points_samples: Sequence[int],
        cut_points_sec: Sequence[float],
        segment_durations: Sequence[float],
        segment_vocal_flags: Optional[Sequence[bool]],
        precision_guard_ok: bool,
        success: bool = True,
        include_precision_guard_threshold: bool = False,
        guard_shift_stats: Optional[Dict[str, float]] = None,
        guard_adjustments: Optional[List[Dict[str, float]]] = None,
        segment_classification_debug: Optional[List[Dict[str, Any]]] = None,
        lyrics_alignment: Optional[Dict[str, Any]] = None,
        boundary_detection: Optional[Dict[str, Any]] = None,
        suppressed_cut_points_sec: Optional[Sequence[float]] = None,
    ) -> Dict[str, Any]:
        flags = list(segment_vocal_flags or [])
        result: Dict[str, Any] = {
            "success": bool(success),
            "method": method,
            "num_segments": len(segment_durations),
            "saved_files": list(export_result.saved_files),
            "mix_segment_files": list(export_result.mix_segment_files),
            "vocal_segment_files": list(export_result.vocal_segment_files),
            "full_vocal_file": export_result.full_vocal_file,
            "full_instrumental_file": export_result.full_instrumental_file,
            "export_plan": list(export_plan),
            "processing_time": float(processing_time),
            "segment_durations": list(segment_durations),
            "segment_vocal_flags": flags,
            "segment_labels": ["human" if f else "music" for f in flags],
            "cut_points_samples": [int(s) for s in cut_points_samples],
            "cut_points_sec": [float(t) for t in cut_points_sec],
            "precision_guard_ok": bool(precision_guard_ok),
            "input_file": input_path,
            "output_dir": output_dir,
        }
        if include_precision_guard_threshold:
            result["precision_guard_threshold_ms"] = dict(self.thresholds)
        if guard_shift_stats is not None:
            result["guard_shift_stats"] = guard_shift_stats
        if guard_adjustments is not None:
            result["guard_adjustments"] = guard_adjustments
        if segment_classification_debug is not None:
            result["segment_classification_debug"] = segment_classification_debug
        if lyrics_alignment is not None:
            result["lyrics_alignment"] = lyrics_alignment
        if boundary_detection is not None:
            result["boundary_detection"] = boundary_detection
        if suppressed_cut_points_sec is not None:
            result["suppressed_cut_points_sec"] = [float(t) for t in suppressed_cut_points_sec]
        return result

    @staticmethod
    def add_separation_metadata(result: Dict[str, Any], separation_result: Any) -> Dict[str, Any]:
        if separation_result is None:
            return result
        result["backend_used"] = getattr(separation_result, "backend_used", None)
        result["separation_confidence"] = getattr(separation_result, "separation_confidence", None)
        result.update(dict(getattr(separation_result, "device_meta", {}) or {}))
        return result

    @staticmethod
    def add_hybrid_metadata(
        result: Dict[str, Any],
        *,
        lib_flags: Sequence[bool],
        hybrid_config: Dict[str, Any],
        beat_analysis: Optional[Dict[str, Any]] = None,
        strategy: Optional[str] = None,
    ) -> Dict[str, Any]:
        result["segment_lib_flags"] = list(lib_flags)
        result["lib_segment_count"] = sum(1 for f in lib_flags if f)
        result["hybrid_config"] = dict(hybrid_config)
        if beat_analysis is not None:
            result["beat_analysis"] = beat_analysis
        if strategy is not None:
            result["strategy"] = strategy
        return result
