"""Public library API: separate_and_segment -> SegmentManifest dict.

Counterpart of ``audio_cut_tpu/api.py``, with the same signature and
manifest schema. The ``device`` argument maps to
``gpu_pipeline.prefer_device``, which defaults to ``cuda``; with no CUDA
device and no explicit ``"cpu"`` the call raises. The port runs the default
``mode="v2.2_mdd"``, ``mode="vpbd_acoustic"``, ``mode="vpbd_asr"``,
``mode="hybrid_mdd"``, ``mode="librosa_onset"`` (whose manifest carries
``smart_segmentation``) and ``mode="vocal_separation"``. The intent arguments
(``segments``/``alignment``) default the mode to ``vpbd_asr`` and turn
lyrics alignment on (provider ``auto``, not strict) before
``runtime_overrides`` apply; the manifest then echoes the resolved
``intent``. Where lyrics were aligned, each manifest segment carries the
words it holds.

``separate_and_segment_batch`` processes many tracks: one separation pass
over the devices of a mesh (``parallel/batch.py:separate_tracks_mesh``, every
CUDA device by default), then each track's detection, cutting and export
with its stems injected (``separation/precomputed.py``), one manifest per
track in its own export subdirectory. Its manifests' cuts and segments equal
single calls'. Unlike the JAX package, a failure of the mesh pass itself
raises (a track that fails to load or to cut fills its own slot), and
nothing falls back to the CPU.

Unlike the JAX package, a failure of the manifest's lyrics attach raises
instead of leaving the segments without lyrics.

The manifest's ``cuts.final`` enriches each final cut with its planner
candidate and guard shift, as the JAX package's ``_build_final_cuts`` does,
its known defect included: a cut that layout moved loses its enrichment.
"""

from __future__ import annotations

import copy
import hashlib
import json
import logging
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence

from torch.profiler import record_function

from audio_cut_tpu_torch.config import get_config_manager
from audio_cut_tpu_torch.config.auto_profile import resolve_smart_cut_intent
from audio_cut_tpu_torch.config.manager import get_nested, set_nested
from audio_cut_tpu_torch.pipeline.qa import build_qa_report
from audio_cut_tpu_torch.pipeline.splitter import SmartSplitter
from audio_cut_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def _apply_call_overrides(mgr, *, device, strict_gpu, layout, overrides) -> None:
    """Apply one call's device/layout/dotted overrides onto ``mgr.config``.
    The caller snapshots and restores ``mgr.config`` around the call."""
    if device:
        set_nested(mgr.config, "gpu_pipeline.prefer_device", device)
    if strict_gpu is not None:
        set_nested(mgr.config, "gpu_pipeline.strict_gpu", bool(strict_gpu))
    if layout:
        ld = dict(layout)
        set_nested(mgr.config, "segment_layout.enable", bool(ld.pop("enable", True)))
        for k, v in ld.items():
            set_nested(mgr.config, f"segment_layout.{k}", v)
    for dotted, value in (overrides or {}).items():
        set_nested(mgr.config, dotted, value)


def separate_and_segment(
    *,
    input_uri: str,
    export_dir: str,
    mode: Optional[str] = None,
    segments: Any = None,
    alignment: Any = None,
    device: Optional[str] = None,
    export_types: Optional[Sequence[str]] = None,
    layout: Optional[Mapping[str, Any]] = None,
    strict_gpu: Optional[bool] = None,
    export_manifest: bool = False,
    manifest_filename: str = "SegmentManifest.json",
    runtime_overrides: Optional[Mapping[str, Any]] = None,
) -> Dict[str, Any]:
    """Separate + segment one track and emit a manifest."""
    input_path = Path(input_uri).expanduser().resolve()
    if not input_path.exists():
        raise FileNotFoundError(f"input audio not found: {input_path}")
    export_path = Path(export_dir).expanduser().resolve()

    has_intent = segments is not None or alignment is not None
    effective_mode = mode or ("vpbd_asr" if has_intent else "v2.2_mdd")

    overrides: Dict[str, Any] = {}
    if has_intent:
        overrides.update({
            "lyrics_alignment.enabled": True,
            "lyrics_alignment.provider": "auto",
            "lyrics_alignment.strict": False,
        })
        if segments is not None:
            overrides["smart_cut.segments"] = segments
        if alignment is not None:
            overrides["smart_cut.alignment"] = alignment
    overrides.update(dict(runtime_overrides or {}))

    mgr = get_config_manager()
    snapshot = mgr.snapshot()
    try:
        _apply_call_overrides(mgr, device=device, strict_gpu=strict_gpu,
                              layout=layout, overrides=overrides)
        torch_device = resolve_device(get_nested(mgr.config, "gpu_pipeline.prefer_device", "cuda"))
        export_path.mkdir(parents=True, exist_ok=True)

        layout_cfg = copy.deepcopy(get_nested(mgr.config, "segment_layout", {}) or {})
        sample_rate = int(get_nested(mgr.config, "audio.sample_rate", 44100))
        channels = int(get_nested(mgr.config, "audio.channels", 1))
        intent_echo = (resolve_smart_cut_intent(get_nested(mgr.config, "smart_cut", {}) or {})
                       if has_intent else None)

        splitter = SmartSplitter(torch_device, sample_rate=sample_rate)
        result = splitter.split_audio_seamlessly(
            str(input_path),
            str(export_path),
            mode=effective_mode,
            export_plan=list(export_types) if export_types is not None else None,
        )
        if intent_echo is not None:
            result.setdefault("intent", intent_echo)
    finally:
        mgr.restore(snapshot)

    manifest = _build_manifest(
        result=result,
        input_path=input_path,
        export_dir=export_path,
        mode=effective_mode,
        sample_rate=sample_rate,
        channels=channels,
        layout_cfg=layout_cfg,
    )
    if export_manifest:
        mpath = export_path / manifest_filename
        mpath.write_text(json.dumps(manifest, ensure_ascii=False, indent=2), encoding="utf-8")
        manifest["manifest_path"] = mpath.as_posix()
    return manifest


def separate_and_segment_batch(
    *,
    input_uris: Sequence[str],
    export_dir: str,
    mode: Optional[str] = None,
    device: Optional[str] = None,
    export_types: Optional[Sequence[str]] = None,
    layout: Optional[Mapping[str, Any]] = None,
    strict_gpu: Optional[bool] = None,
    export_manifest: bool = True,
    manifest_filename: str = "SegmentManifest.json",
    runtime_overrides: Optional[Mapping[str, Any]] = None,
    mesh: Any = None,
    workers: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Process N tracks: one manifest per track, in input order.

    The separation runs once for the whole batch over ``mesh``
    (``parallel/mesh.make_mesh``; by default every CUDA device, or the CPU
    for ``device="cpu"``), each track with its single-call OLA plan. Then
    each track's mode runs on ``workers`` host threads (1 by default) on the
    staged path (``device_pipeline.fused_program`` off for the call) with
    its vocal injected through ``PrecomputedStemEngine``. ``librosa_onset``
    without separation skips the mesh pass. Each track exports to
    ``export_dir/<input stem>/`` (``<stem>_1``, ... on a name collision). A
    track that fails to load or to cut reports ``{"success": False,
    "error", "input_file"}`` in its slot; the rest of the batch goes on.
    """
    from audio_cut_tpu_torch.io.audio import load_audio
    from audio_cut_tpu_torch.parallel.batch import separate_tracks_mesh
    from audio_cut_tpu_torch.parallel.mesh import make_mesh
    from audio_cut_tpu_torch.separation.backends import make_backend
    from audio_cut_tpu_torch.separation.engine import SeparationEngine
    from audio_cut_tpu_torch.separation.precomputed import PrecomputedStemEngine

    paths = [Path(u).expanduser().resolve() for u in input_uris]
    for p in paths:
        if not p.exists():
            raise FileNotFoundError(f"input audio not found: {p}")
    export_root = Path(export_dir).expanduser().resolve()

    # per-track export subdirs: the input stem, deduplicated
    seen: Dict[str, int] = {}
    subdirs: List[Path] = []
    for p in paths:
        k = seen.get(p.stem, 0)
        seen[p.stem] = k + 1
        subdirs.append(export_root / (p.stem if k == 0 else f"{p.stem}_{k}"))

    effective_mode = mode or "v2.2_mdd"
    mgr = get_config_manager()
    snapshot = mgr.snapshot()
    manifests: List[Optional[Dict[str, Any]]] = [None] * len(paths)
    try:
        _apply_call_overrides(mgr, device=device, strict_gpu=strict_gpu,
                              layout=layout, overrides=runtime_overrides)
        # the mesh pass has separated; the host stage runs the staged bundle
        # path over the injected stems
        set_nested(mgr.config, "device_pipeline.fused_program", False)
        torch_device = resolve_device(get_nested(mgr.config, "gpu_pipeline.prefer_device", "cuda"))
        export_root.mkdir(parents=True, exist_ok=True)

        layout_cfg = copy.deepcopy(get_nested(mgr.config, "segment_layout", {}) or {})
        sample_rate = int(get_nested(mgr.config, "audio.sample_rate", 44100))
        channels = int(get_nested(mgr.config, "audio.channels", 1))
        backend_name = str(get_nested(mgr.config, "enhanced_separation.backend", "convtdf"))

        audios: List[Optional[Any]] = [None] * len(paths)
        for i, p in enumerate(paths):
            try:
                audios[i] = load_audio(str(p), target_sr=sample_rate, mono=True)[0]
            except Exception as exc:  # the track's slot reports it; the batch goes on
                logger.exception("batch track %s failed to load", p)
                manifests[i] = {"success": False, "error": str(exc), "input_file": str(p)}

        # the mesh pass: one separation of every track that loaded
        vocals: List[Optional[Any]] = [None] * len(paths)
        align = 1
        live = [i for i in range(len(paths)) if audios[i] is not None]
        if live and (effective_mode != "librosa_onset" or bool(get_nested(
                mgr.config, "librosa_onset.use_vocal_separation", True))):
            if mesh is None:
                mesh = make_mesh("cpu") if torch_device.type == "cpu" else make_mesh()
            # one backend instance for the mesh pass and the host stage's
            # padding: the injected stems pad with its align
            backend = make_backend(backend_name, sample_rate, mesh.devices[0])
            align = SeparationEngine(sample_rate, mesh.devices[0], backend=backend)._geometry()[3]
            with record_function("mesh_pass"):
                stems = separate_tracks_mesh([audios[i] for i in live], sample_rate, mesh=mesh,
                                             backend=backend)
            for i, (vocal, _inst) in zip(live, stems):
                vocals[i] = vocal  # the modes rebuild the instrumental as mix - vocal
        meta = {"gpu_pipeline_mode": "mesh_batch_precomputed",
                "gpu_pipeline_batch_size": len(paths)}

        def run_one(i: int) -> Dict[str, Any]:
            subdirs[i].mkdir(parents=True, exist_ok=True)
            splitter = SmartSplitter(torch_device, sample_rate=sample_rate)
            if vocals[i] is not None:
                splitter._separator = PrecomputedStemEngine(
                    sample_rate, torch_device, vocals[i], backend_name, meta=meta, align=align)
            result = splitter.split_audio_seamlessly(
                str(paths[i]), str(subdirs[i]), mode=effective_mode,
                export_plan=list(export_types) if export_types is not None else None,
            )
            manifest = _build_manifest(
                result=result, input_path=paths[i], export_dir=subdirs[i],
                mode=effective_mode, sample_rate=sample_rate, channels=channels,
                layout_cfg=layout_cfg,
            )
            if export_manifest:
                mpath = subdirs[i] / manifest_filename
                mpath.write_text(json.dumps(manifest, ensure_ascii=False, indent=2),
                                 encoding="utf-8")
                manifest["manifest_path"] = mpath.as_posix()
            return manifest

        def settle(i: int, run) -> None:
            try:
                manifests[i] = run()
            except Exception as exc:  # the track's slot reports it; the batch goes on
                logger.exception("batch track %s failed", paths[i])
                manifests[i] = {"success": False, "error": str(exc), "input_file": str(paths[i])}

        pending = [i for i in range(len(paths)) if manifests[i] is None]
        n_workers = max(1, int(workers)) if workers else 1
        if n_workers == 1:
            for i in pending:
                settle(i, lambda i=i: run_one(i))
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=n_workers) as pool:
                futures = {i: pool.submit(run_one, i) for i in pending}
                for i, fut in futures.items():
                    settle(i, fut.result)
    finally:
        mgr.restore(snapshot)
    return manifests  # type: ignore[return-value]


# -- manifest -------------------------------------------------------------


def _sha256(path: Path) -> str:
    digest = hashlib.sha256()
    with path.open("rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def _rel(path_value: Any, base: Path) -> Optional[str]:
    if not path_value:
        return None
    p = Path(str(path_value))
    try:
        return p.resolve().relative_to(base).as_posix()
    except ValueError:
        return p.as_posix()


def _build_final_cuts(result: Mapping[str, Any]) -> List[Any]:
    """Enrich final cut times with planner candidate metadata + guard shifts:
    joins the planner's final_time_by_raw_time and guard_shift_ms_by_raw_time
    onto cut_points_sec. Without ``boundary_detection`` the plain times."""
    cut_points = list(result.get("cut_points_sec", []))
    bd = result.get("boundary_detection")
    if not isinstance(bd, Mapping):
        return cut_points
    planner = bd.get("planner") if isinstance(bd.get("planner"), Mapping) else {}

    final_by_raw: Dict[float, float] = {}
    for raw, fin in (planner.get("final_time_by_raw_time", {}) or {}).items():
        try:
            final_by_raw[round(float(raw), 6)] = float(fin)
        except (TypeError, ValueError):
            continue

    selected_by_final: Dict[float, Mapping[str, Any]] = {}
    for item in bd.get("selected", []) or []:
        if not isinstance(item, Mapping):
            continue
        try:
            raw_key = round(float(item.get("t")), 6)
        except (TypeError, ValueError):
            continue
        selected_by_final[round(final_by_raw.get(raw_key, raw_key), 6)] = item

    guard_by_final: Dict[float, Any] = {}
    for raw, shift in (planner.get("guard_shift_ms_by_raw_time", {}) or {}).items():
        try:
            raw_key = round(float(raw), 6)
        except (TypeError, ValueError):
            continue
        guard_by_final[round(final_by_raw.get(raw_key, raw_key), 6)] = shift

    if not selected_by_final and not guard_by_final:
        return cut_points

    out: List[Any] = []
    for t in cut_points:
        key = round(float(t), 6)
        entry: Dict[str, Any] = {"t": float(t)}
        cand = selected_by_final.get(key)
        if cand is not None:
            entry["score"] = cand.get("score")
            entry["source"] = cand.get("source")
            entry["features"] = dict(cand.get("features", {}) or {})
            entry["reasons"] = list(cand.get("reasons", []) or [])
            entry["meta"] = dict(cand.get("meta", {}) or {})
        if key in guard_by_final:
            entry["guard_shift_ms"] = guard_by_final[key]
        out.append(entry)
    return out


def _build_segments(result: Mapping[str, Any], export_dir: Path) -> List[Dict[str, Any]]:
    cut_points = list(result.get("cut_points_sec", []))
    labels = list(result.get("segment_labels", []))
    durations = list(result.get("segment_durations", []))
    mix_files = list(result.get("mix_segment_files", []))
    vocal_files = list(result.get("vocal_segment_files", []))
    debug = list(result.get("segment_classification_debug", []))

    segments: List[Dict[str, Any]] = []
    for idx, label in enumerate(labels):
        start = cut_points[idx] if idx < len(cut_points) else sum(durations[:idx])
        end = cut_points[idx + 1] if idx + 1 < len(cut_points) else (
            start + (durations[idx] if idx < len(durations) else 0.0)
        )
        entry: Dict[str, Any] = {
            "id": f"{idx + 1:04d}",
            "start": start,
            "end": end,
            "duration": durations[idx] if idx < len(durations) else end - start,
            "label": label,
        }
        if idx < len(mix_files):
            entry["mix_path"] = _rel(mix_files[idx], export_dir)
        if idx < len(vocal_files):
            entry["vocal_path"] = _rel(vocal_files[idx], export_dir)
        if idx < len(debug) and debug[idx]:
            entry["debug"] = debug[idx]
        segments.append(entry)

    lyrics = result.get("lyrics_alignment")
    if isinstance(lyrics, Mapping) and isinstance(lyrics.get("timeline"), Mapping):
        from audio_cut_tpu_torch.lyrics.models import LyricsTimeline
        from audio_cut_tpu_torch.lyrics.segment_attach import attach_lyrics_to_segments

        timeline = LyricsTimeline.from_dict(dict(lyrics["timeline"]), strict=False)
        return attach_lyrics_to_segments(segments, timeline)
    return segments


def _collect_artifacts(result: Mapping[str, Any], export_dir: Path) -> Dict[str, Any]:
    artifacts: Dict[str, Any] = {}
    if result.get("mix_segment_files"):
        artifacts["music_segments"] = [_rel(p, export_dir) for p in result["mix_segment_files"]]
    if result.get("vocal_segment_files"):
        artifacts["human_segments"] = [_rel(p, export_dir) for p in result["vocal_segment_files"]]
    if result.get("full_vocal_file"):
        artifacts["vocal_full"] = _rel(result["full_vocal_file"], export_dir)
    if result.get("full_instrumental_file"):
        artifacts["instrumental_full"] = _rel(result["full_instrumental_file"], export_dir)
    if result.get("saved_files"):
        artifacts["all"] = [_rel(p, export_dir) for p in result["saved_files"]]
    artifacts["output_dir"] = export_dir.as_posix()
    return artifacts


def _estimate_duration(result: Mapping[str, Any], input_path: Path) -> Optional[float]:
    cuts = result.get("cut_points_sec")
    if cuts:
        try:
            return float(cuts[-1])
        except (TypeError, ValueError):
            pass
    from audio_cut_tpu_torch.exceptions import AudioIOError
    from audio_cut_tpu_torch.io.wavio import wav_info

    try:
        info = wav_info(input_path)
        if info.frames and info.sample_rate:
            return info.frames / float(info.sample_rate)
    except (AudioIOError, OSError):
        pass
    durations = result.get("segment_durations")
    if durations:
        try:
            return float(sum(durations))
        except (TypeError, ValueError):
            pass
    return None


def _build_manifest(
    *,
    result: Dict[str, Any],
    input_path: Path,
    export_dir: Path,
    mode: str,
    sample_rate: int,
    channels: int,
    layout_cfg: Mapping[str, Any],
) -> Dict[str, Any]:
    manifest: Dict[str, Any] = {
        "version": str(mode),
        "success": bool(result.get("success", False)),
        "job": {"source": input_path.as_posix()},
        "export_plan": result.get("export_plan") or [],
        "audio": {
            "sr": sample_rate,
            "channels": channels,
            "duration": _estimate_duration(result, input_path),
            "hash": f"sha256:{_sha256(input_path)}",
        },
        "layout_cfg": dict(layout_cfg) | {"applied": bool(result.get("segment_layout_applied", False))},
        "cuts": {
            "final": _build_final_cuts(result),
            "samples": result.get("cut_points_samples", []),
            "suppressed": result.get("suppressed_cut_points_sec", []),
        },
        "segments": _build_segments(result, export_dir),
        "artifacts": _collect_artifacts(result, export_dir),
        "guard": {
            "shift_stats": result.get("guard_shift_stats", {}),
            "adjustments": result.get("guard_adjustments", []),
            "precision_ok": bool(result.get("precision_guard_ok", True)),
            "threshold_ms": result.get("precision_guard_threshold_ms", {}),
        },
        "separation": {
            "backend": result.get("backend_used"),
            "confidence": result.get("separation_confidence"),
        },
        "timings_ms": {
            "total": int(round(float(result["processing_time"]) * 1000.0))
            if result.get("processing_time") is not None else None,
        },
        "stats": {"num_segments": int(result.get("num_segments", 0))},
    }

    for key in ("note", "lyrics_alignment", "boundary_detection", "auto_profile", "intent"):
        if result.get(key) is not None:
            manifest[key] = result[key]

    device_meta = {k: result[k] for k in result if k.startswith("gpu_pipeline_")}
    if device_meta:
        manifest["gpu"] = device_meta

    manifest["qa_report"] = build_qa_report(manifest)

    if result.get("bpm") is not None or result.get("method") == "smart_segment_v2":
        manifest["smart_segmentation"] = {
            "method": result.get("method"),
            "bpm": result.get("bpm"),
            "bar_duration_s": result.get("bar_duration_s"),
            "density": result.get("density"),
            "silence_boundaries": result.get("silence_boundaries", []),
        }
    return manifest


__all__ = ["separate_and_segment", "separate_and_segment_batch"]
