"""Command-line entry point: ``python -m audio_cut_tpu_torch.cli``.

Counterpart of ``audio_cut_tpu/cli.py``, with the same flags, destinations,
choices, defaults and exit codes: 2 for a missing input, 3 for exported
segments that do not splice back to the input (``--validate-reconstruction``),
1 for a manifest with ``success: false`` or a failed track of a batch. An
intent flag (``--segments``/``--align``) without ``--mode`` runs
``vpbd_asr``; otherwise ``v2.2_mdd``. Two verbs come before the arguments:
``batch`` (``separate_and_segment_batch`` over every CUDA device) and
``warmup`` (``warmup.py``).

Where it differs from the JAX package:

* ``--device`` takes ``cuda``, ``cuda:N`` or ``cpu`` (``utils/device.py``).
  Without it the command runs on CUDA and raises where there is none; it
  never carries on on the CPU.
* ``--compat-config v2`` reads the legacy file with
  ``config/yaml_subset.load_file``: YAML outside that subset raises
  ``ValueError`` naming the file and the line.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path
from typing import Any, Dict, Optional

from audio_cut_tpu_torch.pipeline.splitter import KNOWN_MODES

logger = logging.getLogger(__name__)

PROG = "python -m audio_cut_tpu_torch.cli"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=PROG,
        description="vocal smart splitter on CUDA: separate + segment at natural vocal pauses",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=f"""
examples:
  {PROG} input/song.wav --segments medium --align beat_lean
  {PROG} input/song.wav --segments 6-14 --align 0.75
  {PROG} input/song.wav --mode vocal_separation
  {PROG} input/song.wav --mode hybrid_mdd
  {PROG} warmup                 # build the CUDA kernels, run each path once
  {PROG} batch a.wav b.wav -o out   # N tracks, one separation pass
""",
    )
    parser.add_argument("input_file", help="input audio path (WAV)")
    parser.add_argument("--output-dir", "-o", default=None,
                        help="export directory (default: output.directory config)")
    parser.add_argument("--mode", choices=list(KNOWN_MODES), default=None,
                        help="explicit processing mode; omit to route by intent flags "
                             "(intent -> vpbd_asr, otherwise v2.2_mdd)")
    parser.add_argument("--segments", default=None,
                        help="segment density intent: few|medium|many or MIN-MAX seconds (e.g. 6-14)")
    parser.add_argument("--align", default=None,
                        help="alignment intent: lyric|lyric_lean|balanced|beat_lean|beat or 0.0-1.0")
    parser.add_argument("--profile", choices=["auto", "ballad", "pop", "edm", "rap"], default=None,
                        help="style profile override")
    parser.add_argument("--device", "--gpu-device", dest="device", default=None,
                        help="cuda, cuda:N or cpu (default: gpu_pipeline.prefer_device, cuda; "
                             "raises where there is no CUDA device)")
    parser.add_argument("--strict-device", "--strict-gpu", dest="strict_device", action="store_true",
                        help="fail instead of falling back when the accelerator path errors")
    parser.add_argument("--compat-config", choices=["v2"], default=None,
                        help="migrate a legacy v2 config file and apply it")
    parser.add_argument("--compat-config-path", default=None,
                        help="path of the legacy config for --compat-config")
    parser.add_argument("--lyrics-provider",
                        choices=["disabled", "fake", "auto", "sidecar", "cli",
                                 "in_process", "null"], default=None)
    parser.add_argument("--lyrics-fixture", default=None,
                        help="timeline fixture JSON for the fake provider")
    parser.add_argument("--sidecar-endpoint", "--firered-endpoint", dest="sidecar_endpoint", default=None)
    parser.add_argument("--asr-chunk-s", type=float, default=None)
    parser.add_argument("--asr-overlap-s", type=float, default=None)
    parser.add_argument("--asr-strict", action="store_true")
    parser.add_argument("--validate-reconstruction", action="store_true",
                        help="verify the exported segments concatenate back to the input")
    parser.add_argument("--manifest", action="store_true", default=True,
                        help="write SegmentManifest.json (default on)")
    parser.add_argument("--json", action="store_true", help="print the manifest JSON to stdout")
    parser.add_argument("--verbose", "-v", action="store_true")
    return parser


def build_batch_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=f"{PROG} batch",
        description="batch processing: N tracks, one separation pass over the CUDA devices",
    )
    parser.add_argument("input_files", nargs="+", help="input audio paths (WAV)")
    parser.add_argument("--output-dir", "-o", default=None,
                        help="export root (default: output.directory config); "
                             "one subdirectory per track")
    parser.add_argument("--mode", choices=list(KNOWN_MODES), default=None)
    parser.add_argument("--device", default=None)
    parser.add_argument("--workers", type=int, default=1,
                        help="host worker threads for the per-track "
                             "detection/cutting stage")
    parser.add_argument("--json", action="store_true",
                        help="print one summary JSON line per track")
    parser.add_argument("--verbose", "-v", action="store_true")
    return parser


def resolve_effective_mode(args: argparse.Namespace) -> str:
    if args.mode:
        return args.mode
    if args.segments is not None or args.align is not None:
        return "vpbd_asr"
    return "v2.2_mdd"


def _parse_segments(value: Optional[str]):
    if value is None:
        return None
    v = value.strip().lower()
    if v in ("few", "medium", "many"):
        return v
    if "-" in v:
        lo, hi = v.split("-", 1)
        return [float(lo), float(hi)]
    raise SystemExit(f"--segments must be few|medium|many or MIN-MAX, got {value!r}")


def build_runtime_overrides(args: argparse.Namespace) -> Dict[str, Any]:
    overrides: Dict[str, Any] = {}
    if args.profile:
        overrides["smart_cut.profile"] = args.profile
    if args.lyrics_provider:
        overrides["lyrics_alignment.provider"] = args.lyrics_provider
        overrides["lyrics_alignment.enabled"] = args.lyrics_provider != "disabled"
    if args.lyrics_fixture:
        overrides["lyrics_alignment.fixture_path"] = args.lyrics_fixture
    if args.sidecar_endpoint:
        overrides["fire_red.endpoint"] = args.sidecar_endpoint
    if args.asr_chunk_s is not None:
        overrides["lyrics_alignment.chunk_s"] = args.asr_chunk_s
    if args.asr_overlap_s is not None:
        overrides["lyrics_alignment.overlap_s"] = args.asr_overlap_s
    if args.asr_strict:
        overrides["lyrics_alignment.strict"] = True
    if args.compat_config:
        if not args.compat_config_path:
            raise SystemExit("--compat-config requires --compat-config-path")
        from audio_cut_tpu_torch.config.derive import build_runtime_override_map
        from audio_cut_tpu_torch.config.migrate import migrate_v2_config
        from audio_cut_tpu_torch.config.yaml_subset import load_file

        legacy = load_file(args.compat_config_path) or {}
        schema, report = migrate_v2_config(legacy)
        overrides.update(build_runtime_override_map(schema))
        logger.info("migrated v2 config: %d keys mapped", len(report["mapped"]))
    return overrides


def _configure_logging(verbose: bool) -> None:
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
    )


def _batch_main(argv) -> int:
    """``batch``: N tracks with ONE separation pass.

    The separation of the whole list runs over every CUDA device
    (``parallel/mesh.make_mesh``; the CPU for ``--device cpu``); detection,
    cutting and export then run per track on ``--workers`` host threads.
    Output: export_dir/<input stem>/ per track, each with its own
    SegmentManifest.json. The cuts equal those of single runs."""
    args = build_batch_parser().parse_args(argv)
    _configure_logging(args.verbose)

    from audio_cut_tpu_torch.api import separate_and_segment_batch
    from audio_cut_tpu_torch.config import get_config

    out_dir = args.output_dir or str(get_config("output.directory", "./output"))
    manifests = separate_and_segment_batch(
        input_uris=list(args.input_files),
        export_dir=out_dir,
        mode=args.mode,
        device=args.device,
        workers=args.workers,
    )
    n_ok = 0
    for path, manifest in zip(args.input_files, manifests):
        ok = bool(manifest.get("success"))
        n_ok += ok
        if args.json:
            print(json.dumps({
                "input": path, "success": ok,
                "segments": (manifest.get("stats") or {}).get("num_segments"),
                "manifest": manifest.get("manifest_path"),
                "error": manifest.get("error"),
            }, ensure_ascii=False))
        else:
            stats = manifest.get("stats") or {}
            print(f"{path}: success={ok} segments={stats.get('num_segments')} "
                  f"-> {manifest.get('manifest_path') or manifest.get('error')}")
    print(f"batch: {n_ok}/{len(manifests)} tracks succeeded")
    return 0 if n_ok == len(manifests) else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "batch":
        return _batch_main(argv[1:])
    if argv and argv[0] == "warmup":
        from audio_cut_tpu_torch.warmup import warmup_main

        return warmup_main(argv[1:])
    args = build_parser().parse_args(argv)
    _configure_logging(args.verbose)

    from audio_cut_tpu_torch.api import separate_and_segment
    from audio_cut_tpu_torch.config import get_config

    out_dir = args.output_dir or str(get_config("output.directory", "./output"))
    try:
        manifest = separate_and_segment(
            input_uri=args.input_file,
            export_dir=out_dir,
            mode=args.mode,
            segments=_parse_segments(args.segments),
            alignment=args.align,
            device=args.device,
            strict_gpu=args.strict_device or None,
            export_manifest=args.manifest,
            runtime_overrides=build_runtime_overrides(args) or None,
        )
    except FileNotFoundError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    if args.validate_reconstruction and manifest.get("segments"):
        ok = _validate_reconstruction(args.input_file, out_dir, manifest)
        manifest["reconstruction_ok"] = ok
        print(f"reconstruction: {'OK' if ok else 'MISMATCH'}")
        if not ok:
            return 3

    if args.json:
        print(json.dumps(manifest, ensure_ascii=False, indent=2))
    else:
        stats = manifest.get("stats", {})
        qa = manifest.get("qa_report", {})
        print(f"mode={manifest.get('version')} success={manifest.get('success')} "
              f"segments={stats.get('num_segments')} "
              f"median_s={qa.get('median_segment_s')} "
              f"output={manifest['artifacts'].get('output_dir')}")
    return 0 if manifest.get("success") else 1


def _validate_reconstruction(input_file: str, out_dir: str, manifest: Dict[str, Any]) -> bool:
    """The exported mix segments, concatenated, equal the input's PCM-24
    encoding within one 24-bit step."""
    import numpy as np

    from audio_cut_tpu_torch.config import get_config
    from audio_cut_tpu_torch.io import load_audio, read_wav

    sr = int(get_config("audio.sample_rate", 44100))
    audio, _ = load_audio(input_file, target_sr=sr, mono=True)
    pieces = []
    for seg in manifest.get("segments", []):
        path = seg.get("mix_path")
        if not path:
            return False
        data, _ = read_wav(Path(out_dir) / path)
        pieces.append(data)
    if not pieces:
        return False
    recon = np.concatenate(pieces)
    if recon.size != audio.size:
        return False
    q = np.round(np.clip(audio, -1, 1).astype(np.float64) * 8388607.0) / 8388607.0
    return bool(np.max(np.abs(recon.astype(np.float64) - q)) <= 1.0 / 8388607.0)


if __name__ == "__main__":
    raise SystemExit(main())
