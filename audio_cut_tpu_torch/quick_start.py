"""Interactive quick start: ``python -m audio_cut_tpu_torch.quick_start [input_dir]``.

Counterpart of ``audio_cut_tpu/quick_start.py``: pick a file from the input
directory (or ``all`` for every file), answer three questions (split or only
separate stems, segment density, cut alignment), and run
``separate_and_segment`` once per file into ``<output dir>/<file stem>/``.
Exit codes: 2 when the directory holds no audio file, 1 when a file failed,
else 0.

Like every entry point of the port, it runs on CUDA unless the config asks
for the CPU (``gpu_pipeline.prefer_device: cpu``); where there is no CUDA
device it raises before the first question.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Optional

from audio_cut_tpu_torch.api import separate_and_segment
from audio_cut_tpu_torch.config import get_config
from audio_cut_tpu_torch.utils.device import resolve_device

_AUDIO_EXTS = {".wav", ".wave"}
# compressed inputs decode through ffmpeg (io/audio.py); offered only when
# ffmpeg is on PATH
_COMPRESSED_EXTS = {".mp3", ".flac", ".m4a", ".ogg"}


def find_audio_files(input_dir: str = "input") -> List[Path]:
    from audio_cut_tpu_torch.io.audio import ffmpeg_available

    exts = set(_AUDIO_EXTS)
    if ffmpeg_available():
        exts |= _COMPRESSED_EXTS
    root = Path(input_dir)
    if not root.exists():
        return []
    return sorted(p for p in root.rglob("*") if p.suffix.lower() in exts)


def _ask(prompt: str, choices: List[str], default: str) -> str:
    opts = "/".join(c.upper() if c == default else c for c in choices)
    while True:
        raw = input(f"{prompt} [{opts}]: ").strip().lower()
        if not raw:
            return default
        if raw in choices:
            return raw
        print(f"  please answer one of: {', '.join(choices)}")


def run_interactive(input_dir: str = "input", output_dir: Optional[str] = None) -> int:
    files = find_audio_files(input_dir)
    if not files:
        print(f"no audio files found under {input_dir!r} "
              "(WAV natively; mp3/flac/m4a/ogg with ffmpeg on PATH)")
        return 2
    # no CUDA device and no explicit cpu: raise before asking anything
    resolve_device(get_config("gpu_pipeline.prefer_device", "cuda"))

    print("available files:")
    for i, p in enumerate(files, 1):
        print(f"  {i}. {p}")
    while True:
        raw = input(f"pick a file (1-{len(files)}, or 'all' for batch): ").strip().lower()
        if raw == "all":
            selected = files
            break
        try:
            selected = [files[int(raw) - 1]]
            break
        except (ValueError, IndexError):
            print("  invalid selection")

    action = _ask("1/3 split into segments, or only separate stems?", ["split", "separate"], "split")
    if action == "separate":
        mode, segments, alignment = "vocal_separation", None, None
    else:
        mode = None
        segments = _ask("2/3 segment density?", ["few", "medium", "many"], "medium")
        alignment = _ask(
            "3/3 cut alignment?", ["lyric", "lyric_lean", "balanced", "beat_lean", "beat"], "balanced"
        )

    out_root = Path(output_dir or str(get_config("output.directory", "./output")))
    failures = 0
    for path in selected:
        dest = out_root / path.stem
        print(f"\nprocessing {path} -> {dest}")
        try:
            manifest = separate_and_segment(
                input_uri=str(path),
                export_dir=str(dest),
                mode=mode,
                segments=segments,
                alignment=alignment,
                export_manifest=True,
            )
        except Exception as exc:  # noqa: BLE001 - the interactive surface reports and goes on
            print(f"  FAILED: {exc}")
            failures += 1
            continue
        stats = manifest.get("stats", {})
        print(f"  done: {stats.get('num_segments', 0)} segments, "
              f"success={manifest.get('success')}")
    return 1 if failures else 0


def main() -> int:
    input_dir = sys.argv[1] if len(sys.argv) > 1 else "input"
    return run_interactive(input_dir)


if __name__ == "__main__":
    raise SystemExit(main())
