"""Cold-start warmup: ``python -m audio_cut_tpu_torch.cli warmup``.

Counterpart of ``audio_cut_tpu/warmup.py``, with the same flags, the same
steps and the same report, ``{"steps": [{name, ok, wall_s}], "total_s"}``:
``v2.2_mdd`` once per duration in ``--durations``, then ``vocal_separation``
and ``vpbd_asr`` (with the fake lyrics provider) on the longest, each on a
synthetic track.

What persists across processes, and what does not. The JAX package fills a
persistent XLA compilation cache. The port has no compiled program to keep:
what it leaves behind is the CUDA kernel libraries, built from
``csrc/*.cu`` into ``audio_cut_tpu_torch/_build/`` (``ops/cuda.py``), which
every later process loads without running nvcc. So when the device that
``gpu_pipeline.prefer_device`` resolves to is CUDA, warmup first builds every
library, in parallel, one step each with its build seconds (0.0 for a
library already built), then runs the kernel library check (K0) on that
device as a step of its own. PyTorch keeps no compiled program, cuDNN plan,
or caching-allocator pool across processes, and the port's layout caches
and loaded weights live in the process too; so a fresh process still pays
those on its first track, and the synthetic tracks' runs warm only the
process that runs them. On an explicit ``cpu`` there is no build step.

Like every entry point of the port, it runs on CUDA unless the config asks
for the CPU (``gpu_pipeline.prefer_device: cpu``, or
``VSS__gpu_pipeline__prefer_device=cpu``), and raises where there is no
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np


def _synth_song(duration_s: float, sr: int = 44100, seed: int = 11) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(duration_s * sr)
    t = np.arange(n) / sr
    audio = 0.02 * rng.standard_normal(n)
    ph = 0.5
    while ph + 3.0 < duration_s:
        seg = (t >= ph) & (t < ph + 2.2)
        f0 = 200.0 + 60.0 * np.sin(2 * np.pi * 0.3 * ph)
        x = np.zeros(int(seg.sum()))
        for h in range(1, 4):
            x += np.sin(2 * np.pi * h * f0 * t[seg]) / h
        audio[seg] += 0.4 * x
        ph += 3.2
    peak = float(np.abs(audio).max()) or 1.0
    return (0.85 * audio / peak).astype(np.float32)


def _fake_timeline(duration_s: float) -> Dict:
    words = [
        {"text": f"w{k}", "start_s": 0.8 + 0.8 * k, "end_s": 1.2 + 0.8 * k,
         "confidence": 0.9}
        for k in range(max(1, int((duration_s - 2.0) / 0.8)))
    ]
    return {
        "words": words,
        "sentences": [{"text": "s", "start_s": words[0]["start_s"],
                       "end_s": words[-1]["end_s"], "confidence": 0.9}],
        "vad_regions": [], "duration_s": duration_s, "language": "en",
    }


def build_kernel_steps(device) -> List[Dict]:
    """Build every ``csrc/*.cu`` library, all at once, then run the kernel
    library check on ``device``: one step per library with its build
    seconds, and one for the check. A failed build or check raises."""
    from concurrent.futures import ThreadPoolExecutor

    from audio_cut_tpu_torch.ops.cuda import CSRC, build_library, check_kernel_library

    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        secs = list(pool.map(build_library, names))
    steps = [{"name": f"build_{name}.cu", "ok": True, "wall_s": round(sec, 2)}
             for name, sec in zip(names, secs)]
    t0 = time.time()
    check_kernel_library(device)
    steps.append({"name": "kernel_library_check", "ok": True,
                  "wall_s": round(time.time() - t0, 2)})
    return steps


def run_warmup(durations: List[float], extra_modes: bool = True,
               export_dir: str | None = None) -> Dict:
    """Build the kernels (on CUDA) and run each production path once.

    Returns {"steps": [{name, ok, wall_s}], "total_s": float}."""
    from audio_cut_tpu_torch.api import separate_and_segment
    from audio_cut_tpu_torch.config import get_config, reset_runtime_config, set_runtime_config
    from audio_cut_tpu_torch.io import write_wav
    from audio_cut_tpu_torch.utils.device import resolve_device

    device = resolve_device(get_config("gpu_pipeline.prefer_device", "cuda"))
    t_all = time.time()
    steps = build_kernel_steps(device) if device.type == "cuda" else []
    with tempfile.TemporaryDirectory() as td:
        out_root = export_dir or td
        for d in sorted(set(durations)):
            song = os.path.join(td, f"warm_{int(d)}s.wav")
            write_wav(song, _synth_song(d), 44100)
            t0 = time.time()
            m = separate_and_segment(
                input_uri=song, mode="v2.2_mdd",
                export_dir=os.path.join(out_root, f"v22_{int(d)}"),
            )
            steps.append({"name": f"v2.2_mdd_{int(d)}s", "ok": bool(m.get("success")),
                          "wall_s": round(time.time() - t0, 2)})
        if extra_modes and durations:
            d = max(durations)
            song = os.path.join(td, f"warm_{int(d)}s.wav")
            t0 = time.time()
            m = separate_and_segment(
                input_uri=song, mode="vocal_separation",
                export_dir=os.path.join(out_root, "sep"),
            )
            steps.append({"name": "vocal_separation", "ok": bool(m.get("success")),
                          "wall_s": round(time.time() - t0, 2)})
            tl_path = os.path.join(td, "tl.json")
            with open(tl_path, "w") as f:
                json.dump(_fake_timeline(d), f)
            try:
                set_runtime_config({
                    "lyrics_alignment.enabled": True,
                    "lyrics_alignment.provider": "fake",
                    "lyrics_alignment.fixture_path": tl_path,
                })
                t0 = time.time()
                m = separate_and_segment(
                    input_uri=song, mode="vpbd_asr",
                    export_dir=os.path.join(out_root, "asr"),
                )
                steps.append({"name": "vpbd_asr", "ok": bool(m.get("success")),
                              "wall_s": round(time.time() - t0, 2)})
            finally:
                reset_runtime_config()
    return {"steps": steps, "total_s": round(time.time() - t_all, 2)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m audio_cut_tpu_torch.cli warmup",
        description="Build the port's CUDA kernels into audio_cut_tpu_torch/_build/, "
                    "so that later processes load them without nvcc, and run each "
                    "production path once on synthetic tracks.",
    )
    ap.add_argument("--durations", default="15,75,120,180,240",
                    help="comma-separated synthetic track lengths (s); the engine pads "
                         "tracks to 15 s buckets up to 75 s, then "
                         "device_pipeline.long_bucket_seconds (60 s) buckets. The "
                         "default runs short clips and every long bucket of the "
                         "1:16-4:00 production band")
    ap.add_argument("--fast", action="store_true",
                    help="one short bucket and the 3-min bucket (durations 15,180), "
                         "default mode only")
    ap.add_argument("--skip-extra-modes", action="store_true",
                    help="only the default v2.2_mdd path (skip vocal_separation's "
                         "stem pack and vpbd_asr's ASR copy)")
    ap.add_argument("--json", action="store_true", help="print a JSON report")
    return ap


def warmup_main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.fast:
        durations = [15.0, 180.0]
        report = run_warmup(durations, extra_modes=False)
    else:
        durations = [float(x) for x in str(args.durations).split(",") if x.strip()]
        report = run_warmup(durations, extra_modes=not args.skip_extra_modes)
    if args.json:
        print(json.dumps(report))
    else:
        for s in report["steps"]:
            print(f"  {s['name']:<22} {'ok' if s['ok'] else 'FAILED':<7} {s['wall_s']:8.1f} s")
        print(f"warmup complete in {report['total_s']:.1f} s; the built kernels stay in "
              "audio_cut_tpu_torch/_build/ for later processes")
    return 0 if all(s["ok"] for s in report["steps"]) else 1


if __name__ == "__main__":
    sys.exit(warmup_main())
