#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (audio_cut_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. builds every CUDA kernel of the port from ``audio_cut_tpu_torch/csrc`` with
   nvcc, one process per source, all started together;
3. holds kernel K1 (windowed overlap-add, ``csrc/ola.cu``) against its plain
   PyTorch version on the card at atol 1e-5, at both shapes the main path
   gives it and two others, and times it at the serving shape beside its
   plain version, ``F.fold`` and its bound: device time from a CUDA graph
   replay, and apart from it the wrapper's time per call from Python;
4. drives the main path: ``separate_and_segment(mode="vocal_separation")``
   with the packaged ConvTDF-large checkpoint on a synthesized 60 s song,
   twice (cold, warm), and checks the stems and that every call went through
   K1 (3 launches per call: 11 model windows in groups of 4);
5. runs one model window through the port's separator on the card (bfloat16,
   K1) and on the CPU (float32, plain versions) and requires SNR >= 30 dB;
6. profiles one more warm call (``torch.profiler``): wall time, the engine's
   fenced time, the card's busy time, the kernels that take it and K1's
   device time per launch on the main path;
7. prints a ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.

Every phase that fails raises, so the script exits non-zero and prints no
result. It needs no network and writes only under ``build/`` in the checkout.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SR = 44100
SONG_S = 60.0
CALLS = 2
OLA_ATOL = 1e-5
PARITY_SNR_DB = 30.0
# (batch or None, n_frames, frame_len, hop): the serving shape first, then the
# last group of a 60 s track (11 windows in groups of 4, 4, 3), then two others
OLA_SHAPES = [(4, 256, 6144, 1024), (3, 256, 6144, 1024), (None, 21, 512, 128), (3, 13, 256, 64)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_song(duration_s: float, sr: int = SR, seed: int = 7):
    """Synthetic song: harmonic vocal-like phrases over a percussive bed,
    with quiet gaps (the generator of the repository's tests)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(duration_s * sr)
    t = np.arange(n, dtype=np.float64) / sr
    audio = np.zeros(n, dtype=np.float64)
    for beat in np.arange(0.0, duration_s, 0.5):
        i = int(beat * sr)
        env = np.exp(-np.arange(min(2000, n - i)) / 300.0)
        audio[i:i + env.size] += 0.12 * env * rng.standard_normal(env.size)
    phrase = 0.0
    while phrase + 2.5 < duration_s:
        seg = (t >= phrase) & (t < phrase + 2.2)
        f0 = 220.0 * (1 + 0.01 * np.sin(2 * np.pi * 5.5 * t[seg]))
        x = np.zeros(seg.sum())
        for h in range(1, 5):
            x += np.sin(2 * np.pi * h * np.cumsum(f0) / sr) / h
        fade = np.minimum(1.0, np.minimum(np.arange(seg.sum()) / (0.05 * sr),
                                          (seg.sum() - np.arange(seg.sum())) / (0.05 * sr)))
        audio[seg] += 0.35 * x * fade
        phrase = phrase + 2.2 + 0.8 + 0.4 * rng.random()
    return (0.9 * audio / np.abs(audio).max()).astype(np.float32)


def _warm_up(fn, seconds: float) -> None:
    """Calls for ``seconds``, to bring the card's clocks up from idle."""
    import torch

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()


def _event_ms(run, repeats: int) -> float:
    """Median over ``repeats`` of the ms of one ``run()``, CUDA events around it."""
    import statistics

    import torch

    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, iters: int = 100, repeats: int = 5, warmup_s: float = 0.3) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one CUDA
    graph, the replay timed with CUDA events, median of ``repeats`` over
    ``iters``. The replay launches back to back, so no host work (Python,
    allocation, the launch call) sits between the kernels."""
    import torch

    _warm_up(fn, warmup_s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _event_ms(graph.replay, repeats) / iters


def call_ms(fn, iters: int = 100, repeats: int = 5, warmup_s: float = 0.3) -> float:
    """Time of one call of ``fn`` issued from Python, as a caller issues it:
    ``iters`` calls timed with CUDA events, median of ``repeats`` over ``iters``.
    Where the host takes longer per call than the card, this is the host's rate."""
    _warm_up(fn, warmup_s)

    def run():
        for _ in range(iters):
            fn()

    return _event_ms(run, repeats) / iters


def snr_db(ref, est) -> float:
    import numpy as np

    ref = np.asarray(ref, np.float64)
    return float(10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - est) ** 2), 1e-30)))


def check_k1(torch, dev):
    """K1 against its plain version at OLA_SHAPES; times at the serving shape."""
    import numpy as np
    import torch.nn.functional as F

    from audio_cut_tpu_torch.ops.ola import windowed_ola_cuda, windowed_ola_reference
    from audio_cut_tpu_torch.ops.stft import hann_window

    max_err = 0.0
    timing = None
    for batch, n, L, hop in OLA_SHAPES:
        shape = (n, L) if batch is None else (batch, n, L)
        frames = torch.from_numpy(
            np.random.default_rng(n + L).standard_normal(shape).astype(np.float32)).to(dev)
        window = hann_window(L, device=dev)
        got = windowed_ola_cuda(frames, window, hop)
        want = windowed_ola_reference(frames, window, hop)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"K1 {shape} hop {hop}: max |kernel - plain| = {err:.3e} (atol {OLA_ATOL})")
        if not (got.shape == want.shape and err <= OLA_ATOL):
            fail(f"K1 disagrees with its plain version at {shape} hop {hop}: {err}")
        max_err = max(max_err, err)
        if timing is None:  # the serving shape
            total = (n - 1) * hop + L
            # rotate over 4 input sets (4 x 25 MB > the 50 MB L2), so every
            # launch reads its frames from device memory as the serving path does
            sets = [torch.randn(shape, device=dev) for _ in range(4)]
            it = {"k": 0}

            def nxt():
                it["k"] = (it["k"] + 1) % len(sets)
                return sets[it["k"]]

            def fold():
                x = nxt() * window
                return F.fold(x.transpose(1, 2), output_size=(1, total),
                              kernel_size=(1, L), stride=(1, hop))

            lib = fold().reshape(batch, total)
            ref = windowed_ola_reference(sets[it["k"]], window, hop)
            lib_err = float((lib - ref).abs().max())
            print(f"K1 library yardstick F.fold(frames * window): max |fold - plain| = {lib_err:.3e}")
            moved = (frames.numel() + window.numel() + batch * total) * 4
            bound = moved / HBM_BYTES_PER_S * 1e3
            kernel = lambda: windowed_ola_cuda(nxt(), window, hop)  # noqa: E731
            plain = lambda: windowed_ola_reference(nxt(), window, hop)  # noqa: E731
            # device times (CUDA graph replay) for the kernels line; the
            # wrapper's time per Python call beside it, labelled apart
            timing = {
                "ms": device_ms(kernel),
                "plain_ms": device_ms(plain),
                "library_ms": device_ms(fold),
                "bound_ms": bound,
                "bytes": moved,
            }
            wrapper_ms = call_ms(kernel)
            print(f"K1 serving shape {shape} hop {hop}, device time per call (CUDA graph "
                  f"replay of 100 calls, median of 5): kernel {timing['ms']:.4f} ms, "
                  f"plain {timing['plain_ms']:.4f} ms, F.fold {timing['library_ms']:.4f} ms; "
                  f"bound {bound:.4f} ms ({moved} bytes at {HBM_BYTES_PER_S:.3e} B/s)")
            print(f"K1 serving shape: wrapper called from Python 100 times in a row, "
                  f"{wrapper_ms:.4f} ms per call (CUDA events; includes the host's launch rate)")
    return max_err, timing


def run_slice(torch, dev, work: Path):
    import numpy as np

    from audio_cut_tpu_torch import separate_and_segment
    from audio_cut_tpu_torch.io import read_wav, wav_info, write_wav
    from audio_cut_tpu_torch.ops.ola import K1

    audio = make_song(SONG_S)
    song = work / "song.wav"
    write_wav(song, audio, SR, subtype="FLOAT")
    torch.cuda.reset_peak_memory_stats(dev)
    K1.launches = 0  # main path starts: only its launches count from here
    for call in range(CALLS):
        before = K1.launches
        t0 = time.perf_counter()
        m = separate_and_segment(input_uri=str(song), export_dir=str(work / f"out{call}"),
                                 mode="vocal_separation", device="cuda")
        wall = time.perf_counter() - t0
        launches = K1.launches - before
        label = "cold" if call == 0 else "warm"
        print(f"slice call {call} ({label}): {wall:.3f} s wall, "
              f"{SONG_S / wall:.2f} audio-s per wall-s, K1 launches {launches}")
        if not m["success"]:
            fail(f"separate_and_segment reported failure: {m}")
        if m["gpu"]["gpu_pipeline_device"] != "cuda":
            fail(f"gpu_pipeline_device is {m['gpu']['gpu_pipeline_device']!r}")
        groups = -(-m["gpu"]["gpu_pipeline_chunks"] // 4)
        if launches != groups or launches != 3:
            fail(f"K1 launched {launches} times; expected one per window group (3)")
        out = work / f"out{call}"
        stems = []
        for key in ("vocal_full", "instrumental_full"):
            info = wav_info(out / m["artifacts"][key])
            x, sr = read_wav(out / m["artifacts"][key])
            if info.bits_per_sample != 24 or sr != SR or x.shape != audio.shape:
                fail(f"{key}: {info} shape {x.shape}, expected 24-bit {audio.shape}")
            if not np.isfinite(x).all():
                fail(f"{key} is not finite")
            stems.append(x)
        err = float(np.abs(stems[0].astype(np.float64) + stems[1] - audio).max())
        if err > 2.5 / 8388607.0:
            fail(f"vocal + instrumental differs from the mix by {err}")
        print(f"slice call {call}: stems 24-bit x {audio.size} samples, finite, "
              f"|vocal + instrumental - mix| <= {err:.3e}, confidence "
              f"{m['separation']['confidence']:.4f}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"slice: torch.cuda.max_memory_allocated = {peak} bytes")
    return audio, K1.launches


def one_window_parity(torch, dev, audio):
    """The port's separator on one window: card (bf16, K1) vs CPU (f32, plain)."""
    from audio_cut_tpu_torch.models.convtdf import ConvTDFSeparator
    from audio_cut_tpu_torch.separation.backends import make_backend

    backend = make_backend("convtdf", SR, dev)  # the one the slice used
    sep = backend.sep
    cpu = ConvTDFSeparator(SR, n_fft=sep.n_fft, hop=sep.hop, dim_f=sep.dim_f, dim_t=sep.dim_t,
                           channels=sep.net.first.conv1.out_channels, depth=sep.net.depth,
                           tdf_bottleneck=sep.net.first.tdf.fc1.out_features,
                           dtype=torch.float32)
    cpu.net.load_state_dict({k: v.cpu() for k, v in sep.net.state_dict().items()})
    w = sep.window_samples
    start = int(10.0 * SR)
    x = torch.from_numpy(audio[start:start + w].copy())[None]
    v_gpu, _ = sep.separate(x.to(dev), w)
    t0 = time.perf_counter()
    v_cpu, _ = cpu.separate(x, w)
    cpu_s = time.perf_counter() - t0
    snr = snr_db(v_cpu[0].numpy(), v_gpu[0].float().cpu().numpy())
    print(f"one-window parity ({w} samples): vocal SNR card bf16 vs CPU f32 = {snr:.2f} dB "
          f"(required >= {PARITY_SNR_DB}); CPU forward {cpu_s:.2f} s")
    if not snr >= PARITY_SNR_DB:
        fail(f"one-window parity {snr:.2f} dB < {PARITY_SNR_DB} dB")


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def profile_call(torch, work: Path):
    """One more warm call under torch.profiler: where its time goes."""
    from torch.profiler import ProfilerActivity, profile

    from audio_cut_tpu_torch import separate_and_segment

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = separate_and_segment(input_uri=str(work / "song.wav"), export_dir=str(work / "prof"),
                                 mode="vocal_separation", device="cuda")
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not m["success"]:
        fail("profiled call failed")
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    ola = [(e.time_range.end - e.time_range.start) / 1e3 for e in kernels
           if "windowed_ola_kernel" in e.name]
    engine_ms = m["gpu"]["gpu_pipeline_compute_ms"]
    print(f"profile (warm call under torch.profiler): wall {wall_ms:.1f} ms, engine "
          f"(upload + windows + OLA, fenced) {engine_ms:.1f} ms")
    if not kernels:
        print("profile: device busy time not measured (the profiler recorded no kernels)")
        return
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    print(f"profile: card busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall "
          f"(idle share {1 - busy_ms / wall_ms:.3f}), {len(kernels)} kernel launches")
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"profile:   {ms:8.3f} ms  {n:4d}x  {name[:110]}")
    if ola:
        print(f"profile: K1 windowed_ola_kernel on the main path, device time per launch (ms): "
              f"{', '.join(f'{ms:.4f}' for ms in ola)}")


def main() -> int:
    if not (ROOT / "audio_cut_tpu_torch").is_dir():
        print("chip_smoke: audio_cut_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(nvidia_smi_line())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {name}, count {torch.cuda.device_count()}")

    from audio_cut_tpu_torch.ops.cuda import build_library

    print(f"kernel build: ola.cu {build_library('ola'):.3f} s (nvcc, sm_90a)")

    max_err, timing = check_k1(torch, dev)

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        audio, launches = run_slice(torch, dev, work)
        one_window_parity(torch, dev, audio)
        profile_call(torch, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [{
        "name": "K1 windowed_ola",
        "route": "cuda",
        "source": "audio_cut_tpu_torch/csrc/ola.cu",
        "replaces": "audio_cut_tpu/ops/pallas/ola.py:63",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": "bytes",
        "library_ms": timing["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
