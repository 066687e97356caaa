#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (audio_cut_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. builds every CUDA kernel of the port from ``audio_cut_tpu_torch/csrc`` with
   nvcc, one process per source, all started together, and prints each
   build's time;
3. holds kernel K1 (windowed overlap-add, ``csrc/ola.cu``) against its plain
   PyTorch version at atol 1e-5, at both shapes the main path gives it and two
   others, and times it at the serving shape beside its plain version,
   ``F.fold`` and its bound;
4. holds kernel K2 (spectral flatness and onset, ``csrc/frame_stats.cu``)
   against its plain version at rtol 2e-4 / atol 2e-5, at the feature grids of
   a 60 s and a 3-minute song and two edge shapes, and times it at the 60 s
   shape beside its plain version and its bound. Device times come from a
   CUDA graph replay; the wrapper's time per call from Python is printed apart;
5. drives the main path: ``separate_and_segment()`` with no mode (v2.2_mdd)
   and no device, with the packaged ConvTDF-large and ConvVAD, on a
   synthesized 60 s song, cold then warm. Each call must succeed, give >= 2
   segments labelled human or music that splice back to the PCM-24 encoding
   of the input exactly, and launch K1 3 times and K2 once;
6. computes the detection bundle from the warm call's stems on the card and
   on the CPU (plain versions, float32) and holds every output of the card to
   the CPU's within the bounds of ``BUNDLE_TOL``, K2 on the main path's own
   spectrogram at its kernel bound, and the VAD segments equal; prints the
   cut lists the host tail makes from each bundle;
7. runs the first slice's path, ``mode="vocal_separation"``, once, and one
   model window through the separator on the card (bfloat16, K1) and on the
   CPU (float32, plain versions) at SNR >= 30 dB;
8. profiles one more warm v2.2_mdd call (``torch.profiler``): wall time, the
   spans of the pass (load, separation, detection bundle, host tail,
   export), the card's busy time, the kernels that take it and K1's and K2's
   device time per launch;
9. prints a ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.

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
KERNEL_SOURCES = ("ola", "frame_stats")
OLA_ATOL = 1e-5
PARITY_SNR_DB = 30.0
# (batch or None, n_frames, frame_len, hop): the serving shape first, then the
# last group of a 60 s track (11 windows in groups of 4, 4, 3), then two others
OLA_SHAPES = [(4, 256, 6144, 1024), (3, 256, 6144, 1024), (None, 21, 512, 128), (3, 13, 256, 64)]
# (frames, bins): the feature grid of a 60 s song first (n_fft 2048, hop 2205),
# then of a 3-minute song, the JAX package's edge shape and a single frame
K2_SHAPES = [(1201, 1025), (3601, 1025), (257, 129), (1, 1025)]
K2_RTOL, K2_ATOL = 2e-4, 2e-5
# the card's bundle against the CPU's, (rtol, atol) per output:
# * RMS envelopes: sums of squares scanned in other orders, rtol 1e-5;
# * flatness: K2's bound; onset: K2's rtol with atol 1e-4, because cuFFT and
#   the CPU's FFT round differently and log1p(1000 |X|) magnifies that up to
#   1000-fold in near-silent bins; the MDD series, which normalises both,
#   atol 1e-4;
# * dB grids: atol 1e-3 dB;
# * VAD probabilities: atol 1e-4 (float32 matmuls on both sides, no TF32);
# * tempo: 1e-4 relative; its strength atol 1e-4; the vocal energy rtol 1e-5.
BUNDLE_TOL = {
    "rms": (1e-5, 1e-7), "vocal_rms_grid": (1e-5, 1e-7), "vocal_rms_fine": (1e-5, 1e-7),
    "act_rms": (1e-5, 1e-7),
    "flatness": (K2_RTOL, K2_ATOL), "onset": (K2_RTOL, 1e-4), "mdd": (0.0, 1e-4),
    "vocal_db_guard": (0.0, 1e-3), "mix_db_guard": (0.0, 1e-3),
    "mix_db_refine": (0.0, 1e-3), "vocal_db_fine": (0.0, 1e-3),
    "vad_probs": (0.0, 1e-4),
    "bpm": (1e-4, 0.0), "period_frames": (1e-4, 0.0), "phase_frames": (1e-4, 0.0),
    "tempo_strength": (0.0, 1e-4), "vocal_energy": (1e-5, 0.0),
}
SPANS = ("load", "separation", "detection_bundle", "host_tail", "export")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOPS = 67e12          # float32 outside the tensor cores, the same sheet


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


def build_kernels():
    """Build every csrc/*.cu with nvcc, one process per source, all started
    together; print each build's time."""
    from concurrent.futures import ThreadPoolExecutor

    from audio_cut_tpu_torch.ops.cuda import build_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNEL_SOURCES)) as pool:
        secs = list(pool.map(build_library, KERNEL_SOURCES))
    for name, sec in zip(KERNEL_SOURCES, secs):
        print(f"kernel build: {name}.cu {sec:.3f} s (nvcc, sm_90a)")
    print(f"kernel build: all {len(secs)} in parallel, {time.perf_counter() - t0:.3f} s wall")


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


def _k2_inputs(t: int, f: int, seed: int):
    import numpy as np

    mag = np.abs(np.random.default_rng(seed).standard_normal((t, f))).astype(np.float32)
    mag[t // 2] = 0.0  # a silent frame
    return mag


def check_k2(torch, dev):
    """K2 against its plain version at K2_SHAPES; device times at the 60 s shape."""
    from audio_cut_tpu_torch.ops.frame_stats import spectral_stats_cuda, spectral_stats_reference

    max_err = 0.0
    for t, f in K2_SHAPES:
        mag = torch.from_numpy(_k2_inputs(t, f, seed=t)).to(dev)
        got = spectral_stats_cuda(mag)
        want = spectral_stats_reference(mag)
        torch.cuda.synchronize()
        for name, g, w in zip(("flatness", "onset"), got, want):
            err = float((g - w).abs().max())
            bad = float(((g - w).abs() - (K2_ATOL + K2_RTOL * w.abs())).max())
            print(f"K2 ({t}, {f}) {name}: max |kernel - plain| = {err:.3e} "
                  f"(rtol {K2_RTOL}, atol {K2_ATOL})")
            if g.shape != (t,) or bad > 0:
                fail(f"K2 disagrees with its plain version at ({t}, {f}) in {name}: {err}")
            max_err = max(max_err, err)
        if float(got[1][0]) != 0.0:
            fail("K2 onset of frame 0 is not 0")

    t, f = K2_SHAPES[0]
    # rotate over 12 inputs (12 x 4.9 MB > the 50 MB L2): each launch reads
    # its spectrogram from device memory
    sets = [torch.from_numpy(_k2_inputs(t, f, seed=100 + k)).to(dev) for k in range(12)]
    it = {"k": 0}

    def nxt():
        it["k"] = (it["k"] + 1) % len(sets)
        return sets[it["k"]]

    moved = (t * f + 2 * t) * 4
    # per bin: 2 products, 2 adds, log, 2 log1p, a subtract, a max, 2 adds
    ops = 11 * t * f
    bound = max(moved / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
    timing = {
        "ms": device_ms(lambda: spectral_stats_cuda(nxt())),
        "plain_ms": device_ms(lambda: spectral_stats_reference(nxt())),
        "library_ms": None,  # no single PyTorch call computes flatness and onset
        "bound_ms": bound,
        "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops / F32_FLOPS else "operations",
    }
    wrapper_ms = call_ms(lambda: spectral_stats_cuda(nxt()))
    print(f"K2 main-path shape ({t}, {f}), device time per call (CUDA graph replay of 100 calls, "
          f"median of 5): kernel {timing['ms']:.4f} ms, plain {timing['plain_ms']:.4f} ms; bound "
          f"{bound:.4f} ms ({moved} bytes at {HBM_BYTES_PER_S:.3e} B/s; {ops} operations at "
          f"{F32_FLOPS:.3e}/s; bound by {timing['bound_by']}); no library call")
    print(f"K2 main-path shape: wrapper called from Python 100 times in a row, "
          f"{wrapper_ms:.4f} ms per call (CUDA events; includes the host's launch rate)")
    return max_err, timing


class _Capture:
    """Wraps the port's separate_and_detect_fused to keep the last call's
    device stems; the main path still runs the function itself."""

    def __init__(self, fused):
        self.fused = fused
        self.inner = fused.separate_and_detect_fused
        self.last = None

    def __enter__(self):
        def wrapper(*args, **kwargs):
            sep, bundle = self.inner(*args, **kwargs)
            self.last = (sep, bundle)
            return sep, bundle

        self.fused.separate_and_detect_fused = wrapper
        return self

    def __exit__(self, *exc):
        self.fused.separate_and_detect_fused = self.inner


def check_segments(m, out: Path, audio) -> None:
    """success, >= 2 segments labelled human/music, and the exported mix
    segments splice back to the PCM-24 encoding of the input exactly."""
    import numpy as np

    from audio_cut_tpu_torch.io import read_wav
    from audio_cut_tpu_torch.io.wavio import decode_pcm24, encode_pcm24

    if not m["success"]:
        fail(f"separate_and_segment reported failure: {m}")
    labels = [s["label"] for s in m["segments"]]
    if len(labels) < 2 or not set(labels) <= {"human", "music"}:
        fail(f"segments {labels}: expected >= 2 labelled human or music")
    parts = [read_wav(out / s["mix_path"])[0] for s in m["segments"]]
    spliced = np.concatenate(parts)
    if not np.array_equal(spliced, decode_pcm24(encode_pcm24(audio))):
        fail("the exported segments do not splice back to the input's PCM-24 encoding")


def run_mdd(torch, dev, work: Path, audio):
    """The main path: separate_and_segment() with no mode and no device, cold
    then warm. Returns (K1 and K2 launches, the warm call's stems, manifest)."""
    from audio_cut_tpu_torch import separate_and_segment
    from audio_cut_tpu_torch.ops.frame_stats import K2
    from audio_cut_tpu_torch.ops.ola import K1
    from audio_cut_tpu_torch.separation import fused

    song = work / "song.wav"
    torch.cuda.reset_peak_memory_stats(dev)
    K1.launches = K2.launches = 0  # the main path starts: only its launches count
    with _Capture(fused) as cap:
        for call in range(CALLS):
            k1, k2 = K1.launches, K2.launches
            t0 = time.perf_counter()
            m = separate_and_segment(input_uri=str(song), export_dir=str(work / f"mdd{call}"))
            wall = time.perf_counter() - t0
            k1, k2 = K1.launches - k1, K2.launches - k2
            label = "cold" if call == 0 else "warm"
            print(f"v2.2_mdd call {call} ({label}): {wall:.3f} s wall, {SONG_S / wall:.2f} audio-s "
                  f"per wall-s, fused pass {m['gpu']['gpu_pipeline_compute_ms']:.1f} ms, "
                  f"K1 launches {k1}, K2 launches {k2}")
            if m["gpu"]["gpu_pipeline_device"] != "cuda":
                fail(f"gpu_pipeline_device is {m['gpu']['gpu_pipeline_device']!r}")
            if k1 != 3 or k2 != 1:
                fail(f"K1 launched {k1} times and K2 {k2} times; expected 3 and 1 per call")
            check_segments(m, work / f"mdd{call}", audio)
            labels = [s["label"] for s in m["segments"]]
            print(f"v2.2_mdd call {call}: {len(labels)} segments {labels}, cuts (samples) "
                  f"{m['cuts']['samples']}, spliced back exactly; confidence "
                  f"{m['separation']['confidence']:.4f}, guard {m['guard']['shift_stats']}")
    launches = {"K1": K1.launches, "K2": K2.launches}
    print(f"v2.2_mdd: torch.cuda.max_memory_allocated = {torch.cuda.max_memory_allocated(dev)} bytes")
    return launches, cap.last, m


def bundle_parity(torch, dev, warm, audio):
    """The detection half on the card against the CPU (plain versions, f32),
    from the warm call's stems; then both cut lists from the host tail."""
    import numpy as np

    from audio_cut_tpu_torch.analysis import bundle as TB
    from audio_cut_tpu_torch.config import get_config
    from audio_cut_tpu_torch.models.vad import build_vad
    from audio_cut_tpu_torch.ops.frame_stats import spectral_stats, spectral_stats_reference
    from audio_cut_tpu_torch.ops.stft import stft
    from audio_cut_tpu_torch.pipeline.modes.pure_vocal import _plan_cuts

    sep, _ = warm
    n = audio.size
    statics = TB.bundle_statics(SR)
    vads = {"card": build_vad(SR, dev), "cpu": build_vad(SR, "cpu")}
    outs, bundles = {}, {}
    with torch.inference_mode():
        mix_dev = sep.mix_device
        vocal_dev = torch.nn.functional.pad(sep.vocal_device, (0, mix_dev.shape[-1] - n))
        mix_cpu, vocal_cpu = mix_dev.cpu(), vocal_dev.cpu()
        for side, (mix, vocal) in (("card", (mix_dev, vocal_dev)), ("cpu", (mix_cpu, vocal_cpu))):
            out = TB._bundle_fn(mix, vocal, vads[side].net, SR, *statics)
            flat, shapes = TB.flatten_bundle(out)
            outs[side] = {k: v.cpu().numpy() for k, v in out.items()}
            bundles[side] = TB.unpack_bundle(flat.cpu().numpy(), shapes, SR, n, statics, vads[side])
        # K2 in place: the card's own magnitude spectrogram of the mix, K2
        # against its plain version on the CPU
        mag = torch.abs(stft(mix_dev, n_fft=2048, hop=statics[0])).contiguous()
        k2 = [x.cpu() for x in spectral_stats(mag)]
        plain = spectral_stats_reference(mag.cpu())
    for name, g, w in zip(("flatness", "onset"), k2, plain):
        err = float((g - w).abs().max())
        print(f"bundle: K2 on the main path's spectrogram {tuple(mag.shape)}, {name}: max |card - "
              f"CPU plain| = {err:.3e} (rtol {K2_RTOL}, atol {K2_ATOL})")
        if not torch.allclose(g, w, rtol=K2_RTOL, atol=K2_ATOL):
            fail(f"K2 on the main path's spectrogram disagrees in {name}")
    for key in sorted(BUNDLE_TOL):
        g, w = outs["card"][key], outs["cpu"][key]
        rtol, atol = BUNDLE_TOL[key]
        err = float(np.abs(g.astype(np.float64) - w).max())
        ok = g.shape == w.shape and np.allclose(g, w, rtol=rtol, atol=atol)
        print(f"bundle: {key} {g.shape}: max |card - CPU| = {err:.3e} (rtol {rtol}, atol {atol})")
        if not ok:
            fail(f"the card's bundle disagrees with the CPU's in {key}: {err}")
    seg = {side: vads[side].detect(b.vad_probs, n_true=n).segments for side, b in bundles.items()}
    print(f"bundle: VAD segments, card {len(seg['card'])}, CPU {len(seg['cpu'])}, equal "
          f"{seg['card'] == seg['cpu']}")
    if seg["card"] != seg["cpu"]:
        fail("the card's VAD segments differ from the CPU's")
    qc = get_config("v2_mdd.quality_control", {}) or {}
    cuts = {}
    for side, b in bundles.items():
        plan = _plan_cuts(audio, SR, b, vads[side], vads[side], qc,
                          qc.get("enforce_quiet_cut", {}) or {},
                          qc.get("local_boundary_refine", {}) or {})
        cuts[side] = plan["cut_samples"]
        print(f"bundle: host tail fed the {side} bundle: cuts {plan['cut_samples']}, "
              f"labels {['human' if f else 'music' for f in plan['flags']]}")
    print(f"bundle: the two cut lists are equal: {cuts['card'] == cuts['cpu']}")


def run_separation(torch, dev, work: Path, audio):
    """The first slice's path, once: mode="vocal_separation" on the card."""
    import numpy as np

    from audio_cut_tpu_torch import separate_and_segment
    from audio_cut_tpu_torch.io import read_wav, wav_info
    from audio_cut_tpu_torch.ops.ola import K1

    K1.launches = 0  # this path starts: only its launches count
    t0 = time.perf_counter()
    m = separate_and_segment(input_uri=str(work / "song.wav"), export_dir=str(work / "sep"),
                             mode="vocal_separation")
    wall = time.perf_counter() - t0
    print(f"vocal_separation call (warm): {wall:.3f} s wall, {SONG_S / wall:.2f} audio-s per "
          f"wall-s, K1 launches {K1.launches}")
    if not m["success"] or m["gpu"]["gpu_pipeline_device"] != "cuda":
        fail(f"vocal_separation failed or ran off the card: {m}")
    if K1.launches != 3:
        fail(f"K1 launched {K1.launches} times; expected one per window group (3)")
    stems = []
    for key in ("vocal_full", "instrumental_full"):
        info = wav_info(work / "sep" / m["artifacts"][key])
        x, sr = read_wav(work / "sep" / m["artifacts"][key])
        if info.bits_per_sample != 24 or sr != SR or x.shape != audio.shape:
            fail(f"{key}: {info} shape {x.shape}, expected 24-bit {audio.shape}")
        if not np.isfinite(x).all():
            fail(f"{key} is not finite")
        stems.append(x)
    err = float(np.abs(stems[0].astype(np.float64) + stems[1] - audio).max())
    if err > 2.5 / 8388607.0:
        fail(f"vocal + instrumental differs from the mix by {err}")
    print(f"vocal_separation: stems 24-bit x {audio.size} samples, finite, "
          f"|vocal + instrumental - mix| <= {err:.3e}")

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


def _print_top(prefix: str, kernels, count: int) -> None:
    by_name = {}
    for e in kernels:
        ms, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, k + 1)
    for name, (ms, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:count]:
        print(f"profile:   {prefix}{ms:8.3f} ms  {k:4d}x  {name[:110]}")


def profile_call(torch, work: Path):
    """One more warm v2.2_mdd call under torch.profiler: where its time goes."""
    from torch.profiler import ProfilerActivity, profile

    from audio_cut_tpu_torch import separate_and_segment

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = separate_and_segment(input_uri=str(work / "song.wav"), export_dir=str(work / "prof"))
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not m["success"]:
        fail("profiled call failed")
    events = prof.events()
    spans = {}
    for e in events:
        if e.name in SPANS and e.device_type == torch.autograd.DeviceType.CPU:
            spans[e.name] = spans.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    print(f"profile (warm v2.2_mdd call under torch.profiler): wall {wall_ms:.1f} ms; spans (ms): "
          + ", ".join(f"{k} {spans.get(k, float('nan')):.1f}" for k in SPANS)
          + f"; fused pass (gpu_pipeline_compute_ms) {m['gpu']['gpu_pipeline_compute_ms']:.1f}")
    on_card = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    # the spans also show on the card's timeline, as the range their kernels cover
    ranges = {e.name: (e.time_range.start, e.time_range.end) for e in on_card if e.name in SPANS}
    kernels = [e for e in on_card if e.name not in SPANS]
    if not kernels:
        print("profile: device busy time not measured (the profiler recorded no kernels)")
        return
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    print(f"profile: card busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall "
          f"(idle share {1 - busy_ms / wall_ms:.3f}), {len(kernels)} kernel launches")
    _print_top("", kernels, 12)
    for span, (a, b) in sorted(ranges.items(), key=lambda kv: kv[1]):
        inside = [e for e in kernels if a <= e.time_range.start and e.time_range.end <= b]
        busy = _union_us([(e.time_range.start, e.time_range.end) for e in inside]) / 1e3
        print(f"profile: span {span} on the card: {(b - a) / 1e3:.1f} ms from its first kernel "
              f"to its last, {busy:.1f} ms busy, {len(inside)} kernel launches")
        _print_top(f"{span}: ", inside, 6)
    for label, key in (("K1 windowed_ola_kernel", "windowed_ola_kernel"),
                       ("K2 spectral_stats_kernel", "spectral_stats_kernel")):
        per = [(e.time_range.end - e.time_range.start) / 1e3 for e in kernels if key in e.name]
        print(f"profile: {label} on the main path, device time per launch (ms): "
              f"{', '.join(f'{ms:.4f}' for ms in per)}")


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

    build_kernels()
    k1_err, k1_timing = check_k1(torch, dev)
    k2_err, k2_timing = check_k2(torch, dev)

    from audio_cut_tpu_torch.io import write_wav

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        audio = make_song(SONG_S)
        write_wav(work / "song.wav", audio, SR, subtype="FLOAT")
        launches, warm, _ = run_mdd(torch, dev, work, audio)
        bundle_parity(torch, dev, warm, audio)
        del warm
        run_separation(torch, dev, work, audio)
        one_window_parity(torch, dev, audio)
        profile_call(torch, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [{
        "name": "K1 windowed_ola",
        "route": "cuda",
        "source": "audio_cut_tpu_torch/csrc/ola.cu",
        "replaces": "audio_cut_tpu/ops/pallas/ola.py:63",
        "launches": launches["K1"],
        "max_abs_err": k1_err,
        "ms": k1_timing["ms"],
        "plain_ms": k1_timing["plain_ms"],
        "bound_ms": k1_timing["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k1_timing["library_ms"],
    }, {
        "name": "K2 spectral_stats",
        "route": "cuda",
        "source": "audio_cut_tpu_torch/csrc/frame_stats.cu",
        "replaces": "audio_cut_tpu/ops/pallas/frame_stats.py:57",
        "launches": launches["K2"],
        "max_abs_err": k2_err,
        "ms": k2_timing["ms"],
        "plain_ms": k2_timing["plain_ms"],
        "bound_ms": k2_timing["bound_ms"],
        "bound_by": k2_timing["bound_by"],
        "library_ms": k2_timing["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
