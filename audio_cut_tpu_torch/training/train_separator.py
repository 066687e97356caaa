"""Train a separator (the ConvTDF, or the WaveUNet) on (mix, vocal) pairs.

    python -m audio_cut_tpu_torch.training.train_separator --data-dir pairs/ \\
        --steps 1000 --checkpoint convtdf.msgpack
    python -m audio_cut_tpu_torch.training.train_separator --small --synthetic \\
        --steps 3 --device cpu                        # a few steps on the CPU
    python -m audio_cut_tpu_torch.training.train_separator --large --resume packaged \\
        --steps 20 --checkpoint tuned.msgpack         # fine-tune ConvTDF-large on the card
    python -m audio_cut_tpu_torch.training.train_separator --family waveunet --bootstrap \\
        --steps 1000 --checkpoint waveunet.msgpack    # the WaveUNet tier's weights

Counterpart of ``scripts/train_separator.py``. Data: a directory of paired
WAVs ``<name>_mix.wav`` / ``<name>_vocal.wav`` (equal length, 44.1 kHz mono),
``--synthetic`` for a run without data, or the synthetic stem generator
(``training/sep_data.py``) for ``--bootstrap``, ``--tiny`` and ``--large``.
It runs on CUDA unless ``--device cpu``; with no CUDA device and no
``--device cpu`` it raises.

``--family waveunet`` trains the waveform U-Net (``training/wave_trainer.py``)
at ``WAVEUNET_GEOMETRY`` (``--small``: ``WAVEUNET_SMALL_GEOMETRY``); the
WaveUNet is fully convolutional over time, so its checkpoint serves at the
config's ``window_samples`` and the sidecar pins only channels and depth.

Not in the port yet: ``--rich`` (raises ``NotImplementedError`` naming its
ROADMAP.md item). The JAX script's ``--probe-threshold-s`` timed a matmul
to detect a degraded TPU attach and has no counterpart on the card.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from audio_cut_tpu_torch.models import convtdf, waveunet
from audio_cut_tpu_torch.models.convtdf import ConvTDFSeparator
from audio_cut_tpu_torch.models.waveunet import WaveUNetSeparator
from audio_cut_tpu_torch.training.trainer import TrainConfig, Trainer
from audio_cut_tpu_torch.training.wave_trainer import WaveTrainer
from audio_cut_tpu_torch.utils.device import resolve_device

SR = 44100

# geometry of the packaged bootstrap checkpoint: the production spectral
# frame (n_fft 6144 / hop 1024 / dim_f 2048, what the OLA engine feeds) with
# a compact net; dim_t is a TRAINING window length only: the net is fully
# convolutional over T, so serving uses the config dim_t (default 256)
BOOTSTRAP_GEOMETRY = dict(
    n_fft=6144, hop=1024, dim_f=2048, dim_t=64,
    channels=16, depth=2, tdf_bottleneck=32,
)

# ConvTDF-large, the packaged convtdf_large_v1 checkpoint's geometry (about
# 5.1 M parameters): the production spectral frame at channels 32, depth 3,
# bottleneck 64. dim_t 128 doubles the bootstrap's training window so
# GroupNorm's (T, F) statistics at train time sit closer to the dim_t-256
# serving window.
LARGE_GEOMETRY = dict(
    n_fft=6144, hop=1024, dim_f=2048, dim_t=128,
    channels=32, depth=3, tdf_bottleneck=64,
)

# the tiny geometry of the packaged CPU-tier checkpoint. dim_t here is the
# training window; the sidecar records TINY_SERVING_DIM_T so serving uses a
# longer window.
TINY_GEOMETRY = dict(
    n_fft=1024, hop=256, dim_f=384, dim_t=64,
    channels=12, depth=2, tdf_bottleneck=24,
)
TINY_SERVING_DIM_T = 256

SMALL_GEOMETRY = dict(
    n_fft=512, hop=128, dim_f=128, dim_t=32,
    channels=8, depth=2, tdf_bottleneck=16,
)

# the WaveUNet's training window is shorter than its serving window (the
# config's window_samples, 262144): the net is fully convolutional over T;
# channels and depth are what the sidecar records
WAVEUNET_GEOMETRY = dict(window_samples=65536, channels=24, depth=4)
WAVEUNET_SMALL_GEOMETRY = dict(window_samples=16384, channels=8, depth=3)


def iter_batches(data_dir, window: int, batch: int, rng: np.random.Generator):
    """Random windows of the ``*_mix.wav`` / ``*_vocal.wav`` pairs under ``data_dir``."""
    from audio_cut_tpu_torch.io.audio import load_audio

    pairs = sorted(Path(data_dir).glob("*_mix.wav"))
    if not pairs:
        raise SystemExit(f"no *_mix.wav files under {data_dir}")
    loaded = []
    for mix_path in pairs:
        vocal_path = mix_path.with_name(mix_path.name.replace("_mix.wav", "_vocal.wav"))
        if not vocal_path.exists():
            continue
        mix, _ = load_audio(mix_path, target_sr=SR)
        vocal, _ = load_audio(vocal_path, target_sr=SR)
        n = min(mix.size, vocal.size)
        if n >= window:
            loaded.append((mix[:n], vocal[:n]))
    if not loaded:
        raise SystemExit("no usable pairs (need *_mix.wav + *_vocal.wav of >= window length)")
    while True:
        mixes, vocals = [], []
        for _ in range(batch):
            mix, vocal = loaded[rng.integers(len(loaded))]
            start = rng.integers(0, mix.size - window + 1)
            mixes.append(mix[start:start + window])
            vocals.append(vocal[start:start + window])
        yield np.stack(mixes), np.stack(vocals)


def synthetic_batches(window: int, batch: int, rng: np.random.Generator):
    """Harmonic tones over noise beds: a run without data."""
    t = np.arange(window) / float(SR)
    while True:
        vocals = np.zeros((batch, window), np.float32)
        beds = np.zeros((batch, window), np.float32)
        for b in range(batch):
            f0 = rng.uniform(120, 350)
            x = np.zeros(window)
            for h in range(1, 5):
                x += np.sin(2 * np.pi * h * f0 * t) / h
            vocals[b] = (rng.uniform(0.1, 0.4) * x).astype(np.float32)
            beds[b] = (rng.standard_normal(window) * rng.uniform(0.02, 0.1)).astype(np.float32)
        yield vocals + beds, vocals


def evaluate_si_snr(sep, device: torch.device, n_pairs: int = 6, seed: int = 1234):
    """Held-out synthetic eval: SI-SNR (dB) of the separator's vocal estimate
    (a ``ConvTDFSeparator`` or a ``WaveUNetSeparator``) and of the model-free
    spectral-mask backend on the same mixtures."""
    from audio_cut_tpu_torch.separation.backends import SpectralMaskBackend
    from audio_cut_tpu_torch.training.sep_data import si_snr, synth_pair

    rng = np.random.default_rng(seed)
    spectral = SpectralMaskBackend(SR)
    conv_scores, spec_scores = [], []
    for _ in range(n_pairs):
        mix, vocal = synth_pair(rng, sep.window_samples)
        x = torch.from_numpy(mix).to(device)
        v_conv, _ = sep.separate(x[None], sep.window_samples)
        v_spec, _ = spectral.separate_window(x)
        conv_scores.append(si_snr(v_conv[0].float().cpu().numpy(), vocal))
        spec_scores.append(si_snr(v_spec.cpu().numpy()[:vocal.size], vocal))
    return float(np.mean(conv_scores)), float(np.mean(spec_scores))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m audio_cut_tpu_torch.training.train_separator",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--bootstrap", action="store_true",
                    help="the bootstrap geometry on the synthetic stem generator "
                         "(training/sep_data.py); saves msgpack + geometry sidecar")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--checkpoint", default=None,
                    help="a flax .msgpack file to write the trained parameters to")
    ap.add_argument("--small", action="store_true", help="small geometry for smoke tests")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny CPU-tier geometry (TINY_GEOMETRY)")
    ap.add_argument("--large", action="store_true",
                    help="ConvTDF-large (LARGE_GEOMETRY, about 5.1 M parameters)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--pause-weight", type=float, default=None,
                    help="override TrainConfig.pause_loss_weight (the pause-suppression "
                         "RMS penalty)")
    ap.add_argument("--eval-pairs", type=int, default=6)
    ap.add_argument("--max-minutes", type=float, default=0.0,
                    help="wall-clock budget; stops cleanly (saving the checkpoint) when "
                         "exceeded")
    ap.add_argument("--augment", action="store_true",
                    help="channel-effect augmentation (reverb, saturation, noise) on the "
                         "synthetic stem generator's pairs")
    ap.add_argument("--rich", action="store_true",
                    help="widened timbre families (not in the PyTorch port yet)")
    ap.add_argument("--family", choices=("convtdf", "waveunet"), default="convtdf",
                    help="separator family: the spectrogram mask net (default) or the "
                         "waveform U-Net tier")
    ap.add_argument("--datagen-threads", type=int, default=2,
                    help="producer threads for the synthetic stem generator "
                         "(training/prefetch.py); 0 disables prefetch")
    ap.add_argument("--resume", default=None,
                    help="initialise the parameters from a checkpoint ('packaged' or a "
                         ".msgpack path); the optimizer state restarts fresh")
    ap.add_argument("--warm-step-threshold-s", type=float, default=0.0,
                    help="if > 0: exit with code 3 when the first warm train step is "
                         "slower than this")
    ap.add_argument("--device", default="cuda",
                    help="'cuda', 'cuda:N' or 'cpu' (default cuda; raises without CUDA)")
    return ap


def main(argv: Optional[Sequence[str]] = None, report: Optional[Dict[str, Any]] = None) -> int:
    """The entry point. ``report``, if given, is a dict that ``main`` fills
    with the run's record, for a caller that measures the run: the trainer,
    one dict per step (its metrics, ``wait_s`` for the batch, ``step_s``),
    the loop's wall seconds and the held-out SI-SNR pair."""
    args = _parser().parse_args(argv)
    if args.rich:
        raise NotImplementedError(
            "--rich (training/rich_data.py) is not in the PyTorch port yet: ROADMAP.md, "
            "queue 1, 'Training'")
    device = resolve_device(args.device)

    cfg_kwargs: Dict[str, Any] = dict(learning_rate=args.lr)
    if args.pause_weight is not None:
        cfg_kwargs["pause_loss_weight"] = args.pause_weight
    train_cfg = TrainConfig(**cfg_kwargs)
    generator = torch.Generator().manual_seed(0)
    if args.family == "waveunet":
        family = waveunet
        geometry = WAVEUNET_SMALL_GEOMETRY if args.small else WAVEUNET_GEOMETRY
        sep = WaveUNetSeparator(SR, **geometry)
        trainer = WaveTrainer(sep, train_cfg, generator=generator, device=device)
    else:
        family = convtdf
        if args.small:
            geometry = SMALL_GEOMETRY
        elif args.tiny:
            geometry = TINY_GEOMETRY
        elif args.large:
            geometry = LARGE_GEOMETRY
        elif args.bootstrap:
            geometry = BOOTSTRAP_GEOMETRY
        else:
            geometry = {}
        sep = ConvTDFSeparator(SR, **geometry)
        trainer = Trainer(sep, train_cfg, generator=generator, device=device)
    if args.resume:
        src = family.packaged_checkpoint_path() if args.resume == "packaged" else args.resume
        if not src:
            raise SystemExit("--resume packaged: no packaged checkpoint found")
        trainer.load_params(family.load_checkpoint(str(src)))
        print(f"resumed params from {src}", flush=True)

    generated = args.bootstrap or args.tiny or args.large
    rng = np.random.default_rng(0)
    prefetch = None
    if generated:
        from audio_cut_tpu_torch.training.sep_data import synth_batches

        def make_iter(seed):
            return synth_batches(sep.window_samples, args.batch, np.random.default_rng(seed),
                                 augment=args.augment)

        if args.datagen_threads > 0:
            from audio_cut_tpu_torch.training.prefetch import PrefetchBatches

            batches = prefetch = PrefetchBatches(make_iter, threads=args.datagen_threads)
        else:
            batches = make_iter(0)
    elif args.synthetic or not args.data_dir:
        batches = synthetic_batches(sep.window_samples, args.batch, rng)
    else:
        batches = iter_batches(args.data_dir, sep.window_samples, args.batch, rng)

    steps = []
    t_start = time.perf_counter()
    budget_s = args.max_minutes * 60.0 if args.max_minutes > 0 else float("inf")
    completed = 0
    try:
        for step in range(1, args.steps + 1):
            t0 = time.perf_counter()
            mix, vocal = next(batches)
            t1 = time.perf_counter()
            metrics = trainer.train_step(mix, vocal)  # floats: the step has finished
            step_s = time.perf_counter() - t1
            steps.append({"step": step, "wait_s": t1 - t0, "step_s": step_s, **metrics})
            if step == 1:
                print(f"step 1 (first) {step_s:.1f}s  loss {metrics['loss']:.4f}", flush=True)
            elif (step == 2 and args.warm_step_threshold_s > 0
                  and step_s > args.warm_step_threshold_s):
                print(f"warm step {step_s:.2f}s > {args.warm_step_threshold_s}s: stopping",
                      flush=True)
                return 3
            elif step % max(1, args.steps // 20) == 0 or step == 2:
                print(f"step {step:6d}  loss {metrics['loss']:.4f}  "
                      f"spec {metrics['spec_l1']:.4f}  wave {metrics['wave_l1']:.4f}  "
                      f"pause {metrics['pause_rms']:.4f}  ({step_s * 1000:.0f} ms/step, "
                      f"{(t1 - t0) * 1000:.0f} ms waiting for the batch)", flush=True)
            completed = step
            if time.perf_counter() - t_start > budget_s:
                print(f"wall-clock budget reached at step {step}; stopping cleanly", flush=True)
                break
    finally:
        if prefetch is not None:
            prefetch.close()
        if report is not None:
            report.update(trainer=trainer, steps=steps, loop_s=time.perf_counter() - t_start,
                          eval=None)

    if args.checkpoint and completed < min(50, args.steps):
        # too few steps for real training: a near-random checkpoint would
        # silently replace trained weights
        print(f"only {completed} steps completed: NOT saving {args.checkpoint}", flush=True)
        return 4

    if generated:
        eval_sep = sep
        if args.tiny and args.family == "convtdf":
            # evaluate at the SERVING window: the tiny training window
            # (0.37 s) often holds no vocal at all, which makes SI-SNR meaningless
            eval_sep = ConvTDFSeparator(SR, **{**TINY_GEOMETRY, "dim_t": TINY_SERVING_DIM_T})
            eval_sep.net = sep.net
        conv_db, spec_db = evaluate_si_snr(eval_sep, device, n_pairs=args.eval_pairs)
        if report is not None:
            report["eval"] = (conv_db, spec_db)
        print(f"held-out SI-SNR: convtdf {conv_db:.2f} dB vs spectral {spec_db:.2f} dB "
              f"({'BEATS' if conv_db > spec_db else 'BELOW'} the model-free baseline)", flush=True)

    if args.checkpoint:
        ckpt_path = Path(args.checkpoint).expanduser().resolve()
        trainer.save_checkpoint(str(ckpt_path))
        if generated:
            if args.family == "waveunet":
                # fully convolutional over T: the serving window stays the
                # config's window_samples; the sidecar pins only the net
                meta = {"channels": sep.net.channels, "depth": sep.net.depth}
            elif args.tiny:
                # the tiny sidecar pins the serving window too
                meta = {k: v for k, v in TINY_GEOMETRY.items() if k != "dim_t"}
                meta["dim_t"] = TINY_SERVING_DIM_T
            else:
                # fully convolutional over T: the serving window stays the
                # config dim_t; the sidecar pins only the net
                meta = {k: v for k, v in geometry.items() if k != "dim_t"}
            with open(str(ckpt_path) + ".json", "w") as f:
                json.dump(meta, f, indent=1)
            print(f"geometry sidecar saved: {ckpt_path}.json")
        print(f"checkpoint saved: {args.checkpoint}")
        print(f"activate with runtime override: enhanced_separation.backend={args.family}, "
              f"enhanced_separation.{args.family}.checkpoint={args.checkpoint}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
