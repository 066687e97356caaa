"""One fixed (vocal stem, detection bundle) pair for the host-tail parity
tests of the PyTorch port (``test_torch_mdd_tail.py``, ``test_torch_vpbd.py``).

The pair comes from the port's bundle of a synthetic 30 s song on the CPU
(with the packaged ConvVAD, or without it for ``vad.backend: energy_gate``),
copied to the host as ONE flat array. Each package unpacks that flat copy
into its own DetectionBundle. ``patch_fused`` replaces both packages'
``separate_and_detect_fused``, for one test's ``MonkeyPatch`` only, by a
function that returns the pair, so ``separate_and_segment`` then runs the
whole host tail of each package on equal inputs. The port's result also
holds the vocal as its device stem (a CPU tensor), which its ``vpbd_asr``
reads for the ASR copy. No file of either package changes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

SR = 44100
DUR_S = 30.0
FAKE_META = {"gpu_pipeline_backend": "convtdf", "gpu_pipeline_chunks": 11,
             "gpu_pipeline_mode": "fused_single_program"}


def song(chorus_s: Optional[float] = None):
    """(mix, vocal): an 8 s beat-only intro, then sung phrases of 1.6-3.5 s
    with 0.5-1.2 s gaps, over clicks at 120 BPM. With ``chorus_s``, the bed
    is three times as loud from that time on and carries a sustained chord:
    a high-energy section of whole bars, where beat candidates may fall."""
    rng = np.random.default_rng(21)
    n = int(DUR_S * SR)
    t = np.arange(n) / SR
    vocal = np.zeros(n)
    start = 8.0
    while start + 2.0 < DUR_S:
        length = rng.uniform(1.6, 3.5)
        seg = (t >= start) & (t < min(start + length, DUR_S))
        f0 = rng.uniform(180, 300) * (1 + 0.01 * np.sin(2 * np.pi * 5.5 * t[seg]))
        x = sum(np.sin(2 * np.pi * h * np.cumsum(f0) / SR) / h for h in range(1, 5))
        ramp = np.minimum(1.0, np.minimum(np.arange(x.size), x.size - np.arange(x.size)) / (0.04 * SR))
        vocal[seg] += 0.3 * x * ramp
        start += length + rng.uniform(0.5, 1.2)
    bed = np.zeros(n)
    for beat in np.arange(0.0, DUR_S, 0.5):
        i = int(beat * SR)
        k = min(2000, n - i)
        bed[i:i + k] += 0.15 * np.exp(-np.arange(k) / 300.0) * rng.standard_normal(k)
    if chorus_s is not None:
        loud = t >= chorus_s
        bed[loud] *= 3.0
        bed[loud] += 0.1 * sum(np.sin(2 * np.pi * f * t[loud]) for f in (110.0, 138.6, 164.8))
    vocal *= 0.9
    return (vocal + bed).astype(np.float32), vocal.astype(np.float32)


@dataclass
class TailPair:
    mix: np.ndarray
    vocal: np.ndarray
    flat: np.ndarray
    shapes: Dict[str, Any]
    statics: Any
    torch_vad: Any
    jax_vad: Any


def build_pair(vad_backend: str = "conv", chorus_s: Optional[float] = None) -> TailPair:
    """The song, and the port's bundle of it on the CPU as one flat host copy."""
    from audio_cut_tpu.models.vad import build_vad as jax_build_vad
    from audio_cut_tpu_torch.analysis import bundle as TB
    from audio_cut_tpu_torch.models.vad import build_vad as torch_build_vad
    from audio_cut_tpu_torch.separation.engine import padded_track_len

    mix, vocal = song(chorus_s)
    n = mix.size
    padded = padded_track_len(n, SR, 1024)
    statics = TB.bundle_statics(SR)
    if vad_backend == "conv":
        torch_vad, jax_vad = torch_build_vad(SR, "cpu"), jax_build_vad(SR)
    else:  # the energy gate: no ConvVAD in the bundle
        torch_vad = jax_vad = None
    with torch.inference_mode():
        out = TB._bundle_fn(torch.from_numpy(np.pad(mix, (0, padded - n))),
                            torch.from_numpy(np.pad(vocal, (0, padded - n))),
                            torch_vad.net if torch_vad is not None else None, SR, *statics)
        flat, shapes = TB.flatten_bundle(out)
    return TailPair(mix, vocal, flat.numpy(), shapes, statics, torch_vad, jax_vad)


def patch_fused(mp, pair: TailPair) -> None:
    """Make both packages' ``separate_and_detect_fused`` return ``pair``."""
    import jax

    from audio_cut_tpu.analysis import bundle as JB
    from audio_cut_tpu.separation import fused as jax_fused
    from audio_cut_tpu.separation.engine import SeparationResult as JaxResult
    from audio_cut_tpu_torch.analysis import bundle as TB
    from audio_cut_tpu_torch.separation import fused as torch_fused
    from audio_cut_tpu_torch.separation.engine import SeparationResult as TorchResult

    n = pair.mix.size
    jshapes = {k: jax.ShapeDtypeStruct(s, np.float32) for k, s in pair.shapes.items()}

    def fake(result_cls, bundle_mod, shapes, vad):
        def separate_and_detect_fused(engine, vad_model, audio, *, guard_win_ms, refine_win_ms,
                                      staged=False):
            assert vad_model is vad and len(audio) == n
            assert (guard_win_ms, refine_win_ms) == (80.0, 5.0)
            assert not staged
            sep = result_cls(vocal_track=pair.vocal.copy(), instrumental_track=None,
                             backend_used="convtdf", separation_confidence=None,
                             device_meta=dict(FAKE_META))
            sep._mix_energy = float(np.mean(np.square(audio)))
            if result_cls is TorchResult:
                sep.vocal_device = torch.from_numpy(pair.vocal.copy())
            bundle = bundle_mod.unpack_bundle(pair.flat, shapes, SR, n, pair.statics, vad_model)
            if bundle.vocal_energy is not None:  # as both packages' fused pass sets it
                ratio = bundle.vocal_energy / (sep._mix_energy + 1e-12)
                sep.separation_confidence = float(np.clip(1.0 - abs(ratio - 0.35) / 0.65, 0.1, 0.99))
            return sep, bundle
        return separate_and_detect_fused

    mp.setattr(jax_fused, "separate_and_detect_fused", fake(JaxResult, JB, jshapes, pair.jax_vad))
    mp.setattr(torch_fused, "separate_and_detect_fused",
               fake(TorchResult, TB, pair.shapes, pair.torch_vad))
