"""The serving pass of v2.2_mdd: separation, then the detection bundle over
the stems on the device, then ONE host copy.

Counterpart of ``audio_cut_tpu/separation/fused.py``. The JAX package traces
the engine's OLA graph and the bundle into one jitted program; here the
engine's whole-track OLA (``SeparationEngine.separate_on_device``) and the
bundle (``analysis/bundle._bundle_fn``) run one after the other on the same
device, and the only device-to-host copy is the bundle's flat tensor. The
stems stay on the device; their host copies are lazy.

The bundle sees what the JAX program sees: the dequantized int16 upload of
the mix, padded to ``padded_track_len``, and the vocal stem with exact zeros
past the true length (the OLA leaks a little energy past the track end).
"""

from __future__ import annotations

import time

import numpy as np
from torch.profiler import record_function


def separate_and_detect_fused(
    engine,
    vad_model,
    audio: np.ndarray,
    *,
    guard_win_ms: float = 80.0,
    refine_win_ms: float = 5.0,
    pipeline_mode: str = "fused_single_program",
):
    """Returns (SeparationResult, DetectionBundle). ``vad_model`` is a
    ``ConvVAD`` or None (energy gate: no VAD probabilities in the bundle).
    ``pipeline_mode`` is the manifest's label: the JAX package's staged path
    and hybrid_mdd's second pass report ``device_ola``, and run this same
    pass in the port."""
    from audio_cut_tpu_torch.analysis.bundle import build_detection_bundle
    from audio_cut_tpu_torch.separation.engine import SeparationResult

    audio = np.asarray(audio, dtype=np.float32)
    n = audio.shape[-1]

    t0 = time.time()
    with record_function("separation"):
        vocal_dev, inst_dev, mix_dev, meta = engine.separate_on_device(audio)
    with record_function("detection_bundle"):
        bundle = build_detection_bundle(mix_dev, vocal_dev, engine.sample_rate, n,
                                        guard_win_ms=guard_win_ms, refine_win_ms=refine_win_ms,
                                        vad_model=vad_model)
    total_ms = round((time.time() - t0) * 1000.0, 3)

    meta = dict(meta)
    meta.update({
        "gpu_pipeline_compute_ms": total_ms,
        "gpu_pipeline_total_ms": total_ms,
        "gpu_pipeline_mode": pipeline_mode,
    })
    result = SeparationResult(
        vocal_track=None,
        instrumental_track=None,
        backend_used=engine._backend_name,
        separation_confidence=None,
        device_meta=meta,
    )
    result.vocal_device = vocal_dev
    result.instrumental_device = inst_dev
    result.mix_device = mix_dev
    result._mix_energy = float(np.mean(np.square(audio)))
    return result, bundle
