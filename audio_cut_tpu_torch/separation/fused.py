"""The serving pass of v2.2_mdd: separation, then the detection bundle over
the stems on the device, then ONE host copy.

Counterpart of ``audio_cut_tpu/separation/fused.py``. The JAX package traces
the engine's OLA graph and the bundle into one jitted program; here the
engine's OLA (``SeparationEngine.separate_on_device``, whole-track or in
pipelined pieces) and the bundle (``analysis/bundle._bundle_fn``) run one
after the other on the same device, and the only device-to-host copy is the
bundle's flat tensor. The stems stay on the device; their host copies are
lazy.

The bundle sees what the JAX program sees: the dequantized int16 upload of
the mix, padded to ``padded_track_len``, and the vocal stem with exact zeros
past the true length (the OLA leaks a little energy past the track end).

The manifest's label comes from the layout that ran: ``fused_pipelined_p<P>``
for P pieces, else ``fused_single_program``. The JAX package's staged path
and hybrid_mdd's memo miss call ``separate_for_detection`` there, and report
the engine's ``device_ola_pipelined_p<P>`` or ``device_ola``; in the port
they run this same pass with ``staged=True``, which keeps the engine's label.
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
    staged: bool = False,
):
    """Returns (SeparationResult, DetectionBundle). ``vad_model`` is a
    ``ConvVAD`` or None (energy gate: no VAD probabilities in the bundle).
    ``staged`` keeps the engine's label (the staged path, hybrid's memo
    miss) instead of the fused pass's."""
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
    label = meta["gpu_pipeline_mode"]  # device_ola[_pipelined_p<P>]
    if not staged:
        label = ("fused_single_program" if label == "device_ola"
                 else label.replace("device_ola", "fused", 1))
    meta.update({
        "gpu_pipeline_compute_ms": total_ms,
        "gpu_pipeline_total_ms": total_ms,
        "gpu_pipeline_mode": label,
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
