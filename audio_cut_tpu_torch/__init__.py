"""PyTorch/CUDA port of audio_cut_tpu.

A second package beside the JAX reference: the same functions in PyTorch,
with every Pallas kernel of the reference rewritten by hand for NVIDIA Hopper
(``csrc/``). Entry points run on CUDA unless the caller passes ``device="cpu"``.
It runs ``separate_and_segment()`` in its default ``v2.2_mdd`` mode (ConvTDF
or spectral-mask separation, the detection bundle with ConvVAD, the host
cutting tail), on the fused pass or, with ``device_pipeline.fused_program:
false``, on the staged path; in ``vpbd_acoustic`` and ``vpbd_asr`` (with
lyric priors from an ASR provider when lyrics alignment is on, as the intent
arguments ``segments=``/``alignment=`` turn it); in ``hybrid_mdd``
(beat-snapped cuts with _lib tags); in ``librosa_onset`` (the bpm's bar grid
over a feature pass, the separation only labelling the segments); and in
``vocal_separation``. The pause detector's legacy multi-feature mode
(``enable_relative_energy_mode: false``, YIN and LPC on the vocal stem's
device) runs under the modes that detect pauses. ``separate_and_segment_batch()``
runs many tracks: one separation pass over the CUDA devices, then each
track's mode over its injected stems, with the manifests of single calls.
ROADMAP.md lists what comes next.
"""

from audio_cut_tpu_torch.api import separate_and_segment, separate_and_segment_batch

__all__ = ["separate_and_segment", "separate_and_segment_batch"]
