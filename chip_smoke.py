#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (audio_cut_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. builds every CUDA kernel of the port from ``audio_cut_tpu_torch/csrc`` with
   nvcc, one process per source, all started together, and prints each
   build's time and, from the same builds' ``-Xptxas -v`` report, each
   kernel's registers and spills; checks that the
   first kernel launch of the process ran the library check, K0
   (``csrc/probe.cu``), exactly once, with a result equal to x * 2, and
   times K0 and ``torch.mul`` in turns (mul, K0, K0, mul);
3. holds kernel K1 (windowed overlap-add, ``csrc/ola.cu``) equal to its plain
   PyTorch version bit for bit, at every shape a path gives it
   (``K1_SHAPES`` of ``audio_cut_tpu_torch/testing.py``: a piece of 2
   windows, the last piece of 1, pieces of 3, the whole-track path's groups
   of 4, a spectral piece, the training forward), two others and its edges
   (``K1_EDGE_SHAPES``: the scalar form off 16 B alignment and at a hop no
   multiple of 4, r = 1, r above the terms a thread loads together, a single
   frame, fewer frames than r), one launch each, and times it at each of
   those path shapes but the spectral one (timed in 6) beside its plain
   version, ``F.fold`` and its bound; holds K1's backward kernels (``csrc/ola.cu``:
   K1B, the frames' gradient, exactly; K1W, the window's, one launch that
   reduces the rows across a thread-block cluster, within ``OLA_BWD_RTOL``
   of the sum of |terms|) against the plain backward at the same shapes, the
   training shape and a hop that takes the kernels' scalar path, checks that
   autograd through the iSTFT on the card launches K1B and gives the CPU's
   gradient, and times K1B and K1B + K1W at the training shape beside the
   plain backward, the backward of ``F.fold`` and their bounds;
4. holds kernel K2 (spectral flatness and onset, ``csrc/frame_stats.cu``)
   against its plain version at rtol 2e-4 / atol 2e-5, at the feature grids of
   a 60 s and a 3-minute song, edge shapes, librosa_onset's grid of a 60 s
   song (``K2_SHAPES``) and a spectrogram that starts off a 16 B boundary,
   and times it at the bundle's 60 s grid and at librosa_onset's
   (``K2_TIMED_SHAPES``) beside its plain version and its bound.
   Device times come from a CUDA graph replay; the wrapper's time per call
   from Python is printed apart;
5. drives the main path: ``separate_and_segment()`` with no mode (v2.2_mdd)
   and no device, with the packaged ConvTDF-large and ConvVAD, on a
   synthesized 60 s song, cold then warm. Each call must succeed, give >= 2
   segments labelled human or music that splice back to the PCM-24 encoding
   of the input exactly, and launch K1 once per piece of the pipelined
   upload and K2 once, under the label of the layout that ran
   (``check_pass``: the script computes the pieces from ``ola_plan`` and the
   piece rule, ``expected_pass``: 11 windows in 6 pieces at 60 s, so K1 6,
   ``fused_pipelined_p6``); the two calls launch K0 once. Before each path the script sets every launch count to 0
   and re-arms the library check (``reset_counts``), so each path shows K0
   as a fresh process would;
   Then the spectral backend on the same song, cold then warm
   (``enhanced_separation.backend: spectral``, no model): each call must
   report the backend and ``cuda``, run the config schedule's engine windows
   (8 at 60 s, computed by the script with ``ola_plan``) in 4 pieces, launch
   K1 once per piece and K2 once, and splice back exactly; one group
   of 4 engine windows through the backend on the card and on the CPU must
   agree at SNR >= ``SPECTRAL_SNR_DB``; K1 at the shape this path gives it
   ([2, 865, 2048] hop 512 at 60 s) is held against its plain version and timed
   beside its bound and ``F.fold``; one more warm call is profiled, with the
   median network's share of the card's busy time;
   Then drives the vpbd modes the same way, on the same song with a loud
   section of whole bars from ``CHORUS_S`` on (where the chorus-gated beat
   candidates fall): ``mode="vpbd_acoustic"`` twice and ``mode="vpbd_asr"``
   (lyrics alignment off, the default) once, each launching K1 once per
   piece and K2 once (K0 once in the phase), each splicing back exactly and carrying
   the planner's ``boundary_detection`` (candidate counts with beat
   candidates in the unified pool and a non-empty merged pool, selected
   candidates, guard-shift metadata), ``cuts.final`` entries enriched with
   their candidate's source, the ``auto_profile`` and the candidate debug
   JSON; ``vpbd_asr`` carries ``note == "lyrics_unavailable:disabled"``.
   Prints each call's wall time, style, anchor weights, candidate counts
   and cuts, and the phase's peak memory.
   Then vpbd_asr with lyric priors on that song, through the intent
   argument ``segments="many"``: with the fake provider on a timeline the
   script writes from the song's voice phrases (two words, one sentence and
   one mVAD region a phrase), the call must report vpbd_asr with no note and
   the fake provider, hold lyric candidates in its pool, echo the intent,
   give every segment the words that lie inside it, launch K1 once per piece
   and K2 once and splice back exactly; its ASR copy must be made from the CUDA
   vocal stem and lie within one PCM_16 step of the same function's copy of
   that stem on the CPU. On the default provider chain the call must note
   ``lyrics_unavailable:no_provider``; strict with the null provider it must
   raise ``LyricsAlignmentUnavailable``. The first call runs once more under
   the profiler.
   Then drives ``mode="hybrid_mdd"`` the same way, once per strategy
   (``snap_to_beat`` at the defaults, then ``beat_only``) on the song with
   the loud section and on a song whose loud section from ``STOP_TIME_S``
   is sung on the beat grid with silent rests (the loud bed of the first
   leaks into the vocal stem, so no beat there passes the strategies'
   quiet check): each call reuses its ``v2.2_mdd`` sub-run's device pass,
   so it launches K1 once per piece and K2 once (K0 once in the phase), splices
   back exactly and names each segment's file with ``_lib`` exactly where
   the result's lib flag is set; at least one segment of the phase carries
   ``_lib``. Prints each call's wall time, its ``_lib`` count and cuts, and
   the phase's peak memory;
   Then ``mode="librosa_onset"`` on the 60 s song with
   ``export_types=("mix_segments", "vocal_segments")``, cold and warm with the
   separation (the default), once with ``use_vocal_separation: false`` and
   once with the separation on a song whose first ``INTRO_S`` s are the beat
   alone: every call reports ``smart_segment_v2`` and splices back exactly;
   with the separation K1 once per piece, K2 1, the engine's label
   ``device_ola_pipelined_p6`` and one vocal segment per segment,
   without it K1 0, K2 1 and every label human; the intro call gives a
   music segment; K0 once in the phase. The warm call's features (hop 512)
   are held to the CPU's within ``BUNDLE_TOL``, the onset within what the two
   sides' spectrograms allow (``check_onset``), and its cuts to the CPU's
   run of the same host logic over the CPU's features within the shift that
   the bpm's tolerance allows the last bar edge. Prints each call's wall
   time, bpm, bar duration, silence boundaries, labels and peak memory;
   Then the legacy multi-feature detector (``LEGACY``) on the 60 s song:
   v2.2_mdd cold and warm and vpbd_acoustic once, each with K1 once per
   piece and K2 1
   (K0 once in the phase), multi_feature pauses and the exact splice; YIN
   and LPC on the warm call's vocal stem on the card against the CPU
   (voicing and formant strength within ``VOICING_ATOL``, f0 within
   ``F0_HZ`` on ``F0_MIN_SHARE`` of frames); the warm call's pauses against
   the detector on the CPU's bundle with YIN and LPC on the CPU (the same
   count, confidences within ``LEGACY_CONF_ATOL``, cuts at most one dB-grid
   stride apart); the warm call's audio-s per wall-s beside the default
   warm call's, and the fenced split of YIN's and LPC's time (device part,
   download, host Viterbi) beside the vocal download;
6. computes the detection bundle from the warm call's stems on the card and
   on the CPU (plain versions, float32) and holds every output of the card to
   the CPU's within the bounds of ``BUNDLE_TOL``, K2 on the main path's own
   spectrogram at its kernel bound, and the VAD segments equal; prints the
   cut lists the v2.2_mdd and the vpbd host tails make from each bundle, the
   vpbd style of each, and which of the style, its inputs, the pool, the
   planner's choice and the cuts are equal (printed, not held). Then the
   staged bundle path: ``build_detection_bundle`` over the warm call's own
   stems with the same ConvVAD must equal that call's fused bundle bit for
   bit, and one call with ``device_pipeline.fused_program: false``, which
   separates the song again, must launch K1 once per piece and K2 once (K0
   once), report the engine's ``device_ola_pipelined_p6``, splice back
   exactly, and give the warm fused call's bundle bit for bit and its cuts.
   Then two calls with ``device_pipeline.pipelined_upload: false``: the
   whole-track path, K1 3 and K2 1 a call under ``fused_single_program``,
   the warm pipelined call's mix bit for bit and its stems within
   ``PIECE_SNR_DB`` and ``PIECE_ATOL``, the walls and peak memory printed
   beside theirs, and one more call profiled (``profile_call``). Then
   one call under a YAML config file named by ``$AUDIO_CUT_TPU_CONFIG`` that
   sets ``device_pipeline.piece_windows: 3``: 4 pieces, K1 4,
   ``fused_pipelined_p4``;
7. runs the first slice's path, ``mode="vocal_separation"``, once, and one
   model window through the separator on the card (bfloat16, K1) and on the
   CPU (float32, plain versions) at SNR >= 30 dB.
   Then shift averaging (``SHIFTS``: ``enhanced_separation.convtdf.shifts:
   2``): v2.2_mdd cold and warm, each with the K1 launches ``expected_pass``
   computes for it (a forward takes map_group // 2 windows, so one K1 a
   piece at 4 rows, 2 for the last piece: 6 a call, their rows recorded at
   each launch), K2 once, K0 once in the phase, ``fused_pipelined_p6`` and
   the exact splice; it prints the walls, the peak memory and the shifted
   vocal's SNR against the ``shifts: 1`` warm vocal, and holds one window at
   shifts 2 (2 rows in one forward) card against CPU at >= 30 dB.
   Then the batch entry point, ``separate_and_segment_batch``, over
   song.wav, song_chorus.wav and a ``BATCH_SHORT_S`` song, after a warm
   single call of each (K1 6, 6 and 4, K2 1 each): the batch launches K1 8
   times at the rows ``expected_batch`` computes (the 45 s bucket's 8
   windows, then the two 60 s tracks' 22, in forwards of 4: 7 at 4 rows, 1
   at 2), K2 3 and K0 1; every manifest succeeds under
   ``mesh_batch_precomputed`` with ``gpu_pipeline_batch_size`` 3, with the
   cuts and segments of its single call and the exact splice; the stems of
   ``separate_tracks_mesh`` lie within ``BATCH_STEM_ATOL`` of
   ``SeparationEngine.separate_on_device``'s, and the injected engine's mix
   equals the engine's bit for bit. It prints the batch's wall and peak
   memory beside the single calls';
   Then the shell (``run_shell``): ``cli.main([song, "-o", out, "--json",
   "--validate-reconstruction"])`` in this process (rc 0, ``reconstruction:
   OK``, K1 6, K2 1, ``fused_pipelined_p6``, the warm v2.2_mdd call's cut
   samples, the exact splice); its ``batch`` verb over the batch phase's
   three songs (rc 0, three JSON lines with ``success``, K1 8 at
   ``expected_batch``'s rows, K2 3, K0 1, the batch phase's cuts);
   ``python -m audio_cut_tpu_torch.cli warmup --json`` in a fresh process
   (rc 0, every step ok, every build step 0.0 s: the libraries this run
   built were found; each step's wall printed); the 60 s song through
   ``python -m audio_cut_tpu_torch.cli`` in a fresh process (rc 0, the exact
   splice; its wall from start to exit, the first-track latency with the
   kernels built); and ``quick_start.run_interactive`` with ``input``
   scripted (``QUICK_START_ANSWERS``) on a directory holding
   song_chorus.wav, which runs vpbd_asr's intent (rc 0, K1 6, K2 1, the
   manifest passing ``check_vpbd``). Every figure is printed beside the
   card's name and power limit. The root logger that the CLI configures is
   restored after the in-process calls;
8. profiles one more warm v2.2_mdd call and one more warm vpbd_acoustic call
   (on the song of the vpbd phase) (``torch.profiler``): wall time, the spans of the pass (load, separation,
   detection bundle, host tail, export), the card's busy time, the kernels
   that take it and K1's and K2's device time per launch, how much of the
   upload's host-to-device copy time overlaps kernel time (printed, not
   held), and that every cached staging buffer of the upload is pinned
   (held);
9. drives the training slice through its entry point,
   ``train_separator.main``: ConvTDF-large at full width from the packaged
   checkpoint, ``TRAIN_STEPS`` steps at batch 4 with the synthetic stem
   generator on 2 host threads, the held-out SI-SNR on 2 pairs and a
   checkpoint. Every loss must be finite, every parameter must move, and
   the launches must be K1 = steps + 2 per held-out pair, K1B = steps,
   K1W = 0 and K0 = 1. Prints the warm step time (steps 3 on), trained audio-s per
   wall-s, the share of each step spent waiting for a batch and the peak
   memory; profiles one more step;
10. loads the written checkpoint through the serving ``ConvTDFBackend`` and
    separates one window: it must equal the trained net in memory exactly;
11. runs one float32 train step of ConvTDF-large (dim_t 32, batch 1) on the
    card and on the CPU from the same weights and batch: the loss and the
    global gradient norm within ``STEP_RTOL`` and every leaf's gradients at
    cosine >= ``STEP_MIN_COS``;
12. drives the WaveUNet tier (``models/waveunet.py``, window 262144,
    channels 24, depth 4, bfloat16 activations on float32 parameters):
    trains it through ``train_separator.main(["--family", "waveunet",
    "--bootstrap", ...])``, ``WAVEUNET_STEPS`` steps at batch 4, with K0 1
    and K1 one per held-out pair (the spectral yardstick; the WaveUNet runs
    none of the port's kernels), finite losses, the msgpack and its sidecar
    ``{"channels": 24, "depth": 4}``, read back equal to the trained
    parameters, and prints the warm steps' median and trained audio-s per
    wall-s; profiles one more step; holds one float32 train step at the ``--small`` geometry card
    against CPU (``STEP_RTOL``, ``STEP_MIN_COS``); then serves that
    checkpoint (``enhanced_separation.backend: waveunet``) through
    ``separate_and_segment()`` with no mode, cold then warm, and
    ``mode="vocal_separation"`` once: backend waveunet on cuda, 11 windows
    in 6 pieces (``expected_pass(..., "waveunet", ...)``), K1 0 and K2 1 in
    each v2.2_mdd call and 0 in vocal_separation, K0 once in the phase, the
    device stems summing to the mix within ``WAVEUNET_SUM_ATOL``, the exact
    splice (one segment allowed: 20 steps leave the stem without clean
    pauses), each call's wall, audio-s per wall-s and peak memory printed;
    the warm v2.2_mdd call's cuts against a ``device="cpu"`` call on the
    same checkpoint (same count, each within one dB-grid stride); one map group of 4 windows through the backend, card (bf16) against CPU
    (float32), at SNR >= ``WAVEUNET_GROUP_SNR_DB``; and one more warm call
    profiled;
13. drives the ONNX tier (``separation/onnx_backend.py``, the port's
    ``onnx/`` reader and executor): writes the Kim_Vocal_1-geometry graph
    (``testing.KIM_VOCAL_1``: dim_f 3072, dim_t 256, L 11, g 48, l 3, bn 8;
    459 nodes, ``ONNX_PARAMS`` parameters from ``ONNX_SEED``) under
    ``build/`` with "vocal" in its name and reads it back (every op
    supported, input [None, 4, 3072, 256]); holds the executor against the
    ``ConvTDFNetTrim`` it was written from on one [1, 4, 3072, 256] input
    (``ONNX_NET_RTOL_F32`` of the net's scale with cuDNN's TF32 off,
    ``ONNX_NET_RTOL_SERVED`` at the process's flags) and runs one more
    forward under ``torch.cuda.set_sync_debug_mode("error")``; then serves
    it (``enhanced_separation.backend: onnx``, the config's dim_f 2048
    overruled by the file) through ``separate_and_segment()`` with no mode,
    cold then warm, and ``mode="vocal_separation"`` once: backend onnx on
    cuda, 11 windows in 6 pieces, K1 at the rows ``expected_pass(...,
    "onnx", ...)`` computes (5 at [4, 256, 6144] and 1 at [2, 256, 6144] a
    call, recorded at each launch), K2 1 a v2.2_mdd call and 0 in
    vocal_separation, K0 once in the phase, the device stems summing to the
    mix within ``ONNX_SUM_RTOL`` of the vocal's scale, the exact splice (one
    segment allowed: the weights are seeded), each call's wall, audio-s per
    wall-s and peak memory printed; one model window through
    ``separate_windows`` card against CPU (plain K1) at SNR >=
    ``ONNX_SNR_DB`` with the TF32 flags printed beside it; and one more warm
    call profiled, with the separation's launches per forward;
14. holds K1W (``csrc/ola.cu``, the window's gradient: one launch that
    reduces the rows across a thread-block cluster) at its edge shapes
    (``K1W_EDGE_SHAPES`` of ``audio_cut_tpu_torch/testing.py``, which the
    card tests share: one frame, fewer rows than its cluster, rows its
    cluster does not divide, a ragged column tile, the scalar path by hop and
    by alignment), checks that a trainable window through ``windowed_ola``
    launches K1W once with the same bits as a direct call, and times K1W at
    ``K1W_TIMED_SHAPES`` beside its plain version, the one-call
    ``torch.einsum`` yardstick (and ``F.fold``'s autograd at the training
    shape) and its bound. It runs after the main path and training, so that
    the cuBLAS workspace the ``torch.einsum`` yardstick leaves allocated is
    not counted in their peak memory. Its two other checks run right after
    4, before any serving phase (``check_k1w_profile``): two launches give
    the same bits, and one profiled call runs one device kernel;
15. prints a ``kernels`` JSON line (K1's launches are the two v2.2_mdd
    calls'; its entry also lists its times at every timed shape under
    ``shapes``, the piece's first, K2's at the
    bundle's grid and librosa_onset's; under ``paths`` K1's launches and
    shapes in the shifts phase's two calls, in the batch and in the ONNX
    phase, and K2's in the batch, the WaveUNet phase and the ONNX phase)
    and, last,
    ``{"ok": true, "device": ...}``.

Every phase that fails raises, so the script exits non-zero and prints no
result. It needs no network and writes only under ``build/`` in the checkout
(and the kernels' build directory, ``audio_cut_tpu_torch/_build/``).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
SR = 44100
SONG_S = 60.0
CHORUS_S = 40.0  # the vpbd phase's song is loud from here on: 10 of its 30 bars
CALLS = 2
KERNEL_SOURCES = ("probe", "ola", "frame_stats")
# K1W against the plain backward, per column c: |kernel - plain| <= rtol *
# sum_{b,i} |g * frames|. Both sum the same float32 products in another order
# (K1W: rows in order within a lane, the lanes of a block, then the ranks of
# a cluster, against torch's reduction), which moves a sum of n terms by at
# most about n * 6e-8 of that scale and typically sqrt(n) * 6e-8; n is at
# most 1024 here.
OLA_BWD_RTOL = 1e-5
# the training shape of ConvTDF-large at batch 4: [B, dim_t, n_fft], hop;
# and a hop that is no multiple of 4, for the backward kernels' scalar path
TRAIN_OLA_SHAPE = (4, 128, 6144, 1024)
SCALAR_OLA_SHAPE = (2, 7, 90, 30)
# profiler sessions of one K1W call, while a session records no device kernel
K1W_PROFILE_TRIES = 3
# K1W timed at the training shape and the largest of OLA_SHAPES (1,024 rows)
K1W_TIMED_SHAPES = [TRAIN_OLA_SHAPE, (4, 256, 6144, 1024)]
TRAIN_STEPS = 20
TRAIN_BATCH = 4
TRAIN_EVAL_PAIRS = 2
# the card's float32 train step against the CPU's. cuDNN runs the card's
# float32 convolutions in TF32 (torch's default, which the port leaves
# alone): a 10-bit mantissa, about 5e-4 relative per product. Sums of many
# such products average it down, so the loss and the global gradient norm
# agree to about 1e-4 (held at 2e-3) and each leaf's gradient keeps its
# direction (held at cosine 0.999), not its bits.
STEP_RTOL = 2e-3
STEP_MIN_COS = 0.999
PARITY_SNR_DB = 30.0
# (batch or None, n_frames, frame_len, hop): the serving shape first (a piece
# of 2 windows), then the last piece of a 60 s track (11 windows in pieces of
# 2, ..., 2, 1), the whole-track path's groups (4, 4, 3: pipelined_upload
# off), then two others. K1 is held at these and at every shape of
# ``testing.K1_SHAPES``; the backward kernels at these.
OLA_SHAPES = [(2, 256, 6144, 1024), (1, 256, 6144, 1024), (4, 256, 6144, 1024),
              (3, 256, 6144, 1024), (None, 21, 512, 128), (3, 13, 256, 64)]
# K1's timed inputs: at least this many sets, and together more than the L2
K1_TIMED_SETS = 4
L2_BYTES = 50e6  # H100 SXM, NVIDIA's data sheet
# (frames, bins): the feature grid of a 60 s song first (n_fft 2048, hop 2205),
# then of a 3-minute song, the JAX package's edge shape and a single frame;
# then edges: one more frame than an H100 has SMs (133) and fewer (50),
# 1024 bins (every row 16 B aligned, each thread 4 bins), rows narrower than
# a warp (3 bins, 1 bin); last the grid librosa_onset gives it on a 60 s song
# (hop 512 over the 60 s bucket)
K2_SHAPES = [(1201, 1025), (3601, 1025), (257, 129), (1, 1025),
             (133, 1025), (50, 1025), (300, 1024), (77, 3), (64, 1), (5168, 1025)]
# K2 timed at the bundle's grid and at librosa_onset's
K2_TIMED_SHAPES = [K2_SHAPES[0], K2_SHAPES[-1]]
K0_TURNS = 12  # rounds of (torch.mul, K0, K0, torch.mul), one timed graph replay each
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
VPBD_CALLS = 2  # vpbd_acoustic calls in the vpbd phase, then one vpbd_asr call
HYBRID_CASES = (("snap_to_beat", {}), ("beat_only", {"hybrid_mdd.lib_alignment": "beat_only"}))
# the hybrid phase's second song: silent rests on the beat grid from here on
# (song_chorus's loud bed leaks into the vocal stem, so no beat there is quiet)
STOP_TIME_S = 40.0
SPANS = ("load", "separation", "detection_bundle", "host_tail", "export")
STEP_SPANS = ("upload", "loss", "backward", "optimizer", "metrics")
# the spectral phase: the backend override, and the least SNR of the card's
# vocal against the CPU's on one group of windows (float32 throughout, the
# medians exact selections)
SPECTRAL = {"enhanced_separation.backend": "spectral"}
SPECTRAL_SNR_DB = 60.0
# the median network's elementwise kernels in a profile of a spectral call
MEDIAN_KERNELS = ("minimum", "maximum")
# the librosa_onset phase: its exports, and the voice's start in the song
# with a beat-only intro (the music-label call)
LIBROSA_EXPORTS = ("mix_segments", "vocal_segments")
INTRO_S = 8.0
# the legacy phase: the multi-feature detector's switch; YIN and LPC on the
# card against the CPU (cuFFT and the CPU's FFT round differently, which may
# flip a frame across YIN's 0.15 dip rule or the Viterbi's choice of bin);
# a pause's confidence moves by at most f0_weight (0.3) / 20 frames x the
# MDD multiplier's 1.4 when one 10 ms frame of the shortest (0.2 s) pause
# flips across the voicing threshold
LEGACY = {"v2_mdd.pure_vocal_detection.enable_relative_energy_mode": False}
# for comparison only (printed, not held): the textbook bound of librosa_onset's
# STFT (n_fft 2048) on the card against the CPU's, per frame, ||card - CPU||_2
# <= STFT_REL * ||X||_2, if each side's float32 FFT were radix-2 with exact
# twiddles: log2(n) * eta each, eta = u + gamma_4 (sqrt(2) + u), about
# (1 + 4 sqrt(2)) u (Higham, Accuracy and Stability of Numerical Algorithms,
# 2nd ed., Theorem 24.2), and u each for the window and its product
STFT_REL = (2 * 11 * (1 + 4 * 2 ** 0.5) + 4) * 2.0 ** -24
VOICING_ATOL = 1e-3
F0_HZ, F0_MIN_SHARE = 0.5, 0.995
LEGACY_CONF_ATOL = 0.3 / 20 * 1.4
WALLS = {}  # label -> wall seconds of the calls that later phases print beside theirs
SPAN_LAUNCHES = {}  # (profiled call, span) -> the kernel launches inside the span
# the whole-track phase (the piece upload off) and the YAML-config phase
# (``$AUDIO_CUT_TPU_CONFIG`` names a file that widens the pieces to 3 windows)
UNPIPELINED = {"device_pipeline.pipelined_upload": False}
YAML_PIECES = {"device_pipeline.piece_windows": 3}
# the whole-track call's stems against the pipelined warm call's: bfloat16
# convolutions round differently at batch 4 than at batch 2 (the CPU test's
# measure: vocal 56.5 dB, instrumental 34.6 dB, max |diff| 2.1e-3); the mix
# is equal bit for bit
PIECE_SNR_DB = {"vocal": 40.0, "instrumental": 30.0}
PIECE_ATOL = 1e-2
# the shifts phase: shift averaging at 2 sub-hop offsets on the main path
SHIFTS = {"enhanced_separation.convtdf.shifts": 2}
# the batch phase's third track: the 45 s bucket, 8 model windows
BATCH_SHORT_S = 40.0
# the batch's stems against single engine runs (max |diff|)
BATCH_STEM_ATOL = 1e-5
# the shell phase: quick_start's scripted answers (the first file, split,
# density, alignment: vpbd_asr's intent), and the subprocesses' time limits
QUICK_START_ANSWERS = ("1", "split", "medium", "balanced")
WARMUP_TIMEOUT_S = 480
FIRST_TRACK_TIMEOUT_S = 240
# the WaveUNet phase: the served checkpoint comes from the trainer, which
# refuses to save below min(50, steps) steps, so 20 steps save
WAVEUNET_STEPS = 20
WAVEUNET_GROUP_SNR_DB = 30.0  # one map group of 4 windows, card bf16 vs CPU f32
WAVEUNET_SUM_ATOL = 1e-5  # |vocal + instrumental - mix| on the card: float32 sums of the OLA
# the ONNX phase: the Kim_Vocal_1-geometry graph (testing.KIM_VOCAL_1) at its
# published width, its weights from this seed
ONNX_SEED = 0
ONNX_PARAMS = 16_701_760  # ConvTDFNetTrim's parameters at KIM_VOCAL_1
# the executor against the torch net it was written from, on the card: max
# |diff| over max |net|, in float32 (cuDNN's TF32 off for the check: the JAX
# package's CPU bound) and at the process's flags, as served
ONNX_NET_RTOL_F32 = 1e-4
ONNX_NET_RTOL_SERVED = 1e-2
ONNX_SNR_DB = 30.0  # one model window, card against CPU
ONNX_SUM_RTOL = 1e-5  # |vocal + instrumental - mix| over max(1, max |vocal|), on the card
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOPS = 67e12          # float32 outside the tensor cores, the same sheet


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_song(duration_s: float, sr: int = SR, seed: int = 7, chorus_s: Optional[float] = None,
              stop_time_s: Optional[float] = None, phrases: Optional[list] = None,
              intro_s: float = 0.0):
    """Synthetic song: harmonic vocal-like phrases over a percussive bed,
    with quiet gaps (the generator of the repository's tests). With
    ``chorus_s``, the bed is three times as loud from that time on and
    carries a sustained chord: a high-energy section of whole bars, where
    the vpbd pool's chorus-gated beat candidates fall. With ``stop_time_s``,
    the bed stops from that time on and the voice, three times as loud,
    sings 1.8 s phrases that start on the beat grid, 3 s apart: a
    high-energy section whose rests are silent and hold two beats, the
    first 0.2 s after the phrase's end, where hybrid_mdd's snap to a quiet
    beat can take effect. The voice starts at ``intro_s``: before it the
    song is the beat alone. A ``phrases`` list receives each voice phrase's
    (start, end) in seconds."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(duration_s * sr)
    t = np.arange(n, dtype=np.float64) / sr
    audio = np.zeros(n, dtype=np.float64)
    for beat in np.arange(0.0, duration_s if stop_time_s is None else stop_time_s, 0.5):
        i = int(beat * sr)
        env = np.exp(-np.arange(min(2000, n - i)) / 300.0)
        audio[i:i + env.size] += 0.12 * env * rng.standard_normal(env.size)
    if chorus_s is not None:
        loud = t >= chorus_s
        audio[loud] *= 3.0
        audio[loud] += 0.2 * sum(np.sin(2 * np.pi * f * t[loud]) for f in (110.0, 138.6, 164.8))
    phrase = float(intro_s)
    while phrase + 2.5 < duration_s:
        sung = stop_time_s is not None and phrase >= stop_time_s
        length = 1.8 if sung else 2.2
        seg = (t >= phrase) & (t < phrase + length)
        f0 = 220.0 * (1 + 0.01 * np.sin(2 * np.pi * 5.5 * t[seg]))
        x = np.zeros(seg.sum())
        for h in range(1, 5):
            x += np.sin(2 * np.pi * h * np.cumsum(f0) / sr) / h
        fade = np.minimum(1.0, np.minimum(np.arange(seg.sum()) / (0.05 * sr),
                                          (seg.sum() - np.arange(seg.sum())) / (0.05 * sr)))
        audio[seg] += 0.35 * x * fade * (3.0 if sung else 1.0)
        if phrases is not None:
            phrases.append((float(phrase), float(phrase + length)))
        if sung:
            phrase += 3.0
            continue
        phrase = phrase + 2.2 + 0.8 + 0.4 * rng.random()
        if stop_time_s is not None and phrase >= stop_time_s:
            phrase = float(np.ceil(phrase * 2.0)) / 2.0  # the first sung phrase starts on a beat
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


def _graph(fn, iters: int, stream=None):
    """``iters`` calls of ``fn`` captured in one CUDA graph, replayed once."""
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def device_ms(fn, iters: int = 100, repeats: int = 5, warmup_s: float = 0.3,
              stream=None) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one CUDA
    graph, the replay timed with CUDA events, median of ``repeats`` over
    ``iters``. The replay launches back to back, so no host work (Python,
    allocation, the launch call) sits between the kernels. ``stream``: the
    stream to capture on (an autograd backward runs on its forward's stream)."""
    _warm_up(fn, warmup_s)
    return _event_ms(_graph(fn, iters, stream).replay, repeats) / iters


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


def ptxas_lines(log: str) -> list:
    """Each kernel's registers and spills from ptxas's ``-v`` report in a
    build's nvcc output, its name demangled with ``cu++filt``."""
    import re

    from audio_cut_tpu_torch.ops.cuda import find_nvcc

    kernels, name, spills = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and name is not None:
            kernels.append((name, f"{line.split(':', 1)[1].strip()}; {spills}"))
            name = None
    cufilt = Path(find_nvcc()).parent / "cu++filt"
    if kernels and cufilt.exists():
        names = subprocess.run([str(cufilt)], input="\n".join(k for k, _ in kernels),
                               capture_output=True, text=True, timeout=60).stdout.split("\n")
        kernels = [(d or k, r) for (k, r), d in zip(kernels, names)]
    return [f"{k}: {r}" for k, r in kernels]


def build_kernels():
    """Build every csrc/*.cu with nvcc, one process per source, all started
    together; print each build's time and each kernel's registers and spills."""
    from concurrent.futures import ThreadPoolExecutor

    from audio_cut_tpu_torch.ops.cuda import BUILD_LOGS, build_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNEL_SOURCES)) as pool:
        secs = list(pool.map(build_library, KERNEL_SOURCES))
    for name, sec in zip(KERNEL_SOURCES, secs):
        print(f"kernel build: {name}.cu {sec:.3f} s (nvcc, sm_90a)")
    print(f"kernel build: all {len(secs)} in parallel, {time.perf_counter() - t0:.3f} s wall")
    for name in KERNEL_SOURCES:
        for line in ptxas_lines(BUILD_LOGS.get(name, "")):
            print(f"ptxas {name}.cu: {line}")


def _rotating(tensors):
    """A callable that returns the next of ``tensors`` on each call."""
    it = {"k": 0}

    def nxt():
        it["k"] = (it["k"] + 1) % len(tensors)
        return tensors[it["k"]]

    return nxt


def check_k0(torch, dev):
    """K0: the first kernel launch of the process runs the library check
    (K0 once, its result equal to x * 2); then K0's device time, in turns
    with torch.mul's."""
    import statistics

    from audio_cut_tpu_torch.ops.cuda import LIBRARY_CHECK, PROBE_SHAPE, K0, probe_cuda
    from audio_cut_tpu_torch.ops.ola import K1, windowed_ola_cuda
    from audio_cut_tpu_torch.ops.stft import hann_window

    if K0.launches or K1.launches or LIBRARY_CHECK:
        fail("a kernel launched before the first kernel launch of the process")
    # the first launch of any kernel: K1 on one small frame matrix
    windowed_ola_cuda(torch.ones((2, 512), device=dev), hann_window(512, device=dev), 128)
    torch.cuda.synchronize()
    err = LIBRARY_CHECK.get(dev.index)
    print(f"K0 library check at the first kernel launch: K0 launches {K0.launches}, K1 launches "
          f"{K1.launches}, passed on cards {sorted(LIBRARY_CHECK)}, max |K0 - x * 2| = {err}")
    if K0.launches != 1 or K1.launches != 1 or sorted(LIBRARY_CHECK) != [dev.index]:
        fail("the first kernel launch did not run the library check (K0) exactly once")
    if err != 0.0:
        fail(f"K0 is off x * 2 by {err}")
    x = torch.randn(PROBE_SHAPE, device=dev)
    moved = 2 * x.numel() * 4
    # K0 and the one PyTorch call that computes x * 2, torch.mul, in turns:
    # each a graph of 100 calls, replayed mul, K0, K0, mul, K0_TURNS times
    kernel, mul = (lambda: probe_cuda(x)), (lambda: torch.mul(x, 2.0))
    _warm_up(lambda: (kernel(), mul()), 0.3)
    graphs = {"K0": _graph(kernel, 100), "torch.mul": _graph(mul, 100)}
    times = {"K0": [], "torch.mul": []}
    for _ in range(K0_TURNS):
        for key in ("torch.mul", "K0", "K0", "torch.mul"):
            times[key].append(_event_ms(graphs[key].replay, 1) / 100)
    timing = {
        "ms": statistics.median(times["K0"]),
        "plain_ms": device_ms(lambda: x * 2.0),
        "library_ms": statistics.median(times["torch.mul"]),
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
        "max_abs_err": err,
    }
    for key, ts in times.items():
        q = statistics.quantiles(ts, n=4)
        print(f"K0 {PROBE_SHAPE} in turns with torch.mul: {key} median {statistics.median(ts):.5f} "
              f"ms, quartiles {q[0]:.5f}-{q[2]:.5f}, range {min(ts):.5f}-{max(ts):.5f} ms "
              f"({len(ts)} replays of 100 calls)")
    print(f"K0 {PROBE_SHAPE}, device time per call: kernel {timing['ms']:.5f} ms, torch.mul "
          f"{timing['library_ms']:.5f} ms (medians in turns), plain x * 2.0 {timing['plain_ms']:.5f} "
          f"ms (CUDA graph replay of 100 calls, median of 5); bound {timing['bound_ms']:.7f} ms "
          f"({moved} bytes at {HBM_BYTES_PER_S:.3e} B/s)")
    return timing


def time_k1(torch, dev, shape, hop: int, label: str):
    """K1's device time at ``shape`` [B, N, L] and ``hop`` beside its plain
    version, ``F.fold`` and its bound; the wrapper's time per Python call
    printed apart."""
    import math

    import torch.nn.functional as F

    from audio_cut_tpu_torch.ops.ola import windowed_ola_cuda, windowed_ola_reference
    from audio_cut_tpu_torch.ops.stft import hann_window

    batch, n, L = shape
    total = (n - 1) * hop + L
    window = hann_window(L, device=dev)
    # rotate over K1_TIMED_SETS input sets, more where they would fit the L2
    # together, so every launch reads its frames from device memory
    count = max(K1_TIMED_SETS, math.ceil(L2_BYTES / (batch * n * L * 4)))
    sets = [torch.randn(shape, device=dev) for _ in range(count)]
    nxt = _rotating(sets)

    def fold(x):
        return F.fold((x * window).transpose(1, 2), output_size=(1, total),
                      kernel_size=(1, L), stride=(1, hop))

    lib = fold(sets[0]).reshape(batch, total)
    ref = windowed_ola_reference(sets[0], window, hop)
    lib_err = float((lib - ref).abs().max())
    print(f"K1 {label} {tuple(shape)} hop {hop}: library yardstick F.fold(frames * window): "
          f"max |fold - plain| = {lib_err:.3e}")
    moved = (batch * n * L + L + batch * total) * 4
    bound = moved / HBM_BYTES_PER_S * 1e3
    kernel = lambda: windowed_ola_cuda(nxt(), window, hop)  # noqa: E731
    plain = lambda: windowed_ola_reference(nxt(), window, hop)  # noqa: E731
    # device times (CUDA graph replay) for the kernels line; the wrapper's
    # time per Python call beside it, labelled apart
    timing = {
        "ms": device_ms(kernel),
        "plain_ms": device_ms(plain),
        "library_ms": device_ms(lambda: fold(nxt())),
        "bound_ms": bound,
    }
    wrapper_ms = call_ms(kernel)
    print(f"K1 {label} {tuple(shape)} hop {hop}, device time per call (CUDA graph "
          f"replay of 100 calls, median of 5, {count} input sets): kernel {timing['ms']:.4f} ms, "
          f"plain {timing['plain_ms']:.4f} ms, F.fold {timing['library_ms']:.4f} ms; "
          f"bound {bound:.4f} ms ({moved} bytes at {HBM_BYTES_PER_S:.3e} B/s), "
          f"{bound / timing['ms']:.3f} of it")
    print(f"K1 {label}: wrapper called from Python 100 times in a row, "
          f"{wrapper_ms:.4f} ms per call (CUDA events; includes the host's launch rate)")
    return timing


def k1_error(torch, dev, shape, hop: int, offset: int = 0) -> float:
    """max |K1 - plain| on seeded frames of ``shape``, ``offset`` floats off
    their storage's start; fails unless the two are equal bit for bit and K1
    launched once."""
    from audio_cut_tpu_torch.ops.ola import K1, windowed_ola_cuda, windowed_ola_reference
    from audio_cut_tpu_torch.ops.stft import hann_window
    from audio_cut_tpu_torch.testing import k1_inputs

    n, L = shape[-2:]
    frames = k1_inputs(shape, n + L, dev, offset)
    window = hann_window(L, device=dev)
    before = K1.launches
    got = windowed_ola_cuda(frames, window, hop)
    want = windowed_ola_reference(frames, window, hop)
    torch.cuda.synchronize()
    same = got.shape == want.shape and torch.equal(got, want)
    err = float((got - want).abs().max()) if got.shape == want.shape else float("inf")
    print(f"K1 {shape} hop {hop}, offset {4 * offset} B: max |kernel - plain| = {err:.3e}, "
          f"equal: {same}")
    if not same or K1.launches != before + 1:
        fail(f"K1 differs from its plain version at {shape} hop {hop}, offset {offset}: {err}")
    return err


def check_k1(torch, dev):
    """K1 equal to its plain version at OLA_SHAPES, at every path shape
    (``K1_SHAPES``) and at its edges (``K1_EDGE_SHAPES``); timed at each path
    shape but the spectral piece's, which the spectral phase times at the
    shape its path gives. Returns the largest |K1 - plain| and the timings,
    each with its shape and hop, the serving shape's first."""
    from audio_cut_tpu_torch.testing import K1_EDGE_SHAPES, K1_SHAPES, k1_edge_holds

    max_err = 0.0
    shapes = OLA_SHAPES + [(b, n, L, hop) for _, b, n, L, hop in K1_SHAPES
                           if (b, n, L, hop) not in OLA_SHAPES]
    for batch, n, L, hop in shapes:
        max_err = max(max_err, k1_error(torch, dev, (n, L) if batch is None else (batch, n, L), hop))
    for edge, batch, n, L, hop, offset in K1_EDGE_SHAPES:
        if not k1_edge_holds(edge, batch, n, L, hop, offset):
            fail(f"K1 edge {edge!r} is not that edge at ({batch}, {n}, {L}) hop {hop}")
        print(f"K1 edge, {edge}:")
        max_err = max(max_err, k1_error(torch, dev, (batch, n, L), hop, offset))
    timings = []
    for what, batch, n, L, hop in K1_SHAPES:
        if what != "a spectral piece":
            timing = time_k1(torch, dev, (batch, n, L), hop, what)
            timings.append({"shape": [batch, n, L], "hop": hop, "max_abs_err": max_err, **timing})
    return max_err, timings


def _fold_backward(torch, frames, window, hop, wrt):
    """The library yardstick: autograd's backward of ``F.fold(frames *
    window)``, the call ``check_k1`` times for the forward, with respect to
    the inputs named in ``wrt`` ("frames", "window"). The forward runs once
    on a side stream; ``call(g)`` is ``torch.autograd.grad`` of it for the
    cotangent ``g``. Returns (call, stream to capture it on)."""
    import torch.nn.functional as F

    b, n, L = frames.shape
    total = (n - 1) * hop + L
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        f = frames.detach().clone().requires_grad_("frames" in wrt)
        w = window.detach().clone().requires_grad_("window" in wrt)
        y = F.fold((f * w).transpose(1, 2), output_size=(1, total), kernel_size=(1, L),
                   stride=(1, hop))
    torch.cuda.current_stream().wait_stream(stream)
    inputs = tuple(t for name, t in (("frames", f), ("window", w)) if name in wrt)

    def call(g):
        return torch.autograd.grad(y, inputs, grad_outputs=g.view(y.shape), retain_graph=True)

    return call, stream


def check_k1_backward(torch, dev):
    """K1B and K1W against the plain backward at OLA_SHAPES and the training
    shape; autograd through the iSTFT on the card against the CPU; device
    times at the training shape: K1B alone, and K1B with K1W. Returns K1B's
    timing, K1W's largest error and the timing of both."""
    import numpy as np

    from audio_cut_tpu_torch.ops.ola import (
        K1B, K1W, ola_backward_frames_cuda, ola_backward_window_cuda,
        windowed_ola_backward_reference)
    from audio_cut_tpu_torch.ops.stft import frame_signal, hann_window, istft

    max_err = 0.0  # K1B's (held to 0.0)
    max_err_w = 0.0  # K1W's (held per column to OLA_BWD_RTOL)
    for batch, n, L, hop in OLA_SHAPES + [TRAIN_OLA_SHAPE, SCALAR_OLA_SHAPE]:
        shape = (n, L) if batch is None else (batch, n, L)
        total = (n - 1) * hop + L
        rng = np.random.default_rng(n + L + 1)
        frames = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
        g = torch.from_numpy(rng.standard_normal(shape[:-2] + (total,)).astype(np.float32)).to(dev)
        window = hann_window(L, device=dev)
        b0, w0 = K1B.launches, K1W.launches
        got_f = ola_backward_frames_cuda(g, frames.shape, window, hop)
        got_w = ola_backward_window_cuda(g, frames, window, hop)
        want_f, want_w = windowed_ola_backward_reference(g, frames, window, hop)
        g_raw = frame_signal(g, L, hop, center=False)[..., :n, :]
        scale = (g_raw * frames).abs().sum(dim=tuple(range(g_raw.ndim - 1)))
        torch.cuda.synchronize()
        err_f = float((got_f - want_f).abs().max())
        err_w = float((got_w - want_w).abs().max())
        worst = float(((got_w - want_w).abs() / scale.clamp_min(1e-30)).max())
        print(f"K1 backward {shape} hop {hop}: g_frames max |kernel - plain| = {err_f:.3e} "
              f"(exact); g_window max |kernel - plain| = {err_w:.3e}, at most {worst:.3e} of "
              f"sum |g * frames| (rtol {OLA_BWD_RTOL})")
        if got_f.shape != want_f.shape or err_f != 0.0:
            fail(f"K1B disagrees with the plain backward at {shape} hop {hop}: {err_f}")
        if got_w.shape != want_w.shape or not worst <= OLA_BWD_RTOL:
            fail(f"K1W disagrees with the plain backward at {shape} hop {hop}: {worst}")
        if K1B.launches != b0 + 1 or K1W.launches != w0 + 1:
            fail("the K1 backward wrappers did not count one launch each")
        max_err = max(max_err, err_f)
        max_err_w = max(max_err_w, err_w)

    # autograd through the iSTFT on the card launches K1B (not K1W: the
    # window is a constant) and gives the CPU's gradient
    rng = np.random.default_rng(3)
    spec_np = (rng.standard_normal((2, 40, 513)) + 1j * rng.standard_normal((2, 40, 513)))
    weight_np = rng.standard_normal((2, 39 * 256)).astype(np.float32)
    grads = {}
    b0, w0 = K1B.launches, K1W.launches
    for side in ("card", "cpu"):
        d = dev if side == "card" else torch.device("cpu")
        spec = torch.from_numpy(spec_np.astype(np.complex64)).to(d).requires_grad_(True)
        out = istft(spec, n_fft=1024, hop=256, length=39 * 256)
        (out * torch.from_numpy(weight_np).to(d)).sum().backward()
        grads[side] = spec.grad.cpu()
    err = float((grads["card"] - grads["cpu"]).abs().max())
    ref = float(grads["cpu"].abs().max())
    print(f"K1 backward through istft (2, 40, 513), n_fft 1024 hop 256: K1B launches "
          f"{K1B.launches - b0}, K1W launches {K1W.launches - w0}; max |card - CPU| of the "
          f"gradient = {err:.3e} (bound 1e-5 * max |CPU| = {1e-5 * ref:.3e})")
    if K1B.launches - b0 != 1 or K1W.launches != w0:
        fail("autograd through the iSTFT on the card did not launch K1B once (and K1W never)")
    if not err <= 1e-5 * ref:
        fail(f"the iSTFT gradient on the card disagrees with the CPU's: {err}")

    # device times at the training shape; inputs rotate over > 50 MB (the L2)
    batch, n, L, hop = TRAIN_OLA_SHAPE
    total = (n - 1) * hop + L
    window = hann_window(L, device=dev)
    gs = [torch.randn((batch, total), device=dev) for _ in range(28)]        # 61 MB
    fs = [torch.randn((batch, n, L), device=dev) for _ in range(4)]          # 50 MB + gs
    next_g, next_f = _rotating(gs), _rotating(fs)
    shape = (batch, n, L)
    g_bytes, f_bytes, w_bytes = batch * total * 4, batch * n * L * 4, L * 4
    frames_moved = g_bytes + w_bytes + f_bytes                  # read g, window; write g_frames
    both_moved = g_bytes + f_bytes + w_bytes + f_bytes + w_bytes  # ... and read frames; write g_window

    def plain_frames():
        return frame_signal(next_g(), L, hop, center=False)[..., :n, :] * window

    lib_frames, lib_frames_stream = _fold_backward(torch, fs[0], window, hop, ("frames",))
    lib_both, lib_both_stream = _fold_backward(torch, fs[0], window, hop, ("frames", "window"))
    check = lib_both(gs[0])
    want = windowed_ola_backward_reference(gs[0], fs[0], window, hop)
    print(f"K1 backward library yardstick (autograd of F.fold(frames * window)): max |fold - "
          f"plain| g_frames {float((check[0] - want[0]).abs().max()):.3e}, g_window "
          f"{float((check[1] - want[1]).abs().max()):.3e}")

    def kernel_both():
        gg = next_g()
        return (ola_backward_frames_cuda(gg, shape, window, hop),
                ola_backward_window_cuda(gg, next_f(), window, hop))

    timing = {
        "ms": device_ms(lambda: ola_backward_frames_cuda(next_g(), shape, window, hop)),
        "plain_ms": device_ms(plain_frames),
        "library_ms": device_ms(lambda: lib_frames(next_g()), stream=lib_frames_stream),
        "bound_ms": frames_moved / HBM_BYTES_PER_S * 1e3,
        "max_abs_err": max_err,
    }
    both = {
        "ms": device_ms(kernel_both),
        "plain_ms": device_ms(lambda: windowed_ola_backward_reference(next_g(), next_f(), window,
                                                                     hop)),
        "library_ms": device_ms(lambda: lib_both(next_g()), stream=lib_both_stream),
        "bound_ms": both_moved / HBM_BYTES_PER_S * 1e3,
    }
    print(f"K1 backward, training shape {shape} hop {hop}, device time per call (CUDA graph "
          f"replay of 100 calls, median of 5): g_frames (K1B): kernel {timing['ms']:.4f} ms, plain "
          f"{timing['plain_ms']:.4f} ms, F.fold backward {timing['library_ms']:.4f} ms; bound "
          f"{timing['bound_ms']:.5f} ms ({frames_moved} bytes at {HBM_BYTES_PER_S:.3e} B/s)")
    print(f"K1 backward, training shape: g_frames and g_window (K1B + K1W): kernels "
          f"{both['ms']:.4f} ms, plain {both['plain_ms']:.4f} ms, F.fold backward "
          f"{both['library_ms']:.4f} ms; bound {both['bound_ms']:.5f} ms ({both_moved} bytes)")
    return timing, max_err_w, both


def check_k1w_profile(torch, dev) -> None:
    """K1W at the training shape: two launches give the same bits, and one
    profiled call runs one device kernel. It runs before the serving phases:
    in a process that has already profiled the serving calls and a train
    step, this short session often records nothing on the card; run first,
    it records the kernel."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from audio_cut_tpu_torch.ops.ola import ola_backward_window_cuda
    from audio_cut_tpu_torch.ops.stft import hann_window
    from audio_cut_tpu_torch.testing import k1w_inputs

    batch, n, L, hop = TRAIN_OLA_SHAPE
    frames, g = k1w_inputs((batch, n, L), hop, 17, dev)
    window = hann_window(L, device=dev)
    first = ola_backward_window_cuda(g, frames, window, hop)
    second = ola_backward_window_cuda(g, frames, window, hop)
    torch.cuda.synchronize()
    print(f"K1W {tuple(frames.shape)}: two launches give the same bits: {torch.equal(first, second)}")
    if not torch.equal(first, second):
        fail("two K1W launches on the same inputs differ")

    # one warm-up step before the recorded one: a short session's first
    # kernels can go unrecorded while the tracer starts (runs that profiled
    # this one call alone have recorded no kernel at all). A session that
    # records nothing on the card says nothing of the call, which ran (its
    # bits were checked above): it is profiled again, at most
    # K1W_PROFILE_TRIES times; any other count or kernel fails at once
    for attempt in range(K1W_PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                ola_backward_window_cuda(g, frames, window, hop)
                torch.cuda.synchronize()
                prof.step()
        # the step's own range also shows on the card's timeline: not a kernel
        on_card = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith("ProfilerStep")]
        print(f"K1W profiled call (session {attempt + 1}): {len(on_card)} device kernel(s): "
              f"{on_card}")
        if on_card:
            break
    if len(on_card) != 1 or "ola_backward_window_kernel" not in on_card[0]:
        fail(f"one K1W call ran {on_card} on the card, not one K1W kernel")


def check_k1w(torch, dev):
    """K1W at its edge shapes and on an unaligned view, one launch through
    autograd with a trainable window (the same bits as a direct call);
    device times at K1W_TIMED_SHAPES. Returns (largest |K1W - plain|, the
    training shape's timing)."""
    from audio_cut_tpu_torch.ops.ola import (
        K1B, K1W, ola_backward_window_cuda, window_plan, windowed_ola,
        windowed_ola_backward_reference)
    from audio_cut_tpu_torch.ops.stft import hann_window
    from audio_cut_tpu_torch.testing import (
        K1W_EDGE_SHAPES, k1w_edge_holds, k1w_error, k1w_inputs)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    max_err = 0.0
    for edge, batch, n, L, hop, offset in K1W_EDGE_SHAPES:
        plan = window_plan(batch * n, L, sms)
        premise = k1w_edge_holds(edge, batch, n, L, hop, offset, plan)
        frames, g = k1w_inputs((batch, n, L), hop, n + L, dev, offset)
        w0 = K1W.launches
        got = ola_backward_window_cuda(g, frames, hann_window(L, device=dev), hop)
        err, worst = k1w_error(got, g, frames, hop)
        print(f"K1W edge, {edge}: ({batch}, {n}, {L}) hop {hop}, offset {4 * offset} B, {plan}: "
              f"max |kernel - plain| = {err:.3e}, at most {worst:.3e} of sum |g * frames| "
              f"(rtol {OLA_BWD_RTOL})")
        if not premise:
            fail(f"K1W edge {edge!r} is not one under the plan {plan}")
        if not worst <= OLA_BWD_RTOL or K1W.launches != w0 + 1:
            fail(f"K1W disagrees with the plain backward at the edge {edge!r}: {worst}")
        max_err = max(max_err, err)

    batch, n, L, hop = TRAIN_OLA_SHAPE
    frames, g = k1w_inputs((batch, n, L), hop, 17, dev)
    window = hann_window(L, device=dev)
    first = ola_backward_window_cuda(g, frames, window, hop)
    trainable = window.clone().requires_grad_(True)
    b0, w0 = K1B.launches, K1W.launches
    windowed_ola(frames, trainable, hop).backward(g)
    torch.cuda.synchronize()
    same = torch.equal(trainable.grad, first)
    print(f"K1W through windowed_ola with a trainable window: K1W launches {K1W.launches - w0}, "
          f"K1B launches {K1B.launches - b0}; the gradient equals a direct call's bits: {same}")
    if K1W.launches - w0 != 1 or K1B.launches != b0 or not same:
        fail("autograd with a trainable window did not launch K1W once, with its bits")

    plan = window_plan(batch * n, L, sms)
    print(f"K1W plan at the training shape on {sms} SMs: {plan}: {plan.blocks} blocks of "
          f"{plan.threads} threads, {plan.rows_per_rank} rows a rank")

    timing = None
    for batch, n, L, hop in K1W_TIMED_SHAPES:
        total = (n - 1) * hop + L
        window = hann_window(L, device=dev)
        g_bytes, f_bytes, w_bytes = batch * total * 4, batch * n * L * 4, L * 4
        # inputs rotate over more than the 50 MB L2, each list on its own
        gs = [torch.randn((batch, total), device=dev) for _ in range(-(-60_000_000 // g_bytes))]
        fs = [torch.randn((batch, n, L), device=dev) for _ in range(-(-50_000_000 // f_bytes))]
        next_g, next_f = _rotating(gs), _rotating(fs)
        moved = g_bytes + f_bytes + w_bytes                     # read g, frames; write g_window
        ops = 2 * batch * n * L                                 # a multiply and an add a term

        def einsum(gg, ff):
            return torch.einsum("bnc,bnc->c", gg.unfold(-1, L, hop)[:, :n], ff)

        lib_err = float((einsum(gs[0], fs[0]) - windowed_ola_backward_reference(
            gs[0], fs[0], window, hop, want_frames=False)[1]).abs().max())
        t = {
            "ms": device_ms(lambda: ola_backward_window_cuda(next_g(), next_f(), window, hop)),
            "plain_ms": device_ms(lambda: windowed_ola_backward_reference(
                next_g(), next_f(), window, hop, want_frames=False)[1]),
            "library_ms": device_ms(lambda: einsum(next_g(), next_f())),
            "bound_ms": max(moved / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3,
            "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops / F32_FLOPS else "operations",
        }
        fold = ""
        if timing is None:  # the training shape: F.fold's autograd beside it, as for K1B
            lib_window, lib_stream = _fold_backward(torch, fs[0], window, hop, ("window",))
            t["fold_ms"] = device_ms(lambda: lib_window(next_g()), stream=lib_stream)
            fold = f", autograd of F.fold (window only) {t['fold_ms']:.4f} ms"
        print(f"K1W {(batch, n, L)} hop {hop}, device time per call (CUDA graph replay of 100 "
              f"calls, median of 5): kernel {t['ms']:.5f} ms, plain {t['plain_ms']:.4f} ms, "
              f"torch.einsum {t['library_ms']:.4f} ms (max |einsum - plain| {lib_err:.3e}){fold}; "
              f"bound {t['bound_ms']:.5f} ms ({moved} bytes at {HBM_BYTES_PER_S:.3e} B/s; {ops} "
              f"operations at {F32_FLOPS:.3e}/s; bound by {t['bound_by']}); share of the bound "
              f"{t['bound_ms'] / t['ms']:.3f}")
        if timing is None:
            timing = t
        del gs, fs
    wrapper_ms = call_ms(lambda: ola_backward_window_cuda(g, frames, hann_window(
        TRAIN_OLA_SHAPE[2], device=dev), TRAIN_OLA_SHAPE[3]))
    print(f"K1W training shape: wrapper called from Python 100 times in a row, {wrapper_ms:.4f} ms "
          f"per call (CUDA events; includes the host's launch rate)")
    return max_err, timing


def _k2_inputs(t: int, f: int, seed: int):
    import numpy as np

    mag = np.abs(np.random.default_rng(seed).standard_normal((t, f))).astype(np.float32)
    mag[t // 2] = 0.0  # a silent frame
    return mag


def check_k2(torch, dev):
    """K2 against its plain version at K2_SHAPES and on a view off 16 B
    alignment; device times at the 60 s shape."""
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
    # the 60 s grid starting 4 B past a 16 B boundary: every row's alignment shifts by one
    t, f = K2_SHAPES[0]
    padded = torch.empty(t * f + 1, device=dev)
    padded[1:] = torch.from_numpy(_k2_inputs(t, f, seed=5)).to(dev).reshape(-1)
    mag = padded[1:].view(t, f)
    got, want = spectral_stats_cuda(mag), spectral_stats_reference(mag)
    torch.cuda.synchronize()
    for name, g, w in zip(("flatness", "onset"), got, want):
        err = float((g - w).abs().max())
        print(f"K2 ({t}, {f}) from a view 4 B off 16 B alignment, {name}: max |kernel - plain| = "
              f"{err:.3e}")
        if bool(((g - w).abs() > K2_ATOL + K2_RTOL * w.abs()).any()) or float(got[1][0]) != 0.0:
            fail(f"K2 disagrees with its plain version on an unaligned view in {name}: {err}")
        max_err = max(max_err, err)

    return max_err, [time_k2(torch, dev, t, f) for t, f in K2_TIMED_SHAPES]


def time_k2(torch, dev, t: int, f: int):
    """K2's device time at (t, f) beside its plain version and its bound."""
    from audio_cut_tpu_torch.ops.frame_stats import spectral_stats_cuda, spectral_stats_reference

    # rotate over inputs that together exceed the 50 MB L2 (12 x 4.9 MB at
    # the bundle's grid): each launch reads its spectrogram from device memory
    count = max(2, -(-12 * 1201 // t))
    nxt = _rotating([torch.from_numpy(_k2_inputs(t, f, seed=100 + k)).to(dev)
                     for k in range(count)])

    moved = (t * f + 2 * t) * 4
    # per bin: 2 products, 2 adds, log, 2 log1p, a subtract, a max, 2 adds
    ops = 11 * t * f
    bound = max(moved / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
    timing = {
        "shape": [t, f],
        "ms": device_ms(lambda: spectral_stats_cuda(nxt())),
        "plain_ms": device_ms(lambda: spectral_stats_reference(nxt())),
        "library_ms": None,  # no single PyTorch call computes flatness and onset
        "bound_ms": bound,
        "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops / F32_FLOPS else "operations",
    }
    wrapper_ms = call_ms(lambda: spectral_stats_cuda(nxt()))
    print(f"K2 shape ({t}, {f}), device time per call (CUDA graph replay of 100 calls, "
          f"median of 5): kernel {timing['ms']:.4f} ms, plain {timing['plain_ms']:.4f} ms; bound "
          f"{bound:.5f} ms ({moved} bytes at {HBM_BYTES_PER_S:.3e} B/s; {ops} operations at "
          f"{F32_FLOPS:.3e}/s; bound by {timing['bound_by']}); no library call; kernel at "
          f"{bound / timing['ms']:.3f} of its bound")
    print(f"K2 shape ({t}, {f}): wrapper called from Python 100 times in a row, "
          f"{wrapper_ms:.4f} ms per call (CUDA events; includes the host's launch rate)")
    return timing


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


class _K1Rows:
    """Records (batch, frames, frame length) of every K1 launch while
    active; the launch and its count stay K1's own."""

    def __enter__(self):
        from audio_cut_tpu_torch.ops.ola import K1

        self.k1, self.shapes = K1, []
        inner = K1.launch

        def launch(device, *args):
            self.shapes.append(tuple(args[3:6]))  # frames, window, out, batch, n, L, ...
            return inner(device, *args)

        K1.launch = launch
        return self

    def __exit__(self, *exc):
        del self.k1.launch  # the instance attribute: the class's method is back

    def counts(self, start: int = 0) -> dict:
        """{"[b, n, L]": launches} of the launches from ``start`` on."""
        out = {}
        for shape in self.shapes[start:]:
            out[str(list(shape))] = out.get(str(list(shape)), 0) + 1
        return out


def check_segments(m, out: Path, audio, min_segments: int = 2) -> None:
    """success, >= ``min_segments`` segments labelled human/music, and the
    exported mix segments splice back to the PCM-24 encoding of the input
    exactly."""
    import numpy as np

    from audio_cut_tpu_torch.io import read_wav
    from audio_cut_tpu_torch.io.wavio import decode_pcm24, encode_pcm24

    if not m["success"]:
        fail(f"separate_and_segment reported failure: {m}")
    labels = [s["label"] for s in m["segments"]]
    if len(labels) < min_segments or not set(labels) <= {"human", "music"}:
        fail(f"segments {labels}: expected >= {min_segments} labelled human or music")
    parts = [read_wav(out / s["mix_path"])[0] for s in m["segments"]]
    spliced = np.concatenate(parts)
    if not np.array_equal(spliced, decode_pcm24(encode_pcm24(audio))):
        fail("the exported segments do not splice back to the input's PCM-24 encoding")


def reset_counts():
    """Set every kernel's launch count to 0 and re-arm the library check, so
    that the path driven next shows K0 as a fresh process would."""
    from audio_cut_tpu_torch.ops.cuda import LIBRARY_CHECK, K0
    from audio_cut_tpu_torch.ops.frame_stats import K2
    from audio_cut_tpu_torch.ops.ola import K1, K1B, K1W

    kernels = {"K0": K0, "K1": K1, "K1B": K1B, "K1W": K1W, "K2": K2}
    for k in kernels.values():
        k.launches = 0
    LIBRARY_CHECK.clear()
    return kernels


_EXPECTED = {}


def expected_pass(n: int, backend: str = "convtdf", overrides: Optional[dict] = None) -> dict:
    """What one separation of an n-sample song must show, computed here from
    ``ola_plan`` and the piece rule of ``device_pipeline`` (the config's, or
    ``overrides``'), not from the engine's layout: with ``pipelined_upload``
    on and more than 2 windows, pieces of max(piece_windows, ceil(windows /
    max_pieces)) windows, each one backend call; else one call of every
    window. The backend runs ``group`` windows a forward (``map_group`` of
    the ConvTDF, ``WINDOW_GROUP`` of the spectral mask), one K1 launch each.
    Under ``enhanced_separation.convtdf.shifts`` s > 1 a ConvTDF forward
    takes ``map_group // s`` windows and sends windows x s rows through K1.
    The WaveUNet (``backend="waveunet"``, its checkpoint in ``overrides``)
    runs ``map_group`` windows a forward with no iSTFT, so K1 launches 0
    times. The ONNX tier (``backend="onnx"``, its model in ``overrides``)
    runs its backend's ``map_group // shifts`` windows a forward and sends
    its mono windows through the STFT as stereo: a forward of n windows
    sends 2n x shifts rows through K1. Returns the windows, the piece sizes,
    the forwards, K1's launches and the rows of each, the largest batch a
    forward sees, and the manifest labels of the fused pass and of the
    engine."""
    import math

    from audio_cut_tpu_torch.config import get_config
    from audio_cut_tpu_torch.separation.backends import WINDOW_GROUP, make_backend
    from audio_cut_tpu_torch.separation.engine import ola_plan, padded_track_len

    key = (n, backend, tuple(sorted((overrides or {}).items())))
    if key in _EXPECTED:
        return _EXPECTED[key]

    def cfg(name, section="device_pipeline"):
        return (overrides or {}).get(f"{section}.{name}", get_config(f"{section}.{name}"))

    shifts, stereo = 1, 1
    if backend in ("waveunet", "onnx"):
        model = _backend_under(overrides, backend)
        g = model.engine_geometry()
        geometry = (g["chunk_s"], g["overlap_s"], g["halo_s"], int(g["align"]))
        group = model.map_group
        if backend == "onnx":
            shifts, stereo = model.shifts, 2
    elif backend == "convtdf":
        # the main path's own backend (cached after its first call); its model
        # window is the engine window
        model = make_backend("convtdf", SR, "cuda")
        g = model.engine_geometry()
        geometry = (g["chunk_s"], g["overlap_s"], g["halo_s"], int(g["align"]))
        # the backend's rule, from the config: map_group // shifts windows a forward
        shifts = max(1, int(cfg("shifts", "enhanced_separation.convtdf")))
        group = max(1, int(cfg("map_group", "enhanced_separation.convtdf")) // shifts)
    else:
        geometry = (float(cfg("chunk_seconds")), float(cfg("overlap_seconds")),
                    float(cfg("halo_seconds")), int(cfg("align_hop")))
        group = WINDOW_GROUP
    plans, window, _, _ = ola_plan(padded_track_len(n, SR, geometry[3]), SR, *geometry)
    windows = len(plans)
    if bool(cfg("pipelined_upload")) and windows > 2:
        per = max(max(1, int(cfg("piece_windows"))),
                  math.ceil(windows / max(2, int(cfg("max_pieces")))))
        sizes = [min(per, windows - k) for k in range(0, windows, per)]
        fused, engine = f"fused_pipelined_p{len(sizes)}", f"device_ola_pipelined_p{len(sizes)}"
    else:
        sizes, fused, engine = [windows], "fused_single_program", "device_ola"
    forwards = [min(group, k - j) * shifts for k in sizes for j in range(0, k, group)]
    rows = [] if backend == "waveunet" else [f * stereo for f in forwards]
    out = {"windows": windows, "window": window, "sizes": sizes, "forwards": len(forwards),
           "k1": len(rows), "rows": rows, "batch": max(forwards), "fused": fused,
           "engine": engine}
    _EXPECTED[key] = out
    return out


def check_pass(tag: str, m, k1: int, k2: int, label: str = "fused", backend: str = "convtdf",
               overrides: Optional[dict] = None) -> None:
    """One separation of the 60 s song in this call: on cuda, K1 as
    ``expected_pass`` says, K2 once, and the manifest's label of the layout
    that ran (``label``: "fused" for the fused pass, "engine" for the staged
    call, hybrid's memo miss and the modes that call separate_for_detection)."""
    want = expected_pass(int(SONG_S * SR), backend, overrides)
    gpu = m.get("gpu") or {}
    if (gpu.get("gpu_pipeline_device") != "cuda" or gpu.get("gpu_pipeline_mode") != want[label]
            or k1 != want["k1"] or k2 != 1):
        fail(f"{tag}: K1 {k1}, K2 {k2}, gpu {gpu}; expected K1 {want['k1']} (pieces "
             f"{want['sizes']}) and K2 1 on cuda, {want[label]}")


def run_mdd(torch, dev, work: Path, audio):
    """The main path: separate_and_segment() with no mode and no device, cold
    then warm. Returns (K1 and K2 launches, the warm call's stems, manifest)."""
    from audio_cut_tpu_torch import separate_and_segment
    from audio_cut_tpu_torch.separation import fused

    song = work / "song.wav"
    torch.cuda.reset_peak_memory_stats(dev)
    kernels = reset_counts()  # the main path starts: only its launches count
    K0, K1, K2 = kernels["K0"], kernels["K1"], kernels["K2"]
    with _Capture(fused) as cap:
        for call in range(CALLS):
            k1, k2 = K1.launches, K2.launches
            t0 = time.perf_counter()
            m = separate_and_segment(input_uri=str(song), export_dir=str(work / f"mdd{call}"))
            wall = time.perf_counter() - t0
            k1, k2 = K1.launches - k1, K2.launches - k2
            label = "cold" if call == 0 else "warm"
            WALLS[f"v2.2_mdd {label}"] = wall
            print(f"v2.2_mdd call {call} ({label}): {wall:.3f} s wall, {SONG_S / wall:.2f} audio-s "
                  f"per wall-s, fused pass {m['gpu']['gpu_pipeline_compute_ms']:.1f} ms, "
                  f"K1 launches {k1}, K2 launches {k2}, {m['gpu']['gpu_pipeline_mode']}")
            check_pass(f"v2.2_mdd call {call}", m, k1, k2)
            check_segments(m, work / f"mdd{call}", audio)
            labels = [s["label"] for s in m["segments"]]
            print(f"v2.2_mdd call {call}: {len(labels)} segments {labels}, cuts (samples) "
                  f"{m['cuts']['samples']}, spliced back exactly; confidence "
                  f"{m['separation']['confidence']:.4f}, guard {m['guard']['shift_stats']}")
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"v2.2_mdd: launches in the two calls {launches}")
    if K0.launches != 1:
        fail(f"K0 launched {K0.launches} times in the two calls; expected once, at the first launch")
    print(f"v2.2_mdd: torch.cuda.max_memory_allocated = {torch.cuda.max_memory_allocated(dev)} bytes")
    return launches, cap.last, m


def check_vpbd(m, out: Path, audio, mode: str) -> None:
    """What a vpbd call must carry beyond check_segments: the planner's
    boundary detection with a non-empty merged pool (beat candidates in it,
    for the unified pool on the song's loud bars), selected candidates and
    guard-shift metadata, at least one final cut enriched with its
    candidate's source, the auto profile, and the candidate debug JSON in
    the export directory."""
    check_segments(m, out, audio)
    bd = m.get("boundary_detection") or {}
    planner = bd.get("planner") or {}
    counts = bd.get("candidate_counts") or {}
    if "merged" not in counts or "final_time_by_raw_time" not in planner:
        fail(f"{mode}: boundary_detection lacks candidate_counts or planner metadata: {bd}")
    if counts["merged"] <= 0 or (counts.get("pool_mode") == "unified" and counts.get("beat", 0) <= 0):
        fail(f"{mode}: candidate counts {counts}: expected a merged pool with beat candidates")
    if planner.get("selected_count", 0) <= 0 or not bd.get("selected"):
        fail(f"{mode}: the planner selected no candidate: {planner}")
    if not any(isinstance(c, dict) and c.get("source") for c in m["cuts"]["final"]):
        fail(f"{mode}: no entry of cuts.final carries its candidate's source: {m['cuts']['final']}")
    if not (m.get("auto_profile") or {}).get("intent"):
        fail(f"{mode}: no auto_profile in the manifest")
    if not (out / "vpbd_candidates_debug.json").is_file():
        fail(f"{mode}: vpbd_candidates_debug.json was not written")


def run_vpbd(torch, dev, work: Path, audio):
    """The vpbd modes through the entry point with no device, on the song
    with a loud section (``song_chorus.wav``, ``audio``): vpbd_acoustic
    twice, then vpbd_asr (lyrics alignment off, the default) once. Each call
    launches K1 once per piece and K2 once (``check_pass``); the phase
    launches K0 once."""
    from audio_cut_tpu_torch import separate_and_segment

    song = work / "song_chorus.wav"
    torch.cuda.reset_peak_memory_stats(dev)
    kernels = reset_counts()  # the vpbd path starts: only its launches count
    K0, K1, K2 = kernels["K0"], kernels["K1"], kernels["K2"]
    for call, mode in enumerate(["vpbd_acoustic"] * VPBD_CALLS + ["vpbd_asr"]):
        out = work / f"vpbd{call}"
        k1, k2 = K1.launches, K2.launches
        t0 = time.perf_counter()
        m = separate_and_segment(input_uri=str(song), export_dir=str(out), mode=mode)
        wall = time.perf_counter() - t0
        k1, k2 = K1.launches - k1, K2.launches - k2
        print(f"{mode} call {call}: {wall:.3f} s wall, {SONG_S / wall:.2f} audio-s per wall-s, "
              f"fused pass {m['gpu']['gpu_pipeline_compute_ms']:.1f} ms, K1 launches {k1}, "
              f"K2 launches {k2}")
        check_pass(f"{mode} call {call}", m, k1, k2)
        check_vpbd(m, out, audio, mode)
        if mode == "vpbd_asr" and m.get("note") != "lyrics_unavailable:disabled":
            fail(f"vpbd_asr: note {m.get('note')!r}, expected 'lyrics_unavailable:disabled'")
        ap = m["auto_profile"].get("auto_profile", {})
        bd = m["boundary_detection"]
        print(f"{mode} call {call}: style {ap.get('style')} confidence {ap.get('confidence')} "
              f"anchor weights {ap.get('anchor_weights')} features {ap.get('features')}; "
              f"candidate_counts {bd['candidate_counts']}; planner {bd['planner']['planner']}, "
              f"{bd['planner']['selected_count']} selected "
              f"{[c['source'] for c in bd['selected']]}; note {m.get('note')}")
        enriched = [c for c in m["cuts"]["final"] if isinstance(c, dict) and c.get("source")]
        print(f"{mode} call {call}: {len(enriched)} of {len(m['cuts']['final'])} final cuts carry "
              f"their candidate: {[(round(c['t'], 4), c['source']) for c in enriched]}")
        print(f"{mode} call {call}: {len(m['segments'])} segments "
              f"{[s['label'] for s in m['segments']]}, cuts (samples) {m['cuts']['samples']}, "
              f"spliced back exactly; guard {m['guard']['shift_stats']}")
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"vpbd: launches in the {VPBD_CALLS + 1} calls {launches}")
    if K0.launches != 1:
        fail(f"K0 launched {K0.launches} times in the vpbd calls; expected once, at the first launch")
    print(f"vpbd: torch.cuda.max_memory_allocated = {torch.cuda.max_memory_allocated(dev)} bytes")
    return launches


class _HybridResults:
    """Wraps the port's ResultBuilder.add_hybrid_metadata to keep each hybrid
    call's result (its per-segment lib flags); the call still runs it."""

    def __init__(self):
        from audio_cut_tpu_torch.pipeline.result import ResultBuilder

        self.cls = ResultBuilder
        self.inner = ResultBuilder.__dict__["add_hybrid_metadata"]
        self.results = []

    def __enter__(self):
        inner = self.inner.__func__

        def add_hybrid_metadata(result, **kwargs):
            out = inner(result, **kwargs)
            self.results.append(out)
            return out

        self.cls.add_hybrid_metadata = staticmethod(add_hybrid_metadata)
        return self

    def __exit__(self, *exc):
        self.cls.add_hybrid_metadata = self.inner


def run_hybrid(torch, dev, work: Path, songs):
    """hybrid_mdd through the entry point with no device, once per strategy
    of ``HYBRID_CASES`` on each of ``songs`` ({file name: audio}): the song
    with a loud section, then the one whose loud section is sung on the beat
    grid with silent rests. Each call reuses its v2.2_mdd sub-run's device
    pass, so it launches K1 once per piece and K2 once, under the fused
    pass's label; the phase launches K0 once.
    Each segment's file name carries ``_lib`` exactly where the result's lib
    flag is set, and at least one segment of the phase carries it."""
    from audio_cut_tpu_torch import separate_and_segment

    torch.cuda.reset_peak_memory_stats(dev)
    kernels = reset_counts()  # the hybrid path starts: only its launches count
    K0, K1, K2 = kernels["K0"], kernels["K1"], kernels["K2"]
    lib_total = 0
    calls = [(song, name, overrides) for song in songs for name, overrides in HYBRID_CASES]
    with _HybridResults() as captured:
        for call, (song, name, overrides) in enumerate(calls):
            out = work / f"hybrid{call}"
            k1, k2 = K1.launches, K2.launches
            t0 = time.perf_counter()
            m = separate_and_segment(input_uri=str(work / song), export_dir=str(out),
                                     mode="hybrid_mdd", runtime_overrides=overrides)
            wall = time.perf_counter() - t0
            k1, k2 = K1.launches - k1, K2.launches - k2
            label = f"hybrid_mdd call {call} ({song}, {name})"
            print(f"{label}: {wall:.3f} s wall, {SONG_S / wall:.2f} audio-s per wall-s, fused pass "
                  f"{m['gpu']['gpu_pipeline_compute_ms']:.1f} ms, K1 launches {k1}, K2 launches {k2}")
            check_pass(f"{label} (one device pass, the sub-run's)", m, k1, k2)
            check_segments(m, out, songs[song])
            if len(captured.results) != call + 1:
                fail(f"{label}: {len(captured.results)} hybrid results captured")
            result = captured.results[-1]
            lib = result["segment_lib_flags"]
            names = [s["mix_path"] for s in m["segments"]]
            if ["_lib" in n for n in names] != lib:
                fail(f"{label}: segment names {names} disagree with lib flags {lib}")
            lib_total += sum(lib)
            print(f"{label}: strategy {result['strategy']}, {result['lib_segment_count']} _lib "
                  f"segments of {len(names)}, beat analysis {result['beat_analysis']}; cuts "
                  f"(samples) {m['cuts']['samples']}, segments {names}, spliced back exactly; "
                  f"guard {m['guard']['shift_stats']}")
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"hybrid_mdd: launches in the {len(calls)} calls {launches}")
    if K0.launches != 1:
        fail(f"K0 launched {K0.launches} times in the hybrid calls; expected once, at the first launch")
    if lib_total == 0:
        fail("hybrid_mdd: no segment of the phase carries _lib")
    print(f"hybrid_mdd: torch.cuda.max_memory_allocated = {torch.cuda.max_memory_allocated(dev)} bytes")


def run_librosa(torch, dev, work: Path, audio, intro):
    """librosa_onset through the entry point with no device, with the
    packaged ConvTDF-large, on the main path's song: cold, warm (both with
    the separation, the default), then once with
    ``librosa_onset.use_vocal_separation: false``; then once with the
    separation on ``song_intro.wav`` (``intro``: the beat alone for its first
    ``INTRO_S`` s). Every call must report ``smart_segment_v2`` and splice
    back exactly; with the separation it launches K1 once per piece and K2
    once, under the engine's label, and writes one vocal segment per segment, without it K1 0 times and K2
    once and labels every segment human; the intro call gives a music
    segment; the phase launches K0 once. The warm call's features are held
    to the CPU's ``build_track_features`` on the same mix within
    ``BUNDLE_TOL``, the onset within what the two sides' spectrograms allow
    (``check_onset``), and its cuts to the CPU's run of the same host logic
    (``plan_onset_cuts``) over the CPU's features, within the shift that
    the bpm's tolerance allows the last bar edge."""
    import math

    import numpy as np

    from audio_cut_tpu_torch import separate_and_segment
    from audio_cut_tpu_torch.analysis.features import build_track_features
    from audio_cut_tpu_torch.config import get_config
    from audio_cut_tpu_torch.pipeline import splitter

    torch.cuda.reset_peak_memory_stats(dev)
    kernels = reset_counts()  # the librosa_onset path starts: only its launches count
    K0, K1, K2 = kernels["K0"], kernels["K1"], kernels["K2"]
    calls = [("cold", "song.wav", audio, {}), ("warm", "song.wav", audio, {}),
             ("no separation", "song.wav", audio, {"librosa_onset.use_vocal_separation": False}),
             ("beat-only intro", "song_intro.wav", intro, {})]
    features = []
    inner = splitter.build_track_features

    def capture(*args, **kwargs):
        features.append(inner(*args, **kwargs))
        return features[-1]

    splitter.build_track_features = capture
    try:
        results = []
        for call, (label, name, song_audio, overrides) in enumerate(calls):
            out = work / f"onset{call}"
            k1, k2 = K1.launches, K2.launches
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            m = separate_and_segment(input_uri=str(work / name), export_dir=str(out),
                                     mode="librosa_onset", export_types=LIBROSA_EXPORTS,
                                     runtime_overrides=overrides)
            wall = time.perf_counter() - t0
            k1, k2 = K1.launches - k1, K2.launches - k2
            tag = f"librosa_onset call {call} ({label}, {name})"
            smart = m.get("smart_segmentation") or {}
            labels = [s["label"] for s in m["segments"]]
            print(f"{tag}: {wall:.3f} s wall, {SONG_S / wall:.2f} audio-s per wall-s, K1 launches "
                  f"{k1}, K2 launches {k2}; bpm {smart.get('bpm')!r}, bar duration "
                  f"{smart.get('bar_duration_s')!r} s, silence boundaries "
                  f"{smart.get('silence_boundaries')}; {len(labels)} segments {labels}, cuts "
                  f"(samples) {m['cuts']['samples']}; peak memory "
                  f"{torch.cuda.max_memory_allocated(dev)} bytes")
            if smart.get("method") != "smart_segment_v2":
                fail(f"{tag}: smart_segmentation {smart}")
            check_segments(m, out, song_audio)
            separated = not overrides
            if separated:
                check_pass(tag, m, k1, k2, label="engine")
                vocal = m["artifacts"].get("human_segments", [])
                if len(vocal) != len(labels) or not all((out / v).is_file() for v in vocal):
                    fail(f"{tag}: {len(vocal)} vocal segments for {len(labels)} segments")
            else:
                if k1 != 0 or k2 != 1 or set(labels) != {"human"}:
                    fail(f"{tag}: K1 {k1}, K2 {k2}, labels {labels}; expected K1 0, K2 1 and "
                         f"every segment human")
            if label == "beat-only intro" and "music" not in labels:
                fail(f"{tag}: no music segment on a song whose first {INTRO_S} s are the beat "
                     f"alone: {labels}")
            results.append(m)
    finally:
        splitter.build_track_features = inner
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"librosa_onset: launches in the {len(calls)} calls {launches}")
    if K0.launches != 1:
        fail(f"K0 launched {K0.launches} times in the librosa_onset calls; expected once")

    # the warm call's features against the CPU's, and its cuts against the
    # CPU's host logic over them
    card = features[1]
    cfg = get_config("librosa_onset", {}) or {}
    hop = int(cfg.get("energy_analysis", {}).get("hop_length", 512))
    cpu = build_track_features(audio, SR, hop_s=hop / SR, device="cpu")
    check_onset(torch, dev, audio, hop, card.onset, cpu.onset)
    for key in ("rms", "flatness", "mdd"):
        g, w = getattr(card, key), getattr(cpu, key)
        rtol, atol = BUNDLE_TOL[key]
        err = float(np.abs(g.astype(np.float64) - w).max())
        print(f"librosa_onset: features {key} {g.shape}: max |card - CPU| = {err:.3e} "
              f"(rtol {rtol}, atol {atol})")
        if g.shape != w.shape or not np.allclose(g, w, rtol=rtol, atol=atol):
            fail(f"librosa_onset: the card's {key} disagrees with the CPU's: {err}")
    for key, g, w in (("bpm", card.bpm, cpu.bpm), ("tempo_strength", card.tempo_strength,
                                                   cpu.tempo_strength)):
        rtol, atol = BUNDLE_TOL[key]
        print(f"librosa_onset: features {key}: card {g!r}, CPU {w!r}")
        if abs(g - w) > atol + rtol * abs(w):
            fail(f"librosa_onset: the card's {key} {g} disagrees with the CPU's {w}")
    plan = splitter.plan_onset_cuts(cpu, audio.size, SR, cfg)
    got, want = results[1]["cuts"]["samples"], plan["cut_samples"]
    bar = plan["bar_duration_s"]
    # the bpm agrees to BUNDLE_TOL's rtol, so bar edge k moves by at most k x
    # bar x rtol; the last edge by n_bars x bar x rtol, and int() by 1 more
    bound = math.ceil(math.ceil(SONG_S / bar) * bar * BUNDLE_TOL["bpm"][0] * SR) + 1
    diffs = [abs(a - b) for a, b in zip(got, want)]
    print(f"librosa_onset: warm call's cuts {got}; the CPU's host logic over the CPU's features "
          f"{want} (silence boundaries {plan['silence_boundaries']}); max |card - CPU| "
          f"{max(diffs) if diffs else 0} samples (bound {bound})")
    if len(got) != len(want) or any(d > bound for d in diffs):
        fail(f"librosa_onset: the card's cuts {got} are not within {bound} samples of the CPU's "
             f"{want}")
    return launches


def check_onset(torch, dev, audio, hop: int, got, want) -> None:
    """librosa_onset's onset, card against CPU. Each side takes its own
    STFT, and log1p(1000 |X|) magnifies their rounding difference up to
    1000-fold in near-silent bins, where clamp(flux, 0) keeps the positive
    half of it in the mean; so BUNDLE_TOL's atol (fitted at the bundle's
    grid) is printed, not held. Held instead: each frame's onset difference
    within the difference that the two spectrograms imply
    (``testing.onset_allowed``: K2's onset formula over each side's
    spectrogram in float64, and their difference), plus K2's own rounding
    against its plain version (rtol K2_RTOL, atol K2_ATOL). How much that
    lets through is printed: the median and largest allowance as a share
    of the onset, and the largest allowance. The spectrograms themselves are held through the flatness
    (BUNDLE_TOL); their per-frame difference is printed beside
    ``STFT_REL``."""
    import numpy as np

    from audio_cut_tpu_torch.analysis.features import _FEATURE_NFFT, pad_to_bucket
    from audio_cut_tpu_torch.ops.stft import stft
    from audio_cut_tpu_torch.testing import onset_allowed

    padded = torch.from_numpy(pad_to_bucket(audio, SR))
    with torch.inference_mode():
        spec = {side: stft(padded.to(d), n_fft=_FEATURE_NFFT, hop=hop).cpu()
                for side, d in (("card", dev), ("cpu", "cpu"))}
    n = got.size
    x_card, x_cpu = (spec[k].numpy()[:n].astype(np.complex128) for k in ("card", "cpu"))
    rel = np.linalg.norm(x_card - x_cpu, axis=-1) / np.maximum(np.linalg.norm(x_cpu, axis=-1),
                                                               1e-30)
    allowed = onset_allowed(np.abs(x_card), np.abs(x_cpu))
    err = np.abs(got.astype(np.float64) - want)
    slack = allowed + K2_RTOL * np.abs(want) + K2_ATOL - err
    rtol, atol = BUNDLE_TOL["onset"]
    beyond = int(np.sum(err > atol + rtol * np.abs(want)))
    worst = int(np.argmax(err))
    print(f"librosa_onset: STFT {x_card.shape} card against CPU: max per-frame ||d X|| / ||X|| "
          f"= {rel.max():.3e} at frame {int(np.argmax(rel))} (the radix-2 bound with exact "
          f"twiddles, STFT_REL: {STFT_REL:.3e}); {int(np.sum(rel > STFT_REL))} frames above it")
    print(f"librosa_onset: features onset {got.shape}: max |card - CPU| = {err.max():.3e} at "
          f"frame {worst} (value {want[worst]:.4f}, allowed there {allowed[worst]:.3e}); "
          f"{beyond} frames beyond BUNDLE_TOL's (rtol {rtol}, atol {atol}); least slack to "
          f"the spectrograms' bound {slack.min():.3e}")
    live = np.abs(want) >= atol
    share = allowed[live] / np.abs(want[live])
    widest = int(np.argmax(allowed))
    print(f"librosa_onset: the spectrograms' bound as a share of |onset| over the {int(live.sum())} "
          f"frames with |onset| >= {atol}: median {np.median(share):.3e}, max {share.max():.3e}; "
          f"largest allowance {allowed[widest]:.3e} at frame {widest} (onset {want[widest]:.4f})")
    if slack.min() < 0:
        fail(f"librosa_onset: the card's onset differs from the CPU's beyond what the two "
             f"spectrograms allow (frame {int(np.argmin(slack))})")


class _PauseCapture:
    """Wraps the port's PureVocalPauseDetector.detect_pure_vocal_pauses to
    keep each call's keyword arguments and pauses; the call still runs it."""

    def __init__(self):
        from audio_cut_tpu_torch.detection.pause_detector import PureVocalPauseDetector

        self.cls = PureVocalPauseDetector
        self.inner = PureVocalPauseDetector.detect_pure_vocal_pauses
        self.calls = []

    def __enter__(self):
        inner = self.inner

        def detect_pure_vocal_pauses(det, **kwargs):
            pauses = inner(det, **kwargs)
            self.calls.append((kwargs, pauses))
            return pauses

        self.cls.detect_pure_vocal_pauses = detect_pure_vocal_pauses
        return self

    def __exit__(self, *exc):
        self.cls.detect_pure_vocal_pauses = self.inner


def _fenced_ms(torch, fn):
    """(fn(), ms): fn's wall time between two device synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def run_legacy(torch, dev, work: Path, audio):
    """The legacy multi-feature detector (``LEGACY``) through the entry point
    with no device on the main path's song: v2.2_mdd cold and warm, then
    vpbd_acoustic once, each launching K1 once per piece and K2 once (K0
    once in the phase) and splicing back exactly, with multi_feature pauses. Then
    YIN and LPC on the warm call's vocal stem on the card against the same
    functions on its host copy on the CPU; the warm call's pauses against
    the detector's run on the CPU (the CPU's bundle of the same stems, YIN
    and LPC on the CPU, the call's focus windows); and the split of both
    functions' time on the card: the device part, the download and the
    host part, beside the vocal download."""
    import numpy as np

    from audio_cut_tpu_torch import separate_and_segment
    from audio_cut_tpu_torch.analysis.bundle import DB_STRIDE, build_detection_bundle
    from audio_cut_tpu_torch.config import get_config_manager, set_runtime_config
    from audio_cut_tpu_torch.detection.pause_detector import PureVocalPauseDetector
    from audio_cut_tpu_torch.models.vad import build_vad
    from audio_cut_tpu_torch.ops import voice
    from audio_cut_tpu_torch.separation import fused
    from audio_cut_tpu_torch.separation.engine import SeparationResult

    torch.cuda.reset_peak_memory_stats(dev)
    kernels = reset_counts()  # the legacy path starts: only its launches count
    K0, K1, K2 = kernels["K0"], kernels["K1"], kernels["K2"]
    with _Capture(fused) as cap, _PauseCapture() as pauses_cap:
        for call, mode in enumerate(["v2.2_mdd", "v2.2_mdd", "vpbd_acoustic"]):
            out = work / f"legacy{call}"
            k1, k2, detected = K1.launches, K2.launches, len(pauses_cap.calls)
            t0 = time.perf_counter()
            m = separate_and_segment(input_uri=str(work / "song.wav"), export_dir=str(out),
                                     mode=mode, runtime_overrides=LEGACY)
            wall = time.perf_counter() - t0
            k1, k2 = K1.launches - k1, K2.launches - k2
            tag = f"legacy {mode} call {call}"
            pauses = pauses_cap.calls[-1][1] if len(pauses_cap.calls) > detected else []
            types = sorted({p.pause_type for p in pauses})
            print(f"{tag}: {wall:.3f} s wall, {SONG_S / wall:.2f} audio-s per wall-s, K1 launches "
                  f"{k1}, K2 launches {k2}; {len(pauses)} pauses {types}; {len(m['segments'])} "
                  f"segments {[s['label'] for s in m['segments']]}, cuts (samples) "
                  f"{m['cuts']['samples']}")
            check_pass(tag, m, k1, k2)
            if not pauses or not all(t.startswith("multi_feature") for t in types):
                fail(f"{tag}: pause types {types}; expected multi_feature pauses")
            check_segments(m, out, audio)
            if call == 1:
                warm, warm_wall = cap.last, wall
                card_kwargs, card_pauses = pauses_cap.calls[-1]
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"legacy: launches in the 3 calls {launches}; peak memory "
          f"{torch.cuda.max_memory_allocated(dev)} bytes")
    if K0.launches != 1:
        fail(f"K0 launched {K0.launches} times in the legacy calls; expected once")
    default = WALLS["v2.2_mdd warm"]
    print(f"legacy: warm v2.2_mdd {SONG_S / warm_wall:.2f} audio-s per wall-s ({warm_wall:.3f} s) "
          f"against the default detector's warm call {SONG_S / default:.2f} ({default:.3f} s)")

    sep, _ = warm
    stem, host = sep.vocal_device, sep.vocal_track
    f_card, v_card = voice.yin_f0(stem, SR)
    f_cpu, v_cpu = voice.yin_f0(host, SR)
    l_card, l_cpu = voice.lpc_formant_strength(stem, SR), voice.lpc_formant_strength(host, SR)
    v_err = float(np.abs(v_card - v_cpu).max())
    f_share = float(np.mean(np.abs(f_card - f_cpu) <= F0_HZ))
    l_err = float(np.abs(l_card - l_cpu).max())
    print(f"legacy: YIN on the card's vocal stem against the CPU's on its host copy, {v_card.size} "
          f"frames: max |voicing diff| {v_err:.3e} (atol {VOICING_ATOL}); f0 within {F0_HZ} Hz on "
          f"{f_share:.5f} of frames (>= {F0_MIN_SHARE}), max |f0 diff| "
          f"{float(np.abs(f_card - f_cpu).max()):.3f} Hz; LPC formant strength max |diff| "
          f"{l_err:.3e} (atol {VOICING_ATOL})")
    if (v_card.shape != v_cpu.shape or v_err > VOICING_ATOL or f_share < F0_MIN_SHARE
            or l_card.shape != l_cpu.shape or l_err > VOICING_ATOL):
        fail("legacy: YIN or LPC on the card disagrees with the CPU")

    # the warm call's pauses against the detector on the CPU
    n = audio.size
    with torch.inference_mode():
        cpu_bundle = build_detection_bundle(sep.mix_device.cpu(), stem.cpu(), SR, n,
                                            vad_model=build_vad(SR, "cpu"))
    cpu_stems = SeparationResult(None, None, "cpu", None)
    cpu_stems.vocal_device = torch.from_numpy(host)  # the card stem's host copy
    kwargs = dict(card_kwargs, features=cpu_bundle.features, rms_env=cpu_bundle.vocal_rms_fine,
                  env_db_grid=cpu_bundle.vocal_db_fine, env_db_stride=cpu_bundle.db_stride,
                  stems=cpu_stems)
    mgr = get_config_manager()
    snapshot = mgr.snapshot()
    try:
        set_runtime_config(LEGACY)
        cpu_pauses = PureVocalPauseDetector(SR).detect_pure_vocal_pauses(**kwargs)
    finally:
        mgr.restore(snapshot)
    print(f"legacy: warm call's pauses on the card {len(card_pauses)}, on the CPU {len(cpu_pauses)}")
    for g, w in zip(card_pauses, cpu_pauses):
        print(f"legacy: pause {g.start_time:.2f}-{g.end_time:.2f} s {g.pause_type}/{w.pause_type}: "
              f"confidence card {g.confidence:.6f} CPU {w.confidence:.6f}; cut card "
              f"{g.cut_point!r} CPU {w.cut_point!r}; grade {g.quality_grade}/{w.quality_grade}")
    if len(card_pauses) != len(cpu_pauses):
        fail("legacy: the card's and the CPU's pause counts differ")
    stride_s = DB_STRIDE / SR
    for g, w in zip(card_pauses, cpu_pauses):
        if not (g.pause_type.startswith("multi_feature") and w.pause_type.startswith("multi_feature")
                and abs(g.confidence - w.confidence) <= LEGACY_CONF_ATOL
                and abs(g.cut_point - w.cut_point) <= stride_s + 1e-9):
            fail(f"legacy: a pause differs beyond its bounds (confidence atol {LEGACY_CONF_ATOL}, "
                 f"cut one dB-grid stride, {DB_STRIDE} samples)")
    del cpu_bundle

    # where the time of both functions goes on the card, fenced
    frame, hop, tau_min, tau_max = voice.yin_geometry(SR)
    lframe, lhop = voice.lpc_geometry(SR)
    with torch.inference_mode():
        for rep in range(3):
            _, download = _fenced_ms(torch, lambda: stem.cpu())
            (cmnd, energy), yin_dev = _fenced_ms(torch, lambda: voice._yin_cmnd(stem, frame, hop,
                                                                              tau_max))
            band, yin_dl = _fenced_ms(torch, lambda: torch.cat(
                [cmnd[:, tau_min:tau_max], energy[:, None]], dim=1).cpu().numpy())
            _, yin_host = _fenced_ms(torch, lambda: voice.yin_track(
                band[:, :-1], band[:, -1], SR, frame, tau_min, tau_max))
            res, lpc_dev = _fenced_ms(torch, lambda: voice._lpc_residual(stem, lframe, lhop, 12))
            _, lpc_dl = _fenced_ms(torch, lambda: res.cpu().numpy())
            print(f"legacy: time split {rep} (ms, fenced): vocal download ({stem.numel() * 4} B) "
                  f"{download:.3f}; YIN device {yin_dev:.3f}, band download "
                  f"({band.nbytes} B, {band.shape}) {yin_dl:.3f}, host Viterbi and refinement "
                  f"{yin_host:.3f}; LPC device {lpc_dev:.3f}, download {lpc_dl:.3f}")
            del cmnd, energy, res
    return launches


def run_spectral(torch, dev, work: Path, audio):
    """The spectral backend on the main path's song: separate_and_segment()
    with no mode and no device and ``enhanced_separation.backend: spectral``,
    cold then warm. Each call runs the config schedule's engine windows
    (``ola_plan``, 8 at 60 s) in pieces of 2 (``expected_pass``), so it
    launches K1 once per piece (4) and K2 once (K0 once in the phase), and
    splices back exactly. Then one group of 4 engine windows through the backend on
    the card and on the CPU (SNR >= SPECTRAL_SNR_DB), K1 at the spectral
    shape against its plain version and timed beside its bound, and one
    profiled warm call. Returns K1's shape there ([B, N, L], hop) and its
    timing."""
    import numpy as np

    from audio_cut_tpu_torch import separate_and_segment
    from audio_cut_tpu_torch.config import get_config
    from audio_cut_tpu_torch.separation.backends import WINDOW_GROUP, make_backend
    from audio_cut_tpu_torch.separation.engine import ola_plan, padded_track_len

    geometry = (float(get_config("device_pipeline.chunk_seconds")),
                float(get_config("device_pipeline.overlap_seconds")),
                float(get_config("device_pipeline.halo_seconds")),
                int(get_config("device_pipeline.align_hop")))
    padded = padded_track_len(audio.size, SR, geometry[3])
    plans, window, _, _ = ola_plan(padded, SR, *geometry)
    want = expected_pass(audio.size, "spectral")
    print(f"spectral: config schedule {geometry}: {len(plans)} engine windows of {window} samples "
          f"over {padded} in pieces {want['sizes']}, so K1 {want['k1']} and K2 1 a call, "
          f"{want['fused']}")

    torch.cuda.reset_peak_memory_stats(dev)
    kernels = reset_counts()  # the spectral path starts: only its launches count
    K0, K1, K2 = kernels["K0"], kernels["K1"], kernels["K2"]
    for call in range(CALLS):
        out = work / f"spectral{call}"
        k1, k2 = K1.launches, K2.launches
        t0 = time.perf_counter()
        m = separate_and_segment(input_uri=str(work / "song.wav"), export_dir=str(out),
                                 runtime_overrides=SPECTRAL)
        wall = time.perf_counter() - t0
        k1, k2 = K1.launches - k1, K2.launches - k2
        gpu = m["gpu"]
        label = f"spectral v2.2_mdd call {call} ({'cold' if call == 0 else 'warm'})"
        print(f"{label}: {wall:.3f} s wall, {SONG_S / wall:.2f} audio-s per wall-s, fused pass "
              f"{gpu['gpu_pipeline_compute_ms']:.1f} ms, backend {gpu['gpu_pipeline_backend']}, "
              f"{gpu['gpu_pipeline_chunks']} windows, K1 launches {k1}, K2 launches {k2}")
        if gpu["gpu_pipeline_backend"] != "spectral" or gpu["gpu_pipeline_device"] != "cuda":
            fail(f"{label}: backend {gpu['gpu_pipeline_backend']!r} on "
                 f"{gpu['gpu_pipeline_device']!r}, expected 'spectral' on 'cuda'")
        if gpu["gpu_pipeline_chunks"] != len(plans):
            fail(f"{label}: {gpu['gpu_pipeline_chunks']} windows, expected {len(plans)}")
        check_pass(label, m, k1, k2, backend="spectral")
        check_segments(m, out, audio)
        print(f"{label}: {len(m['segments'])} segments {[s['label'] for s in m['segments']]}, "
              f"cuts (samples) {m['cuts']['samples']}, spliced back exactly")
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"spectral: launches in the {CALLS} calls {launches}")
    if K0.launches != 1:
        fail(f"K0 launched {K0.launches} times in the spectral calls; expected once")
    print(f"spectral: torch.cuda.max_memory_allocated = {torch.cuda.max_memory_allocated(dev)} bytes")

    # one group of engine windows, card against CPU
    backend = make_backend("spectral", SR, "cuda")  # the main path's, as the entry points ask
    padded_audio = np.pad(audio, (0, padded - audio.size))
    group = torch.from_numpy(np.stack([padded_audio[p.start:p.start + window]
                                       for p in plans[:WINDOW_GROUP]]))
    v_card, _ = backend.separate_windows(group.to(dev))
    t0 = time.perf_counter()
    v_cpu, _ = make_backend("spectral", SR, "cpu").separate_windows(group)
    cpu_s = time.perf_counter() - t0
    v_card = v_card.cpu().numpy()
    err = float(np.abs(v_card - v_cpu.numpy()).max())
    snr = snr_db(v_cpu.numpy(), v_card)
    print(f"spectral: one group of {WINDOW_GROUP} engine windows ({window} samples), vocal card vs "
          f"CPU: max |diff| = {err:.3e}, SNR {snr:.2f} dB (required >= {SPECTRAL_SNR_DB}); "
          f"CPU {cpu_s:.2f} s")
    if not snr >= SPECTRAL_SNR_DB:
        fail(f"spectral: the card's vocal is {snr:.2f} dB from the CPU's, < {SPECTRAL_SNR_DB} dB")

    # K1 at the shape this path gives it: one piece's iSTFT frames, the
    # spectral piece of K1_SHAPES
    from audio_cut_tpu_torch.testing import K1_SHAPES

    shape, hop = (want["batch"], window // backend.hop + 1, backend.n_fft), backend.hop
    if ("a spectral piece", *shape, hop) not in K1_SHAPES:
        fail(f"spectral: K1 runs at {shape} hop {hop}, not the spectral piece of K1_SHAPES")
    k1_err = k1_error(torch, dev, shape, hop)
    timing = time_k1(torch, dev, shape, hop, "spectral shape")
    timing["max_abs_err"] = k1_err

    # one warm call, profiled: the median network's share of the card
    found, busy_ms = profile_call(torch, work, mode="v2.2_mdd", song="song.wav",
                                  overrides=SPECTRAL, name="spectral")
    median = [e for e in found if any(k in e.name for k in MEDIAN_KERNELS)]
    if busy_ms > 0:
        median_ms = _union_us([(e.time_range.start, e.time_range.end) for e in median]) / 1e3
        print(f"profile (spectral): the median network's min/max kernels: {len(median)} launches, "
              f"{median_ms:.1f} ms busy, {median_ms / busy_ms:.3f} of the card's busy time")
    else:
        print("profile (spectral): the median network's share not measured (no kernels recorded)")
    return shape, hop, timing


class _AsrCopies:
    """Wraps the port's ``write_asr_copy_from_device`` to record, for each
    call, its input stem's device, a host copy of that stem and the int16
    copy it wrote; the call still runs it."""

    def __init__(self):
        from audio_cut_tpu_torch.io import audio as io_audio

        self.module = io_audio
        self.inner = io_audio.write_asr_copy_from_device
        self.calls = []

    def __enter__(self):
        def write_asr_copy_from_device(audio_device, sample_rate, dest, *args, **kwargs):
            out = self.inner(audio_device, sample_rate, dest, *args, **kwargs)
            self.calls.append((audio_device.device, audio_device.detach().cpu(), read_pcm16(out)))
            return out

        self.module.write_asr_copy_from_device = write_asr_copy_from_device
        return self

    def __exit__(self, *exc):
        self.module.write_asr_copy_from_device = self.inner


def read_pcm16(path):
    """The int16 samples of a mono 16 kHz PCM_16 WAV file."""
    import wave

    import numpy as np

    with wave.open(str(path), "rb") as w:
        if (w.getframerate(), w.getsampwidth(), w.getnchannels()) != (16000, 2, 1):
            fail(f"{path}: not mono 16 kHz PCM_16")
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int32)


def write_timeline(path: Path, phrases) -> dict:
    """A lyrics timeline in the schema of tests/fixtures/lyrics/: two words
    inside each voice phrase, one sentence and one mVAD region per phrase."""
    words, sentences, regions = [], [], []
    for k, (a, b) in enumerate(phrases):
        words += [{"text": f"la{k}", "start_s": round(a + 0.10, 3), "end_s": round(a + 0.95, 3),
                   "confidence": 0.9},
                  {"text": f"lo{k}", "start_s": round(a + 1.10, 3), "end_s": round(b - 0.20, 3),
                   "confidence": 0.9}]
        sentences.append({"text": f"la{k} lo{k}.", "start_s": round(a + 0.10, 3),
                          "end_s": round(b - 0.20, 3), "confidence": 0.9})
        regions.append({"start_s": round(a, 3), "end_s": round(b, 3), "kind": "singing",
                        "confidence": 0.9})
    timeline = {"language": "en", "words": words, "sentences": sentences, "vad_regions": regions}
    path.write_text(json.dumps(timeline, indent=1), encoding="utf-8")
    return timeline


def run_lyrics(torch, dev, work: Path, audio, phrases):
    """vpbd_asr with lyric priors on ``song_chorus.wav`` (``audio``), through
    the intent argument ``segments="many"`` with no device: with the fake
    provider on a timeline of the song's phrases (lyric candidates in the
    pool, per-segment lyrics, the intent echo, K1 once per piece and K2 1, the exact
    splice, an ASR copy made from the CUDA stem and within one PCM_16 step of
    the CPU's copy of the same stem); on the default provider chain
    (``lyrics_unavailable:no_provider``); and strict with the null provider,
    which must raise ``LyricsAlignmentUnavailable``. Then call 0 once more
    under the profiler."""
    import numpy as np

    from audio_cut_tpu_torch import separate_and_segment
    from audio_cut_tpu_torch.exceptions import LyricsAlignmentUnavailable
    from audio_cut_tpu_torch.io.audio import write_asr_copy_from_device

    song = work / "song_chorus.wav"
    fixture = work / "song_chorus_timeline.json"
    timeline = write_timeline(fixture, phrases)
    print(f"lyrics: timeline of {len(phrases)} phrases, {len(timeline['words'])} words, written to "
          f"the work directory")
    torch.cuda.reset_peak_memory_stats(dev)
    kernels = reset_counts()  # the lyrics path starts: only its launches count
    K0, K1, K2 = kernels["K0"], kernels["K1"], kernels["K2"]

    out = work / "lyrics0"
    with _AsrCopies() as copies:
        t0 = time.perf_counter()
        m = separate_and_segment(input_uri=str(song), export_dir=str(out), segments="many",
                                 runtime_overrides={"lyrics_alignment.provider": "fake",
                                                    "lyrics_alignment.fixture_path": str(fixture)})
        wall = time.perf_counter() - t0
    k1, k2 = K1.launches, K2.launches
    counts = m["boundary_detection"]["candidate_counts"]
    la = m.get("lyrics_alignment") or {}
    print(f"lyrics call 0 (segments=many, fake provider): {wall:.3f} s wall, {SONG_S / wall:.2f} "
          f"audio-s per wall-s, fused pass {m['gpu']['gpu_pipeline_compute_ms']:.1f} ms, K1 "
          f"launches {k1}, K2 launches {k2}; mode {m['version']}, note {m.get('note')}, provider "
          f"{la.get('provider')}, {la.get('word_count')} words; candidate_counts {counts}; "
          f"intent {m.get('intent')}")
    if m["version"] != "vpbd_asr" or "note" in m or la.get("provider") != "fake":
        fail(f"lyrics: mode {m['version']}, note {m.get('note')!r}, provider {la.get('provider')!r}; "
             "expected vpbd_asr, no note, fake")
    check_pass("lyrics call 0", m, k1, k2)
    if counts.get("lyrics", 0) <= 0:
        fail(f"lyrics: no lyric candidate in the pool: {counts}")
    if (m.get("intent") or {}).get("segments") != "many":
        fail(f"lyrics: the manifest's intent echo is {m.get('intent')}")
    check_segments(m, out, audio)
    for seg in m["segments"]:
        inside = [w["text"] for w in timeline["words"]
                  if seg["start"] <= w["start_s"] and w["end_s"] <= seg["end"]]
        got = [w["text"] for w in (seg.get("lyrics") or {}).get("words", [])]
        if not set(inside) <= set(got):
            fail(f"lyrics: segment {seg['id']} holds words {inside} but carries {got}")
    with_lyrics = [s["id"] for s in m["segments"] if s.get("lyrics")]
    if not with_lyrics:
        fail("lyrics: no segment carries lyrics")
    print(f"lyrics call 0: {len(m['segments'])} segments, {len(with_lyrics)} carry lyrics; cuts "
          f"(samples) {m['cuts']['samples']}, spliced back exactly; guard {m['guard']['shift_stats']}")

    # the ASR copy: made from the CUDA stem, within one PCM_16 step of the CPU's
    if len(copies.calls) != 1:
        fail(f"lyrics: {len(copies.calls)} device ASR copies in the call, expected 1")
    stem_device, stem, card_copy = copies.calls[0]
    if stem_device.type != "cuda":
        fail(f"lyrics: the ASR copy was made from a stem on {stem_device}")
    cpu_copy = read_pcm16(write_asr_copy_from_device(stem, SR, work / "asr_cpu.wav"))
    diff = np.abs(card_copy - cpu_copy) if card_copy.size == cpu_copy.size else None
    print(f"lyrics: ASR copy from the {stem_device} stem: {card_copy.size} int16 samples at 16 kHz "
          f"(CPU copy of the same stem: {cpu_copy.size}); "
          + (f"max |card - CPU| = {int(diff.max())} LSB, {int((diff > 0).sum())} samples differ"
             if diff is not None else "lengths differ"))
    if diff is None or diff.max() > 1:
        fail("lyrics: the card's ASR copy is not within one PCM_16 step of the CPU's")

    # the default provider chain ends at null
    out = work / "lyrics1"
    k1, k2 = K1.launches, K2.launches
    t0 = time.perf_counter()
    m = separate_and_segment(input_uri=str(song), export_dir=str(out), segments="many")
    wall = time.perf_counter() - t0
    k1, k2 = K1.launches - k1, K2.launches - k2
    print(f"lyrics call 1 (segments=many, default chain): {wall:.3f} s wall, {SONG_S / wall:.2f} "
          f"audio-s per wall-s, K1 launches {k1}, K2 launches {k2}, note {m.get('note')}")
    if m.get("note") != "lyrics_unavailable:no_provider":
        fail(f"lyrics: note {m.get('note')!r}; expected 'lyrics_unavailable:no_provider'")
    check_pass("lyrics call 1", m, k1, k2)
    check_segments(m, out, audio)

    # strict, with the null provider: raises
    strict = {"lyrics_alignment.enabled": True, "lyrics_alignment.provider": "null",
              "lyrics_alignment.strict": True}
    try:
        separate_and_segment(input_uri=str(song), export_dir=str(work / "lyrics2"),
                             mode="vpbd_asr", runtime_overrides=strict)
    except LyricsAlignmentUnavailable as exc:
        print(f"lyrics call 2 (strict, null provider): raised LyricsAlignmentUnavailable ({exc})")
    else:
        fail("lyrics: strict vpbd_asr with the null provider did not raise")
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"lyrics: launches in the 3 calls {launches}")
    if K0.launches != 1:
        fail(f"K0 launched {K0.launches} times in the lyrics calls; expected once")
    print(f"lyrics: torch.cuda.max_memory_allocated = {torch.cuda.max_memory_allocated(dev)} bytes")
    # call 0 once more, profiled: where its host time goes beside vpbd_acoustic's
    profile_call(torch, work, mode="vpbd_asr", song="song_chorus.wav", name="lyrics",
                 overrides={"lyrics_alignment.enabled": True, "smart_cut.segments": "many",
                            "lyrics_alignment.provider": "fake",
                            "lyrics_alignment.fixture_path": str(fixture)})


def _unequal_fields(a, b) -> list:
    """The DetectionBundle fields (and feature fields) of ``a`` and ``b``
    that are not equal bit for bit. ``features.extras`` is left out: the
    host tail writes into it."""
    from dataclasses import fields

    import numpy as np

    unequal = []
    for f in fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        pairs = ([(g.name, getattr(x, g.name), getattr(y, g.name)) for g in fields(x)
                  if g.name != "extras"] if f.name == "features" else [(f.name, x, y)])
        unequal += [name for name, u, v in pairs
                    if not np.array_equal(np.asarray(u), np.asarray(v))]
    return unequal


def staged_check(torch, dev, work: Path, warm, warm_m, audio):
    """The staged bundle path (device_pipeline.fused_program: false). First
    the bundle over the warm v2.2_mdd call's own stems, through the bundle
    function, with the same ConvVAD: every array must equal the fused pass's
    bit for bit. Then one call on the staged path through the entry point,
    which separates the song again: K1 once per piece and K2 once, the
    engine's gpu_pipeline_mode (device_ola_pipelined_p<pieces>), the exact splice, the bundle that reached
    its host tail equal to the warm fused call's bit for bit, and the same
    cuts."""
    from dataclasses import fields

    from audio_cut_tpu_torch import separate_and_segment
    from audio_cut_tpu_torch.analysis.bundle import build_detection_bundle
    from audio_cut_tpu_torch.models.vad import build_vad
    from audio_cut_tpu_torch.separation import fused

    sep, fused_bundle = warm
    rebuilt = build_detection_bundle(sep.mix_device, sep.vocal_device, SR, audio.size,
                                     vad_model=build_vad(SR, dev))
    unequal = _unequal_fields(fused_bundle, rebuilt)
    print(f"staged: build_detection_bundle over the warm call's stems against its fused bundle: "
          f"{len(fields(fused_bundle)) - 1} fields and {len(fields(fused_bundle.features)) - 1} "
          f"feature fields, bit for bit equal: {not unequal}")
    if unequal:
        fail(f"the rebuilt bundle differs from the fused one in {unequal}")
    del rebuilt

    kernels = reset_counts()  # the staged path starts: only its launches count
    out = work / "staged"
    with _Capture(fused) as cap:
        t0 = time.perf_counter()
        m = separate_and_segment(input_uri=str(work / "song.wav"), export_dir=str(out),
                                 runtime_overrides={"device_pipeline.fused_program": False})
        wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"staged v2.2_mdd call: {wall:.3f} s wall, {SONG_S / wall:.2f} audio-s per wall-s, "
          f"gpu_pipeline_mode {m['gpu']['gpu_pipeline_mode']}, pass "
          f"{m['gpu']['gpu_pipeline_compute_ms']:.1f} ms, launches {launches}")
    check_pass("staged call", m, launches["K1"], launches["K2"], label="engine")
    if launches["K0"] != 1:
        fail(f"staged call: launches {launches}; expected K0 once")
    check_segments(m, out, audio)
    if cap.last is None:
        fail("staged call: no bundle captured")
    unequal = _unequal_fields(fused_bundle, cap.last[1])
    print(f"staged: the staged call's bundle (its own separation) against the warm fused "
          f"call's, bit for bit equal: {not unequal}")
    if unequal:
        fail(f"the staged call's bundle differs from the warm fused call's in {unequal}")
    cuts, fused_cuts = m["cuts"]["samples"], warm_m["cuts"]["samples"]
    print(f"staged: cuts (samples) {cuts}; the warm fused call's {fused_cuts}; "
          f"equal {cuts == fused_cuts}")
    if cuts != fused_cuts:
        fail("the staged call's cuts differ from the warm fused call's")


def run_unpipelined(torch, dev, work: Path, audio, warm) -> None:
    """v2.2_mdd with ``device_pipeline.pipelined_upload: false``, twice (the
    first call in the process at the whole-track batch of 4, then warm): the
    whole-track path, one backend call of all 11 windows in groups of 4, so
    K1 3 and K2 once a call (K0 once) under ``fused_single_program``, the
    exact splice, the warm pipelined call's mix bit for bit and its stems
    within ``PIECE_SNR_DB`` and ``PIECE_ATOL``. Prints the walls and peak
    memory beside the pipelined calls', and profiles one more call."""
    import math

    from audio_cut_tpu_torch import separate_and_segment
    from audio_cut_tpu_torch.separation import fused

    torch.cuda.reset_peak_memory_stats(dev)
    kernels = reset_counts()  # the whole-track path starts: only its launches count
    with _Capture(fused) as cap:
        for call in range(CALLS):
            out = work / f"whole{call}"
            k1, k2 = kernels["K1"].launches, kernels["K2"].launches
            t0 = time.perf_counter()
            m = separate_and_segment(input_uri=str(work / "song.wav"), export_dir=str(out),
                                     runtime_overrides=UNPIPELINED)
            wall = time.perf_counter() - t0
            k1, k2 = kernels["K1"].launches - k1, kernels["K2"].launches - k2
            print(f"whole-track v2.2_mdd call {call} (pipelined_upload false): {wall:.3f} s wall, "
                  f"{SONG_S / wall:.2f} audio-s per wall-s (the pipelined warm call: "
                  f"{SONG_S / WALLS['v2.2_mdd warm']:.2f}), pass "
                  f"{m['gpu']['gpu_pipeline_compute_ms']:.1f} ms, {m['gpu']['gpu_pipeline_mode']}, "
                  f"K1 launches {k1}, K2 launches {k2}")
            check_pass(f"whole-track call {call}", m, k1, k2, overrides=UNPIPELINED)
            check_segments(m, out, audio)
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"whole-track: launches in the {CALLS} calls {launches}, peak memory "
          f"{torch.cuda.max_memory_allocated(dev)} bytes")
    if launches["K0"] != 1:
        fail(f"whole-track calls: launches {launches}; expected K0 once")
    sep, ref = cap.last[0], warm[0]
    if not torch.equal(sep.mix_device, ref.mix_device):
        fail("whole-track call: the mix differs from the pipelined call's")
    for stem, got, want in (("vocal", sep.vocal_device, ref.vocal_device),
                            ("instrumental", sep.instrumental_device, ref.instrumental_device)):
        diff = got.double() - want.double()
        noise = float((diff ** 2).sum())
        snr = 10 * math.log10(float((want.double() ** 2).sum()) / noise) if noise else math.inf
        err = float(diff.abs().max())
        print(f"whole-track call: {stem} against the pipelined warm call's: SNR {snr:.2f} dB "
              f"(>= {PIECE_SNR_DB[stem]}), max |diff| {err:.3e} (<= {PIECE_ATOL}); mix bit for "
              f"bit equal")
        if not (snr >= PIECE_SNR_DB[stem] and err <= PIECE_ATOL):
            fail(f"whole-track call: the {stem} stem is beyond its bound against the pipelined one")
    del sep, ref
    profile_call(torch, work, overrides=UNPIPELINED, name="whole-track")


def run_yaml_config(torch, dev, work: Path, audio) -> None:
    """A YAML config file named by ``$AUDIO_CUT_TPU_CONFIG`` that sets
    ``device_pipeline.piece_windows: 3``: the manager reloads it, and one
    v2.2_mdd call then cuts the 11 windows into 4 pieces (3, 3, 3, 2), so K1
    4 and K2 once under ``fused_pipelined_p4``, with the exact splice. The
    variable is removed and the config reloaded after the call."""
    from audio_cut_tpu_torch import separate_and_segment
    from audio_cut_tpu_torch.config import get_config, get_config_manager

    site = work / "site.yaml"
    site.write_text("# a site config\ndevice_pipeline:\n  piece_windows: 3   # wider pieces\n")
    want = expected_pass(audio.size, overrides=YAML_PIECES)
    if want["sizes"] != [3, 3, 3, 2] or want["fused"] != "fused_pipelined_p4":
        fail(f"YAML config: expected pieces {want['sizes']}, not 3, 3, 3, 2")
    mgr = get_config_manager()
    before = os.environ.get("AUDIO_CUT_TPU_CONFIG")
    os.environ["AUDIO_CUT_TPU_CONFIG"] = str(site)
    try:
        mgr.reload()
        if get_config("device_pipeline.piece_windows") != 3:
            fail("YAML config: the file's piece_windows did not take effect")
        kernels = reset_counts()  # the YAML-config path starts: only its launches count
        out = work / "yaml"
        t0 = time.perf_counter()
        m = separate_and_segment(input_uri=str(work / "song.wav"), export_dir=str(out))
        wall = time.perf_counter() - t0
    finally:
        if before is None:
            os.environ.pop("AUDIO_CUT_TPU_CONFIG", None)
        else:
            os.environ["AUDIO_CUT_TPU_CONFIG"] = before
        mgr.reload()
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"YAML config call ($AUDIO_CUT_TPU_CONFIG, piece_windows 3): {wall:.3f} s wall, "
          f"{SONG_S / wall:.2f} audio-s per wall-s, {m['gpu']['gpu_pipeline_mode']}, launches "
          f"{launches}")
    check_pass("YAML config call", m, launches["K1"], launches["K2"], overrides=YAML_PIECES)
    check_segments(m, out, audio)
    if get_config("device_pipeline.piece_windows") != 2:
        fail("YAML config: the default piece_windows did not come back after the reload")


def bundle_parity(torch, dev, warm, audio):
    """The detection half on the card against the CPU (plain versions, f32),
    from the warm call's stems; then the cut lists that the v2.2_mdd and the
    vpbd host tails make from each bundle (printed, not held: the style's
    thresholds and the DP's argmax may flip on differences within
    BUNDLE_TOL)."""
    import numpy as np

    from audio_cut_tpu_torch.analysis import bundle as TB
    from audio_cut_tpu_torch.config import get_config, get_config_manager
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
    mgr = get_config_manager()
    for mode in ("v2.2_mdd", "vpbd_acoustic"):
        plans = {}
        for side, b in bundles.items():
            snapshot = mgr.snapshot()  # the vpbd tail sets runtime overrides, as in a call
            try:
                plans[side] = _plan_cuts(audio, SR, b, vads[side], vads[side], qc,
                                         qc.get("enforce_quiet_cut", {}) or {},
                                         qc.get("local_boundary_refine", {}) or {}, mode=mode)
            finally:
                mgr.restore(snapshot)
            plan = plans[side]
            style = ""
            if plan["auto_profile"] is not None:
                ap = plan["auto_profile"].get("auto_profile", {})
                style = (f"style {ap.get('style')} confidence {ap.get('confidence')} anchors "
                         f"{ap.get('anchor_weights')} features {ap.get('features')}; ")
            print(f"bundle: {mode} host tail fed the {side} bundle: {style}cuts "
                  f"{plan['cut_samples']}, labels {['human' if f else 'music' for f in plan['flags']]}")
        card, cpu = plans["card"], plans["cpu"]
        print(f"bundle: {mode}: the two cut lists are equal: "
              f"{card['cut_samples'] == cpu['cut_samples']}")
        if mode != "v2.2_mdd":
            # what may flip on differences within BUNDLE_TOL: the style's inputs
            # and thresholds, the pool, the DP's choice
            ap_card = card["auto_profile"].get("auto_profile", {})
            ap_cpu = cpu["auto_profile"].get("auto_profile", {})
            bd_card, bd_cpu = card["boundary_detection"], cpu["boundary_detection"]
            same = {
                "style": ap_card.get("style") == ap_cpu.get("style"),
                "style features": ap_card.get("features") == ap_cpu.get("features"),
                "anchor weights": ap_card.get("anchor_weights") == ap_cpu.get("anchor_weights"),
                "candidate counts": bd_card["candidate_counts"] == bd_cpu["candidate_counts"],
                "selected times": ([c["t"] for c in bd_card["selected"]]
                                   == [c["t"] for c in bd_cpu["selected"]]),
                "cut samples": card["cut_samples"] == cpu["cut_samples"],
            }
            print(f"bundle: {mode}: card vs CPU, equal: {same}")
            for c_card, c_cpu in zip(bd_card["selected"], bd_cpu["selected"]):
                if c_card["t"] != c_cpu["t"]:
                    print(f"bundle: {mode}: a selected candidate differs: card t "
                          f"{c_card['t']!r} (detected {c_card.get('t_detected')!r}, "
                          f"{c_card['source']}), CPU t {c_cpu['t']!r} (detected "
                          f"{c_cpu.get('t_detected')!r}, {c_cpu['source']})")


def run_separation(torch, dev, work: Path, audio):
    """The first slice's path, once: mode="vocal_separation" on the card."""
    from audio_cut_tpu_torch import separate_and_segment

    K1 = reset_counts()["K1"]  # this path starts: only its launches count
    t0 = time.perf_counter()
    m = separate_and_segment(input_uri=str(work / "song.wav"), export_dir=str(work / "sep"),
                             mode="vocal_separation")
    wall = time.perf_counter() - t0
    print(f"vocal_separation call (warm): {wall:.3f} s wall, {SONG_S / wall:.2f} audio-s per "
          f"wall-s, K1 launches {K1.launches}, {m['gpu']['gpu_pipeline_mode']}")
    if not m["success"]:
        fail(f"vocal_separation failed: {m}")
    want = expected_pass(audio.size)
    if (m["gpu"]["gpu_pipeline_device"] != "cuda" or m["gpu"]["gpu_pipeline_mode"] != want["engine"]
            or K1.launches != want["k1"]):
        fail(f"vocal_separation: K1 {K1.launches}, gpu {m['gpu']}; expected K1 {want['k1']} on "
             f"cuda, {want['engine']}")
    check_stems("vocal_separation", m, work / "sep", audio)


def check_stems(tag: str, m, out: Path, audio) -> None:
    """The exported stems of a vocal_separation call: 24-bit, the input's
    length, finite, and summing to the mix within 2.5 steps of PCM-24."""
    import numpy as np

    from audio_cut_tpu_torch.io import read_wav, wav_info

    stems = []
    for key in ("vocal_full", "instrumental_full"):
        info = wav_info(out / m["artifacts"][key])
        x, sr = read_wav(out / m["artifacts"][key])
        if info.bits_per_sample != 24 or sr != SR or x.shape != audio.shape:
            fail(f"{tag}: {key}: {info} shape {x.shape}, expected 24-bit {audio.shape}")
        if not np.isfinite(x).all():
            fail(f"{tag}: {key} is not finite")
        stems.append(x)
    err = float(np.abs(stems[0].astype(np.float64) + stems[1] - audio).max())
    if err > 2.5 / 8388607.0:
        fail(f"{tag}: vocal + instrumental differs from the mix by {err}")
    print(f"{tag}: stems 24-bit x {audio.size} samples, finite, "
          f"|vocal + instrumental - mix| <= {err:.3e}")

def _backend_under(overrides: Optional[dict], name: str = "convtdf", device: str = "cuda"):
    """The ``name`` backend the entry points use under ``overrides`` (the
    backend cache's instance: they ask for "cuda", and the cache keeps the
    backends of this script's configurations without dropping one); with
    ``device="cpu"``, the same backend on the CPU."""
    from audio_cut_tpu_torch.config import get_config_manager
    from audio_cut_tpu_torch.config.manager import set_nested
    from audio_cut_tpu_torch.separation.backends import make_backend

    mgr = get_config_manager()
    snapshot = mgr.snapshot()
    try:
        for key, value in (overrides or {}).items():
            set_nested(mgr.config, key, value)
        return make_backend(name, SR, device)
    finally:
        mgr.restore(snapshot)


def one_window_parity(torch, dev, audio, overrides: Optional[dict] = None):
    """The port's separator on one window: card (bf16, K1) vs CPU (f32,
    plain), through ``separate_shifted`` at the ``shifts`` of the backend
    that ``overrides`` give (1: the plain forward; s: s rows in one forward)."""
    from audio_cut_tpu_torch.models.convtdf import ConvTDFSeparator

    backend = _backend_under(overrides)
    sep, shifts = backend.sep, backend.shifts
    cpu = ConvTDFSeparator(SR, n_fft=sep.n_fft, hop=sep.hop, dim_f=sep.dim_f, dim_t=sep.dim_t,
                           channels=sep.net.first.conv1.out_channels, depth=sep.net.depth,
                           tdf_bottleneck=sep.net.first.tdf.fc1.out_features,
                           dtype=torch.float32)
    cpu.net.load_state_dict({k: v.cpu() for k, v in sep.net.state_dict().items()})
    w = sep.window_samples
    start = int(10.0 * SR)
    x = torch.from_numpy(audio[start:start + w].copy())[None]
    v_gpu, _ = sep.separate_shifted(x.to(dev), w, shifts)
    t0 = time.perf_counter()
    v_cpu, _ = cpu.separate_shifted(x, w, shifts)
    cpu_s = time.perf_counter() - t0
    snr = snr_db(v_cpu[0].numpy(), v_gpu[0].float().cpu().numpy())
    print(f"one-window parity ({w} samples, shifts {shifts}: {shifts} rows in one forward): "
          f"vocal SNR card bf16 vs CPU f32 = {snr:.2f} dB (required >= {PARITY_SNR_DB}); "
          f"CPU forward {cpu_s:.2f} s")
    if not snr >= PARITY_SNR_DB:
        fail(f"one-window parity {snr:.2f} dB < {PARITY_SNR_DB} dB")


def run_shifts(torch, dev, work: Path, audio, base_vocal):
    """v2.2_mdd with ``enhanced_separation.convtdf.shifts: 2``, cold (the
    process's first shifts-2 backend) then warm: each call K1 and K2 as
    ``expected_pass`` says (a forward takes map_group // 2 = 2 windows, so
    one K1 a piece, at 4 rows, 2 for the last piece), K0 once, every K1 at
    (rows, 256, n_fft), ``fused_pipelined_p6`` and the exact splice. Prints
    the walls and peak memory, and the SNR of the warm call's vocal against
    the default warm call's (``base_vocal``, shifts 1; printed, not held);
    then one window at shifts 2 (2 rows) card against CPU. Returns the K1
    launches and their shapes over the two calls."""
    from audio_cut_tpu_torch import separate_and_segment
    from audio_cut_tpu_torch.separation import fused

    want = expected_pass(audio.size, overrides=SHIFTS)
    print(f"shifts 2: expected pieces {want['sizes']}, K1 {want['k1']} at rows {want['rows']}")
    torch.cuda.reset_peak_memory_stats(dev)
    kernels = reset_counts()  # the shifts path starts: only its launches count
    with _Capture(fused) as cap, _K1Rows() as rec:
        for call in range(CALLS):
            out = work / f"shifts{call}"
            k1, k2, first = kernels["K1"].launches, kernels["K2"].launches, len(rec.shapes)
            t0 = time.perf_counter()
            m = separate_and_segment(input_uri=str(work / "song.wav"), export_dir=str(out),
                                     runtime_overrides=SHIFTS)
            wall = time.perf_counter() - t0
            k1, k2 = kernels["K1"].launches - k1, kernels["K2"].launches - k2
            shapes = rec.shapes[first:]
            label = "cold" if call == 0 else "warm"
            WALLS[f"shifts 2 {label}"] = wall
            print(f"shifts 2 v2.2_mdd call {call} ({label}): {wall:.3f} s wall, "
                  f"{SONG_S / wall:.2f} audio-s per wall-s (shifts 1 warm: "
                  f"{SONG_S / WALLS['v2.2_mdd warm']:.2f}), pass "
                  f"{m['gpu']['gpu_pipeline_compute_ms']:.1f} ms, {m['gpu']['gpu_pipeline_mode']}, "
                  f"K1 launches {k1} {rec.counts(first)}, K2 launches {k2}")
            check_pass(f"shifts 2 call {call}", m, k1, k2, overrides=SHIFTS)
            window = (256, 6144)
            if [b for b, *_ in shapes] != want["rows"] or any(tuple(r) != window
                                                            for _, *r in shapes):
                fail(f"shifts 2 call {call}: K1 at {shapes}; expected rows {want['rows']} "
                     f"of {window}")
            check_segments(m, out, audio)
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"shifts 2: launches in the {CALLS} calls {launches}, peak memory "
          f"{torch.cuda.max_memory_allocated(dev)} bytes")
    if launches["K0"] != 1:
        fail(f"shifts 2 calls: launches {launches}; expected K0 once")
    vocal = cap.last[0].vocal_device.cpu().numpy()
    print(f"shifts 2: warm vocal against the shifts 1 warm vocal: SNR "
          f"{snr_db(base_vocal, vocal):.2f} dB (printed, not held)")
    one_window_parity(torch, dev, audio, SHIFTS)
    profile_call(torch, work, overrides=SHIFTS, name="shifts 2")
    return {"launches": launches["K1"], "shapes": rec.counts()}


def expected_batch(lengths) -> list:
    """The rows of each K1 launch of the batch's mesh pass over one device:
    the tracks grouped by padded length (groups in ascending order), each
    group's windows, track after track, in forwards of ``map_group``."""
    from audio_cut_tpu_torch.separation.engine import ola_plan, padded_track_len

    model = _backend_under(None)
    g = model.engine_geometry()
    geometry = (g["chunk_s"], g["overlap_s"], g["halo_s"], int(g["align"]))
    groups = {}
    for n in lengths:
        padded = padded_track_len(n, SR, geometry[3])
        groups[padded] = groups.get(padded, 0) + 1
    rows = []
    for padded, count in sorted(groups.items()):
        total = count * len(ola_plan(padded, SR, *geometry)[0])
        rows += [min(model.map_group, total - j) for j in range(0, total, model.map_group)]
    return rows


def run_batch(torch, dev, work: Path, audio):
    """``separate_and_segment_batch`` over song.wav, song_chorus.wav and a
    ``BATCH_SHORT_S`` song, beside a warm single call of each: every single
    call K1 as ``expected_pass`` says and K2 once; the batch K1 as
    ``expected_batch`` says (two 60 s tracks' 22 windows and the 45 s
    bucket's 8 in forwards of 4) with those rows, K2 once a track, K0 once,
    every manifest a success labelled ``mesh_batch_precomputed`` with
    ``gpu_pipeline_batch_size`` 3, cuts and segments equal to the single
    call's, and the exact splice. Then ``separate_tracks_mesh`` on the card
    against ``SeparationEngine.separate_on_device`` of each track (max |diff|
    <= ``BATCH_STEM_ATOL``), and the injected engine's mix equal to the
    engine's. Prints the walls and peak memory of the batch and of the
    single calls. Returns K1's and K2's launches and K1's shapes in the
    batch."""
    from audio_cut_tpu_torch import separate_and_segment, separate_and_segment_batch
    from audio_cut_tpu_torch.io import read_wav, write_wav
    from audio_cut_tpu_torch.parallel.batch import separate_tracks_mesh
    from audio_cut_tpu_torch.separation.engine import SeparationEngine
    from audio_cut_tpu_torch.separation.precomputed import PrecomputedStemEngine

    write_wav(work / "song_short.wav", make_song(BATCH_SHORT_S, seed=11), SR, subtype="FLOAT")
    paths = [work / "song.wav", work / "song_chorus.wav", work / "song_short.wav"]
    tracks = [audio] + [read_wav(p)[0] for p in paths[1:]]

    torch.cuda.reset_peak_memory_stats(dev)
    kernels = reset_counts()  # the single calls: only their launches count
    singles, single_wall = [], 0.0
    for path, track in zip(paths, tracks):
        out = work / "single" / path.stem
        k1, k2 = kernels["K1"].launches, kernels["K2"].launches
        t0 = time.perf_counter()
        m = separate_and_segment(input_uri=str(path), export_dir=str(out))
        wall = time.perf_counter() - t0
        single_wall += wall
        k1, k2 = kernels["K1"].launches - k1, kernels["K2"].launches - k2
        want = expected_pass(track.size)
        print(f"batch phase, single call {path.name} ({track.size / SR:.0f} s): {wall:.3f} s "
              f"wall, K1 {k1}, K2 {k2}, {m['gpu']['gpu_pipeline_mode']}")
        if k1 != want["k1"] or k2 != 1 or m["gpu"]["gpu_pipeline_mode"] != want["fused"]:
            fail(f"single call {path.name}: K1 {k1}, K2 {k2}, {m['gpu']}; expected K1 "
                 f"{want['k1']}, K2 1, {want['fused']}")
        check_segments(m, out, track)
        singles.append(m)
    single_peak = torch.cuda.max_memory_allocated(dev)

    want_rows = expected_batch([t.size for t in tracks])
    torch.cuda.reset_peak_memory_stats(dev)
    kernels = reset_counts()  # the batch path starts: only its launches count
    with _K1Rows() as rec:
        t0 = time.perf_counter()
        batch = separate_and_segment_batch(input_uris=[str(p) for p in paths],
                                           export_dir=str(work / "batch"))
        wall = time.perf_counter() - t0
    batch_cuts = [json.loads(json.dumps(mb["cuts"])) for mb in batch]
    launches = {name: k.launches for name, k in kernels.items()}
    batch_peak = torch.cuda.max_memory_allocated(dev)
    print(f"batch of {len(paths)} tracks: {wall:.3f} s wall against {single_wall:.3f} s for "
          f"the {len(paths)} single calls ({sum(t.size for t in tracks) / SR / wall:.2f} against "
          f"{sum(t.size for t in tracks) / SR / single_wall:.2f} audio-s per wall-s); peak "
          f"memory {batch_peak} against {single_peak} bytes; launches {launches}, K1 "
          f"{rec.counts()}")
    if ([b for b, *_ in rec.shapes] != want_rows or launches["K2"] != len(paths)
            or launches["K0"] != 1):
        fail(f"batch: launches {launches}, K1 at {rec.shapes}; expected K1 rows {want_rows}, "
             f"K2 {len(paths)}, K0 1")
    for path, track, mb, ms in zip(paths, tracks, batch, singles):
        gpu = mb.get("gpu") or {}
        if (gpu.get("gpu_pipeline_mode") != "mesh_batch_precomputed"
                or gpu.get("gpu_pipeline_batch_size") != len(paths)
                or gpu.get("gpu_pipeline_device") != "cuda"):
            fail(f"batch {path.name}: gpu {gpu}")
        if mb["cuts"] != ms["cuts"] or mb["segments"] != ms["segments"]:
            fail(f"batch {path.name}: cuts {mb['cuts']['samples']} against the single call's "
                 f"{ms['cuts']['samples']}, or other segments")
        check_segments(mb, work / "batch" / path.stem, track)
        print(f"batch {path.name}: {len(mb['segments'])} segments, cuts (samples) "
              f"{mb['cuts']['samples']}, equal to the single call's; spliced back exactly")

    engine = SeparationEngine(SR, dev)
    errs = []
    for track, (v, i) in zip(tracks, separate_tracks_mesh(tracks, SR)):
        v_ref, i_ref, mix_ref, _ = engine.separate_on_device(track)
        errs.append(max(float((v - v_ref).abs().max()), float((i - i_ref).abs().max())))
        pre = PrecomputedStemEngine(SR, dev, v, "convtdf", align=engine._geometry()[3])
        if not torch.equal(pre.mix_device(track), mix_ref):
            fail("batch: the injected engine's mix differs from the engine's")
    print(f"batch: separate_tracks_mesh stems against SeparationEngine.separate_on_device, "
          f"max |diff| per track {errs} (<= {BATCH_STEM_ATOL}); the injected mix equal bit for bit")
    if not max(errs) <= BATCH_STEM_ATOL:
        fail(f"batch: stems differ from single engine runs by {max(errs)}")
    # one more warm batch under the profiler: the mesh pass's span on the
    # card against the host stage's
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batch = separate_and_segment_batch(input_uris=[str(p) for p in paths],
                                           export_dir=str(work / "prof_batch"))
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not all(m["success"] for m in batch):
        fail("profiled batch call failed")
    report_profile(torch, prof, wall_ms, "batch", spans_of=("mesh_pass",) + SPANS)
    return {"K1": launches["K1"], "K2": launches["K2"], "shapes": rec.counts(),
            "paths": paths, "tracks": tracks, "cuts": batch_cuts}


def _manifest_of(text: str) -> dict:
    """The manifest the CLI printed with ``--json`` (``indent=2``): the JSON
    object from the first "{" of ``text`` on."""
    _, brace, body = text.partition("{")
    return json.loads(brace + body)


def _shell_subprocess(tag: str, argv, timeout: int, env=None):
    """``python -m audio_cut_tpu_torch.cli *argv`` from the checkout's root:
    its stdout and its wall time from start to exit. Fails on a non-zero
    exit; the time limit kills it."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "audio_cut_tpu_torch.cli", *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout, env=env)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{tag}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    return proc.stdout, wall


def run_shell(torch, dev, work: Path, audio, warm_m, batch):
    """The shell: ``cli.main`` on the 60 s song in process (rc 0,
    ``reconstruction: OK``, ``check_pass``: K1 6, K2 1,
    ``fused_pipelined_p6``; the cuts of the warm ``v2.2_mdd`` call of
    ``run_mdd``); its ``batch`` verb over the batch phase's three songs (rc 0,
    three JSON lines with ``success``, K1 at ``expected_batch``'s rows, K2 3,
    K0 1, each track's cuts those of the batch phase); ``warmup --json`` in a
    fresh process (rc 0, every step ok, the kernels found built: every build
    step 0.0 s); the 60 s song in a fresh process (rc 0, the exact splice;
    its wall from start to exit is the first-track latency with the kernels
    built); and ``quick_start.run_interactive`` with its answers scripted
    (``QUICK_START_ANSWERS``) on a directory holding the song with the loud
    section, which runs vpbd_asr's intent (rc 0, ``check_pass``, the manifest
    passes ``check_vpbd``). The CLI configures the root logger; it is
    restored after the in-process calls."""
    import builtins
    import contextlib
    import io
    import logging

    from audio_cut_tpu_torch import cli, quick_start
    from audio_cut_tpu_torch.io import read_wav

    smi = nvidia_smi_line()
    song = work / "song.wav"
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        kernels = reset_counts()  # the CLI call: only its launches count
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = cli.main([str(song), "-o", str(work / "cli"), "--json",
                           "--validate-reconstruction"])
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        head = text.getvalue().partition("{")[0].strip()
        print(f"shell: cli.main on song.wav: rc {rc}, {head!r}, {wall:.3f} s wall, launches "
              f"{launches} [{smi}]")
        if rc != 0 or head != "reconstruction: OK":
            fail(f"shell: cli.main gave rc {rc} and {head!r}; expected 0 and 'reconstruction: OK'")
        m = _manifest_of(text.getvalue())
        check_pass("shell: cli.main", m, launches["K1"], launches["K2"])
        check_segments(m, work / "cli", audio)
        if m["cuts"]["samples"] != list(warm_m["cuts"]["samples"]):
            fail(f"shell: cli.main cuts {m['cuts']['samples']} against the warm API call's "
                 f"{warm_m['cuts']['samples']}")
        print(f"shell: cli.main: {len(m['segments'])} segments, cuts (samples) "
              f"{m['cuts']['samples']}, equal to the warm v2.2_mdd call's; spliced back exactly")

        want_rows = expected_batch([t.size for t in batch["tracks"]])
        kernels = reset_counts()  # the batch verb: only its launches count
        text = io.StringIO()
        with _K1Rows() as rec, contextlib.redirect_stdout(text):
            t0 = time.perf_counter()
            rc = cli.main(["batch", *[str(p) for p in batch["paths"]], "-o",
                           str(work / "cli_batch"), "--json"])
            wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        rows = [json.loads(line) for line in text.getvalue().splitlines() if line.startswith("{")]
        print(f"shell: batch verb over {len(batch['paths'])} tracks: rc {rc}, {wall:.3f} s wall, "
              f"launches {launches}, K1 {rec.counts()} [{smi}]")
        if rc != 0 or len(rows) != len(batch["paths"]) or not all(r["success"] for r in rows):
            fail(f"shell: batch verb rc {rc}, lines {rows}")
        if ([b for b, *_ in rec.shapes] != want_rows or launches["K2"] != len(rows)
                or launches["K0"] != 1):
            fail(f"shell: batch verb launches {launches}, K1 at {rec.shapes}; expected K1 rows "
                 f"{want_rows}, K2 {len(rows)}, K0 1")
        for row, path, track, cuts in zip(rows, batch["paths"], batch["tracks"], batch["cuts"]):
            mb = json.loads(Path(row["manifest"]).read_text(encoding="utf-8"))
            if mb["cuts"] != cuts:
                fail(f"shell: batch verb {path.name}: cuts {mb['cuts']['samples']} against the "
                     f"batch phase's {cuts['samples']}")
            check_segments(mb, work / "cli_batch" / path.stem, track)
            print(f"shell: batch verb {path.name}: {row['segments']} segments, cuts equal to the "
                  f"batch phase's; spliced back exactly")
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)

    # warmup and a first track, each in a fresh process; the kernels this run
    # built are in audio_cut_tpu_torch/_build/
    tmp = work / "tmp"
    tmp.mkdir()
    env = dict(os.environ, TMPDIR=str(tmp))
    out, wall = _shell_subprocess("shell: warmup", ["warmup", "--json"], WARMUP_TIMEOUT_S, env)
    report = json.loads(out.strip().splitlines()[-1])
    for step in report["steps"]:
        print(f"shell: warmup step {step['name']}: ok {step['ok']}, {step['wall_s']} s [{smi}]")
    print(f"shell: warmup (fresh process, default durations): total_s {report['total_s']}, "
          f"{wall:.3f} s from start to exit [{smi}]")
    names = [s["name"] for s in report["steps"]]
    want_names = ([f"build_{n}.cu" for n in sorted(KERNEL_SOURCES)] + ["kernel_library_check"]
                  + [f"v2.2_mdd_{d}s" for d in (15, 75, 120, 180, 240)]
                  + ["vocal_separation", "vpbd_asr"])
    if names != want_names or not all(s["ok"] for s in report["steps"]):
        fail(f"shell: warmup steps {report['steps']}; expected {want_names}, every one ok")
    rebuilt = [s for s in report["steps"] if s["name"].startswith("build_") and s["wall_s"] != 0.0]
    if rebuilt:
        fail(f"shell: warmup rebuilt {rebuilt}: the libraries this run built were not found")

    out, wall = _shell_subprocess("shell: first track",
                                  [str(song), "-o", str(work / "first"), "--json"],
                                  FIRST_TRACK_TIMEOUT_S, env)
    m = _manifest_of(out)
    check_segments(m, work / "first", audio)
    same = m["cuts"]["samples"] == list(warm_m["cuts"]["samples"])
    print(f"shell: first track (fresh process, kernels built): {wall:.3f} s from start to exit, "
          f"of which the split itself {m['timings_ms']['total']} ms (the manifest's "
          f"timings_ms.total); {m['gpu']['gpu_pipeline_mode']}, {len(m['segments'])} segments, "
          f"cuts (samples) "
          f"{m['cuts']['samples']}, spliced back exactly; cuts equal to the warm API call's: "
          f"{same} [{smi}]")

    # quick_start on a directory holding the song with the loud section
    qdir = work / "qs_input"
    qdir.mkdir()
    shutil.copy(work / "song_chorus.wav", qdir / "song_chorus.wav")
    answers = iter(QUICK_START_ANSWERS)
    ask = builtins.input
    builtins.input = lambda *_a: next(answers)
    kernels = reset_counts()  # quick_start: only its launches count
    try:
        t0 = time.perf_counter()
        rc = quick_start.run_interactive(str(qdir), output_dir=str(work / "qs_out"))
        wall = time.perf_counter() - t0
    finally:
        builtins.input = ask
    launches = {name: k.launches for name, k in kernels.items()}
    out = work / "qs_out" / "song_chorus"
    print(f"shell: quick_start {QUICK_START_ANSWERS}: rc {rc}, {wall:.3f} s wall, launches "
          f"{launches} [{smi}]")
    if rc != 0:
        fail(f"shell: quick_start gave rc {rc}")
    m = json.loads((out / "SegmentManifest.json").read_text(encoding="utf-8"))
    if m["version"] != "vpbd_asr" or (m.get("intent") or {}).get("segments") != "medium":
        fail(f"shell: quick_start ran {m['version']} with intent {m.get('intent')}; expected "
             "vpbd_asr with segments 'medium'")
    check_pass("shell: quick_start", m, launches["K1"], launches["K2"])
    check_vpbd(m, out, read_wav(work / "song_chorus.wav")[0], "shell: quick_start")
    print(f"shell: quick_start: {len(m['segments'])} segments, cuts (samples) "
          f"{m['cuts']['samples']}, note {m.get('note')}; spliced back exactly")


def _merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _union_us(intervals) -> float:
    return sum(b - a for a, b in _merged(intervals))


def _overlap_us(interval, merged) -> float:
    a, b = interval
    return sum(max(0.0, min(b, d) - max(a, c)) for c, d in merged)


def _print_top(prefix: str, kernels, count: int) -> None:
    by_name = {}
    for e in kernels:
        ms, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, k + 1)
    for name, (ms, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:count]:
        print(f"profile:   {prefix}{ms:8.3f} ms  {k:4d}x  {name[:110]}")


def profile_call(torch, work: Path, mode: str = "v2.2_mdd", song: str = "song.wav",
                 overrides: Optional[dict] = None, name: Optional[str] = None):
    """One more warm call of ``mode`` on ``song`` (with ``overrides``, printed
    as ``name``) under torch.profiler: where its time goes. Returns (the
    device kernels, their busy ms); none when the profiler recorded none."""
    from torch.profiler import ProfilerActivity, profile

    from audio_cut_tpu_torch import separate_and_segment

    from audio_cut_tpu_torch.separation import engine

    name = name or mode
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = separate_and_segment(input_uri=str(work / song), export_dir=str(work / f"prof_{name}"),
                                 mode=mode, runtime_overrides=overrides)
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not m["success"]:
        fail(f"profiled {name} call failed")
    print(f"profile ({name}): fused pass (gpu_pipeline_compute_ms) "
          f"{m['gpu']['gpu_pipeline_compute_ms']:.1f} ms")
    # the upload's host buffers: pinned, or a non_blocking copy would be a
    # silent synchronous one
    staging = [t for layout in engine._OLA_CACHE.values() if layout
               for t in layout["staging"].values()]
    print(f"profile ({name}): {len(staging)} cached staging buffers, pinned: "
          f"{[t.is_pinned() for t in staging]}")
    if not staging or not all(t.is_pinned() for t in staging):
        fail(f"profile ({name}): a staging buffer of the upload is not pinned")
    return report_profile(torch, prof, wall_ms, name)


def report_profile(torch, prof, wall_ms: float, name: str, spans_of=SPANS):
    """Where the time of one profiled call went: the host spans ``spans_of``,
    the card's busy time and idle share, the top kernels, the upload copies'
    overlap with kernels, each span's range on the card, and K1's and K2's
    time per launch. Returns (the device kernels, their busy ms)."""
    events = prof.events()
    spans = {}
    for e in events:
        if e.name in spans_of and e.device_type == torch.autograd.DeviceType.CPU:
            spans[e.name] = spans.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    print(f"profile (warm {name} call under torch.profiler): wall {wall_ms:.1f} ms; spans (ms): "
          + ", ".join(f"{k} {spans.get(k, float('nan')):.1f}" for k in spans_of))
    on_card = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    # the spans also show on the card's timeline, as the range their kernels
    # cover: one range per stream (the upload's copies run on a side stream),
    # so a span's range is the union's hull
    ranges = {}
    for e in on_card:
        if e.name in spans_of:
            a, b = ranges.get(e.name, (e.time_range.start, e.time_range.end))
            ranges[e.name] = (min(a, e.time_range.start), max(b, e.time_range.end))
    kernels = [e for e in on_card if e.name not in spans_of]
    if not kernels:
        print(f"profile ({name}): device busy time not measured (the profiler recorded no kernels)")
        return [], 0.0
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    print(f"profile ({name}): card busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall "
          f"(idle share {1 - busy_ms / wall_ms:.3f}), {len(kernels)} kernel launches")
    _print_top(f"{name}: ", kernels, 12)
    # the host-to-device copies against the kernels: how much of the copy
    # time runs while a kernel runs (printed, not held); the upload's copies
    # are the pinned ones, the pageable ones are small tensors made on the host
    compute = _merged([(e.time_range.start, e.time_range.end) for e in kernels
                       if not e.name.startswith(("Memcpy", "Memset"))])
    for kind in ("Pinned", "Pageable"):
        copies = [e for e in kernels if e.name.startswith(f"Memcpy HtoD ({kind}")]
        copy_us = sum(e.time_range.end - e.time_range.start for e in copies)
        over_us = sum(_overlap_us((e.time_range.start, e.time_range.end), compute) for e in copies)
        print(f"profile ({name}): {len(copies)} host-to-device copies from {kind.lower()} memory, "
              f"{copy_us / 1e3:.3f} ms, of which {over_us / 1e3:.3f} ms "
              f"({over_us / copy_us if copy_us else float('nan'):.3f}) overlap kernel time")
    for span, (a, b) in sorted(ranges.items(), key=lambda kv: kv[1]):
        inside = [e for e in kernels if a <= e.time_range.start and e.time_range.end <= b]
        SPAN_LAUNCHES[(name, span)] = len(inside)
        busy = _union_us([(e.time_range.start, e.time_range.end) for e in inside]) / 1e3
        print(f"profile ({name}): span {span} on the card: {(b - a) / 1e3:.1f} ms from its first kernel "
              f"to its last, {busy:.1f} ms busy, {len(inside)} kernel launches")
        _print_top(f"{name} {span}: ", inside, 6)
    for label, key in (("K1 windowed_ola_kernel", "windowed_ola_kernel"),
                       ("K2 spectral_stats_kernel", "spectral_stats_kernel")):
        per = [(e.time_range.end - e.time_range.start) / 1e3 for e in kernels if key in e.name]
        print(f"profile ({name}): {label}, device time per launch (ms): "
              f"{', '.join(f'{ms:.4f}' for ms in per)}")
    return kernels, busy_ms


def print_steps(tag: str, steps, window: int, peak: int) -> None:
    """The first step, the warm steps' (3 on) median and spread, the share of
    the loop spent waiting for a batch, the trained audio-s per wall-s and
    the peak memory of a run of ``TRAIN_BATCH`` x ``window`` samples a step."""
    import statistics

    audio_per_step = TRAIN_BATCH * window / SR
    warm = steps[2:]
    step_ms = [s["step_s"] * 1e3 for s in warm]
    busy = sum(s["step_s"] + s["wait_s"] for s in warm)
    waited = sum(s["wait_s"] for s in warm)
    q = statistics.quantiles(step_ms, n=4)
    print(f"{tag}: first step {steps[0]['step_s'] * 1e3:.1f} ms (waited {steps[0]['wait_s'] * 1e3:.1f} ms "
          f"for its batch); warm steps 3-{len(steps)}: median {statistics.median(step_ms):.2f} ms "
          f"per step (min {min(step_ms):.2f}, quartiles {q[0]:.2f} / {q[2]:.2f}, max "
          f"{max(step_ms):.2f}); waiting for a batch {waited / busy:.3f} of the loop "
          f"(median wait {statistics.median(s['wait_s'] for s in warm) * 1e3:.2f} ms)")
    print(f"{tag}: {audio_per_step:.4f} audio-s per step (batch {TRAIN_BATCH} x {window} samples); "
          f"warm steps: {audio_per_step * len(warm) / busy:.2f} trained audio-s per wall-s; "
          f"torch.cuda.max_memory_allocated = {peak} bytes")


def run_training(torch, dev, work: Path):
    """The training slice through its entry point, with every launch count
    set to 0 just before it. Returns (launches, the run's report, checkpoint)."""
    import math

    from audio_cut_tpu_torch.models.convtdf import load_checkpoint, packaged_checkpoint_path
    from audio_cut_tpu_torch.training import train_separator

    ckpt = work / "trained.msgpack"
    argv = ["--large", "--resume", "packaged", "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
            "--datagen-threads", "2", "--eval-pairs", str(TRAIN_EVAL_PAIRS),
            "--checkpoint", str(ckpt)]
    torch.cuda.reset_peak_memory_stats(dev)
    kernels = reset_counts()  # the training slice starts: only its launches count
    report = {}
    print(f"training: train_separator.main({argv})", flush=True)
    t0 = time.perf_counter()
    rc = train_separator.main(argv, report=report)
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    if rc != 0:
        fail(f"train_separator.main returned {rc}")
    steps = report["steps"]
    want = {"K0": 1, "K1": TRAIN_STEPS + 2 * TRAIN_EVAL_PAIRS, "K1B": TRAIN_STEPS, "K1W": 0, "K2": 0}
    print(f"training: {len(steps)} steps in {wall:.3f} s wall (main, with the resume, the held-out "
          f"eval and the checkpoint); launches {launches}, expected {want}")
    if launches != want:
        fail(f"the training run launched {launches}, expected {want}")
    if len(steps) != TRAIN_STEPS:
        fail(f"{len(steps)} steps ran, expected {TRAIN_STEPS}")
    bad = [s for s in steps
           if not all(math.isfinite(s[k]) for k in ("loss", "spec_l1", "wave_l1", "pause_rms"))]
    if bad:
        fail(f"non-finite losses at steps {[s['step'] for s in bad]}")
    print("training: losses " + ", ".join(f"{s['loss']:.4f}" for s in steps))
    trainer = report["trainer"]
    start = load_checkpoint(packaged_checkpoint_path())
    trained = trainer.sep.net.state_dict()
    moved = {k: float((trained[k].float().cpu() - start[k]).abs().max()) for k in start}
    still = sorted(k for k, v in moved.items() if v == 0.0)
    print(f"training: {len(moved) - len(still)} of {len(moved)} parameter leaves moved, max |step| "
          f"{max(moved.values()):.3e}")
    if still:
        fail(f"parameters that did not move: {still}")
    print_steps("training", steps, trainer.sep.window_samples, peak)
    if report["eval"] is None:
        fail("the held-out SI-SNR did not run")
    print(f"training: held-out SI-SNR on {TRAIN_EVAL_PAIRS} pairs: convtdf {report['eval'][0]:.2f} dB, "
          f"spectral {report['eval'][1]:.2f} dB")
    if not (ckpt.exists() and Path(str(ckpt) + ".json").exists()):
        fail("the checkpoint or its geometry sidecar was not written")
    return launches, report, ckpt


def serve_checkpoint(torch, dev, trainer, ckpt: Path, audio) -> None:
    """The written checkpoint through the serving ConvTDFBackend separates a
    window exactly as the trained net in memory does."""
    from audio_cut_tpu_torch.config import reset_runtime_config, set_runtime_config
    from audio_cut_tpu_torch.models.convtdf import ConvTDFBackend, ConvTDFSeparator

    set_runtime_config({"enhanced_separation.convtdf.checkpoint": str(ckpt)})
    try:
        backend = ConvTDFBackend(SR, dev)
    finally:
        reset_runtime_config()
    sep, net = backend.sep, trainer.sep.net
    w = sep.window_samples
    start = int(20.0 * SR)
    x = torch.from_numpy(audio[start:start + w].copy())[None].to(dev)
    got, _ = backend.separate_windows(x)
    mem = ConvTDFSeparator(SR, n_fft=sep.n_fft, hop=sep.hop, dim_f=sep.dim_f, dim_t=sep.dim_t,
                           channels=net.first.conv1.out_channels, depth=net.depth,
                           tdf_bottleneck=net.first.tdf.fc1.out_features)
    mem.net = net
    want, _ = mem.separate(x, w)
    err = float((got - want).abs().max())
    print(f"checkpoint: the serving ConvTDFBackend from {ckpt.name} (geometry from its sidecar, "
          f"dim_t {sep.dim_t}) on one {w}-sample window: max |served - trained net| = {err:.3e} "
          f"(exact required)")
    if got.shape != want.shape or err != 0.0:
        fail(f"the written checkpoint does not serve what the trained net computes: {err}")


def profile_step(torch, trainer, tag: str = "profile step") -> None:
    """One more train step under torch.profiler: where its time goes, by the
    trainer's spans (host time, and the card's busy time and launches in
    the range each span's kernels cover), printed under ``tag``."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from audio_cut_tpu_torch.training.sep_data import synth_batches

    mix, vocal = next(synth_batches(trainer.sep.window_samples, TRAIN_BATCH,
                                    np.random.default_rng(99)))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(mix, vocal)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    spans = {}
    for e in events:
        if e.name in STEP_SPANS and e.device_type == torch.autograd.DeviceType.CPU:
            spans[e.name] = spans.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    print(f"{tag} (one warm train step under torch.profiler): wall {wall_ms:.1f} ms; host "
          f"spans (ms): " + ", ".join(f"{k} {spans.get(k, float('nan')):.1f}" for k in STEP_SPANS))
    on_card = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ranges = {e.name: (e.time_range.start, e.time_range.end) for e in on_card
              if e.name in STEP_SPANS}
    kernels = [e for e in on_card if e.name not in STEP_SPANS]
    if not kernels:
        print(f"{tag}: device busy time not measured (the profiler recorded nothing on the card)")
        return
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    print(f"{tag}: card busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall (idle share "
          f"{1 - busy_ms / wall_ms:.3f}), {len(kernels)} kernels and copies on the card")
    _print_top(f"{tag}: ", kernels, 14)
    for span, (a, b) in sorted(ranges.items(), key=lambda kv: kv[1]):
        inside = [e for e in kernels if a <= e.time_range.start and e.time_range.end <= b]
        busy = _union_us([(e.time_range.start, e.time_range.end) for e in inside]) / 1e3
        print(f"{tag}: span {span} on the card: {(b - a) / 1e3:.1f} ms from its first "
              f"kernel to its last, {busy:.1f} ms busy, {len(inside)} kernels and copies")
    for label, key in (("host-to-device copies", "Memcpy HtoD"), ("K1 forward", "windowed_ola_kernel"),
                       ("K1B", "ola_backward_frames_kernel")):
        per = [(e.time_range.end - e.time_range.start) / 1e3 for e in kernels if key in e.name]
        print(f"{tag}: {label}: {len(per)} events, {sum(per):.4f} ms in all "
              f"({', '.join(f'{ms:.4f}' for ms in per[:8])})")


def step_parity(torch, dev, build, make_loss, mix, vocal) -> dict:
    """One float32 loss and gradient, card against CPU: ``build()`` makes the
    separator (the same weights each time), ``make_loss(sep, TrainConfig())``
    its loss, on the batch (``mix``, ``vocal``). Returns the losses, the
    global gradient norms, their relative differences, the lowest and the
    median per-leaf cosine, and each side's seconds."""
    from audio_cut_tpu_torch.training.trainer import TrainConfig

    out = {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        sep = build()
        sep.to(d)
        names, params = zip(*sep.net.named_parameters())
        t0 = time.perf_counter()
        loss, _ = make_loss(sep, TrainConfig())(torch.from_numpy(mix).to(d),
                                                torch.from_numpy(vocal).to(d))
        grads = torch.autograd.grad(loss, params)
        grads = [g.double().cpu() for g in grads]
        out[side] = (float(loss.detach()), grads, time.perf_counter() - t0)
    (l_card, g_card, s_card), (l_cpu, g_cpu, s_cpu) = out["card"], out["cpu"]
    norm = {side: float(torch.sqrt(sum((g * g).sum() for g in out[side][1]))) for side in out}
    cos = []
    for name, a, b in zip(names, g_card, g_cpu):
        na, nb = float(a.norm()), float(b.norm())
        cos.append((1.0 if na == nb == 0.0 else float((a * b).sum()) / max(na * nb, 1e-300), name))
    return {"loss": (l_card, l_cpu), "norm": (norm["card"], norm["cpu"]),
            "rel_loss": abs(l_card - l_cpu) / abs(l_cpu),
            "rel_norm": abs(norm["card"] - norm["cpu"]) / norm["cpu"],
            "worst": min(cos), "median_cos": sorted(c for c, _ in cos)[len(cos) // 2],
            "seconds": (s_card, s_cpu)}


def _parity_line(r: dict) -> str:
    return (f"loss {r['loss'][0]:.6f} vs {r['loss'][1]:.6f} (rel {r['rel_loss']:.3e}), global "
            f"gradient norm {r['norm'][0]:.6f} vs {r['norm'][1]:.6f} (rel {r['rel_norm']:.3e}); "
            f"bounds rtol {STEP_RTOL}; lowest per-leaf cosine {r['worst'][0]:.6f} "
            f"({r['worst'][1]}; bound {STEP_MIN_COS}); median cosine {r['median_cos']:.6f}; "
            f"card {r['seconds'][0]:.2f} s, CPU {r['seconds'][1]:.2f} s")


def _parity_holds(r: dict) -> bool:
    return r["rel_loss"] <= STEP_RTOL and r["rel_norm"] <= STEP_RTOL and r["worst"][0] >= STEP_MIN_COS


def card_vs_cpu_step(torch, dev) -> None:
    """One float32 train step of ConvTDF-large (dim_t 32, batch 1), card
    against CPU, from the packaged weights and one synthetic pair."""
    import numpy as np

    from audio_cut_tpu_torch.models.convtdf import (
        ConvTDFSeparator, load_checkpoint, packaged_checkpoint_path)
    from audio_cut_tpu_torch.ops.ola import K1B
    from audio_cut_tpu_torch.training.sep_data import synth_pair
    from audio_cut_tpu_torch.training.train_separator import LARGE_GEOMETRY
    from audio_cut_tpu_torch.training.trainer import make_loss_fn

    state = load_checkpoint(packaged_checkpoint_path())
    geometry = {**LARGE_GEOMETRY, "dim_t": 32}

    def build():
        sep = ConvTDFSeparator(SR, **geometry, dtype=torch.float32)
        sep.net.load_state_dict(state)
        return sep

    window = build().window_samples
    mix, vocal = synth_pair(np.random.default_rng(21), window)
    b0 = K1B.launches
    r = step_parity(torch, dev, build, make_loss_fn, mix[None], vocal[None])
    print(f"card vs CPU, one float32 train step of ConvTDF-large (dim_t 32, batch 1, "
          f"{window} samples; K1B launches on the card {K1B.launches - b0}): {_parity_line(r)}")
    if K1B.launches - b0 != 1:
        fail("the card's train step did not launch K1B once")
    if not _parity_holds(r):
        fail("the card's float32 train step disagrees with the CPU's")


def train_waveunet(torch, dev, work: Path):
    """The WaveUNet's trainer through its entry point, with every launch
    count set to 0 just before it: ``--family waveunet --bootstrap``,
    ``WAVEUNET_STEPS`` steps at batch 4, the held-out SI-SNR on 2 pairs and a
    checkpoint. Every loss finite; the launches K0 1 and K1 one per held-out
    pair (the spectral yardstick's iSTFT: the WaveUNet's loss and forward run
    no kernel of the port); the msgpack and its sidecar ({"channels": 24,
    "depth": 4}) written, and the checkpoint read back equal to the trained
    parameters. Returns the checkpoint's path and the trainer."""
    import math

    from audio_cut_tpu_torch.models.waveunet import load_checkpoint
    from audio_cut_tpu_torch.training import train_separator

    ckpt = work / "waveunet" / "waveunet.msgpack"
    ckpt.parent.mkdir()
    argv = ["--family", "waveunet", "--bootstrap", "--steps", str(WAVEUNET_STEPS),
            "--batch", str(TRAIN_BATCH), "--eval-pairs", str(TRAIN_EVAL_PAIRS),
            "--checkpoint", str(ckpt)]
    torch.cuda.reset_peak_memory_stats(dev)
    kernels = reset_counts()  # the WaveUNet's training starts: only its launches count
    report = {}
    print(f"waveunet training: train_separator.main({argv})", flush=True)
    t0 = time.perf_counter()
    rc = train_separator.main(argv, report=report)
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    if rc != 0:
        fail(f"train_separator.main --family waveunet returned {rc}")
    steps = report["steps"]
    want = {"K0": 1, "K1": TRAIN_EVAL_PAIRS, "K1B": 0, "K1W": 0, "K2": 0}
    print(f"waveunet training: {len(steps)} steps in {wall:.3f} s wall (main, with the held-out "
          f"eval and the checkpoint); launches {launches}, expected {want}")
    if launches != want or len(steps) != WAVEUNET_STEPS:
        fail(f"the WaveUNet training ran {len(steps)} steps and launched {launches}; expected "
             f"{WAVEUNET_STEPS} and {want}")
    if not all(math.isfinite(st[k]) for st in steps for k in ("loss", "spec_l1", "wave_l1",
                                                               "pause_rms")):
        fail("the WaveUNet training gave a non-finite loss")
    print("waveunet training: losses " + ", ".join(f"{st['loss']:.4f}" for st in steps))
    trainer = report["trainer"]
    sep = trainer.sep
    print(f"waveunet training: window {sep.window_samples}, channels {sep.net.channels}, depth "
          f"{sep.net.depth}, {sum(p.numel() for p in sep.net.parameters())} parameters, "
          f"activations {sep.net.dtype}, on {next(sep.net.parameters()).device}")
    print_steps("waveunet training", steps, sep.window_samples, peak)
    print(f"waveunet training: held-out SI-SNR on {TRAIN_EVAL_PAIRS} pairs: waveunet "
          f"{report['eval'][0]:.2f} dB, spectral {report['eval'][1]:.2f} dB")
    sidecar = Path(str(ckpt) + ".json")
    if not (ckpt.exists() and sidecar.exists()):
        fail("the WaveUNet checkpoint or its geometry sidecar was not written")
    meta = json.loads(sidecar.read_text())
    if meta != {"channels": 24, "depth": 4}:
        fail(f"the WaveUNet sidecar holds {meta}")
    state, trained = load_checkpoint(str(ckpt)), sep.net.state_dict()
    if state.keys() != trained.keys() or not all(torch.equal(state[k], trained[k].cpu())
                                                 for k in state):
        fail("the WaveUNet checkpoint does not read back as the trained parameters")
    print(f"waveunet training: {ckpt.name} ({ckpt.stat().st_size} bytes) and its sidecar {meta} "
          "written; read back equal to the trained parameters")
    return ckpt, trainer


def waveunet_step_parity(torch, dev) -> None:
    """One float32 train step of the WaveUNet at the ``--small`` geometry
    (window 16384, channels 8, depth 3, batch 2), card against CPU, from one
    seeded initialisation and one synthetic batch: the loss and the global
    gradient norm within ``STEP_RTOL``, every leaf's gradients at cosine >=
    ``STEP_MIN_COS``."""
    import numpy as np

    from audio_cut_tpu_torch.models.waveunet import WaveUNetSeparator
    from audio_cut_tpu_torch.training.sep_data import synth_batches
    from audio_cut_tpu_torch.training.train_separator import WAVEUNET_SMALL_GEOMETRY
    from audio_cut_tpu_torch.training.wave_trainer import make_wave_loss_fn

    def build():
        sep = WaveUNetSeparator(SR, **WAVEUNET_SMALL_GEOMETRY, dtype=torch.float32)
        sep.init_params(torch.Generator().manual_seed(0))
        return sep

    mix, vocal = next(synth_batches(WAVEUNET_SMALL_GEOMETRY["window_samples"], 2,
                                    np.random.default_rng(23)))
    r = step_parity(torch, dev, build, make_wave_loss_fn, mix, vocal)
    print(f"card vs CPU, one float32 train step of the WaveUNet at --small "
          f"({WAVEUNET_SMALL_GEOMETRY}, batch 2): {_parity_line(r)}")
    if not _parity_holds(r):
        fail("the card's float32 WaveUNet train step disagrees with the CPU's")


def serve_waveunet(torch, dev, work: Path, audio, ckpt: Path) -> int:
    """The WaveUNet tier served from the trained checkpoint
    (``enhanced_separation.backend: waveunet``): ``separate_and_segment()``
    with no mode and no device, cold then warm, then
    ``mode="vocal_separation"`` once, every count set to 0 just before. Each
    call reports backend ``waveunet`` on cuda and runs the 11 engine windows
    at 262144 samples (window, channels and depth of the backend) in the 6
    pieces that ``expected_pass`` computes, launching K1 0 times and K2 once
    in v2.2_mdd (0 in vocal_separation), K0 once in the phase; the v2.2_mdd
    calls' device stems sum to their mix within ``WAVEUNET_SUM_ATOL`` and
    their segments splice back exactly; the vocal_separation stems are
    checked by ``check_stems``. Then the warm v2.2_mdd call's cuts against
    a ``device="cpu"`` call on the same checkpoint: the same count, each
    within one dB-grid stride. Then one map group of 4 windows through the
    backend on the card (bf16) and on the CPU (float32) at SNR >=
    ``WAVEUNET_GROUP_SNR_DB``, and one more warm call profiled. Returns K2's
    launches in the phase."""
    import numpy as np

    from audio_cut_tpu_torch import separate_and_segment
    from audio_cut_tpu_torch.analysis.bundle import DB_STRIDE
    from audio_cut_tpu_torch.models.waveunet import NATIVE_WINDOW, WaveUNetSeparator
    from audio_cut_tpu_torch.separation import fused

    overrides = {"enhanced_separation.backend": "waveunet",
                 "enhanced_separation.waveunet.checkpoint": str(ckpt)}
    want = expected_pass(audio.size, "waveunet", overrides)
    backend = _backend_under(overrides, "waveunet")
    net = backend.sep.net
    geometry = (backend.sep.window_samples, net.channels, net.depth)
    print(f"waveunet serving: backend window {geometry[0]}, channels {geometry[1]}, depth "
          f"{geometry[2]} on {next(net.parameters()).device} ({net.dtype}); expected "
          f"{want['windows']} windows of {want['window']} in pieces {want['sizes']}, "
          f"{want['forwards']} forwards of <= {backend.map_group}, K1 {want['k1']}")
    if geometry != (NATIVE_WINDOW, 24, 4) or (want["windows"], len(want["sizes"])) != (11, 6):
        fail(f"waveunet serving: geometry {geometry}, {want['windows']} windows in "
             f"{len(want['sizes'])} pieces; expected ({NATIVE_WINDOW}, 24, 4), 11 in 6")
    kernels = reset_counts()  # the WaveUNet's serving starts: only its launches count
    calls = (("v2.2_mdd", "cold"), ("v2.2_mdd", "warm"), ("vocal_separation", "warm"))
    with _Capture(fused) as cap:
        for call, (mode, label) in enumerate(calls):
            out = work / f"waveunet{call}"
            k1, k2 = kernels["K1"].launches, kernels["K2"].launches
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            m = separate_and_segment(input_uri=str(work / "song.wav"), export_dir=str(out),
                                     mode=None if mode == "v2.2_mdd" else mode,
                                     runtime_overrides=overrides)
            wall = time.perf_counter() - t0
            k1, k2 = kernels["K1"].launches - k1, kernels["K2"].launches - k2
            WALLS[f"waveunet {mode} {label}"] = wall
            print(f"waveunet {mode} call {call} ({label}): {wall:.3f} s wall, {SONG_S / wall:.2f} "
                  f"audio-s per wall-s (convtdf v2.2_mdd warm: "
                  f"{SONG_S / WALLS['v2.2_mdd warm']:.2f}), pass "
                  f"{m['gpu']['gpu_pipeline_compute_ms']:.1f} ms, {m['gpu']['gpu_pipeline_mode']}, "
                  f"K1 launches {k1}, K2 launches {k2}, peak memory "
                  f"{torch.cuda.max_memory_allocated(dev)} bytes")
            if not m["success"]:
                fail(f"waveunet {mode} call {call} failed: {m}")
            if (m["separation"]["backend"] != "waveunet"
                    or m["gpu"]["gpu_pipeline_backend"] != "waveunet"
                    or m["gpu"]["gpu_pipeline_chunks"] != want["windows"]):
                fail(f"waveunet {mode} call {call}: separation {m['separation']}, gpu {m['gpu']}")
            if mode == "vocal_separation":
                if (m["gpu"]["gpu_pipeline_device"] != "cuda"
                        or m["gpu"]["gpu_pipeline_mode"] != want["engine"] or (k1, k2) != (0, 0)):
                    fail(f"waveunet vocal_separation: K1 {k1}, K2 {k2}, gpu {m['gpu']}; expected "
                         f"K1 0 and K2 0 on cuda, {want['engine']}")
                check_stems("waveunet vocal_separation", m, out, audio)
                continue
            check_pass(f"waveunet v2.2_mdd call {call}", m, k1, k2, backend="waveunet",
                       overrides=overrides)
            # 20 steps of training leave the stem without clean pauses, so
            # one segment is a valid result: the splice is what is held
            check_segments(m, out, audio, min_segments=1)
            sep = cap.last[0]
            n = audio.size
            err = float((sep.vocal_device.double() + sep.instrumental_device.double()
                         - sep.mix_device[:n].double()).abs().max())
            labels = [s["label"] for s in m["segments"]]
            card_cuts = m["cuts"]["samples"]
            print(f"waveunet v2.2_mdd call {call}: {len(labels)} segments {labels}, cuts "
                  f"(samples) {m['cuts']['samples']}, spliced back exactly; device |vocal + "
                  f"instrumental - mix| = {err:.3e} (<= {WAVEUNET_SUM_ATOL})")
            if not err <= WAVEUNET_SUM_ATOL:
                fail(f"waveunet v2.2_mdd call {call}: the stems do not sum to the mix ({err})")
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"waveunet serving: launches in the {len(calls)} calls {launches}")
    if launches != {"K0": 1, "K1": 0, "K1B": 0, "K1W": 0, "K2": 2}:
        fail(f"waveunet serving launched {launches}; expected K0 1, K1 0 and K2 2")
    del cap, sep

    # the warm call's cuts against the same checkpoint served on the CPU
    m = separate_and_segment(input_uri=str(work / "song.wav"), export_dir=str(work / "waveunet_cpu"),
                             device="cpu", runtime_overrides=overrides)
    cpu_cuts = m["cuts"]["samples"]
    print(f"waveunet cuts (samples), warm v2.2_mdd call on the card {card_cuts}, on the CPU "
          f"{cpu_cuts} (each within one dB-grid stride, {DB_STRIDE} samples)")
    if not m["success"] or len(cpu_cuts) != len(card_cuts) or any(
            abs(a - b) > DB_STRIDE for a, b in zip(card_cuts, cpu_cuts)):
        fail("waveunet: the card's cuts and the CPU's differ beyond one dB-grid stride")

    # one map group of windows, card (bf16, the served backend) against CPU (f32)
    w = backend.sep.window_samples
    starts = [int(10.0 * SR) + j * (w // 2) for j in range(backend.map_group)]
    x = torch.from_numpy(np.stack([audio[s:s + w] for s in starts]))
    v_gpu, _ = backend.separate_windows(x.to(dev))
    cpu = WaveUNetSeparator(SR, w, net.channels, net.depth, dtype=torch.float32)
    cpu.net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    t0 = time.perf_counter()
    v_cpu, _ = cpu.separate(x, w)
    cpu_s = time.perf_counter() - t0
    snr = snr_db(v_cpu.numpy(), v_gpu.float().cpu().numpy())
    print(f"waveunet group parity ({backend.map_group} windows of {w} samples in one forward): "
          f"vocal SNR card bf16 vs CPU f32 = {snr:.2f} dB (required >= {WAVEUNET_GROUP_SNR_DB}); "
          f"CPU forward {cpu_s:.2f} s")
    if not snr >= WAVEUNET_GROUP_SNR_DB:
        fail(f"waveunet group parity {snr:.2f} dB < {WAVEUNET_GROUP_SNR_DB} dB")
    profile_call(torch, work, overrides=overrides, name="waveunet")
    return launches["K2"]


def build_onnx_model(torch, work: Path):
    """The ONNX phase's model: ``ConvTDFNetTrim`` at ``KIM_VOCAL_1`` (dim_f
    3072, dim_t 256, L 11, k 3, g 48, l 3, bn 8), its weights from
    ``ONNX_SEED``, written as an ONNX graph under ``work`` with "vocal" in
    its name (so ``output: auto`` reads vocals) and read back with the port's
    reader. Requires ``validate_graph == []``, the input [None, 4, 3072, 256],
    ``ONNX_PARAMS`` parameters in the net and, in the graph, exactly those
    plus the BatchNorms' running statistics and the GroupNorm lowering's unit
    affines (2 + 2 floats each). Returns (the file, the net on the CPU)."""
    from collections import Counter

    from audio_cut_tpu_torch.onnx import load_model, save_model, validate_graph
    from audio_cut_tpu_torch.testing import KIM_VOCAL_1, build_graph, make_net

    t0 = time.perf_counter()
    net = make_net(**KIM_VOCAL_1, generator=torch.Generator().manual_seed(ONNX_SEED))
    graph = build_graph(net, KIM_VOCAL_1["g"], KIM_VOCAL_1["l"], KIM_VOCAL_1["k"],
                        KIM_VOCAL_1["bn"])
    path = work / "onnx" / "kim_vocal_1_geometry_seeded.onnx"
    path.parent.mkdir()
    save_model(graph, str(path))
    built_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = load_model(str(path))
    read_s = time.perf_counter() - t0
    params = sum(p.numel() for p in net.parameters())
    stats = sum(m.running_mean.numel() + m.running_var.numel() for m in net.modules()
                if isinstance(m, torch.nn.BatchNorm2d))
    norms = sum(isinstance(m, torch.nn.GroupNorm) for m in net.modules())
    floats = sum(int(a.size) for a in g.initializers.values() if a.dtype.kind == "f")
    print(f"onnx build: {KIM_VOCAL_1}, seed {ONNX_SEED}: {len(g.nodes)} nodes "
          f"{dict(sorted(Counter(n.op_type for n in g.nodes).items()))}; {params} parameters, "
          f"{floats} floats in the graph (+ {stats} running statistics, + {4 * norms} unit "
          f"affines of {norms} GroupNorms); {path.name} {path.stat().st_size} bytes; built and "
          f"written in {built_s:.2f} s, read back in {read_s:.2f} s")
    unsupported = validate_graph(g)
    shape = g.input_shapes.get(g.inputs[0]) if g.inputs else None
    if (unsupported or shape != [None, 4, KIM_VOCAL_1["dim_f"], KIM_VOCAL_1["dim_t"]]
            or params != ONNX_PARAMS or floats != params + stats + 4 * norms):
        fail(f"onnx build: unsupported {unsupported}, input {shape}, {params} parameters "
             f"(expected {ONNX_PARAMS}), {floats} floats in the graph")
    return path, net


def onnx_executor_check(torch, dev, path: Path, net) -> None:
    """The port's executor on the graph against the ``ConvTDFNetTrim`` it was
    written from, on the card, on one seeded [1, 4, 3072, 256] input: max
    |diff| <= ``ONNX_NET_RTOL_F32`` x max |net| with cuDNN's TF32 off for
    the check, and <= ``ONNX_NET_RTOL_SERVED`` x max |net| at the process's
    flags (the serving path's); then one more forward under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises if the forward
    reads a value back from the card, and its output within
    ``ONNX_NET_RTOL_F32`` x max |output| of the one before."""
    import numpy as np

    from audio_cut_tpu_torch.onnx import OnnxGraphModule, load_model

    module = OnnxGraphModule(load_model(str(path))).to(dev).eval()
    net = net.to(dev)
    x = np.random.default_rng(17).standard_normal((1, 4, 3072, 256)).astype(np.float32)
    x = torch.from_numpy(0.5 * x).to(dev)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    for label, rtol, tf32 in (("float32", ONNX_NET_RTOL_F32, False),
                              ("served flags", ONNX_NET_RTOL_SERVED, flags[0])):
        with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
            (y,) = module(x)
            ref = net(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (y,) = module(x)
            torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t0) * 1e3
        err, scale = float((y - ref).abs().max()), float(ref.abs().max())
        print(f"onnx executor vs its torch net on the card ({label}: cudnn.allow_tf32 {tf32}, "
              f"cuda.matmul.allow_tf32 {flags[1]}): max |diff| {err:.3e}, max |net| {scale:.4f}, "
              f"ratio {err / scale:.3e} (bound {rtol}); one warm forward {fwd_ms:.1f} ms")
        if not (torch.isfinite(y).all() and err <= rtol * scale):
            fail(f"onnx executor vs its net ({label}): {err} > {rtol} x {scale}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            (again,) = module(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # cuDNN may sum a transposed conv with atomics: the same values up to their order
    diff = float((again - y).abs().max())
    print(f"onnx executor: one more forward under torch.cuda.set_sync_debug_mode('error') raised "
          f"nothing (no value read back from the card); max |diff| to the forward before {diff:.3e}")
    if not diff <= ONNX_NET_RTOL_F32 * float(y.abs().max()):
        fail(f"onnx executor: the forward under set_sync_debug_mode('error') differs by {diff}")
    del module, net, x, y, ref, again


def run_onnx(torch, dev, work: Path, audio) -> dict:
    """The ONNX tier (``separation/onnx_backend.py``) on the card, every
    count set to 0 just before it: builds the Kim_Vocal_1-geometry graph
    (``build_onnx_model``), holds the executor against its torch net
    (``onnx_executor_check``), then serves it (``enhanced_separation.backend:
    onnx``, the file as ``enhanced_separation.onnx.model_path``; the config
    keeps dim_f 2048 and the file's 3072 must win) through
    ``separate_and_segment()`` with no mode and no device, cold then warm,
    and ``mode="vocal_separation"`` once. Each call reports backend onnx on
    cuda, runs the 11 engine windows of 261120 samples in the 6 pieces
    ``expected_pass(..., "onnx", ...)`` computes and launches K1 at the rows
    it computes (2 a window: 5 at [4, 256, 6144], 1 at [2, 256, 6144]),
    K2 once in v2.2_mdd and 0 in vocal_separation, K0 once in the phase;
    the v2.2_mdd calls' device stems sum to their mix within
    ``ONNX_SUM_RTOL`` and their segments splice back exactly (one segment
    allowed: the weights are seeded, not trained); the vocal_separation
    stems pass ``check_stems``. Then one model window through
    ``separate_windows`` on the card and on the CPU (plain K1) at SNR >=
    ``ONNX_SNR_DB``, with the TF32 flags printed beside it, and one more
    warm v2.2_mdd call profiled. Returns K1's and K2's launches in the phase
    and K1's shapes."""
    import numpy as np

    from audio_cut_tpu_torch import separate_and_segment
    from audio_cut_tpu_torch.separation import fused

    kernels = reset_counts()  # the ONNX phase starts: only its launches count
    path, net = build_onnx_model(torch, work)
    onnx_executor_check(torch, dev, path, net)
    del net
    overrides = {"enhanced_separation.backend": "onnx",
                 "enhanced_separation.onnx.model_path": str(path)}
    want = expected_pass(audio.size, "onnx", overrides)
    backend = _backend_under(overrides, "onnx")
    geometry = (backend.dim_f, backend.dim_t, backend.window_samples, backend.output)
    print(f"onnx serving: backend dim_f {geometry[0]}, dim_t {geometry[1]}, window {geometry[2]}, "
          f"output {geometry[3]}, {backend.net.param_count()} floats on "
          f"{next(backend.net.buffers()).device}, map_group {backend.map_group}, shifts "
          f"{backend.shifts}; expected {want['windows']} windows in pieces {want['sizes']}, "
          f"{want['forwards']} forwards, K1 {want['k1']} at rows {want['rows']}")
    if (geometry != (3072, 256, 261120, "vocals")
            or (want["windows"], len(want["sizes"])) != (11, 6)):
        fail(f"onnx serving: geometry {geometry}, {want['windows']} windows in "
             f"{len(want['sizes'])} pieces; expected (3072, 256, 261120, 'vocals'), 11 in 6")
    want_rows = {}
    for r in want["rows"]:
        key = str([r, backend.dim_t, backend.n_fft])
        want_rows[key] = want_rows.get(key, 0) + 1
    calls = (("v2.2_mdd", "cold"), ("v2.2_mdd", "warm"), ("vocal_separation", "warm"))
    shapes = {}
    with _Capture(fused) as cap, _K1Rows() as rows:
        for call, (mode, label) in enumerate(calls):
            out = work / f"onnx{call}"
            k1, k2, start = kernels["K1"].launches, kernels["K2"].launches, len(rows.shapes)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            m = separate_and_segment(input_uri=str(work / "song.wav"), export_dir=str(out),
                                     mode=None if mode == "v2.2_mdd" else mode,
                                     runtime_overrides=overrides)
            wall = time.perf_counter() - t0
            k1, k2 = kernels["K1"].launches - k1, kernels["K2"].launches - k2
            got_rows = rows.counts(start)
            for key, k in got_rows.items():
                shapes[key] = shapes.get(key, 0) + k
            WALLS[f"onnx {mode} {label}"] = wall
            print(f"onnx {mode} call {call} ({label}): {wall:.3f} s wall, {SONG_S / wall:.2f} "
                  f"audio-s per wall-s (convtdf v2.2_mdd warm: "
                  f"{SONG_S / WALLS['v2.2_mdd warm']:.2f}), pass "
                  f"{m['gpu']['gpu_pipeline_compute_ms']:.1f} ms, {m['gpu']['gpu_pipeline_mode']}, "
                  f"K1 launches {k1} at {got_rows}, K2 launches {k2}, peak memory "
                  f"{torch.cuda.max_memory_allocated(dev)} bytes")
            if not m["success"]:
                fail(f"onnx {mode} call {call} failed: {m}")
            if (m["separation"]["backend"] != "onnx" or m["gpu"]["gpu_pipeline_backend"] != "onnx"
                    or m["gpu"]["gpu_pipeline_chunks"] != want["windows"]
                    or got_rows != want_rows):
                fail(f"onnx {mode} call {call}: separation {m['separation']}, gpu {m['gpu']}, "
                     f"K1 rows {got_rows}; expected K1 at {want_rows}")
            if mode == "vocal_separation":
                if (m["gpu"]["gpu_pipeline_device"] != "cuda"
                        or m["gpu"]["gpu_pipeline_mode"] != want["engine"]
                        or (k1, k2) != (want["k1"], 0)):
                    fail(f"onnx vocal_separation: K1 {k1}, K2 {k2}, gpu {m['gpu']}; expected "
                         f"K1 {want['k1']} and K2 0 on cuda, {want['engine']}")
                check_stems("onnx vocal_separation", m, out, audio)
                continue
            check_pass(f"onnx v2.2_mdd call {call}", m, k1, k2, backend="onnx", overrides=overrides)
            # seeded weights: the stem has no clean pauses, so one segment is
            # a valid result; the splice is what is held
            check_segments(m, out, audio, min_segments=1)
            sep = cap.last[0]
            n = audio.size
            vocal = sep.vocal_device.double()
            err = float((vocal + sep.instrumental_device.double()
                         - sep.mix_device[:n].double()).abs().max())
            bound = ONNX_SUM_RTOL * max(1.0, float(vocal.abs().max()))
            finite = bool(torch.isfinite(vocal).all())
            labels = [s["label"] for s in m["segments"]]
            print(f"onnx v2.2_mdd call {call}: {len(labels)} segments {labels}, cuts (samples) "
                  f"{m['cuts']['samples']}, spliced back exactly; vocal rms "
                  f"{float(vocal.pow(2).mean().sqrt()):.4e}, max {float(vocal.abs().max()):.4e}, "
                  f"finite {finite}; device |vocal + instrumental - mix| = {err:.3e} (<= {bound:.3e})")
            if not (finite and err <= bound):
                fail(f"onnx v2.2_mdd call {call}: the stems are not finite or do not sum to "
                     f"the mix ({err})")
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"onnx phase: launches {launches} (K1 at {shapes})")
    if launches != {"K0": 1, "K1": 3 * want["k1"], "K1B": 0, "K1W": 0, "K2": 2}:
        fail(f"the onnx phase launched {launches}; expected K0 1, K1 {3 * want['k1']}, K2 2")
    del cap, sep, vocal

    # one model window, card (the served backend) against CPU (plain K1)
    w = backend.window_samples
    start = int(10.0 * SR)
    x = torch.from_numpy(audio[start:start + w].copy())[None]
    v_gpu, _ = backend.separate_windows(x.to(dev))
    cpu = _backend_under(overrides, "onnx", device="cpu")
    t0 = time.perf_counter()
    v_cpu, _ = cpu.separate_windows(x)
    cpu_s = time.perf_counter() - t0
    snr = snr_db(v_cpu[0].numpy(), v_gpu[0].cpu().numpy())
    print(f"onnx window parity ({w} samples, one forward): vocal SNR card vs CPU = {snr:.2f} dB "
          f"(required >= {ONNX_SNR_DB}); torch.backends.cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}, torch.backends.cuda.matmul.allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}; CPU forward {cpu_s:.2f} s")
    if not snr >= ONNX_SNR_DB:
        fail(f"onnx window parity {snr:.2f} dB < {ONNX_SNR_DB} dB")
    del cpu, v_cpu, v_gpu

    profile_call(torch, work, overrides=overrides, name="onnx")
    sep_launches = SPAN_LAUNCHES.get(("onnx", "separation"))
    if sep_launches is not None:
        print(f"profile (onnx): {sep_launches} kernel launches in the separation span, "
              f"{sep_launches / want['forwards']:.1f} per forward ({want['forwards']} forwards)")
    return {"K1": {"launches": launches["K1"], "shapes": shapes}, "K2": launches["K2"]}


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
    k0_timing = check_k0(torch, dev)
    k1_err, k1_timings = check_k1(torch, dev)
    k1_timing = k1_timings[0]  # the serving shape, a piece of 2 windows
    k1b_timing, k1w_err, _ = check_k1_backward(torch, dev)
    k2_err, k2_timings = check_k2(torch, dev)
    k2_timing = k2_timings[0]
    check_k1w_profile(torch, dev)  # before the serving phases (its docstring)

    from audio_cut_tpu_torch.io import write_wav

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        audio = make_song(SONG_S)
        write_wav(work / "song.wav", audio, SR, subtype="FLOAT")
        launches, warm, warm_m = run_mdd(torch, dev, work, audio)
        spectral_shape, spectral_hop, k1_spectral = run_spectral(torch, dev, work, audio)
        phrases = []
        chorus = make_song(SONG_S, chorus_s=CHORUS_S, phrases=phrases)
        write_wav(work / "song_chorus.wav", chorus, SR, subtype="FLOAT")
        run_vpbd(torch, dev, work, chorus)
        run_lyrics(torch, dev, work, chorus, phrases)
        stop = make_song(SONG_S, stop_time_s=STOP_TIME_S)
        write_wav(work / "song_stop.wav", stop, SR, subtype="FLOAT")
        run_hybrid(torch, dev, work, {"song_chorus.wav": chorus, "song_stop.wav": stop})
        del chorus, stop
        intro = make_song(SONG_S, intro_s=INTRO_S)
        write_wav(work / "song_intro.wav", intro, SR, subtype="FLOAT")
        run_librosa(torch, dev, work, audio, intro)
        del intro
        run_legacy(torch, dev, work, audio)
        bundle_parity(torch, dev, warm, audio)
        staged_check(torch, dev, work, warm, warm_m, audio)
        run_unpipelined(torch, dev, work, audio, warm)
        base_vocal = warm[0].vocal_device.cpu().numpy()
        del warm
        run_yaml_config(torch, dev, work, audio)
        run_separation(torch, dev, work, audio)
        one_window_parity(torch, dev, audio)
        shifts_k1 = run_shifts(torch, dev, work, audio, base_vocal)
        batch_launches = run_batch(torch, dev, work, audio)
        run_shell(torch, dev, work, audio, warm_m, batch_launches)
        profile_call(torch, work)
        profile_call(torch, work, mode="vpbd_acoustic", song="song_chorus.wav")
        train_launches, report, ckpt = run_training(torch, dev, work)
        serve_checkpoint(torch, dev, report["trainer"], ckpt, audio)
        profile_step(torch, report["trainer"])
        del report
        card_vs_cpu_step(torch, dev)
        waveunet_ckpt, trainer = train_waveunet(torch, dev, work)
        profile_step(torch, trainer, "profile waveunet step")
        del trainer
        waveunet_step_parity(torch, dev)
        waveunet_k2 = serve_waveunet(torch, dev, work, audio, waveunet_ckpt)
        onnx_launches = run_onnx(torch, dev, work, audio)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    k1w_err_edges, k1w_timing = check_k1w(torch, dev)

    # launches: K1's and K2's counts in the two v2.2_mdd calls, the main path
    # (K1 once per piece); the other kernels' in the training run, which is
    # their path
    kernels = [{
        "name": "K0 probe",
        "route": "cuda",
        "source": "audio_cut_tpu_torch/csrc/probe.cu",
        "replaces": "audio_cut_tpu/ops/pallas/probe.py:61",
        "launches": train_launches["K0"],
        "max_abs_err": k0_timing["max_abs_err"],
        "ms": k0_timing["ms"],
        "plain_ms": k0_timing["plain_ms"],
        "bound_ms": k0_timing["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k0_timing["library_ms"],
    }, {
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
        # every timed shape: the serving shape (the numbers above) first,
        # then the other path shapes, the spectral piece last
        "shapes": k1_timings + [{"shape": list(spectral_shape), "hop": spectral_hop,
                                 **k1_spectral}],
        # K1 on the later paths: its launches and their shapes
        "paths": {"shifts_2": shifts_k1,
                  "batch": {"launches": batch_launches["K1"],
                            "shapes": batch_launches["shapes"]},
                  "onnx": onnx_launches["K1"]},
    }, {
        "name": "K1 backward (g_frames) ola_backward_frames",
        "route": "cuda",
        "source": "audio_cut_tpu_torch/csrc/ola.cu",
        "replaces": "audio_cut_tpu/ops/pallas/ola.py:77",
        "launches": train_launches["K1B"],
        "max_abs_err": k1b_timing["max_abs_err"],
        "ms": k1b_timing["ms"],
        "plain_ms": k1b_timing["plain_ms"],
        "bound_ms": k1b_timing["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k1b_timing["library_ms"],
    }, {
        "name": "K1 backward (g_window) ola_backward_window",
        "route": "cuda",
        "source": "audio_cut_tpu_torch/csrc/ola.cu",
        "replaces": "audio_cut_tpu/ops/pallas/ola.py:77",
        "launches": train_launches["K1W"],
        "max_abs_err": max(k1w_err, k1w_err_edges),
        "ms": k1w_timing["ms"],
        "plain_ms": k1w_timing["plain_ms"],
        "bound_ms": k1w_timing["bound_ms"],
        "bound_by": k1w_timing["bound_by"],
        "library_ms": k1w_timing["library_ms"],
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
        # the bundle's grid (the numbers above) and librosa_onset's
        "shapes": k2_timings,
        "paths": {"batch": {"launches": batch_launches["K2"]},
                  "waveunet": {"launches": waveunet_k2},
                  "onnx": {"launches": onnx_launches["K2"]}},
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
