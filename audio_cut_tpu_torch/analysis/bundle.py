"""DetectionBundle: every envelope the v2.2_mdd host tail needs, in one pass.

Counterpart of ``audio_cut_tpu/analysis/bundle.py``. Over the (mix, vocal)
pair that the separation leaves on the device, ``_bundle_fn`` computes the
feature grid (with kernel K2), the 10 ms valley envelope, the decimated
guard/refine dB grids, the classification activity envelope and, with a
ConvVAD, its frame probabilities and the vocal energy. ``flatten_bundle``
(``features.flatten_outputs``) concatenates the outputs in sorted key order
into one float32 tensor, so the host copies it once; ``unpack_bundle`` cuts
the host copy back into a ``DetectionBundle``, its feature store through the
same ``features.track_features_from_host`` as ``build_track_features``. ``build_detection_bundle`` does the three over the
stems of one separation; the fused pass and the staged path both call it.

dB grids are decimated by ``DB_STRIDE`` samples (1.45 ms at 44.1 kHz); every
consumer works on windows of 5 ms or more.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from audio_cut_tpu_torch.analysis.features import (
    DEFAULT_HOP_S,
    TrackFeatures,
    _compute_features,
    track_features_from_host,
    unflatten_outputs,
)
from audio_cut_tpu_torch.analysis.features import flatten_outputs as flatten_bundle
from audio_cut_tpu_torch.ops.frames import frame_rms

DB_STRIDE = 64


def _rms_db_grid(x: torch.Tensor, window: int) -> torch.Tensor:
    """Decimated centred RMS-dB grid (stride DB_STRIDE)."""
    sums_grid, counts = _binned_window_sums(torch.square(x), window)
    rms = torch.sqrt(torch.clamp(sums_grid, min=0.0) / counts + 1e-24)
    return 20.0 * torch.log10(rms + 1e-12)


def _binned_window_sums(sq: torch.Tensor, window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed sums over DB_STRIDE bins: each output is the direct sum of
    its ``wb`` bins (no prefix-sum cancellation, no ones-kernel conv)."""
    t = sq.shape[-1]
    nb = -(-t // DB_STRIDE)
    pad = nb * DB_STRIDE - t
    bins = torch.nn.functional.pad(sq, (0, pad)).reshape(nb, DB_STRIDE).sum(-1)
    wb = max(1, int(round(window / DB_STRIDE)))
    half = wb // 2
    sums = torch.nn.functional.pad(bins, (half, wb - half - 1)).unfold(-1, wb, 1).sum(-1)
    return sums, _binned_counts(t, wb, str(sq.device))


@functools.lru_cache(maxsize=32)
def _binned_counts(t: int, wb: int, device: str) -> torch.Tensor:
    """In-bounds sample counts of the ``wb``-bin windows. They depend only on
    (t, wb): host numpy as in the JAX package, built once per (t, wb, device)
    as the JAX package builds them once per compile, so a warm call neither
    recomputes nor uploads them."""
    nb = -(-t // DB_STRIDE)
    pad = nb * DB_STRIDE - t
    half = wb // 2
    cnt = np.pad(np.ones((t,), np.float32), (0, pad)).reshape(nb, DB_STRIDE).sum(-1)
    cnt = np.pad(cnt, (half, wb - half - 1))
    cs = np.concatenate([[0.0], np.cumsum(cnt, dtype=np.float64)])
    counts = (cs[wb:] - cs[:-wb]).astype(np.float32)
    return torch.from_numpy(np.maximum(counts, 1.0)).to(device)


def _bundle_fn(
    mix: torch.Tensor,
    vocal: torch.Tensor,
    vad_net,
    sr: int,
    feat_hop: int,
    fine_hop: int,
    fine_frame: int,
    guard_win: int,
    refine_win: int,
    act_hop: int,
    act_frame: int,
) -> Dict[str, torch.Tensor]:
    """All envelopes over the padded (mix, vocal) pair; ``vad_net`` is a
    ``ConvVADNet`` on the same device, or None for the energy gate."""
    out = dict(_compute_features(mix, feat_hop, sr / feat_hop))
    out["vocal_rms_grid"] = frame_rms(vocal, 2048, feat_hop)
    out["vocal_rms_fine"] = frame_rms(vocal, fine_frame, fine_hop)
    out["vocal_db_guard"] = _rms_db_grid(vocal, guard_win)
    out["mix_db_guard"] = _rms_db_grid(mix, guard_win)
    out["mix_db_refine"] = _rms_db_grid(mix, refine_win)
    out["vocal_db_fine"] = _rms_db_grid(vocal, fine_frame)
    out["act_rms"] = frame_rms(vocal, act_frame, act_hop)
    if vad_net is not None:
        from audio_cut_tpu_torch.models.vad import device_probs_graph

        out["vad_probs"] = device_probs_graph(vad_net, vocal, sr_in=sr)
        # a SUM over the zero-padded track; unpack_bundle divides by the true
        # length for the separation-confidence heuristic
        out["vocal_energy"] = torch.sum(torch.square(vocal))
    return out


@dataclass
class DetectionBundle:
    sr: int
    features: TrackFeatures
    vocal_rms_grid: np.ndarray     # feature-grid RMS of the vocal stem
    vocal_rms_fine: np.ndarray     # 10 ms valley-scan envelope
    fine_fps: float
    vocal_db_guard: np.ndarray     # decimated dB grids (stride DB_STRIDE)
    mix_db_guard: np.ndarray
    mix_db_refine: np.ndarray
    vocal_db_fine: np.ndarray
    db_stride: int
    act_rms: np.ndarray            # 20 ms-hop vocal RMS for classification
    act_fps: float
    vad_probs: Optional[np.ndarray] = None   # ConvVAD frame probabilities (16 kHz / 512)
    vad_fps: float = 0.0
    vocal_energy: Optional[float] = None     # mean(vocal^2) for the confidence


def bundle_statics(sr: int, guard_win_ms: float = 80.0, refine_win_ms: float = 5.0):
    """(feat_hop, fine_hop, fine_frame, guard_win, refine_win, act_hop,
    act_frame): the static grid parameters of the bundle."""
    feat_hop = max(1, int(round(DEFAULT_HOP_S * sr)))
    fine_hop = max(1, int(round(0.01 * sr)))
    fine_frame = max(fine_hop, int(round(0.025 * sr)))
    guard_win = max(1, int(round(guard_win_ms / 1000.0 * sr)))
    refine_win = max(1, int(round(refine_win_ms / 1000.0 * sr)))
    act_hop = max(1, int(0.02 * sr))
    act_frame = max(act_hop * 2, int(0.05 * sr))
    return feat_hop, fine_hop, fine_frame, guard_win, refine_win, act_hop, act_frame


def unpack_bundle(
    flat_host: np.ndarray, shapes: Mapping[str, Tuple[int, ...]], sr: int, n_true: int,
    statics, vad_model,
) -> DetectionBundle:
    """Cut the one host copy back into a DetectionBundle, trimmed to the
    true length ``n_true``."""
    feat_hop, fine_hop, fine_frame, guard_win, refine_win, act_hop, act_frame = statics
    host = unflatten_outputs(flat_host, shapes)
    features = track_features_from_host(host, sr, DEFAULT_HOP_S, n_true)
    n_feat = n_true // feat_hop + 1
    n_fine = n_true // fine_hop + 1
    n_db = -(-n_true // DB_STRIDE)
    n_act = n_true // act_hop + 1
    vad_probs = None
    vad_fps = 0.0
    vocal_energy = None
    if vad_model is not None and "vad_probs" in host:
        from audio_cut_tpu_torch.models.vad import FRAME as VAD_FRAME, VAD_SR

        true_frames = int(n_true * VAD_SR / sr) // VAD_FRAME
        vad_probs = host["vad_probs"][:true_frames]
        vad_fps = VAD_SR / VAD_FRAME
        # sum(vocal^2) over the zero-padded track, over the TRUE length
        vocal_energy = float(host["vocal_energy"]) / max(n_true, 1)
    return DetectionBundle(
        sr=sr,
        features=features,
        vocal_rms_grid=host["vocal_rms_grid"][:n_feat],
        vocal_rms_fine=host["vocal_rms_fine"][:n_fine],
        fine_fps=sr / float(fine_hop),
        vocal_db_guard=host["vocal_db_guard"][:n_db],
        mix_db_guard=host["mix_db_guard"][:n_db],
        mix_db_refine=host["mix_db_refine"][:n_db],
        vocal_db_fine=host["vocal_db_fine"][:n_db],
        db_stride=DB_STRIDE,
        act_rms=host["act_rms"][:n_act],
        act_fps=sr / float(act_hop),
        vad_probs=vad_probs,
        vad_fps=vad_fps,
        vocal_energy=vocal_energy,
    )


def build_detection_bundle(
    mix_dev: torch.Tensor,
    vocal_dev: torch.Tensor,
    sr: int,
    n_true: int,
    *,
    guard_win_ms: float = 80.0,
    refine_win_ms: float = 5.0,
    vad_model=None,
) -> DetectionBundle:
    """The bundle of the padded mix and the vocal, both on one device, with
    ONE host copy. The vocal is cut to ``n_true`` and padded with exact zeros
    to the mix's length, so every caller that passes the same stems gets the
    same bits. Pass a ConvVAD as ``vad_model`` for its probabilities and the
    vocal energy."""
    statics = bundle_statics(sr, guard_win_ms, refine_win_ms)
    with torch.inference_mode():
        vocal = vocal_dev[..., :n_true]
        vocal = torch.nn.functional.pad(vocal, (0, int(mix_dev.shape[-1]) - vocal.shape[-1]))
        out = _bundle_fn(mix_dev, vocal, vad_model.net if vad_model is not None else None,
                         sr, *statics)
        flat, shapes = flatten_bundle(out)
        # the only device-to-host copy; it waits for the device
        flat_host = flat.cpu().numpy()
    return unpack_bundle(flat_host, shapes, sr, n_true, statics, vad_model)
