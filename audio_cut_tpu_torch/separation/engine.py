"""Chunked separation engine: schedule, batched window forward, device OLA.

Counterpart of ``audio_cut_tpu/separation/engine.py``. The whole track is
uploaded once (int16, quantized at its peak), cut into the backend's model
windows, run through the backend in groups, and overlap-added on the device
with the cross-fade/halo weights of ``ola_plan`` (the JAX package's
``_ola_graph``). The stems stay on the device; the host copies are lazy.

A backend with a native geometry (``engine_geometry()``, the ConvTDF) gets
engine windows equal to its model windows; one without (the spectral mask)
takes the config schedule, ``device_pipeline.chunk_seconds`` /
``overlap_seconds`` / ``halo_seconds`` / ``align_hop``, as in the JAX
package.

The JAX package's backend fallback chain is not carried, by design: there a
primary backend that fails to load or run is replaced by
``enhanced_separation.fallback_backend`` and then by ``spectral`` while
``enhanced_separation.enable_fallback`` is on (the default), or the result
has no stems (``backend_used="none"``). That would hide the model. Here a
backend that fails to load or run raises, whatever those two keys say, and
no code path builds the spectral backend as a substitute.

Not in this slice (ROADMAP.md, queue 1): the pipelined piece upload, which
gives the same stems and overlaps the upload with compute; the host-chunked
path of backends without a batched window forward.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from audio_cut_tpu_torch.config import get_config

# track-length padding bucket for the whole-track OLA program (see the JAX
# package: it bounds the number of distinct compiled lengths there; the port
# keeps the same buckets so both compute the same OLA plan)
PAD_BUCKET_S = 15.0

# beyond this track length, buckets widen to device_pipeline.long_bucket_seconds
LONG_TRACK_S = 75.0


def padded_track_len(n: int, sr: int, align: int = 1) -> int:
    """Single source of truth for the bucket-padded whole-track length.

    15 s buckets up to LONG_TRACK_S, then long_bucket_seconds buckets, then
    align-rounding for the backend's window schedule. Must agree bit for bit
    with ``audio_cut_tpu.separation.engine.padded_track_len``.
    """
    bucket = int(round(PAD_BUCKET_S * sr))
    padded = max(bucket, ((n + bucket - 1) // bucket) * bucket)
    if padded > int(round(LONG_TRACK_S * sr)):
        long_bucket = int(round(
            float(get_config("device_pipeline.long_bucket_seconds", 60.0)) * sr))
        if long_bucket > 0:
            padded = ((n + long_bucket - 1) // long_bucket) * long_bucket
    if align > 1:
        padded = ((padded + align - 1) // align) * align
    return padded


@dataclass(frozen=True)
class ChunkPlan:
    """One window of the schedule."""

    index: int
    start: int            # window start sample (includes left halo)
    end: int              # window end sample (includes right halo)
    effective_start: int  # samples owned by this chunk after halo trim
    effective_end: int


def quantize_upload(padded: np.ndarray):
    """(raw, scale) for the int16 host->device upload, quantized at the
    signal's actual peak (guarded against near-silence)."""
    peak = max(float(np.abs(padded).max()), 1e-4)
    raw = np.round(padded * (32767.0 / peak)).astype(np.int16)
    return raw, np.float32(peak / 32767.0)


def ola_plan(
    padded_len: int,
    sr: int,
    chunk_s: float,
    overlap_s: float,
    halo_s: float,
    align: int,
):
    """Shared whole-track OLA plan: (plans, window, weights, inv_wsum).

    ``weights`` is the per-window [n, window] cross-fade/halo mask and
    ``inv_wsum`` the [padded_len] normalization curve.
    """
    plans, window = chunk_schedule(padded_len, sr, chunk_s, overlap_s, halo_s, align)
    halo = int(round(halo_s * sr))
    ramp = max(1, int(round((overlap_s - 2 * halo_s) * sr)))
    weights = np.ones((len(plans), window), dtype=np.float32)
    for k, p in enumerate(plans):
        w = weights[k]
        w[:ramp] = np.linspace(0.0, 1.0, ramp, endpoint=False) + 1e-6
        w[-ramp:] = np.linspace(1.0, 0.0, ramp, endpoint=False) + 1e-6
        # halo samples contribute nothing (recomputed by the neighbour);
        # halo == 0 means pure cross-fade (w[-0:] would zero the whole window)
        if halo > 0:
            if p.start > 0:
                w[:halo] = 0.0
            if p.start + window < padded_len:
                w[-halo:] = 0.0
    wsum = np.full(padded_len, 1e-9, dtype=np.float32)
    for k, p in enumerate(plans):
        wsum[p.start:p.start + window] += weights[k]
    # coverage invariant: every sample must receive weight from some window;
    # a violation means overlap < 2*halo: silent zeros in the output
    if float(wsum.min()) < 1e-7:
        raise ValueError(
            f"OLA plan leaves uncovered samples (min weight {wsum.min():.2e}); "
            f"geometry overlap={overlap_s}s halo={halo_s}s window={window}"
        )
    inv_wsum = (1.0 / wsum).astype(np.float32)
    return plans, window, weights, inv_wsum


def chunk_schedule(
    total_samples: int,
    sr: int,
    chunk_s: float = 10.0,
    overlap_s: float = 2.5,
    halo_s: float = 0.5,
    align: int = 4096,
) -> Tuple[List[ChunkPlan], int]:
    """Fixed-length window schedule. Returns (plans, window_len).

    Window length, overlap and every chunk start are multiples of ``align``,
    which keeps the STFT frame phase of a chunk equal to the full track's.
    Every window has the same length; the final window is right-aligned to
    the align-padded track end.
    """
    window = int(round(chunk_s * sr))
    window = ((window + align - 1) // align) * align
    overlap = max(align, (int(round(overlap_s * sr)) // align) * align)
    halo = int(round(halo_s * sr))
    stride = max(window - overlap, align)
    total_padded = ((total_samples + align - 1) // align) * align

    if total_samples <= window:
        return [ChunkPlan(0, 0, window, 0, total_samples)], window

    plans: List[ChunkPlan] = []
    start = 0
    idx = 0
    prev_eff_end = 0
    while True:
        last = start + window >= total_padded
        if last:
            start = total_padded - window  # aligned: both are align multiples
        end = min(start + window, total_samples)
        eff_start = prev_eff_end
        eff_end = total_samples if last else min(end - halo, total_samples)
        plans.append(ChunkPlan(idx, start, end, eff_start, eff_end))
        prev_eff_end = eff_end
        if last:
            break
        start += stride
        idx += 1
    return plans, window


def _estimate_confidence(mix: np.ndarray, vocal: np.ndarray) -> float:
    """Energy-partition heuristic: confident when the vocal estimate is a
    meaningful, sub-unity share of the mix."""
    e_mix = float(np.mean(np.square(mix))) + 1e-12
    e_voc = float(np.mean(np.square(vocal)))
    ratio = e_voc / e_mix
    return float(np.clip(1.0 - abs(ratio - 0.35) / 0.65, 0.1, 0.99))


class SeparationResult:
    """Stems of one track. The device stems (``vocal_device``,
    ``instrumental_device``) are torch tensors; ``vocal_track`` and
    ``instrumental_track`` copy them to the host on first access."""

    def __init__(
        self,
        vocal_track: Optional[np.ndarray],
        instrumental_track: Optional[np.ndarray],
        backend_used: str,
        separation_confidence: Optional[float],
        device_meta: Optional[Dict[str, Any]] = None,
    ) -> None:
        self._vocal_host = vocal_track
        self._inst_host = instrumental_track
        self.backend_used = backend_used
        self._confidence = separation_confidence
        self._mix_energy: Optional[float] = None
        self.device_meta = device_meta or {}
        self.vocal_device: Optional[torch.Tensor] = None
        self.instrumental_device: Optional[torch.Tensor] = None
        self.mix_device: Optional[torch.Tensor] = None

    @property
    def separation_confidence(self) -> float:
        """Lazy when the stems stayed on the device: computed from the host
        vocal if it exists, else from one device reduction."""
        if self._confidence is None:
            if self._mix_energy is not None and self._vocal_host is not None:
                e_voc = float(np.mean(np.square(self._vocal_host, dtype=np.float64)))
            elif self.vocal_device is not None and self._mix_energy is not None:
                e_voc = float(torch.mean(torch.square(self.vocal_device)))
            else:
                self._confidence = 0.0
                return self._confidence
            ratio = e_voc / (self._mix_energy + 1e-12)
            self._confidence = float(np.clip(1.0 - abs(ratio - 0.35) / 0.65, 0.1, 0.99))
        return self._confidence

    @separation_confidence.setter
    def separation_confidence(self, value: Optional[float]) -> None:
        self._confidence = value

    @property
    def vocal_track(self) -> Optional[np.ndarray]:
        if self._vocal_host is None and self.vocal_device is not None:
            self._vocal_host = self.vocal_device.cpu().numpy()
        return self._vocal_host

    @vocal_track.setter
    def vocal_track(self, value: Optional[np.ndarray]) -> None:
        self._vocal_host = value

    @property
    def instrumental_track(self) -> Optional[np.ndarray]:
        if self._inst_host is None and self.instrumental_device is not None:
            self._inst_host = self.instrumental_device.cpu().numpy()
        return self._inst_host

    @instrumental_track.setter
    def instrumental_track(self, value: Optional[np.ndarray]) -> None:
        self._inst_host = value

    @property
    def has_vocal(self) -> bool:
        """True when a vocal stem exists (host or device) without a download."""
        return self._vocal_host is not None or self.vocal_device is not None

    def complement_instrumental(self, mix: np.ndarray) -> Optional[np.ndarray]:
        """Materialize the instrumental as ``mix - vocal`` on the host.

        The backend's windows give complementary stems and the OLA weights
        are a partition of unity, so this equals the device instrumental up
        to float association, and skips its download. No-op when a host
        instrumental already exists."""
        if self._inst_host is None:
            v = self.vocal_track  # may download the vocal (one transfer)
            if v is not None:
                n = v.shape[-1]
                self._inst_host = np.asarray(mix[..., :n], dtype=np.float32) - v
        return self._inst_host


class SeparationEngine:
    """Runs a backend's model windows over the whole track on one device."""

    def __init__(self, sample_rate: int, device: torch.device) -> None:
        self.sample_rate = int(sample_rate)
        self.device = torch.device(device)
        self._backend = None
        self._backend_name = str(get_config("enhanced_separation.backend", "convtdf"))

    @property
    def backend(self):
        if self._backend is None:
            from audio_cut_tpu_torch.separation.backends import make_backend

            self._backend = make_backend(self._backend_name, self.sample_rate, self.device)
        return self._backend

    def _geometry(self) -> Tuple[float, float, float, int]:
        """The chunk geometry (chunk, overlap, halo seconds; align): the
        backend's native one, where engine windows are model windows and the
        whole-track OLA is one batched model forward; else the config's."""
        geometry = getattr(self.backend, "engine_geometry", None)
        if geometry is None:
            return (float(get_config("device_pipeline.chunk_seconds", 10.0)),
                    float(get_config("device_pipeline.overlap_seconds", 2.5)),
                    float(get_config("device_pipeline.halo_seconds", 0.5)),
                    int(get_config("device_pipeline.align_hop", 4096)))
        g = geometry()
        return float(g["chunk_s"]), float(g["overlap_s"]), float(g["halo_s"]), int(g["align"])

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def separate_on_device(self, audio: np.ndarray):
        """Returns (vocal_dev, inst_dev, mix_dev, meta): device stems of
        len(audio), and the bucket-padded dequantized mix."""
        audio = np.asarray(audio, dtype=np.float32)
        n = audio.shape[-1]
        chunk_s, overlap_s, halo_s, align = self._geometry()
        padded_len = padded_track_len(n, self.sample_rate, align)
        plans, window, weights, inv_wsum = ola_plan(
            padded_len, self.sample_rate, chunk_s, overlap_s, halo_s, align)

        t0 = time.time()
        padded = np.pad(audio, (0, padded_len - n)) if padded_len != n else audio
        dev = self.device
        if bool(get_config("device_pipeline.upload_int16", True)):
            # half the upload bytes at -90 dB quantization; the host keeps the
            # exact input for splicing and the complement instrumental
            raw, scale = quantize_upload(padded)
            mix = torch.from_numpy(raw).to(dev).to(torch.float32) * torch.tensor(scale, device=dev)
        else:
            mix = torch.from_numpy(padded).to(dev)
        windows = torch.stack([mix[p.start:p.start + window] for p in plans])
        v, i = self.backend.separate_windows(windows)
        w = torch.from_numpy(weights).to(dev)
        wv, wi = v * w, i * w
        vocal = torch.zeros(padded_len, dtype=torch.float32, device=dev)
        inst = torch.zeros(padded_len, dtype=torch.float32, device=dev)
        for k, p in enumerate(plans):  # in order: the JAX package's association
            vocal[p.start:p.start + window] += wv[k]
            inst[p.start:p.start + window] += wi[k]
        norm = torch.from_numpy(inv_wsum).to(dev)
        vocal, inst = vocal * norm, inst * norm
        # fence before timing: kernels run asynchronously
        self._synchronize()
        elapsed_ms = round((time.time() - t0) * 1000.0, 3)
        meta = {
            "gpu_pipeline_backend": self._backend_name,
            "gpu_pipeline_chunks": len(plans),
            "gpu_pipeline_window_samples": padded_len,
            "gpu_pipeline_compute_ms": elapsed_ms,
            "gpu_pipeline_total_ms": elapsed_ms,
            "gpu_pipeline_device": vocal.device.type,
            "gpu_pipeline_mode": "device_ola",
        }
        return vocal[:n], inst[:n], mix, meta

    def separate_for_detection(
        self, audio: np.ndarray, need_instrumental: bool = True
    ) -> SeparationResult:
        audio = np.asarray(audio, dtype=np.float32)
        vocal_dev, inst_dev, mix_dev, meta = self.separate_on_device(audio)
        vocal = inst = None
        if need_instrumental:
            both = torch.stack([vocal_dev, inst_dev]).cpu().numpy()
            vocal, inst = both[0], both[1]
        result = SeparationResult(
            vocal_track=vocal,
            instrumental_track=inst,
            backend_used=self._backend_name,
            separation_confidence=_estimate_confidence(audio, vocal) if vocal is not None else None,
            device_meta=meta,
        )
        if vocal is None:
            result._mix_energy = float(np.mean(np.square(audio)))
        result.vocal_device = vocal_dev
        result.instrumental_device = inst_dev
        result.mix_device = mix_dev
        return result
