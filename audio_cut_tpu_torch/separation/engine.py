"""Chunked separation engine: schedule, batched window forward, device OLA.

Counterpart of ``audio_cut_tpu/separation/engine.py``. The whole track is
uploaded once (int16, quantized at its peak), cut into the backend's model
windows, run through the backend in groups, and overlap-added on the device
with the cross-fade/halo weights of ``ola_plan`` (the JAX package's
``_ola_graph``). The stems stay on the device; the host copies are lazy.

A backend with a native geometry (``engine_geometry()``: the ConvTDF and the
WaveUNet) gets engine windows equal to its model windows; one without (the
spectral mask) takes the config schedule, ``device_pipeline.chunk_seconds``
/ ``overlap_seconds`` / ``halo_seconds`` / ``align_hop``, as in the JAX
package.

The JAX package's backend fallback chain is not carried, by design: there a
primary backend that fails to load or run is replaced by
``enhanced_separation.fallback_backend`` and then by ``spectral`` while
``enhanced_separation.enable_fallback`` is on (the default), or the result
has no stems (``backend_used="none"``). That would hide the model. Here a
backend that fails to load or run raises, whatever those two keys say, and
no code path builds the spectral backend as a substitute.

With ``device_pipeline.pipelined_upload`` on (the default) and more than
two windows, the schedule is cut into pieces of ``piece_windows``
consecutive windows (at most ``max_pieces`` pieces), as in the JAX package's
``_piece_layout``. The int16 track is written once into a pinned host buffer
cached with the layout; each piece's new samples go to the device on a side
copy stream, and the compute stream waits for that copy before it runs the
piece's windows, so the upload of piece k+1 overlaps the forward of piece k.
The windows are added in plan order, as on the whole-track path, so the mix
is equal bit for bit and the stems differ only by the backend's batch
(``tests/test_torch_pipelined.py``). The layouts, and the whole-track plan,
live in a module cache that outlives the engine, keyed by a per-instance
backend token and the full geometry.

Not in this slice (ROADMAP.md, queue 1): the host-chunked path of backends
without a batched window forward.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from audio_cut_tpu_torch.config import get_config

# OLA layouts (device weight rows, inv_wsum, the pinned staging buffer) keyed
# by backend token and geometry; they outlive the engine, which the API builds
# anew for each call. Tokens are per backend instance, so a process that builds
# many backends would grow this forever: LRU-bounded, as in the JAX package.
_OLA_CACHE: Dict[Any, Any] = {}
_OLA_CACHE_MAX = 64
_OLA_CACHE_LOCK = threading.Lock()


def _ola_cache_get(key):
    with _OLA_CACHE_LOCK:
        if key in _OLA_CACHE:
            val = _OLA_CACHE.pop(key)
            _OLA_CACHE[key] = val  # re-insert: dict order == LRU order
            return True, val
    return False, None


def _ola_cache_put(key, val):
    with _OLA_CACHE_LOCK:
        _OLA_CACHE.pop(key, None)
        _OLA_CACHE[key] = val
        while len(_OLA_CACHE) > _OLA_CACHE_MAX:
            _OLA_CACHE.pop(next(iter(_OLA_CACHE)))
    return val


_CACHE_TOKENS = itertools.count(1)


def backend_cache_token(backend) -> int:
    """Monotonic per-instance cache key. ``id(backend)`` is unsafe: a backend
    can be collected and a new one, with other weights or geometry, allocated
    at the recycled address would hit the old one's cached layout."""
    tok = backend.__dict__.get("_cache_token")
    if tok is None:
        tok = next(_CACHE_TOKENS)
        backend.__dict__["_cache_token"] = tok
    return tok


_COPY_STREAMS: Dict[str, Any] = {}


def _copy_stream(device: torch.device):
    """The side stream that carries the uploads to ``device``, one per card."""
    key = str(device)
    stream = _COPY_STREAMS.get(key)
    if stream is None:
        stream = _COPY_STREAMS.setdefault(key, torch.cuda.Stream(device))
    return stream


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


def upload_pair(audio: np.ndarray, padded_len: int):
    """(raw, scale) of the host-to-device upload of ``audio`` padded with
    zeros to ``padded_len``: int16 quantized at its peak under
    ``device_pipeline.upload_int16`` (the default), else the float32 samples
    and scale 1. The device's mix is ``dequantize(raw, scale, device)``."""
    n = audio.shape[-1]
    padded = np.pad(audio, (0, padded_len - n)) if padded_len != n else audio
    if bool(get_config("device_pipeline.upload_int16", True)):
        # half the upload bytes at -90 dB quantization; the host keeps the
        # exact input for splicing and the complement instrumental
        return quantize_upload(padded)
    return padded, np.float32(1.0)


def dequantize(raw: np.ndarray, scale, device: torch.device) -> torch.Tensor:
    """The mix on ``device``: ``raw * scale`` in float32, as the engine's
    pieces compute it (``scale`` is a float32 value, so the product rounds
    as x * float32(scale))."""
    return torch.mul(torch.from_numpy(raw).to(device), float(scale))


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

    def __init__(self, sample_rate: int, device: torch.device, backend=None) -> None:
        """``backend``: an instance to run (the batch's, shared with its mesh
        pass), else the one ``enhanced_separation.backend`` names, built on
        first use."""
        self.sample_rate = int(sample_rate)
        self.device = torch.device(device)
        self._backend = backend
        self._backend_name = (backend.name if backend is not None
                              else str(get_config("enhanced_separation.backend", "convtdf")))

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

    def _layout_key(self, kind: str, padded_len: int, *extra) -> Tuple:
        """The full geometry, the backend instance and the device: a key of
        shapes alone reused a stale combine in the JAX package (0.62 L_inf)."""
        return (kind, self._backend_name, backend_cache_token(self.backend), str(self.device),
                self.sample_rate, padded_len, *self._geometry(), *extra)

    def _build_layout(self, padded_len: int, per: Optional[int]) -> Dict[str, Any]:
        """The OLA plan cut into pieces of ``per`` consecutive windows (None:
        one piece of all of them): their start groups, spans, device weight
        rows and window offsets within the span, and the samples each piece
        owns, those that no earlier span holds (a partition of the track,
        uploaded once)."""
        plans, window, weights, inv_wsum = ola_plan(
            padded_len, self.sample_rate, *self._geometry())
        starts = [p.start for p in plans]
        per = per or len(starts)
        groups = [starts[k:k + per] for k in range(0, len(starts), per)]
        spans = [(g[0], g[-1] + window) for g in groups]
        owned = [(spans[k - 1][1] if k else 0, e) for k, (_s, e) in enumerate(spans)]
        if owned[-1][1] != padded_len:
            raise ValueError(f"OLA plan ends at {owned[-1][1]}, not the padded length {padded_len}")
        rows, offsets, base = [], [], 0
        for g, (s, _e) in zip(groups, spans):
            rows.append(torch.from_numpy(weights[base:base + len(g)]).to(self.device))
            offsets.append([st - s for st in g])
            base += len(g)
        return {
            "per": per,
            "window": window,
            "n_chunks": len(plans),
            "groups": groups,
            "spans": spans,
            "span_len": max(e - s for s, e in spans),
            "kmax": max(len(g) for g in groups),
            "weights": rows,
            "offsets": offsets,
            "owned": owned,
            "inv_wsum": torch.from_numpy(inv_wsum).to(self.device),
            "padded_len": padded_len,
            # pinned host buffers of the upload, by dtype; the lock keeps one
            # call's copies out of the buffer until the previous call's fence
            "staging": {},
            "lock": threading.Lock(),
        }

    def _piece_layout(self, padded_len: int) -> Optional[Dict[str, Any]]:
        """The pipelined layout (cached), as the JAX package's
        ``_piece_layout``: None when ``device_pipeline.pipelined_upload`` is
        off or the schedule has at most 2 windows; else pieces of
        ``max(piece_windows, ceil(windows / max_pieces))`` windows."""
        if not bool(get_config("device_pipeline.pipelined_upload", True)):
            return None
        per = max(1, int(get_config("device_pipeline.piece_windows", 2)))
        max_pieces = max(2, int(get_config("device_pipeline.max_pieces", 8)))
        key = self._layout_key("piece_layout", padded_len, per, max_pieces)
        hit, layout = _ola_cache_get(key)
        if hit:
            return layout
        plans, _ = chunk_schedule(padded_len, self.sample_rate, *self._geometry())
        if len(plans) <= 2:
            return _ola_cache_put(key, None)
        # each piece is a copy and a forward: cap the count, so that small
        # native windows do not shatter the schedule into tiny pieces
        per = max(per, -(-len(plans) // max_pieces))
        return _ola_cache_put(key, self._build_layout(padded_len, per))

    def _whole_layout(self, padded_len: int) -> Dict[str, Any]:
        """The whole-track plan (cached): one piece holding every window."""
        key = self._layout_key("ola_plan", padded_len)
        hit, layout = _ola_cache_get(key)
        if hit:
            return layout
        return _ola_cache_put(key, self._build_layout(padded_len, None))

    def _stage(self, layout: Dict[str, Any], raw: np.ndarray):
        """On the card: ``raw`` into the layout's pinned buffer (allocated
        once), and the device buffer the pieces' copies fill. Returns
        (pinned buffer, device buffer, side stream). The device buffer is
        allocated on the compute stream, which reads it only after waiting
        for each copy, so its memory is not reused while a copy may still
        write it; the side stream first waits for the compute stream, whose
        queued work may still read that memory from an earlier tensor."""
        staging = layout["staging"].get(raw.dtype.str)
        if staging is None:
            staging = torch.empty(raw.shape, dtype=torch.from_numpy(raw[:0]).dtype,
                                  pin_memory=True)
            layout["staging"][raw.dtype.str] = staging
        staging.numpy()[:] = raw
        dev_raw = torch.empty(staging.shape, dtype=staging.dtype, device=self.device)
        side = _copy_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        return staging, dev_raw, side

    @staticmethod
    def _copy(staging: torch.Tensor, dev_raw: torch.Tensor, side, a: int, b: int):
        """Samples [a, b) to the device on the side stream; returns the
        event the compute stream waits for."""
        with torch.cuda.stream(side):
            dev_raw[a:b].copy_(staging[a:b], non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return done

    def _run_layout(self, layout: Dict[str, Any], raw: np.ndarray, scale) -> Tuple[torch.Tensor, ...]:
        """Every piece in order: wait for its copy, dequantize its owned
        samples into the mix, slice its windows at the cached offsets, one
        backend call, weight them, and add them into the stems in plan order
        (the JAX package's association). On the card the copy of piece k+1
        is queued before piece k's work, so it streams while that piece
        computes. Returns (vocal, inst, mix) of the padded length. On the
        CPU the same steps run on ``raw`` itself."""
        dev = self.device
        owned = layout["owned"]
        if dev.type == "cuda":
            staging, dev_raw, side = self._stage(layout, raw)
            ready = [self._copy(staging, dev_raw, side, *owned[0])]
        else:
            dev_raw, ready = torch.from_numpy(raw), None
        padded_len, window = layout["padded_len"], layout["window"]
        scale = float(scale)  # a float32 value: the product rounds as x * float32(scale)
        mix = torch.empty(padded_len, dtype=torch.float32, device=dev)
        vocal = torch.zeros(padded_len, dtype=torch.float32, device=dev)
        inst = torch.zeros(padded_len, dtype=torch.float32, device=dev)
        pieces = zip(layout["groups"], layout["spans"], owned, layout["offsets"], layout["weights"])
        for k, (group, (s, e), (a, b), offsets, w) in enumerate(pieces):
            if ready is not None:
                if k + 1 < len(owned):
                    ready.append(self._copy(staging, dev_raw, side, *owned[k + 1]))
                torch.cuda.current_stream(dev).wait_event(ready[k])
            torch.mul(dev_raw[a:b], scale, out=mix[a:b])
            span = mix[s:e]
            v, i = self.backend.separate_windows(torch.stack([span[o:o + window] for o in offsets]))
            wv, wi = v * w, i * w
            for j, start in enumerate(group):
                vocal[start:start + window] += wv[j]
                inst[start:start + window] += wi[j]
        norm = layout["inv_wsum"]
        return vocal * norm, inst * norm, mix

    @torch.inference_mode()
    def separate_on_device(self, audio: np.ndarray):
        """Returns (vocal_dev, inst_dev, mix_dev, meta): device stems of
        len(audio), and the bucket-padded dequantized mix. The manifest's
        label is ``device_ola_pipelined_p<pieces>`` on the pipelined layout,
        else ``device_ola``."""
        audio = np.asarray(audio, dtype=np.float32)
        n = audio.shape[-1]
        padded_len = padded_track_len(n, self.sample_rate, self._geometry()[3])

        t0 = time.time()
        raw, scale = upload_pair(audio, padded_len)
        layout = self._piece_layout(padded_len)
        if layout is None:
            mode, layout = "device_ola", self._whole_layout(padded_len)
        else:
            mode = f"device_ola_pipelined_p{len(layout['spans'])}"
        with layout["lock"]:
            vocal, inst, mix = self._run_layout(layout, raw, scale)
            # fence before timing (kernels run asynchronously), and before the
            # next call may refill the pinned buffer
            self._synchronize()
        elapsed_ms = round((time.time() - t0) * 1000.0, 3)
        meta = {
            "gpu_pipeline_backend": self._backend_name,
            "gpu_pipeline_chunks": layout["n_chunks"],
            "gpu_pipeline_window_samples": padded_len,
            "gpu_pipeline_compute_ms": elapsed_ms,
            "gpu_pipeline_total_ms": elapsed_ms,
            "gpu_pipeline_device": vocal.device.type,
            "gpu_pipeline_mode": mode,
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
