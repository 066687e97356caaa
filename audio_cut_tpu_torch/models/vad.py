"""ConvVAD: the learned voice-activity model, in PyTorch.

Counterpart of ``audio_cut_tpu/models/vad.py``: a strided 1-D conv encoder
over 16 kHz audio, a pairwise mean onto the 512-sample (32 ms) frame grid,
dilated residual context convs at the frame rate, then one dense logit per
frame. The operational wrapper resamples the native-rate vocal to 16 kHz,
runs fixed 8 s windows with a halo on each side in one batched forward and
trims the halos.

What carries the flax semantics over (checked against flax by
``tests/test_torch_vad.py``):

* activations are NWC [B, T, C], as in flax, and conv kernels stay in flax's
  (k, in, out) layout;
* ``padding="SAME"`` pads (total // 2, total - total // 2) with
  total = (ceil(n / stride) - 1) * stride + (k - 1) * dilation + 1 - n:
  (2, 3) for the kernel-9, stride-4 encoder convs on a length divisible by 4,
  (2d, 2d) for the kernel-5 context convs at dilation d;
* ``GroupNorm(4)`` has eps 1e-6 (the port's ``GroupNorm`` of ``convtdf``);
  ``nn.gelu`` is the tanh form.

Each conv is one float32 matrix product: the k dilated, strided taps of the
padded input are concatenated over the channels and multiplied by the
kernel reshaped to (k * in, out). On the card cuBLAS runs it in full float32
under torch's default matmul precision, where ``conv1d`` would go through
cuDNN in TF32. The port sets no global setting of torch.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from audio_cut_tpu_torch.models.convtdf import WEIGHTS_DIR, GroupNorm, _same_pad

VAD_SR = 16000
FRAME = 512  # 32 ms at 16 kHz
# fixed inference window: 8 s interior plus a halo on each side
WINDOW_S = 8.0
HALO_S = 0.25
PACKAGED_CHECKPOINT = "convvad_v1.msgpack"


def context_halo_s(context: int) -> float:
    """Per-side halo that covers the receptive field of the context block:
    kernel 5 at dilation 2^i spreads 2*2^i frames of 32 ms per side."""
    return HALO_S + 0.064 * ((1 << int(context)) - 1)


class _ConvNWC(nn.Module):
    """flax ``nn.Conv`` with ``padding="SAME"`` on [B, T, C], as one matmul."""

    def __init__(self, k: int, cin: int, cout: int, stride: int = 1, dilation: int = 1) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(k, cin, cout))  # flax (k, in, out)
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride = stride
        self.dilation = dilation

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        k, cin, cout = self.weight.shape
        n = h.shape[1]
        lo, hi = _same_pad(n, self.stride, (k - 1) * self.dilation + 1)
        hp = F.pad(h, (0, 0, lo, hi))
        out_len = -(-n // self.stride)
        span = (out_len - 1) * self.stride + 1
        taps = [hp[:, j * self.dilation:j * self.dilation + span:self.stride, :] for j in range(k)]
        cols = torch.cat(taps, dim=-1)  # [B, out_len, k * cin], (k, in) order
        return torch.matmul(cols, self.weight.reshape(k * cin, cout)) + self.bias


class ConvVADNet(nn.Module):
    """[B, T] 16 kHz waveform -> [B, T // FRAME] speech logits."""

    def __init__(self, channels: int = 32, depth: int = 4, context: int = 0) -> None:
        super().__init__()
        self.channels = channels
        self.depth = depth
        self.context = context
        self.enc = nn.ModuleList()
        self.enc_norm = nn.ModuleList()
        cin, ch, stride_total = 1, channels, 1
        for _ in range(depth):
            stride = 4 if stride_total * 4 <= FRAME else FRAME // stride_total
            self.enc.append(_ConvNWC(9, cin, ch, stride=stride))
            self.enc_norm.append(GroupNorm(ch))
            stride_total *= stride
            cin, ch = ch, min(ch * 2, 128)
        self.ctx = nn.ModuleList(_ConvNWC(5, cin, cin, dilation=2 ** c) for c in range(context))
        self.ctx_norm = nn.ModuleList(GroupNorm(cin) for _ in range(context))
        self.dense = nn.Linear(cin, 1)

    @staticmethod
    def _norm(norm: GroupNorm, h: torch.Tensor) -> torch.Tensor:
        return norm(h.transpose(1, 2)).transpose(1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[..., None]
        for conv, norm in zip(self.enc, self.enc_norm):
            h = F.gelu(self._norm(norm, conv(h)), approximate="tanh")
        # collapse the residual stride onto the FRAME grid (256 -> 512 samples)
        target = x.shape[-1] // FRAME
        h = h[:, :target * (h.shape[1] // max(target, 1)), :]
        if target > 0 and h.shape[1] != target:
            h = h[:, :target * (h.shape[1] // target), :]
            h = h.reshape(h.shape[0], target, -1, h.shape[-1]).mean(dim=2)
        for conv, norm in zip(self.ctx, self.ctx_norm):
            h = h + F.gelu(self._norm(norm, conv(h)), approximate="tanh")
        w = self.dense.weight.reshape(-1, 1)  # [C, 1], a float32 matmul as above
        return (torch.matmul(h, w) + self.dense.bias)[..., 0]


def _leaf(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def convert_convvad_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ConvVADNet params (nested dict of numpy arrays) -> ``ConvVADNet``
    state_dict. flax numbers the layers in creation order: the encoder convs
    and norms first, then the context convs and norms, then ``Dense_0``.
    Every leaf lands in exactly one entry; an unexpected leaf raises."""
    n_conv = sum(1 for k in tree if k.startswith("Conv_"))
    # the encoder convs have kernel 9, the context convs kernel 5
    n_enc = sum(1 for i in range(n_conv) if np.shape(tree[f"Conv_{i}"]["kernel"])[0] == 9)
    out: Dict[str, torch.Tensor] = {}
    for i in range(n_conv):
        prefix, j = ("enc", i) if i < n_enc else ("ctx", i - n_enc)
        out[f"{prefix}.{j}.weight"] = _leaf(tree[f"Conv_{i}"]["kernel"])
        out[f"{prefix}.{j}.bias"] = _leaf(tree[f"Conv_{i}"]["bias"])
        out[f"{prefix}_norm.{j}.weight"] = _leaf(tree[f"GroupNorm_{i}"]["scale"])
        out[f"{prefix}_norm.{j}.bias"] = _leaf(tree[f"GroupNorm_{i}"]["bias"])
    out["dense.weight"] = _leaf(tree["Dense_0"]["kernel"]).T.contiguous()
    out["dense.bias"] = _leaf(tree["Dense_0"]["bias"])
    expected = {f"Conv_{i}" for i in range(n_conv)} | {f"GroupNorm_{i}" for i in range(n_conv)}
    extra = set(tree) - expected - {"Dense_0"}
    if extra:
        raise ValueError(f"unexpected ConvVAD parameters {sorted(extra)}")
    return out


def read_vad_sidecar(checkpoint: str) -> dict:
    """Architecture/calibration sidecar ``<checkpoint>.json``: {channels,
    depth, context, threshold}. A missing file gives {}."""
    path = str(checkpoint) + ".json"
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def packaged_checkpoint_path() -> Optional[str]:
    path = WEIGHTS_DIR / PACKAGED_CHECKPOINT
    return str(path) if path.exists() else None


def device_probs_graph(net: ConvVADNet, x: torch.Tensor, *, sr_in: int) -> torch.Tensor:
    """Resample to 16 kHz, overlapped fixed windows, forward, sigmoid and halo
    trim over a padded waveform on its device -> flat frame probabilities."""
    from audio_cut_tpu_torch.ops.resample import resample_graph

    in_len = int(x.shape[-1])
    out_len = int(round(in_len * VAD_SR / sr_in))
    halo = int(context_halo_s(net.context) * VAD_SR) // FRAME * FRAME
    interior = int(WINDOW_S * VAD_SR) // FRAME * FRAME
    window = interior + 2 * halo
    n_windows = max(1, -(-out_len // interior))
    n_pad = 1
    while n_pad < n_windows:  # a power of two, as the JAX package buckets it
        n_pad *= 2
    x16 = resample_graph(x, sr_in, VAD_SR)
    padded = F.pad(x16, (halo, n_pad * interior + halo - out_len))
    windows = torch.stack([padded[k * interior:k * interior + window] for k in range(n_pad)])
    probs = torch.sigmoid(net(windows))
    hf = halo // FRAME
    return probs[:, hf:hf + interior // FRAME].reshape(-1)


class ConvVAD:
    """Operational wrapper: the net on its device, and speech segments from
    its frame probabilities. ``threshold=None`` takes the sidecar's
    calibrated threshold (0.5 without one); an explicit float wins."""

    def __init__(self, sample_rate: int, checkpoint: str, device: torch.device,
                 threshold: Optional[float] = None) -> None:
        from audio_cut_tpu_torch.models.flax_msgpack import read_flax_msgpack

        if not str(checkpoint).endswith(".msgpack"):
            raise NotImplementedError(
                f"VAD checkpoint {checkpoint}: the PyTorch port reads flax .msgpack "
                "checkpoints only (orbax directories: ROADMAP.md, queue 1)")
        self.native_sr = int(sample_rate)
        sidecar = read_vad_sidecar(checkpoint)
        if threshold is None:
            threshold = sidecar.get("threshold", 0.5)
        self.threshold = float(threshold)
        self.net = ConvVADNet(
            channels=int(sidecar.get("channels", 32)),
            depth=int(sidecar.get("depth", 4)),
            context=int(sidecar.get("context", 0)),
        )
        self.net.load_state_dict(convert_convvad_params(read_flax_msgpack(checkpoint)), strict=True)
        self.net.to(torch.device(device)).eval()

    def detect(self, probs: np.ndarray, n_true: Optional[int] = None,
               min_speech_s: float = 0.1, min_silence_s: float = 0.15):
        """Speech segments in native-rate seconds from frame probabilities."""
        from audio_cut_tpu_torch.detection.vad import VadResult

        probs = np.asarray(probs)
        if n_true is not None:
            probs = probs[: int(n_true * VAD_SR / self.native_sr) // FRAME]
        fps = VAD_SR / FRAME
        mask = probs > self.threshold
        # close short gaps, drop short bursts
        min_sil = max(1, int(round(min_silence_s * fps)))
        min_sp = max(1, int(round(min_speech_s * fps)))
        inv = ~mask
        edges = np.diff(inv.astype(np.int8), prepend=0, append=0)
        for s, e in zip(np.nonzero(edges == 1)[0], np.nonzero(edges == -1)[0]):
            if e - s <= min_sil:
                mask[s:e] = True
        out: List[Tuple[float, float]] = []
        edges = np.diff(mask.astype(np.int8), prepend=0, append=0)
        for s, e in zip(np.nonzero(edges == 1)[0], np.nonzero(edges == -1)[0]):
            if e - s >= min_sp:
                out.append((s / fps, e / fps))
        return VadResult(out, fps)


# a loaded detector per (rate, checkpoint, threshold, file times, device):
# a fresh pipeline per API call reuses it, and an in-place retrain misses
_VAD_CACHE: Dict[Tuple, ConvVAD] = {}
_VAD_CACHE_MAX = 8


def _mtime(path: str) -> int:
    try:
        return os.stat(path).st_mtime_ns
    except OSError:
        return 0


def build_vad(sample_rate: int, device: torch.device):
    """The detector ``vad.backend`` asks for: ``conv`` (the configured or the
    packaged ConvVAD checkpoint) or ``energy_gate``. A ConvVAD that cannot be
    loaded raises; the port never swaps in the energy gate for it."""
    from audio_cut_tpu_torch.config import get_config
    from audio_cut_tpu_torch.detection.vad import EnergyGateDetector

    backend = str(get_config("vad.backend", "conv"))
    if backend == "energy_gate":
        return EnergyGateDetector(sample_rate)
    if backend != "conv":
        raise ValueError(f"vad.backend must be 'conv' or 'energy_gate', got {backend!r}")
    threshold = get_config("vad.threshold", None)
    if threshold is not None:
        threshold = float(threshold)
    ckpt = get_config("vad.checkpoint") or packaged_checkpoint_path()
    if not ckpt:
        raise RuntimeError(f"vad.backend=conv but vad.checkpoint is unset and no "
                           f"{PACKAGED_CHECKPOINT} is in {WEIGHTS_DIR}")
    ckpt = str(Path(ckpt))
    key = (int(sample_rate), ckpt, threshold, _mtime(ckpt), _mtime(ckpt + ".json"),
           str(torch.device(device)))
    vad = _VAD_CACHE.get(key)
    if vad is None:
        vad = ConvVAD(sample_rate, ckpt, device, threshold=threshold)
        _VAD_CACHE[key] = vad
        while len(_VAD_CACHE) > _VAD_CACHE_MAX:
            _VAD_CACHE.pop(next(iter(_VAD_CACHE)))
    return vad
