"""Conv-TDF spectrogram mask network in PyTorch.

Counterpart of ``audio_cut_tpu/models/convtdf.py``: a U-Net over the complex
spectrogram whose blocks hold TDF (time-distributed fully-connected) layers
mixing the frequency axis. The public functions keep the JAX package's NHWC
layout [B, T, F, C]; inside, activations are NCHW [B, C, T, F] so the
frequency axis is last for the TDF matmuls and cuDNN gets its native layout.

What carries the flax semantics over (each checked against flax 0.12.3 by
``tests/test_torch_convtdf.py``):

* a stride-2 3x3 ``"SAME"`` conv pads (total // 2, total - total // 2) with
  total = max((ceil(n / 2) - 1) * 2 + 3 - n, 0): (0, 1) for even n. The
  port pads explicitly and convolves with padding 0;
* ``ConvTranspose(3x3, stride 2, "SAME")`` dilates the input by 2, pads
  (2, 1) and cross-correlates with the stored kernel, unflipped. That equals
  ``conv_transpose2d`` with the spatially flipped kernel, stride 2, no
  padding, cropped to twice the input;
* conv kernels are stored (kh, kw, in, out) and dense kernels (in, out);
* ``GroupNorm(4)``: eps 1e-6, statistics in float32 whatever the input type;
* ``nn.gelu`` is the tanh form;
* activations run in the net's dtype (bfloat16 in production) and the mask
  head in float32. cuDNN would run a float32 conv in TF32 by default, so the
  head's 3x3 conv is one float32 matmul over the channels and nine shifted
  adds (``_head_conv_f32``). cuBLAS runs that matmul in full float32 under
  torch's default matmul precision (``"highest"``); the port changes no
  global setting of torch.
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from audio_cut_tpu_torch.config import get_config

PACKAGED_CHECKPOINT = "convtdf_large_v1.msgpack"
PACKAGED_TINY_CHECKPOINT = "convtdf_tiny_v1.msgpack"
# the JAX package's checkpoint files, read by path (data, not an import)
WEIGHTS_DIR = Path(__file__).resolve().parents[2] / "audio_cut_tpu" / "models" / "weights"

_GN_EPS = 1e-6
_GN_GROUPS = 4


def _head_conv_f32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """3x3 conv with padding 1 in float32, NCHW: one matmul of the nine taps
    over the channels, then the nine shifted tap planes summed. Equal to
    ``F.conv2d(x, weight, bias, padding=1)`` in exact float32 arithmetic."""
    b, c, t, f = x.shape
    o = weight.shape[0]
    taps = weight.permute(2, 3, 0, 1).reshape(9 * o, c)  # rows (kh, kw, out)
    z = torch.matmul(taps, x.reshape(b, c, t * f)).reshape(b, 3, 3, o, t, f)
    z = F.pad(z, (1, 1, 1, 1))
    out = bias.view(1, o, 1, 1).expand(b, o, t, f)
    for i in range(3):
        for j in range(3):
            out = out + z[:, i, j, :, i:i + t, j:j + f]
    return out


def _same_pad(n: int, stride: int, k: int = 3) -> Tuple[int, int]:
    """flax/lax ``"SAME"`` padding (lo, hi) along one axis."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class GroupNorm(nn.Module):
    """flax ``GroupNorm(4)``: statistics in float32, output in the input's dtype."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), _GN_GROUPS, self.weight, self.bias, eps=_GN_EPS)
        return y.to(x.dtype)


class TDF(nn.Module):
    """Time-distributed frequency MLP: dense bottleneck across the F axis."""

    def __init__(self, freq: int, bottleneck: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(freq, bottleneck)
        self.fc2 = nn.Linear(bottleneck, freq)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T, F]
        w1, b1 = self.fc1.weight.to(x.dtype), self.fc1.bias.to(x.dtype)
        w2, b2 = self.fc2.weight.to(x.dtype), self.fc2.bias.to(x.dtype)
        y = F.gelu(F.linear(x, w1, b1), approximate="tanh")
        return F.linear(y, w2, b2)


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, channels: int, freq: int, tdf_bottleneck: Optional[int]) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, channels, 3)
        self.norm1 = GroupNorm(channels)
        self.tdf = TDF(freq, tdf_bottleneck) if tdf_bottleneck else None
        self.conv2 = nn.Conv2d(channels, channels, 3)
        self.norm2 = GroupNorm(channels)

    @staticmethod
    def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.gelu(self.norm1(self._conv(self.conv1, x)), approximate="tanh")
        if self.tdf is not None:
            y = y + self.tdf(y)
        return F.gelu(self.norm2(self._conv(self.conv2, y)), approximate="tanh")


class ConvTDFNet(nn.Module):
    """U-Net over [B, T, F, 2] (real/imag) predicting a complex ratio mask.

    Parameters are float32; activations run in ``dtype`` and the mask head in
    float32. ``dim_f`` fixes the TDF widths (the frequency axis at each
    level); the time axis is free.
    """

    def __init__(self, dim_f: int, channels: int = 24, depth: int = 3,
                 tdf_bottleneck: int = 64, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.depth = depth
        self.dtype = dtype
        freqs = [dim_f]
        for _ in range(depth):
            freqs.append(-(-freqs[-1] // 2))
        ch = channels
        self.first = ConvBlock(2, ch, freqs[0], tdf_bottleneck)
        self.down = nn.ModuleList()
        self.enc = nn.ModuleList()
        for level in range(1, depth + 1):
            self.down.append(nn.Conv2d(ch, ch * 2, 3))
            ch *= 2
            self.enc.append(ConvBlock(ch, ch, freqs[level], tdf_bottleneck))
        self.bottleneck = ConvBlock(ch, ch, freqs[depth], tdf_bottleneck)
        self.up = nn.ModuleList()
        self.dec = nn.ModuleList()
        for level in range(depth - 1, -1, -1):
            # stored as conv_transpose2d weights [in, out, kh, kw], flipped
            self.up.append(nn.ConvTranspose2d(ch, ch // 2, 3))
            ch //= 2
            self.dec.append(ConvBlock(ch * 2, ch, freqs[level], tdf_bottleneck))
        self.head = nn.Conv2d(ch, 2, 3)

    def forward(self, spec_ri: torch.Tensor) -> torch.Tensor:
        """[B, T, F, 2] float32 -> mask [B, T, F, 2] float32."""
        x = spec_ri.permute(0, 3, 1, 2).to(self.dtype)
        skips: List[torch.Tensor] = []
        x = self.first(x)
        for down, block in zip(self.down, self.enc):
            skips.append(x)
            pt, pf = _same_pad(x.shape[2], 2), _same_pad(x.shape[3], 2)
            x = F.pad(x, (pf[0], pf[1], pt[0], pt[1]))
            x = F.conv2d(x, down.weight.to(x.dtype), down.bias.to(x.dtype), stride=2)
            x = block(x)
        x = self.bottleneck(x)
        for up, block in zip(self.up, self.dec):
            t, f = x.shape[2], x.shape[3]
            x = F.conv_transpose2d(x, up.weight.to(x.dtype), up.bias.to(x.dtype), stride=2)
            skip = skips.pop()
            x = x[:, :, :min(2 * t, skip.shape[2]), :min(2 * f, skip.shape[3])]
            x = torch.cat([x, skip], dim=1)
            x = block(x)
        mask = _head_conv_f32(x.float().contiguous(), self.head.weight, self.head.bias)
        return mask.permute(0, 2, 3, 1).contiguous()

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Initialise in place as flax's ``init`` does: every conv, transposed
        conv and dense kernel ``lecun_normal``, biases 0, GroupNorm scale 1
        and bias 0. The draws come from ``generator`` (a CPU generator) in
        module order, so the result is the same on any device; they are not
        flax's draws for any key."""
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = module.weight
                if isinstance(module, nn.Linear):
                    fan_in = w.shape[1]                     # flax (in, out)
                elif isinstance(module, nn.ConvTranspose2d):
                    fan_in = w.shape[0] * w.shape[2] * w.shape[3]  # stored (in, out, kh, kw)
                else:
                    fan_in = w.shape[1] * w.shape[2] * w.shape[3]  # (out, in, kh, kw)
                w.copy_(_lecun_normal(tuple(w.shape), fan_in, generator))
                module.bias.zero_()
            elif isinstance(module, GroupNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()


# flax's truncated normal at +-2 sigma: the stddev that gives the truncated
# draw a variance of 1 / fan_in (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def _lecun_normal(shape: Tuple[int, ...], fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """``jax.nn.initializers.lecun_normal``: a normal cut at +-2 sigma, by the
    inverse CDF of a uniform draw as ``jax.random.truncated_normal`` does it,
    scaled to stddev ``sqrt(1 / fan_in) / 0.8796...``. float32, on the CPU."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=generator, dtype=torch.float32) * (hi - lo) + lo
    z = math.sqrt(2.0) * torch.erfinv(u)
    z = z.clamp(math.nextafter(-2.0, 0.0), math.nextafter(2.0, 0.0))
    return z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)


def _conv_weight(kernel: np.ndarray) -> torch.Tensor:
    """flax conv kernel (kh, kw, in, out) -> torch conv2d weight (out, in, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1))))


def _conv_transpose_weight(kernel: np.ndarray) -> torch.Tensor:
    """flax ConvTranspose kernel (kh, kw, in, out), applied unflipped to the
    dilated input -> torch conv_transpose2d weight (in, out, kh, kw), flipped."""
    w = np.transpose(kernel, (2, 3, 0, 1))[:, :, ::-1, ::-1]
    return torch.from_numpy(np.ascontiguousarray(w))


def _vec(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def convert_convtdf_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ConvTDFNet params (nested dict of numpy arrays) -> ``ConvTDFNet``
    state_dict. Every leaf of ``tree`` lands in exactly one entry; an
    unexpected leaf raises."""
    depth = sum(1 for k in tree if k.startswith("ConvTranspose_"))
    out: Dict[str, torch.Tensor] = {}
    used = set()

    def block(flax_name: str, prefix: str) -> None:
        p = tree[flax_name]
        for i, conv in ((0, "conv1"), (1, "conv2")):
            out[f"{prefix}.{conv}.weight"] = _conv_weight(p[f"Conv_{i}"]["kernel"])
            out[f"{prefix}.{conv}.bias"] = _vec(p[f"Conv_{i}"]["bias"])
            out[f"{prefix}.norm{i + 1}.weight"] = _vec(p[f"GroupNorm_{i}"]["scale"])
            out[f"{prefix}.norm{i + 1}.bias"] = _vec(p[f"GroupNorm_{i}"]["bias"])
        if "TDF_0" in p:
            for i, fc in ((0, "fc1"), (1, "fc2")):
                dense = p["TDF_0"][f"Dense_{i}"]
                out[f"{prefix}.tdf.{fc}.weight"] = torch.from_numpy(
                    np.ascontiguousarray(np.asarray(dense["kernel"], np.float32).T))
                out[f"{prefix}.tdf.{fc}.bias"] = _vec(dense["bias"])
        extra = set(p) - {"Conv_0", "Conv_1", "GroupNorm_0", "GroupNorm_1", "TDF_0"}
        if extra:
            raise ValueError(f"{flax_name}: unexpected parameters {sorted(extra)}")
        used.add(flax_name)

    block("ConvBlock_0", "first")
    for i in range(depth):
        block(f"ConvBlock_{i + 1}", f"enc.{i}")
        out[f"down.{i}.weight"] = _conv_weight(tree[f"Conv_{i}"]["kernel"])
        out[f"down.{i}.bias"] = _vec(tree[f"Conv_{i}"]["bias"])
        used.add(f"Conv_{i}")
    block(f"ConvBlock_{depth + 1}", "bottleneck")
    for i in range(depth):
        block(f"ConvBlock_{depth + 2 + i}", f"dec.{i}")
        out[f"up.{i}.weight"] = _conv_transpose_weight(tree[f"ConvTranspose_{i}"]["kernel"])
        out[f"up.{i}.bias"] = _vec(tree[f"ConvTranspose_{i}"]["bias"])
        used.add(f"ConvTranspose_{i}")
    out["head.weight"] = _conv_weight(tree[f"Conv_{depth}"]["kernel"])
    out["head.bias"] = _vec(tree[f"Conv_{depth}"]["bias"])
    used.add(f"Conv_{depth}")
    extra = set(tree) - used
    if extra:
        raise ValueError(f"unexpected top-level parameters {sorted(extra)}")
    return out


def _flax_conv_kernel(weight: torch.Tensor) -> np.ndarray:
    """Inverse of ``_conv_weight``: (out, in, kh, kw) -> (kh, kw, in, out)."""
    return np.ascontiguousarray(np.transpose(_np32(weight), (2, 3, 1, 0)))


def _flax_conv_transpose_kernel(weight: torch.Tensor) -> np.ndarray:
    """Inverse of ``_conv_transpose_weight``: flipped (in, out, kh, kw) ->
    flax's unflipped (kh, kw, in, out)."""
    w = _np32(weight)[:, :, ::-1, ::-1]
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1)))


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def to_flax_params(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``convert_convtdf_params``: a ``ConvTDFNet`` state_dict (or a
    dict of its gradients under the same names) -> the flax parameter tree as
    float32 numpy, keys sorted as ``jax.device_get`` leaves them. Every entry
    of ``state`` lands in exactly one leaf; an unexpected entry raises."""
    depth = sum(1 for k in state if k.startswith("down.") and k.endswith(".weight"))
    tree: Dict[str, Any] = {}
    used = set()

    def take(name: str) -> torch.Tensor:
        used.add(name)
        return state[name]

    def block(prefix: str) -> Dict[str, Any]:
        p: Dict[str, Any] = {}
        for i, conv in ((0, "conv1"), (1, "conv2")):
            p[f"Conv_{i}"] = {"bias": _np32(take(f"{prefix}.{conv}.bias")),
                              "kernel": _flax_conv_kernel(take(f"{prefix}.{conv}.weight"))}
            p[f"GroupNorm_{i}"] = {"bias": _np32(take(f"{prefix}.norm{i + 1}.bias")),
                                   "scale": _np32(take(f"{prefix}.norm{i + 1}.weight"))}
        if f"{prefix}.tdf.fc1.weight" in state:
            p["TDF_0"] = {
                f"Dense_{i}": {"bias": _np32(take(f"{prefix}.tdf.{fc}.bias")),
                               "kernel": np.ascontiguousarray(
                                   _np32(take(f"{prefix}.tdf.{fc}.weight")).T)}
                for i, fc in ((0, "fc1"), (1, "fc2"))}
        return p

    tree["ConvBlock_0"] = block("first")
    for i in range(depth):
        tree[f"ConvBlock_{i + 1}"] = block(f"enc.{i}")
        tree[f"Conv_{i}"] = {"bias": _np32(take(f"down.{i}.bias")),
                             "kernel": _flax_conv_kernel(take(f"down.{i}.weight"))}
    tree[f"ConvBlock_{depth + 1}"] = block("bottleneck")
    for i in range(depth):
        tree[f"ConvBlock_{depth + 2 + i}"] = block(f"dec.{i}")
        tree[f"ConvTranspose_{i}"] = {
            "bias": _np32(take(f"up.{i}.bias")),
            "kernel": _flax_conv_transpose_kernel(take(f"up.{i}.weight"))}
    tree[f"Conv_{depth}"] = {"bias": _np32(take("head.bias")),
                             "kernel": _flax_conv_kernel(take("head.weight"))}
    extra = set(state) - used
    if extra:
        raise ValueError(f"unexpected state_dict entries {sorted(extra)}")
    return _sorted_tree(tree)


def _sorted_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def apply_complex_mask(spec: torch.Tensor, mask_ri: torch.Tensor) -> torch.Tensor:
    """Complex ratio mask: (mr + i*mi) * spec."""
    return torch.complex(mask_ri[..., 0], mask_ri[..., 1]) * spec


class ConvTDFSeparator(nn.Module):
    """Waveform window -> (vocal, instrumental).

    Static geometry: n_fft, hop, dim_f (cropped bins), dim_t (frames/window).
    """

    def __init__(self, sample_rate: int, n_fft: int = 6144, hop: int = 1024,
                 dim_f: int = 2048, dim_t: int = 256, channels: int = 24, depth: int = 3,
                 tdf_bottleneck: int = 64, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.sr = sample_rate
        self.n_fft = n_fft
        self.hop = hop
        self.dim_f = dim_f
        self.dim_t = dim_t
        self.window_samples = (dim_t - 1) * hop
        self.net = ConvTDFNet(dim_f, channels=channels, depth=depth,
                              tdf_bottleneck=tdf_bottleneck, dtype=dtype)

    def analyze(self, audio: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """waveform [B, S] -> (full complex spec [B, T, Fall], cropped RI [B, T, F, 2])."""
        from audio_cut_tpu_torch.ops.stft import stft

        spec = stft(audio, n_fft=self.n_fft, hop=self.hop, center=True)
        spec = spec[..., :self.dim_t, :]
        crop = spec[..., :self.dim_f]
        ri = torch.stack([crop.real, crop.imag], dim=-1).to(torch.float32)
        return spec, ri

    def synthesize(self, spec_full: torch.Tensor, mask_ri: torch.Tensor, length: int) -> torch.Tensor:
        from audio_cut_tpu_torch.ops.stft import istft

        masked = apply_complex_mask(spec_full[..., :self.dim_f], mask_ri)
        rest = torch.zeros_like(spec_full[..., self.dim_f:])
        full = torch.cat([masked, rest], dim=-1)
        return istft(full, n_fft=self.n_fft, hop=self.hop, length=length)

    def init_params(self, generator: torch.Generator) -> None:
        """flax-style initialisation of the net in place (``ConvTDFNet.init_params``)."""
        self.net.init_params(generator)

    def separate_fn(self, audio: torch.Tensor, length: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, S] windows -> (vocal, instrumental = window - vocal), each
        [B, length]; differentiable in the net's parameters."""
        spec, ri = self.analyze(audio)
        mask = self.net(ri)
        vocal = self.synthesize(spec, mask, length)
        return vocal, audio[..., :length] - vocal

    @torch.inference_mode()
    def separate(self, audio: torch.Tensor, length: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``separate_fn`` under ``inference_mode``: the serving path."""
        return self.separate_fn(audio, length)

    @torch.inference_mode()
    def separate_shifted(self, audio: torch.Tensor, length: int,
                         shifts: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``separate`` with the vocal shift-averaged over ``shifts`` sub-hop
        offsets in one batched forward (``tiling.shift_averaged``); the
        instrumental stays the exact complement ``audio - vocal``. The
        counterpart of the JAX package's ``separate_shifted_fn``."""
        from audio_cut_tpu_torch.separation.tiling import shift_averaged

        if int(shifts) <= 1:
            return self.separate_fn(audio, length)
        fwd = shift_averaged(lambda x: self.separate_fn(x, length)[0], self.hop, shifts)
        vocal = fwd(audio)
        return vocal, audio[..., :length] - vocal


def packaged_checkpoint_path() -> Optional[str]:
    """Path of the packaged large checkpoint, if this build ships one."""
    path = WEIGHTS_DIR / PACKAGED_CHECKPOINT
    return str(path) if path.exists() else None


def packaged_tiny_checkpoint_path() -> Optional[str]:
    """Tiny CPU-tier checkpoint (checkpoint='packaged_tiny'), if shipped."""
    path = WEIGHTS_DIR / PACKAGED_TINY_CHECKPOINT
    return str(path) if path.exists() else None


def _packaged_geometry(ckpt_path: str) -> Dict[str, Any]:
    """Geometry sidecar (<ckpt>.json) written next to a msgpack checkpoint."""
    sidecar = str(ckpt_path) + ".json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            return json.load(f)
    return {}


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A flax ``.msgpack`` ConvTDF checkpoint -> ``ConvTDFNet`` state_dict."""
    from audio_cut_tpu_torch.models.flax_msgpack import read_flax_msgpack

    if not str(path).endswith(".msgpack"):
        raise NotImplementedError(
            f"checkpoint {path}: the PyTorch port reads flax .msgpack checkpoints "
            "only (orbax directories: ROADMAP.md, queue 1)")
    return convert_convtdf_params(read_flax_msgpack(path))


class ConvTDFBackend:
    """Engine-facing backend: batched model windows -> (vocal, instrumental)."""

    name = "convtdf"

    def __init__(self, sample_rate: int, device: torch.device,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        cfg = get_config("enhanced_separation.convtdf", {}) or {}
        self.sample_rate = int(sample_rate)
        self.device = torch.device(device)
        ckpt = cfg.get("checkpoint")
        geometry = {
            "n_fft": int(cfg.get("n_fft", 6144)),
            "hop": int(cfg.get("hop", 1024)),
            "dim_f": int(cfg.get("dim_f", 2048)),
            "dim_t": int(cfg.get("dim_t", 256)),
            "channels": int(cfg.get("channels", 24)),
            "depth": int(cfg.get("num_blocks", 9)) // 3,
            "tdf_bottleneck": int(cfg.get("tdf_bottleneck", 64)),
        }
        if ckpt in ("packaged", "packaged_tiny"):
            resolved = (packaged_tiny_checkpoint_path() if ckpt == "packaged_tiny"
                        else packaged_checkpoint_path())
            if resolved is None:
                raise RuntimeError(
                    f"enhanced_separation.convtdf.checkpoint={ckpt} but no such "
                    f"checkpoint is in {WEIGHTS_DIR}")
            ckpt = resolved
        if not ckpt:
            # the JAX package runs random weights here when its fallback is
            # off; the port never separates with an untrained net
            raise RuntimeError(
                "convtdf backend selected but enhanced_separation.convtdf.checkpoint "
                "is unset: no trained weights")
        # the sidecar pins the geometry the checkpoint was trained with
        meta = _packaged_geometry(ckpt)
        for key in ("n_fft", "hop", "dim_f", "dim_t", "channels", "depth", "tdf_bottleneck"):
            if key in meta:
                geometry[key] = int(meta[key])
        self.sep = ConvTDFSeparator(sample_rate, dtype=dtype, **geometry)
        self.sep.net.load_state_dict(load_checkpoint(ckpt), strict=True)
        self.sep.to(self.device).eval()
        # test-time shift averaging: each window runs at ``shifts`` sub-hop
        # offsets in one forward, so a forward takes map_group // shifts
        # windows and its activations stay bounded at about map_group rows
        self.shifts = max(1, int(cfg.get("shifts", 1)))
        self.map_group = max(1, int(cfg.get("map_group", 4)) // self.shifts)

    def engine_geometry(self) -> Dict[str, float]:
        """Native chunk schedule: engine windows are model windows."""
        from audio_cut_tpu_torch.separation.tiling import stft_engine_geometry

        return stft_engine_geometry(
            self.sample_rate, self.sep.window_samples, self.sep.n_fft, self.sep.hop)

    def separate_windows(self, windows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[N, W] model windows -> 2x [N, W], ``map_group`` windows (times
        ``shifts`` rows) per forward."""
        from audio_cut_tpu_torch.separation.tiling import mapped_forward

        length = int(windows.shape[-1])
        if length != self.sep.window_samples:
            raise NotImplementedError(
                f"engine window {length} != the model's {self.sep.window_samples}: "
                "re-tiling (tiled_forward_batch) is not in the PyTorch port yet: "
                "ROADMAP.md, queue 1, 'other separator tiers (waveunet, onnx)'")
        return mapped_forward(lambda batch: self.sep.separate_shifted(batch, length, self.shifts),
                              windows, self.map_group)
