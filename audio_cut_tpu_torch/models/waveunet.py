"""WaveUNet: the waveform-domain separator tier, in PyTorch.

Counterpart of ``audio_cut_tpu/models/waveunet.py``: a 1-D conv U-Net over
the waveform (stride 4 per level, GLU gating after each encoder and decoder
conv, a dilated-conv context bottleneck), a different architecture family
from the ConvTDF mask net. Activations run in NCW layout [B, C, T] so cuDNN
gets its native 1-D layout; the net holds float32 parameters and casts them
to its ``dtype`` (bfloat16 in production) inside ``forward``.

What carries the flax semantics over (each checked against flax by
``tests/test_torch_waveunet.py``):

* ``Conv(kernel 8, stride 4, "SAME")`` pads (total // 2, total - total // 2)
  with total = max((ceil(n / 4) - 1) * 4 + 8 - n, 0): (2, 2) on a length
  divisible by 4. The dilated 3-tap convs pad ``dilation`` on each side;
* ``ConvTranspose(kernel 8, stride 4, "SAME")`` is ``lax.conv_transpose``
  with ``transpose_kernel=False``: the input dilated by 4, padded (5, 5) and
  cross-correlated with the stored kernel, unflipped. That equals
  ``conv_transpose1d`` with the kernel flipped along its taps, stride 4 and
  padding 2, giving 4n samples;
* kernels are stored (k, in, out); flax names its compact submodules by
  creation order per type: ``Conv_0 .. Conv_{2d-1}`` the encoder (strided,
  then the 1x1 GLU conv, per level), ``Conv_{2d} .. Conv_{2d+5}`` the
  bottleneck (two per dilation 1, 2, 4), ``Conv_{2d+6} ..`` the decoder's
  1x1 GLU convs and ``ConvTranspose_0 ..`` its upsampling convs;
* ``nn.gelu`` is the tanh form;
* each conv casts its parameters and input to the net's dtype and the net
  returns float32; ``jnp.std`` has ddof 0, taken in float32 before the cast.

No WaveUNet checkpoint is packaged (nor in the JAX package): the tier is
usable with the weights ``train_separator --family waveunet`` writes.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from audio_cut_tpu_torch.config import get_config
from audio_cut_tpu_torch.models.convtdf import WEIGHTS_DIR, _lecun_normal, _np32, _sorted_tree

NATIVE_WINDOW = 1 << 18  # 262144 samples = 5.94 s at 44.1 kHz; 4^4 divides it
DILATIONS = (1, 2, 4)

PACKAGED_CHECKPOINT = "waveunet_bootstrap_v1.msgpack"


def _same_pad(n: int, stride: int, k: int) -> Tuple[int, int]:
    """flax/lax ``"SAME"`` padding (lo, hi) of a strided conv along one axis."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _transpose_same_padding(k: int, stride: int) -> int:
    """The ``conv_transpose1d`` padding equal to ``lax.conv_transpose``'s
    ``"SAME"`` pads (a, b) on the dilated input, which torch can only take
    when a == b: torch pads k - 1 - padding on each side."""
    pad_len = k + stride - 2
    a = k - 1 if stride > k - 1 else -(-pad_len // 2)
    if pad_len - a != a:
        raise ValueError(f"ConvTranspose SAME at kernel {k}, stride {stride} pads "
                         f"({a}, {pad_len - a}): not a conv_transpose1d padding")
    return k - 1 - a


def conv_in_dtype(op, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  **kw) -> torch.Tensor:
    """``op`` (``F.conv1d`` or ``F.conv_transpose1d``) with the float32
    parameters cast to ``x``'s dtype, as flax casts each conv's parameters.
    cuDNN sums a bfloat16 conv's products in float32 and rounds once; torch's
    CPU kernels keep less of the sums, so on a CPU tensor a bfloat16 conv runs
    in float32 and rounds its output once. Every conv of the net goes through
    here."""
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        return op(x.float(), weight.float(), bias.float(), **kw).to(x.dtype)
    return op(x, weight.to(x.dtype), bias.to(x.dtype), **kw)


def same_conv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                stride: int) -> torch.Tensor:
    """flax ``Conv(padding="SAME", strides=stride)`` in NCW with a torch
    ``Conv1d`` weight (out, in, k), in ``x``'s dtype."""
    lo, hi = _same_pad(x.shape[-1], stride, weight.shape[-1])
    if lo != hi:
        x = F.pad(x, (lo, hi))
        lo = 0
    return conv_in_dtype(F.conv1d, x, weight, bias, stride=stride, padding=lo)


def same_conv_transpose1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                          stride: int) -> torch.Tensor:
    """flax ``ConvTranspose(padding="SAME", strides=stride)`` in NCW with a
    torch ``ConvTranspose1d`` weight (in, out, k), the taps flipped: ``stride``
    x the input length, in ``x``'s dtype."""
    return conv_in_dtype(F.conv_transpose1d, x, weight, bias, stride=stride,
                         padding=_transpose_same_padding(weight.shape[-1], stride))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def input_scale(audio: torch.Tensor) -> torch.Tensor:
    """The per-row scale of ``separate_fn``: ``jnp.std`` (ddof 0) over the
    last axis, plus 1e-6."""
    return torch.std(audio, dim=-1, keepdim=True, correction=0) + 1e-6


def _glu(x: torch.Tensor) -> torch.Tensor:
    a, b = torch.chunk(x, 2, dim=1)
    return a * torch.sigmoid(b)


class WaveUNetNet(nn.Module):
    """[B, 1, T] waveform -> [B, 1, T] vocal estimate (float32), T divisible
    by ``stride ** depth``."""

    def __init__(self, channels: int = 24, depth: int = 4, stride: int = 4, kernel: int = 8,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        _transpose_same_padding(kernel, stride)  # raises on a geometry torch cannot pad
        self.channels, self.depth, self.stride, self.kernel = channels, depth, stride, kernel
        self.dtype = dtype
        self.down = nn.ModuleList()
        self.down_glu = nn.ModuleList()
        ch, c_in = channels, 1
        for _ in range(depth):
            self.down.append(nn.Conv1d(c_in, ch, kernel))
            self.down_glu.append(nn.Conv1d(ch, 2 * ch, 1))
            c_in = ch
            ch *= 2
        width = ch // 2
        self.dilated = nn.ModuleList(nn.Conv1d(width, width, 3, dilation=d) for d in DILATIONS)
        self.context = nn.ModuleList(nn.Conv1d(width, width, 1) for _ in DILATIONS)
        self.up_glu = nn.ModuleList()
        self.up = nn.ModuleList()
        for level in range(depth):
            ch //= 2
            self.up_glu.append(nn.Conv1d(ch, 2 * ch, 1))
            # stored as conv_transpose1d weights [in, out, k], flipped
            self.up.append(nn.ConvTranspose1d(ch, max(ch // 2, channels) if level < depth - 1 else 1,
                                              kernel))

    @staticmethod
    def _conv(conv: nn.Conv1d, x: torch.Tensor, **kw) -> torch.Tensor:
        return conv_in_dtype(F.conv1d, x, conv.weight, conv.bias, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype)
        skips: List[torch.Tensor] = []
        for down, glu in zip(self.down, self.down_glu):
            y = gelu(same_conv1d(y, down.weight, down.bias, self.stride))
            y = _glu(self._conv(glu, y))
            skips.append(y)
        for d, dilated, context in zip(DILATIONS, self.dilated, self.context):
            r = gelu(self._conv(dilated, y, padding=d, dilation=d))
            y = y + self._conv(context, r)
        for glu, up in zip(self.up_glu, self.up):
            skip = skips.pop()
            y = y[..., :skip.shape[-1]] + skip
            y = _glu(self._conv(glu, y))
            y = same_conv_transpose1d(y, up.weight, up.bias, self.stride)
            if skips:
                y = gelu(y)
        return y.float()

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Initialise in place as flax's ``init`` does: every kernel
        ``lecun_normal`` (fan_in = taps x input channels), biases 0. The
        draws come from ``generator`` (a CPU generator) in module order, so
        the result is the same on any device; they are not flax's draws for
        any key."""
        for module in self.modules():
            if isinstance(module, (nn.Conv1d, nn.ConvTranspose1d)):
                w = module.weight
                # Conv1d (out, in, k); ConvTranspose1d (in, out, k)
                fan_in = w.shape[0 if isinstance(module, nn.ConvTranspose1d) else 1] * w.shape[2]
                w.copy_(_lecun_normal(tuple(w.shape), fan_in, generator))
                module.bias.zero_()


def _flax_names(depth: int) -> List[Tuple[str, str, bool]]:
    """(flax submodule, ``WaveUNetNet`` module, transposed?) in flax's
    creation order."""
    names = []
    for i in range(depth):
        names += [(f"Conv_{2 * i}", f"down.{i}", False), (f"Conv_{2 * i + 1}", f"down_glu.{i}", False)]
    for j in range(len(DILATIONS)):
        names += [(f"Conv_{2 * depth + 2 * j}", f"dilated.{j}", False),
                  (f"Conv_{2 * depth + 2 * j + 1}", f"context.{j}", False)]
    for i in range(depth):
        names += [(f"Conv_{2 * depth + 6 + i}", f"up_glu.{i}", False),
                  (f"ConvTranspose_{i}", f"up.{i}", True)]
    return names


def convert_waveunet_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax WaveUNetNet params (nested dict of numpy arrays) -> ``WaveUNetNet``
    state_dict. Every leaf of ``tree`` lands in exactly one entry; an
    unexpected leaf raises."""
    depth = sum(1 for k in tree if k.startswith("ConvTranspose_"))
    out: Dict[str, torch.Tensor] = {}
    names = _flax_names(depth)
    for flax_name, prefix, transposed in names:
        p = tree[flax_name]
        if set(p) != {"kernel", "bias"}:
            raise ValueError(f"{flax_name}: unexpected parameters {sorted(p)}")
        k = np.asarray(p["kernel"], np.float32)
        # (k, in, out) -> Conv1d (out, in, k), or ConvTranspose1d (in, out, k) flipped
        w = np.transpose(k, (1, 2, 0))[:, :, ::-1] if transposed else np.transpose(k, (2, 1, 0))
        out[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        out[f"{prefix}.bias"] = torch.from_numpy(np.array(p["bias"], dtype=np.float32))
    extra = set(tree) - {n for n, _, _ in names}
    if extra:
        raise ValueError(f"unexpected top-level parameters {sorted(extra)}")
    return out


def to_flax_params(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``convert_waveunet_params``: a ``WaveUNetNet`` state_dict
    (or a dict of its gradients under the same names) -> the flax parameter
    tree as float32 numpy, keys sorted as ``jax.device_get`` leaves them.
    Every entry of ``state`` lands in exactly one leaf; an unexpected entry
    raises."""
    depth = sum(1 for k in state if k.startswith("up.") and k.endswith(".weight"))
    tree: Dict[str, Any] = {}
    used = set()
    for flax_name, prefix, transposed in _flax_names(depth):
        w = _np32(state[f"{prefix}.weight"])
        k = np.transpose(w[:, :, ::-1], (2, 0, 1)) if transposed else np.transpose(w, (2, 1, 0))
        tree[flax_name] = {"bias": _np32(state[f"{prefix}.bias"]), "kernel": np.ascontiguousarray(k)}
        used |= {f"{prefix}.weight", f"{prefix}.bias"}
    extra = set(state) - used
    if extra:
        raise ValueError(f"unexpected state_dict entries {sorted(extra)}")
    return _sorted_tree(tree)


class WaveUNetSeparator(nn.Module):
    """Waveform window batch -> (vocal, instrumental)."""

    def __init__(self, sample_rate: int, window_samples: int = NATIVE_WINDOW, channels: int = 24,
                 depth: int = 4, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.sr = int(sample_rate)
        self.window_samples = int(window_samples)
        if self.window_samples % (4 ** depth):
            raise ValueError(f"window_samples {window_samples}: 4 ** depth ({4 ** depth}) must divide it")
        self.net = WaveUNetNet(channels=channels, depth=depth, dtype=dtype)

    def init_params(self, generator: torch.Generator) -> None:
        """flax-style initialisation of the net in place (``WaveUNetNet.init_params``)."""
        self.net.init_params(generator)

    def separate_fn(self, audio: torch.Tensor, length: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, S] -> (vocal [B, length], inst [B, length]); differentiable in
        the net's parameters. Demucs-style per-sample std normalisation: the
        net sees unit-scale input and the estimate is rescaled back."""
        std = input_scale(audio)
        y = self.net((audio / std).unsqueeze(-2)).squeeze(-2)
        vocal = (y * std)[..., :length]
        return vocal, audio[..., :length] - vocal

    @torch.inference_mode()
    def separate(self, audio: torch.Tensor, length: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``separate_fn`` under ``inference_mode``: the serving path."""
        return self.separate_fn(audio, length)


def packaged_checkpoint_path() -> Optional[str]:
    """Path of the packaged WaveUNet checkpoint, if this build ships one
    (none does: the JAX package stopped shipping it)."""
    path = WEIGHTS_DIR / PACKAGED_CHECKPOINT
    return str(path) if path.exists() else None


def _packaged_geometry(ckpt_path: str) -> Dict[str, Any]:
    """Geometry sidecar (<ckpt>.json) written next to a msgpack checkpoint."""
    sidecar = str(ckpt_path) + ".json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            return json.load(f)
    return {}


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A flax ``.msgpack`` WaveUNet checkpoint -> ``WaveUNetNet`` state_dict."""
    from audio_cut_tpu_torch.models.flax_msgpack import read_flax_msgpack

    if not str(path).endswith(".msgpack"):
        raise NotImplementedError(
            f"checkpoint {path}: the PyTorch port reads flax .msgpack checkpoints "
            "only (orbax directories: ROADMAP.md, queue 1, "
            "'other separator tiers (waveunet, onnx)')")
    return convert_waveunet_params(read_flax_msgpack(path))


class WaveUNetBackend:
    """Engine-facing backend (the same seam as ``ConvTDFBackend``)."""

    name = "waveunet"

    def __init__(self, sample_rate: int, device: torch.device) -> None:
        cfg = get_config("enhanced_separation.waveunet", {}) or {}
        self.sample_rate = int(sample_rate)
        self.device = torch.device(device)
        geometry = {
            "window_samples": int(cfg.get("window_samples", NATIVE_WINDOW)),
            "channels": int(cfg.get("channels", 24)),
            "depth": int(cfg.get("depth", 4)),
        }
        ckpt = cfg.get("checkpoint")
        if ckpt == "packaged":
            ckpt = packaged_checkpoint_path()
            if ckpt is None:
                raise RuntimeError(
                    "enhanced_separation.waveunet.checkpoint=packaged but no packaged "
                    f"checkpoint ships in this build (models/weights/{PACKAGED_CHECKPOINT})")
        if not ckpt:
            # the JAX package runs random weights here when its fallback is
            # off; the port never separates with an untrained net
            raise RuntimeError(
                "waveunet backend selected but enhanced_separation.waveunet.checkpoint "
                "is unset: no trained weights")
        # the sidecar pins the net the checkpoint was trained with
        meta = _packaged_geometry(str(ckpt))
        for key in ("channels", "depth"):
            if key in meta:
                geometry[key] = int(meta[key])
        self.sep = WaveUNetSeparator(sample_rate, dtype=torch.bfloat16, **geometry)
        self.sep.net.load_state_dict(load_checkpoint(str(ckpt)), strict=True)
        self.sep.to(self.device).eval()
        self.map_group = max(1, int(cfg.get("map_group", 4)))

    def engine_geometry(self) -> Dict[str, float]:
        """Native schedule: engine windows are model windows; overlap first,
        then halo = overlap / 4, so overlap > 2 * halo with a positive
        cross-fade ramp for any window; align 4096 (no STFT frame grid in the
        waveform domain)."""
        sr = float(self.sample_rate)
        target = self.sep.window_samples
        overlap = max(4096, min(16384, (target // 4) // 4096 * 4096))
        halo = overlap // 4
        return {"chunk_s": target / sr, "overlap_s": overlap / sr, "halo_s": halo / sr,
                "align": 4096}

    def separate_windows(self, windows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[N, W] model windows -> 2x [N, W], ``map_group`` windows a forward."""
        from audio_cut_tpu_torch.separation.tiling import mapped_forward

        length = int(windows.shape[-1])
        if length != self.sep.window_samples:
            raise NotImplementedError(
                f"engine window {length} != the model's {self.sep.window_samples}: "
                "re-tiling (tiled_forward_batch) is not in the PyTorch port yet: "
                "ROADMAP.md, queue 1, 'other separator tiers (waveunet, onnx)'")
        return mapped_forward(lambda batch: self.sep.separate(batch, length), windows,
                              self.map_group)

    def separate(self, audio: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """A whole track through the port's engine on this backend's device
        -> (vocal, instrumental) as float32 numpy."""
        from audio_cut_tpu_torch.separation.engine import SeparationEngine

        eng = SeparationEngine(self.sample_rate, self.device, backend=self)
        v_dev, i_dev, _mix, _meta = eng.separate_on_device(np.asarray(audio, np.float32))
        both = torch.stack([v_dev, i_dev]).cpu().numpy()
        return both[0], both[1]
