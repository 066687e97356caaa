"""Cases and inputs that the card tests (``tests/test_torch_cuda.py``), the
CPU tests and ``chip_smoke.py`` share, so that they hold a kernel at the same
edges in the same way; and the MDX-Net graph builder (``ConvTDFNetTrim``,
``build_graph``, ``make_net``) that the ONNX tests and ``chip_smoke.py``
serve."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from audio_cut_tpu_torch.ops.ola import WindowPlan, windowed_ola_backward_reference
from audio_cut_tpu_torch.ops.stft import frame_signal

# K1's shapes, (what, batch, n_frames, frame_len, hop): every shape a path
# launches it at. The ConvTDF serving path (n_fft 6144, hop 1024) in pieces
# of 2 windows and its last piece of 1 (the default piece upload), in pieces
# of 3 (a YAML config's, and the whole-track path's last group) and of 4 (the
# whole-track path); under shift averaging a forward holds windows x shifts
# rows (shifts 2: pieces of 2 give 4 rows, the last piece 2; shifts 3: one
# window a forward, 3 rows); the batch's groups of 4 windows and its last
# group of 2; the ONNX tier's forwards, whose mono windows go through the
# STFT as stereo, 2 rows a window (a piece of 2 windows: 4 rows, the last
# piece 2); a piece of the spectral backend (n_fft 2048, hop 512); the
# training forward of ConvTDF-large at batch 4.
K1_SHAPES = [
    ("a piece of 2 windows; shifts 2: the last piece; the batch's last group; "
     "ONNX: the last piece", 2, 256, 6144, 1024),
    ("the last piece, 1 window", 1, 256, 6144, 1024),
    ("pieces of 3; shifts 3: a window", 3, 256, 6144, 1024),
    ("the whole-track path's groups of 4; shifts 2: a piece; the batch's groups; "
     "ONNX: a piece", 4, 256, 6144, 1024),
    ("a spectral piece", 2, 865, 2048, 512),
    ("the training forward", 4, 128, 6144, 1024),
]
# the terms whose loads a K1 thread issues together (csrc/ola.cu:kMaxRatio)
K1_MAX_RATIO = 6
# K1's edges: (what, batch, n_frames, frame_len, hop, offset of the frames
# from a 16 B boundary in floats). The first two take the scalar form.
K1_EDGE_SHAPES = [
    ("scalar path: 4 B off 16 B alignment", 2, 256, 6144, 1024, 1),
    ("scalar path: hop not a multiple of 4", 2, 9, 18, 6, 0),
    ("r = 1: hop equals L", 2, 9, 512, 512, 0),
    ("r above kMaxRatio", 2, 21, 2048, 128, 0),
    ("a single frame", 2, 1, 2048, 512, 0),
    ("fewer frames than r", 2, 3, 6144, 1024, 0),
]


def k1_edge_holds(edge: str, batch: int, n: int, frame_len: int, hop: int, offset: int) -> bool:
    """Whether the case ``edge`` of ``K1_EDGE_SHAPES`` is that edge."""
    r = frame_len // hop
    return {"scalar path: 4 B off 16 B alignment": offset % 4 != 0,
            "scalar path: hop not a multiple of 4": hop % 4 != 0,
            "r = 1: hop equals L": r == 1,
            "r above kMaxRatio": r > K1_MAX_RATIO,
            "a single frame": n == 1,
            "fewer frames than r": 1 < n < r}[edge]


# K1W's edges: (what, batch, n_frames, frame_len, hop, offset of the inputs
# from a 16 B boundary in floats). The last two are the scalar path: a hop
# that is no multiple of 4, and the training shape [4, 128, 6144] hop 1024
# on a view 4 B off alignment.
K1W_EDGE_SHAPES = [
    ("one frame", 1, 1, 6144, 1024, 0),
    ("fewer rows than the cluster", 1, 5, 512, 128, 0),
    ("rows the cluster does not divide", 3, 7, 6144, 1024, 0),
    ("L not a multiple of the tile", 2, 9, 1000, 250, 0),
    ("scalar path: hop not a multiple of 4", 2, 7, 90, 30, 0),
    ("scalar path: 4 B off 16 B alignment", 4, 128, 6144, 1024, 1),
]


def k1w_edge_holds(edge: str, batch: int, n: int, frame_len: int, hop: int, offset: int,
                   plan: WindowPlan) -> bool:
    """Whether the case ``edge`` of ``K1W_EDGE_SHAPES`` is that edge under ``plan``."""
    rows = batch * n
    return {"one frame": rows == 1,
            "fewer rows than the cluster": rows < plan.cluster,
            "rows the cluster does not divide": rows % plan.cluster != 0,
            "L not a multiple of the tile": frame_len % plan.tile_cols != 0,
            "scalar path: hop not a multiple of 4": hop % 4 != 0,
            "scalar path: 4 B off 16 B alignment": offset % 4 != 0}[edge]


def _normal(shape: Tuple[int, ...], rng: np.random.Generator, device,
            offset: int) -> torch.Tensor:
    """Standard normal of ``shape`` from ``rng``, on ``device``, as a view
    starting ``offset`` floats into its storage."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    buf = torch.empty(x.numel() + offset, device=device)
    buf[offset:] = x.reshape(-1)
    return buf[offset:].view(shape)


def k1_inputs(shape: Tuple[int, ...], seed: int, device, offset: int = 0) -> torch.Tensor:
    """K1's frames of ``shape``, standard normal from ``seed``, starting
    ``offset`` floats into their storage."""
    return _normal(shape, np.random.default_rng(seed), device, offset)


def k1w_inputs(shape: Tuple[int, ...], hop: int, seed: int, device,
               offset: int = 0) -> List[torch.Tensor]:
    """frames of ``shape`` and their cotangent g, standard normal from ``seed``,
    each starting ``offset`` floats into its storage."""
    n, frame_len = shape[-2], shape[-1]
    rng = np.random.default_rng(seed)
    return [_normal(x_shape, rng, device, offset)
            for x_shape in (shape, shape[:-2] + ((n - 1) * hop + frame_len,))]


def k1w_error(got: torch.Tensor, g: torch.Tensor, frames: torch.Tensor,
              hop: int) -> Tuple[float, float]:
    """max |got - plain| of a window's gradient over its columns, and the
    largest share of a column's sum |g * frames| that it reaches. Raises if
    ``got`` has another shape than the plain backward's."""
    n, frame_len = frames.shape[-2], frames.shape[-1]
    _, want = windowed_ola_backward_reference(g, frames, None, hop, frames_shape=frames.shape,
                                              want_frames=False)
    if got.shape != want.shape:
        raise ValueError(f"K1W gave shape {tuple(got.shape)}, the plain backward "
                         f"{tuple(want.shape)}")
    raw = frame_signal(g, frame_len, hop, center=False)[..., :n, :]
    scale = (raw * frames).abs().sum(dim=tuple(range(raw.ndim - 1)))
    err = (got - want).abs()
    return float(err.max()), float((err / scale.clamp_min(1e-30)).max())


def _onset64(mag: np.ndarray) -> np.ndarray:
    """K2's onset of a magnitude spectrogram [T, F] (the plain version's
    formula), in float64."""
    logmag = np.log1p(1000.0 * np.asarray(mag, np.float64))
    flux = np.diff(logmag, axis=-2, prepend=logmag[..., :1, :])
    return np.clip(flux, 0.0, None).mean(axis=-1)


def onset_allowed(mag_a: np.ndarray, mag_b: np.ndarray) -> np.ndarray:
    """Per frame, how far the onsets (K2's: the mean over bins of
    clamp(diff over frames of log1p(1000 |X|), 0)) of two magnitude
    spectrograms [T, F] of one signal differ: the onset of each, in
    float64, and their difference. Two libraries' FFTs of one signal round
    differently, and log1p(1000 |X|) magnifies that up to 1000-fold in
    near-silent bins; this follows the spectrograms' own difference instead
    of a fixed tolerance, and leaves to the caller only the rounding of the
    onset itself (K2's against its plain version)."""
    return np.abs(_onset64(mag_a) - _onset64(mag_b))


# -- the MDX-Net (kuielab Conv_TDF_net_trim) graph builder ----------------------
#
# The architecture of MDX23's Kim_Vocal_1.onnx, the separator the reference
# serves, rebuilt in torch and written as an ONNX graph with the lowerings of
# the published exports (the port's copy of scripts/make_mdxnet_fixture.py):
# a growth-g channel ladder (first 1x1 conv 4 -> g; down: Conv2d(c, c + g, 2,
# stride 2); up: ConvTranspose2d(c, c - g, 2, stride 2); final 1x1 conv c ->
# 4), the layout transposes [B, C, F, T] <-> [B, C, T, F] around the body,
# TFC-TDF blocks (l x (Conv2d k pad k // 2, GroupNorm(2, c), ReLU), then a
# dense bottleneck over the frequency axis, joined by an additive skip),
# multiplicative U-skips, GroupNorm lowered as Reshape -> InstanceNormalization
# -> Reshape -> Mul -> Add (opset < 18) and BatchNorm2d as BatchNormalization.

# the published geometry and width of Kim_Vocal_1 (dim_f 3072 = n_fft / 2,
# dim_t 256, L 11: five scale stages)
KIM_VOCAL_1 = dict(dim_f=3072, dim_t=256, L=11, k=3, g=48, l=3, bn=8)
# the committed fixture's mini geometry (tests/fixtures/onnx/mdxnet_trim_mini.onnx)
MDX_MINI = dict(dim_f=128, dim_t=32, L=11, k=3, g=4, l=2, bn=4)


class TFCTDF(nn.Module):
    """kuielab Conv_TDF block: l conv layers + dense bottleneck, additive skip."""

    def __init__(self, c: int, l: int, f: int, k: int, bn: int) -> None:
        super().__init__()
        self.H = nn.ModuleList([
            nn.Sequential(nn.Conv2d(c, c, k, 1, k // 2), nn.GroupNorm(2, c), nn.ReLU())
            for _ in range(l)
        ])
        hidden = max(1, f // bn)
        self.tdf = nn.Sequential(
            nn.Linear(f, hidden), nn.GroupNorm(2, c), nn.ReLU(),
            nn.Linear(hidden, f), nn.GroupNorm(2, c), nn.ReLU(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T, F]
        for h in self.H:
            x = h(x)
        return x + self.tdf(x)


class ConvTDFNetTrim(nn.Module):
    """kuielab Conv_TDF_net_trim: the Kim_Vocal_1 architecture family."""

    def __init__(self, dim_f: int, dim_t: int, L: int, k: int, g: int, l: int, bn: int) -> None:
        super().__init__()
        self.n = L // 2
        self.dim_f, self.dim_t = dim_f, dim_t
        self.first_conv = nn.Sequential(nn.Conv2d(4, g, 1, 1), nn.BatchNorm2d(g), nn.ReLU())
        f, c = dim_f, g
        self.ds_dense, self.ds = nn.ModuleList(), nn.ModuleList()
        for _ in range(self.n):
            self.ds_dense.append(TFCTDF(c, l, f, k, bn))
            self.ds.append(nn.Sequential(
                nn.Conv2d(c, c + g, (2, 2), (2, 2)), nn.BatchNorm2d(c + g), nn.ReLU()))
            f //= 2
            c += g
        self.mid_dense = TFCTDF(c, l, f, k, bn)
        self.us_dense, self.us = nn.ModuleList(), nn.ModuleList()
        for _ in range(self.n):
            self.us.append(nn.Sequential(
                nn.ConvTranspose2d(c, c - g, (2, 2), (2, 2)), nn.BatchNorm2d(c - g), nn.ReLU()))
            f *= 2
            c -= g
            self.us_dense.append(TFCTDF(c, l, f, k, bn))
        self.final_conv = nn.Sequential(nn.Conv2d(c, 4, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, 4, F, T]
        x = self.first_conv(x)
        x = x.transpose(-1, -2)  # [B, g, T, F]
        skips = []
        for i in range(self.n):
            x = self.ds_dense[i](x)
            skips.append(x)
            x = self.ds[i](x)
        x = self.mid_dense(x)
        for i in range(self.n):
            x = self.us[i](x)
            x = x * skips[-i - 1]  # multiplicative U-skip
            x = self.us_dense[i](x)
        x = x.transpose(-1, -2)  # back to [B, c, F, T]
        return self.final_conv(x)  # the stem's spectrogram (no mask)


class _GraphBuilder:
    def __init__(self, sd: Dict[str, np.ndarray]) -> None:
        from audio_cut_tpu_torch.onnx.proto import Node

        self.Node = Node
        self.sd = sd
        self.nodes: list = []
        self.init: Dict[str, np.ndarray] = {}
        self._n = 0

    def add(self, op: str, inputs, attrs=None, hint=None) -> str:
        self._n += 1
        out = f"{hint or op.lower()}_{self._n}"
        self.nodes.append(self.Node(op, list(inputs), [out], out, attrs or {}))
        return out

    def const(self, name: str, arr) -> str:
        self.init[name] = np.asarray(arr)
        return name

    def conv(self, x: str, prefix: str, strides, pads, kshape) -> str:
        for p in ("weight", "bias"):
            self.init[f"{prefix}.{p}"] = self.sd[f"{prefix}.{p}"]
        return self.add("Conv", [x, f"{prefix}.weight", f"{prefix}.bias"],
                        {"strides": strides, "pads": pads, "kernel_shape": kshape}, "conv")

    def bn(self, x: str, prefix: str) -> str:
        for a, b in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                     ("var", "running_var")):
            self.init[f"{prefix}.{a}"] = self.sd[f"{prefix}.{b}"]
        return self.add("BatchNormalization",
                        [x] + [f"{prefix}.{a}" for a in ("scale", "bias", "mean", "var")],
                        {"epsilon": 1e-5}, "bn")

    def gn(self, x: str, prefix: str, c: int, t: int, f: int) -> str:
        """nn.GroupNorm(2, c) on [B, c, t, f] as an opset < 18 export writes it."""
        g = 2
        shp_in = self.const(f"{prefix}.shape_in", np.asarray([0, g, -1], np.int64))
        shp_out = self.const(f"{prefix}.shape_out", np.asarray([0, c, t, f], np.int64))
        unit_s = self.const(f"{prefix}.unit_scale", np.ones(g, np.float32))
        unit_b = self.const(f"{prefix}.unit_bias", np.zeros(g, np.float32))
        self.init[f"{prefix}.weight"] = self.sd[f"{prefix}.weight"].reshape(1, c, 1, 1).copy()
        self.init[f"{prefix}.bias"] = self.sd[f"{prefix}.bias"].reshape(1, c, 1, 1).copy()
        y = self.add("Reshape", [x, shp_in], hint="gn_rs")
        y = self.add("InstanceNormalization", [y, unit_s, unit_b], {"epsilon": 1e-5}, "gn_in")
        y = self.add("Reshape", [y, shp_out], hint="gn_rs")
        y = self.add("Mul", [y, f"{prefix}.weight"], hint="gn_mul")
        return self.add("Add", [y, f"{prefix}.bias"], hint="gn_add")

    def linear(self, x: str, prefix: str) -> str:
        self.init[f"{prefix}.wT"] = self.sd[f"{prefix}.weight"].T.copy()
        self.init[f"{prefix}.bias"] = self.sd[f"{prefix}.bias"]
        y = self.add("MatMul", [x, f"{prefix}.wT"], hint="mm")
        return self.add("Add", [y, f"{prefix}.bias"], hint="lin_add")

    def tfctdf(self, x: str, prefix: str, c: int, l: int, t: int, f: int, k: int,
               bn: int) -> str:
        y = x
        for i in range(l):
            y = self.conv(y, f"{prefix}.H.{i}.0", [1, 1], [k // 2] * 4, [k, k])
            y = self.gn(y, f"{prefix}.H.{i}.1", c, t, f)
            y = self.add("Relu", [y])
        h = max(1, f // bn)
        z = self.linear(y, f"{prefix}.tdf.0")
        z = self.gn(z, f"{prefix}.tdf.1", c, t, h)
        z = self.add("Relu", [z])
        z = self.linear(z, f"{prefix}.tdf.3")
        z = self.gn(z, f"{prefix}.tdf.4", c, t, f)
        z = self.add("Relu", [z])
        return self.add("Add", [y, z], hint="tdf_skip")


def build_graph(model: ConvTDFNetTrim, g: int, l: int, k: int, bn: int):
    """``model`` as an ONNX ``Graph`` (input [None, 4, dim_f, dim_t], opset 17)."""
    from audio_cut_tpu_torch.onnx.proto import Graph

    b = _GraphBuilder({key: v.detach().cpu().numpy() for key, v in model.state_dict().items()})
    n, dim_f, dim_t = model.n, model.dim_f, model.dim_t
    y = b.conv("input", "first_conv.0", [1, 1], [0, 0, 0, 0], [1, 1])
    y = b.bn(y, "first_conv.1")
    y = b.add("Relu", [y])
    y = b.add("Transpose", [y], {"perm": [0, 1, 3, 2]}, "tr_in")
    f, c, t = dim_f, g, dim_t
    skips = []
    for i in range(n):
        y = b.tfctdf(y, f"ds_dense.{i}", c, l, t, f, k, bn)
        skips.append(y)
        y = b.conv(y, f"ds.{i}.0", [2, 2], [0, 0, 0, 0], [2, 2])
        y = b.bn(y, f"ds.{i}.1")
        y = b.add("Relu", [y])
        f, t, c = f // 2, t // 2, c + g
    y = b.tfctdf(y, "mid_dense", c, l, t, f, k, bn)
    for i in range(n):
        for p in ("weight", "bias"):
            b.init[f"us.{i}.0.{p}"] = b.sd[f"us.{i}.0.{p}"]
        y = b.add("ConvTranspose", [y, f"us.{i}.0.weight", f"us.{i}.0.bias"],
                  {"strides": [2, 2], "kernel_shape": [2, 2]}, "up")
        y = b.bn(y, f"us.{i}.1")
        y = b.add("Relu", [y])
        f, t, c = f * 2, t * 2, c - g
        y = b.add("Mul", [y, skips[-i - 1]], hint="uskip_mul")
        y = b.tfctdf(y, f"us_dense.{i}", c, l, t, f, k, bn)
    y = b.add("Transpose", [y], {"perm": [0, 1, 3, 2]}, "tr_out")
    for p in ("weight", "bias"):
        b.init[f"final_conv.0.{p}"] = b.sd[f"final_conv.0.{p}"]
    b.nodes.append(b.Node("Conv", [y, "final_conv.0.weight", "final_conv.0.bias"], ["output"],
                          "final", {"strides": [1, 1], "pads": [0, 0, 0, 0],
                                    "kernel_shape": [1, 1]}))
    return Graph(nodes=b.nodes, initializers=b.init, inputs=["input"], outputs=["output"],
                 input_shapes={"input": [None, 4, dim_f, dim_t]}, name="conv_tdf_net_trim",
                 opset=17, producer="audio_cut_tpu_fixture")


def make_net(dim_f: int, dim_t: int, L: int, k: int, g: int, l: int, bn: int,
             generator: torch.Generator) -> ConvTDFNetTrim:
    """A ``ConvTDFNetTrim`` in eval mode with every parameter and statistic
    drawn from ``generator``: conv and linear weights and biases uniform in
    +-1/sqrt(fan_in) (torch's default bound), BatchNorm running means
    N(0, 0.1^2) and variances U(0.75, 1.25), GroupNorm scales U(0.75, 1.25)
    and shifts N(0, 0.1^2), as the fixture script draws them. The process's
    global generator is left as it was."""
    with torch.random.fork_rng(devices=[]):
        net = ConvTDFNetTrim(dim_f, dim_t, L, k, g, l, bn)

    def uniform(t: torch.Tensor, lo: float, hi: float) -> None:
        t.copy_(torch.rand(t.shape, generator=generator) * (hi - lo) + lo)

    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                # ConvTranspose2d's weight is [C_in, C_out, k, k]: its fan-in is dim 1
                fan_in = m.weight[0].numel() if not isinstance(m, nn.ConvTranspose2d) \
                    else m.weight[:, 0].numel()
                bound = 1.0 / fan_in ** 0.5
                uniform(m.weight, -bound, bound)
                uniform(m.bias, -bound, bound)
            elif isinstance(m, nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=generator) * 0.1)
                uniform(m.running_var, 0.75, 1.25)
            elif isinstance(m, nn.GroupNorm):
                uniform(m.weight, 0.75, 1.25)
                m.bias.copy_(torch.randn(m.bias.shape, generator=generator) * 0.1)
    return net.eval()
