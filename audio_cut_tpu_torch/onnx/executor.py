"""ONNX graph -> PyTorch module, run op by op.

Counterpart of ``audio_cut_tpu/onnx/executor.py``. There the graph is traced
once into one XLA program; here ``OnnxGraphModule`` walks the same nodes
eagerly on the weights' device, with the same op table and the same
numerics (float32, as the JAX package runs without x64):

* float initializers are buffers (float64 ones become float32), so
  ``.to(device)`` moves the weights once and they stay there across calls;
* integer and bool initializers, graph inputs given as numpy arrays and every
  ``Shape``/``Size`` result stay numpy on the host. A node whose inputs are
  all host values runs in numpy (the JAX package's ``_xp`` rule), so
  Reshape/Slice/Pad/Expand chains resolve on the host and a forward reads
  nothing back from the device;
* every value is dropped after its last reader, as XLA frees a buffer.

Where torch's call differs from the ONNX op, the module computes the ONNX
op: asymmetric or ``auto_pad`` Conv pads go through ``F.pad`` before a conv
with padding 0; ConvTranspose's weight [C_in, C_out/group, k...] is torch's
own layout, and its asymmetric pads crop the unpadded result; a negative
Slice step flips; Gather takes negative indices; Resize computes
``jax.image.resize``'s weights (half-pixel centres, antialiasing when it
shrinks, Keys' cubic with a = -0.5) instead of ``F.interpolate``'s.

Unsupported ops raise ``UnsupportedOnnxOp`` naming the op, at run time and
in ``validate_graph``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from audio_cut_tpu_torch.onnx.proto import _DTYPE_TO_NP, Graph, Node


class UnsupportedOnnxOp(NotImplementedError):
    pass


def _is_static(*vals: Any) -> bool:
    return all(isinstance(v, (np.ndarray, np.generic, int, float, bool)) or v is None
               for v in vals)


def _ints(v: Any) -> List[int]:
    if v is None:
        return []
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return [int(x) for x in np.asarray(v).reshape(-1)]


def _pair_pads(pads: Sequence[int], ndim: int) -> List[Tuple[int, int]]:
    """ONNX pads [x1_b, x2_b, ..., x1_e, x2_e] -> [(b, e), ...] per spatial dim."""
    if not pads:
        return [(0, 0)] * ndim
    half = len(pads) // 2
    return [(int(pads[i]), int(pads[i + half])) for i in range(half)]


def _flat_pads(pairs: Sequence[Tuple[int, int]]) -> List[int]:
    """[(b, e)] per dim, first dim first -> ``F.pad``'s list, last dim first."""
    out: List[int] = []
    for lo, hi in reversed(pairs):
        out += [lo, hi]
    return out


_TORCH_DTYPE = {np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16,
                np.dtype(np.float64): torch.float32,  # no float64 on the device, as without x64
                np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32,
                np.dtype(np.int16): torch.int16, np.dtype(np.int8): torch.int8,
                np.dtype(np.uint8): torch.uint8, np.dtype(np.bool_): torch.bool}


def _on(v: Any, device: torch.device) -> torch.Tensor:
    """A device value for ``v``: a tensor as it is; a host value as a tensor,
    float64 as float32. A 0-d host value stays a CPU scalar tensor, which
    torch's elementwise ops take beside a CUDA tensor without a copy."""
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(_TORCH_DTYPE[a.dtype])
    return t if t.ndim == 0 else t.to(device)


def _scalar(v: Any):
    """A 0-d host value as a Python number, anything else as it is."""
    if _is_static(v) and np.asarray(v).ndim == 0:
        return np.asarray(v).item()
    return v


# -- conv family ----------------------------------------------------------------


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _weights(vals, device):
    """A conv's input, weight and optional bias as device values."""
    b = vals[2] if len(vals) > 2 and vals[2] is not None else None
    return _on(vals[0], device), _on(vals[1], device), None if b is None else _on(b, device)


def _conv(node, vals, device):
    x, w, b = _weights(vals, device)
    spatial = w.ndim - 2
    strides = _ints(node.attrs.get("strides")) or [1] * spatial
    dilations = _ints(node.attrs.get("dilations")) or [1] * spatial
    group = int(node.attrs.get("group", 1))
    pads = _pair_pads(_ints(node.attrs.get("pads")), spatial)
    auto_pad = node.attrs.get("auto_pad", "NOTSET")
    if auto_pad not in ("NOTSET", "", None):
        if auto_pad == "VALID":
            pads = [(0, 0)] * spatial
        else:  # SAME_UPPER / SAME_LOWER
            pads = []
            for i in range(spatial):
                out = -(-x.shape[2 + i] // strides[i])
                need = max(0, (out - 1) * strides[i]
                           + (w.shape[2 + i] - 1) * dilations[i] + 1 - x.shape[2 + i])
                lo = need // 2
                if auto_pad == "SAME_LOWER":
                    lo = need - need // 2
                pads.append((lo, need - lo))
    if all(lo == hi for lo, hi in pads):
        padding = [lo for lo, _ in pads]
    else:  # torch pads both sides alike: pad first, then a conv with padding 0
        x, padding = F.pad(x, _flat_pads(pads)), [0] * spatial
    return [_CONV[spatial](x, w, b, stride=strides, padding=padding, dilation=dilations,
                           groups=group)]


def _conv_transpose(node, vals, device):
    x, w, b = _weights(vals, device)
    spatial = w.ndim - 2
    strides = _ints(node.attrs.get("strides")) or [1] * spatial
    dilations = _ints(node.attrs.get("dilations")) or [1] * spatial
    group = int(node.attrs.get("group", 1))
    pads = _pair_pads(_ints(node.attrs.get("pads")), spatial)
    out_pad = _ints(node.attrs.get("output_padding")) or [0] * spatial
    if _ints(node.attrs.get("output_shape")):
        raise UnsupportedOnnxOp("ConvTranspose with explicit output_shape")
    # ONNX's weight [C_in, C_out/group, *k] is conv_transpose's own layout
    fn = _CONV_T[spatial]
    if (all(lo == hi for lo, hi in pads)
            and all(p < max(s, d) for p, s, d in zip(out_pad, strides, dilations))):
        return [fn(x, w, b, stride=strides, padding=[lo for lo, _ in pads],
                   output_padding=out_pad, groups=group, dilation=dilations)]
    # asymmetric pads: the unpadded result, cropped (a negative F.pad), with
    # output_padding's zeros at the end, then the bias
    y = fn(x, w, None, stride=strides, padding=0, groups=group, dilation=dilations)
    y = F.pad(y, _flat_pads([(-lo, op - hi) for (lo, hi), op in zip(pads, out_pad)]))
    if b is not None:
        y = y + b.reshape((1, -1) + (1,) * spatial)
    return [y]


def _pool(x, node: Node, kind: str):
    kshape = _ints(node.attrs["kernel_shape"])
    spatial = len(kshape)
    strides = _ints(node.attrs.get("strides")) or [1] * spatial
    pads = _flat_pads(_pair_pads(_ints(node.attrs.get("pads")), spatial))
    if kind == "max":
        pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[spatial]
        return pool(F.pad(x, pads, value=-float("inf")), kshape, strides)
    # average over the cells inside the input (count_include_pad=0): the mean
    # with zeros, over the mean of ones
    pool = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}[spatial]
    s = pool(F.pad(x, pads), kshape, strides)
    c = pool(F.pad(torch.ones_like(x), pads), kshape, strides)
    return s / c


# -- elementwise / structural helpers ----------------------------------------------


def _axes_of(node: Node, vals, default=None):
    if len(vals) > 1 and vals[1] is not None:
        return _ints(vals[1])
    a = node.attrs.get("axes")
    return _ints(a) if a is not None else default


def _reduce(op: str):
    def run(node, vals, device):
        x = vals[0]
        axes = _axes_of(node, vals)
        keep = bool(node.attrs.get("keepdims", 1))
        if not axes and node.attrs.get("noop_with_empty_axes", 0) and len(vals) > 1:
            return [x]
        axes = None if not axes else [a % x.ndim for a in axes]
        if _is_static(x):
            return [getattr(np, op)(x, axis=None if axes is None else tuple(axes), keepdims=keep)]
        dims = list(range(x.ndim)) if axes is None else axes
        if op == "mean" and not x.is_floating_point():
            x = x.to(torch.float32)
        if op == "prod":
            for d in sorted(dims, reverse=True):
                x = torch.prod(x, dim=d, keepdim=keep)
            return [x]
        fn = {"mean": torch.mean, "sum": torch.sum, "max": torch.amax, "min": torch.amin}[op]
        return [fn(x, dim=dims, keepdim=keep)]

    return run


def _slice(node, vals, device):
    x = vals[0]
    if len(vals) > 1:  # opset >= 10: inputs
        starts, ends = _ints(vals[1]), _ints(vals[2])
        axes = _ints(vals[3]) if len(vals) > 3 and vals[3] is not None else list(range(len(starts)))
        steps = _ints(vals[4]) if len(vals) > 4 and vals[4] is not None else [1] * len(starts)
    else:
        starts = _ints(node.attrs["starts"])
        ends = _ints(node.attrs["ends"])
        axes = _ints(node.attrs.get("axes")) or list(range(len(starts)))
        steps = [1] * len(starts)
    sl = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        sl[ax % x.ndim] = slice(st if st > -(2**31) else None,
                                en if abs(en) < 2**31 else None, sp)
    if _is_static(x):
        return [x[tuple(sl)]]
    for ax, s in enumerate(sl):
        if s.step is None or s.step > 0:
            continue
        # torch slices only forward: the span the step walks, flipped
        idx = range(*s.indices(x.shape[ax]))
        if len(idx) == 0:
            x, sl[ax] = x.narrow(ax, 0, 0), slice(None)
            continue
        lo, hi = idx[-1], idx[0]
        x = x.narrow(ax, lo, hi - lo + 1).flip(ax)
        sl[ax] = slice(None, None, -s.step)
    return [x[tuple(sl)]]


def _gather(node, vals, device):
    x, idx = vals
    axis = int(node.attrs.get("axis", 0))
    if _is_static(x, idx):
        return [np.take(x, np.asarray(idx), axis=axis)]
    x = _on(x, device)
    axis = axis % x.ndim
    n = x.shape[axis]
    if _is_static(idx):
        idx = np.asarray(idx)
        flat = _on(np.where(idx < 0, idx + n, idx).reshape(-1).astype(np.int64), x.device)
    else:
        flat = torch.where(idx < 0, idx + n, idx).reshape(-1).to(torch.int64)
    y = x.index_select(axis, flat)
    return [y.reshape(x.shape[:axis] + tuple(np.asarray(idx).shape if _is_static(idx)
                                             else idx.shape) + x.shape[axis + 1:])]


def _pad_along(x: torch.Tensor, ax: int, lo: int, hi: int, mode: str) -> torch.Tensor:
    """numpy's "edge" or "reflect" padding of one axis by slices: reflection
    by at most n - 1 samples at a time, so wide pads mirror periodically."""
    n = x.shape[ax]
    if mode == "edge" or n == 1:
        parts = [x.narrow(ax, 0, 1).expand(*x.shape[:ax], lo, *x.shape[ax + 1:]), x,
                 x.narrow(ax, n - 1, 1).expand(*x.shape[:ax], hi, *x.shape[ax + 1:])]
        return torch.cat(parts, dim=ax)
    while lo > 0:
        k = min(lo, n - 1)
        x = torch.cat([x.narrow(ax, 1, k).flip(ax), x], dim=ax)
        lo -= k
    while hi > 0:
        k = min(hi, n - 1)
        m = x.shape[ax]
        x = torch.cat([x, x.narrow(ax, m - 1 - k, k).flip(ax)], dim=ax)
        hi -= k
    return x


def _pad(node, vals, device):
    x = vals[0]
    mode = node.attrs.get("mode", "constant")
    if len(vals) > 1 and vals[1] is not None:
        pads = _ints(vals[1])
    else:
        pads = _ints(node.attrs.get("pads"))
    cval = 0.0
    if len(vals) > 2 and vals[2] is not None:
        cval = float(np.asarray(_host(vals[2])).reshape(-1)[0])
    half = len(pads) // 2
    widths = [(pads[i], pads[i + half]) for i in range(half)]
    if _is_static(x):
        if mode == "constant":
            return [np.pad(x, widths, mode="constant", constant_values=cval)]
        return [np.pad(x, widths, mode={"reflect": "reflect", "edge": "edge"}[mode])]
    if mode == "constant":
        return [F.pad(x, _flat_pads(widths), value=cval)]
    mode = {"reflect": "reflect", "edge": "edge"}[mode]
    for ax, (lo, hi) in enumerate(widths):
        if lo or hi:
            x = _pad_along(x, ax, lo, hi, mode)
    return [x]


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else v


# -- Resize: jax.image.resize's algorithm ------------------------------------------


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x
                   + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x)).astype(np.float32)


def _resize_weights(m: int, n: int, kernel: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    """The [m, n] weights ``jax.image.resize`` contracts an axis of m samples
    with to give n (scale n / m, no translation, antialiased), in float32."""
    scale = n / m
    inv_scale = 1.0 / scale
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = ((np.arange(n, dtype=np.float32) + np.float32(0.5)) * np.float32(inv_scale)
                - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=np.float32)[:, None]) / kernel_scale
    weights = kernel(x.astype(np.float32))
    total = np.sum(weights, axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return np.where(inside[None, :], weights, np.float32(0.0)).astype(np.float32)


def _resize(node, vals, device):
    x = _on(vals[0], device)
    mode = node.attrs.get("mode", "nearest")
    sizes = None
    if len(vals) > 3 and vals[3] is not None and np.asarray(_host(vals[3])).size:
        sizes = _ints(vals[3])
    elif len(vals) > 2 and vals[2] is not None and np.asarray(_host(vals[2])).size:
        scales = np.asarray(_host(vals[2]), dtype=np.float64).reshape(-1)
        sizes = [int(round(s * d)) for s, d in zip(scales, x.shape)]
    if sizes is None:
        raise UnsupportedOnnxOp("Resize without scales/sizes")
    kernel = {"nearest": None, "linear": _triangle, "cubic": _keys_cubic}[mode]
    if not x.is_floating_point() and kernel is not None:
        x = x.to(torch.float32)
    for d, (m, n) in enumerate(zip(x.shape, sizes)):
        if m == n:
            continue
        if kernel is None:
            idx = np.floor(((np.arange(n, dtype=np.float32) + np.float32(0.5)) * np.float32(m)
                            / np.float32(n)).astype(np.float32)).astype(np.int64)
            x = x.index_select(d, _on(idx, x.device))
        else:
            w = _on(_resize_weights(m, n, kernel), x.device).to(x.dtype)
            x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return [x]


# -- the op table ----------------------------------------------------------------------
#
# Each entry takes (node, vals, device) and returns the node's outputs. Ops
# that the JAX package computes with jax.numpy whatever its inputs (Conv, the
# norms, Sigmoid, Softmax, ...) run on the device here too; the others run in
# numpy when every input is a host value.


def _binary(np_fn: str, torch_fn: Callable):
    def run(node, vals, device):
        a, b = vals
        if _is_static(a, b):
            if np_fn == "divide" and np.asarray(a).dtype.kind in "iu":
                return [np.floor_divide(a, b)]
            return [getattr(np, np_fn)(a, b)]
        return [torch_fn(_on(a, device), _on(b, device))]

    return run


def _unary(np_fn: str, torch_fn: Callable):
    def run(node, vals, device):
        x = vals[0]
        return [getattr(np, np_fn)(x) if _is_static(x) else torch_fn(x)]

    return run


def _device_unary(torch_fn: Callable):
    def run(node, vals, device):
        return [torch_fn(_on(vals[0], device), node)]

    return run


def _batch_norm(node, vals, device):
    x, scale, bias, mean, var = [_on(v, device) for v in vals[:5]]
    eps = float(node.attrs.get("epsilon", 1e-5))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = scale.reshape(shape) / torch.sqrt(var.reshape(shape) + eps)
    return [x * inv + (bias.reshape(shape) - mean.reshape(shape) * inv)]


def _instance_norm(node, vals, device):
    x, scale, bias = [_on(v, device) for v in vals[:3]]
    eps = float(node.attrs.get("epsilon", 1e-5))
    axes = tuple(range(2, x.ndim))
    var, mu = torch.var_mean(x, dim=axes, correction=0, keepdim=True)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return [(x - mu) / torch.sqrt(var + eps) * scale.reshape(shape) + bias.reshape(shape)]


def _layer_norm(node, vals, device):
    x, scale = _on(vals[0], device), _on(vals[1], device)
    bias = _on(vals[2], device) if len(vals) > 2 and vals[2] is not None else None
    axis = int(node.attrs.get("axis", -1))
    eps = float(node.attrs.get("epsilon", 1e-5))
    axes = tuple(range(axis % x.ndim, x.ndim))
    var, mu = torch.var_mean(x, dim=axes, correction=0, keepdim=True)
    y = (x - mu) / torch.sqrt(var + eps) * scale
    if bias is not None:
        y = y + bias
    return [y]


def _group_norm(node, vals, device):
    x, scale, bias = [_on(v, device) for v in vals[:3]]
    eps = float(node.attrs.get("epsilon", 1e-5))
    g = int(node.attrs["num_groups"])
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    var, mu = torch.var_mean(xg, dim=tuple(range(2, xg.ndim)), correction=0, keepdim=True)
    y = ((xg - mu) / torch.sqrt(var + eps)).reshape(x.shape)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return [y * scale.reshape(shape) + bias.reshape(shape)]


def _gemm(node, vals, device):
    a, b = vals[0], vals[1]
    c = vals[2] if len(vals) > 2 else None
    alpha = float(node.attrs.get("alpha", 1.0))
    beta = float(node.attrs.get("beta", 1.0))
    if node.attrs.get("transA", 0):
        a = a.T
    if node.attrs.get("transB", 0):
        b = b.T
    if _is_static(a, b):
        y = alpha * np.matmul(a, b)
    else:
        y = alpha * torch.matmul(_on(a, device), _on(b, device))
    if c is not None:
        y = y + beta * (c if _is_static(y, c) else _on(c, device))
    return [y]


def _variadic(np_fn, torch_fn):
    def run(node, vals, device):
        if _is_static(*vals):
            out = vals[0]
            for v in vals[1:]:
                out = np_fn(out, v)
            return [out]
        out = _on(vals[0], device)
        for v in vals[1:]:
            out = torch_fn(out, _on(v, device))
        return [out]

    return run


def _where(node, vals, device):
    if _is_static(*vals):
        return [np.where(vals[0], vals[1], vals[2])]
    c, a, b = _on(vals[0], device), _scalar(vals[1]), _scalar(vals[2])
    return [torch.where(c, a if isinstance(a, (int, float, bool)) else _on(a, device),
                        b if isinstance(b, (int, float, bool)) else _on(b, device))]


def _relu(node, vals, device):
    x = vals[0]
    return [np.maximum(x, 0) if _is_static(x) else torch.relu(x)]


def _leaky_relu(node, vals, device):
    alpha = float(node.attrs.get("alpha", 0.01))
    x = vals[0]
    if _is_static(x):
        return [np.where(x >= 0, x, alpha * x)]
    return [torch.where(x >= 0, x, alpha * x)]


def _prelu(node, vals, device):
    x, slope = vals
    if _is_static(x):
        return [np.where(x >= 0, x, slope * x)]
    return [torch.where(x >= 0, x, _on(slope, device).to(x.dtype) * x)]


def _elu(x, node):
    alpha = float(node.attrs.get("alpha", 1.0))
    return torch.where(x >= 0, x, alpha * (torch.exp(x) - 1.0))


def _softmax(x, node):
    return torch.softmax(x, dim=int(node.attrs.get("axis", -1)))


def _hard_sigmoid(x, node):
    alpha = float(node.attrs.get("alpha", 0.2))
    beta = float(node.attrs.get("beta", 0.5))
    return torch.clamp(alpha * x + beta, 0.0, 1.0)


def _clip(node, vals, device):
    x = vals[0]
    lo = vals[1] if len(vals) > 1 and vals[1] is not None else node.attrs.get("min")
    hi = vals[2] if len(vals) > 2 and vals[2] is not None else node.attrs.get("max")
    if _is_static(x):
        if lo is not None:
            x = np.maximum(x, lo)
        if hi is not None:
            x = np.minimum(x, hi)
        return [x]
    if lo is not None:
        x = torch.maximum(x, _on(lo, device).to(x.dtype))
    if hi is not None:
        x = torch.minimum(x, _on(hi, device).to(x.dtype))
    return [x]


def _shape(node, vals, device):
    shape = np.asarray(tuple(vals[0].shape), dtype=np.int64)
    start = int(node.attrs.get("start", 0))
    end = node.attrs.get("end")
    return [shape[start:int(end)] if end is not None else shape[start:]]


def _size(node, vals, device):
    return [np.asarray(int(np.prod(tuple(vals[0].shape))), dtype=np.int64)]


def _reshape(node, vals, device):
    x, shape = vals[0], _ints(vals[1])
    if not node.attrs.get("allowzero", 0):
        shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return [x.reshape(shape)]


def _transpose(node, vals, device):
    x = vals[0]
    perm = _ints(node.attrs.get("perm")) or list(range(x.ndim))[::-1]
    return [np.transpose(x, perm) if _is_static(x) else x.permute(perm)]


def _squeeze(node, vals, device):
    axes = _axes_of(node, vals)
    x = vals[0]
    if not axes:
        return [x.reshape([d for d in x.shape if d != 1])]
    drop = [a % x.ndim for a in axes]
    return [x.reshape([d for i, d in enumerate(x.shape) if (i % x.ndim) not in drop])]


def _unsqueeze(node, vals, device):
    x = vals[0]
    axes = _axes_of(node, vals)
    for a in sorted(a % (x.ndim + len(axes)) for a in axes):
        x = np.expand_dims(x, a) if _is_static(x) else x.unsqueeze(a)
    return [x]


def _flatten(node, vals, device):
    axis = int(node.attrs.get("axis", 1))
    x = vals[0]
    lead = int(np.prod(tuple(x.shape[:axis]))) if axis else 1
    return [x.reshape(lead, -1)]


def _concat(node, vals, device):
    axis = int(node.attrs["axis"])
    if _is_static(*vals):
        return [np.concatenate(vals, axis=axis)]
    return [torch.cat([_on(v, device) for v in vals], dim=axis)]


def _split(node, vals, device):
    x = vals[0]
    axis = int(node.attrs.get("axis", 0))
    if len(vals) > 1 and vals[1] is not None:
        sizes = _ints(vals[1])
    else:
        sizes = _ints(node.attrs.get("split"))
    n_out = len(node.outputs)
    if not sizes:
        sizes = [x.shape[axis] // n_out] * n_out
    if _is_static(x):
        return list(np.split(x, np.cumsum(sizes)[:-1], axis=axis))
    return list(torch.split(x, sizes, dim=axis))


def _expand(node, vals, device):
    x, shape = vals[0], _ints(vals[1])
    # ONNX Expand uses numpy broadcasting but allows shape dims of 1
    target = list(np.broadcast_shapes(tuple(x.shape), tuple(shape)))
    return [np.broadcast_to(x, target) if _is_static(x) else x.expand(target)]


def _cast(node, vals, device):
    to = _DTYPE_TO_NP[int(node.attrs["to"])]
    x = vals[0]
    if _is_static(x):
        return [np.asarray(x).astype(to)]
    return [x.to(_TORCH_DTYPE[np.dtype(to)])]


def _constant(node, vals, device):
    for key in ("value", "value_float", "value_int", "value_floats", "value_ints"):
        if key in node.attrs:
            return [np.asarray(node.attrs[key])]
    raise UnsupportedOnnxOp("Constant without value")


def _constant_of_shape(node, vals, device):
    shape = _ints(vals[0])
    fill = node.attrs.get("value")
    if fill is None:
        return [np.zeros(shape, dtype=np.float32)]
    fill = np.asarray(fill)
    return [np.full(shape, fill.reshape(-1)[0], dtype=fill.dtype)]


def _range(node, vals, device):
    start, limit, delta = (np.asarray(_host(v)) for v in vals[:3])
    return [np.arange(int(start), int(limit), int(delta), dtype=start.dtype)]


def _argmax(node, vals, device):
    axis = int(node.attrs.get("axis", 0))
    keep = bool(node.attrs.get("keepdims", 1))
    x = vals[0]
    if _is_static(x):
        y = np.argmax(x, axis=axis)
        return [np.expand_dims(y, axis) if keep else y]
    return [torch.argmax(x, dim=axis, keepdim=keep)]


def _global_average_pool(x, node):
    return torch.mean(x, dim=tuple(range(2, x.ndim)), keepdim=True)


def _identity(node, vals, device):
    return [vals[0]] + [None] * (len(node.outputs) - 1)


_OPS: Dict[str, Callable[[Node, List[Any], torch.device], List[Any]]] = {
    "Conv": _conv,
    "ConvTranspose": _conv_transpose,
    "BatchNormalization": _batch_norm,
    "InstanceNormalization": _instance_norm,
    "LayerNormalization": _layer_norm,
    "GroupNormalization": _group_norm,
    "MatMul": _binary("matmul", torch.matmul),
    "Gemm": _gemm,
    "Add": _binary("add", torch.add),
    "Sub": _binary("subtract", torch.sub),
    "Mul": _binary("multiply", torch.mul),
    "Div": _binary("divide", torch.div),
    "Pow": _binary("power", torch.pow),
    "Equal": _binary("equal", torch.eq),
    "Greater": _binary("greater", torch.gt),
    "Less": _binary("less", torch.lt),
    "GreaterOrEqual": _binary("greater_equal", torch.ge),
    "LessOrEqual": _binary("less_equal", torch.le),
    "Max": _variadic(np.maximum, torch.maximum),
    "Min": _variadic(np.minimum, torch.minimum),
    "Where": _where,
    "Relu": _relu,
    "LeakyRelu": _leaky_relu,
    "PRelu": _prelu,
    "Sigmoid": _device_unary(lambda x, node: torch.sigmoid(x)),
    "Tanh": _unary("tanh", torch.tanh),
    "Elu": _device_unary(_elu),
    "Softmax": _device_unary(_softmax),
    "Erf": _device_unary(lambda x, node: torch.erf(x)),
    "Exp": _unary("exp", torch.exp),
    "Log": _unary("log", torch.log),
    "Sqrt": _unary("sqrt", torch.sqrt),
    "Abs": _unary("abs", torch.abs),
    "Floor": _unary("floor", torch.floor),
    "Ceil": _unary("ceil", torch.ceil),
    "Sin": _unary("sin", torch.sin),
    "Cos": _unary("cos", torch.cos),
    "Neg": lambda node, vals, device: [-vals[0]],
    "Reciprocal": lambda node, vals, device: [1.0 / vals[0]],
    "Clip": _clip,
    "HardSigmoid": _device_unary(_hard_sigmoid),
    "Shape": _shape,
    "Size": _size,
    "Reshape": _reshape,
    "Transpose": _transpose,
    "Squeeze": _squeeze,
    "Unsqueeze": _unsqueeze,
    "Flatten": _flatten,
    "Concat": _concat,
    "Split": _split,
    "Slice": _slice,
    "Gather": _gather,
    "Expand": _expand,
    "Cast": _cast,
    "Constant": _constant,
    "ConstantOfShape": _constant_of_shape,
    "Range": _range,
    "Pad": _pad,
    "ReduceMean": _reduce("mean"),
    "ReduceSum": _reduce("sum"),
    "ReduceMax": _reduce("max"),
    "ReduceMin": _reduce("min"),
    "ReduceProd": _reduce("prod"),
    "ArgMax": _argmax,
    "GlobalAveragePool": _device_unary(_global_average_pool),
    "MaxPool": _device_unary(lambda x, node: _pool(x, node, "max")),
    "AveragePool": _device_unary(lambda x, node: _pool(x, node, "avg")),
    "Resize": _resize,
    "Identity": _identity,
    "Dropout": _identity,
}


def _exec_node(node: Node, vals: List[Any], device: torch.device) -> List[Any]:
    fn = _OPS.get(node.op_type)
    if fn is None:
        raise UnsupportedOnnxOp(
            f"ONNX op {node.op_type!r} is not supported by the PyTorch executor")
    return fn(node, vals, device)


class OnnxGraphModule(nn.Module):
    """An ONNX graph as a module: ``forward(*inputs)`` returns the tuple of
    the graph's outputs. Inputs given as tensors are device values; numpy
    inputs are host values, as an unjitted call of the JAX package's function
    treats them."""

    def __init__(self, graph: Graph) -> None:
        super().__init__()
        self.nodes = list(graph.nodes)
        self.inputs = list(graph.inputs)
        self.outputs = list(graph.outputs)
        self.statics: Dict[str, np.ndarray] = {}
        self._buffer_of: Dict[str, str] = {}
        for name, arr in graph.initializers.items():
            if arr.dtype.kind in "iub":
                self.statics[name] = arr
                continue
            attr = f"init_{len(self._buffer_of)}"
            self.register_buffer(attr, torch.from_numpy(
                np.ascontiguousarray(arr)).to(_TORCH_DTYPE[arr.dtype]))
            self._buffer_of[name] = attr
        # the device of a graph with no float initializer and host inputs
        self.register_buffer("_anchor", torch.zeros(0), persistent=False)
        # after node k, drop the values it read last (outputs stay)
        last: Dict[str, int] = {}
        for k, node in enumerate(graph.nodes):
            for name in node.inputs:
                if name:
                    last[name] = k
        keep = set(self.outputs)
        self._drop_after: List[List[str]] = [[] for _ in graph.nodes]
        for name, k in last.items():
            if name not in keep and name not in graph.initializers:
                self._drop_after[k].append(name)

    def param_count(self) -> int:
        """Elements of the float initializers: the weights on the device."""
        return sum(getattr(self, attr).numel() for attr in self._buffer_of.values())

    def forward(self, *args: Any) -> Tuple[Any, ...]:
        if len(args) != len(self.inputs):
            raise ValueError(f"expected {len(self.inputs)} inputs {self.inputs}, got {len(args)}")
        device = self._anchor.device
        env: Dict[str, Any] = dict(zip(self.inputs, args))

        def value(name: str) -> Any:
            if not name:
                return None
            if name in env:
                return env[name]
            if name in self.statics:
                return self.statics[name]
            return getattr(self, self._buffer_of[name])

        for node, drop in zip(self.nodes, self._drop_after):
            res = _exec_node(node, [value(i) for i in node.inputs], device)
            for o, v in zip(node.outputs, res):
                if o:
                    env[o] = v
            for name in drop:
                env.pop(name, None)
        return tuple(value(o) for o in self.outputs)


def validate_graph(graph: Graph) -> List[str]:
    """Return the list of unsupported op types (empty = fully executable)."""
    return sorted({node.op_type for node in graph.nodes if node.op_type not in _OPS})
