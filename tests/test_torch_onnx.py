"""The ONNX reader, writer and graph executor of the port against the JAX
package, on the CPU.

1. Reader and writer: both committed fixtures parse to the same graph
   (nodes, attributes, initializers, value infos), and both writers give
   the same bytes, the fixture's own; a graph written by either package
   reads back the same in the other. Exact.
2. Per-op parity: one tiny graph per case, written with the JAX package's
   writer, through ``build_jax_fn`` (unjitted, float inputs and weights as
   device arrays, integer operands as host numpy, as a traced call sees
   them) and ``OnnxGraphModule`` (float inputs as tensors, integer operands
   as numpy). Float outputs: max |port - JAX| <= 1e-5 * max(1, max |JAX|)
   (float32 on both sides, sums in other orders); integer and bool outputs
   equal; the same shape and dtype kind.
3. The executor on both fixtures: the port within 1e-5 * max |JAX| of the
   JAX executor (one compile each), and both within 1e-4 of the pinned
   torch forward (the JAX package's own bound). ``validate_graph`` gives the
   JAX package's lists, over every op either executor's table names.
4. The graph builder of ``audio_cut_tpu_torch/testing.py``: the structure of
   ``mdxnet_trim_mini.onnx`` at the mini geometry, the op counts of
   ``mdxnet_trim_ops.json`` at L 11 with g 8, l 2, bn 8, and the executor
   within 1e-5 * max |net| of the ``ConvTDFNetTrim`` it was written from.
"""

import json
import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from audio_cut_tpu.onnx import Graph, Node  # noqa: E402
from audio_cut_tpu.onnx import build_jax_fn, load_model as jax_load, save_model as jax_save  # noqa: E402
from audio_cut_tpu.onnx import validate_graph as jax_validate  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "onnx"
FIXTURE_NAMES = ["mini_convtdf", "mdxnet_trim_mini"]


def _same_graph(a, b) -> None:
    assert (a.name, a.opset, a.producer, a.inputs, a.outputs, a.input_shapes) == \
        (b.name, b.opset, b.producer, b.inputs, b.outputs, b.input_shapes)
    assert len(a.nodes) == len(b.nodes)
    for na, nb in zip(a.nodes, b.nodes):
        assert (na.op_type, na.inputs, na.outputs, na.name) == (nb.op_type, nb.inputs, nb.outputs,
                                                                nb.name)
        assert na.attrs.keys() == nb.attrs.keys()
        for k, v in na.attrs.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == nb.attrs[k].dtype
                np.testing.assert_array_equal(v, nb.attrs[k])
            else:
                assert v == nb.attrs[k] and type(v) is type(nb.attrs[k])
    assert list(a.initializers) == list(b.initializers)
    for k, v in a.initializers.items():
        assert v.dtype == b.initializers[k].dtype and v.shape == b.initializers[k].shape
        np.testing.assert_array_equal(v, b.initializers[k])


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_reads_and_writes_as_jax(name, tmp_path):
    from audio_cut_tpu_torch.onnx import load_model, save_model

    path = FIXTURES / f"{name}.onnx"
    got, want = load_model(str(path)), jax_load(str(path))
    _same_graph(got, want)
    save_model(got, str(tmp_path / "port.onnx"))
    jax_save(want, str(tmp_path / "jax.onnx"))
    port_bytes = (tmp_path / "port.onnx").read_bytes()
    assert port_bytes == (tmp_path / "jax.onnx").read_bytes() == path.read_bytes()


def test_round_trip_across_packages(tmp_path):
    """Floats, negative ints, strings, tensors and int lists as attributes;
    int64, float32 and bool initializers; a dynamic input dimension."""
    from audio_cut_tpu_torch.onnx import proto

    g = Graph(
        nodes=[Node("Conv", ["x", "w"], ["y"], "c",
                    {"strides": [1, 1], "pads": [0, -1, 0, 0], "epsilon": 1e-3,
                     "mode": "constant", "value": np.asarray([2.5], np.float32),
                     "scales": [0.5, 2.0], "axis": -3}),
               Node("ReduceMean", ["y", "ax"], ["z"], "", {"keepdims": 1})],
        initializers={"w": np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2),
                      "ax": np.asarray([0, -1, -(2 ** 40)], dtype=np.int64),
                      "flag": np.asarray([True, False])},
        inputs=["x"], outputs=["z"], input_shapes={"x": [None, 3, 8, 8]}, opset=13)
    jax_save(g, str(tmp_path / "jax.onnx"))
    port = proto.load_model(str(tmp_path / "jax.onnx"))
    _same_graph(port, jax_load(str(tmp_path / "jax.onnx")))
    proto.save_model(port, str(tmp_path / "port.onnx"))
    assert (tmp_path / "port.onnx").read_bytes() == (tmp_path / "jax.onnx").read_bytes()
    _same_graph(jax_load(str(tmp_path / "port.onnx")), port)


# -- per-op parity ------------------------------------------------------------------

_RNG = np.random.default_rng(31)


def _f(*shape):
    return _RNG.standard_normal(shape).astype(np.float32)


def _i(*vals):
    return np.asarray(vals, dtype=np.int64)


# case: (nodes as (op, inputs, attrs[, outputs]), initializers, graph inputs
# (float arrays are device values, integer ones host values))
OP_CASES = {
    "conv_asymmetric_pads": (
        [("Conv", ["x", "w", "b"], {"pads": [0, 1, 2, 0], "kernel_shape": [3, 3]})],
        {"w": _f(4, 3, 3, 3), "b": _f(4)}, {"x": _f(2, 3, 7, 8)}),
    "conv_same_upper_stride_2": (
        [("Conv", ["x", "w"], {"auto_pad": "SAME_UPPER", "strides": [2, 2]})],
        {"w": _f(4, 3, 4, 3)}, {"x": _f(1, 3, 9, 8)}),
    "conv_same_lower_dilated": (
        [("Conv", ["x", "w", "b"], {"auto_pad": "SAME_LOWER", "dilations": [2, 1]})],
        {"w": _f(2, 3, 2, 2), "b": _f(2)}, {"x": _f(1, 3, 6, 7)}),
    "conv_grouped_dilated_1d": (
        [("Conv", ["x", "w", "b"], {"group": 2, "dilations": [3], "pads": [2, 2],
                                    "strides": [2]})],
        {"w": _f(6, 2, 3), "b": _f(6)}, {"x": _f(2, 4, 19)}),
    "conv_transpose_symmetric": (
        [("ConvTranspose", ["x", "w", "b"], {"strides": [2, 2], "pads": [1, 1, 1, 1],
                                             "output_padding": [1, 1]})],
        {"w": _f(3, 5, 3, 3), "b": _f(5)}, {"x": _f(1, 3, 5, 6)}),
    "conv_transpose_asymmetric_grouped": (
        [("ConvTranspose", ["x", "w", "b"], {"strides": [2, 3], "pads": [0, 1, 2, 0],
                                             "output_padding": [1, 0], "group": 2,
                                             "dilations": [1, 2]})],
        {"w": _f(4, 3, 2, 3), "b": _f(6)}, {"x": _f(2, 4, 4, 5)}),
    "conv_transpose_mdx_up": (
        [("ConvTranspose", ["x", "w", "b"], {"strides": [2, 2], "kernel_shape": [2, 2]})],
        {"w": _f(6, 4, 2, 2), "b": _f(4)}, {"x": _f(2, 6, 3, 5)}),
    "groupnorm_lowering_instance_norm_3d": (
        [("Reshape", ["x", "s_in"], {}, ["r"]),
         ("InstanceNormalization", ["r", "one", "zero"], {"epsilon": 1e-5}, ["n"]),
         ("Reshape", ["n", "s_out"], {}, ["y"])],
        {"s_in": _i(0, 2, -1), "s_out": _i(0, 4, 5, 6), "one": np.ones(2, np.float32),
         "zero": np.zeros(2, np.float32)}, {"x": 3 + 2 * _f(2, 4, 5, 6)}),
    "instance_norm_default_eps": (
        [("InstanceNormalization", ["x", "s", "b"], {})],
        {"s": _f(3), "b": _f(3)}, {"x": _f(2, 3, 4, 5)}),
    "batch_norm_inference": (
        [("BatchNormalization", ["x", "s", "b", "m", "v"], {})],
        {"s": _f(3), "b": _f(3), "m": _f(3), "v": np.abs(_f(3)) + 0.5}, {"x": _f(2, 3, 4, 5)}),
    "layer_norm": (
        [("LayerNormalization", ["x", "s", "b"], {"axis": -2, "epsilon": 1e-3})],
        {"s": _f(4, 5), "b": _f(4, 5)}, {"x": _f(2, 3, 4, 5)}),
    "group_norm": (
        [("GroupNormalization", ["x", "s", "b"], {"num_groups": 2})],
        {"s": _f(4), "b": _f(4)}, {"x": _f(2, 4, 3, 5)}),
    "reduce_mean_axes_attribute": (
        [("ReduceMean", ["x"], {"axes": [1, -1], "keepdims": 1})], {}, {"x": _f(2, 3, 4)}),
    "reduce_sum_axes_input": (
        [("ReduceSum", ["x", "a"], {"keepdims": 0})], {}, {"x": _f(2, 3, 4), "a": _i(0, 2)}),
    "reduce_max_all_axes": (
        [("ReduceMax", ["x"], {"keepdims": 0})], {}, {"x": _f(2, 3, 4)}),
    "reduce_noop_with_empty_axes": (
        [("ReduceMin", ["x", "a"], {"noop_with_empty_axes": 1})], {},
        {"x": _f(2, 3), "a": np.zeros(0, np.int64)}),
    "reduce_prod_two_axes": (
        [("ReduceProd", ["x"], {"axes": [0, 2], "keepdims": 0})], {}, {"x": _f(2, 3, 4)}),
    "squeeze_unsqueeze_attributes": (
        [("Unsqueeze", ["x"], {"axes": [-1, 0]}, ["u"]), ("Squeeze", ["u"], {"axes": [0]}, ["y"])],
        {}, {"x": _f(3, 1, 4)}),
    "squeeze_unsqueeze_inputs": (
        [("Squeeze", ["x", "a"], {}, ["s"]), ("Unsqueeze", ["s", "b"], {}, ["y"])],
        {}, {"x": _f(3, 1, 4), "a": _i(-2), "b": _i(1, -1)}),
    "squeeze_all_ones": ([("Squeeze", ["x"], {})], {}, {"x": _f(1, 3, 1)}),
    "split_attribute": (
        [("Split", ["x"], {"axis": 1, "split": [1, 3]}, ["a", "b"])], {}, {"x": _f(2, 4, 3)}),
    "split_input_and_equal": (
        [("Split", ["x", "s"], {"axis": -1}, ["a", "b"]),
         ("Split", ["x"], {"axis": 0}, ["c", "d"])],
        {}, {"x": _f(2, 4, 5), "s": _i(2, 3)}),
    "slice_negative_steps": (
        [("Slice", ["x", "s", "e", "a", "st"], {})], {},
        {"x": _f(4, 6, 5), "s": _i(-1, 4), "e": _i(-(2 ** 63), 0), "a": _i(0, 2),
         "st": _i(-1, -2)}),
    "slice_int64_max_and_negative_ends": (
        [("Slice", ["x", "s", "e", "a", "st"], {})], {},
        {"x": _f(4, 6, 5), "s": _i(1, -4), "e": _i(2 ** 63 - 1, -1), "a": _i(1, -1),
         "st": _i(2, 1)}),
    "slice_attributes": (
        [("Slice", ["x"], {"starts": [1, 0], "ends": [3, -1], "axes": [0, 2]})], {},
        {"x": _f(4, 6, 5)}),
    "gather_negative_indices": (
        [("Gather", ["x", "i"], {"axis": 1})], {}, {"x": _f(3, 5, 2), "i": _i(-1, 0, -5, 2)}),
    "gather_2d_indices_axis_0": (
        [("Gather", ["x", "i"], {"axis": 0})], {},
        {"x": _f(4, 3), "i": np.asarray([[0, -1], [2, 1]], np.int64)}),
    "shape_gather_concat_reshape": (
        [("Shape", ["x"], {}, ["sh"]), ("Gather", ["sh", "zero"], {"axis": 0}, ["d0"]),
         ("Unsqueeze", ["d0"], {"axes": [0]}, ["d0u"]),
         ("Concat", ["d0u", "minus1"], {"axis": 0}, ["tgt"]),
         ("Reshape", ["x", "tgt"], {}, ["y"]), ("Size", ["x"], {}, ["n"]),
         ("Shape", ["x"], {"start": 1, "end": -1}, ["mid"])],
        {"zero": np.asarray(-3, np.int64), "minus1": _i(-1)}, {"x": _f(3, 4, 5)}),
    "expand_and_constant_of_shape": (
        [("Expand", ["x", "s"], {}, ["e"]), ("Shape", ["e"], {}, ["sh"]),
         ("ConstantOfShape", ["sh"], {"value": np.asarray([1.5], np.float32)}, ["c"]),
         ("Add", ["e", "c"], {}, ["y"])],
        {}, {"x": _f(3, 1), "s": _i(2, 1, 4)}),
    "range_cast_and_host_arithmetic": (
        [("Range", ["a", "b", "c"], {}, ["r"]), ("Cast", ["r"], {"to": 1}, ["rf"]),
         ("Mul", ["rf", "x"], {}, ["y"]), ("Div", ["b", "c"], {}, ["q"])],
        {}, {"a": np.asarray(1, np.int64), "b": np.asarray(9, np.int64),
             "c": np.asarray(2, np.int64), "x": _f(4)}),
    "cast_float64_on_device_is_float32": (
        [("Cast", ["x"], {"to": 11}, ["d"]), ("Cast", ["d"], {"to": 7}, ["i"]),
         ("Cast", ["x"], {"to": 9}, ["bo"])], {}, {"x": 3 * _f(2, 3)}),
    "constants_beside_device_values": (
        [("Constant", [], {"value_float": 0.25}, ["c"]), ("Add", ["x", "c"], {}, ["a"]),
         ("Constant", [], {"value": np.asarray([2.0, -1.0, 0.5], np.float32)}, ["v"]),
         ("Mul", ["a", "v"], {}, ["m"]), ("Constant", [], {"value_ints": [1, 3]}, ["s"]),
         ("Reshape", ["m", "s"], {}, ["y"])], {}, {"x": _f(3)}),
    "resize_nearest_sizes_up_and_down": (
        [("Resize", ["x", "", "", "s"], {"mode": "nearest"})], {},
        {"x": _f(1, 2, 4, 7), "s": _i(1, 2, 9, 3)}),
    "resize_linear_scales_up": (
        [("Constant", [], {"value": np.asarray([1, 1, 2, 1.5], np.float32)}, ["sc"]),
         ("Resize", ["x", "", "sc"], {"mode": "linear"}, ["y"])], {}, {"x": _f(1, 2, 4, 6)}),
    "resize_linear_down_antialiased": (
        [("Resize", ["x", "", "", "s"], {"mode": "linear"})], {},
        {"x": _f(1, 2, 9, 8), "s": _i(1, 2, 4, 3)}),
    "resize_cubic_up": (
        [("Resize", ["x", "", "", "s"], {"mode": "cubic"})], {},
        {"x": _f(1, 1, 5, 6), "s": _i(1, 1, 11, 13)}),
    "resize_cubic_down": (
        [("Resize", ["x", "", "", "s"], {"mode": "cubic"})], {},
        {"x": _f(2, 1, 12, 9), "s": _i(2, 1, 5, 4)}),
    "softmax_on_its_axis": ([("Softmax", ["x"], {"axis": 1})], {}, {"x": _f(2, 3, 4)}),
    "pad_reflect_wide_and_edge": (
        [("Pad", ["x", "p"], {"mode": "reflect"}, ["r"]),
         ("Pad", ["x", "q"], {"mode": "edge"}, ["e"])], {},
        {"x": _f(1, 2, 3), "p": _i(0, 1, 5, 0, 0, 4), "q": _i(0, 0, 2, 0, 1, 3)}),
    "pad_constant_value_input": (
        [("Pad", ["x", "p", "v"], {}, ["y"])],
        {"v": np.asarray(1.5, np.float32)}, {"x": _f(2, 3), "p": _i(1, 0, 0, 2)}),
    "matmul_and_gemm": (
        [("MatMul", ["x", "w"], {}, ["m"]),
         ("Gemm", ["a", "b", "c"], {"transA": 1, "transB": 1, "alpha": 2.0, "beta": 0.5},
          ["g"])],
        {"w": _f(5, 3), "b": _f(6, 4), "c": _f(6)},
        {"x": _f(2, 3, 4, 5), "a": _f(4, 2)}),
    "pools": (
        [("MaxPool", ["x"], {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 1, 1]},
          ["mx"]),
         ("AveragePool", ["x"], {"kernel_shape": [3, 2], "pads": [1, 0, 1, 1]}, ["av"]),
         ("GlobalAveragePool", ["x"], {}, ["gp"])], {}, {"x": _f(2, 3, 7, 6)}),
    "activations": (
        [("Relu", ["x"], {}, ["r"]), ("LeakyRelu", ["x"], {"alpha": 0.2}, ["l"]),
         ("PRelu", ["x", "sl"], {}, ["p"]), ("Sigmoid", ["x"], {}, ["s"]),
         ("Tanh", ["x"], {}, ["t"]), ("Elu", ["x"], {"alpha": 0.7}, ["e"]),
         ("Erf", ["x"], {}, ["er"]), ("HardSigmoid", ["x"], {"alpha": 0.3}, ["h"]),
         ("Clip", ["x", "lo", "hi"], {}, ["c"]), ("Neg", ["x"], {}, ["n"]),
         ("Abs", ["x"], {}, ["ab"]), ("Exp", ["x"], {}, ["ex"]),
         ("Reciprocal", ["x"], {}, ["rc"]), ("Floor", ["x"], {}, ["fl"]),
         ("Ceil", ["x"], {}, ["ce"]), ("Sin", ["x"], {}, ["si"]), ("Cos", ["x"], {}, ["co"]),
         ("Identity", ["x"], {}, ["id"]), ("Dropout", ["x"], {}, ["dr"])],
        {"sl": _f(3, 1), "lo": np.asarray(-0.5, np.float32), "hi": np.asarray(0.7, np.float32)},
        {"x": _f(2, 3, 4)}),
    "positive_unary": (
        [("Log", ["x"], {}, ["l"]), ("Sqrt", ["x"], {}, ["s"]), ("Pow", ["x", "x"], {}, ["p"])],
        {}, {"x": np.abs(_f(3, 4)) + 0.1}),
    "binary_compare_where_minmax": (
        [("Sub", ["a", "b"], {}, ["s"]), ("Div", ["a", "b"], {}, ["d"]),
         ("Greater", ["a", "b"], {}, ["gt"]), ("LessOrEqual", ["a", "b"], {}, ["le"]),
         ("Equal", ["a", "a"], {}, ["eq"]), ("Less", ["a", "b"], {}, ["lt"]),
         ("GreaterOrEqual", ["a", "b"], {}, ["ge"]), ("Where", ["gt", "a", "half"], {}, ["w"]),
         ("Max", ["a", "b", "c"], {}, ["mx"]), ("Min", ["a", "b"], {}, ["mn"]),
         ("ArgMax", ["a"], {"axis": 1, "keepdims": 1}, ["am"]),
         ("Flatten", ["a"], {"axis": 2}, ["fl"]), ("Transpose", ["a"], {"perm": [2, 0, 1]}, ["tr"]),
         ("Transpose", ["a"], {}, ["tr2"]), ("Concat", ["a", "b"], {"axis": -1}, ["cat"])],
        {"half": np.asarray(0.5, np.float32)}, {"a": _f(2, 3, 4), "b": _f(2, 3, 4), "c": _f(4)}),
}


def _case_graph(case):
    nodes_spec, inits, inputs = OP_CASES[case]
    nodes = []
    for k, spec in enumerate(nodes_spec):
        op, ins, attrs = spec[:3]
        outs = spec[3] if len(spec) > 3 else ["y"]
        nodes.append(Node(op, list(ins), list(outs), f"n{k}", dict(attrs)))
    outputs = [o for n in nodes for o in n.outputs]
    return Graph(nodes=nodes, initializers=dict(inits), inputs=list(inputs), outputs=outputs,
                 input_shapes={k: list(v.shape) for k, v in inputs.items()}), inputs


def _run_both(graph, inputs):
    from audio_cut_tpu_torch.onnx import OnnxGraphModule

    fn, params = build_jax_fn(graph)
    want = fn({k: jnp.asarray(v) for k, v in params.items()},
              *[jnp.asarray(v) if v.dtype.kind == "f" else v for v in inputs.values()])
    got = OnnxGraphModule(graph)(*[torch.from_numpy(v) if v.dtype.kind == "f" else v
                                   for v in inputs.values()])
    return ([None if w is None else np.asarray(w) for w in want],
            [None if g is None else (g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g))
             for g in got])


@pytest.mark.parametrize("case", list(OP_CASES))
def test_op_matches_jax(case, tmp_path):
    from audio_cut_tpu_torch.onnx import load_model

    graph, inputs = _case_graph(case)
    jax_save(graph, str(tmp_path / "case.onnx"))
    want, _ = _run_both(jax_load(str(tmp_path / "case.onnx")), inputs)
    _, got = _run_both(load_model(str(tmp_path / "case.onnx")), inputs)
    assert len(got) == len(want)
    for name, g, w in zip(graph.outputs, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert g.dtype.kind == w.dtype.kind and g.dtype.itemsize == w.dtype.itemsize or \
            (g.dtype.kind == w.dtype.kind == "i"), (name, g.dtype, w.dtype)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            bound = 1e-5 * max(1.0, float(np.abs(w).max()) if w.size else 0.0)
            assert float(np.abs(g - w).max(initial=0.0)) <= bound, name


def test_conv_transpose_output_shape_raises_in_both():
    from audio_cut_tpu.onnx import UnsupportedOnnxOp as JaxUnsupported
    from audio_cut_tpu_torch.onnx import OnnxGraphModule, UnsupportedOnnxOp

    g = Graph(nodes=[Node("ConvTranspose", ["x", "w"], ["y"], "ct",
                          {"strides": [2, 2], "output_shape": [9, 9]})],
              initializers={"w": _f(2, 3, 2, 2)}, inputs=["x"], outputs=["y"])
    fn, params = build_jax_fn(g)
    with pytest.raises(JaxUnsupported, match="output_shape"):
        fn(params, jnp.asarray(_f(1, 2, 4, 4)))
    with pytest.raises(UnsupportedOnnxOp, match="output_shape"):
        OnnxGraphModule(g)(torch.from_numpy(_f(1, 2, 4, 4)))


def test_unsupported_op_raises_with_its_name():
    from audio_cut_tpu_torch.onnx import OnnxGraphModule, UnsupportedOnnxOp, validate_graph

    g = Graph(nodes=[Node("NonMaxSuppression", ["x"], ["y"], "n", {})],
              initializers={}, inputs=["x"], outputs=["y"])
    assert validate_graph(g) == jax_validate(g) == ["NonMaxSuppression"]
    with pytest.raises(UnsupportedOnnxOp, match="'NonMaxSuppression' is not supported"):
        OnnxGraphModule(g)(torch.zeros(1))


def test_validate_graph_lists_what_jax_lists():
    """Every op that either table names, and some neither has: the same
    sorted list of unsupported ops."""
    from audio_cut_tpu_torch.onnx import executor, validate_graph

    src = (REPO / "audio_cut_tpu" / "onnx" / "executor.py").read_text()
    jax_ops = set(re.findall(r'op == "(\w+)"', src))
    for group in re.findall(r"op in \(([^)]*)\)", src):
        jax_ops |= set(re.findall(r'"(\w+)"', group))
    ops = sorted(jax_ops | set(executor._OPS)) + ["NonMaxSuppression", "LSTM", "Loop", ""]
    g = Graph(nodes=[Node(op, [], [], f"n{k}", {}) for k, op in enumerate(ops)],
              initializers={}, inputs=[], outputs=[])
    assert jax_ops == set(executor._OPS)
    assert validate_graph(g) == jax_validate(g) == ["", "LSTM", "Loop", "NonMaxSuppression"]
    for name in FIXTURE_NAMES:
        graph = jax_load(str(FIXTURES / f"{name}.onnx"))
        assert validate_graph(graph) == jax_validate(graph) == []


# -- the executor on the committed fixtures ----------------------------------------------


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_executes_as_jax(name):
    from audio_cut_tpu_torch.onnx import OnnxGraphModule, load_model

    io = np.load(FIXTURES / f"{name}_io.npz")
    fn, params = build_jax_fn(jax_load(str(FIXTURES / f"{name}.onnx")))
    (want,) = jax.jit(fn)(params, io["input"])
    want = np.asarray(want)
    module = OnnxGraphModule(load_model(str(FIXTURES / f"{name}.onnx")))
    with torch.inference_mode():
        (got,) = module(torch.from_numpy(io["input"]))
    got = got.numpy()
    assert got.shape == want.shape == io["expected"].shape and got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())
    for out in (got, want):
        assert float(np.abs(out - io["expected"]).max()) < 1e-4
    # float weights are buffers; integer shapes stay on the host
    assert all(b.dtype == torch.float32 for b in module.buffers())
    assert all(isinstance(v, np.ndarray) and v.dtype.kind == "i" for v in module.statics.values())


# -- the graph builder -------------------------------------------------------------------


def test_builder_writes_the_mini_fixture_structure(tmp_path):
    from audio_cut_tpu_torch.onnx import OnnxGraphModule, load_model, save_model
    from audio_cut_tpu_torch.testing import MDX_MINI, build_graph, make_net

    net = make_net(**MDX_MINI, generator=torch.Generator().manual_seed(7))
    save_model(build_graph(net, MDX_MINI["g"], MDX_MINI["l"], MDX_MINI["k"], MDX_MINI["bn"]),
               str(tmp_path / "mini.onnx"))
    got, want = load_model(str(tmp_path / "mini.onnx")), jax_load(str(FIXTURES / "mdxnet_trim_mini.onnx"))
    assert [(n.op_type, n.inputs, n.outputs, n.name, n.attrs) for n in got.nodes] == \
        [(n.op_type, n.inputs, n.outputs, n.name, n.attrs) for n in want.nodes]
    assert {k: (v.shape, v.dtype) for k, v in got.initializers.items()} == \
        {k: (v.shape, v.dtype) for k, v in want.initializers.items()}
    assert (got.inputs, got.outputs, got.input_shapes) == (want.inputs, want.outputs,
                                                           want.input_shapes)
    # the executor against the net the graph was written from
    x = np.random.default_rng(55).standard_normal((2, 4, MDX_MINI["dim_f"], MDX_MINI["dim_t"]))
    x = torch.from_numpy(x.astype(np.float32))
    with torch.inference_mode():
        (y,) = OnnxGraphModule(got)(x)
        ref = net(x)
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_builder_counts_at_the_real_geometry():
    from audio_cut_tpu_torch.testing import KIM_VOCAL_1, build_graph, make_net

    inventory = json.loads((FIXTURES / "mdxnet_trim_ops.json").read_text())
    geometry = {**{k: KIM_VOCAL_1[k] for k in ("dim_f", "dim_t", "L", "k")}, "g": 8, "l": 2,
                "bn": 8}
    assert {k: geometry[k] for k in inventory["geometry"]} == inventory["geometry"]
    net = make_net(**geometry, generator=torch.Generator().manual_seed(11))
    graph = build_graph(net, geometry["g"], geometry["l"], geometry["k"], geometry["bn"])
    assert len(graph.nodes) == inventory["node_count"]
    assert dict(Counter(n.op_type for n in graph.nodes)) == inventory["ops"]
    assert graph.input_shapes["input"] == inventory["input_shape"]
