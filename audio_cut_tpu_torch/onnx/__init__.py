"""ONNX weight import: protobuf reader/writer + PyTorch graph executor.

Counterpart of ``audio_cut_tpu/onnx``: ``.onnx`` -> parsed graph ->
``OnnxGraphModule`` (the port's counterpart of ``build_jax_fn``), with the
weights as buffers on the module's device. No ``onnx``/``onnxruntime``
packages required.
"""

from audio_cut_tpu_torch.onnx.executor import OnnxGraphModule, UnsupportedOnnxOp, validate_graph
from audio_cut_tpu_torch.onnx.proto import Graph, Node, load_model, save_model

__all__ = [
    "Graph",
    "Node",
    "OnnxGraphModule",
    "UnsupportedOnnxOp",
    "load_model",
    "save_model",
    "validate_graph",
]
