"""MDX-class ONNX separation backend: an ``.onnx`` mask net run by the port's
executor.

Counterpart of ``audio_cut_tpu/separation/onnx_backend.py``. The model is
MDX23's ``Kim_Vocal_1.onnx`` class (n_fft 6144, hop 1024, input [B, 4,
dim_f, dim_t]: the (re, im) pairs of both stereo channels, Hann window,
centred frames, the bins above dim_f zero in the stem). The graph is parsed
in-process (``audio_cut_tpu_torch.onnx``, no onnxruntime) and run by
``OnnxGraphModule``, its weights resident on the backend's device. A
forward is the STFT, the graph and the iSTFT, whose overlap-add is kernel K1
on the card: the mono windows go through as stereo, so a forward of n
windows sends 2n rows through K1.

Engine windows are model windows (``stft_engine_geometry``). A window of
another length raises: re-tiling (``tiled_forward_batch``, and the JAX
package's ``separate_window``) is not in the port yet. A missing or
unusable model raises whatever ``enable_fallback`` says.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from audio_cut_tpu_torch.config import get_config

logger = logging.getLogger(__name__)

_DEFAULT_SEARCH = (
    "models",
    "models/MDX23",
    os.path.join(os.path.expanduser("~"), ".cache", "audio_cut_tpu", "models"),
)


def discover_model(path_cfg: Optional[str]) -> str:
    """Locate the ONNX model file, in the JAX package's order: the config's
    path, then ``$AUDIO_CUT_ONNX_MODEL``, then ``$MDX23_MODEL_FILENAME``
    (default ``Kim_Vocal_1.onnx``) in the conventional model directories."""
    candidates = []
    if path_cfg:
        candidates.append(path_cfg)
    env = os.environ.get("AUDIO_CUT_ONNX_MODEL")
    if env:
        candidates.append(env)
    filename = os.environ.get("MDX23_MODEL_FILENAME", "Kim_Vocal_1.onnx")
    for d in _DEFAULT_SEARCH:
        candidates.append(os.path.join(d, filename))
    for c in candidates:
        if c and Path(c).is_file():
            return str(c)
    raise FileNotFoundError(
        f"no ONNX separation model found (looked at {candidates}); set "
        "enhanced_separation.onnx.model_path or AUDIO_CUT_ONNX_MODEL"
    )


class OnnxSeparatorBackend:
    """Engine-facing backend executing MDX-geometry ONNX mask nets."""

    name = "onnx"

    def __init__(self, sample_rate: int, device: torch.device) -> None:
        from audio_cut_tpu_torch.onnx import OnnxGraphModule, load_model, validate_graph

        cfg = get_config("enhanced_separation.onnx", {}) or {}
        self.sample_rate = int(sample_rate)
        self.device = torch.device(device)
        self.n_fft = int(cfg.get("n_fft", 6144))
        self.hop = int(cfg.get("hop", 1024))
        self.dim_f = int(cfg.get("dim_f", 2048))
        self.dim_t = int(cfg.get("dim_t", 256))

        path = discover_model(cfg.get("model_path"))
        graph = load_model(path)
        unsupported = validate_graph(graph)
        if unsupported:
            raise ValueError(f"ONNX model {path} uses unsupported ops: {unsupported}")
        # the model's static input signature wins over the config: the real
        # Kim_Vocal_1 declares [B, 4, 3072, 256], not the config's dim_f 2048
        if graph.inputs:
            shape = (graph.input_shapes or {}).get(graph.inputs[0]) or []
            if len(shape) == 4 and shape[1] == 4:
                model_f, model_t = shape[2], shape[3]
                if isinstance(model_f, int) and model_f > 0 and model_f != self.dim_f:
                    logger.info("ONNX model declares dim_f=%d (config said %d); "
                                "using the model's", model_f, self.dim_f)
                    self.dim_f = int(model_f)
                if isinstance(model_t, int) and model_t > 0 and model_t != self.dim_t:
                    logger.info("ONNX model declares dim_t=%d (config said %d); "
                                "using the model's", model_t, self.dim_t)
                    self.dim_t = int(model_t)
        if self.dim_f > self.n_fft // 2 + 1:
            raise ValueError(
                f"model dim_f={self.dim_f} exceeds n_fft/2+1={self.n_fft // 2 + 1}; "
                f"set enhanced_separation.onnx.n_fft to the model's STFT size")
        self.window_samples = self.hop * (self.dim_t - 1)
        if len(graph.inputs) != 1:
            raise ValueError(f"expected a single-input mask net, got {graph.inputs}")
        self.net = OnnxGraphModule(graph).to(self.device).eval()

        # output semantics from the file name
        output = str(cfg.get("output", "auto"))
        if output == "auto":
            output = "vocals" if "vocal" in Path(path).name.lower() else "instrumental"
        self.output = output
        self.model_path = path
        # test-time shift averaging, as for the ConvTDF: a forward takes
        # map_group // shifts windows, so its activations stay bounded
        self.shifts = max(1, int(cfg.get("shifts", 1)))
        self.map_group = max(1, int(cfg.get("map_group", 4)) // self.shifts)
        logger.info("ONNX separator: %s (output=%s, window=%d samples)",
                    path, output, self.window_samples)

    def engine_geometry(self) -> Dict[str, float]:
        """Native chunk schedule: engine windows are model windows."""
        from audio_cut_tpu_torch.separation.tiling import stft_engine_geometry

        return stft_engine_geometry(self.sample_rate, self.window_samples, self.n_fft, self.hop)

    def _forward_windows(self, windows: torch.Tensor) -> torch.Tensor:
        """[n, window_samples] mono -> [n, window_samples] model stem."""
        from audio_cut_tpu_torch.ops.stft import istft, stft

        n, w = windows.shape
        stereo = windows[:, None, :].expand(n, 2, w)
        spec = stft(stereo, n_fft=self.n_fft, hop=self.hop, center=True)  # [n, 2, T, Fall]
        spec = spec[..., :self.dim_t, :]
        crop = spec[..., :self.dim_f]
        # ONNX layout [B, 4, F, T]; channel order (L_re, L_im, R_re, R_im)
        ri = torch.stack([crop.real, crop.imag], dim=2)  # [n, 2, 2, T, F]
        x = ri.reshape(n, 4, self.dim_t, self.dim_f).transpose(-1, -2).to(torch.float32)

        (y,) = self.net(x)  # [n, 4, F, T]

        y = y.transpose(-1, -2).reshape(n, 2, 2, self.dim_t, self.dim_f)
        stem = torch.complex(y[:, :, 0], y[:, :, 1])  # [n, 2, T, F]
        full = torch.cat([stem, torch.zeros_like(spec[..., self.dim_f:])], dim=-1)
        wave = istft(full, n_fft=self.n_fft, hop=self.hop, length=w)  # K1: 2n rows
        return wave.mean(dim=1)  # stereo -> mono

    @torch.inference_mode()
    def separate_windows(self, windows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[N, W] model windows -> (vocal, instrumental), each [N, W]:
        ``map_group`` windows (times ``shifts`` rows) a forward; the model's
        stem and its complement ``window - stem``, swapped for an
        instrumental model."""
        from audio_cut_tpu_torch.separation.tiling import mapped_forward, shift_averaged

        length = int(windows.shape[-1])
        if length != self.window_samples:
            raise NotImplementedError(
                f"engine window {length} != the model's {self.window_samples}: "
                "re-tiling (tiled_forward_batch) is not in the PyTorch port yet: "
                "ROADMAP.md, queue 1, 'other separator tiers (waveunet, onnx)'")
        forward = shift_averaged(self._forward_windows, self.hop, self.shifts)
        (stem,) = mapped_forward(lambda batch: (forward(batch),), windows, self.map_group)
        rest = windows - stem
        if self.output == "vocals":
            return stem, rest
        return rest, stem  # the model emitted the instrumental: vocal by subtraction

    def separate(self, audio: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """A whole track through the port's engine on this backend's device
        -> (vocal, instrumental) as float32 numpy."""
        from audio_cut_tpu_torch.separation.engine import SeparationEngine

        eng = SeparationEngine(self.sample_rate, self.device, backend=self)
        v_dev, i_dev, _mix, _meta = eng.separate_on_device(np.asarray(audio, np.float32))
        both = torch.stack([v_dev, i_dev]).cpu().numpy()
        return both[0], both[1]
