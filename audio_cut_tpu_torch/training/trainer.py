"""Training loop for the ConvTDF separator (mask regression).

Counterpart of ``audio_cut_tpu/training/trainer.py``: complex-mask L1 on the
cropped spectrogram, waveform L1 after the iSTFT, and a pause-suppression
RMS, then the global-norm clip and AdamW of optax. One train step is the
forward, the loss, the backward (through K1's backward kernel on the card:
``ops/ola.py``), the clip and the AdamW update.

The net runs its activations in its ``dtype`` (bfloat16 in production) on
float32 parameters, which it casts inside ``forward``; the gradients reach
the float32 parameters through those casts. The optimizer updates the
parameters and its moments in place (the JAX package builds new arrays).
Sharded training over a mesh is not in the port yet.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from audio_cut_tpu_torch.models.convtdf import ConvTDFSeparator, apply_complex_mask, to_flax_params
from audio_cut_tpu_torch.utils.device import resolve_device

_MESH_ITEM = ("sharded training over a mesh is not in the PyTorch port yet: "
              "ROADMAP.md, queue 1, 'Scale-out and shell'")


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 1e-4
    spec_loss_weight: float = 1.0
    wave_loss_weight: float = 1.0
    # extra penalty on predicted vocal energy where the TARGET vocal is
    # silent: pause cleanliness of the stem is what drives cut precision
    # downstream (the quiet guard and the valley snap read the vocal dB grid
    # inside pauses)
    pause_loss_weight: float = 0.5
    pause_silence_thresh: float = 1e-3  # target frame RMS below ~-60 dBFS
    clip_norm: float = 1.0


def pause_suppression_rms(pred_wave: torch.Tensor, tgt_wave: torch.Tensor,
                          cfg: TrainConfig) -> torch.Tensor:
    """RMS of the predicted vocal restricted to ~23 ms frames where the
    TARGET vocal is silent (see ``TrainConfig.pause_loss_weight``)."""
    frame = 1024  # ~23 ms at 44.1 kHz
    length = pred_wave.shape[-1]
    nf = length // frame
    tr = tgt_wave[..., :nf * frame].reshape(*tgt_wave.shape[:-1], nf, frame)
    pr = pred_wave[..., :nf * frame].reshape(*pred_wave.shape[:-1], nf, frame)
    tgt_rms = torch.sqrt(torch.mean(tr * tr, dim=-1) + 1e-12)
    silent = (tgt_rms < cfg.pause_silence_thresh).to(pred_wave.dtype)
    pause_ms = torch.sum(silent[..., None] * pr * pr) / (torch.sum(silent) * frame + 1.0)
    return torch.sqrt(pause_ms + 1e-12)


def make_loss_fn(sep: ConvTDFSeparator, cfg: TrainConfig, mesh=None
                 ) -> Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """``loss_fn(mix, vocal_target) -> (loss, metrics)`` over ``sep``'s net
    parameters, as the JAX package's ``make_loss_fn`` computes it."""
    if mesh is not None:
        raise NotImplementedError(_MESH_ITEM)

    def loss_fn(mix: torch.Tensor, vocal_target: torch.Tensor):
        spec_mix, ri_mix = sep.analyze(mix)
        mask = sep.net(ri_mix)
        pred_spec = apply_complex_mask(spec_mix[..., :sep.dim_f], mask)

        spec_tgt, _ = sep.analyze(vocal_target)
        tgt_crop = spec_tgt[..., :sep.dim_f]
        spec_l1 = (torch.mean(torch.abs(pred_spec.real - tgt_crop.real))
                   + torch.mean(torch.abs(pred_spec.imag - tgt_crop.imag)))

        length = mix.shape[-1]
        pred_wave = sep.synthesize(spec_mix, mask, length)
        tgt_wave = vocal_target[..., :length]
        wave_l1 = torch.mean(torch.abs(pred_wave - tgt_wave))

        pause_rms = pause_suppression_rms(pred_wave, tgt_wave, cfg)

        loss = (cfg.spec_loss_weight * spec_l1
                + cfg.wave_loss_weight * wave_l1
                + cfg.pause_loss_weight * pause_rms)
        return loss, {"loss": loss, "spec_l1": spec_l1, "wave_l1": wave_l1,
                      "pause_rms": pause_rms}

    return loss_fn


@dataclasses.dataclass
class AdamState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(learning_rate,
    weight_decay=weight_decay))`` with optax's defaults (b1 0.9, b2 0.999,
    eps 1e-8, eps_root 0, decay on every leaf), in optax's order of
    operations. The clip scales by ``max_norm / norm`` only when the global
    norm is not below ``max_norm``, as ``(g / norm) * max_norm``;
    ``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` instead."""

    def __init__(self, learning_rate: float, weight_decay: float, clip_norm: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def apply(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              state: AdamState) -> None:
        """One step: updates ``params`` and ``state`` in place. No host sync."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.clip_norm
        state.count += 1
        # 1 - decay ** count in float32, as optax computes it
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(state.count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(state.count))
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            g = torch.where(keep, g, (g / norm) * self.clip_norm)
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            update = update + self.weight_decay * p
            p.add_(-self.learning_rate * update)


def make_optimizer(cfg: TrainConfig) -> ClippedAdamW:
    return ClippedAdamW(cfg.learning_rate, cfg.weight_decay, cfg.clip_norm)


class Trainer:
    """Imperative shell around the train step.

    ``device``: the entry points' rule (CUDA unless ``"cpu"``; raises with no
    CUDA). ``generator``: a CPU ``torch.Generator`` for the flax-style
    initialisation (``manual_seed(0)`` when not given).
    """

    def __init__(self, sep: ConvTDFSeparator, cfg: Optional[TrainConfig] = None, mesh=None,
                 generator: Optional[torch.Generator] = None, device: object = "cuda") -> None:
        if mesh is not None:
            raise NotImplementedError(_MESH_ITEM)
        self.device = resolve_device(device)
        self.sep = sep
        self.cfg = cfg or TrainConfig()
        sep.init_params(generator if generator is not None else torch.Generator().manual_seed(0))
        sep.to(self.device)
        self.params = list(sep.net.parameters())
        self.optimizer = make_optimizer(self.cfg)
        self.opt_state = self.optimizer.init(self.params)
        self._loss_fn = self._make_loss_fn()
        self.step_count = 0

    def _make_loss_fn(self):
        return make_loss_fn(self.sep, self.cfg)

    def _flax_params(self) -> Dict:
        """The net's parameters as the flax tree the checkpoint holds."""
        return to_flax_params(self.sep.net.state_dict())

    def load_params(self, state: Dict[str, torch.Tensor]) -> None:
        """Start from these parameters (a ``ConvTDFNet`` state_dict); the
        optimizer state restarts fresh."""
        self.sep.net.load_state_dict(state, strict=True)
        self.opt_state = self.optimizer.init(self.params)

    def train_step(self, mix, vocal) -> Dict[str, float]:
        """One step on a (mix [B, S], vocal [B, S]) batch of numpy arrays or
        tensors; returns the metrics as floats. The ``torch.profiler`` spans
        ``upload``, ``loss``, ``backward``, ``optimizer`` and ``metrics`` (the
        wait for the card) split the step."""
        with record_function("upload"):
            mix = torch.as_tensor(mix, dtype=torch.float32).to(self.device)
            vocal = torch.as_tensor(vocal, dtype=torch.float32).to(self.device)
        with record_function("loss"):
            loss, metrics = self._loss_fn(mix, vocal)
        with record_function("backward"):
            # every parameter must get a gradient: autograd.grad raises otherwise
            grads = torch.autograd.grad(loss, self.params)
        with record_function("optimizer"):
            self.optimizer.apply(self.params, grads, self.opt_state)
        self.step_count += 1
        with record_function("metrics"):
            return {k: float(v.detach()) for k, v in metrics.items()}

    def save_checkpoint(self, path: str) -> None:
        if not str(path).endswith(".msgpack"):
            raise NotImplementedError(
                f"checkpoint {path}: the PyTorch port writes flax .msgpack checkpoints "
                "only (orbax directories: ROADMAP.md, queue 1, 'Other separator tiers')")
        from audio_cut_tpu_torch.models.flax_msgpack import write_flax_msgpack

        Path(path).write_bytes(write_flax_msgpack(self._flax_params()))
