"""Training for the waveform-domain separator (WaveUNet).

Counterpart of ``audio_cut_tpu/training/wave_trainer.py``. Loss = waveform
L1 + multi-resolution STFT magnitude L1 + the pause-suppression RMS (the
standard waveform-separator recipe: time-domain accuracy alone lets the net
smear transients; the spectral terms anchor timbre at several analysis
scales). The STFTs are forward only, so a step launches none of K1's
kernels. The optimizer, the step and the msgpack checkpoint are the ConvTDF
trainer's (``trainer.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from audio_cut_tpu_torch.models.waveunet import WaveUNetSeparator, to_flax_params
from audio_cut_tpu_torch.ops.stft import stft
from audio_cut_tpu_torch.training.trainer import (
    _MESH_ITEM, TrainConfig, Trainer, pause_suppression_rms)

STFT_SCALES = ((512, 128), (2048, 512))


def make_wave_loss_fn(sep: WaveUNetSeparator, cfg: TrainConfig, mesh=None
                      ) -> Callable[[torch.Tensor, torch.Tensor],
                                    Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """``loss_fn(mix, vocal_target) -> (loss, metrics)`` over ``sep``'s net
    parameters, as the JAX package's ``make_wave_loss_fn`` computes it."""
    if mesh is not None:
        raise NotImplementedError(_MESH_ITEM)

    def loss_fn(mix: torch.Tensor, vocal_target: torch.Tensor):
        length = mix.shape[-1]
        pred, _ = sep.separate_fn(mix, length)
        tgt = vocal_target[..., :length]
        wave_l1 = torch.mean(torch.abs(pred - tgt))
        spec_l1 = 0.0
        for n_fft, hop in STFT_SCALES:
            pm = torch.abs(stft(pred, n_fft=n_fft, hop=hop))
            tm = torch.abs(stft(tgt, n_fft=n_fft, hop=hop))
            spec_l1 = spec_l1 + torch.mean(torch.abs(pm - tm))
        spec_l1 = spec_l1 / len(STFT_SCALES)
        pause_rms = pause_suppression_rms(pred, tgt, cfg)
        loss = (cfg.wave_loss_weight * wave_l1
                + cfg.spec_loss_weight * spec_l1
                + cfg.pause_loss_weight * pause_rms)
        return loss, {"loss": loss, "spec_l1": spec_l1, "wave_l1": wave_l1,
                      "pause_rms": pause_rms}

    return loss_fn


class WaveTrainer(Trainer):
    """The ConvTDF trainer's shell (``Trainer``) with the wave-domain loss
    and the WaveUNet's parameter tree; a mesh raises, as there."""

    def _make_loss_fn(self):
        return make_wave_loss_fn(self.sep, self.cfg)

    def _flax_params(self) -> Dict:
        return to_flax_params(self.sep.net.state_dict())
