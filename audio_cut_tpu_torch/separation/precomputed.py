"""Engine seam of the batch: serve stems the mesh pass already computed.

Counterpart of ``audio_cut_tpu/separation/precomputed.py``.
``separate_and_segment_batch`` (``api.py``) separates every track in one
mesh pass (``parallel/batch.py:separate_tracks_mesh``), then runs each
track's pipeline with this object as the splitter's separator. The modes
reach the separation only through ``separate_on_device`` (the staged pass,
``separation/fused.py``) and ``separate_for_detection``; both hand back the
injected vocal, so detection and cutting see what a single engine run gives.

The mix is the engine's to the bit: the bucket-padded track, quantized and
dequantized as the engine uploads it (``engine.upload_pair`` and
``dequantize``), on the splitter's device. The vocal is padded with zeros
back to ``padded_track_len(n, sr, align)``, with the ``align`` of the mesh
pass's backend; the device stem handed out is its first n samples, as the
engine's is. There is no instrumental: the modes rebuild it as mix - vocal.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from audio_cut_tpu_torch.separation.engine import (
    SeparationResult,
    _estimate_confidence,
    dequantize,
    padded_track_len,
    upload_pair,
)


class PrecomputedStemEngine:
    """A ``SeparationEngine`` in place of the splitter's, over an injected
    vocal stem (a torch tensor on any device, or a host array)."""

    def __init__(
        self,
        sample_rate: int,
        device: torch.device,
        vocal,
        backend_name: str,
        meta: Optional[Dict[str, Any]] = None,
        align: int = 1,
    ) -> None:
        self.sample_rate = int(sample_rate)
        self.device = torch.device(device)
        self.align = int(align)
        self._vocal = torch.as_tensor(vocal, dtype=torch.float32)
        self._backend_name = str(backend_name)
        self._meta = dict(meta or {})
        self._meta.setdefault("gpu_pipeline_backend", self._backend_name)
        self._meta.setdefault("gpu_pipeline_mode", "mesh_batch_precomputed")
        self._meta.setdefault("gpu_pipeline_device", self.device.type)

    def padded_len(self, n: int) -> int:
        return padded_track_len(n, self.sample_rate, self.align)

    def mix_device(self, audio: np.ndarray) -> torch.Tensor:
        """The bucket-padded mix as the engine's upload leaves it on the device."""
        audio = np.asarray(audio, dtype=np.float32)
        return dequantize(*upload_pair(audio, self.padded_len(audio.shape[-1])), self.device)

    def vocal_device(self, n: int) -> torch.Tensor:
        """The vocal's first n samples, padded with zeros to ``padded_len(n)``,
        on the device."""
        vocal = self._vocal[:n].to(self.device)
        return torch.nn.functional.pad(vocal, (0, self.padded_len(n) - vocal.shape[-1]))

    def separate_on_device(self, audio: np.ndarray) -> Tuple[torch.Tensor, None, torch.Tensor, Dict]:
        """(vocal [n], no instrumental, padded mix, meta), as the engine's
        ``separate_on_device`` returns them."""
        n = np.asarray(audio).shape[-1]
        return self.vocal_device(n)[:n], None, self.mix_device(audio), dict(self._meta)

    def separate_for_detection(self, audio: np.ndarray,
                               need_instrumental: bool = True) -> SeparationResult:
        audio = np.asarray(audio, dtype=np.float32)
        vocal_dev, _, mix_dev, meta = self.separate_on_device(audio)
        vocal = vocal_dev.cpu().numpy() if need_instrumental else None
        result = SeparationResult(
            vocal_track=vocal,
            instrumental_track=None,
            backend_used=self._backend_name,
            separation_confidence=_estimate_confidence(audio, vocal) if vocal is not None else None,
            device_meta=meta,
        )
        if vocal is None:
            result._mix_energy = float(np.mean(np.square(audio)))
        result.vocal_device = vocal_dev
        result.mix_device = mix_dev
        return result
