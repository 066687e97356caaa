"""On-device PCM quantization: PCM_24 for stem export, PCM_16 for the ASR copy.

Counterpart of ``audio_cut_tpu/ops/pcm.py``: the vocal stem is packed into
24-bit PCM byte planes on the device, so 3 bytes a sample cross to the host
instead of 4; the 16 kHz ASR copy is rounded to int16 on the device. ``torch.round``, like ``jnp.round``, rounds the float32
product half to even. The host codec (``io/wavio.py``) rounds the float64
product, so the two can differ by one 24-bit LSB on loud samples;
``pcm24_planes_to_float`` returns exactly what the written file decodes to.
"""

from __future__ import annotations

import numpy as np
import torch

_SCALE = 8388607.0  # the host codec's scale (io/wavio.py)


def pcm24_pack_graph(x: torch.Tensor) -> torch.Tensor:
    """float stem [n] -> uint8 planes [3, n] (little-endian byte planes)."""
    q = torch.clamp(torch.round(torch.clamp(x, -1.0, 1.0) * _SCALE), -8388608.0, 8388607.0)
    u = q.to(torch.int32)
    # arithmetic shifts of the two's-complement int32 give the same low 24
    # bits as the JAX package's uint32 shifts
    return torch.stack([(u >> s) & 0xFF for s in (0, 8, 16)]).to(torch.uint8)


def pcm16_pack_graph(x: torch.Tensor) -> torch.Tensor:
    """float waveform [n] -> int16 [n] on the PCM_16 grid (scale 32767; the
    float32 product rounded half to even, as ``jnp.round`` does)."""
    q = torch.clamp(torch.round(torch.clamp(x, -1.0, 1.0) * 32767.0), -32768.0, 32767.0)
    return q.to(torch.int16)


def pcm24_planes_to_payload(planes: np.ndarray) -> bytes:
    """uint8 planes [3, n] -> packed little-endian 24-bit PCM payload."""
    planes = np.asarray(planes)
    return np.ascontiguousarray(planes.T).tobytes()


def pcm24_planes_to_float(planes: np.ndarray) -> np.ndarray:
    """uint8 planes [3, n] -> float32, exactly what the written file decodes
    to (the 1/8388607 scale of ``io/wavio.py``)."""
    planes = np.asarray(planes)
    i32 = (
        planes[0].astype(np.int32)
        | (planes[1].astype(np.int32) << 8)
        | (planes[2].astype(np.int32) << 16)
    )
    i32 = (i32 ^ 0x800000) - 0x800000  # sign-extend 24-bit
    return (i32.astype(np.float64) / _SCALE).astype(np.float32)
