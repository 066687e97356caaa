"""Device selection for the port's entry points.

Counterpart of the device handling in ``audio_cut_tpu/utils/device.py``: the
port runs on CUDA unless the caller asks for the CPU (``device="cpu"``, or
``gpu_pipeline.prefer_device: cpu``). With no CUDA device and no explicit
``cpu``, it raises; it never carries on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(prefer: object) -> torch.device:
    """``gpu_pipeline.prefer_device`` -> a torch device: ``cuda`` (or
    ``cuda:N``) or ``cpu``. Raises when CUDA is asked for and absent."""
    name = str(prefer or "cuda").strip().lower()
    if name == "cpu":
        return torch.device("cpu")
    if name == "cuda" or name.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} asked for (gpu_pipeline.prefer_device) but torch sees "
                "no CUDA device; pass device='cpu' to run on the CPU")
        return torch.device(name)
    raise ValueError(f"gpu_pipeline.prefer_device must be 'cuda', 'cuda:N' or 'cpu', got {prefer!r}")


def indexed(device: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current device>``; any other device as it is. Two
    names of one card then compare (and key caches) equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
