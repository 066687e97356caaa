"""The device mesh of the batch entry point.

Counterpart of ``audio_cut_tpu/parallel/mesh.py:make_mesh``: an ordered list
of torch devices with its (dp, sp, tp) shape. Only dp is carried: the batch
splits its windows over the devices (``parallel/batch.py``). sp (one track's
windows over the devices) and tp (the model's channels) raise, and the JAX
package's XLA sharding specs (``batch_sharding``, ``param_shardings``,
``shard_batch_of_tracks``) have no reader in the port.

By default the mesh takes every CUDA device. It takes the CPU only when the
caller asks for ``"cpu"``; with no CUDA device and no explicit ``"cpu"`` it
raises, as ``utils/device.resolve_device`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import torch

from audio_cut_tpu_torch.utils.device import indexed, resolve_device

_SCALE_OUT = "ROADMAP.md, queue 1, 'Scale-out and shell'"


@dataclass(frozen=True)
class DeviceMesh:
    """``devices`` in mesh order, laid out as ``dp`` x ``sp`` x ``tp``."""

    devices: Tuple[torch.device, ...]
    dp: int
    sp: int = 1
    tp: int = 1

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(
    devices: Optional[Union[str, torch.device, Sequence[Union[str, torch.device]]]] = None,
    dp: Optional[int] = None,
    sp: int = 1,
    tp: int = 1,
) -> DeviceMesh:
    """A (dp, sp, tp) mesh over ``devices``: every CUDA device when None,
    one device for a single name (``"cpu"``, ``"cuda:1"``), else the list
    as given (``["cpu", "cpu"]`` is a two-device mesh on the CPU)."""
    if sp > 1 or tp > 1:
        raise NotImplementedError(
            f"a mesh with sp={sp}, tp={tp}: sequence and tensor parallel serving are not "
            f"in the PyTorch port yet: {_SCALE_OUT}")
    if devices is None:
        resolve_device("cuda")  # raises without CUDA
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devs = [indexed(resolve_device(str(devices)))]
    else:
        devs = [indexed(resolve_device(str(d))) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    n = len(devs)
    if dp is None:
        dp = n // (sp * tp)
    if dp * sp * tp != n:
        raise ValueError(f"mesh {dp}x{sp}x{tp} != {n} devices")
    return DeviceMesh(tuple(devs), dp, sp, tp)
