"""The batch's separation: many whole tracks over the devices of a mesh.

Counterpart of ``audio_cut_tpu/parallel/batch.py:separate_tracks_mesh``.
Each track keeps the OLA plan that a single engine run gives it
(``separation/engine.py:ola_plan`` at its ``padded_track_len``) and its int16
upload quantization, so its stems are the engine's up to the backend's
batch; detection and cutting downstream then match single calls.

Tracks are grouped by padded length. A group's windows, track after track in
plan order, are split into contiguous blocks, one per mesh device. Each
device dequantizes the tracks its block reads, runs
``backend.separate_windows`` on the block, weights the windows and adds them
in plan order into a flat ``[g * padded_len]`` buffer on that device (the
JAX package's ``scan``). The per-device buffers are summed on the first
device in mesh order, where the JAX package runs one ``psum``; with one
device that buffer is the sum, untouched. Then ``inv_wsum`` and the trim.
The plan, its weight rows and ``inv_wsum`` come from the engine's cached
whole-track layout on each device (``SeparationEngine._whole_layout``), so
a warm batch uploads only the tracks.

Not in the port (ROADMAP.md, queue 1, 'Scale-out and shell'): the JAX
package's ``separate_batch_sharded`` (one window a track, with no reader on
either entry point) and ``separate_track_sp_sharded`` (one track's windows
over the devices).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from audio_cut_tpu_torch.config import get_config
from audio_cut_tpu_torch.parallel.mesh import DeviceMesh, make_mesh
from audio_cut_tpu_torch.utils.device import indexed


def _backend_on(backend, device: torch.device, sample_rate: int):
    """``backend`` where it runs on ``device`` or holds no device (the
    spectral mask), else the same backend built on ``device``."""
    from audio_cut_tpu_torch.separation.backends import make_backend

    own = getattr(backend, "device", None)
    if own is None or indexed(own) == device:
        return backend
    return make_backend(backend.name, sample_rate, device)


def _device_ola(engine, block: List[Tuple[int, int]], uploads, layout: Dict,
                flat_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One device's share of a group: the windows ``block`` ((track row,
    window index) pairs) separated by ``engine``'s backend, weighted and
    added in order into flat [flat_len] stems on ``engine.device``."""
    from audio_cut_tpu_torch.separation.engine import dequantize

    device, padded_len, window = engine.device, layout["padded_len"], layout["window"]
    starts, weights = layout["groups"][0], layout["weights"][0]
    mixes = {row: dequantize(*uploads[row], device) for row in sorted({r for r, _ in block})}
    wins = torch.stack([mixes[row][starts[k]:starts[k] + window] for row, k in block])
    v, i = engine.backend.separate_windows(wins)
    vocal = torch.zeros(flat_len, dtype=torch.float32, device=device)
    inst = torch.zeros(flat_len, dtype=torch.float32, device=device)
    for j, (row, k) in enumerate(block):
        s = row * padded_len + starts[k]
        vocal[s:s + window] += v[j] * weights[k]
        inst[s:s + window] += i[j] * weights[k]
    return vocal, inst


@torch.inference_mode()
def separate_tracks_mesh(
    tracks: Sequence[np.ndarray],
    sample_rate: int,
    mesh: Optional[DeviceMesh] = None,
    backend=None,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Separate whole tracks over ``mesh`` (every CUDA device when None).

    ``backend`` is a backend instance, or the name of one (None: the
    config's ``enhanced_separation.backend``), built on the mesh's first
    device. Returns (vocal, instrumental) per track in input order, each of
    the track's true length, on the mesh's first device.
    """
    from audio_cut_tpu_torch.separation.backends import make_backend
    from audio_cut_tpu_torch.separation.engine import (
        SeparationEngine,
        padded_track_len,
        upload_pair,
    )

    mesh = mesh if mesh is not None else make_mesh()
    sr = int(sample_rate)
    first = mesh.devices[0]
    if backend is None or isinstance(backend, str):
        backend = make_backend(
            backend or str(get_config("enhanced_separation.backend", "convtdf")), sr, first)
    if not hasattr(backend, "separate_windows"):
        raise ValueError(f"backend {backend.name!r} has no batched windows path")
    engines = {d: SeparationEngine(sr, d, backend=_backend_on(backend, d, sr))
               for d in mesh.devices}
    align = engines[first]._geometry()[3]

    tracks = [np.asarray(t, dtype=np.float32) for t in tracks]
    groups: Dict[int, List[int]] = {}
    for idx, t in enumerate(tracks):
        groups.setdefault(padded_track_len(t.shape[-1], sr, align), []).append(idx)

    out: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = [None] * len(tracks)
    for padded_len, idxs in sorted(groups.items()):
        layouts = {d: e._whole_layout(padded_len) for d, e in engines.items()}
        uploads = [upload_pair(tracks[idx], padded_len) for idx in idxs]
        order = [(row, k) for row in range(len(idxs)) for k in range(layouts[first]["n_chunks"])]
        per = -(-len(order) // mesh.size)
        flat_len = len(idxs) * padded_len
        vocal = inst = None
        for d, device in enumerate(mesh.devices):
            block = order[d * per:(d + 1) * per]
            if not block:
                continue
            v, i = _device_ola(engines[device], block, uploads, layouts[device], flat_len)
            if vocal is None:  # the first device's block: never empty
                vocal, inst = v, i
            else:
                vocal, inst = vocal + v.to(first), inst + i.to(first)
        norm = layouts[first]["inv_wsum"]
        vocal = vocal.view(len(idxs), padded_len) * norm
        inst = inst.view(len(idxs), padded_len) * norm
        for row, idx in enumerate(idxs):
            n = tracks[idx].shape[-1]
            out[idx] = (vocal[row, :n], inst[row, :n])
    return out  # type: ignore[return-value]
