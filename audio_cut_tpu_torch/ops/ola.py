"""Kernel K1: fused window-multiply + overlap-add (the iSTFT tail), and its
backward.

Counterpart of the TPU kernel ``audio_cut_tpu/ops/pallas/ola.py``
(``windowed_ola_pallas`` and its custom VJP ``_ola_bwd``). frames [..., N, L]
times window [L], overlap-added at ``hop`` (hop | L) -> [..., (N-1)*hop + L].

``windowed_ola`` launches the hand-written CUDA kernel (``csrc/ola.cu``) for
a CUDA tensor and takes the plain PyTorch version, ``windowed_ola_reference``,
only for a CPU tensor. There is no fallback from the kernel: a CUDA tensor
the kernel does not take raises.

Where autograd needs a gradient of the result, ``windowed_ola`` goes through
``WindowedOLA``, a ``torch.autograd.Function``: its forward is the same
launch, its backward the backward kernels of ``csrc/ola.cu`` on CUDA (K1B for
the frames, K1W for the window, the latter only when the window needs a
gradient; one launch each) and ``windowed_ola_backward_reference`` on the
CPU. K1W's grid comes from ``window_plan``, a pure function of the row
count, the frame length and the card's SM count. The kernel
writes into a fresh tensor through ``ctypes``, which autograd cannot see, so
the Function is what ties its output to the graph. Under ``no_grad`` or
``inference_mode`` (the serving path) the Function is not entered and
nothing is saved.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import torch

from audio_cut_tpu_torch.ops.cuda import CudaKernel
from audio_cut_tpu_torch.ops.stft import frame_signal, overlap_add

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
K1 = CudaKernel("ola", "windowed_ola_launch",
                [_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _PTR])
# the frames' gradient (every training step) ...
K1B = CudaKernel("ola", "ola_backward_frames_launch",
                 [_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _PTR])
# ... and the window's (only where the window is trained), one kernel that
# reduces the rows across a thread-block cluster
K1W = CudaKernel("ola", "ola_backward_window_launch",
                 [_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _PTR])

_MAX_GRID_Y = 65535  # K1 puts the batch on grid.y
# K1W's plan: blocks of 256 threads (csrc/ola.cu), column tiles of 32, 16 or
# 8 lanes of 4 columns (a warp's run of a row is 512, 256 or 128 B), clusters
# of at most 8 blocks (the portable size), about 1.5 blocks per SM
_WINDOW_THREADS = 256
_WINDOW_MAX_CLUSTER = 8
_WINDOW_BLOCKS_PER_SM = 1.5
_WINDOW_COL_LANES = (32, 16, 8)


@dataclass(frozen=True)
class WindowPlan:
    """K1W's grid: ``tiles`` column tiles of ``tile_cols`` columns, each a
    cluster of ``cluster`` blocks (ranks) of (tile_cols / 4 column lanes) x
    ``row_lanes`` threads. Lane q = rank * row_lanes + row lane sums rows
    [q * rows_per_lane, (q + 1) * rows_per_lane) of the B*N rows, clipped to
    them; rank k so owns ``rows_per_rank`` rows from k * rows_per_rank."""

    tile_cols: int
    row_lanes: int
    cluster: int
    rows_per_lane: int
    tiles: int

    @property
    def threads(self) -> int:
        return self.tile_cols // 4 * self.row_lanes

    @property
    def rows_per_rank(self) -> int:
        return self.row_lanes * self.rows_per_lane

    @property
    def blocks(self) -> int:
        return self.tiles * self.cluster

    def lane_rows(self, rows: int) -> Iterator[range]:
        """The rows of each lane of a tile, lane by lane (rank-major)."""
        for q in range(self.cluster * self.row_lanes):
            yield range(min(rows, q * self.rows_per_lane), min(rows, (q + 1) * self.rows_per_lane))


def window_plan(rows: int, frame_len: int, sm_count: int) -> WindowPlan:
    """K1W's plan for ``rows`` = B*N rows of ``frame_len`` columns on a card of
    ``sm_count`` SMs: the widest column tile that still gives about
    ``_WINDOW_BLOCKS_PER_SM`` blocks per SM with clusters of
    ``_WINDOW_MAX_CLUSTER``, then as many ranks a tile as that many blocks
    allow; every block resident at once."""
    if rows < 1 or frame_len < 1 or sm_count < 1:
        raise ValueError(f"K1W plan: rows {rows}, frame_len {frame_len}, SMs {sm_count}")
    target = max(1, int(_WINDOW_BLOCKS_PER_SM * sm_count))
    lanes = -(-frame_len // 4)  # column lanes of 4 columns
    for col_lanes in _WINDOW_COL_LANES:
        if -(-lanes // col_lanes) * _WINDOW_MAX_CLUSTER >= target:
            break
    col_lanes = min(col_lanes, -(-lanes // 8) * 8)
    tiles = -(-lanes // col_lanes)
    cluster = max(1, min(_WINDOW_MAX_CLUSTER, target // tiles))
    row_lanes = max(1, min(_WINDOW_THREADS // col_lanes, -(-rows // cluster)))
    return WindowPlan(tile_cols=4 * col_lanes, row_lanes=row_lanes, cluster=cluster,
                      rows_per_lane=-(-rows // (cluster * row_lanes)), tiles=tiles)


def windowed_ola_reference(frames: torch.Tensor, window: torch.Tensor, hop: int) -> torch.Tensor:
    """Plain PyTorch version: ``frames * window`` then ``overlap_add``."""
    return overlap_add(frames * window, hop)


def windowed_ola_backward_reference(
        g: torch.Tensor, frames: Optional[torch.Tensor], window: torch.Tensor, hop: int, *,
        frames_shape: Optional[torch.Size] = None, want_frames: bool = True,
        want_window: bool = True) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Plain backward, as ``_ola_bwd`` computes it: the cotangent re-framed
    at ``hop``, times the window (frames' gradient) and summed against the
    frames over every leading axis (window's gradient). An output not wanted
    is None and not computed; without the window's gradient ``frames`` may be
    None if ``frames_shape`` is given."""
    shape = frames.shape if frames_shape is None else frames_shape
    n, L = shape[-2], shape[-1]
    g_raw = frame_signal(g, L, hop, center=False)[..., :n, :]
    g_frames = g_raw * window if want_frames else None
    g_window = (g_raw * frames).sum(dim=tuple(range(g_raw.ndim - 1))) if want_window else None
    return g_frames, g_window


def _check(frames: torch.Tensor, window: torch.Tensor, hop: int) -> Tuple[int, int, int]:
    """(batch, N, L) of what the kernels take; raises on anything else."""
    if frames.device.type != "cuda" or window.device != frames.device:
        raise ValueError(f"K1 takes frames and window on one CUDA device, got "
                         f"{frames.device} and {window.device}")
    if frames.dtype != torch.float32 or window.dtype != torch.float32:
        raise TypeError(f"K1 takes float32, got {frames.dtype} and {window.dtype}")
    if not (frames.is_contiguous() and window.is_contiguous()):
        raise ValueError("K1 takes contiguous frames and window")
    return _geometry(frames.shape, window, hop)


def _geometry(frames_shape: torch.Size, window: torch.Tensor, hop: int) -> Tuple[int, int, int]:
    if len(frames_shape) not in (2, 3):
        raise ValueError(f"K1 takes [N, L] or [B, N, L] frames, got shape {tuple(frames_shape)}")
    n, L = frames_shape[-2], frames_shape[-1]
    batch = frames_shape[0] if len(frames_shape) == 3 else 1
    if hop <= 0 or L % hop:
        raise ValueError(f"K1 needs hop ({hop}) to divide the frame length ({L})")
    if window.shape != (L,):
        raise ValueError(f"window shape {tuple(window.shape)} != ({L},)")
    if n == 0 or batch == 0 or batch > _MAX_GRID_Y:
        raise ValueError(f"K1 takes 1..{_MAX_GRID_Y} rows of >= 1 frame, got {batch} x {n}")
    return batch, n, L


def _check_cotangent(g: torch.Tensor, frames_shape: torch.Size, window: torch.Tensor,
                     hop: int) -> Tuple[int, int, int]:
    """(batch, N, L) for a cotangent ``g`` of K1's output; raises on anything
    the backward kernels do not take."""
    if g.device.type != "cuda" or window.device != g.device:
        raise ValueError(f"K1 backward takes g and window on one CUDA device, got "
                         f"{g.device} and {window.device}")
    if g.dtype != torch.float32 or window.dtype != torch.float32:
        raise TypeError(f"K1 backward takes float32, got {g.dtype} and {window.dtype}")
    if not (g.is_contiguous() and window.is_contiguous()):
        raise ValueError("K1 backward takes a contiguous cotangent and window")
    batch, n, L = _geometry(frames_shape, window, hop)
    want = tuple(frames_shape[:-2]) + ((n - 1) * hop + L,)
    if tuple(g.shape) != want:
        raise ValueError(f"K1 backward: cotangent shape {tuple(g.shape)} != {want}")
    return batch, n, L


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def windowed_ola_cuda(frames: torch.Tensor, window: torch.Tensor, hop: int) -> torch.Tensor:
    """Launch K1 on ``torch.cuda.current_stream()``. frames [N, L] or [B, N, L]."""
    batch, n, L = _check(frames, window, hop)
    total = (n - 1) * hop + L
    out = torch.empty(frames.shape[:-2] + (total,), dtype=torch.float32, device=frames.device)
    K1.launch(frames.device, frames.data_ptr(), window.data_ptr(), out.data_ptr(), batch, n, L,
              hop, _stream(frames))
    return out


def ola_backward_frames_cuda(g: torch.Tensor, frames_shape: torch.Size, window: torch.Tensor,
                             hop: int) -> torch.Tensor:
    """Launch K1B: the frames' gradient ``frame(g) * window``, of ``frames_shape``."""
    batch, n, L = _check_cotangent(g, frames_shape, window, hop)
    out = torch.empty(frames_shape, dtype=torch.float32, device=g.device)
    K1B.launch(g.device, g.data_ptr(), window.data_ptr(), out.data_ptr(), batch, n, L, hop, _stream(g))
    return out


def ola_backward_window_cuda(g: torch.Tensor, frames: torch.Tensor, window: torch.Tensor,
                             hop: int) -> torch.Tensor:
    """Launch K1W: the window's gradient ``sum over (b, i) of frame(g) * frames``,
    in one launch, in the fixed order of ``window_plan`` for this card's SM
    count."""
    _check(frames, window, hop)
    batch, n, L = _check_cotangent(g, frames.shape, window, hop)
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    plan = window_plan(batch * n, L, sms)
    out = torch.empty((L,), dtype=torch.float32, device=g.device)
    K1W.launch(g.device, g.data_ptr(), frames.data_ptr(), out.data_ptr(), batch, n, L, hop,
               plan.tile_cols, plan.row_lanes, plan.cluster, plan.rows_per_lane, _stream(g))
    return out


class WindowedOLA(torch.autograd.Function):
    """K1 with its backward: CUDA kernels for CUDA tensors, the plain
    versions for CPU tensors."""

    @staticmethod
    def forward(ctx, frames: torch.Tensor, window: torch.Tensor, hop: int) -> torch.Tensor:
        ctx.hop = hop
        ctx.frames_shape = frames.shape
        # the frames are needed only for the window's gradient
        ctx.save_for_backward(frames if ctx.needs_input_grad[1] else None, window)
        return _forward(frames, window, hop)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        frames, window = ctx.saved_tensors
        hop, shape = ctx.hop, ctx.frames_shape
        want_frames, want_window = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        g = g.contiguous()
        if g.device.type == "cpu":
            g_frames, g_window = windowed_ola_backward_reference(
                g, frames, window, hop, frames_shape=shape, want_frames=want_frames,
                want_window=want_window)
            return g_frames, g_window, None
        g_frames: Optional[torch.Tensor] = None
        g_window: Optional[torch.Tensor] = None
        if want_frames:
            g_frames = ola_backward_frames_cuda(g, shape, window, hop)
        if want_window:
            g_window = ola_backward_window_cuda(g, frames, window, hop)
        return g_frames, g_window, None


def _forward(frames: torch.Tensor, window: torch.Tensor, hop: int) -> torch.Tensor:
    if frames.device.type == "cpu":
        return windowed_ola_reference(frames, window, hop)
    return windowed_ola_cuda(frames, window, hop)


def windowed_ola(frames: torch.Tensor, window: torch.Tensor, hop: int) -> torch.Tensor:
    """K1 for a CUDA tensor, the plain version for a CPU tensor; through
    ``WindowedOLA`` where autograd records a gradient."""
    if torch.is_grad_enabled() and (frames.requires_grad or window.requires_grad):
        return WindowedOLA.apply(frames, window, hop)
    return _forward(frames, window, hop)
