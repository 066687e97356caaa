"""K1W's plan and the order of its sums, on the CPU.

K1W (the window's gradient of K1, ``csrc/ola.cu``) runs only on the card,
but what fixes its result is its plan, ``window_plan``: the column tiles,
the cluster of row ranks, the row lanes of a block and the rows of each
lane. These tests hold the plan to what the kernel needs (every row summed
once, in rank order; a cluster of at most 8 blocks; a block of at most 256
threads; a grid within CUDA's limits) and emulate the kernel's order of the
sums (rows in order within a lane, each a fused multiply-add; then the lanes
of a rank in order; then the ranks in order) against the plain backward and
the JAX package's VJP ``_ola_bwd``.

Tolerance: per column, 1e-5 of sum_{b,i} |g * frames| (``OLA_BWD_RTOL`` of
``chip_smoke.py``). The three sum the same float32 products in other
orders, which moves a sum of n terms by at most about n * 6e-8 of that
scale; n is at most 21 here.
"""

import numpy as np
import pytest
import torch

from audio_cut_tpu_torch.ops.ola import WindowPlan, window_plan, windowed_ola_backward_reference
from audio_cut_tpu_torch.ops.stft import frame_signal

OLA_BWD_RTOL = 1e-5
MAX_CLUSTER = 8            # the portable cluster size
MAX_THREADS = 256          # K1W's block (its shared memory is sized for it)
MAX_GRID_X = 2 ** 31 - 1
TRAIN_L, TRAIN_HOP = 6144, 1024  # the training shape's columns: ConvTDF-large's n_fft, hop


@pytest.mark.parametrize("sm_count", [132, 114, 1])
@pytest.mark.parametrize("frame_len", [90, 256, 512, 6144])
@pytest.mark.parametrize("rows", [1, 7, 512, 1024, 4097])
def test_window_plan_covers_every_row_once_within_the_limits(rows, frame_len, sm_count):
    plan = window_plan(rows, frame_len, sm_count)
    lanes = list(plan.lane_rows(rows))
    assert len(lanes) == plan.cluster * plan.row_lanes
    # the lanes, rank-major, are contiguous, in order, and cover each row once
    assert [r for lane in lanes for r in lane] == list(range(rows))
    for k in range(plan.cluster):
        rank = [r for lane in lanes[k * plan.row_lanes:(k + 1) * plan.row_lanes] for r in lane]
        lo, hi = min(rows, k * plan.rows_per_rank), min(rows, (k + 1) * plan.rows_per_rank)
        assert rank == list(range(lo, hi))
    assert 1 <= plan.cluster <= MAX_CLUSTER
    assert plan.tile_cols % 4 == 0 and 1 <= plan.threads <= MAX_THREADS
    # every tile holds columns, and the tiles cover the frame
    assert (plan.tiles - 1) * plan.tile_cols < frame_len <= plan.tiles * plan.tile_cols
    assert plan.blocks <= MAX_GRID_X
    # the clusters fit about 1.5 blocks per SM; only tiles alone may outnumber that
    assert plan.cluster == 1 or plan.blocks <= 1.5 * sm_count


def test_window_plan_at_the_training_shape():
    """[4, 128, 6144] on an H100's 132 SMs: 48 tiles of 128 columns x 4 ranks,
    192 blocks of 32 column lanes (a warp a row) x 8 row lanes, 16 rows a lane."""
    plan = window_plan(4 * 128, TRAIN_L, 132)
    assert plan == WindowPlan(tile_cols=128, row_lanes=8, cluster=4, rows_per_lane=16, tiles=48)
    assert (plan.blocks, plan.threads, plan.rows_per_rank) == (192, 256, 128)
    assert TRAIN_L % plan.tile_cols == 0


def test_window_plan_rejects_what_it_cannot_plan():
    for args in ((0, 6144, 132), (4, 0, 132), (4, 6144, 0)):
        with pytest.raises(ValueError):
            window_plan(*args)


def _kernel_order(g: torch.Tensor, frames: torch.Tensor, hop: int, plan: WindowPlan):
    """K1W's sum in the kernel's order: per lane its rows in order, each a
    fused multiply-add (the exact float64 product added to the float32 sum,
    rounded once); per rank its lanes in order; then the ranks in order."""
    n, L = frames.shape[-2:]
    raw = frame_signal(g, L, hop, center=False)[..., :n, :].reshape(-1, L).double()
    f = frames.reshape(-1, L).double()
    lane_sums = []
    for lane in plan.lane_rows(raw.shape[0]):
        acc = torch.zeros(L, dtype=torch.float32)
        for r in lane:
            acc = (acc.double() + raw[r] * f[r]).float()
        lane_sums.append(acc)
    ranks = []
    for k in range(plan.cluster):
        s = lane_sums[k * plan.row_lanes]
        for lane_sum in lane_sums[k * plan.row_lanes + 1:(k + 1) * plan.row_lanes]:
            s = s + lane_sum
        ranks.append(s)
    out = ranks[0]
    for s in ranks[1:]:
        out = out + s
    return out


@pytest.mark.parametrize("sm_count", [132, 1])
@pytest.mark.parametrize("batch, n", [(1, 1), (2, 5), (3, 7)])
def test_kernel_order_matches_plain_backward_and_jax(batch, n, sm_count):
    jnp = pytest.importorskip("jax.numpy")
    from audio_cut_tpu.ops.pallas.ola import _ola_bwd

    rng = np.random.default_rng(batch * 10 + n)
    frames = rng.standard_normal((batch, n, TRAIN_L)).astype(np.float32)
    window = rng.uniform(0.0, 1.0, TRAIN_L).astype(np.float32)
    g = rng.standard_normal((batch, (n - 1) * TRAIN_HOP + TRAIN_L)).astype(np.float32)
    f_t, w_t, g_t = (torch.from_numpy(x) for x in (frames, window, g))
    plan = window_plan(batch * n, TRAIN_L, sm_count)

    got = _kernel_order(g_t, f_t, TRAIN_HOP, plan)
    _, plain = windowed_ola_backward_reference(g_t, f_t, w_t, TRAIN_HOP, want_frames=False)
    _, want_j = _ola_bwd(TRAIN_HOP, (jnp.asarray(frames), jnp.asarray(window)), jnp.asarray(g))
    raw = frame_signal(g_t, TRAIN_L, TRAIN_HOP, center=False)[..., :n, :]
    scale = (raw * f_t).abs().sum(dim=(0, 1)).numpy()
    assert got.shape == (TRAIN_L,) and got.dtype == torch.float32
    for want in (plain.numpy(), np.asarray(want_j)):
        assert np.all(np.abs(got.numpy() - want) <= OLA_BWD_RTOL * scale)
