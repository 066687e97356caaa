"""Cut-point refinement: NMS, zero-crossing snap, quiet guards.

Counterpart of ``audio_cut_tpu/cutting/refine.py``: score-ordered min-gap
NMS with per-window caps, the vocal-then-mix guard stages, the rightward
quiet search, the boundary/min-gap filter, ``CutAdjustment`` bookkeeping,
the suppressed points, and ``vpbd_asr``'s restore of guard moves that land
inside a recognised word. Host numpy, as in the JAX package.

The quiet guards read the detection bundle's decimated dB grids
(``QuietLookup(db_grid=...)``); the port has no host-waveform lookup, so
``finalize_cut_points`` takes both lookups whenever its guards are on. The
zero-crossing snap runs on the host mix, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

_EPS = 1e-12


@dataclass
class CutPoint:
    t: float
    score: float
    kind: str = "pause"


@dataclass
class CutContext:
    sr: int
    mix_wave: np.ndarray


@dataclass
class CutAdjustment:
    raw_time: float
    guard_time: float
    final_time: float
    score: float
    guard_shift_ms: float
    final_shift_ms: float

    def to_dict(self) -> Dict[str, float]:
        return {
            "raw_time": self.raw_time,
            "guard_time": self.guard_time,
            "final_time": self.final_time,
            "score": self.score,
            "guard_shift_ms": self.guard_shift_ms,
            "final_shift_ms": self.final_shift_ms,
        }


@dataclass
class CutRefineResult:
    final_points: List[CutPoint]
    sample_boundaries: List[int]
    adjustments: List[CutAdjustment]
    suppressed_points: List[CutPoint] = field(default_factory=list)


def _ensure_mono(wave: Optional[np.ndarray]) -> Optional[np.ndarray]:
    if wave is None:
        return None
    w = np.asarray(wave)
    if w.ndim == 2:
        return np.mean(w, axis=-1 if w.shape[-1] <= 2 else 0).astype(np.float32)
    return w.reshape(-1).astype(np.float32, copy=False)


class QuietLookup:
    """A track's RMS-dB grid, decimated by ``stride`` samples, queried on the
    host for rightward quiet searches."""

    def __init__(
        self,
        *,
        db_grid: np.ndarray,
        stride: int,
        sr: int = 44100,
        floor_db: Optional[float] = -60.0,
        floor_percentile: float = 0.5,
    ):
        self.sr = sr
        self.rms_db = np.asarray(db_grid)
        self.stride = int(stride)
        if floor_db is None:
            floor_db = float(np.percentile(self.rms_db, floor_percentile))
        self.floor_db = float(floor_db)

    def guard_right(self, times: np.ndarray, max_shift_ms: float, guard_db: float) -> np.ndarray:
        """Vectorised rightward quiet search for all cut times at once."""
        if times.size == 0:
            return times
        n = self.rms_db.size
        grid_sr = self.sr / self.stride
        span = max(1, int(round(max_shift_ms / 1000.0 * grid_sr)))
        idx = np.clip(np.round(times * grid_sr).astype(np.int64), 0, n - 1)
        offs = np.arange(span)
        win_idx = np.minimum(idx[:, None] + offs[None, :], n - 1)       # [K, span]
        win_db = self.rms_db[win_idx]
        orig_db = self.rms_db[idx]
        # the nearest offset that satisfies the quiet conditions, not the
        # quietest one: the precision gate budgets displacement
        qualify = ((orig_db[:, None] - win_db) >= guard_db) & (win_db <= self.floor_db)
        # staying put is no adjustment: drop offset 0 and every end-of-array
        # column that clamps back onto idx
        qualify &= win_idx != idx[:, None]
        accept = qualify.any(axis=1)
        best_off = np.argmax(qualify, axis=1)                           # first True
        target_idx = np.minimum(idx + best_off, n - 1)
        return np.where(accept, target_idx.astype(np.float64) / grid_sr, times)


def align_to_zero_cross_many(
    wave: Optional[np.ndarray], sr: int, times: np.ndarray, win_ms: float = 8.0
) -> np.ndarray:
    """Snap every time to its nearest zero crossing (sub-sample interpolated)."""
    wave = _ensure_mono(wave)
    if wave is None or wave.size < 3 or sr <= 0 or times.size == 0:
        return times
    n = wave.size
    half = max(1, int(round(win_ms / 1000.0 * sr)))
    idx = np.round(times * sr).astype(np.int64)
    valid = (idx > 0) & (idx < n)

    lo = np.clip(idx - half, 1, n - 1)
    width = 2 * half + 1
    offs = np.arange(width)
    pos = np.minimum(lo[:, None] + offs[None, :], n - 1)               # [K, W]
    left = wave[pos - 1]
    right = wave[pos]
    crossing = (left == 0.0) | (right == 0.0) | (left * right < 0.0)
    denom = np.abs(left) + np.abs(right)
    frac = np.where(denom > _EPS, np.abs(left) / np.maximum(denom, _EPS), 0.5)
    zero_pos = np.where(left == 0.0, (pos - 1).astype(np.float64), (pos - 1) + frac)
    zero_pos = np.where(right == 0.0, pos.astype(np.float64), zero_pos)
    dist = np.where(crossing, np.abs(zero_pos - idx[:, None]), np.inf)
    best = np.argmin(dist, axis=1)
    rows = np.arange(times.size)
    found = np.isfinite(dist[rows, best])
    snapped = zero_pos[rows, best] / float(sr)
    return np.where(valid & found, snapped, times)


def nms_min_gap(
    points: Iterable[CutPoint],
    min_gap_s: float,
    topk: Optional[int] = None,
    *,
    max_per_window: Optional[int] = None,
    window_s: float = 10.0,
) -> List[CutPoint]:
    """Greedy score-ordered suppression with a min time gap and a per-window cap."""
    ordered = sorted(points, key=lambda p: p.score, reverse=True)
    kept: List[CutPoint] = []
    kept_times: List[float] = []
    window_counts: Dict[int, int] = {}
    span = max(window_s, min_gap_s, 1e-6)
    for p in ordered:
        if kept_times and np.min(np.abs(np.asarray(kept_times) - p.t)) < min_gap_s:
            continue
        bucket = int(p.t // span) if max_per_window is not None else None
        if bucket is not None and window_counts.get(bucket, 0) >= max_per_window:
            continue
        kept.append(p)
        kept_times.append(p.t)
        if bucket is not None:
            window_counts[bucket] = window_counts.get(bucket, 0) + 1
        if topk is not None and len(kept) >= topk:
            break
    return sorted(kept, key=lambda p: p.t)


def _filter_cut_times(
    times: Sequence[float], *, duration_s: float, min_gap_s: float, min_boundary_s: float
) -> List[float]:
    out: List[float] = []
    if duration_s <= 0.0:
        return out
    boundary = min(min_boundary_s, duration_s / 2.0)
    for t in sorted(times):
        if t <= boundary or t >= duration_s - boundary:
            continue
        if out and (t - out[-1]) < min_gap_s:
            continue
        out.append(t)
    return out


def finalize_cut_points(
    ctx: CutContext,
    raw_points: Iterable[CutPoint],
    *,
    vocal_lookup: Optional[QuietLookup],
    mix_lookup: Optional[QuietLookup],
    min_gap_s: float = 1.0,
    max_keep: Optional[int] = None,
    topk_per_10s: Optional[int] = None,
    nms_window_s: float = 10.0,
    guard_db: float = 2.0,
    search_right_ms: float = 150.0,
    enable_mix_guard: bool = True,
    enable_vocal_guard: bool = True,
    zero_cross_win_ms: float = 8.0,
    min_boundary_s: float = 0.5,
) -> CutRefineResult:
    """NMS -> vocal quiet guard -> mix zero-cross snap -> mix quiet guard -> filter."""
    sr = ctx.sr
    mix = _ensure_mono(ctx.mix_wave)
    duration_s = mix.size / float(sr) if mix is not None and sr > 0 else 0.0

    if mix is None or mix.size == 0 or sr <= 0:
        return CutRefineResult([], [0, 0 if mix is None else mix.size], [])

    base = list(raw_points)
    if not base:
        return CutRefineResult([], [0, mix.size], [])
    if (enable_vocal_guard and vocal_lookup is None) or (enable_mix_guard and mix_lookup is None):
        raise ValueError("the quiet guards read the bundle's dB grids: pass vocal_lookup and "
                         "mix_lookup, or turn the guard off")

    cap = topk_per_10s if (topk_per_10s or 0) > 0 else None
    pruned = nms_min_gap(base, min_gap_s=min_gap_s, topk=max_keep, max_per_window=cap, window_s=nms_window_s)
    kept_ids = {id(p) for p in pruned}
    suppressed = [CutPoint(float(p.t), float(p.score), p.kind) for p in base if id(p) not in kept_ids]

    raw_times = np.asarray([p.t for p in pruned], dtype=np.float64)
    scores = np.asarray([p.score for p in pruned], dtype=np.float64)

    # stage 1: the vocal quiet guard, from the vocal dB grid
    guard_times = raw_times.copy()
    if enable_vocal_guard:
        guard_times = vocal_lookup.guard_right(guard_times, search_right_ms, guard_db)

    # stage 2: mix zero-cross + mix quiet guard
    final_times = align_to_zero_cross_many(mix, sr, guard_times, zero_cross_win_ms)
    if enable_mix_guard:
        final_times = mix_lookup.guard_right(final_times, search_right_ms, guard_db)
    final_times = np.clip(final_times, 0.0, max(duration_s, 0.0))

    adjustments = [
        CutAdjustment(
            raw_time=float(rt),
            guard_time=float(gt),
            final_time=float(ft),
            score=float(sc),
            guard_shift_ms=float((gt - rt) * 1000.0),
            final_shift_ms=float((ft - rt) * 1000.0),
        )
        for rt, gt, ft, sc in zip(raw_times, guard_times, final_times, scores)
    ]

    kept_times = _filter_cut_times(
        final_times.tolist(), duration_s=duration_s, min_gap_s=min_gap_s, min_boundary_s=min_boundary_s
    )
    kept_adjustments: List[CutAdjustment] = []
    if adjustments:
        finals = np.asarray([a.final_time for a in adjustments])
        for t in kept_times:
            kept_adjustments.append(adjustments[int(np.argmin(np.abs(finals - t)))])

    final_points = [CutPoint(t=float(t), score=1.0) for t in kept_times]
    boundaries = sorted({0, mix.size, *(int(round(t * sr)) for t in kept_times)})
    return CutRefineResult(final_points, boundaries, kept_adjustments, suppressed)


def merge_word_intervals(word_intervals) -> List[Tuple[float, float]]:
    """Merge overlapping/touching (start, end) intervals into a disjoint
    sorted list. ASR word intervals DO overlap (layered/backing vocals);
    searchsorted-based inside-word checks are only correct on disjoint
    intervals — an overlapped longer word would otherwise be missed."""
    iv = sorted((float(a), float(b)) for a, b in word_intervals)
    merged: List[Tuple[float, float]] = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def inside_word_check(word_intervals) -> Callable[[float], bool]:
    """A predicate: is ``t`` strictly inside one of the (merged) words?"""
    if not word_intervals:
        return lambda t: False
    iv = merge_word_intervals(word_intervals)  # overlapping words happen
    word_starts = np.asarray([a for a, _ in iv])
    word_ends = np.asarray([b for _, b in iv])

    def inside(t: float) -> bool:
        k = int(np.searchsorted(word_starts, t, side="right")) - 1
        return k >= 0 and word_starts[k] < t < word_ends[k]

    return inside


def restore_guards_outside_words(
    cut_times: Sequence[float],
    adjustments: Sequence[CutAdjustment],
    word_intervals: Sequence[Tuple[float, float]],
    *,
    duration_s: float,
    sr: int,
    min_gap_s: float,
) -> Tuple[List[float], Optional[List[CutAdjustment]], int]:
    """Undo guard moves that push a boundary from outside an ASR word into one.

    Applied on ``vpbd_asr`` only: a quiet-guard shift is meant to land in
    silence; if it lands strictly inside a recognised word while the raw
    candidate was outside every word, the raw time was the better boundary.
    Each restore must keep the min-gap invariant against its neighbours;
    restored adjustments become zero-shift entries, so the guard statistics
    stay honest.

    Returns (times, adjustments or None when unchanged, restored count).
    """
    times = sorted(float(t) for t in cut_times)
    if not times or not adjustments or not word_intervals:
        return times, None, 0

    _inside = inside_word_check(word_intervals)

    def _key(t: float) -> int:
        return int(round(t * sr))

    points = sorted({_key(t) for t in times if 0 < _key(t) < _key(duration_s)})
    min_gap = max(0, int(round(min_gap_s * sr)))
    restored_raw: set = set()

    for adj in adjustments:
        raw_t, final_t = float(adj.raw_time), float(adj.final_time)
        if not _inside(final_t) or _inside(raw_t):
            continue
        raw_sample, final_sample = _key(raw_t), _key(final_t)
        if final_sample not in points or raw_sample in (0, _key(duration_s)):
            continue
        candidate = sorted(raw_sample if p == final_sample else p for p in points)
        idx = candidate.index(raw_sample)
        left_ok = idx == 0 or candidate[idx] - candidate[idx - 1] >= min_gap
        right_ok = idx == len(candidate) - 1 or candidate[idx + 1] - candidate[idx] >= min_gap
        if not (left_ok and right_ok):
            continue
        points = candidate
        restored_raw.add(raw_t)

    if not restored_raw:
        return times, None, 0

    new_adjustments = [
        CutAdjustment(
            raw_time=a.raw_time, guard_time=a.raw_time, final_time=a.raw_time,
            score=a.score, guard_shift_ms=0.0, final_shift_ms=0.0,
        )
        if float(a.raw_time) in restored_raw
        else a
        for a in adjustments
    ]
    return [p / float(sr) for p in points], new_adjustments, len(restored_raw)


def guard_shift_stats(adjustments: Sequence[CutAdjustment]) -> Dict[str, float]:
    """avg/max/p95 |final shift| in ms, and the count."""
    if not adjustments:
        return {"count": 0, "avg_ms": 0.0, "max_ms": 0.0, "p95_ms": 0.0}
    shifts = np.abs(np.asarray([a.final_shift_ms for a in adjustments]))
    return {
        "count": int(shifts.size),
        "avg_ms": float(shifts.mean()),
        "max_ms": float(shifts.max()),
        "p95_ms": float(np.percentile(shifts, 95)),
    }
