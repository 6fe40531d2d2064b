"""Mask-graph statistics (counterpart of ``models/graph.py:51-376``).

Every quantity of the reference's per-mask histogram loop (reference
graph/construction.py:98-158) is a slice of one co-occurrence matrix

    c[m, m'] = #points of mask m (minus global boundary points)
               that carry mask id m' in frame(m'),

a counting product of two {0, 1} matrices over points (``ops/counting``).
From c: per-(mask, frame) visible counts and the "contained-by" top mask
(a segmented max over each frame's contiguous columns), the
undersegmentation verdicts and their undo, and the exact integer histogram
of the observer matrix that the percentile schedule reads.

All stage tensors are torch tensors on the caller's device; the mask table
is host numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from maskclustering_tpu_torch.ops import counting
from maskclustering_tpu_torch.ops.geometry import fma
from maskclustering_tpu_torch.utils.compile_cache import bucket_size, record_shape_bucket


class MaskTable(NamedTuple):
    """Host-side compact index of valid masks, padded to M_pad.

    Padding entries have frame = F (out of range) and id = -1 so they can
    never match a point. Masks are ordered by (frame, id): ascending and
    contiguous per frame, which the segmented max relies on.
    """

    frame: np.ndarray  # (M_pad,) int32
    mask_id: np.ndarray  # (M_pad,) int32, -1 for padding
    valid: np.ndarray  # (M_pad,) bool
    num_masks: int
    num_frames: int
    k_max: int

    @property
    def m_pad(self) -> int:
        return int(self.frame.shape[0])


def build_mask_table(mask_valid: np.ndarray, pad_multiple: int = 256) -> MaskTable:
    """Compact (frame, id) table of valid masks from (F, K_max+1) validity."""
    mask_valid = np.asarray(mask_valid)
    f_idx, k_idx = np.nonzero(mask_valid)
    num = len(f_idx)
    m_pad = bucket_size(num, pad_multiple)
    record_shape_bucket("masks", m_pad)
    frame = np.full(m_pad, mask_valid.shape[0], dtype=np.int32)
    mask_id = np.full(m_pad, -1, dtype=np.int32)
    frame[:num] = f_idx
    mask_id[:num] = k_idx
    valid = np.zeros(m_pad, dtype=bool)
    valid[:num] = True
    return MaskTable(frame=frame, mask_id=mask_id, valid=valid, num_masks=num,
                     num_frames=int(mask_valid.shape[0]), k_max=int(mask_valid.shape[1]) - 1)


class GraphStats(NamedTuple):
    """Everything the clustering stage needs, all (M_pad, ...) tensors."""

    visible: torch.Tensor  # (M_pad, F) bool — reference visible_frames (post-undo)
    contained: torch.Tensor  # (M_pad, M_pad) bool — reference contained_masks (post-undo)
    undersegment: torch.Tensor  # (M_pad,) bool
    n_tot: torch.Tensor  # (M_pad,) f32 valid-point count per mask
    observer_hist: torch.Tensor  # (F+1,) int32 histogram of observer counts


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 threshold as a tensor on ``like``'s device, so comparisons
    and divisions run in float32 as the JAX package's weak-typed scalars do
    (a CUDA division by a host scalar multiplies by its reciprocal)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def cooccurrence_counts(mask_of_point: torch.Tensor, boundary: torch.Tensor,
                        mask_frame: torch.Tensor, mask_id: torch.Tensor, point_chunk: int,
                        count_dtype: str = "bf16"):
    """(c, n_tot) by chunked counting products over the points given.

    ``c`` stays in the encoding's accumulator dtype (float32 for bf16,
    int32 for int8). Every entry is an exact integer below 2**24, so the
    counts of a column split of the points sum to the whole cloud's, in any
    order and any chunking: the fused mesh step sums point shards' partial
    counts so (``parallel/sharded.py``).
    """
    f, n = mask_of_point.shape
    m_pad = mask_frame.shape[0]
    safe_frame = torch.clamp(mask_frame.long(), max=f - 1)  # padding has frame == F
    mask_id = mask_id.to(mask_of_point.dtype)
    c = torch.zeros((m_pad, m_pad), dtype=counting.accumulator_dtype(count_dtype),
                    device=mask_of_point.device)
    n_tot = torch.zeros(m_pad, dtype=torch.float32, device=mask_of_point.device)
    for start in range(0, n, point_chunk):
        mc = mask_of_point[:, start:start + point_chunk]  # (F, Nc)
        bc = boundary[start:start + point_chunk]
        w_right = mc[safe_frame, :].T == mask_id[None, :]  # (Nc, M_pad)
        w_left = w_right & ~bc[:, None]
        c += counting.count_dot(w_left.T, w_right, count_dtype=count_dtype, out_dtype=None)
        n_tot += w_left.sum(dim=0).to(torch.float32)
    return c, n_tot


def frame_segment_stats(c: torch.Tensor, mask_frame: torch.Tensor, f: int, k_max: int):
    """Per-frame segmented (max, argmax, sum) over a count matrix's columns:
    ``(cmax, top_global, n_vis)``, each (rows, F).

    Each frame's masks occupy a contiguous column range
    [starts[j], starts[j+1]) of width <= k_max. An empty range gives
    cmax = -1, top = starts[j] and n_vis = 0, as in the JAX package. Ties
    go to the first (lowest-id) column.
    """
    rows = c.shape[0]
    dev = c.device
    starts = torch.searchsorted(mask_frame.contiguous(),
                                torch.arange(f + 1, dtype=mask_frame.dtype, device=dev))
    c_ext = torch.cat([c, torch.full((rows, k_max), -1.0, device=dev)], dim=1)
    lane = torch.arange(k_max, device=dev)
    cmax = torch.empty((rows, f), dtype=torch.float32, device=dev)
    top = torch.empty((rows, f), dtype=torch.int64, device=dev)
    n_vis = torch.empty((rows, f), dtype=torch.float32, device=dev)
    step = max(1, (1 << 24) // max(rows * k_max, 1))  # frames per gathered block
    for j0 in range(0, f, step):
        j1 = min(f, j0 + step)
        cols = starts[j0:j1, None] + lane[None, :]  # (Fc, k_max)
        valid_col = lane[None, :] < (starts[j0 + 1:j1 + 1] - starts[j0:j1])[:, None]
        sl = c_ext[:, cols]  # (rows, Fc, k_max)
        slm = torch.where(valid_col, sl, -1.0)
        best = slm.max(dim=2).values
        first = torch.where(slm == best[..., None], lane, k_max).min(dim=2).values
        cmax[:, j0:j1] = best
        top[:, j0:j1] = starts[j0:j1][None, :] + first
        n_vis[:, j0:j1] = torch.where(valid_col, sl, 0.0).sum(dim=2)
    return cmax, top, n_vis


def observer_histogram(observers: torch.Tensor, nbins: int) -> torch.Tensor:
    """Exact integer histogram of an observer-count matrix (values 0..nbins-1)."""
    return torch.bincount(observers.reshape(-1).long(), minlength=nbins)[:nbins].to(torch.int32)


def compute_graph_stats(
    mask_of_point: torch.Tensor,  # (F, N) int32, boundary-zeroed
    boundary: torch.Tensor,  # (N,) bool global boundary points
    mask_frame: torch.Tensor,  # (M_pad,) int32
    mask_id: torch.Tensor,  # (M_pad,) int32
    mask_active: torch.Tensor,  # (M_pad,) bool
    *,
    k_max: int = 127,
    point_chunk: int = 8192,
    mask_visible_threshold: float = 0.3,
    contained_threshold: float = 0.8,
    undersegment_filter_threshold: float = 0.3,
    big_mask_point_count: int = 500,
    count_dtype: str = "bf16",
) -> GraphStats:
    c, n_tot = cooccurrence_counts(mask_of_point, boundary, mask_frame, mask_id,
                                   point_chunk, count_dtype)
    return graph_stats_from_counts(
        c, n_tot, mask_frame, mask_active, num_frames=mask_of_point.shape[0], k_max=k_max,
        mask_visible_threshold=mask_visible_threshold, contained_threshold=contained_threshold,
        undersegment_filter_threshold=undersegment_filter_threshold,
        big_mask_point_count=big_mask_point_count, count_dtype=count_dtype)


def graph_stats_from_counts(
    c: torch.Tensor,  # (M_pad, M_pad) co-occurrence counts, any exact dtype
    n_tot: torch.Tensor,  # (M_pad,) f32 valid-point count per mask
    mask_frame: torch.Tensor,  # (M_pad,) int32
    mask_active: torch.Tensor,  # (M_pad,) bool
    *,
    num_frames: int,
    k_max: int = 127,
    mask_visible_threshold: float = 0.3,
    contained_threshold: float = 0.8,
    undersegment_filter_threshold: float = 0.3,
    big_mask_point_count: int = 500,
    count_dtype: str = "bf16",
) -> GraphStats:
    """The thresholds of :func:`compute_graph_stats` over its counts."""
    f = num_frames
    m_pad = mask_frame.shape[0]
    dev = c.device
    c = c.to(torch.float32)

    frame_onehot = mask_frame.long()[:, None] == torch.arange(f, device=dev)[None, :]
    cmax, top_global, n_vis = frame_segment_stats(c, mask_frame, f, k_max)

    # visibility / containment / undersegmentation (construction.py:112-132)
    vis_ratio = n_vis / torch.clamp(n_tot, min=1.0)[:, None]
    visible_test = ((vis_ratio >= _f32(mask_visible_threshold, c))
                    | (n_vis >= _f32(big_mask_point_count, c))) \
        & (n_vis > 0) & mask_active[:, None]
    contained_ratio = cmax / torch.clamp(n_vis, min=1.0)
    passes = contained_ratio > _f32(contained_threshold, c)
    visible = visible_test & passes  # the reference sets visible_frame only on pass
    split = visible_test & ~passes
    visible_num = visible_test.sum(dim=1).to(torch.float32)
    split_num = split.sum(dim=1).to(torch.float32)
    undersegment = mask_active & (
        (visible_num == 0)
        | (split_num > _f32(undersegment_filter_threshold, c) * visible_num))

    # contained[m, m*] = 1 where m* is the argmax mask of a visible frame;
    # column m_pad is the drop slot for frames that are not visible
    safe_top = torch.where(visible, top_global, m_pad)
    contained = torch.zeros((m_pad, m_pad + 1), dtype=torch.bool, device=dev)
    contained.scatter_(1, safe_top, True)
    contained = contained[:, :m_pad]

    # undo undersegmented observers (construction.py:163-169)
    u_cols = undersegment[None, :] & contained
    zap = counting.count_dot(u_cols, frame_onehot, count_dtype=count_dtype) > 0
    visible = visible & ~zap
    contained = contained & ~undersegment[None, :]

    observers = counting.count_dot(visible, visible.T, count_dtype=count_dtype)
    observer_hist = observer_histogram(observers, f + 1)
    return GraphStats(visible=visible, contained=contained, undersegment=undersegment,
                      n_tot=n_tot, observer_hist=observer_hist)


def observer_schedule_device(observer_hist: torch.Tensor, max_len: int = 20) -> torch.Tensor:
    """The float32 observer-percentile schedule (``graph.py:296-335``).

    Reference construction.py:80-96: percentiles 95..0 step -5 of the
    positive observer counts, linearly interpolated; a value <= 1 becomes 1
    while the percentile is >= 50 and ends the schedule below 50. Entries
    past the end are +inf. Same integer-rank split and float32 expressions
    as the JAX pipeline's jitted schedule, rounded as XLA:CPU compiles
    them: the division by the constant 100 becomes a product with its
    float32 reciprocal, and the interpolation's first product contracts
    into an FMA. So the values are bit-equal to the jitted program.
    """
    dev = observer_hist.device
    hist = observer_hist.to(torch.int32)
    cum = torch.cumsum(hist, dim=0, dtype=torch.int32)
    total = cum[-1]
    cnt = total - hist[0]  # positive observer pairs
    qs_i = torch.arange(95, -5, -5, dtype=torch.int32, device=dev)[:max_len]
    qs = qs_i.to(torch.float32)
    # rank = (total - cnt) + (cnt - 1) * q / 100 with cnt - 1 = 100 d + r,
    # so that no int32 product overflows at M_pad^2 scale
    cm1 = torch.clamp(cnt - 1, min=0)
    d, r = cm1 // 100, cm1 % 100
    rq = r * qs_i
    lo = (total - cnt) + d * qs_i + rq // 100
    frac = (rq % 100).to(torch.float32)
    frac = frac * torch.full_like(frac, float(np.float32(1) / np.float32(100)))
    lo = torch.minimum(torch.clamp(lo, min=0), total - 1)
    hi = torch.minimum(lo + 1, total - 1)
    v_lo = torch.searchsorted(cum, (lo + 1).contiguous(), side="left").to(torch.float32)
    v_hi = torch.searchsorted(cum, (hi + 1).contiguous(), side="left").to(torch.float32)
    one = torch.ones_like(frac)
    interp = fma(v_lo, one - frac, torch.where(hi > lo, v_hi, v_lo) * frac)
    le1 = interp <= 1.0
    clipped = torch.where(le1, one, interp)
    dead = (le1 & (qs < 50)) | (cnt == 0)
    stopped = torch.cumsum(dead.to(torch.int32), dim=0) > 0
    return torch.where(stopped, torch.full_like(clipped, float("inf")), clipped)


def observer_schedule(observer_hist, max_len: int = 20) -> np.ndarray:
    """Host float64 form of the schedule (``graph.py:338-376``): np.percentile
    semantics (linear interpolation) of the positive observer counts at
    95..0 step -5, padded to ``max_len`` with +inf."""
    hist = np.asarray(observer_hist, dtype=np.int64)
    cum = np.cumsum(hist)
    total = int(cum[-1])
    cnt_pos = total - int(hist[0])
    out = []
    if cnt_pos > 0:
        qs = list(range(95, -5, -5))
        pos = (total - cnt_pos) + (cnt_pos - 1) * (np.asarray(qs) / 100.0)
        lo = np.minimum(np.floor(pos).astype(np.int64), total - 1)
        hi = np.minimum(lo + 1, total - 1)
        v_lo = np.searchsorted(cum, lo + 1, side="left").astype(np.float64)
        v_hi = np.searchsorted(cum, hi + 1, side="left").astype(np.float64)
        frac = pos - lo
        interp = v_lo * (1.0 - frac) + np.where(hi > lo, v_hi, v_lo) * frac
        for q, val in zip(qs, interp):
            val = float(val)
            if val <= 1:
                if q < 50:
                    break
                val = 1.0
            out.append(val)
    sched = np.full(max_len, np.inf, dtype=np.float32)
    sched[: len(out)] = out[:max_len]
    return sched
