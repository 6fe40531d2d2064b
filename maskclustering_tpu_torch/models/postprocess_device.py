"""Device-resident post-process: split + merge as tensor passes.

Counterpart of ``maskclustering_tpu/models/postprocess_device.py:84-872``,
the default rung (``device_postprocess=True``). Everything up to the final
compact instances runs on the device and the (F, N) claim planes are read
in place, never pulled:

- ``_prep_kernel``: the live-representative routing tables, sized by the
  live count (a 4-byte pull from ``_live_count_kernel``);
- ``_node_stats_kernel``: per (live rep, point) whether the point is a node
  point and whether it passes the detection-ratio test (reference
  post_process.py:56-76);
- ``_dbscan_split_kernel``: the node point sets of every live rep split by
  the grid DBSCAN (``ops/grid_dbscan.py``), pairs compacted in ascending
  (rep, point) order;
- ``_group_structs_kernel``: group sizes, membership planes, bounding boxes
  and per-mask group ranges as scatters through dump slots;
- ``_mask_group_counts_impl``: each mask's best group, by counting products
  of one-hot claim planes against the group membership plane;
- ``_survivor_gather_kernel``: the surviving objects' bit planes and their
  pairwise intersection counts; only the greedy overlap merge runs on the
  host, over those counts (``postprocess.merge_from_counts``).

The host pulls are the live count, the per-rep node sizes, the per-rep
group counts with the overflow flag, the O(M_pad + S) drain scalars and the
survivors' bit planes, as in the JAX package. Every count is an exact
integer, so the artifacts equal the host rung's (``models/postprocess.py``)
and the JAX package's byte for byte. A scene that overflows
``post_group_cap`` or ``post_neighbor_cap`` raises
:class:`PostprocessCapacityError`; this module does not catch it.

All kernels here are plain torch on the caller's device. The JAX package
computes them as XLA programs with no Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from maskclustering_tpu_torch.models.postprocess import (
    SceneObjects,
    _PhaseTimer,
    merge_from_counts,
    postprocess_scene,
)
from maskclustering_tpu_torch.ops import counting
from maskclustering_tpu_torch.ops.grid_dbscan import _bucket_pow2, build_grid, grid_dbscan_pairs
from maskclustering_tpu_torch.utils import faults
from maskclustering_tpu_torch.utils.compile_cache import record_shape_bucket


class PostprocessCapacityError(RuntimeError):
    """The scene overflowed a device post-process capacity bucket; raise the
    named config knob, or run the scene on the host rung."""

    def __init__(self, what: str, amount: int, cap: int, knob: str):
        self.what = what
        self.amount = amount
        self.cap = cap
        self.knob = knob
        over = f"{amount} > {cap}" if amount > 0 else f"over {cap}"
        super().__init__(
            f"device postprocess overflowed its {what} bucket ({over}); "
            f"retry degrades to the host-postprocess rung (or raise cfg.{knob})")


def run_postprocess(cfg, scene_points, first, last, mask_frame, mask_id, mask_active,
                    assignment, node_visible, frame_ids, *, k_max: int,
                    timings: Optional[Dict[str, float]] = None,
                    n_real: Optional[int] = None, pulls: Optional[List[int]] = None,
                    seq_name: Optional[str] = None) -> SceneObjects:
    """Single dispatch point of the device and host post-process rungs
    (``postprocess_device.py:106-173``); both give byte-identical artifacts.

    The large operands are tensors on the scene's device. ``n_real``: the
    true point count when the inputs are padded; a claimed pad point raises
    and the objects get the real count back. ``pulls``, when given, is a
    one-element list the device-to-host pulls are added to. ``seq_name``
    names the scene at the ``post`` fault seam, which heads the device rung
    only: the host rung is the ladder's fallback, and a seam that kept
    firing there would leave the ladder nothing to heal with.
    """
    kwargs = dict(k_max=k_max, point_filter_threshold=cfg.point_filter_threshold,
                  dbscan_eps=cfg.dbscan_split_eps,
                  dbscan_min_points=cfg.dbscan_split_min_points,
                  overlap_merge_ratio=cfg.overlap_merge_ratio,
                  min_masks_per_object=cfg.min_masks_per_object, timings=timings)
    scene_points = np.asarray(scene_points)
    mask_frame = np.asarray(mask_frame)
    mask_id = np.asarray(mask_id)
    pulled = [0]
    if cfg.device_postprocess:
        faults.inject("post", seq_name)
        objects = postprocess_scene_device(
            scene_points, first, last, mask_frame, mask_id, mask_active, assignment,
            node_visible, frame_ids, pull_chunk=cfg.claims_pull_chunk,
            count_dtype=cfg.count_dtype, group_cap=cfg.post_group_cap,
            neighbor_cap=cfg.post_neighbor_cap, n_real=n_real, pulls=pulled, **kwargs)
    else:
        # the host rung pulls the claim planes, as postprocess_device.py:150-163
        first_h = first.cpu().numpy()
        last_h = last.cpu().numpy()
        nv_h = node_visible.cpu().numpy()
        active_h = mask_active.cpu().numpy()
        assign_h = assignment.cpu().numpy()
        pulled[0] += 5
        objects = postprocess_scene(scene_points, first_h, last_h, first_h > 0, mask_frame,
                                    mask_id, active_h, assign_h, nv_h, frame_ids, **kwargs)
    if pulls is not None:
        pulls[0] += pulled[0]
    if n_real is not None and objects.num_points != n_real:
        for pids in objects.point_ids_list:
            if pids.size and int(pids.max()) >= n_real:
                raise RuntimeError(
                    "sentinel pad point claimed — padding invariant violated "
                    f"(max point id {int(pids.max())} >= num_points {n_real})")
        objects = SceneObjects(point_ids_list=objects.point_ids_list,
                               mask_list=objects.mask_list, num_points=n_real)
    return objects


def _frame_chunk(f: int) -> int:
    """Frames per counting step: largest divisor of F in {8, 4, 2, 1}."""
    return next(c for c in (8, 4, 2, 1) if f % c == 0)


def _rep_bucket(live: int) -> int:
    """Live-representative shape bucket: pow2 of the live count, floor 64."""
    return _bucket_pow2(max(int(live), 1), minimum=64)


def _cluster_sizes(assignment: torch.Tensor, mask_active: torch.Tensor) -> torch.Tensor:
    """Active members per representative slot (M_pad,)."""
    m_pad = assignment.shape[0]
    return torch.bincount(assignment[mask_active].long(), minlength=m_pad)[:m_pad]


def _live_count_kernel(assignment, mask_active, *, min_masks_per_object):
    """Number of clusters with >= min_masks_per_object active members."""
    return (_cluster_sizes(assignment, mask_active) >= min_masks_per_object).sum()


def _prep_kernel(assignment, mask_active, mask_frame, mask_id, *, r_pad: int, f: int, k2: int,
                 min_masks_per_object: int):
    """Live-rep routing tables (``postprocess_device.py:250-289``). Dense
    live-rep indices follow ascending representative slot order (cumsum
    compaction), so the emitted object order is the host prep's. Returns
    (rep_tab, live_slots, live_valid, ridx_of_mask, alive, mask_flat)."""
    dev = assignment.device
    m_pad = assignment.shape[0]
    arange_m = torch.arange(m_pad, dtype=torch.int32, device=dev)
    live = _cluster_sizes(assignment, mask_active) >= min_masks_per_object
    dense = torch.cumsum(live.to(torch.int32), dim=0, dtype=torch.int32) - 1
    rep_lut = torch.where(live, dense, torch.full_like(dense, -1))
    # slot r_pad is the dump slot of the non-live entries
    scatter_to = torch.where(live, dense, torch.full_like(dense, r_pad)).long()
    live_slots = torch.zeros(r_pad + 1, dtype=torch.int32, device=dev)
    live_slots[scatter_to] = arange_m
    live_valid = torch.zeros(r_pad + 1, dtype=torch.bool, device=dev)
    live_valid[scatter_to] = True
    ridx_of_mask = rep_lut[assignment.long().clamp(0, m_pad - 1)]
    slot = mask_frame.long() * k2 + mask_id.long().clamp(0, k2 - 1)
    rep_tab = torch.full((f * k2 + 1,), -1, dtype=torch.int32, device=dev)
    rep_tab[torch.where(mask_active, slot, torch.full_like(slot, f * k2))] = ridx_of_mask
    alive = mask_active & (ridx_of_mask >= 0)
    mask_flat = torch.where(alive, slot, torch.zeros_like(slot)).to(torch.int32)
    return (rep_tab[:f * k2].reshape(f, k2), live_slots[:r_pad], live_valid[:r_pad],
            ridx_of_mask, alive, mask_flat)


def _node_stats_kernel(first, last, rep_tab, node_visible, live_slots, live_valid, *,
                       r_pad: int, point_filter_threshold: float, count_dtype: str = "bf16"):
    """Per-(rep, point) claim statistics (``postprocess_device.py:292-383``):
    ``(claimed, ratio_ok, nv_rep)``, (r_pad, N) bool x2 and (r_pad, F) bool.

    ``claimed``: the point is a node point of the rep; the OVIR numerator
    counts the frames where a mask of the rep claims the point and the rep
    sees the frame, one per (rep, point, frame) triple (two masks of one
    rep claiming one cell count once). The JAX package counts both with
    one-hot matrix products; here they are integer histograms over
    ``rep * N + point`` keys, the same exact counts. The denominator, the
    frames where the rep sees the frame and the point is claimed at all, is
    one counting product of node visibility against point visibility.
    """
    dev = first.device
    f, n = first.shape
    nv_rep = node_visible[live_slots.long()] & live_valid[:, None]
    a = first.long()
    b = last.long()
    b2 = torch.where(b == a, torch.zeros_like(b), b)
    rep_a = torch.gather(rep_tab.long(), 1, a)  # (F, N) dense rep or -1 (id 0 maps to -1)
    rep_b = torch.gather(rep_tab.long(), 1, b2)
    dup = (rep_a >= 0) & (rep_a == rep_b) & (a != b2)
    frame = torch.arange(f, device=dev)[:, None].expand(f, n)
    point = torch.arange(n, device=dev)[None, :].expand(f, n)
    sel_a = rep_a >= 0
    sel_b = (rep_b >= 0) & ~dup
    rep = torch.cat([rep_a[sel_a], rep_b[sel_b]])
    key = rep * n + torch.cat([point[sel_a], point[sel_b]])
    seen = nv_rep[rep, torch.cat([frame[sel_a], frame[sel_b]])]
    claimed = torch.bincount(key, minlength=r_pad * n)[:r_pad * n].reshape(r_pad, n) > 0
    num = torch.bincount(key[seen], minlength=r_pad * n)[:r_pad * n].reshape(r_pad, n)
    den = counting.count_dot(nv_rep, first > 0, count_dtype=count_dtype)
    eps = torch.tensor(1e-6, dtype=torch.float32, device=dev)
    thr = torch.tensor(point_filter_threshold, dtype=torch.float32, device=dev)
    ratio_ok = num.to(torch.float32) / (den + eps) > thr
    return claimed, ratio_ok, nv_rep


def _pack_bits(x: torch.Tensor) -> torch.Tensor:
    """(R, N) bool -> (R, ceil(N/8)) uint8, np.unpackbits-compatible (big-endian)."""
    r, n = x.shape
    n8 = -(-n // 8) * 8
    xp = torch.nn.functional.pad(x.to(torch.int32), (0, n8 - n)).reshape(r, n8 // 8, 8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=x.device)
    return (xp * weights).sum(dim=-1).to(torch.uint8)


def _unpack_bits(packed: np.ndarray, n: int) -> np.ndarray:
    return np.unpackbits(np.asarray(packed), axis=1)[:, :n].astype(bool)


def _row_chunks(arr, rows: int, chunk: int) -> List:
    """``arr[:rows]`` as row slices of at most ``chunk`` rows (one slice when
    ``chunk <= 0`` or it covers everything)."""
    if chunk <= 0 or rows <= chunk:
        return [arr[:rows]]
    return [arr[i:min(i + chunk, rows)] for i in range(0, rows, chunk)]


def _dbscan_split_kernel(claimed, nv_rep, live_valid, points, order, start, length, *,
                         c_pad: int, cell_cap: int, neighbor_cap: int, eps: float,
                         min_points: int):
    """Grid-DBSCAN split over compacted (rep, point) pairs
    (``postprocess_device.py:419-460``). Returns (pair_rep, pair_pt,
    pair_valid, dense_local, groups per rep incl. the noise slot, overflow)."""
    r_pad, n = claimed.shape
    candidate = live_valid & claimed.any(dim=1) & nv_rep.any(dim=1)
    valid_rows = (claimed & candidate[:, None]).reshape(-1)
    idx = torch.nonzero(valid_rows).reshape(-1)[:c_pad]  # ascending (rep, point)
    pair_idx = torch.full((c_pad,), r_pad * n, dtype=torch.int64, device=claimed.device)
    pair_idx[:idx.shape[0]] = idx
    pair_valid = pair_idx < r_pad * n
    pair_rep = torch.where(pair_valid, pair_idx // n, torch.full_like(pair_idx, r_pad))
    pair_pt = torch.where(pair_valid, pair_idx % n, torch.zeros_like(pair_idx))
    dense_local, root_count, nb_overflow = grid_dbscan_pairs(
        points, order, start, length, pair_rep, pair_pt, pair_valid, r_pad=r_pad,
        cell_cap=cell_cap, neighbor_cap=neighbor_cap, eps=eps, min_points=min_points)
    ngrp = torch.where(candidate, root_count + 1, torch.zeros_like(root_count))
    return (pair_rep.to(torch.int32), pair_pt.to(torch.int32), pair_valid, dense_local, ngrp,
            nb_overflow)


def _group_structs_kernel(pair_rep, pair_pt, pair_valid, dense_local, goff, ngrp, ratio_ok,
                          points, ridx_of_mask, alive, *, s_pad: int):
    """Every group structure as scatters over the split's pairs
    (``postprocess_device.py:463-522``); slot ``s_pad`` is the dump slot.
    Returns (group_size, npts_ratio, goh (N, s_pad) f32, packed object
    planes, bb_min, bb_max, glo, ghi)."""
    dev = points.device
    r_pad = goff.shape[0]
    n = points.shape[0]
    rep_clip = pair_rep.long().clamp(0, r_pad - 1)
    pt = pair_pt.long()
    dump = torch.full_like(rep_clip, s_pad)
    gg = torch.where(pair_valid, goff.long()[rep_clip] + dense_local.long() + 1, dump)
    ratio_pair = ratio_ok.reshape(-1)[(rep_clip * n + pt).clamp(0, r_pad * n - 1)]
    gg_ratio = torch.where(ratio_pair & pair_valid, gg, dump)
    group_size = torch.bincount(gg, minlength=s_pad + 1)[:s_pad].to(torch.int32)
    npts_ratio = torch.bincount(gg_ratio, minlength=s_pad + 1)[:s_pad].to(torch.int32)
    goh = torch.zeros((n, s_pad + 1), dtype=torch.float32, device=dev)
    goh[pt, gg] = 1.0
    obj_plane = torch.zeros((s_pad + 1, n), dtype=torch.bool, device=dev)
    obj_plane[gg_ratio, pt] = True
    pts3 = points[pt]
    idx3 = gg[:, None].expand(-1, 3)
    bb_min = torch.full((s_pad + 1, 3), float("inf"), dtype=torch.float32, device=dev)
    bb_min.scatter_reduce_(0, idx3, pts3, reduce="amin")
    bb_max = torch.full((s_pad + 1, 3), float("-inf"), dtype=torch.float32, device=dev)
    bb_max.scatter_reduce_(0, idx3, pts3, reduce="amax")
    ridx = ridx_of_mask.long().clamp(0, r_pad - 1)
    zero = torch.zeros_like(ridx_of_mask)
    glo = torch.where(alive, goff[ridx], zero)
    ghi = glo + torch.where(alive, ngrp[ridx], zero)
    return (group_size, npts_ratio, goh[:, :s_pad], _pack_bits(obj_plane[:s_pad]),
            bb_min[:s_pad], bb_max[:s_pad], glo, ghi)


def _mask_group_counts_impl(first, last, goh, mask_flat, group_lo, group_hi, *, k2: int,
                            s_pad: int, count_dtype: str = "bf16"):
    """Best DBSCAN group (+ claim count) per mask slot
    (``postprocess_device.py:525-566``): counts[m, g] = claims of mask m
    with group g, as one-hot counting products against the (N, s_pad)
    membership plane, frames in chunks of ``_frame_chunk``; the argmax is
    restricted to the mask's own rep's groups, ties to the lowest group."""
    f, n = first.shape
    chunk = _frame_chunk(f)
    counts = []
    for f0 in range(0, f, chunk):
        a = first[f0:f0 + chunk].long()
        b = last[f0:f0 + chunk].long()
        b = torch.where(b == a, torch.full_like(b, k2 - 1), b)  # k2 - 1: unused sentinel row
        oh = counting.count_onehot(a, k2, axis=1) + counting.count_onehot(b, k2, axis=1)
        counts.append(counting.count_dot_general(oh, goh, (((2,), (0,)), ((), ())),
                                                 count_dtype=count_dtype))
    counts = torch.cat(counts).reshape(f * k2, s_pad)
    per_mask = counts[mask_flat.long().clamp(0, f * k2 - 1)]
    slots = torch.arange(s_pad, dtype=torch.int32, device=first.device)[None, :]
    in_range = (slots >= group_lo[:, None]) & (slots < group_hi[:, None])
    masked = torch.where(in_range, per_mask, torch.full_like(per_mask, -1.0))
    best_group = torch.argmax(masked, dim=1)  # the first maximum, as jnp.argmax
    return best_group.to(torch.int32), masked.max(dim=1).values


def _survivor_gather_kernel(obj_packed, surv_idx, *, count_dtype: str = "bf16"):
    """The surviving objects' packed planes and their pairwise intersection
    counts ``inter[i, j] = |points_i and points_j|``."""
    rows = obj_packed[surv_idx.long()]
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=rows.device)
    bits = (rows[:, :, None] >> shifts[None, None, :]) & 1
    flat = bits.reshape(rows.shape[0], -1)
    return rows, counting.count_dot(flat, flat.T, count_dtype=count_dtype)


def postprocess_scene_device(
    scene_points: np.ndarray,  # (N, 3) float32, host
    first: torch.Tensor,  # (F, N) int16, device
    last: torch.Tensor,  # (F, N) int16, device
    mask_frame: np.ndarray,  # (M_pad,) int32, host
    mask_id: np.ndarray,  # (M_pad,) int32, host (-1 padding)
    mask_active: torch.Tensor,  # (M_pad,) bool, device
    assignment: torch.Tensor,  # (M_pad,) int32, device
    node_visible: torch.Tensor,  # (M_pad, F) bool, device
    frame_ids: Sequence,
    *,
    k_max: int = 127,
    point_filter_threshold: float = 0.5,
    dbscan_eps: float = 0.1,
    dbscan_min_points: int = 4,
    overlap_merge_ratio: float = 0.8,
    min_masks_per_object: int = 2,
    timings: Optional[Dict[str, float]] = None,
    pull_chunk: int = 0,
    count_dtype: str = "bf16",
    group_cap: int = 512,
    neighbor_cap: int = 256,
    n_real: Optional[int] = None,
    pulls: Optional[List[int]] = None,
) -> SceneObjects:
    """Same contract and outputs as ``postprocess_scene``, with the claim
    planes consumed on the device (``postprocess_device.py:607-872``).
    ``pull_chunk`` > 0 drains the survivors' bit planes in row chunks of
    that size (same bytes at any chunk size). ``pulls``, when given, is a
    one-element list the device-to-host pulls are added to."""
    t = _PhaseTimer(timings)
    dev = first.device
    f, n = first.shape
    m_pad = mask_frame.shape[0]
    k2 = k_max + 2
    pulled = 0

    def done(*phases):
        for phase in phases:
            t.mark(phase)
        if pulls is not None:
            pulls[0] += pulled
        return SceneObjects(point_ids_list=[], mask_list=[], num_points=n)

    # r_pad sizing: a 4-byte scalar pull, not an assignment pull
    live = int(_live_count_kernel(assignment, mask_active,
                                  min_masks_per_object=int(min_masks_per_object)))
    pulled += 1
    if live == 0:
        return done("claims", "dbscan", "mask_assign", "emit", "merge")
    r_pad = _rep_bucket(live)
    record_shape_bucket("post.nodestats", r_pad, m_pad, f, n, k2)

    mask_frame_d = torch.from_numpy(np.asarray(mask_frame)).to(dev)
    mask_id_d = torch.from_numpy(np.asarray(mask_id)).to(dev)
    rep_tab, live_slots, live_valid, ridx_of_mask, alive, mask_flat = _prep_kernel(
        assignment, mask_active, mask_frame_d, mask_id_d, r_pad=r_pad, f=f, k2=k2,
        min_masks_per_object=int(min_masks_per_object))
    claimed, ratio_ok, nv_rep = _node_stats_kernel(
        first, last, rep_tab, node_visible, live_slots, live_valid, r_pad=r_pad,
        point_filter_threshold=float(point_filter_threshold), count_dtype=count_dtype)
    t.mark("claims")

    # pair-bucket sizing: the O(r_pad) node-size pull
    sizes = claimed.sum(dim=1).cpu().numpy()
    cand_pre = (live_valid & (claimed.any(dim=1)) & nv_rep.any(dim=1)).cpu().numpy()
    pulled += 2
    num_pairs = int(sizes[cand_pre].sum())
    if num_pairs == 0:
        return done("dbscan", "mask_assign", "emit", "merge")

    # grid DBSCAN split; n_real keeps the sentinel pad points out of the grid
    grid = build_grid(scene_points, dbscan_eps, n_real=n_real)
    c_pad = _bucket_pow2(num_pairs, minimum=256)
    record_shape_bucket("post.dbscan", r_pad, c_pad, grid.cell_cap, n)
    points_d = torch.from_numpy(np.asarray(scene_points, np.float32)).to(dev)
    (pair_rep, pair_pt, pair_valid, dense_local, ngrp_d, nb_overflow_d) = _dbscan_split_kernel(
        claimed, nv_rep, live_valid, points_d, torch.from_numpy(grid.order).to(dev),
        torch.from_numpy(grid.start).to(dev), torch.from_numpy(grid.length).to(dev),
        c_pad=c_pad, cell_cap=grid.cell_cap, neighbor_cap=int(neighbor_cap),
        eps=float(dbscan_eps), min_points=int(dbscan_min_points))
    # O(r_pad) group-count pull: sizes the group axis and surfaces overflows
    ngrp = ngrp_d.cpu().numpy()
    nb_overflow = bool(nb_overflow_d)
    pulled += 2
    if nb_overflow:
        raise PostprocessCapacityError("DBSCAN neighbor-list", -1, int(neighbor_cap),
                                       "post_neighbor_cap")
    total = int(ngrp.sum())
    if total > max(int(group_cap), 1):
        raise PostprocessCapacityError("DBSCAN group", total, int(group_cap), "post_group_cap")
    goff = np.zeros(r_pad, np.int32)
    goff[1:] = np.cumsum(ngrp[:-1]).astype(np.int32)
    s_pad = _bucket_pow2(total, minimum=128)
    record_shape_bucket("post.groups", r_pad, s_pad, c_pad, n)
    (group_size_d, npts_ratio_d, goh, obj_packed, bb_min_d, bb_max_d, glo_d,
     ghi_d) = _group_structs_kernel(
        pair_rep, pair_pt, pair_valid, dense_local, torch.from_numpy(goff).to(dev),
        ngrp_d.to(torch.int32), ratio_ok, points_d, ridx_of_mask, alive, s_pad=s_pad)
    t.mark("dbscan")

    best_group_d, best_count_d = _mask_group_counts_impl(
        first, last, goh, mask_flat, glo_d, ghi_d, k2=k2, s_pad=s_pad, count_dtype=count_dtype)
    t.mark("mask_assign")

    # emit-only drain, stage 1: O(M_pad + S) scalars
    (group_size, npts_ratio, best_group, best_count, glo, ghi, bb_min, bb_max) = (
        a.cpu().numpy() for a in (group_size_d, npts_ratio_d, best_group_d, best_count_d,
                                  glo_d, ghi_d, bb_min_d, bb_max_d))
    pulled += 8

    obj_masks: Dict[int, List[Tuple]] = {}
    for m in np.nonzero(ghi > glo)[0]:
        cnt = best_count[m]
        if cnt <= 0:  # no surviving claims (all mid-id overlaps)
            continue
        gl = int(best_group[m])
        obj_masks.setdefault(gl, []).append(
            (frame_ids[mask_frame[m]], int(mask_id[m]), float(cnt / group_size[gl])))
    survivors = [g for g in range(int(total))
                 if group_size[g] > 0 and npts_ratio[g] > 0
                 and len(obj_masks.get(g, [])) >= min_masks_per_object]
    if not survivors:
        return done("emit", "merge")

    # drain, stage 2: the survivors' bit planes + their intersection counts
    o = len(survivors)
    o_pad = _bucket_pow2(o, minimum=8)
    record_shape_bucket("post.drain", o_pad, s_pad, n)
    surv_idx = np.zeros(o_pad, np.int32)
    surv_idx[:o] = survivors
    rows_d, inter_d = _survivor_gather_kernel(obj_packed, torch.from_numpy(surv_idx).to(dev),
                                              count_dtype=count_dtype)
    parts = []
    for c in _row_chunks(rows_d, o_pad, pull_chunk):
        parts.append(_unpack_bits(c.cpu().numpy(), n))
        pulled += 1
    member = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
    inter = inter_d.cpu().numpy()[:o, :o]
    pulled += 1
    t.mark("emit")

    point_ids = [np.nonzero(member[i])[0].astype(np.int32) for i in range(o)]
    bboxes = [(bb_min[g], bb_max[g]) for g in survivors]
    masks = [obj_masks[g] for g in survivors]
    point_ids_list, mask_list = merge_from_counts(point_ids, bboxes, masks,
                                                  npts_ratio[survivors], inter,
                                                  overlap_merge_ratio)
    t.mark("merge")
    if pulls is not None:
        pulls[0] += pulled
    return SceneObjects(point_ids_list=point_ids_list, mask_list=mask_list, num_points=n)
