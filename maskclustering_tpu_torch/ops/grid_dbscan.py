"""Scene-scale voxel-grid DBSCAN over (instance, point) pairs.

Counterpart of ``maskclustering_tpu/ops/grid_dbscan.py:66-310``. The grid
is scene geometry (cell = eps-sized voxel) built once on the host from the
host-resident cloud (:func:`build_grid`); two points within eps differ by
at most one cell per axis, so the 27-cell stencil covers every candidate.
The work items are (rep, point) pairs in ascending (rep, point) order; each
pair's in-eps same-rep neighbours pack into a (C_pad, neighbor_cap) table,
then core/border classification and min-label propagation with pointer
jumping run over that table. Labels are numbered per rep in ascending
order of their lowest core point, border points join the lowest-numbered
neighbouring core cluster, noise is -1: the host DBSCAN's numbering.

Plain torch on the caller's device. The squared distance rounds as
XLA:CPU compiles ``jnp.sum(delta * delta, axis=-1)``,
``fma(d2, d2, fma(d1, d1, d0 * d0))``, so the labels are the JAX device
rung's bit for bit. Every scatter goes through a dump slot or unique
indices, so the result does not depend on the order of writes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from maskclustering_tpu_torch.device import DeviceLike, resolve_device
from maskclustering_tpu_torch.ops.geometry import fma

# the 27 stencil offsets, fixed order (x-major)
STENCIL: Tuple[Tuple[int, int, int], ...] = tuple(
    (dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1))

# elements of the (pairs, cell_cap) candidate block one stencil step holds at once
_PACK_BLOCK = 1 << 25


def _bucket_pow2(value: int, minimum: int = 8) -> int:
    b = minimum
    while b < value:
        b *= 2
    return b


class GridStructure(NamedTuple):
    """Host-built candidate structure of one scene: ``order`` lists point
    indices sorted by voxel; ``start[s, i]`` / ``length[s, i]`` delimit, in
    ``order``, the points of the cell at stencil offset ``s`` from point
    ``i``'s cell; ``cell_cap`` is the pow2 bucket of the max occupancy."""

    order: np.ndarray  # (N_real,) int32
    start: np.ndarray  # (27, N_real) int32
    length: np.ndarray  # (27, N_real) int32
    cell_cap: int


def build_grid(points: np.ndarray, eps: float, *, cap_minimum: int = 8,
               n_real: Optional[int] = None) -> GridStructure:
    """Voxel-bin a host point cloud at cell size ``eps`` (f64 quantization).
    ``n_real`` leaves the sentinel pad points (one shared coordinate) out
    of the grid: they are never node points."""
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    if n_real is not None and n_real < n:
        pts = pts[:n_real]
    if n == 0 or pts.shape[0] == 0:
        z = np.zeros((27, n), np.int32)
        return GridStructure(np.zeros(0, np.int32), z, z.copy(), cap_minimum)
    cell = np.floor(pts / float(eps)).astype(np.int64)
    cell -= cell.min(axis=0)
    cell += 1  # stencil neighbours at -1 stay non-negative
    dims = cell.max(axis=0) + 2

    def lin(c):
        return (c[..., 0] * dims[1] + c[..., 1]) * dims[2] + c[..., 2]

    key = lin(cell)
    order = np.argsort(key, kind="stable").astype(np.int32)
    sorted_key = key[order]
    n = pts.shape[0]
    start = np.empty((27, n), np.int32)
    length = np.empty((27, n), np.int32)
    off = np.empty_like(cell)
    for s, (dx, dy, dz) in enumerate(STENCIL):
        off[:, 0] = cell[:, 0] + dx
        off[:, 1] = cell[:, 1] + dy
        off[:, 2] = cell[:, 2] + dz
        nk = lin(off)
        lo = np.searchsorted(sorted_key, nk, side="left")
        hi = np.searchsorted(sorted_key, nk, side="right")
        start[s] = lo
        length[s] = hi - lo
    cap = _bucket_pow2(int(length[13].max(initial=1)), cap_minimum)
    return GridStructure(order=order, start=start, length=length, cell_cap=cap)


def pack_neighbors(points: torch.Tensor, order: torch.Tensor, start: torch.Tensor,
                   length: torch.Tensor, pair_rep: torch.Tensor, pair_pt: torch.Tensor,
                   pair_valid: torch.Tensor, *, r_pad: int, cell_cap: int, neighbor_cap: int,
                   eps: float):
    """One pass over the 27-cell stencil (``grid_dbscan.py:186-216``): each
    pair's in-eps same-rep neighbours as pair indices, packed into a
    (C_pad, neighbor_cap) int32 table (sentinel C_pad past the end), and
    each pair's degree (all of them, the pair itself included, even past
    the cap)."""
    dev = points.device
    n = points.shape[0]
    n_grid = order.shape[0]
    c_pad = pair_rep.shape[0]
    sent = c_pad
    eps2 = torch.tensor(float(eps) * float(eps), dtype=torch.float32, device=dev)
    lanes = torch.arange(cell_cap, dtype=torch.int64, device=dev)
    sent_t = torch.full((1,), sent, dtype=torch.int32, device=dev)
    pair_pt = pair_pt.to(torch.int64)
    pair_rep = pair_rep.to(torch.int64)

    # (rep, point) -> pair index (sentinel c_pad); padded pairs write the
    # dump slot r_pad * n, which no lookup reads
    flat = torch.where(pair_valid, pair_rep * n + pair_pt, torch.full_like(pair_rep, r_pad * n))
    pair_of = torch.full((r_pad * n + 1,), sent, dtype=torch.int32, device=dev)
    pair_of[flat] = torch.arange(c_pad, dtype=torch.int32, device=dev)
    own = points[pair_pt]
    rep_base = pair_rep.clamp(0, r_pad - 1) * n
    order_l = order.to(torch.int64)

    # one stencil direction at a time, in row blocks; column neighbor_cap
    # is the dump slot of hits past the cap
    nb = torch.full((c_pad, neighbor_cap + 1), sent, dtype=torch.int32, device=dev)
    degree = torch.zeros(c_pad, dtype=torch.int64, device=dev)
    rows = max(1, _PACK_BLOCK // max(cell_cap, 1))
    for s in range(27 if n_grid else 0):
        st_s, ln_s = start[s].to(torch.int64), length[s].to(torch.int64)
        for r0 in range(0, c_pad, rows):
            r1 = min(c_pad, r0 + rows)
            pt = pair_pt[r0:r1]
            run = ln_s[pt]
            idx = (st_s[pt][:, None] + lanes[None, :]).clamp(0, n_grid - 1)
            cand = order_l[idx]
            cp = points[cand]
            delta0 = cp[..., 0] - own[r0:r1, None, 0]
            delta1 = cp[..., 1] - own[r0:r1, None, 1]
            delta2 = cp[..., 2] - own[r0:r1, None, 2]
            d2 = fma(delta2, delta2, fma(delta1, delta1, delta0 * delta0))
            q_nb = pair_of[rep_base[r0:r1, None] + cand]
            hit = ((d2 <= eps2) & (lanes[None, :] < run[:, None])
                   & pair_valid[r0:r1, None] & (q_nb < sent))
            pos = degree[r0:r1]
            hpos = pos[:, None] + torch.cumsum(hit, dim=1) - hit.to(torch.int64)
            col = torch.where(hit & (hpos < neighbor_cap), hpos,
                              torch.full_like(hpos, neighbor_cap))
            nb[r0:r1].scatter_(1, col, torch.where(hit, q_nb, sent_t))
            degree[r0:r1] = pos + hit.sum(dim=1)
    return nb[:, :neighbor_cap], degree


def grid_dbscan_pairs(points: torch.Tensor, order: torch.Tensor, start: torch.Tensor,
                      length: torch.Tensor, pair_rep: torch.Tensor, pair_pt: torch.Tensor,
                      pair_valid: torch.Tensor, *, r_pad: int, cell_cap: int,
                      neighbor_cap: int, eps: float, min_points: int):
    """DBSCAN over compacted (rep, point) pairs (``grid_dbscan.py:150-261``).

    Returns ``(dense_local (C_pad,) int32, root_count (r_pad,) int32,
    nb_overflow () bool)``: the pair's label within its rep (-1 noise or
    padding), clusters per rep, and whether some pair had more than
    ``neighbor_cap`` same-rep neighbours (then the labels are unusable).
    ``degree`` counts the pair itself, the ``min_points`` contract of the
    host DBSCAN. The label fixpoint reads one "changed" flag a sweep.
    """
    dev = points.device
    c_pad = pair_rep.shape[0]
    sent = c_pad
    arange_c = torch.arange(c_pad, dtype=torch.int32, device=dev)
    sent_t = torch.full((1,), sent, dtype=torch.int32, device=dev)
    pair_rep = pair_rep.to(torch.int64)
    nb, degree = pack_neighbors(points, order, start, length, pair_rep, pair_pt, pair_valid,
                                r_pad=r_pad, cell_cap=cell_cap, neighbor_cap=neighbor_cap,
                                eps=eps)
    nb_overflow = (degree > neighbor_cap).any()

    core = pair_valid & (degree >= min_points)
    nb_core = torch.cat([core, torch.zeros(1, dtype=torch.bool, device=dev)])[nb]

    def neighbor_min(labels):
        lab_ext = torch.cat([labels, sent_t])
        return torch.where(nb_core, lab_ext[nb], sent_t).min(dim=1).values

    labels = torch.where(core, arange_c, sent_t)
    while True:
        best = torch.where(core, torch.minimum(labels, neighbor_min(labels)), labels)
        best = torch.where(core, torch.minimum(best, torch.cat([best, sent_t])[best]), best)
        changed = bool((best != labels).any())
        labels = best
        if not changed:
            break

    # border pairs: lowest neighbouring core cluster of the same rep
    blab = neighbor_min(labels)
    labels = torch.where(core, labels,
                         torch.where(pair_valid & (blab < sent), blab, sent_t))

    # densify per rep: a rep's roots are contiguous in the global root
    # ranking, so local rank = global rank minus the rep's root offset
    is_root = core & (labels == arange_c)
    gcum = torch.cumsum(is_root.to(torch.int32), dim=0, dtype=torch.int32)
    root_count = torch.bincount(pair_rep[is_root], minlength=r_pad)[:r_pad]
    roots_before = torch.cumsum(root_count, dim=0) - root_count
    grank = gcum[labels.clamp(0, max(c_pad - 1, 0))] - 1
    dense_local = torch.where(labels < sent,
                              grank - roots_before[pair_rep.clamp(0, r_pad - 1)],
                              torch.full_like(labels, -1))
    return dense_local.to(torch.int32), root_count.to(torch.int32), nb_overflow


def grid_dbscan_reference(points, valid_rows, grid: GridStructure, *, neighbor_cap: int,
                          eps: float, min_points: int, device: DeviceLike = None):
    """Standalone entry over (R, N) validity rows (tests and diagnostics),
    run on ``device`` (CUDA unless the caller asks for the CPU). Returns
    (R, N) dense labels (-1 noise/invalid)."""
    device = resolve_device(device)
    valid_rows = np.asarray(valid_rows)
    r_pad, n = valid_rows.shape
    rep, pt = np.nonzero(valid_rows)
    c_pad = _bucket_pow2(max(len(rep), 1), minimum=8)
    pair_rep = np.zeros(c_pad, np.int32)
    pair_pt = np.zeros(c_pad, np.int32)
    pair_valid = np.zeros(c_pad, bool)
    pair_rep[: len(rep)] = rep
    pair_pt[: len(rep)] = pt
    pair_valid[: len(rep)] = True

    def up(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    dense, _, overflow = grid_dbscan_pairs(
        up(np.asarray(points, np.float32)), up(grid.order), up(grid.start), up(grid.length),
        up(pair_rep), up(pair_pt), up(pair_valid), r_pad=r_pad, cell_cap=grid.cell_cap,
        neighbor_cap=neighbor_cap, eps=float(eps), min_points=int(min_points))
    if bool(overflow):
        raise ValueError(f"neighbor_cap {neighbor_cap} overflowed")
    out = np.full((r_pad, n), -1, np.int32)
    out[rep, pt] = dense.cpu().numpy()[: len(rep)]
    return out
