"""Cluster post-processing and artifact export (host numpy).

Counterpart of ``maskclustering_tpu/models/postprocess.py:29-373``, the
host rung of the JAX post-process (``device_postprocess=False``), which
gives artifacts byte-identical to its device rung. Reproduces the
reference's post pipeline (utils/post_process.py:173-195): per node with
>= 2 masks, (i) DBSCAN-split the node's point cloud into spatially
connected objects, (ii) drop points whose detection ratio within the node
is below threshold, (iii) drop objects with < 2 assigned masks, then (iv)
merge objects with > 0.8 point overlap, and export the class-agnostic npz
+ object_dict artifacts in the reference's evaluator format
(post_process.py:131-170).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from maskclustering_tpu_torch import obs
from maskclustering_tpu_torch.ops.dbscan import dbscan_labels
from maskclustering_tpu_torch.ops.geometry import bboxes_overlap
from maskclustering_tpu_torch.utils import atomic_write


class _PhaseTimer:
    """Optional phase wall-times accumulated into a caller-owned dict."""

    def __init__(self, timings: Optional[Dict[str, float]]):
        self.timings = timings
        self.last = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.timings is not None:
            now = time.perf_counter()
            self.timings[name] = self.timings.get(name, 0.0) + now - self.last
            self.last = now


class SceneObjects(NamedTuple):
    """Final per-scene objects plus the artifacts' raw ingredients."""

    point_ids_list: List[np.ndarray]
    mask_list: List[List[Tuple]]  # per object: [(frame_id, mask_id, coverage), ...]
    num_points: int


def _claims_coo(first: np.ndarray, last: np.ndarray, gmap: np.ndarray):
    """COO arrays (global_mask, point, frame) of every (point, mask) claim.

    first/last: (F, N) integer claiming ids per point per frame (0 = none;
    int16 since the plane narrowing — every op here is width-agnostic).
    gmap: (F, K+1) -> global mask index or -1.

    Each (frame, point) cell contributes at most two claims, and they
    coincide exactly when last == first — so masking the duplicate out of
    ``last`` replaces the multi-million-row ``np.unique(axis=0)`` sort
    (the dominant postprocess cost at bench scale) with one boolean
    compare.
    """
    coords = []
    last_dedup = np.where(last == first, 0, last)
    for arr in (first, last_dedup):
        f_idx, p_idx = np.nonzero(arr)
        m = gmap[f_idx, arr[f_idx, p_idx]]
        ok = m >= 0
        coords.append((m[ok], p_idx[ok], f_idx[ok]))
    m_coo = np.concatenate([c[0] for c in coords])
    p_coo = np.concatenate([c[1] for c in coords])
    f_coo = np.concatenate([c[2] for c in coords])
    return m_coo, p_coo, f_coo


def postprocess_scene(
    scene_points: np.ndarray,  # (N, 3)
    first: np.ndarray,  # (F, N) int16 (any int width works)
    last: np.ndarray,  # (F, N) int16
    point_visible: np.ndarray,  # (F, N) bool
    mask_frame: np.ndarray,  # (M_pad,) int32
    mask_id: np.ndarray,  # (M_pad,) int32
    mask_active: np.ndarray,  # (M_pad,) bool — valid & not undersegmented
    assignment: np.ndarray,  # (M_pad,) int32 final cluster representative
    node_visible: np.ndarray,  # (M_pad, F) bool aggregated per representative
    frame_ids: Sequence,  # original frame identifiers, len F
    *,
    k_max: int = 127,
    point_filter_threshold: float = 0.5,
    dbscan_eps: float = 0.1,
    dbscan_min_points: int = 4,
    overlap_merge_ratio: float = 0.8,
    min_masks_per_object: int = 2,
    timings: Optional[Dict[str, float]] = None,
) -> SceneObjects:
    t = _PhaseTimer(timings)
    f, n = first.shape
    m_pad = mask_frame.shape[0]

    gmap = np.full((f, k_max + 2), -1, dtype=np.int64)
    act_idx = np.nonzero(mask_active)[0]
    gmap[mask_frame[act_idx], mask_id[act_idx]] = act_idx

    m_coo, p_coo, f_coo = _claims_coo(first, last, gmap)
    rep_coo = assignment[m_coo].astype(np.int64)
    t.mark("claims")

    # per-mask point sets (sorted by mask)
    order = np.argsort(m_coo, kind="stable")
    m_sorted, p_by_mask = m_coo[order], p_coo[order]

    # node sizes: count of active member masks per representative
    sizes = np.bincount(assignment[mask_active], minlength=m_pad)
    reps = np.nonzero(sizes >= min_masks_per_object)[0]

    # ONE sort builds both node structures: unique claimed (rep, point, frame)
    # triples, and — because the triple keys are sorted by (rep, point) first —
    # the unique (rep, point) node rows fall out with a flag diff, no 2nd sort.
    rpf_key = np.sort((rep_coo * n + p_coo) * f + f_coo)
    new_tri = np.empty(len(rpf_key), dtype=bool)
    if len(rpf_key):
        new_tri[0] = True
        new_tri[1:] = rpf_key[1:] != rpf_key[:-1]
    rpf_key = rpf_key[new_tri]
    rpf_pf = rpf_key // f
    rpf_f = (rpf_key % f).astype(np.int32)

    new_rp = np.empty(len(rpf_pf), dtype=bool)
    if len(rpf_pf):
        new_rp[0] = True
        new_rp[1:] = rpf_pf[1:] != rpf_pf[:-1]
    rp_key = rpf_pf[new_rp]
    rp_rep = (rp_key // n).astype(np.int32)
    rp_pt = (rp_key % n).astype(np.int32)
    row_of_tri = np.cumsum(new_rp) - 1  # triple -> its (rep, point) row
    rp_starts = np.searchsorted(rp_rep, np.arange(m_pad + 1))
    t.mark("node_structs")

    # ---- detection ratio, vectorized over ALL (rep, point) rows at once ----
    # numerator: #frames where the point is claimed by a node mask
    tri_rep = (rpf_pf // n).astype(np.int32)
    tri_ok = node_visible[tri_rep, rpf_f]
    num = np.bincount(row_of_tri[tri_ok], minlength=len(rp_key)).astype(np.float64)
    # denominator: #node frames where the point is visible at all
    # (chunked (rows, F) gather keeps peak memory bounded)
    den = np.empty(len(rp_key), dtype=np.float64)
    pv_t = point_visible.T  # (N, F)
    chunk = 1 << 20
    for s in range(0, len(rp_key), chunk):
        e = min(s + chunk, len(rp_key))
        den[s:e] = (node_visible[rp_rep[s:e]] & pv_t[rp_pt[s:e]]).sum(axis=1)
    ratio_ok_rows = num / (den + 1e-6) > point_filter_threshold
    t.mark("ratio")

    # ---- DBSCAN split each node; group labels live in one global array ----
    # glabel[row] = group_offset[rep] + (dbscan label + 1); 0-label = noise is
    # kept as its own candidate object (reference post_process.py:109-123)
    glabel = np.full(len(rp_key), -1, dtype=np.int64)
    rep_offset = np.zeros(m_pad, dtype=np.int64)  # group_offset per rep
    rep_groups = np.zeros(m_pad, dtype=np.int64)  # group count per live rep
    rep_slices: List[Tuple[int, int, int, np.ndarray]] = []  # (rep, s, e, groups)
    candidates = [rep for rep in reps
                  if rp_starts[rep + 1] > rp_starts[rep] and node_visible[rep].any()]
    labels_by_rep = {r: dbscan_labels(scene_points[rp_pt[rp_starts[r]:rp_starts[r + 1]]],
                                      dbscan_eps, dbscan_min_points) for r in candidates}
    group_offset = 0
    for rep in candidates:
        s, e = rp_starts[rep], rp_starts[rep + 1]
        labels = labels_by_rep[rep]
        groups = labels + 1
        glabel[s:e] = group_offset + groups
        rep_offset[rep] = group_offset
        rep_groups[rep] = int(groups.max()) + 1
        rep_slices.append((int(rep), int(s), int(e), groups))
        group_offset += int(groups.max()) + 1
    total_groups = max(group_offset, 1)
    group_size = np.bincount(glabel[glabel >= 0], minlength=total_groups)
    t.mark("dbscan")

    # ---- assign each member mask to its best-overlapping group ----
    # Every claimed point of a mask is a node point of its rep, so the
    # mask∩group intersection is a count of the mask's claims per group of
    # its OWN rep — so a (mask, local-group) slot table is dense and small
    # (Σ members × groups-of-their-rep) and one O(C) bincount replaces the
    # per-(mask × group) intersect1d loop (and any O(C log C) sort).
    g_of_mask = rep_groups[assignment]  # (m_pad,) slots per mask
    slot_base = np.zeros(m_pad + 1, dtype=np.int64)
    np.cumsum(g_of_mask, out=slot_base[1:])
    claim_row = np.searchsorted(rp_key, rep_coo[order] * n + p_by_mask)
    claim_gl = glabel[claim_row]
    ok = claim_gl >= 0
    m_ok = m_sorted[ok]
    key = slot_base[m_ok] + (claim_gl[ok] - rep_offset[assignment[m_ok]])
    counts = np.bincount(key, minlength=slot_base[-1]).astype(np.int64)
    # per-mask argmax over its slot segment: pack (count, lowest-index wins)
    # into one int64 so np.maximum.reduceat resolves ties like the
    # reference's ascending scan with a strict > (post_process.py:~150)
    ln = max(len(counts), 1)
    packed = counts * ln + (ln - 1 - np.arange(len(counts), dtype=np.int64))
    # segment boundaries must cover every non-empty slot run (masks with zero
    # slots occupy zero width, so consecutive starts still tile `counts`);
    # inactive masks have no claims, land at cnt == 0, and are skipped below
    seg_masks = np.nonzero(g_of_mask > 0)[0]
    seg_starts = slot_base[seg_masks]
    obj_masks: Dict[int, List[Tuple]] = {}
    if len(seg_starts):
        seg_best = np.maximum.reduceat(packed, seg_starts)
        best_cnt = seg_best // ln
        best_slot = ln - 1 - (seg_best % ln)
        best_gl = best_slot - slot_base[seg_masks] + rep_offset[assignment[seg_masks]]
        for m, gl, cnt in zip(seg_masks, best_gl, best_cnt):
            if cnt <= 0:  # mask with no surviving claims (all mid-id overlaps)
                continue
            obj_masks.setdefault(int(gl), []).append(
                (frame_ids[mask_frame[m]], int(mask_id[m]), float(cnt / group_size[gl]))
            )
    t.mark("mask_assign")

    total_point_ids: List[np.ndarray] = []
    total_bboxes: List[Tuple[np.ndarray, np.ndarray]] = []
    total_masks: List[List[Tuple]] = []

    for rep, s, e, groups in rep_slices:
        node_pts = rp_pt[s:e]
        ratio_ok = ratio_ok_rows[s:e]
        base = glabel[s]  # group_offset of this rep (groups[0] may be noise 0)
        base -= groups[0]
        for g in range(int(groups.max()) + 1):
            sel = groups == g
            if not sel.any():
                continue
            masks_g = obj_masks.get(int(base + g), [])
            obj_pts_all = node_pts[sel]
            obj_pts = obj_pts_all[ratio_ok[sel]]
            if len(obj_pts) == 0 or len(masks_g) < min_masks_per_object:
                continue
            pts3d = scene_points[obj_pts_all]
            total_point_ids.append(obj_pts)
            total_bboxes.append((pts3d.min(axis=0), pts3d.max(axis=0)))
            total_masks.append(masks_g)

    t.mark("emit")
    point_ids_list, mask_list = _merge_overlapping(
        total_point_ids, total_bboxes, total_masks, overlap_merge_ratio
    )
    t.mark("merge")
    return SceneObjects(point_ids_list=point_ids_list, mask_list=mask_list, num_points=n)


def _merge_overlapping(point_ids_list, bbox_list, mask_list, overlap_ratio: float):
    """Greedy pairwise overlap suppression (reference post_process.py:7-37).

    Scan order and the "first passing test wins" asymmetry are preserved:
    if |i∩j|/|i| > r, object i dies; elif |i∩j|/|j| > r, object j dies.
    """
    num = len(point_ids_list)
    dead = np.zeros(num, dtype=bool)
    sets = [frozenset(p.tolist()) for p in point_ids_list]
    for i in range(num):
        if dead[i]:
            continue
        for j in range(i + 1, num):
            if dead[j]:
                continue
            (imin, imax), (jmin, jmax) = bbox_list[i], bbox_list[j]
            if not bboxes_overlap(imin, imax, jmin, jmax):
                continue
            inter = len(sets[i] & sets[j])
            if inter / max(len(sets[i]), 1) > overlap_ratio:
                dead[i] = True
                # no break: the reference keeps scanning j with dead i, and a
                # later j can still die via the elif branch
            elif inter / max(len(sets[j]), 1) > overlap_ratio:
                dead[j] = True
    keep = [k for k in range(num) if not dead[k]]
    return [point_ids_list[k] for k in keep], [mask_list[k] for k in keep]


def merge_from_counts(point_ids_list, bbox_list, mask_list, sizes, inter,
                      overlap_ratio: float):
    """`_merge_overlapping` with precomputed intersection counts.

    ``inter[i, j] = |points_i ∩ points_j|`` and ``sizes[i] = |points_i|``
    as exact integers (the JAX device post-process computes them on the
    device); the scan order, the first-passing-test-wins asymmetry and the
    f64 ratio comparisons are those of the set-based loop above.
    """
    num = len(point_ids_list)
    dead = np.zeros(num, dtype=bool)
    for i in range(num):
        if dead[i]:
            continue
        for j in range(i + 1, num):
            if dead[j]:
                continue
            (imin, imax), (jmin, jmax) = bbox_list[i], bbox_list[j]
            if not bboxes_overlap(imin, imax, jmin, jmax):
                continue
            x = int(inter[i, j])
            if x / max(int(sizes[i]), 1) > overlap_ratio:
                dead[i] = True
                # no break: the reference keeps scanning j with dead i, and a
                # later j can still die via the elif branch
            elif x / max(int(sizes[j]), 1) > overlap_ratio:
                dead[j] = True
    keep = [k for k in range(num) if not dead[k]]
    return [point_ids_list[k] for k in keep], [mask_list[k] for k in keep]


def representative_masks(mask_info_list: List[Tuple], top_k: int = 5) -> List[Tuple]:
    """Top-k masks by object coverage (reference post_process.py:126-128)."""
    return sorted(mask_info_list, key=lambda t: t[2], reverse=True)[:top_k]


def export_artifacts(objects: SceneObjects, seq_name: str, config_name: str,
                     object_dict_dir: str, prediction_root: str = "data/prediction",
                     top_k_repre: int = 5) -> Dict[str, str]:
    """Write the class-agnostic npz + object_dict.npy artifact pair.

    Formats match the reference exactly (post_process.py:131-170) so the
    evaluation protocol and the semantics stage read either framework's
    output interchangeably.
    """
    with obs.span("export", scene=seq_name, num_objects=len(objects.point_ids_list)):
        return _export_artifacts(objects, seq_name, config_name, object_dict_dir,
                                 prediction_root, top_k_repre)


def _export_artifacts(objects: SceneObjects, seq_name: str, config_name: str,
                      object_dict_dir: str, prediction_root: str,
                      top_k_repre: int) -> Dict[str, str]:
    num_instance = len(objects.point_ids_list)
    masks = np.zeros((objects.num_points, max(num_instance, 0)), dtype=bool)
    object_dict = {}
    for i, (pids, mlist) in enumerate(zip(objects.point_ids_list, objects.mask_list)):
        masks[pids, i] = True
        object_dict[i] = {
            "point_ids": np.asarray(pids),
            "mask_list": mlist,
            "repre_mask_list": representative_masks(mlist, top_k_repre),
        }

    # a temporary file of this writer's own, then a rename: an artifact
    # appears whole (no reader or resume check sees a truncated one), and
    # two workers exporting into one root at once never share a file
    ca_dir = os.path.join(prediction_root, config_name + "_class_agnostic")
    os.makedirs(ca_dir, exist_ok=True)
    npz_path = os.path.join(ca_dir, f"{seq_name}.npz")
    with atomic_write.replacing(npz_path, ".npz") as tmp:
        np.savez(
            tmp,
            pred_masks=masks,
            pred_score=np.ones(num_instance),
            pred_classes=np.zeros(num_instance, dtype=np.int32),
        )

    od_dir = os.path.join(object_dict_dir, config_name)
    os.makedirs(od_dir, exist_ok=True)
    od_path = os.path.join(od_dir, "object_dict.npy")
    with atomic_write.replacing(od_path, ".npy") as tmp:
        np.save(tmp, object_dict, allow_pickle=True)
    return {"npz": npz_path, "object_dict": od_path}
