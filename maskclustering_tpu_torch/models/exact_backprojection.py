"""Exact-parity mask backprojection: the reference's ball-query pipeline.

Counterpart of ``maskclustering_tpu/models/exact_backprojection.py:40-303``,
step by step (reference utils/mask_backprojection.py:70-151):

per frame: depth -> view cloud; per mask: pixel backprojections -> voxel
downsample (r = distance_threshold) -> DBSCAN denoise keeping components
>= 20% + statistical outlier removal (geometry.py:9-24) -> strict bbox crop
of the scene cloud (mask_backprojection.py:48-67) -> batched ball query
K=20 r=distance_threshold over padded masks (mask_backprojection.py:123-128)
-> coverage >= 0.3 test (143-145); then the frame's masks are written into
the point-in-mask matrix in ascending id order with shared points zeroed as
boundary (construction.py:46-62).

The per-mask preprocessing is host numpy, as in the reference and the JAX
package. The ball queries run on the caller's device: the CUDA kernel for
``cuda``, the plain torch version for ``cpu``; a failure raises, there is
no fallback. The scene planes are built on the host and uploaded once.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from scipy.spatial import cKDTree

from maskclustering_tpu_torch.device import DeviceLike, resolve_device
from maskclustering_tpu_torch.models.backprojection import SceneAssociation
from maskclustering_tpu_torch.ops.dbscan import dbscan_labels
from maskclustering_tpu_torch.ops.geometry import backproject_depth_np, voxel_downsample_np
from maskclustering_tpu_torch.ops.neighbor import ball_query


def statistical_outlier_mask(points: np.ndarray, nb_neighbors: int = 20,
                             std_ratio: float = 2.0) -> np.ndarray:
    """Keep-mask of Open3D ``remove_statistical_outlier`` semantics.

    Per point: mean distance to its nb_neighbors nearest neighbours, the
    point itself (distance 0) included as Open3D's KNN does. Keep points
    whose mean distance <= global mean + std_ratio * global std.
    """
    p = len(points)
    if p <= 1:
        return np.ones(p, dtype=bool)
    nb = min(nb_neighbors, p)
    dist, _ = cKDTree(points).query(points, k=nb)
    mean_dist = dist.reshape(p, nb).mean(axis=1)
    mu, sigma = mean_dist.mean(), mean_dist.std()
    return mean_dist <= mu + std_ratio * sigma


def denoise_mask_points(points: np.ndarray, eps: float = 0.04,
                        min_points: int = 4) -> np.ndarray:
    """Reference utils/geometry.py denoise: DBSCAN components >= 20% of the
    cloud survive, then statistical outlier removal. Returns kept indices."""
    if len(points) == 0:
        return np.zeros(0, dtype=np.int64)
    labels = dbscan_labels(points, eps=eps, min_points=min_points) + 1
    counts = np.bincount(labels)
    keep = counts[labels] >= 0.2 * len(labels)
    remain = np.nonzero(keep)[0]
    if len(remain) == 0:
        return remain
    inlier = statistical_outlier_mask(points[remain])
    return remain[inlier]


def _pow2(value: int, minimum: int) -> int:
    return 1 << max(minimum, int(np.ceil(np.log2(max(value, 1)))))


def _ball_query_group(q, c, ql, cl, k, radius, device: torch.device) -> np.ndarray:
    """One padded ball-query batch on ``device``; the result comes back to
    the host, where the coverage test and the claim sets are built."""
    out = ball_query(torch.from_numpy(q).to(device), torch.from_numpy(c).to(device),
                     torch.from_numpy(ql).to(device), torch.from_numpy(cl).to(device),
                     k=k, radius=radius)
    return out.cpu().numpy()


def ball_query_groups(mask_points_list, cropped_list):
    """The padded ball-query batches of one frame's masks.

    Masks are grouped by their power-of-two (P_pad, S_pad) bucket (batch
    padded to a power of two, at least 4), which keeps padding waste below
    4x and bounds the distinct kernel shapes, as in the JAX package. Yields
    ``(mask indices, q (B, P_pad, 3) f32, c (B, S_pad, 3) f32, ql, cl)``.
    """
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, (mp, cp) in enumerate(zip(mask_points_list, cropped_list)):
        key = (_pow2(len(mp), 6), _pow2(len(cp), 8))
        groups.setdefault(key, []).append(i)
    for (p_pad, s_pad), idxs in sorted(groups.items()):
        b = _pow2(len(idxs), 2)
        q = np.zeros((b, p_pad, 3), dtype=np.float32)
        c = np.zeros((b, s_pad, 3), dtype=np.float32)
        ql = np.zeros(b, dtype=np.int32)
        cl = np.zeros(b, dtype=np.int32)
        for j, i in enumerate(idxs):
            mp, cp = mask_points_list[i], cropped_list[i]
            q[j, : len(mp)] = mp
            c[j, : len(cp)] = cp
            ql[j], cl[j] = len(mp), len(cp)
        yield idxs, q, c, ql, cl


def _ball_query_batched(mask_points_list, cropped_list, k, radius, device: torch.device,
                        timings: Optional[Dict[str, float]] = None):
    """Ragged per-mask ball queries, one device call per size bucket."""
    n = len(mask_points_list)
    p_out = max(len(m) for m in mask_points_list)
    out = np.full((n, p_out, k), -1, dtype=np.int32)
    for idxs, q, c, ql, cl in ball_query_groups(mask_points_list, cropped_list):
        t0 = time.perf_counter()
        nb = _ball_query_group(q, c, ql, cl, k, radius, device)
        if timings is not None:
            timings["associate.ball_query"] = (timings.get("associate.ball_query", 0.0)
                                               + time.perf_counter() - t0)
            timings["ball_query.pulls"] = timings.get("ball_query.pulls", 0) + 1
        for j, i in enumerate(idxs):
            pl = len(mask_points_list[i])
            out[i, :pl] = nb[j, :pl]
    return out


def frame_mask_candidates(
    scene_points: np.ndarray,  # (N, 3) f64
    depth: np.ndarray,
    seg: np.ndarray,
    intrinsics: np.ndarray,
    cam_to_world: np.ndarray,
    *,
    distance_threshold: float = 0.01,
    depth_trunc: float = 20.0,
    few_points_threshold: int = 25,
    denoise_eps: float = 0.04,
    denoise_min_points: int = 4,
) -> List[Tuple[int, np.ndarray, np.ndarray, np.ndarray]]:
    """The host half of one frame: per surviving mask ``(mask_id, denoised
    mask points, cropped scene points, their scene ids)``."""
    if not np.all(np.isfinite(cam_to_world)):
        return []
    view_points, depth_ok = backproject_depth_np(depth, intrinsics, cam_to_world, depth_trunc)
    seg_flat = seg.reshape(-1)
    seg_valid = seg_flat[depth_ok.reshape(-1)]
    candidates: List[Tuple[int, np.ndarray, np.ndarray, np.ndarray]] = []
    for mask_id in np.unique(seg_flat):
        if mask_id == 0:
            continue
        mask_points = view_points[seg_valid == mask_id]
        if len(mask_points) < few_points_threshold:
            continue
        mask_points = voxel_downsample_np(mask_points, distance_threshold)
        kept = denoise_mask_points(mask_points, eps=denoise_eps, min_points=denoise_min_points)
        mask_points = mask_points[kept]
        if len(mask_points) < few_points_threshold:
            continue
        lo, hi = mask_points.min(axis=0), mask_points.max(axis=0)
        sel = np.nonzero(np.all((scene_points > lo) & (scene_points < hi), axis=1))[0]
        candidates.append((int(mask_id), mask_points, scene_points[sel], sel))
    return candidates


def frame_backprojection_exact(
    scene_points: np.ndarray,  # (N, 3)
    depth: np.ndarray,  # (H, W) metres
    seg: np.ndarray,  # (H, W) int
    intrinsics: np.ndarray,
    cam_to_world: np.ndarray,
    *,
    distance_threshold: float = 0.01,
    depth_trunc: float = 20.0,
    few_points_threshold: int = 25,
    coverage_threshold: float = 0.3,
    k_neighbors: int = 20,
    denoise_eps: float = 0.04,
    denoise_min_points: int = 4,
    device: DeviceLike = None,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[int, np.ndarray]:
    """One frame's mask -> scene-point-id sets, reference semantics.

    Returns {mask_id: sorted unique scene point ids} for masks that pass the
    few-points and coverage filters. The ball queries run on ``device``
    (default: CUDA).
    """
    device = resolve_device(device)
    candidates = frame_mask_candidates(
        scene_points, depth, seg, intrinsics, cam_to_world,
        distance_threshold=distance_threshold, depth_trunc=depth_trunc,
        few_points_threshold=few_points_threshold, denoise_eps=denoise_eps,
        denoise_min_points=denoise_min_points)
    if not candidates:
        return {}

    neighbors = _ball_query_batched([c[1] for c in candidates], [c[2] for c in candidates],
                                    k_neighbors, distance_threshold, device, timings)
    mask_info: Dict[int, np.ndarray] = {}
    for i, (mask_id, mp, _, sel) in enumerate(candidates):
        nb = neighbors[i, :len(mp)]
        valid_nb = nb >= 0
        coverage = np.any(valid_nb, axis=1).mean() if len(mp) else 0.0
        if coverage < coverage_threshold:
            continue
        local = np.unique(nb[valid_nb])
        mask_info[mask_id] = np.sort(sel[local])
    return mask_info


def associate_scene_exact(tensors, cfg, k_max: int = 127, *, device: DeviceLike = None,
                          timings: Optional[Dict[str, float]] = None) -> SceneAssociation:
    """Exact-parity SceneAssociation over all frames (host loop).

    Ascending-id overwrite order, shared-point zeroing into boundary, and
    first/last claim ids per point (construction.py:46-62). The planes are
    built on the host and uploaded to ``device`` once, at the end.
    ``timings``, when given, accumulates the ball-query wall
    (``associate.ball_query``) and its device-to-host pulls.
    """
    device = resolve_device(device)
    scene_points = np.asarray(tensors.scene_points, dtype=np.float64)
    f = len(tensors.frame_ids)
    n = len(scene_points)
    mop = np.zeros((f, n), dtype=np.int32)
    first = np.zeros((f, n), dtype=np.int32)
    last = np.zeros((f, n), dtype=np.int32)
    point_visible = np.zeros((f, n), dtype=bool)
    mask_valid = np.zeros((f, k_max + 1), dtype=bool)
    boundary = np.zeros(n, dtype=bool)

    for fi in range(f):
        if not tensors.frame_valid[fi]:
            continue
        mask_info = frame_backprojection_exact(
            scene_points,
            np.asarray(tensors.depths[fi]),
            np.asarray(tensors.segmentations[fi]),
            np.asarray(tensors.intrinsics[fi]),
            np.asarray(tensors.cam_to_world[fi]),
            distance_threshold=cfg.distance_threshold,
            depth_trunc=cfg.depth_trunc,
            few_points_threshold=cfg.few_points_threshold,
            coverage_threshold=cfg.coverage_threshold,
            denoise_eps=cfg.denoise_eps,
            denoise_min_points=cfg.denoise_min_points,
            device=device,
            timings=timings,
        )
        if not mask_info:
            continue
        frame_boundary = np.zeros(n, dtype=bool)
        appeared = np.zeros(n, dtype=bool)
        for mask_id in sorted(mask_info):
            if mask_id > k_max:
                continue
            pts = mask_info[mask_id]
            frame_boundary[pts] |= appeared[pts]
            mop[fi, pts] = mask_id
            first[fi, pts] = np.where(first[fi, pts] > 0,
                                      np.minimum(first[fi, pts], mask_id), mask_id)
            last[fi, pts] = np.maximum(last[fi, pts], mask_id)
            appeared[pts] = True
            point_visible[fi, pts] = True
            mask_valid[fi, mask_id] = True
        mop[fi, frame_boundary] = 0
        boundary |= frame_boundary

    def up(a):
        return torch.from_numpy(a).to(device)

    # int16 claim planes, as the dense path emits (mask ids <= k_max + 1 fit)
    return SceneAssociation(
        mask_of_point=up(mop),
        first_id=up(first.astype(np.int16)),
        last_id=up(last.astype(np.int16)),
        point_visible=up(point_visible),
        boundary=up(boundary),
        mask_valid=up(mask_valid),
    )
