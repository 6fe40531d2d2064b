"""Synthetic posed-RGB-D scene generator (host numpy).

An analytically ray-traced scene of axis-aligned boxes on a floor: exact
depth maps, exact per-pixel object ids, and a surface-sampled scene point
cloud with per-point ground-truth instance labels. Per-frame mask ids are
randomly permuted per frame to emulate an instance segmenter's
frame-inconsistent numbering. The same seed gives the same scene as the JAX
package's generator, draw for draw.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from maskclustering_tpu_torch.datasets.base import SceneTensors
from maskclustering_tpu_torch.io.image import write_depth_png, write_mask_png
from maskclustering_tpu_torch.io.jpeg import write_jpeg
from maskclustering_tpu_torch.io.ply import write_ply_points


@dataclasses.dataclass
class SyntheticScene:
    scene_points: np.ndarray  # (N, 3) float32
    gt_instance: np.ndarray  # (N,) int32, 0 = floor/none, 1..K = boxes
    depths: np.ndarray  # (F, H, W) float32
    segmentations: np.ndarray  # (F, H, W) int32 (per-frame permuted ids)
    object_of_mask: np.ndarray  # (F, K+1) int32: per-frame mask id -> gt object id
    intrinsics: np.ndarray  # (F, 3, 3)
    cam_to_world: np.ndarray  # (F, 4, 4)
    frame_valid: np.ndarray  # (F,) bool
    frame_ids: List[int]
    boxes: np.ndarray  # (K, 2, 3) min/max corners


def _look_at(eye: np.ndarray, target: np.ndarray, up=(0, 0, 1.0)) -> np.ndarray:
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    # camera convention: +x right, +y down, +z forward (OpenCV)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return c2w


def _ray_box(o: np.ndarray, d: np.ndarray, bmin: np.ndarray, bmax: np.ndarray):
    """Slab-method ray/AABB intersection. o: (3,), d: (...,3). Returns t or inf."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (bmin - o) / d
        t2 = (bmax - o) / d
    tmin = np.minimum(t1, t2).max(axis=-1)
    tmax = np.maximum(t1, t2).min(axis=-1)
    hit = (tmax >= tmin) & (tmax > 0)
    t = np.where(tmin > 0, tmin, tmax)
    return np.where(hit & (t > 0), t, np.inf)


_BOX_HALF_MAX = 0.45  # upper bound of the per-box half extents drawn below


def _place_boxes(k_total: int, room_half: float, rng,
                 min_gap: float = 0.2) -> Tuple[list, float, float]:
    """Grid box placement with a guaranteed minimum inter-box gap.

    Returns ``(boxes [(bmin, bmax)], room_half_eff, scale)``; the room grows
    just enough that neighbouring boxes never touch.
    """
    g = max(2, int(np.ceil(np.sqrt(k_total))))
    spacing = 2 * room_half * 0.6 / (g - 1)
    need = 2 * _BOX_HALF_MAX + min_gap
    scale = max(1.0, need / spacing)
    room_half_eff = room_half * scale
    grid = np.linspace(-room_half_eff * 0.6, room_half_eff * 0.6, g)
    centers = [(gx, gy) for gx in grid for gy in grid]
    rng.shuffle(centers)
    boxes = []
    for i in range(k_total):
        cx_, cy_ = centers[i]
        half = rng.uniform(0.25, _BOX_HALF_MAX, size=2)
        height = rng.uniform(0.4, 0.9)
        boxes.append((np.array([cx_ - half[0], cy_ - half[1], 0.0]),
                      np.array([cx_ + half[0], cy_ + half[1], height])))
    return boxes, room_half_eff, scale


def _sample_box_surface(bmin, bmax, spacing, rng) -> np.ndarray:
    pts = []
    ext = bmax - bmin
    for axis in range(3):
        u, v = [a for a in range(3) if a != axis]
        nu = max(2, int(np.ceil(ext[u] / spacing)))
        nv = max(2, int(np.ceil(ext[v] / spacing)))
        gu, gv = np.meshgrid(np.linspace(0, ext[u], nu), np.linspace(0, ext[v], nv))
        sides = (bmin[axis], bmax[axis]) if axis != 2 else (bmax[axis],)
        # bottom face (z = bmin) skipped: coplanar with the floor, never visible
        for side_val in sides:
            p = np.zeros((gu.size, 3))
            p[:, u] = gu.ravel() + bmin[u]
            p[:, v] = gv.ravel() + bmin[v]
            p[:, axis] = side_val
            pts.append(p)
    out = np.concatenate(pts, axis=0)
    return out + rng.normal(scale=spacing * 0.05, size=out.shape)


def make_scene(
    num_boxes: int = 4,
    num_frames: int = 12,
    image_hw: Tuple[int, int] = (96, 128),
    spacing: float = 0.02,
    seed: int = 0,
    room_half: float = 2.0,
    camera_radius: float = 3.2,
    camera_height: float = 2.2,
    ghost_box: bool = False,
    floor_points: bool = True,
    id_permutation: bool = True,
    floor_spacing: Optional[float] = None,
) -> SyntheticScene:
    """Build a synthetic scene.

    ghost_box: adds one box visible in depth/segmentation but absent from
    the scene cloud — its masks must be rejected by the coverage filter.
    """
    rng = np.random.default_rng(seed)
    h, w = image_hw
    fx = fy = 1.1 * max(h, w)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    intr = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    k_total = num_boxes + (1 if ghost_box else 0)
    boxes, room_half, scale = _place_boxes(k_total, room_half, rng)
    camera_radius *= scale
    camera_height *= scale
    boxes_arr = np.array([[b[0], b[1]] for b in boxes])

    # scene cloud: sampled surfaces of real boxes (+ floor), labeled
    pts, labels = [], []
    for i in range(num_boxes):  # ghost box (index num_boxes) excluded
        p = _sample_box_surface(boxes[i][0], boxes[i][1], spacing, rng)
        pts.append(p)
        labels.append(np.full(len(p), i + 1))
    if floor_points:
        nf = int(2 * room_half / (floor_spacing or spacing))
        gx, gy = np.meshgrid(np.linspace(-room_half, room_half, nf),
                             np.linspace(-room_half, room_half, nf))
        p = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=1)
        pts.append(p + rng.normal(scale=spacing * 0.05, size=p.shape))
        labels.append(np.zeros(len(p), dtype=np.int64))
    scene_points = np.concatenate(pts).astype(np.float32)
    gt_instance = np.concatenate(labels).astype(np.int32)

    # cameras on a circle, looking at the room center
    depths = np.zeros((num_frames, h, w), dtype=np.float32)
    segs = np.zeros((num_frames, h, w), dtype=np.int32)
    poses = np.zeros((num_frames, 4, 4), dtype=np.float32)
    intrs = np.tile(intr[None], (num_frames, 1, 1)).astype(np.float32)
    object_of_mask = np.zeros((num_frames, k_total + 1), dtype=np.int32)

    v, u = np.mgrid[0:h, 0:w]
    d_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u, dtype=np.float64)], axis=-1)

    for f in range(num_frames):
        ang = 2 * np.pi * f / num_frames
        eye = np.array([camera_radius * np.cos(ang), camera_radius * np.sin(ang), camera_height])
        c2w = _look_at(eye, np.array([0, 0, 0.4]))
        poses[f] = c2w
        d_world = d_cam @ c2w[:3, :3].T  # unnormalized; t == camera depth z
        t_best = np.full((h, w), np.inf)
        hit_id = np.zeros((h, w), dtype=np.int32)
        bchunk = 8  # one broadcast slab test per chunk of boxes
        for s in range(0, k_total, bchunk):
            bmin = boxes_arr[s : s + bchunk, 0][:, None, None, :]
            bmax = boxes_arr[s : s + bchunk, 1][:, None, None, :]
            t = _ray_box(eye, d_world[None], bmin, bmax)  # (C, h, w)
            ci = np.argmin(t, axis=0)
            tc = np.take_along_axis(t, ci[None], axis=0)[0]
            closer = tc < t_best
            t_best = np.where(closer, tc, t_best)
            hit_id = np.where(closer, s + ci.astype(np.int32) + 1, hit_id)
        # floor plane z=0
        with np.errstate(divide="ignore", invalid="ignore"):
            t_floor = -eye[2] / d_world[..., 2]
        floor_ok = (t_floor > 0) & (t_floor < t_best)
        t_best = np.where(floor_ok, t_floor, t_best)
        hit_id = np.where(floor_ok, 0, hit_id)

        depths[f] = np.where(np.isfinite(t_best), t_best, 0.0).astype(np.float32)
        perm = rng.permutation(k_total) + 1 if id_permutation else np.arange(1, k_total + 1)
        lut = np.zeros(k_total + 1, dtype=np.int32)
        lut[1:] = perm
        segs[f] = lut[hit_id]
        object_of_mask[f, perm] = np.arange(1, k_total + 1)

    return SyntheticScene(
        scene_points=scene_points,
        gt_instance=gt_instance,
        depths=depths,
        segmentations=segs,
        object_of_mask=object_of_mask,
        intrinsics=intrs,
        cam_to_world=poses,
        frame_valid=np.ones(num_frames, dtype=bool),
        frame_ids=list(range(num_frames)),
        boxes=boxes_arr,
    )


def add_depth_noise(scene: SyntheticScene, sigma: float, seed: int) -> None:
    """Gaussian depth noise on the valid pixels, in place (floored at 1 mm).

    A noiseless flat floor makes the reference's strict bbox crop
    degenerate in z; real sensor noise avoids it.
    """
    rng = np.random.default_rng(seed)
    noisy = scene.depths + rng.normal(scale=sigma, size=scene.depths.shape).astype(np.float32)
    scene.depths[:] = np.where(scene.depths > 0, np.maximum(noisy, 1e-3), 0.0)


def to_scene_tensors(scene: SyntheticScene) -> SceneTensors:
    return SceneTensors(
        scene_points=scene.scene_points,
        depths=scene.depths,
        segmentations=scene.segmentations,
        intrinsics=scene.intrinsics,
        cam_to_world=scene.cam_to_world,
        frame_valid=scene.frame_valid,
        frame_ids=scene.frame_ids,
    )


def write_scannet_layout(scene: SyntheticScene, data_root: str, seq_name: str,
                         gt_label_id: int = 3) -> str:
    """Write a synthetic scene to disk in the ScanNet processed layout
    (``utils/synthetic.py:435-473``), with the port's PNG and PLY writers.

    Produces what ``ScanNetDataset`` and the batch driver read: depth/
    (16-bit millimetres), output/mask/ id-maps, pose/, intrinsic/, the
    vh_clean_2 cloud, color/, and a benchmark GT txt (label * 1000 + inst +
    1; the unannotated floor = 1) under ``<data_root>/scannet/gt``. The
    colour frames are ``<frame id>.jpg`` with the JAX writer's pixels (the
    id-map times 40, mod 256, as grey RGB), encoded by the port's baseline
    4:2:0 quality-75 encoder (``io/jpeg.py``) where the JAX writer uses
    PIL's: the files differ in bytes, not in kind.
    """
    root = os.path.join(data_root, "scannet", "processed", seq_name)
    for sub in ("color", "depth", "pose", "intrinsic", os.path.join("output", "mask")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    intr4 = np.eye(4)
    intr4[:3, :3] = scene.intrinsics[0]
    np.savetxt(os.path.join(root, "intrinsic", "intrinsic_depth.txt"), intr4)
    for f, fid in enumerate(scene.frame_ids):
        write_depth_png(os.path.join(root, "depth", f"{fid}.png"), scene.depths[f] * 1000.0)
        seg = scene.segmentations[f]
        write_mask_png(os.path.join(root, "output", "mask", f"{fid}.png"), seg)
        write_jpeg(os.path.join(root, "color", f"{fid}.jpg"),
                   np.stack([(seg * 40 % 256).astype(np.uint8)] * 3, axis=-1))
        np.savetxt(os.path.join(root, "pose", f"{fid}.txt"),
                   scene.cam_to_world[f].astype(np.float64))
    write_ply_points(os.path.join(root, f"{seq_name}_vh_clean_2.ply"), scene.scene_points)
    gt_dir = os.path.join(data_root, "scannet", "gt")
    os.makedirs(gt_dir, exist_ok=True)
    gt = np.where(scene.gt_instance > 0, gt_label_id * 1000 + scene.gt_instance + 1, 1)
    np.savetxt(os.path.join(gt_dir, f"{seq_name}.txt"), gt, fmt="%d")
    return root
