"""Synthetic posed-RGB-D scene generator.

An analytically ray-traced scene of axis-aligned boxes on a floor: exact
depth maps, exact per-pixel object ids, and a surface-sampled scene point
cloud with per-point ground-truth instance labels. Per-frame mask ids are
randomly permuted per frame to emulate an instance segmenter's
frame-inconsistent numbering. The same seed gives the same scene as the JAX
package's generator, draw for draw.

``make_scene`` renders on the host (numpy). ``make_scene_device`` builds the
bench-scale scene (``synthetic.py:311-379``): the cheap parts on the host,
the frames rendered where they are used, by the ``render_depth_seg`` kernel
(``ops/cuda/render.cu``) on a card, or by its plain torch version
(:func:`render_depth_seg_reference`, the JAX package's chunked program) on
the CPU, bit-equal to the jitted JAX program.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

import torch

from maskclustering_tpu_torch.datasets.base import SceneTensors
from maskclustering_tpu_torch.device import DeviceLike, resolve_device
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


def render_depth_seg_reference(boxes: torch.Tensor, poses: torch.Tensor,
                               intrinsics: torch.Tensor, perms: torch.Tensor,
                               image_hw: Tuple[int, int],
                               box_chunk: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain torch version of the renderer: the JAX package's jitted
    program (``synthetic.py:257-303``) step for step, on the tensors' device.

    ``boxes`` (K, 2, 3) float32 are padded with zero boxes to whole chunks of
    ``box_chunk`` (masked out by index: the slab test ignores corner order,
    so a zero box would still be hit); ``poses`` (F, 4, 4), ``intrinsics``
    (F, 3, 3) float32, ``perms`` (F, K) int32 (entry k is the mask id of box
    k). Per frame, the ray directions ``d_cam @ R.T`` as XLA:CPU contracts
    them (``fma(dy, R[i,1], dx * R[i,0]) + R[i,2]``), then a slab test a
    chunk of boxes: an argmin inside the chunk (the first index on ties), a
    strict "closer" across chunks, then the floor plane z = 0. Returns
    (depths (F, H, W) float32, 0 where nothing is hit; segs (F, H, W) int32).
    """
    from maskclustering_tpu_torch.ops.geometry import fma

    h, w = image_hw
    dev = poses.device
    f32 = torch.float32
    k_total = boxes.shape[0]
    pad = -(-k_total // box_chunk) * box_chunk - k_total
    boxes_pad = torch.cat([boxes, boxes.new_zeros((pad, 2, 3))]) if pad else boxes
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.int32, device=dev),
                          torch.arange(w, dtype=torch.int32, device=dev), indexing="ij")
    u, v = u.reshape(-1).to(f32), v.reshape(-1).to(f32)
    eps = torch.full((), 1e-12, dtype=f32, device=dev)
    inf = torch.full((), float("inf"), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    n_chunks = boxes_pad.shape[0] // box_chunk
    real = torch.arange(n_chunks * box_chunk, device=dev) < k_total
    lut = torch.cat([torch.zeros((poses.shape[0], 1), dtype=torch.int32, device=dev),
                     perms.to(torch.int32)], dim=1)
    depths, segs = [], []
    for f in range(poses.shape[0]):
        k, c2w = intrinsics[f], poses[f]
        dx = (u - k[0, 2]) / k[0, 0]
        dy = (v - k[1, 2]) / k[1, 1]
        d_world = torch.stack([fma(dy, c2w[i, 1], dx * c2w[i, 0]) + c2w[i, 2]
                               for i in range(3)], dim=-1)  # (HW, 3)
        eye = c2w[:3, 3]
        safe_d = torch.where(d_world.abs() < eps, eps, d_world)
        t_best = torch.full((h * w,), float("inf"), dtype=f32, device=dev)
        hit = torch.zeros((h * w,), dtype=torch.int32, device=dev)
        for c in range(n_chunks):
            b = boxes_pad[c * box_chunk:(c + 1) * box_chunk]
            t1 = (b[:, 0][:, None, :] - eye) / safe_d[None]  # (C, HW, 3)
            t2 = (b[:, 1][:, None, :] - eye) / safe_d[None]
            tmin = torch.minimum(t1, t2).amax(dim=-1)
            tmax = torch.maximum(t1, t2).amin(dim=-1)
            ok = (tmax >= tmin) & (tmax > zero) & real[c * box_chunk:(c + 1) * box_chunk, None]
            t = torch.where(tmin > zero, tmin, tmax)
            t = torch.where(ok & (t > zero), t, inf)
            ci = torch.argmin(t, dim=0)
            tc = t.amin(dim=0)
            closer = tc < t_best
            t_best = torch.where(closer, tc, t_best)
            hit = torch.where(closer, c * box_chunk + ci.to(torch.int32) + 1, hit)
        dz = torch.where(d_world[:, 2].abs() < eps, eps, d_world[:, 2])
        t_floor = -eye[2] / dz
        floor_ok = (t_floor > zero) & (t_floor < t_best)
        t_best = torch.where(floor_ok, t_floor, t_best)
        hit = torch.where(floor_ok, 0, hit)
        depths.append(torch.where(torch.isfinite(t_best), t_best, zero).reshape(h, w))
        segs.append(lut[f][hit.long()].reshape(h, w))
    return torch.stack(depths), torch.stack(segs)


def render_depth_seg_device(boxes_arr: np.ndarray, poses: np.ndarray, intrinsics: np.ndarray,
                            perms: np.ndarray, image_hw: Tuple[int, int], *,
                            device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Analytic box-and-floor renderer with device-resident output
    (``synthetic.py:231-308``): (depths (F, H, W) float32, segs (F, H, W)
    int32) on ``device`` (``None``: the card; raises without one).

    Same geometry as ``make_scene``'s host renderer: the nearest box wins
    (the first index on exact ties), the floor plane z = 0 occludes when
    closer, and the per-frame mask ids come from ``perms`` (F, K), entry k
    the mask id of box k. On a CUDA device one ``render_depth_seg`` kernel
    launch renders every frame (or raises); on the CPU the plain version,
    :func:`render_depth_seg_reference`, does.
    """
    from maskclustering_tpu_torch.ops import cuda

    dev = resolve_device(device)
    boxes, poses, intrinsics = (torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
                                for a in (boxes_arr, poses, intrinsics))
    perms = torch.from_numpy(np.ascontiguousarray(perms, dtype=np.int32)).to(dev)
    h, w = image_hw
    if dev.type == "cuda":
        return cuda.render_depth_seg_cuda(boxes, poses, intrinsics, perms, height=h, width=w)
    if dev.type != "cpu":
        raise ValueError(f"render_depth_seg runs on CUDA or the CPU, got {dev}")
    cuda.note_plain("render_depth_seg", (poses.shape[0], boxes.shape[0], h, w))
    return render_depth_seg_reference(boxes, poses, intrinsics, perms, image_hw)


def make_scene_device(
    num_boxes: int = 36,
    num_frames: int = 250,
    image_hw: Tuple[int, int] = (480, 640),
    spacing: float = 0.025,
    floor_spacing: Optional[float] = 0.05,
    seed: int = 0,
    room_half: float = 4.0,
    camera_radius: float = 5.0,
    camera_height: float = 2.5,
    *,
    device: DeviceLike = None,
) -> Tuple[SceneTensors, np.ndarray, np.ndarray]:
    """Bench-scale synthetic scene with device-resident depth and id frames
    (``synthetic.py:311-379``).

    The host builds the cheap parts with the JAX generator's draws in its
    order (boxes, surface cloud, floor grid, poses and one id permutation a
    frame); the frames are rendered on ``device`` (``None``: the card).
    Returns (SceneTensors whose ``depths`` and ``segmentations`` are tensors
    on ``device``, gt_instance, object_of_mask).
    """
    rng = np.random.default_rng(seed)
    h, w = image_hw
    fx = fy = 1.1 * max(h, w)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    intr = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]], dtype=np.float32)

    boxes, room_half, scale = _place_boxes(num_boxes, room_half, rng)
    camera_radius *= scale
    camera_height *= scale
    boxes_arr = np.array([[b[0], b[1]] for b in boxes])

    pts, labels = [], []
    for i in range(num_boxes):
        p = _sample_box_surface(boxes[i][0], boxes[i][1], spacing, rng)
        pts.append(p)
        labels.append(np.full(len(p), i + 1))
    nf = int(2 * room_half / (floor_spacing or spacing))
    gx, gy = np.meshgrid(np.linspace(-room_half, room_half, nf),
                         np.linspace(-room_half, room_half, nf))
    p = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=1)
    pts.append(p + rng.normal(scale=spacing * 0.05, size=p.shape))
    labels.append(np.zeros(len(p), dtype=np.int64))
    scene_points = np.concatenate(pts).astype(np.float32)
    gt_instance = np.concatenate(labels).astype(np.int32)

    poses = np.zeros((num_frames, 4, 4), dtype=np.float32)
    perms = np.zeros((num_frames, num_boxes), dtype=np.int32)
    object_of_mask = np.zeros((num_frames, num_boxes + 1), dtype=np.int32)
    for f in range(num_frames):
        ang = 2 * np.pi * f / num_frames
        eye = np.array([camera_radius * np.cos(ang), camera_radius * np.sin(ang), camera_height])
        poses[f] = _look_at(eye, np.array([0, 0, 0.4]))
        perm = rng.permutation(num_boxes) + 1
        perms[f] = perm
        object_of_mask[f, perm] = np.arange(1, num_boxes + 1)
    intrs = np.tile(intr[None], (num_frames, 1, 1))

    depths, segs = render_depth_seg_device(boxes_arr, poses, intrs, perms, image_hw,
                                           device=device)
    tensors = SceneTensors(
        scene_points=scene_points,
        depths=depths,
        segmentations=segs,
        intrinsics=intrs,
        cam_to_world=poses,
        frame_valid=np.ones(num_frames, dtype=bool),
        frame_ids=list(range(num_frames)),
    )
    return tensors, gt_instance, object_of_mask


def visibility_count(scene: SyntheticScene, tol: float = 0.03) -> np.ndarray:
    """Frames in which each scene point passes the z-buffer test at its pixel
    (``synthetic.py:382-401``, host numpy)."""
    n = len(scene.scene_points)
    count = np.zeros(n, dtype=np.int32)
    for f in range(len(scene.depths)):
        c2w = scene.cam_to_world[f].astype(np.float64)
        w2c = np.linalg.inv(c2w)
        cam = scene.scene_points @ w2c[:3, :3].T + w2c[:3, 3]
        fx, fy = scene.intrinsics[f][0, 0], scene.intrinsics[f][1, 1]
        cx, cy = scene.intrinsics[f][0, 2], scene.intrinsics[f][1, 2]
        h, w = scene.depths[f].shape
        z = cam[:, 2]
        ok = z > 1e-6
        u = np.round(np.where(ok, cam[:, 0] / np.where(ok, z, 1) * fx + cx, -1)).astype(int)
        v = np.round(np.where(ok, cam[:, 1] / np.where(ok, z, 1) * fy + cy, -1)).astype(int)
        inb = ok & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        d = np.zeros(n)
        d[inb] = scene.depths[f][v[inb], u[inb]]
        count += (inb & (d > 0) & (np.abs(z - d) <= tol)).astype(np.int32)
    return count


def resize_scene_points(points: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    """Pad or trim a synthetic cloud to a static benchmark size
    (``synthetic.py:404-418``): an undersized cloud tiles, an oversized one
    takes a seeded uniform subsample. Every measurement tool resamples
    through it, so they all measure the same cloud for a given seed."""
    if points.shape[0] < n:
        points = np.tile(points, (-(-n // points.shape[0]), 1))[:n]
    elif points.shape[0] > n:
        idx = np.random.default_rng(seed).choice(points.shape[0], n, replace=False)
        points = points[idx]
    return np.ascontiguousarray(points, dtype=np.float32)


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
    id-map times 40, mod 256, as grey RGB). Every file is the JAX writer's,
    byte for byte: the colour through the port's libjpeg-equal encoder at
    PIL's quality 75 (``io/jpeg.py``), the depth and mask PNGs through the
    writers that give cv2's and PIL's bytes (``io/image.py``).
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
