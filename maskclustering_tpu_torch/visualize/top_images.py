"""Debug images: object re-projection with z-buffered splatting + 3x3 grids.

Port of ``maskclustering_tpu/visualize/top_images.py``. For each object of
a scene and each of its representative frames, the object's points are
splatted into the frame with a z-buffer; the box around the pixels they
hit is drawn in red on the frame, and the frames of an object are stitched
into a grid of up to 3x3 cells.

Three hand-written kernels of ``ops/cuda/splat.cu`` run on a CUDA device,
each a launch for all the (F, 16) cameras it is given:
:func:`project_zbuffer` launches a depth pass of integer ``atomicMin`` on
the float bits, then a colour pass of ``atomicMax`` on the packed RGB, for
its one camera; :func:`bboxes_by_projection`, which is all that
``save_debug_grids`` needs, launches the box as a min/max reduction over
the points that land at a finite depth in each of an object's frames,
with no buffer at all. On the CPU the plain versions run:
:func:`splat_depth_reference` and :func:`splat_color_reference`, the same
scatters as ``scatter_reduce_`` over the same int32 views, and
:func:`splat_bbox_reference`, a masked ``amin``/``amax``. All round as the
JAX package's jitted program does (see ``splat.cu``), so the images, depth
buffers, visibility masks and boxes are bit-equal to it. Files go through
the port's PNG writer, byte for byte what PIL's ``save`` writes.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from maskclustering_tpu_torch.device import DeviceLike, resolve_device
from maskclustering_tpu_torch.io.image import resize_pil
from maskclustering_tpu_torch.io.png import encode_png_pillow
from maskclustering_tpu_torch.ops.geometry import invert_se3, transform_points

_INF_BITS = 0x7F800000
_TWO31 = 2.0 ** 31


def _as_f32(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           dtype=torch.float32).to(device).contiguous()


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts: toward zero, saturating, NaN -> 0."""
    big = x >= _TWO31
    small = x < -_TWO31
    nan = torch.isnan(x)
    out = torch.where(big | small | nan, torch.zeros_like(x), x).to(torch.int32)
    out = torch.where(big, torch.full_like(out, 2 ** 31 - 1), out)
    return torch.where(small, torch.full_like(out, -2 ** 31), out)


def _host_f32(x) -> torch.Tensor:
    """``x`` as a float32 tensor where it lies (numpy and lists on the host)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def splat_params(intrinsics: torch.Tensor, cam_to_world: torch.Tensor) -> torch.Tensor:
    """The float32 cameras of ``ops/cuda/splat.cu``, (..., 16) for (..., 3, 3)
    intrinsics and (..., 4, 4) poses: the world-to-camera rotation
    (row-major) and translation, then fx, fy, cx, cy. A stack gives each
    camera's bits as a call of its own would."""
    w2c = invert_se3(cam_to_world)
    lead = w2c.shape[:-2]
    return torch.cat([w2c[..., :3, :3].reshape(lead + (9,)), w2c[..., :3, 3],
                      intrinsics[..., 0, 0:1], intrinsics[..., 1, 1:2],
                      intrinsics[..., 0, 2:3], intrinsics[..., 1, 2:3]], dim=-1).contiguous()


def _camera_params(intrinsics, cam_to_world, dev: torch.device) -> torch.Tensor:
    """:func:`splat_params` of the cameras, computed where they lie (the
    host, for the datasets' arrays) and moved to ``dev`` in one copy."""
    return splat_params(_host_f32(intrinsics), _host_f32(cam_to_world)).to(dev)


def _unpack(codebuf: torch.Tensor, height: int, width: int) -> torch.Tensor:
    flat = codebuf[:height * width]
    return torch.stack([(flat >> 16) & 0xFF, (flat >> 8) & 0xFF, flat & 0xFF],
                       dim=-1).to(torch.uint8).reshape(height, width, 3)


def _project(points: torch.Tensor, params: torch.Tensor, height: int, width: int):
    """(valid (F, N) bool, pixel (F, N) int64 with H*W where not valid, camera
    depth (F, N) float32) of each point in each of the (F, 16) cameras,
    rounded as ``splat.cu``'s project()."""
    f = params.shape[0]
    mat = torch.zeros((f, 4, 4), dtype=torch.float32, device=points.device)
    mat[:, :3, :3] = params[:, :9].reshape(f, 3, 3)
    mat[:, :3, 3] = params[:, 9:12]
    fx, fy, cx, cy = (params[:, k:k + 1] for k in range(12, 16))
    cam = transform_points(points.expand(f, -1, -1), mat)
    z = cam[..., 2]
    in_front = z > 1e-6
    safe_z = torch.where(in_front, z, torch.ones_like(z))
    px = _to_int32(torch.round(fx * cam[..., 0] / safe_z + cx))
    py = _to_int32(torch.round(fy * cam[..., 1] / safe_z + cy))
    valid = in_front & (px >= 0) & (px < width) & (py >= 0) & (py < height)
    # invalid points go to a dump slot past the image
    lin = torch.where(valid, py.long() * width + px.long(),
                      torch.full_like(px, height * width, dtype=torch.int64))
    return valid, lin, z


def splat_depth_reference(points: torch.Tensor, params: torch.Tensor, height: int,
                          width: int) -> torch.Tensor:
    """The plain depth pass, on any device: the (F, H*W + 1) int32 buffers of
    ``splat_depth_cuda`` (float32 bits of each pixel's nearest depth), as a
    ``scatter_reduce_`` amin over the depths' int32 views, for the (F, 16)
    cameras ``params``."""
    valid, lin, z = _project(points, params, height, width)
    zbits = torch.where(valid, z, torch.full_like(z, float("inf"))).view(torch.int32)
    zbuf = torch.full((params.shape[0], height * width + 1), _INF_BITS, dtype=torch.int32,
                      device=points.device)
    return zbuf.scatter_reduce_(1, lin, zbits, "amin")


def splat_color_reference(points: torch.Tensor, colors: torch.Tensor, params: torch.Tensor,
                          zbuf: torch.Tensor, height: int, width: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain colour pass, on any device: ``(codebuf (F, H*W + 1) int32,
    visible (F, N) bool)`` of ``splat_color_cuda``, as a ``scatter_reduce_``
    amax of the packed colours of the visible points, for the (F, 16)
    cameras ``params``."""
    valid, lin, z = _project(points, params, height, width)
    zmap = zbuf.view(torch.float32)
    visible = valid & (z <= zmap.gather(1, lin))
    rgb8 = _to_int32(colors * 255.0).clamp(0, 255)
    code = (rgb8[:, 0] << 16) | (rgb8[:, 1] << 8) | rgb8[:, 2]
    codebuf = torch.zeros((params.shape[0], height * width + 1), dtype=torch.int32,
                          device=points.device)
    codebuf.scatter_reduce_(1, lin, torch.where(visible, code, torch.zeros_like(code)), "amax")
    return codebuf, visible


_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1


def splat_bbox_reference(points: torch.Tensor, params: torch.Tensor, height: int,
                         width: int) -> torch.Tensor:
    """The plain box, on any device: ``splat_bbox_cuda``'s (F, 4) int32 (min
    px, min py, max px, max py) over the points that are valid and in front
    of +inf, (INT32_MAX, INT32_MAX, INT32_MIN, INT32_MIN) where there is
    none, for the (F, 16) cameras ``params``."""
    valid, lin, z = _project(points, params, height, width)
    keep = valid & (z < float("inf"))
    if points.shape[0] == 0:
        full = lambda v: torch.full((params.shape[0], 2), v, dtype=torch.int32,  # noqa: E731
                                    device=points.device)
        return torch.cat([full(_INT32_MAX), full(_INT32_MIN)], dim=1)
    px, py = (lin % width).to(torch.int32), (lin // width).to(torch.int32)
    lo, hi = torch.full_like(px, _INT32_MAX), torch.full_like(px, _INT32_MIN)
    return torch.stack([torch.where(keep, px, lo).amin(dim=1),
                        torch.where(keep, py, lo).amin(dim=1),
                        torch.where(keep, px, hi).amax(dim=1),
                        torch.where(keep, py, hi).amax(dim=1)], dim=1)


def project_zbuffer(points, colors, intrinsics, cam_to_world, height: int, width: int, *,
                    device: DeviceLike = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Splat points (N, 3) with colours (N, 3) in [0, 1] into an (H, W, 3)
    image with z-buffering (``top_images.py:24-62``).

    Returns ``(image uint8 (H, W, 3), zbuf float32 (H, W) with inf where
    empty, visible bool (N,))`` on ``device`` (default: the CUDA card). Each
    pixel shows the nearest point; among points at the same depth, the
    largest packed colour wins whole. On CUDA this launches ``splat_depth``
    and ``splat_color`` once each; on the CPU it runs the plain version."""
    dev = resolve_device(device)
    pts = _as_f32(points, dev).reshape(-1, 3)
    cols = _as_f32(colors, dev).reshape(-1, 3)
    params = _camera_params(_host_f32(intrinsics)[None], _host_f32(cam_to_world)[None], dev)
    if dev.type == "cuda":
        from maskclustering_tpu_torch.ops.cuda import splat_color_cuda, splat_depth_cuda

        zbuf = splat_depth_cuda(pts, params, height=height, width=width)
        codebuf, visible = splat_color_cuda(pts, cols, params, zbuf, height=height,
                                            width=width)
    elif dev.type == "cpu":
        from maskclustering_tpu_torch.ops.cuda import note_plain

        for entry in ("splat_depth", "splat_color"):
            note_plain(entry, (1, pts.shape[0], height, width))
        zbuf = splat_depth_reference(pts, params, height, width)
        codebuf, visible = splat_color_reference(pts, cols, params, zbuf, height, width)
    else:
        raise ValueError(f"project_zbuffer runs on cuda or cpu, got {dev}")
    zmap = zbuf[0, :height * width].view(torch.float32).reshape(height, width)
    return _unpack(codebuf[0], height, width), zmap, visible[0]


def bboxes_by_projection(points, intrinsics, cam_to_world, image_hw: Tuple[int, int], *,
                         device: DeviceLike = None
                         ) -> List[Optional[Tuple[int, int, int, int]]]:
    """For each of F cameras, (F, 3, 3) intrinsics and (F, 4, 4) poses, the
    (px_min, py_min, px_max, py_max) of the object's visible pixels, or None
    when nothing projects into the frame (``top_images.py:66-81``).

    The box of the pixels whose splatted depth is finite is the box of the
    points that land in the image at a finite depth, so no buffer is made:
    on CUDA one ``splat_bbox`` launch reduces the F boxes, on the CPU its
    plain version does, and one (F, 4) pull brings them to the host."""
    h, w = image_hw
    dev = resolve_device(device)
    pts = _as_f32(points, dev).reshape(-1, 3)
    params = _camera_params(intrinsics, cam_to_world, dev).reshape(-1, 16)
    if params.shape[0] == 0:
        return []
    if dev.type == "cuda":
        from maskclustering_tpu_torch.ops.cuda import splat_bbox_cuda

        box = splat_bbox_cuda(pts, params, height=h, width=w)
    elif dev.type == "cpu":
        from maskclustering_tpu_torch.ops.cuda import note_plain

        note_plain("splat_bbox", (params.shape[0], pts.shape[0], h, w))
        box = splat_bbox_reference(pts, params, h, w)
    else:
        raise ValueError(f"bboxes_by_projection runs on cuda or cpu, got {dev}")
    return [None if x0 > x1 else (x0, y0, x1, y1) for x0, y0, x1, y1 in box.cpu().tolist()]


def bbox_by_projection(points, intrinsics, cam_to_world, image_hw: Tuple[int, int], *,
                       device: DeviceLike = None) -> Optional[Tuple[int, int, int, int]]:
    """(px_min, py_min, px_max, py_max) of the object's visible pixels, or
    None when nothing projects into the frame (``top_images.py:66-81``): the
    one-frame case of :func:`bboxes_by_projection`."""
    return bboxes_by_projection(points, _host_f32(intrinsics)[None],
                                _host_f32(cam_to_world)[None], image_hw, device=device)[0]


def draw_bbox(rgb: np.ndarray, bbox: Optional[Tuple[int, int, int, int]],
              color=(255, 0, 0), thickness: int = 4) -> np.ndarray:
    """Red rectangle on a copy of the image (``top_images.py:84-99``)."""
    out = np.asarray(rgb).copy()
    if bbox is None:
        return out
    h, w = out.shape[:2]
    x0, y0, x1, y1 = (int(v) for v in bbox)
    x0, x1 = np.clip([x0, x1], 0, w - 1)
    y0, y1 = np.clip([y0, y1], 0, h - 1)
    t = thickness
    out[max(0, y0 - t // 2):y0 + t, x0:x1 + 1] = color
    out[max(0, y1 - t // 2):min(h, y1 + t), x0:x1 + 1] = color
    out[y0:y1 + 1, max(0, x0 - t // 2):x0 + t] = color
    out[y0:y1 + 1, max(0, x1 - t // 2):min(w, x1 + t)] = color
    return out


def stitch_grid(images: Sequence[np.ndarray], cell: int = 512, cols: int = 3) -> np.ndarray:
    """Up-to-3x3 black-background grid (``top_images.py:102-117``); each
    image is resized to ``cell`` x ``cell`` as PIL's default ``resize`` does
    (bicubic)."""
    n = min(cols * cols, len(images))
    if n == 0:
        return np.zeros((cell, cell, 3), dtype=np.uint8)
    rows = int(np.ceil(n / cols))
    use_cols = cols if n > 1 else 1
    canvas = np.zeros((rows * cell, use_cols * cell, 3), dtype=np.uint8)
    for i in range(n):
        r, c = divmod(i, cols)
        canvas[r * cell:(r + 1) * cell, c * cell:(c + 1) * cell] = resize_pil(
            np.asarray(images[i]), cell, cell, "bicubic")
    return canvas


def _write_png(job: Tuple[str, np.ndarray]) -> None:
    path, img = job
    with open(path, "wb") as f:
        f.write(encode_png_pillow(img))


# PNG writers of save_debug_grids: zlib and numpy release the GIL, so one
# object's files compress while the next object's frames are splatted
_WRITERS = min(8, os.cpu_count() or 1)
# decoded colour frames save_debug_grids keeps (objects share frames)
_FRAME_CACHE = 32


def _object_boxes(dataset, obj_points: torch.Tensor, frame_ids: Sequence, rgbs: Sequence,
                  dev: torch.device) -> List[Optional[Tuple[int, int, int, int]]]:
    """The boxes of an object in its frames: one launch and one pull for all
    the frames of one image size (a scan's frames share one)."""
    boxes: List[Optional[Tuple[int, int, int, int]]] = [None] * len(frame_ids)
    by_size: Dict[Tuple[int, int], List[int]] = {}
    for k, rgb in enumerate(rgbs):
        by_size.setdefault(tuple(rgb.shape[:2]), []).append(k)
    for hw, ks in by_size.items():
        intr = np.stack([dataset.get_intrinsics(frame_ids[k]) for k in ks])
        extr = np.stack([dataset.get_extrinsic(frame_ids[k]) for k in ks])
        for k, box in zip(ks, bboxes_by_projection(obj_points, intr, extr, hw, device=dev)):
            boxes[k] = box
    return boxes


def save_debug_grids(dataset, object_dict: Dict[int, dict], scene_points,
                     save_root_dir: str, max_objects: Optional[int] = None, *,
                     device: DeviceLike = None) -> List[str]:
    """Per object: bbox images for its representative frames + a 3x3 grid
    (``top_images.py:120-161``), the splats on ``device`` (default: the
    CUDA card). ``object_dict`` is the clustering artifact {idx:
    {point_ids, mask_list, repre_mask_list}}; each repre_mask entry is
    (frame_id, mask_id, coverage). Writes
    ``bbox/{key}_{conf:.3f}_{frame_id}_.png`` and ``grid/{key}.png`` under
    ``save_root_dir``; returns the grid paths.

    The files are the JAX package's byte for byte. The last
    ``_FRAME_CACHE`` decoded colour frames are kept, and an object's PNG
    files are encoded on a pool of threads while the next object's frames
    are splatted and drawn."""
    dev = resolve_device(device)
    grid_dir = os.path.join(save_root_dir, "grid")
    bbox_dir = os.path.join(save_root_dir, "bbox")
    os.makedirs(grid_dir, exist_ok=True)
    os.makedirs(bbox_dir, exist_ok=True)
    cloud = _as_f32(scene_points, dev).reshape(-1, 3)
    frames: "OrderedDict" = OrderedDict()
    grids = []
    keys = sorted(object_dict.keys())
    if max_objects is not None:
        keys = keys[:max_objects]
    with ThreadPoolExecutor(_WRITERS, thread_name_prefix="vis-png") as pool:
        pending = iter(())
        for key in keys:
            entry = object_dict[key]
            ids = torch.as_tensor(np.asarray(entry["point_ids"], dtype=np.int64)).to(dev)
            obj_points = cloud[ids]
            repre = entry.get("repre_mask_list", [])
            rgbs = []
            for frame_id, _, _ in repre:
                if frame_id not in frames:
                    frames[frame_id] = dataset.get_rgb(frame_id)
                    if len(frames) > _FRAME_CACHE:
                        frames.popitem(last=False)
                frames.move_to_end(frame_id)
                rgbs.append(frames[frame_id])
            boxes = _object_boxes(dataset, obj_points, [f for f, _, _ in repre], rgbs, dev)
            images, jobs = [], []
            for (frame_id, _, conf), rgb, bbox in zip(repre, rgbs, boxes):
                bbox_image = draw_bbox(rgb, bbox)
                images.append(bbox_image)
                jobs.append((os.path.join(bbox_dir, f"{key}_{float(conf):.3f}_{frame_id}_.png"),
                             bbox_image))
            grid_path = os.path.join(grid_dir, f"{key}.png")
            jobs.append((grid_path, stitch_grid(images)))
            grids.append(grid_path)
            list(pending)  # the previous object's files are written (or raise)
            pending = pool.map(_write_png, jobs)
        list(pending)
    return grids
