"""Debug images: object re-projection with z-buffered splatting + 3x3 grids.

Port of ``maskclustering_tpu/visualize/top_images.py``. For each object of
a scene and each of its representative frames, the object's points are
splatted into the frame with a z-buffer; the box around the pixels they
hit is drawn in red on the frame, and the frames of an object are stitched
into a grid of up to 3x3 cells.

The splat, :func:`project_zbuffer`, launches the two hand-written kernels
of ``ops/cuda/splat.cu`` on a CUDA device (a depth pass of integer
``atomicMin`` on the float bits, then a colour pass of ``atomicMax`` on the
packed RGB); on the CPU it runs :func:`splat_depth_reference` and
:func:`splat_color_reference`, the same two scatters as ``scatter_reduce_``
over the same int32 views. Both round
as the JAX package's jitted program does (see ``splat.cu``), so the images,
depth buffers and visibility masks are bit-equal to it. Files go through
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


def splat_params(intrinsics: torch.Tensor, cam_to_world: torch.Tensor) -> torch.Tensor:
    """The (16,) float32 camera of ``ops/cuda/splat.cu``: the world-to-camera
    rotation (row-major) and translation, then fx, fy, cx, cy."""
    w2c = invert_se3(cam_to_world)
    return torch.cat([w2c[:3, :3].reshape(-1), w2c[:3, 3],
                      intrinsics[0, 0].reshape(1), intrinsics[1, 1].reshape(1),
                      intrinsics[0, 2].reshape(1), intrinsics[1, 2].reshape(1)]).contiguous()


def _unpack(codebuf: torch.Tensor, height: int, width: int) -> torch.Tensor:
    flat = codebuf[:height * width]
    return torch.stack([(flat >> 16) & 0xFF, (flat >> 8) & 0xFF, flat & 0xFF],
                       dim=-1).to(torch.uint8).reshape(height, width, 3)


def _project(points: torch.Tensor, params: torch.Tensor, height: int, width: int):
    """(valid (N,) bool, pixel (N,) int64 with H*W where not valid, camera
    depth (N,) float32) of each point, rounded as ``splat.cu``'s project()."""
    mat = torch.zeros((4, 4), dtype=torch.float32, device=points.device)
    mat[:3, :3] = params[:9].reshape(3, 3)
    mat[:3, 3] = params[9:12]
    fx, fy, cx, cy = params[12], params[13], params[14], params[15]
    cam = transform_points(points, mat)
    z = cam[:, 2]
    in_front = z > 1e-6
    safe_z = torch.where(in_front, z, torch.ones_like(z))
    px = _to_int32(torch.round(fx * cam[:, 0] / safe_z + cx))
    py = _to_int32(torch.round(fy * cam[:, 1] / safe_z + cy))
    valid = in_front & (px >= 0) & (px < width) & (py >= 0) & (py < height)
    # invalid points go to a dump slot past the image
    lin = torch.where(valid, py.long() * width + px.long(),
                      torch.full_like(px, height * width, dtype=torch.int64))
    return valid, lin, z


def splat_depth_reference(points: torch.Tensor, params: torch.Tensor, height: int,
                          width: int) -> torch.Tensor:
    """The plain depth pass, on any device: the (H*W + 1) int32 buffer of
    ``splat_depth_cuda`` (float32 bits of each pixel's nearest depth), as a
    ``scatter_reduce_`` amin over the depths' int32 views."""
    valid, lin, z = _project(points, params, height, width)
    zbits = torch.where(valid, z, torch.full_like(z, float("inf"))).view(torch.int32)
    zbuf = torch.full((height * width + 1,), _INF_BITS, dtype=torch.int32, device=points.device)
    return zbuf.scatter_reduce_(0, lin, zbits, "amin")


def splat_color_reference(points: torch.Tensor, colors: torch.Tensor, params: torch.Tensor,
                          zbuf: torch.Tensor, height: int, width: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain colour pass, on any device: ``(codebuf (H*W + 1) int32,
    visible (N,) bool)`` of ``splat_color_cuda``, as a ``scatter_reduce_``
    amax of the packed colours of the visible points."""
    valid, lin, z = _project(points, params, height, width)
    visible = valid & (z <= zbuf.view(torch.float32)[lin])
    rgb8 = _to_int32(colors * 255.0).clamp(0, 255)
    code = (rgb8[:, 0] << 16) | (rgb8[:, 1] << 8) | rgb8[:, 2]
    codebuf = torch.zeros((height * width + 1,), dtype=torch.int32, device=points.device)
    codebuf.scatter_reduce_(0, lin, torch.where(visible, code, torch.zeros_like(code)), "amax")
    return codebuf, visible


def project_zbuffer(points, colors, intrinsics, cam_to_world, height: int, width: int, *,
                    device: DeviceLike = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Splat points (N, 3) with colours (N, 3) in [0, 1] into an (H, W, 3)
    image with z-buffering (``top_images.py:24-62``).

    Returns ``(image uint8 (H, W, 3), zbuf float32 (H, W) with inf where
    empty, visible bool (N,))`` on ``device`` (default: the CUDA card). Each
    pixel shows the nearest point; among points at the same depth, the
    largest packed colour wins whole. On CUDA this launches ``splat_depth``
    and ``splat_color``; on the CPU it runs the plain version."""
    dev = resolve_device(device)
    pts = _as_f32(points, dev).reshape(-1, 3)
    cols = _as_f32(colors, dev).reshape(-1, 3)
    params = splat_params(_as_f32(intrinsics, dev), _as_f32(cam_to_world, dev))
    if dev.type == "cuda":
        from maskclustering_tpu_torch.ops.cuda import splat_color_cuda, splat_depth_cuda

        zbuf = splat_depth_cuda(pts, params, height=height, width=width)
        codebuf, visible = splat_color_cuda(pts, cols, params, zbuf, height=height,
                                            width=width)
    elif dev.type == "cpu":
        zbuf = splat_depth_reference(pts, params, height, width)
        codebuf, visible = splat_color_reference(pts, cols, params, zbuf, height, width)
    else:
        raise ValueError(f"project_zbuffer runs on cuda or cpu, got {dev}")
    zmap = zbuf[:height * width].view(torch.float32).reshape(height, width)
    return _unpack(codebuf, height, width), zmap, visible


def bbox_by_projection(points, intrinsics, cam_to_world, image_hw: Tuple[int, int], *,
                       device: DeviceLike = None) -> Optional[Tuple[int, int, int, int]]:
    """(px_min, py_min, px_max, py_max) of the object's visible pixels, or
    None when nothing projects into the frame (``top_images.py:66-81``)."""
    h, w = image_hw
    dev = resolve_device(device)
    pts = _as_f32(points, dev).reshape(-1, 3)
    _, zbuf, _ = project_zbuffer(pts, torch.zeros_like(pts), intrinsics, cam_to_world, h, w,
                                 device=dev)
    filled = torch.isfinite(zbuf)
    # one pull of the filled rows and columns (H + W bools)
    rows, cols = (t.cpu().numpy() for t in (filled.any(dim=1), filled.any(dim=0)))
    if not rows.any():
        return None
    ys, xs = np.nonzero(rows)[0], np.nonzero(cols)[0]
    return int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())


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
            images, jobs = [], []
            for frame_id, mask_id, conf in entry.get("repre_mask_list", []):
                if frame_id not in frames:
                    frames[frame_id] = dataset.get_rgb(frame_id)
                    if len(frames) > _FRAME_CACHE:
                        frames.popitem(last=False)
                frames.move_to_end(frame_id)
                rgb = frames[frame_id]
                intr = dataset.get_intrinsics(frame_id)
                extr = dataset.get_extrinsic(frame_id)
                bbox = bbox_by_projection(obj_points, intr, extr, rgb.shape[:2], device=dev)
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
