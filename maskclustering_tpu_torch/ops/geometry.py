"""Camera geometry: torch tensor ops of the dense path, host numpy of the exact path.

Counterpart of ``maskclustering_tpu/ops/geometry.py``. Pinhole conventions
match Open3D: pixel (u, v) at depth z unprojects to x = (u - cx) z / fx,
y = (v - cy) z / fy (no half-pixel offset), and the camera-to-world
extrinsic applies as p_world = R p_cam + t.

The tensor functions (``geometry.py:19-86``) round exactly as the JAX
package's jitted code does on the CPU, where XLA contracts a multiply
feeding an add into one fused multiply-add (FMA) inside a fusion. Its 3x3
products are loops in index order whose multiply-adds contract, so
``p @ M.T`` is ``fma(p2, M[i,2], fma(p1, M[i,1], p0 * M[i,0]))`` per output
``i``, and the translation is a separate rounded add. :func:`fma` states
those sites; every other operation rounds on its own, as torch's
element-wise kernels do.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for float32 tensors, rounded once.

    ``torch.addcmul`` is a true FMA on CUDA and on the CPU under the AVX512
    and AVX2 dispatch levels, but not under the ``default`` one, whose
    kernels round the product first. So on the CPU the first call checks
    ``addcmul`` once on triples where the two differ, and a host where it
    is no FMA takes :func:`_fma_exact`. Either way the bits are the host's
    no longer (see also :func:`sqrt_f32`)."""
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    if a.device.type == "cpu" and not _cpu_addcmul_is_fma():
        return _fma_exact(a, b, c)
    return torch.addcmul(c, a, b)


def _fma_exact(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` from float64 operations.

    The float64 product of two float32 values is exact. Their sum with
    ``c`` is rounded to odd (a two-sum recovers the rounding error, and a
    sum whose error is not zero moves to the odd neighbour on its side),
    and rounding that to float32 is the correctly rounded result, because
    53 >= 24 + 2.
    """
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    even = (s.view(torch.int64) & 1) == 0
    to_odd = torch.isfinite(err) & (err != 0) & even
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where(to_odd, torch.nextafter(s, toward), s).float()


@functools.cache
def _cpu_addcmul_is_fma() -> bool:
    """Whether this process's CPU ``addcmul`` rounds once (checked once).

    (1 + 2^-23)(1 - 2^-23) - 1 is -2^-46 fused, but 0 when the product is
    rounded first; the odd lengths reach the vector kernels' scalar tails.
    """
    eps = float(np.float32(2.0 ** -23))
    for n in (1, 7, 16, 67):
        a = torch.full((n,), 1 + eps, dtype=torch.float32)
        b = torch.full((n,), 1 - eps, dtype=torch.float32)
        got = torch.addcmul(torch.full((n,), -1.0), a, b)
        if not bool((got == -eps * eps).all()):
            return False
    return True


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, on every host.

    Some torch CPU builds compute float32 ``torch.sqrt`` through a vector
    approximation that is not correctly rounded (one ulp off on about a
    fifth of the values), while XLA:CPU's is IEEE. The float64 root of a
    float32 value, rounded to float32, is the float32 root exactly
    (53 >= 2 * 24 + 2), so this takes that route on the CPU and on CUDA
    alike, and both devices give the same bits.
    """
    return torch.sqrt(x.double()).float()


def _coef(mat: torch.Tensor, i: int, j: int, nd: int) -> torch.Tensor:
    """``mat[..., i, j]`` with trailing unit axes, so that a stack of
    matrices broadcasts over the ``nd`` leading axes of its points."""
    c = mat[..., i, j]
    return c.reshape(c.shape + (1,) * (nd - c.dim()))


def rotate(points: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """``points @ mat[..., :3, :3].T`` for (..., 3) float32 points as
    XLA:CPU's dot loop computes it: an index-order FMA chain per output
    coordinate. ``mat`` is one matrix or a stack (B, 3+, 3+) whose leading
    axis matches the points' first."""
    nd = points.dim() - 1
    cols = []
    for i in range(3):
        acc = points[..., 0] * _coef(mat, i, 0, nd)
        acc = fma(points[..., 1], _coef(mat, i, 1, nd), acc)
        cols.append(fma(points[..., 2], _coef(mat, i, 2, nd), acc))
    return torch.stack(cols, dim=-1)


def invert_se3(mat: torch.Tensor) -> torch.Tensor:
    """Invert a (..., 4, 4) rigid transform without a general solve."""
    rt = mat[..., :3, :3].transpose(-1, -2)
    t = mat[..., :3, 3]
    out = torch.zeros_like(mat)
    out[..., :3, :3] = rt
    out[..., :3, 3] = -rotate(t, rt)
    out[..., 3, 3] = 1.0
    return out


def transform_points(points: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) rigid transform, or a stack of them as in
    :func:`rotate`, to (..., 3) points."""
    nd = points.dim() - 1
    return rotate(points, mat) + torch.stack([_coef(mat, i, 3, nd) for i in range(3)], dim=-1)


def project_points(points: torch.Tensor, intrinsics: torch.Tensor,
                   world_to_cam: torch.Tensor):
    """Project world points into a pinhole camera: ``((..., 2) continuous
    pixel coordinates (u = column, v = row), (...,) camera-frame depth)``."""
    cam = transform_points(points, world_to_cam)
    z = cam[..., 2]
    safe_z = torch.where(z != 0, z, torch.ones_like(z))
    u = fma(cam[..., 0] / safe_z, intrinsics[0, 0], intrinsics[0, 2].expand_as(z))
    v = fma(cam[..., 1] / safe_z, intrinsics[1, 1], intrinsics[1, 2].expand_as(z))
    return torch.stack([u, v], dim=-1), z


def unproject_depth(depth: torch.Tensor, intrinsics: torch.Tensor,
                    cam_to_world: torch.Tensor, depth_trunc: float = 20.0):
    """Dense depth-map unprojection: ``(world points (..., H, W, 3), valid
    (..., H, W))``, valid = depth in (0, depth_trunc]; points are garbage
    where invalid. ``depth`` is one (H, W) map with (3, 3) intrinsics and a
    (4, 4) pose, or a stack of F of each."""
    h, w = depth.shape[-2:]
    dev = depth.device
    nd = depth.dim()
    fx, fy = _coef(intrinsics, 0, 0, nd), _coef(intrinsics, 1, 1, nd)
    cx, cy = _coef(intrinsics, 0, 2, nd), _coef(intrinsics, 1, 2, nd)
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    x = (u - cx) * depth / fx
    y = (v - cy) * depth / fy
    world = transform_points(torch.stack([x, y, depth], dim=-1), cam_to_world)
    trunc = torch.full((), depth_trunc, dtype=torch.float32, device=dev)
    return world, (depth > 0) & (depth <= trunc)


def voxel_keys(points: torch.Tensor, voxel_size, origin: torch.Tensor) -> torch.Tensor:
    """Integer voxel coordinates for each point (floor grid, Open3D-style)."""
    if not isinstance(voxel_size, torch.Tensor):
        voxel_size = torch.tensor(voxel_size, dtype=torch.float32, device=points.device)
    return torch.floor((points - origin) / voxel_size).to(torch.int32)


def backproject_depth_np(depth: np.ndarray, intrinsics: np.ndarray,
                         cam_to_world: np.ndarray, depth_trunc: float = np.inf):
    """Host pinhole backprojection: (world points (M, 3) f64, valid (H, W) bool)."""
    depth = np.asarray(depth, dtype=np.float64)
    intrinsics = np.asarray(intrinsics, dtype=np.float64)
    cam_to_world = np.asarray(cam_to_world, dtype=np.float64)
    h, w = depth.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    v, u = np.mgrid[0:h, 0:w]
    valid = (depth > 0) & (depth <= depth_trunc)
    z = depth[valid]
    pts = np.stack([(u[valid] - cx) / fx * z, (v[valid] - cy) / fy * z, z], axis=1)
    pts = pts @ cam_to_world[:3, :3].T + cam_to_world[:3, 3]
    return pts, valid


def voxel_downsample_np(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Mean of the points in each occupied voxel of the min-corner grid
    (Open3D ``voxel_down_sample``), voxels in sorted key order."""
    points = np.asarray(points)
    if len(points) == 0:
        return points
    origin = points.min(axis=0)
    keys = np.floor((points - origin) / voxel_size).astype(np.int64)
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((len(counts), 3), dtype=np.float64)
    np.add.at(sums, inverse.reshape(-1), points)
    return sums / counts[:, None]


def bboxes_overlap(amin, amax, bmin, bmax) -> bool:
    """Axis-aligned box intersection test (reference utils/geometry.py:3-7)."""
    return bool(np.all(np.asarray(amin) <= np.asarray(bmax))
                and np.all(np.asarray(bmin) <= np.asarray(amax)))
