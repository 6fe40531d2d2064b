"""Per-frame mask backprojection as dense projective association.

Counterpart of ``maskclustering_tpu/models/backprojection.py:64-565``.
Every scene point is projected into each frame, a (2w+1)^2 pixel window
around its footprint is gathered, and window pixels whose backprojection
lies within ``distance_threshold`` of the point claim it for their mask.
Masks are then filtered by valid-pixel count and by coverage (claimed scene
points over occupied voxels of the mask's backprojection), and every point
keeps the smallest and largest valid claiming id of each frame.

The per-point work of a frame is two steps, each with a plain torch version
here and a hand-written CUDA kernel (``ops/cuda/associate.cu``):

- :func:`claim_candidates`: the claim test over the window, giving the
  (N, (2w+1)^2) candidate plane and the per-mask count of distinct claimed
  points (``backprojection.py:229-300, 319-335``);
- :func:`assign_claims`: once the valid masks are known, ``first``,
  ``last`` and ``mask_of_point`` (``:347-353``).

CUDA tensors launch the kernels, CPU tensors take the plain versions, and
nothing falls back. Pixel counts, voxel counts and the hash stay plain
torch on either device.

Rounding follows XLA:CPU's compiled program exactly, so the planes are bit
for bit the JAX package's: a multiply feeding an add inside one fusion is
a fused multiply-add (the pixel coordinate ``px / z * fx + cx``, the claim
distance, the 3x3 rotations), and a division by a compile-time constant is
a product with its float32 reciprocal.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from maskclustering_tpu_torch.datasets.base import PAD_DISTANCE_CUTOFF
from maskclustering_tpu_torch.device import DeviceLike, resolve_device
from maskclustering_tpu_torch.ops.geometry import fma, invert_se3, rotate, unproject_depth

# elements of the (sample, block) distance matrix estimate_spacing holds at once
_SPACING_BLOCK = 1 << 24


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def estimate_spacing(points: torch.Tensor, *, sample: int = 2048) -> torch.Tensor:
    """Median nearest-neighbour distance of a point sample vs the full cloud.

    ``points[::n // sample][:sample]`` against every point, in blocks; zero
    distances (duplicates) and distances of ``PAD_DISTANCE_CUTOFF`` or more
    (sentinel pads) are excluded from the median, as in the JAX package. The
    squared distance is the reduction XLA:CPU compiles,
    ``fma(d2, d2, fma(d1, d1, d0 * d0))``. The JAX package scans the cloud
    in chunks padded with +inf rows; those rows never win the minimum, so
    the blocks here skip them. Returns a 0-d float32 tensor.
    """
    n = points.shape[0]
    dev = points.device
    stride = max(n // sample, 1)
    sub = points[::stride][:sample]
    s = sub.shape[0]
    best = torch.full((s,), float("inf"), dtype=torch.float32, device=dev)
    tiny = _f32(1e-12, dev)
    inf = _f32(float("inf"), dev)
    block = max(1, _SPACING_BLOCK // max(s, 1))
    for start in range(0, n, block):
        blk = points[start:start + block]
        d0 = sub[:, None, 0] - blk[None, :, 0]
        d1 = sub[:, None, 1] - blk[None, :, 1]
        d2 = sub[:, None, 2] - blk[None, :, 2]
        dist2 = fma(d2, d2, fma(d1, d1, d0 * d0))
        dist2 = torch.where(torch.isfinite(dist2) & (dist2 > tiny), dist2, inf)
        best = torch.minimum(best, dist2.min(dim=1).values)
    d = torch.sqrt(best)
    valid = torch.isfinite(d) & (d < _f32(PAD_DISTANCE_CUTOFF, dev))
    ds = torch.sort(torch.where(valid, d, inf)).values
    cnt = valid.sum()
    med = ds[torch.clamp(cnt // 2, 0, s - 1)]
    return torch.where(cnt > 0, med, torch.zeros_like(med))


def _vox_size_jit(scene_points: torch.Tensor, *, distance_threshold: float) -> torch.Tensor:
    """The coverage voxel size, ``max(distance_threshold, spacing)`` (named
    after its jitted JAX counterpart)."""
    return torch.maximum(_f32(distance_threshold, scene_points.device),
                         estimate_spacing(scene_points))


class FrameAssociation(NamedTuple):
    """Per-frame association results (``backprojection.py:109``)."""

    mask_of_point: torch.Tensor  # (N,) int32: unique claiming mask id, 0 = none/boundary
    first_id: torch.Tensor  # (N,) int16: smallest valid claiming mask id (0 = none)
    last_id: torch.Tensor  # (N,) int16: largest valid claiming mask id
    mask_valid: torch.Tensor  # (K_max+1,) bool
    n_pixels: torch.Tensor  # (K_max+1,) int32: valid-depth pixel count per mask
    n_voxels: torch.Tensor  # (K_max+1,) int32: occupied voxel count per mask
    n_claimed: torch.Tensor  # (K_max+1,) int32: scene points claimed per mask


class SceneAssociation(NamedTuple):
    """Stacked (F, ...) association tensors for a scene (``backprojection.py:129``)."""

    mask_of_point: torch.Tensor  # (F, N) int32 — the reference's point_in_mask_matrix
    first_id: torch.Tensor  # (F, N) int16
    last_id: torch.Tensor  # (F, N) int16
    point_visible: torch.Tensor  # (F, N) bool — the reference's point_frame_matrix
    boundary: torch.Tensor  # (N,) bool — global boundary points
    mask_valid: torch.Tensor  # (F, K_max+1) bool


def _hash_bits(num_ids: int) -> int:
    """Voxel-hash width so the packed (id, hash) key stays within int32."""
    return 30 - max(int(num_ids - 1).bit_length(), 1)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to the int32 they wrap to (two's complement)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _hash_voxel(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """Mix integer voxel coords into a positive hash (bits < 31), with the
    JAX package's wrapping int32 multiplies and ``abs``, computed in int64."""
    k = keys.to(torch.int64)
    h = (_wrap32(k[..., 0] * 73856093) ^ _wrap32(k[..., 1] * 19349663)
         ^ _wrap32(k[..., 2] * 83492791))
    return (h.abs() & ((1 << bits) - 1)).to(torch.int32)


def _counts_by_id(weights: torch.Tensor, ids: torch.Tensor, num_ids: int) -> torch.Tensor:
    """Per-id counts of 0/1 ``weights``. The JAX package counts with a
    one-hot product that is exact under either ``count_dtype``, so an
    integer histogram is the same function."""
    return torch.bincount(ids.reshape(-1)[weights.reshape(-1).bool()].long(),
                          minlength=num_ids)[:num_ids].to(torch.int32)


def _count_distinct_per_mask(ids: torch.Tensor, vox_hash: torch.Tensor, valid: torch.Tensor,
                             num_ids: int, bits: int) -> torch.Tensor:
    """Distinct (id, voxel-hash) pairs per id via one sort; invalid entries
    collapse into slot 0 (background), which callers ignore."""
    zero = torch.zeros_like(ids)
    key = torch.where(valid, ids, zero).to(torch.int64) * (1 << bits) \
        + torch.where(valid, vox_hash, zero).to(torch.int64)
    skey = torch.sort(key).values
    new = torch.ones_like(skey, dtype=torch.bool)
    new[1:] = skey[1:] != skey[:-1]
    return _counts_by_id(new, skey >> bits, num_ids)


def claim_params(intrinsics: torch.Tensor, w2c: torch.Tensor, *, distance_threshold: float,
                 depth_trunc: float) -> torch.Tensor:
    """The 18 floats the claim kernel reads: the world-to-camera rotation
    (row-major) and translation, fx, fy, cx, cy, the squared radius as the
    JAX package rounds it (the float product, once to float32) and the
    depth cut-off."""
    dev = w2c.device
    r2 = float(distance_threshold) * float(distance_threshold)
    return torch.cat([w2c[:3, :3].reshape(-1), w2c[:3, 3],
                      intrinsics[0, 0:1], intrinsics[1, 1:2], intrinsics[0, 2:3],
                      intrinsics[1, 2:3], _f32(r2, dev)[None], _f32(depth_trunc, dev)[None]]
                     ).to(torch.float32).contiguous()


def _round_to_int32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.round(x).astype(int32)``: half to even, NaN to 0, saturating."""
    r = torch.nan_to_num(torch.round(x), nan=0.0)
    return r.clamp(-2147483648.0, 2147483520.0).to(torch.int32)


def claim_candidates_reference(scene_points: torch.Tensor, depth: torch.Tensor,
                               seg: torch.Tensor, params: torch.Tensor, *, k_max: int,
                               window: int = 1):
    """Plain torch claim step of one frame (``backprojection.py:226-300, 319-335``).

    ``params`` is :func:`claim_params`. Returns ``(cand, n_claimed)``:
    (N, (2w+1)^2) int16 claiming mask ids in window order (row offset
    outer), 0 = no claim; (k_max + 1,) int32 distinct scene points claimed
    per mask id. The window is gathered from one (H*W, 2(2w+1)^2) table,
    the JAX package's full-tile form; its per-row strip tables hold the
    same values.
    """
    dev = scene_points.device
    n = scene_points.shape[0]
    h, w = depth.shape
    rot = params[:9].reshape(3, 3)
    fx, fy, cx, cy, r2, trunc = (params[i] for i in range(12, 18))
    seg = torch.where((seg < 0) | (seg > k_max), torch.zeros_like(seg), seg)
    depth_ok = (depth > 0) & (depth <= trunc)

    cam = rotate(scene_points, rot) + params[9:12]
    px, py, pz = cam[:, 0], cam[:, 1], cam[:, 2]
    in_front = pz > _f32(1e-6, dev)
    safe_z = torch.where(in_front, pz, torch.ones_like(pz))
    ui = _round_to_int32(fma(px / safe_z, fx, cx.expand_as(px)))
    vi = _round_to_int32(fma(py / safe_z, fy, cy.expand_as(py)))

    ww = 2 * window + 1
    dz = torch.where(depth_ok, depth, torch.zeros_like(depth))
    padded = torch.nn.functional.pad(torch.stack([dz, seg.to(torch.float32)], dim=-1),
                                     (0, 0, window, window, window, window))
    uc = ui.clamp(0, w - 1)
    vc = vi.clamp(0, h - 1)
    flat_idx = (vc * w + uc).long()

    def claim_col(d, s, dv, du):
        win_ok = ((uc + du - ui).abs() <= window) & ((vc + dv - vi).abs() <= window)
        qx = ((uc + du).to(torch.float32) - cx) * d / fx
        qy = ((vc + dv).to(torch.float32) - cy) * d / fy
        ex, ey, ez = qx - px, qy - py, d - pz
        dist2 = fma(ez, ez, fma(ex, ex, ey * ey))
        claim = in_front & win_ok & (d > 0) & (s > 0) & (dist2 <= r2)
        return torch.where(claim, s, torch.zeros_like(s))

    tiles = torch.cat([padded[kv:kv + h, ku:ku + w] for kv in range(ww) for ku in range(ww)],
                      dim=-1).reshape(h * w, 2 * ww * ww)
    g = tiles[flat_idx]
    offsets = [(dv, du) for dv in range(-window, window + 1) for du in range(-window, window + 1)]
    cols = [claim_col(g[:, 2 * j], g[:, 2 * j + 1].to(torch.int32), dv, du)
            for j, (dv, du) in enumerate(offsets)]
    cand = torch.stack(cols, dim=1) if n else torch.zeros((0, ww * ww), dtype=torch.int32,
                                                           device=dev)

    # each (point, mask) pair counts once: dedupe ids within a point's window
    cs = torch.sort(cand, dim=1).values
    row_new = torch.cat([cs[:, :1] > 0, (cs[:, 1:] != cs[:, :-1]) & (cs[:, 1:] > 0)], dim=1)
    n_claimed = _counts_by_id(row_new, cs, k_max + 1)
    return cand.to(torch.int16), n_claimed


def claim_candidates(scene_points, depth, seg, params, *, k_max: int, window: int = 1):
    """The claim step: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (see :func:`claim_candidates_reference`)."""
    if scene_points.device.type == "cuda":
        from maskclustering_tpu_torch.ops.cuda import associate_claim_cuda

        return associate_claim_cuda(scene_points, depth, seg, params, k_max=k_max, window=window)
    if scene_points.device.type == "cpu":
        return claim_candidates_reference(scene_points, depth, seg, params, k_max=k_max,
                                          window=window)
    raise ValueError(f"claim_candidates runs on cuda or cpu tensors, got {scene_points.device}")


def assign_claims_reference(cand: torch.Tensor, mask_valid: torch.Tensor, *, k_max: int):
    """Plain torch assignment (``backprojection.py:347-353``): per point the
    smallest and largest valid claiming id, and the id itself when they
    agree. Returns ``(mask_of_point int32, first int16, last int16)``."""
    c = cand.to(torch.int64)
    ok = mask_valid[c] & (c > 0)
    first = torch.where(ok, c, torch.full_like(c, k_max + 1)).min(dim=1).values
    last = torch.where(ok, c, torch.zeros_like(c)).max(dim=1).values
    claimed_any = last > 0
    first = torch.where(claimed_any, first, torch.zeros_like(first))
    mop = torch.where(claimed_any & (first == last), first, torch.zeros_like(first))
    return mop.to(torch.int32), first.to(torch.int16), last.to(torch.int16)


def assign_claims(cand, mask_valid, *, k_max: int):
    """The assignment step: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see :func:`assign_claims_reference`)."""
    if cand.device.type == "cuda":
        from maskclustering_tpu_torch.ops.cuda import associate_assign_cuda

        return associate_assign_cuda(cand, mask_valid, k_max=k_max)
    if cand.device.type == "cpu":
        return assign_claims_reference(cand, mask_valid, k_max=k_max)
    raise ValueError(f"assign_claims runs on cuda or cpu tensors, got {cand.device}")


def associate_frame(
    scene_points: torch.Tensor,  # (N, 3) float32
    depth: torch.Tensor,  # (H, W) float32
    seg: torch.Tensor,  # (H, W) int32
    intrinsics: torch.Tensor,  # (3, 3)
    cam_to_world: torch.Tensor,  # (4, 4)
    frame_valid: torch.Tensor,  # () bool
    vox_size: Optional[torch.Tensor] = None,  # () f32 coverage voxel size
    *,
    k_max: int = 127,
    window: int = 1,
    distance_threshold: float = 0.01,
    depth_trunc: float = 20.0,
    few_points_threshold: int = 25,
    coverage_threshold: float = 0.3,
) -> FrameAssociation:
    """Associate every scene point with the masks of one frame
    (``backprojection.py:191-369``). Every count is an exact integer, so
    the JAX package's ``count_dtype`` changes nothing here and is not
    taken; nor is its ``full_tile_table``, whose two table forms give the
    same values."""
    dev = scene_points.device
    params = claim_params(intrinsics, invert_se3(cam_to_world),
                          distance_threshold=distance_threshold, depth_trunc=depth_trunc)
    cand, n_claimed = claim_candidates(scene_points, depth, seg, params, k_max=k_max,
                                       window=window)

    seg = torch.where((seg < 0) | (seg > k_max), torch.zeros_like(seg), seg)
    seg_flat = seg.reshape(-1)
    dok_flat = ((depth > 0) & (depth <= _f32(depth_trunc, dev))).reshape(-1)
    pix_ids = torch.where(dok_flat, seg_flat, torch.zeros_like(seg_flat))
    n_pixels = _counts_by_id(torch.ones_like(pix_ids), pix_ids, k_max + 1)

    # occupied voxels of the mask's backprojected pixels (coverage denominator);
    # without a vox_size the JAX program divides by a constant, which XLA
    # compiles as a product with its float32 reciprocal
    world_pix, _ = unproject_depth(depth, intrinsics, cam_to_world, depth_trunc)
    world_pix = world_pix.reshape(-1, 3)
    if vox_size is None:
        recip = float(np.float32(1) / np.float32(distance_threshold))
        vox = torch.floor(world_pix * _f32(recip, dev))
    else:
        vox = torch.floor(world_pix / vox_size.to(torch.float32))
    bits = _hash_bits(k_max + 1)
    n_voxels = _count_distinct_per_mask(pix_ids, _hash_voxel(vox.to(torch.int32), bits),
                                        dok_flat & (seg_flat > 0), k_max + 1, bits)

    coverage = n_claimed.to(torch.float32) / torch.clamp(n_voxels.to(torch.float32), min=1.0)
    mask_valid = ((n_pixels >= few_points_threshold) & (n_voxels >= 1)
                  & (coverage >= _f32(coverage_threshold, dev))
                  & (torch.arange(k_max + 1, device=dev) > 0) & frame_valid.to(dev))

    mop, first, last = assign_claims(cand, mask_valid, k_max=k_max)
    return FrameAssociation(mask_of_point=mop, first_id=first, last_id=last,
                            mask_valid=mask_valid, n_pixels=n_pixels, n_voxels=n_voxels,
                            n_claimed=n_claimed)


def associate_scene(
    scene_points, depths, segs, intrinsics, cam_to_world, frame_valid, vox_size=None, *,
    k_max: int = 127, window: int = 1, distance_threshold: float = 0.01,
    depth_trunc: float = 20.0, few_points_threshold: int = 25,
    coverage_threshold: float = 0.3,
) -> SceneAssociation:
    """Projective association over all frames (``backprojection.py:372-521``).

    ``vox_size`` defaults to ``max(distance_threshold, median spacing)``.
    Frames run one after another, so the JAX package's ``frame_batch``
    (frames a step of its batched map) has no counterpart: it changes no
    value.
    """
    if vox_size is None:
        vox_size = _vox_size_jit(scene_points, distance_threshold=float(distance_threshold))
    f = depths.shape[0]
    n = scene_points.shape[0]
    dev = scene_points.device
    mop = torch.empty((f, n), dtype=torch.int32, device=dev)
    first = torch.empty((f, n), dtype=torch.int16, device=dev)
    last = torch.empty((f, n), dtype=torch.int16, device=dev)
    mask_valid = torch.empty((f, k_max + 1), dtype=torch.bool, device=dev)
    for fi in range(f):
        fa = associate_frame(
            scene_points, depths[fi], segs[fi], intrinsics[fi], cam_to_world[fi],
            frame_valid[fi], vox_size, k_max=k_max, window=window,
            distance_threshold=distance_threshold, depth_trunc=depth_trunc,
            few_points_threshold=few_points_threshold, coverage_threshold=coverage_threshold)
        mop[fi], first[fi], last[fi], mask_valid[fi] = (
            fa.mask_of_point, fa.first_id, fa.last_id, fa.mask_valid)
    return SceneAssociation(mask_of_point=mop, first_id=first, last_id=last,
                            point_visible=first > 0, boundary=(first != last).any(dim=0),
                            mask_valid=mask_valid)


def associate_scene_tensors(tensors, cfg, k_max: int = 127, *,
                            device: DeviceLike = None) -> SceneAssociation:
    """Run association from a SceneTensors bundle on ``device``: the cloud,
    the float32 depth and int32 id-map stacks and the pose tables are
    uploaded once."""
    dev = resolve_device(device)

    def up(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

    return associate_scene(
        up(tensors.scene_points, torch.float32), up(tensors.depths, torch.float32),
        up(tensors.segmentations, torch.int32), up(tensors.intrinsics, torch.float32),
        up(tensors.cam_to_world, torch.float32), up(tensors.frame_valid, torch.bool),
        k_max=k_max, window=cfg.association_window,
        distance_threshold=cfg.distance_threshold, depth_trunc=cfg.depth_trunc,
        few_points_threshold=cfg.few_points_threshold,
        coverage_threshold=cfg.coverage_threshold)
