"""Per-frame mask backprojection as dense projective association.

Counterpart of ``maskclustering_tpu/models/backprojection.py:64-565``.
Every scene point is projected into each frame, a (2w+1)^2 pixel window
around its footprint is gathered, and window pixels whose backprojection
lies within ``distance_threshold`` of the point claim it for their mask.
Masks are then filtered by valid-pixel count and by coverage (claimed scene
points over occupied voxels of the mask's backprojection), and every point
keeps the smallest and largest valid claiming id of each frame.

The per-point work runs over the whole stack of frames at once, in three
steps, each with a plain torch version here and a hand-written CUDA kernel
(``ops/cuda/associate.cu``), one launch each a scene:

- :func:`pixel_table`: each pixel's masked depth and id and its
  backprojection, once a pixel (``backprojection.py:226-227, 246, 264-265``);
- :func:`claim_scene`: the claim test over the window and, per frame, the
  count of distinct scene points claimed per mask id
  (``:229-300, 319-335``);
- :func:`assign_scene`: once the valid masks are known, the same window
  walked again for ``first``, ``last`` and ``mask_of_point``
  (``:347-353``). On the CPU the plain claim's candidates serve the
  assignment instead.

The JAX package maps one frame at a time (``_associate_scene_impl``); the
frame axis here is a batch axis, which changes no value. CUDA tensors
launch the kernels, CPU tensors take the plain versions, and nothing falls
back. Pixel counts, voxel counts and the hash are plain torch on either
device, batched over frames with integer keys that carry the frame, and
nothing in the stage waits for the card.

Rounding follows XLA:CPU's compiled program exactly, so every field is bit
for bit the JAX package's: a multiply feeding an add inside one fusion is
a fused multiply-add (the pixel coordinate ``px / z * fx + cx``, the claim
distance, the 3x3 rotations), and a division by a compile-time constant is
a product with its float32 reciprocal.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from maskclustering_tpu_torch.analysis.transfer_guard import sanctioned_pull
from maskclustering_tpu_torch.datasets.base import PAD_DISTANCE_CUTOFF
from maskclustering_tpu_torch.device import DeviceLike, resolve_device
from maskclustering_tpu_torch.io.feed import to_device_frames
from maskclustering_tpu_torch.ops import cuda as cuda_entries
from maskclustering_tpu_torch.ops.geometry import (fma, invert_se3, rotate, sqrt_f32,
                                                   unproject_depth)

# elements of the (sample, block) distance matrix estimate_spacing holds at once
_SPACING_BLOCK = 1 << 24


def _f32(value: float, device) -> torch.Tensor:
    """A float32 scalar filled on the device itself: an upload from the
    host would make the host wait for the card."""
    return torch.full((), value, dtype=torch.float32, device=device)


def estimate_spacing(points: torch.Tensor, *, sample: int = 2048) -> torch.Tensor:
    """Median nearest-neighbour distance of a point sample vs the full cloud.

    ``points[::n // sample][:sample]`` against every point, in blocks; zero
    distances (duplicates) and distances of ``PAD_DISTANCE_CUTOFF`` or more
    (sentinel pads) are excluded from the median, as in the JAX package. The
    squared distance is the reduction XLA:CPU compiles,
    ``fma(d2, d2, fma(d1, d1, d0 * d0))``. The JAX package scans the cloud
    in chunks padded with +inf rows; those rows never win the minimum, so
    the blocks here skip them. The root is :func:`sqrt_f32`, correctly
    rounded as XLA's. Returns a 0-d float32 tensor.
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
    d = sqrt_f32(best)
    valid = torch.isfinite(d) & (d < _f32(PAD_DISTANCE_CUTOFF, dev))
    ds = torch.sort(torch.where(valid, d, inf)).values
    cnt = valid.sum()
    med = ds.gather(0, torch.clamp(cnt // 2, 0, s - 1).reshape(1))[0]
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
    """Per-id counts of 0/1 ``weights``, ids in [0, num_ids), as int32. The
    JAX package counts with a one-hot product that is exact under either
    ``count_dtype``, so an integer scatter-add is the same function; unlike
    a boolean select or a CUDA ``bincount`` it never waits for the card."""
    out = torch.zeros(num_ids, dtype=torch.int32, device=ids.device)
    return out.index_add_(0, ids.reshape(-1), weights.reshape(-1).to(torch.int32))


def _count_distinct_per_mask(ids: torch.Tensor, vox_hash: torch.Tensor, valid: torch.Tensor,
                             num_ids: int, bits: int) -> torch.Tensor:
    """Distinct (id, voxel-hash) pairs per id in each frame of (F, P)
    entries, via one sort of keys that carry the frame; invalid entries
    collapse into slot 0 (background) of their frame, which callers
    ignore. Returns (F, num_ids) int32."""
    f = ids.shape[0]
    frame = torch.arange(f, dtype=torch.int64, device=ids.device)[:, None] * num_ids
    zero = torch.zeros_like(ids)
    key = ((frame + torch.where(valid, ids, zero)) << bits) + torch.where(valid, vox_hash, zero)
    skey = torch.sort(key.reshape(-1)).values
    new = torch.ones_like(skey, dtype=torch.bool)
    new[1:] = skey[1:] != skey[:-1]
    return _counts_by_id(new, skey >> bits, f * num_ids).reshape(f, num_ids)


def claim_params(intrinsics: torch.Tensor, w2c: torch.Tensor, *, distance_threshold: float,
                 depth_trunc: float) -> torch.Tensor:
    """The 18 floats the claim reads for a frame: the world-to-camera
    rotation (row-major) and translation, fx, fy, cx, cy, the squared radius
    as the JAX package rounds it (the float product, once to float32) and
    the depth cut-off. For stacks (F, 3, 3) and (F, 4, 4), an (F, 18) table
    whose rows equal the one-frame values."""
    dev = w2c.device
    lead = tuple(w2c.shape[:-2])
    r2 = float(distance_threshold) * float(distance_threshold)
    consts = torch.stack([_f32(r2, dev), _f32(depth_trunc, dev)]).expand(*lead, 2)
    return torch.cat([w2c[..., :3, :3].reshape(*lead, 9), w2c[..., :3, 3],
                      intrinsics[..., 0, 0:1], intrinsics[..., 1, 1:2], intrinsics[..., 0, 2:3],
                      intrinsics[..., 1, 2:3], consts], dim=-1).to(torch.float32).contiguous()


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


def pixel_table_reference(depths: torch.Tensor, segs: torch.Tensor, params: torch.Tensor, *,
                          k_max: int) -> torch.Tensor:
    """Plain version of the pixel table the claim and the assignment read:
    for each pixel (u, v) of the (F, H, W) stacks, the masked depth ``d``,
    the masked id ``s`` and the pixel's backprojection ``qx = ((u - cx) *
    d) / fx``, ``qy = ((v - cy) * d) / fy`` (``backprojection.py:264-265``,
    not contracted). Returns (F, H, W, 4) int32: the float32 bits of
    ``qx``, ``qy`` and ``d``, and ``s``."""
    f, h, w = depths.shape
    dev = depths.device
    prm = params[:, :, None, None]
    fx, fy, cx, cy, trunc = (prm[:, i] for i in (12, 13, 14, 15, 17))
    d = torch.where((depths > 0) & (depths <= trunc), depths, torch.zeros_like(depths))
    s = torch.where((segs < 0) | (segs > k_max), torch.zeros_like(segs), segs)
    u = torch.arange(w, dtype=torch.float32, device=dev)
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    qx = (u - cx) * d / fx
    qy = (v - cy) * d / fy
    return torch.stack([qx.view(torch.int32), qy.view(torch.int32), d.view(torch.int32),
                        s.to(torch.int32)], dim=-1)


def scene_candidates_reference(scene_points: torch.Tensor, table: torch.Tensor,
                               params: torch.Tensor, *, k_max: int, window: int = 1):
    """:func:`claim_candidates_reference` frame by frame over the
    :func:`pixel_table_reference` of a stack (its depth and id) and the
    (F, 18) :func:`claim_params` table. Returns ``(cand, n_claimed)``: a
    list of each frame's (N, (2w+1)^2) int16 candidates and the
    (F, k_max + 1) int32 counts."""
    cand, rows = [], []
    for f in range(table.shape[0]):
        c, n = claim_candidates_reference(scene_points, table[f, ..., 2].view(torch.float32),
                                          table[f, ..., 3], params[f], k_max=k_max,
                                          window=window)
        cand.append(c)
        rows.append(n)
    if not rows:
        return cand, torch.zeros((0, k_max + 1), dtype=torch.int32, device=scene_points.device)
    return cand, torch.stack(rows)


def assign_candidates_reference(cand, mask_valid: torch.Tensor, *, k_max: int, n: int):
    """:func:`assign_claims_reference` of each frame's candidates against its
    row of the (F, k_max + 1) ``mask_valid``. Returns (F, n)
    ``(mask_of_point int32, first int16, last int16)``."""
    outs = [assign_claims_reference(c, mask_valid[f], k_max=k_max) for f, c in enumerate(cand)]
    if not outs:
        return tuple(torch.zeros((0, n), dtype=dt, device=mask_valid.device)
                     for dt in (torch.int32, torch.int16, torch.int16))
    return tuple(torch.stack(col) for col in zip(*outs))


def claim_scene_reference(scene_points: torch.Tensor, table: torch.Tensor, params: torch.Tensor,
                          *, k_max: int, window: int = 1) -> torch.Tensor:
    """Plain version of the scene claim (see :func:`scene_candidates_reference`).
    Returns (F, k_max + 1) int32 counts."""
    return scene_candidates_reference(scene_points, table, params, k_max=k_max,
                                      window=window)[1]


def assign_scene_reference(scene_points: torch.Tensor, table: torch.Tensor, params: torch.Tensor,
                           mask_valid: torch.Tensor, *, k_max: int, window: int = 1):
    """Plain version of the scene assignment: each frame's candidates
    again, against its row of the (F, k_max + 1) ``mask_valid``. Returns
    (F, N) ``(mask_of_point int32, first int16, last int16)``."""
    cand, _ = scene_candidates_reference(scene_points, table, params, k_max=k_max, window=window)
    return assign_candidates_reference(cand, mask_valid, k_max=k_max, n=scene_points.shape[0])


def _device_type(name: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {t.device}")
    return t.device.type


def pixel_table(depths, segs, params, *, k_max: int):
    """The pixel table: one CUDA launch for CUDA tensors, the plain version
    for CPU tensors (see :func:`pixel_table_reference`)."""
    if _device_type("pixel_table", depths) == "cuda":
        from maskclustering_tpu_torch.ops.cuda import associate_table_cuda

        return associate_table_cuda(depths, segs, params, k_max=k_max)
    cuda_entries.note_plain("associate_table", tuple(depths.shape))
    return pixel_table_reference(depths, segs, params, k_max=k_max)


def claim_scene(scene_points, table, params, *, k_max: int, window: int = 1):
    """The scene claim: one CUDA launch for CUDA tensors, the plain version
    for CPU tensors (see :func:`claim_scene_reference`)."""
    if _device_type("claim_scene", scene_points) == "cuda":
        from maskclustering_tpu_torch.ops.cuda import associate_claim_scene_cuda

        return associate_claim_scene_cuda(scene_points, table, params, k_max=k_max,
                                          window=window)
    return claim_scene_reference(scene_points, table, params, k_max=k_max, window=window)


def assign_scene(scene_points, table, params, mask_valid, *, k_max: int, window: int = 1):
    """The scene assignment: one CUDA launch for CUDA tensors, the plain
    version for CPU tensors (see :func:`assign_scene_reference`)."""
    if _device_type("assign_scene", scene_points) == "cuda":
        from maskclustering_tpu_torch.ops.cuda import associate_assign_scene_cuda

        return associate_assign_scene_cuda(scene_points, table, params, mask_valid, k_max=k_max,
                                           window=window)
    return assign_scene_reference(scene_points, table, params, mask_valid, k_max=k_max,
                                  window=window)


# pixels of the frame stack that one sort-and-count step holds at most
_COUNT_BLOCK = 1 << 24


def _frame_counts(depths: torch.Tensor, segs: torch.Tensor, intrinsics: torch.Tensor,
                 cam_to_world: torch.Tensor, vox_size: Optional[torch.Tensor], *, k_max: int,
                 distance_threshold: float, depth_trunc: float):
    """Per frame and mask id, the valid-depth pixels and the occupied voxels
    of their backprojection (the coverage denominator): two (F, k_max + 1)
    int32 tables, computed over blocks of frames. Without a ``vox_size`` the
    JAX program divides by a constant, which XLA compiles as a product with
    its float32 reciprocal."""
    f, h, w = depths.shape
    num_ids = k_max + 1
    bits = _hash_bits(num_ids)
    dev = depths.device
    trunc = _f32(depth_trunc, dev)
    n_pixels, n_voxels = [], []
    step = max(1, _COUNT_BLOCK // max(h * w, 1))
    for s in range(0, f, step):
        depth = depths[s:s + step]
        fb = depth.shape[0]
        seg = segs[s:s + step].reshape(fb, -1)
        seg = torch.where((seg < 0) | (seg > k_max), torch.zeros_like(seg), seg)
        dok = ((depth > 0) & (depth <= trunc)).reshape(fb, -1)
        pix_ids = torch.where(dok, seg, torch.zeros_like(seg))
        frame = torch.arange(fb, device=dev)[:, None] * num_ids
        n_pixels.append(_counts_by_id(torch.ones_like(pix_ids), frame + pix_ids,
                                      fb * num_ids).reshape(fb, num_ids))
        world, _ = unproject_depth(depth, intrinsics[s:s + step], cam_to_world[s:s + step],
                                   depth_trunc)
        world = world.reshape(fb, -1, 3)
        if vox_size is None:
            recip = float(np.float32(1) / np.float32(distance_threshold))
            vox = torch.floor(world * _f32(recip, dev))
        else:
            vox = torch.floor(world / vox_size.to(torch.float32))
        n_voxels.append(_count_distinct_per_mask(pix_ids, _hash_voxel(vox.to(torch.int32), bits),
                                                 dok & (seg > 0), num_ids, bits))
    if not n_pixels:
        empty = torch.zeros((0, num_ids), dtype=torch.int32, device=dev)
        return empty, empty.clone()
    return torch.cat(n_pixels), torch.cat(n_voxels)


class FrameClaims(NamedTuple):
    """The claim half of a stack's association, before the masks are known."""

    params: torch.Tensor  # (F, 18) float32 claim_params
    table: torch.Tensor  # (F, H, W, 4) int32 pixel table
    cand: Optional[torch.Tensor]  # the plain claim's candidates (CPU only), else None
    n_claimed: torch.Tensor  # (F, k_max + 1) int32 distinct points claimed per id


def claim_frames(scene_points, depths, segs, intrinsics, cam_to_world, *, k_max: int,
                 window: int, distance_threshold: float, depth_trunc: float) -> FrameClaims:
    """Pixel table and claim of a stack of F frames against ``scene_points``.

    ``n_claimed`` counts the points given, so over a column split of the
    cloud it is a partial count, and the sum over the parts is the whole
    cloud's (each point is claimed by its own window only).
    """
    params = claim_params(intrinsics, invert_se3(cam_to_world),
                          distance_threshold=distance_threshold, depth_trunc=depth_trunc)
    table = pixel_table(depths, segs, params, k_max=k_max)
    if scene_points.device.type == "cuda":
        return FrameClaims(params, table, None,
                           claim_scene(scene_points, table, params, k_max=k_max, window=window))
    # the plain claim's candidates serve the assignment as they are
    cuda_entries.note_plain("associate_claim", (*table.shape[:1], scene_points.shape[0],
                                                *table.shape[1:3], (2 * window + 1) ** 2))
    cand, n_claimed = scene_candidates_reference(scene_points, table, params, k_max=k_max,
                                                 window=window)
    return FrameClaims(params, table, cand, n_claimed)


def mask_validity(n_pixels, n_voxels, n_claimed, frame_valid, *, k_max: int,
                  few_points_threshold: int, coverage_threshold: float) -> torch.Tensor:
    """(F, k_max + 1) bool: enough valid pixels, at least one voxel and
    enough coverage (claimed points over occupied voxels), in a valid frame."""
    dev = n_claimed.device
    coverage = n_claimed.to(torch.float32) / torch.clamp(n_voxels.to(torch.float32), min=1.0)
    return ((n_pixels >= few_points_threshold) & (n_voxels >= 1)
            & (coverage >= _f32(coverage_threshold, dev))
            & (torch.arange(k_max + 1, device=dev) > 0) & frame_valid.to(dev)[:, None])


def assign_frames(scene_points, claims: FrameClaims, mask_valid, *, k_max: int, window: int):
    """Per point and frame the smallest and largest valid claiming id:
    (F, N) ``(mask_of_point int32, first int16, last int16)``."""
    if claims.cand is None:
        return assign_scene(scene_points, claims.table, claims.params, mask_valid, k_max=k_max,
                            window=window)
    cuda_entries.note_plain("associate_assign", (*claims.table.shape[:1], scene_points.shape[0],
                                                 *claims.table.shape[1:3], (2 * window + 1) ** 2))
    return assign_candidates_reference(claims.cand, mask_valid, k_max=k_max,
                                       n=scene_points.shape[0])


def _associate_frames(scene_points, depths, segs, intrinsics, cam_to_world, frame_valid,
                      vox_size, *, k_max: int, window: int, distance_threshold: float,
                      depth_trunc: float, few_points_threshold: int,
                      coverage_threshold: float) -> FrameAssociation:
    """The association of a stack of F frames: every
    :class:`FrameAssociation` field with a leading frame axis."""
    # the counts first: their sort's scratch is freed before the table exists
    n_pixels, n_voxels = _frame_counts(depths, segs, intrinsics, cam_to_world, vox_size,
                                      k_max=k_max, distance_threshold=distance_threshold,
                                      depth_trunc=depth_trunc)
    claims = claim_frames(scene_points, depths, segs, intrinsics, cam_to_world, k_max=k_max,
                          window=window, distance_threshold=distance_threshold,
                          depth_trunc=depth_trunc)
    n_claimed = claims.n_claimed
    mask_valid = mask_validity(n_pixels, n_voxels, n_claimed, frame_valid, k_max=k_max,
                               few_points_threshold=few_points_threshold,
                               coverage_threshold=coverage_threshold)
    mop, first, last = assign_frames(scene_points, claims, mask_valid, k_max=k_max,
                                     window=window)
    return FrameAssociation(mask_of_point=mop, first_id=first, last_id=last,
                            mask_valid=mask_valid, n_pixels=n_pixels, n_voxels=n_voxels,
                            n_claimed=n_claimed)


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
    (``backprojection.py:191-369``): the scene path with one frame. Every
    count is an exact integer, so the JAX package's ``count_dtype`` changes
    nothing here and is not taken; nor is its ``full_tile_table``, whose two
    table forms give the same values."""
    fa = _associate_frames(
        scene_points, depth[None], seg[None], intrinsics[None], cam_to_world[None],
        frame_valid.reshape(1), vox_size, k_max=k_max, window=window,
        distance_threshold=distance_threshold, depth_trunc=depth_trunc,
        few_points_threshold=few_points_threshold, coverage_threshold=coverage_threshold)
    return FrameAssociation(*(t[0] for t in fa))


def associate_scene(
    scene_points, depths, segs, intrinsics, cam_to_world, frame_valid, vox_size=None, *,
    k_max: int = 127, window: int = 1, distance_threshold: float = 0.01,
    depth_trunc: float = 20.0, few_points_threshold: int = 25,
    coverage_threshold: float = 0.3,
) -> SceneAssociation:
    """Projective association over all frames (``backprojection.py:372-521``).

    ``vox_size`` defaults to ``max(distance_threshold, median spacing)``.
    All frames go through each step together, so the JAX package's
    ``frame_batch`` (frames a step of its batched map) has no counterpart:
    it changes no value.
    """
    if vox_size is None:
        vox_size = _vox_size_jit(scene_points, distance_threshold=float(distance_threshold))
    fa = _associate_frames(
        scene_points, depths, segs, intrinsics, cam_to_world, frame_valid, vox_size,
        k_max=k_max, window=window, distance_threshold=distance_threshold,
        depth_trunc=depth_trunc, few_points_threshold=few_points_threshold,
        coverage_threshold=coverage_threshold)
    return SceneAssociation(mask_of_point=fa.mask_of_point, first_id=fa.first_id,
                            last_id=fa.last_id, point_visible=fa.first_id > 0,
                            boundary=(fa.first_id != fa.last_id).any(dim=0),
                            mask_valid=fa.mask_valid)


def associate_scene_tensors(tensors, cfg, k_max: int = 127, *,
                            device: DeviceLike = None, vox_size=None) -> SceneAssociation:
    """Run association from a SceneTensors bundle on ``device``: the cloud
    and the pose tables are uploaded once, the depth and id-map stacks
    through the compact feed (``io/feed.py``, ``backprojection.py:540-542``):
    uint16 when that is bit-exact, decoded on the device to the host
    arrays' float32 and int32 values. ``vox_size``: the coverage voxel of
    this padded cloud when the caller has it (a stream's chunks share one)."""
    dev = resolve_device(device)

    def up(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

    with sanctioned_pull("scene.upload"):
        depths, segs = to_device_frames(tensors.depths, tensors.segmentations, dev)
        points, intrinsics = up(tensors.scene_points, torch.float32), up(tensors.intrinsics,
                                                                         torch.float32)
        cam_to_world, frame_valid = (up(tensors.cam_to_world, torch.float32),
                                     up(tensors.frame_valid, torch.bool))
    return associate_scene(
        points, depths, segs, intrinsics, cam_to_world, frame_valid, vox_size,
        k_max=k_max, window=cfg.association_window,
        distance_threshold=cfg.distance_threshold, depth_trunc=cfg.depth_trunc,
        few_points_threshold=cfg.few_points_threshold,
        coverage_threshold=cfg.coverage_threshold)
