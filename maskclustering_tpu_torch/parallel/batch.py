"""Mesh-batched scene clustering to artifacts (``parallel/batch.py:38-244``).

- scenes batch over the ``scene`` mesh axis, frames split over ``frame``
  and, on a 3-axis mesh, points over ``point``;
- the device pipeline of a batch is one fused step
  (``parallel/sharded.build_fused_step``: association -> graph -> schedule
  -> clustering);
- ragged scenes are padded to shared shapes: frames to a multiple of
  lcm(frame axis, ``cfg.frame_pad_multiple``) with ``frame_valid=False``
  and identity poses, points to a multiple of lcm(point axis,
  ``cfg.point_chunk``) at the far sentinel no frustum claims;
- the post-process then runs per real lane on the lane's first device,
  after the lane's point-sharded claim planes are gathered there, through
  ``models/postprocess_device.run_postprocess`` (the JAX package also
  post-processes one scene on one chip). The artifacts equal the
  single-device path's (``models/pipeline.run_scene``) byte for byte.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from maskclustering_tpu_torch.datasets.base import PAD_COORD, SceneTensors
from maskclustering_tpu_torch.io.feed import (
    FUSED_FEED_DEPTH_SCALE,
    encode_depth,
    encode_seg,
    host_frames,
)
from maskclustering_tpu_torch.models.postprocess import SceneObjects
from maskclustering_tpu_torch.models.postprocess_device import run_postprocess
from maskclustering_tpu_torch.parallel.mesh import Mesh, make_mesh, point_axis_size
from maskclustering_tpu_torch.parallel.sharded import FusedStepResult, build_fused_step
from maskclustering_tpu_torch.utils.compile_cache import bucket_k_max, max_seg_id


def _round_up(value: int, multiple: int) -> int:
    return max(multiple, -(-value // multiple) * multiple)


def _multiples(cfg, mesh: Mesh) -> Tuple[int, int]:
    """The (frame, point) padding multiples of a batch on ``mesh``."""
    return (math.lcm(int(mesh.shape["frame"]), max(cfg.frame_pad_multiple, 1)),
            math.lcm(point_axis_size(mesh), max(cfg.point_chunk, 1)))


def batch_shapes(tensors_list: Sequence[SceneTensors], cfg, mesh: Mesh) -> Tuple[int, int]:
    """(F_pad, N_pad) shared shapes for a scene batch on ``mesh``: every
    frame shard holds F_pad / frame axis frames, every point shard an equal
    column slice of the (F, N) planes."""
    f_mult, n_mult = _multiples(cfg, mesh)
    return (_round_up(max(t.num_frames for t in tensors_list), f_mult),
            _round_up(max(t.num_points for t in tensors_list), n_mult))


def pad_scene_batch(tensors_list: Sequence[SceneTensors], f_pad: int, n_pad: int,
                    num_scenes: int, pad_tensors: Optional[SceneTensors] = None):
    """Stack scenes into the fused step's batched host arrays.

    Lanes past ``len(tensors_list)`` take ``pad_tensors`` when given (a
    server's warm scene), else repeat the last scene; the caller discards
    them. Padded frames are invalid with identity poses, padded points sit
    at the sentinel. Depth ships as uint16 when the millimetre quantisation
    is bit-exact (the only scale the fused step decodes), ids as uint16
    when they fit; frames on a card are pulled to the host for the stack
    (``batch.frames``). Returns the 6-tuple of (S, ...) arrays.
    """
    h, w = tensors_list[0].depths.shape[1:3]
    s = num_scenes
    pts = np.full((s, n_pad, 3), PAD_COORD, dtype=np.float32)
    depths = np.zeros((s, f_pad, h, w), dtype=np.float32)
    segs = np.zeros((s, f_pad, h, w), dtype=np.int32)
    intr = np.tile(np.eye(3, dtype=np.float32), (s, f_pad, 1, 1))
    c2w = np.tile(np.eye(4, dtype=np.float32), (s, f_pad, 1, 1))
    fv = np.zeros((s, f_pad), dtype=bool)
    for i in range(s):
        if i >= len(tensors_list) and pad_tensors is not None:
            t = pad_tensors
        else:
            t = tensors_list[min(i, len(tensors_list) - 1)]
        f, n = t.num_frames, t.num_points
        pts[i, :n] = t.scene_points
        depths[i, :f] = host_frames(t.depths, "batch.frames")
        segs[i, :f] = host_frames(t.segmentations, "batch.frames")
        intr[i, :f] = t.intrinsics
        c2w[i, :f] = t.cam_to_world
        fv[i, :f] = t.frame_valid
    enc, scale = encode_depth(depths, scales=(FUSED_FEED_DEPTH_SCALE,))
    if scale:
        depths = enc
    return pts, depths, encode_seg(segs), intr, c2w, fv


def out_scene_points(tensors: SceneTensors, n_pad: int) -> np.ndarray:
    """Scene cloud re-padded to the batch bucket (sentinel coords)."""
    pts = np.asarray(tensors.scene_points, dtype=np.float32)
    if pts.shape[0] == n_pad:
        return pts
    out = np.full((n_pad, 3), PAD_COORD, dtype=np.float32)
    out[: pts.shape[0]] = pts
    return out


def fused_scene_objects(out: FusedStepResult, index: int, tensors: SceneTensors, cfg,
                        k_max: int, timings: Optional[Dict[str, float]] = None,
                        seq_name: Optional[str] = None) -> SceneObjects:
    """Post-process of lane ``index`` of a batch, on the lane's first device.

    The dense (frame, id) slot table enumerates masks ascending by (frame,
    id), as the single-device path's compact table does, and
    representatives are min-index labels, so objects and artifacts match.
    """
    f_pad = int(out.node_visible[index].shape[1])
    first = out.lane_plane("first_id", index)
    mask_frame = np.repeat(np.arange(f_pad, dtype=np.int32), k_max)
    mask_id = np.tile(np.arange(1, k_max + 1, dtype=np.int32), f_pad)
    frame_ids = list(tensors.frame_ids) + [None] * (f_pad - tensors.num_frames)
    return run_postprocess(
        cfg, out_scene_points(tensors, first.shape[1]), first, out.lane_plane("last_id", index),
        mask_frame, mask_id, out.mask_active[index], out.assignment[index],
        out.node_visible[index], frame_ids, k_max=k_max, timings=timings,
        n_real=tensors.num_points, seq_name=seq_name)


@functools.lru_cache(maxsize=None)
def _cached_step(mesh: Mesh, cfg, k_max: int):
    """One fused step per (mesh, cfg, k_max), reused across batches; the
    depth and id stacks are donated when ``cfg.donate_buffers`` is on."""
    return build_fused_step(mesh, cfg, k_max=k_max, donate=bool(cfg.donate_buffers))


def cluster_scene_batch(cfg, mesh: Mesh, tensors_list: Sequence[SceneTensors], *,
                        k_max: Optional[int] = None, seq_names: Optional[Sequence[str]] = None,
                        pads: Optional[Tuple[int, int]] = None, width: Optional[int] = None,
                        pad_tensors: Optional[SceneTensors] = None) -> List[SceneObjects]:
    """Run a batch of scenes through the fused mesh step to SceneObjects.

    The batch is padded up to a multiple of the ``scene`` axis; its scenes
    share one (F_pad, N_pad, k_max) shape. A server's packing knobs pin the
    shape independently of the members: ``pads`` is an (f_pad, n_pad) floor
    (re-rounded to the mesh multiples), ``width`` a lane floor, and
    ``pad_tensors`` fills the extra lanes. Only the ``len(tensors_list)``
    real lanes are post-processed.
    """
    if not tensors_list:
        return []
    num_scenes = _round_up(max(len(tensors_list), int(width or 0)), int(mesh.shape["scene"]))
    f_pad, n_pad = batch_shapes(tensors_list, cfg, mesh)
    if pads is not None:
        f_mult, n_mult = _multiples(cfg, mesh)
        f_pad = _round_up(max(f_pad, int(pads[0])), f_mult)
        n_pad = _round_up(max(n_pad, int(pads[1])), n_mult)
    if k_max is None:
        k_max = bucket_k_max(max(max_seg_id(t.segmentations) for t in tensors_list))
    step = _cached_step(mesh, cfg, k_max)
    out = step(*pad_scene_batch(tensors_list, f_pad, n_pad, num_scenes,
                                pad_tensors=pad_tensors))
    names = list(seq_names) if seq_names is not None else [None] * len(tensors_list)
    return [fused_scene_objects(out, i, tensors_list[i], cfg, k_max, seq_name=names[i])
            for i in range(len(tensors_list))]


def make_run_mesh(cfg, devices: Optional[Sequence] = None) -> Mesh:
    """Mesh from ``cfg.mesh_shape`` (+ ``cfg.point_shards``) over ``devices``
    (default: every visible card). ``point_shards > 1`` appends the point
    axis; the device count must equal scene * frame * point."""
    shape = tuple(cfg.mesh_shape)
    if cfg.point_shards > 1:
        shape = shape + (int(cfg.point_shards),)
    return make_mesh(shape, devices=devices)
