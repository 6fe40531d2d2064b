"""Streaming incremental clustering: chunked frame accumulation.

Port of ``maskclustering_tpu/models/streaming.py``. The batch pipeline
(``models/pipeline.py``) keeps every frame's (F, N) claim planes resident
until one graph solve. This module takes frames in chunks of
``cfg.streaming_chunk`` and keeps an accumulator on the device whose size is
one chunk's (F', N) planes plus O(M^2) graph state:

- **within-chunk statistics are exact**: each chunk runs the batch
  ``compute_graph_stats`` over its own claim planes and mask table;
- **cross-chunk statistics run at representative granularity**: past chunks
  survive as the point-level ``rep_plane`` (point -> current cluster
  representative) and the accumulated visibility and containment matrices;
  a new chunk's merge program counts, with one counting product per point
  chunk, how every existing representative projects into the new frames;
- **the periodic re-cluster warm-starts from the previous assignment**
  (``iterative_clustering(init=...)``);
- **anytime partial instances**: after every chunk the rep plane yields the
  current instance map; each chunk's dict carries the live instance count
  and ``partial_objects()`` exports a full partial artifact set.

When one chunk covers the whole scene the accumulator is the batch chain,
and ``finalize`` hands the chunk's planes to ``run_scene_host``: artifacts
and digest dict are the batch path's byte for byte. Every chunk, the last
partial one included, pads to one (f_chunk_pad, n_pad) bucket, as in the JAX
package, whose shapes decide the association's coverage voxel.

The three programs (``_stream_merge``, ``_stream_recluster``,
``_rep_plane_update``) are plain torch on the accumulator's device. Each
makes new tensors: no in-place operation touches a bound state tensor. A
chunk whose watchdog expired keeps running on its daemon thread
(``faults.call_with_deadline``) and shares the device with its retry; the
epoch fence drops its bind, and because the bound state is never written
in place, what it computed meanwhile cannot reach the retry's state.

Metrics and spans are the JAX module's: ``stream.scene``, ``stream.chunk``
and ``stream.finalize`` spans; ``stream.chunks``, ``stream.frames``,
``stream.host_sync``, ``stream.reclusters``, ``stream.stale_binds_dropped``,
``stream.mask_capacity_growths``, ``stream.chunk_retries``,
``stream.state_saves`` and ``stream.state_resumes`` counters; and the
``stream.max_plane_bytes``, ``stream.state_bytes`` and
``stream.partial_instances`` gauges. The host reads keep the JAX module's
``sanctioned_pull`` window names (``stream.mask_valid``,
``stream.partials``, ``stream.rep_plane``, ``stream.assignment``,
``stream.state_journal``; ``analysis/transfer_guard.py``). Each chunk dict
carries ``plane_bytes``, ``partial_instances``, ``seconds`` and ``digest``,
and the result's ``stream.*`` timings add ``stream.finalize`` and its host
DBSCAN, ``stream.dbscan``.

The state journal is the JAX package's npz (same keys, version 1), so a
journal written by either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from maskclustering_tpu_torch import obs
from maskclustering_tpu_torch.analysis.lock_sanitizer import mct_lock
from maskclustering_tpu_torch.analysis.transfer_guard import sanctioned_pull
from maskclustering_tpu_torch.config import PipelineConfig
from maskclustering_tpu_torch.datasets.base import SceneTensors
from maskclustering_tpu_torch.device import DeviceLike, resolve_device
from maskclustering_tpu_torch.models.backprojection import _vox_size_jit, associate_scene_tensors
from maskclustering_tpu_torch.models.clustering import ClusterResult, iterative_clustering
from maskclustering_tpu_torch.models.graph import (
    MaskTable,
    _f32,
    build_mask_table,
    compute_graph_stats,
    frame_segment_stats,
    observer_histogram,
    observer_schedule_device,
)
from maskclustering_tpu_torch.models.pipeline import (
    DeviceHandoff,
    SceneResult,
    pad_scene_tensors,
    run_scene_host,
)
from maskclustering_tpu_torch.models.postprocess import (
    SceneObjects,
    _merge_overlapping,
    export_artifacts,
)
from maskclustering_tpu_torch.obs import digest as sentinel
from maskclustering_tpu_torch.ops import counting
from maskclustering_tpu_torch.ops.dbscan import dbscan_labels_parallel
from maskclustering_tpu_torch.utils import atomic_write, faults
from maskclustering_tpu_torch.utils.compile_cache import (
    bucket_k_max,
    bucket_size,
    max_seg_id,
    record_shape_bucket,
    scene_pads,
)

log = logging.getLogger("maskclustering_tpu_torch")

# the accumulator state journal's schema (the JAX package's)
STREAM_STATE_VERSION = 1


class StaleChunkAttempt(RuntimeError):
    """A watchdog-abandoned ``push_chunk`` attempt reached its bind after a
    retry superseded it; the bind was dropped. Raised on the abandoned
    thread only: callers on the live path never see it."""

    def __init__(self, seq_name, chunk: int):
        super().__init__(f"stream {seq_name}: abandoned chunk {chunk} "
                         f"attempt superseded; bind dropped")


def slice_scene_frames(tensors: SceneTensors, start: int, stop: int) -> SceneTensors:
    """The frame window [start, stop) of a scene as its own SceneTensors;
    the cloud is shared, frame arrays slice along axis 0."""
    return dataclasses.replace(
        tensors,
        depths=tensors.depths[start:stop],
        segmentations=tensors.segmentations[start:stop],
        intrinsics=tensors.intrinsics[start:stop],
        cam_to_world=tensors.cam_to_world[start:stop],
        frame_valid=np.asarray(tensors.frame_valid)[start:stop],  # mct-ok: AST.HOSTSYNC (host numpy by SceneTensors contract, no device sync)
        frame_ids=list(tensors.frame_ids)[start:stop],
    )


def _splice(base: torch.Tensor, block: torch.Tensor, start: int, dim: int) -> torch.Tensor:
    """A new tensor: ``base`` with ``block`` in place of its window at
    ``start`` along ``dim`` (``jax.lax.dynamic_update_slice``, whose start
    clamping the callers never rely on: the window must fit)."""
    stop = start + block.shape[dim]
    if start < 0 or stop > base.shape[dim]:
        raise ValueError(f"window [{start}, {stop}) outside axis {dim} of "
                         f"size {base.shape[dim]}")
    return torch.cat([base.narrow(dim, 0, start), block,
                      base.narrow(dim, stop, base.shape[dim] - stop)], dim=dim)


# ---------------------------------------------------------------------------
# the three streaming programs
# ---------------------------------------------------------------------------


def _stream_merge(
    visible_acc: torch.Tensor,  # (M, F_alloc) bool accumulated visibility
    contained_acc: torch.Tensor,  # (M, M) bool accumulated containment
    active_acc: torch.Tensor,  # (M,) bool
    n_tot_acc: torch.Tensor,  # (M,) f32
    assignment: torch.Tensor,  # (M,) int32 current assignment
    rep_plane: torch.Tensor,  # (N,) int32 point -> rep slot + 1 (0 = none)
    mask_of_point: torch.Tensor,  # (Fc, N) int32 chunk claim planes
    vis_k: torch.Tensor,  # (Mk, Fc) bool chunk-local visible (post-undo)
    con_k: torch.Tensor,  # (Mk, Mk) bool chunk-local contained
    act_k: torch.Tensor,  # (Mk,) bool chunk-local active
    ntot_k: torch.Tensor,  # (Mk,) f32
    chunk_frame: torch.Tensor,  # (Mk,) int32 local frame per chunk mask
    chunk_id: torch.Tensor,  # (Mk,) int32 (-1 padding)
    slot_offset: int,  # global slot of chunk mask 0
    frames_base: int,  # column base of this chunk
    *,
    k_max: int,
    point_chunk: int,
    mask_visible_threshold: float,
    contained_threshold: float,
    big_mask_point_count: int,
    count_dtype: str,
):
    """Fold one chunk into the accumulator (``_stream_merge_impl``,
    ``streaming.py:141-250``): the exact within-chunk blocks, plus the
    rep-level cross terms ``c_cross[r, m'] = #points of representative r
    claimed by chunk mask m'`` by chunked counting products, with the
    representative membership one-hot standing in for the claim rows.
    Returns new (visible, contained, active, n_tot) tensors."""
    m_pad = visible_acc.shape[0]
    fc, n = mask_of_point.shape
    mk = chunk_frame.shape[0]
    dev = visible_acc.device
    if slot_offset + mk > m_pad:
        raise ValueError(f"chunk masks [{slot_offset}, {slot_offset + mk}) exceed "
                         f"the accumulator's {m_pad} slots")
    arange_m = torch.arange(m_pad, dtype=torch.int32, device=dev)
    # prior representatives: active fixpoints of the current assignment
    # (new slots are not active yet, so chunk 1 has none)
    is_rep = active_acc & (assignment == arange_m)

    safe_frame = torch.clamp(chunk_frame.long(), max=fc - 1)
    chunk_id = chunk_id.to(mask_of_point.dtype)
    c_cross = torch.zeros((m_pad, mk), dtype=counting.accumulator_dtype(count_dtype),
                          device=dev)
    rep_npts = torch.zeros(m_pad, dtype=torch.float32, device=dev)
    for start in range(0, n, point_chunk):
        mc = mask_of_point[:, start:start + point_chunk]
        rc = rep_plane[start:start + point_chunk]
        w = mc[safe_frame, :].T == chunk_id[None, :]  # (Nc, Mk)
        a = rc[:, None] == (arange_m[None, :] + 1)  # (Nc, M) rep membership
        c_cross = c_cross + counting.count_dot(a.T, w, count_dtype=count_dtype,
                                               out_dtype=None)
        rep_npts = rep_npts + a.sum(dim=0).to(torch.float32)
    c_cross = c_cross.to(torch.float32)

    # per-frame segmented max/sum over the chunk's mask columns (the batch
    # formulation; chunk masks are (frame, id)-sorted)
    cmax, top_local, n_vis = frame_segment_stats(c_cross, chunk_frame, fc, k_max)

    # representative visibility and containment in the new frames: the batch
    # visibility test with the rep's point count as n_tot
    vis_ratio = n_vis / torch.clamp(rep_npts, min=1.0)[:, None]
    visible_test = ((vis_ratio >= _f32(mask_visible_threshold, c_cross))
                    | (n_vis >= _f32(big_mask_point_count, c_cross))) \
        & (n_vis > 0) & is_rep[:, None]
    passes = (cmax / torch.clamp(n_vis, min=1.0)) > _f32(contained_threshold, c_cross)
    vis_cross = visible_test & passes  # (M, Fc)

    # contained_new[r, slot_offset + top] = True where visible; any column
    # outside [0, m_pad) goes to a dropped extra column (``mode="drop"``)
    safe_top = torch.where(vis_cross, slot_offset + top_local, m_pad)
    safe_top = torch.where((safe_top < 0) | (safe_top > m_pad), m_pad, safe_top)
    contained_new = torch.zeros((m_pad, m_pad + 1), dtype=torch.bool, device=dev).scatter(
        1, safe_top.long(), True)[:, :m_pad]

    # fold the chunk blocks in, each a new tensor
    vis_cols = _splice(vis_cross, vis_k, slot_offset, 0)
    visible_new = _splice(visible_acc, vis_cols, frames_base, 1)
    con_block = torch.zeros((m_pad, m_pad), dtype=torch.bool, device=dev)
    con_block[slot_offset:slot_offset + mk, slot_offset:slot_offset + mk] = con_k
    contained_out = contained_acc | con_block | contained_new
    active_new = _splice(active_acc, act_k, slot_offset, 0)
    n_tot_new = _splice(n_tot_acc, ntot_k, slot_offset, 0)
    return visible_new, contained_out, active_new, n_tot_new


def _stream_recluster(
    visible_acc: torch.Tensor,  # (M, F_alloc) bool
    contained_acc: torch.Tensor,  # (M, M) bool
    active_acc: torch.Tensor,  # (M,) bool
    prev_assign: torch.Tensor,  # (M,) int32 warm-start labels
    *,
    max_len: int,
    view_consensus_threshold: float,
    count_dtype: str,
) -> ClusterResult:
    """Periodic re-cluster over the accumulated state
    (``_stream_recluster_impl``, ``streaming.py:253-284``): the observer
    schedule from the accumulated visibility, as the batch graph stage
    computes it, then the merge warm-started from the previous assignment."""
    observers = counting.count_dot(visible_acc, visible_acc.T, count_dtype=count_dtype)
    hist = observer_histogram(observers, visible_acc.shape[1] + 1)
    schedule = observer_schedule_device(hist, max_len=max_len)
    return iterative_clustering(
        visible_acc, contained_acc, active_acc, schedule, prev_assign,
        view_consensus_threshold=view_consensus_threshold, count_dtype=count_dtype)


def _rep_plane_update(
    rep_plane: torch.Tensor,  # (N,) int32 point -> rep slot + 1
    rep_votes: torch.Tensor,  # (N,) int32 supporting-claim count
    first_id: torch.Tensor,  # (Fc, N) int16 chunk claim planes
    last_id: torch.Tensor,  # (Fc, N) int16
    slot_of: torch.Tensor,  # (Fc, k_max + 2) int32 (frame, id) -> slot, -1 none
    assignment: torch.Tensor,  # (M,) int32
    *,
    chunk_frames: int,  # candidate claim rows to read (<= Fc)
    min_points: int,  # liveness floor of the partial-instance count
):
    """Streaming majority vote (``_rep_plane_update_impl``,
    ``streaming.py:287-350``): fold one chunk's claims into the point ->
    representative plane. Candidates per point: its prior representative,
    weighted by its accumulated votes and listed first so that ties keep it,
    then the chunk's first and last claims through the current assignment
    (``last`` deduped against ``first``). Returns new (rep_plane, votes) and
    the 0-d partial-instance count."""
    m = assignment.shape[0]
    assign = assignment.long()
    prior_slot = torch.clamp(rep_plane.long() - 1, min=0)
    prior = torch.where(rep_plane > 0, assign[prior_slot] + 1, 0)

    first = first_id[:chunk_frames].long()
    last = last_id[:chunk_frames].long()
    last = torch.where(last == first, 0, last)  # each claim counts once
    slot_tab = slot_of.long()

    def rep_of(ids, f):
        slot = slot_tab[f, torch.clamp(ids, 0, slot_tab.shape[1] - 1)]
        rep = torch.where(slot >= 0, assign[torch.clamp(slot, 0, m - 1)] + 1, 0)
        return torch.where(ids > 0, rep, 0)

    cand = torch.stack([prior] + [rep_of(first[f], f) for f in range(chunk_frames)]
                       + [rep_of(last[f], f) for f in range(chunk_frames)], dim=0)
    weights = torch.cat([torch.clamp(rep_votes, min=1).to(torch.int32)[None, :],
                         torch.ones((cand.shape[0] - 1, cand.shape[1]), dtype=torch.int32,
                                    device=cand.device)], dim=0)
    live = cand > 0
    votes = torch.zeros(cand.shape, dtype=torch.int32, device=cand.device)
    for j in range(cand.shape[0]):
        votes = votes + ((cand == cand[j][None, :]) & live).to(torch.int32) * weights[j][None, :]
    # torch.argmax returns the first maximal index: the prior row wins ties
    winner = torch.argmax(votes, dim=0)
    new_rep = cand.gather(0, winner[None, :])[0]
    new_votes = votes.max(dim=0).values

    idx = torch.clamp(new_rep, 0, m)
    sizes = torch.zeros(m + 1, dtype=torch.int64, device=cand.device).scatter_add(
        0, idx, torch.ones_like(idx))
    partial = torch.sum(sizes[1:] >= min_points).to(torch.int32)
    return new_rep.to(torch.int32), new_votes.to(torch.int32), partial


# ---------------------------------------------------------------------------
# the accumulator
# ---------------------------------------------------------------------------


class StreamAccumulator:
    """Device state of one scene's chunked stream (``streaming.py:358-895``).

    ``push_chunk`` is transactional: every program runs against the current
    state and the new state binds only after all of them, so a mid-chunk
    fault leaves the accumulator at the previous chunk's fixpoint and the
    chunk retries cleanly. The bind is epoch-fenced: each ``push_chunk``
    entry supersedes all older attempts in flight, so an abandoned attempt
    that reaches its bind later raises ``StaleChunkAttempt`` instead of
    accumulating the chunk twice. The port fences the state's allocation
    and growth the same way (the JAX package checks at the bind only), so
    an abandoned attempt that wakes late cannot resize the state under its
    retry or under ``finalize``.
    """

    def __init__(self, cfg: PipelineConfig, *, total_frames: int, num_points: int,
                 k_max: Optional[int] = None, seq_name: Optional[str] = None,
                 device: DeviceLike = None):
        if cfg.streaming_chunk <= 0:
            raise ValueError("StreamAccumulator needs cfg.streaming_chunk > 0")
        self.cfg = cfg
        self.seq_name = seq_name
        # every tensor names this device: a chunk runs on a watchdog thread,
        # whose current CUDA device is its own
        self.device = resolve_device(device)
        self.total_frames = int(total_frames)
        self.chunk_frames = min(int(cfg.streaming_chunk), self.total_frames)
        self.n_chunks = max(-(-self.total_frames // self.chunk_frames), 1)
        self.single = self.n_chunks == 1
        f_pad_full, self.n_pad = scene_pads(cfg, self.total_frames, num_points)
        # every chunk (a partial last one included) pads to one bucket
        self.f_chunk_pad = (f_pad_full if self.single
                            else scene_pads(cfg, self.chunk_frames, num_points)[0])
        self.f_alloc = self.n_chunks * self.f_chunk_pad
        self.n_real = int(num_points)
        self.k_max = int(k_max) if k_max else 0
        # host global mask table, (frame, id)-sorted: frames arrive in order
        self.m_pad = 0
        self.masks_used = 0
        self.g_frame: Optional[np.ndarray] = None
        self.g_mask_id: Optional[np.ndarray] = None
        self.frame_ids: List = []
        self.chunks_done = 0
        self.frames_done = 0
        self.partial_instances = 0
        self.timings: Dict[str, float] = {}
        # device state, allocated at the first chunk once m_pad is sized
        self.visible = None
        self.contained = None
        self.active = None
        self.n_tot = None
        self.assignment = None
        self.node_visible = None
        self.rep_plane = None
        self.rep_votes = None
        self.scene_points: Optional[np.ndarray] = None
        # a single-chunk stream keeps its chunk's planes for the batch host
        # phase (the byte-identity path)
        self._single_assoc = None
        self._single_points = None
        self._single_frame_ids = None
        self._single_table: Optional[MaskTable] = None
        self._vox_size: Optional[torch.Tensor] = None  # 0-d, the padded cloud's
        # the abandoned-attempt fence: entry bumps the epoch, the bind
        # re-checks it under the lock
        self._epoch = 0
        self._bind_lock = mct_lock("streaming.StreamAccumulator._bind_lock")

    # -- sizing -------------------------------------------------------------

    def _presize_m_pad(self, chunk_table: MaskTable) -> int:
        """The global mask bucket: the batch m_pad for a single chunk (so the
        post-process shapes match bit for bit), else projected from the
        first chunk's density."""
        if self.single:
            return chunk_table.m_pad
        projected = int(math.ceil(max(chunk_table.num_masks, 1) * self.n_chunks
                                  * self.cfg.stream_mask_headroom))
        return max(bucket_size(projected, self.cfg.mask_pad_multiple), chunk_table.m_pad)

    def _alloc_state(self, m_pad: int) -> None:
        dev = self.device
        self.m_pad = m_pad
        self.g_frame = np.full(m_pad, self.total_frames, dtype=np.int32)
        self.g_mask_id = np.full(m_pad, -1, dtype=np.int32)
        self.visible = torch.zeros((m_pad, self.f_alloc), dtype=torch.bool, device=dev)
        self.contained = torch.zeros((m_pad, m_pad), dtype=torch.bool, device=dev)
        self.active = torch.zeros(m_pad, dtype=torch.bool, device=dev)
        self.n_tot = torch.zeros(m_pad, dtype=torch.float32, device=dev)
        self.assignment = torch.arange(m_pad, dtype=torch.int32, device=dev)
        self.node_visible = torch.zeros((m_pad, self.f_alloc), dtype=torch.bool, device=dev)
        self.rep_plane = torch.zeros(self.n_pad, dtype=torch.int32, device=dev)
        self.rep_votes = torch.zeros(self.n_pad, dtype=torch.int32, device=dev)

    def _grow_state(self, needed: int) -> None:
        """Mask capacity overflow: grow the bucket (new tensors), never drop."""
        new_pad = bucket_size(needed, self.cfg.mask_pad_multiple)
        log.warning("stream %s: mask capacity %d -> %d (projection overflow)",
                    self.seq_name, self.m_pad, new_pad)
        obs.count("stream.mask_capacity_growths")
        dm = new_pad - self.m_pad
        dev = self.device
        self.g_frame = np.concatenate([self.g_frame, np.full(dm, self.total_frames, np.int32)])
        self.g_mask_id = np.concatenate([self.g_mask_id, np.full(dm, -1, np.int32)])

        def grown(t, square=False):
            shape = (new_pad, new_pad) if square else (new_pad,) + tuple(t.shape[1:])
            out = torch.zeros(shape, dtype=t.dtype, device=dev)
            out[tuple(slice(0, k) for k in t.shape)] = t
            return out

        self.visible = grown(self.visible)
        self.contained = grown(self.contained, square=True)
        self.active = grown(self.active)
        self.n_tot = grown(self.n_tot)
        self.assignment = torch.cat([self.assignment, torch.arange(
            self.m_pad, new_pad, dtype=torch.int32, device=dev)])
        self.node_visible = grown(self.node_visible)
        self.m_pad = new_pad

    # -- per-chunk update ---------------------------------------------------

    def _bind_state(self, visible, contained, active, n_tot, assignment, node_visible,
                    rep_plane, rep_votes, table_k, offset, num_k, chunk_tensors,
                    real_frames, partial) -> None:
        """The transaction body (the caller holds ``_bind_lock`` and has
        checked the attempt's epoch): attribute and host-array assignments
        only."""
        self.visible, self.contained = visible, contained
        self.active, self.n_tot = active, n_tot
        self.assignment, self.node_visible = assignment, node_visible
        self.rep_plane, self.rep_votes = rep_plane, rep_votes
        self.g_frame[offset:offset + num_k] = self.frames_done + table_k.frame[:num_k]
        self.g_mask_id[offset:offset + num_k] = table_k.mask_id[:num_k]
        self.masks_used = offset + num_k
        self.frame_ids.extend(list(chunk_tensors.frame_ids)[:real_frames])
        self.frames_done += real_frames
        self.chunks_done += 1
        self.partial_instances = partial

    def push_chunk(self, chunk_tensors: SceneTensors) -> Dict:
        """Accumulate one frame chunk; returns the chunk's dict (its digest)."""
        cfg = self.cfg
        dev = self.device
        t0 = time.perf_counter()
        with self._bind_lock:
            # every new attempt supersedes all older ones in flight
            self._epoch += 1
            epoch = self._epoch
        ci = self.chunks_done
        # fault seam: a scripted fault here retries the chunk, state intact
        faults.inject("chunk", self.seq_name)
        real_frames = chunk_tensors.num_frames
        with obs.span("stream.chunk", scene=self.seq_name, chunk=ci,
                      frames=real_frames) as sp:
            if self.k_max <= 0:
                self.k_max = bucket_k_max(max_seg_id(chunk_tensors.segmentations))
            padded = pad_scene_tensors(chunk_tensors, self.f_chunk_pad, self.n_pad)
            # one bucket vocabulary with the batch path: a chunk is just another
            # scene-bucket coordinate
            record_shape_bucket("scene", self.k_max, self.f_chunk_pad, self.n_pad)
            if self._vox_size is None:
                # every chunk pads the one cloud to n_pad: one coverage voxel
                self._vox_size = _vox_size_jit(
                    torch.from_numpy(np.asarray(padded.scene_points, np.float32)).to(dev),
                    distance_threshold=float(cfg.distance_threshold))
            assoc = associate_scene_tensors(padded, cfg, k_max=self.k_max, device=dev,
                                            vox_size=self._vox_size)
            plane_bytes = sum(t.numel() * t.element_size() for t in (
                assoc.mask_of_point, assoc.first_id, assoc.last_id, assoc.point_visible,
                assoc.boundary))
            obs.gauge_max("stream.max_plane_bytes", float(plane_bytes))

            # the one pull a chunk needs: its mask table's bucket is data-dependent
            faults.inject("pull", self.seq_name)
            with sanctioned_pull("stream.mask_valid"):
                mask_valid_host = assoc.mask_valid.cpu().numpy()
            obs.count("stream.host_sync")
            table_k = build_mask_table(mask_valid_host, pad_multiple=cfg.mask_pad_multiple)
            sp.set(m_pad=table_k.m_pad, plane_bytes=int(plane_bytes))

            with self._bind_lock:
                # the state is sized under the fence too: a superseded attempt
                # must not allocate or grow the state its retry is using
                stale = epoch != self._epoch
                if not stale:
                    if self.chunks_done == 0:
                        self._alloc_state(self._presize_m_pad(table_k))
                        record_shape_bucket("stream", self.m_pad, self.f_alloc, self.n_pad)
                        self.scene_points = np.asarray(chunk_tensors.scene_points)  # mct-ok: AST.HOSTSYNC # mct-ok: CONC.BLOCKING (host numpy by SceneTensors contract)
                    elif self.masks_used + table_k.m_pad > self.m_pad:
                        self._grow_state(self.masks_used + table_k.m_pad)
                        record_shape_bucket("stream", self.m_pad, self.f_alloc, self.n_pad)
                    offset = self.masks_used
            if stale:
                obs.count("stream.stale_binds_dropped")
                raise StaleChunkAttempt(self.seq_name, ci)
            num_k = table_k.num_masks
            frame_t = torch.from_numpy(table_k.frame).to(dev)
            mask_id_t = torch.from_numpy(table_k.mask_id).to(dev)
            valid_t = torch.from_numpy(table_k.valid).to(dev)

            # exact within-chunk graph statistics (the batch program)
            stats = compute_graph_stats(
                assoc.mask_of_point, assoc.boundary, frame_t, mask_id_t, valid_t,
                k_max=self.k_max, point_chunk=cfg.point_chunk,
                mask_visible_threshold=cfg.mask_visible_threshold,
                contained_threshold=cfg.contained_threshold,
                undersegment_filter_threshold=cfg.undersegment_filter_threshold,
                big_mask_point_count=cfg.big_mask_point_count,
                count_dtype=cfg.count_dtype)
            act_k = valid_t & ~stats.undersegment

            visible, contained, active, n_tot = _stream_merge(
                self.visible, self.contained, self.active, self.n_tot, self.assignment,
                self.rep_plane, assoc.mask_of_point, stats.visible, stats.contained, act_k,
                stats.n_tot, frame_t, mask_id_t, offset, ci * self.f_chunk_pad,
                k_max=self.k_max, point_chunk=cfg.point_chunk,
                mask_visible_threshold=cfg.mask_visible_threshold,
                contained_threshold=cfg.contained_threshold,
                big_mask_point_count=cfg.big_mask_point_count,
                count_dtype=cfg.count_dtype)

            assignment, node_visible = self.assignment, self.node_visible
            if (ci + 1) % max(cfg.stream_recluster_every, 1) == 0 or ci + 1 == self.n_chunks:
                result = _stream_recluster(
                    visible, contained, active, self.assignment,
                    max_len=cfg.max_cluster_iterations,
                    view_consensus_threshold=cfg.view_consensus_threshold,
                    count_dtype=cfg.count_dtype)
                assignment, node_visible = result.assignment, result.node_visible
                obs.count("stream.reclusters")

            # fold the chunk's claims into the point -> rep plane
            slot_of = np.full((self.f_chunk_pad, self.k_max + 2), -1, dtype=np.int32)
            valid_rows = table_k.valid[:num_k]
            slot_of[table_k.frame[:num_k][valid_rows], table_k.mask_id[:num_k][valid_rows]] = (
                offset + np.nonzero(valid_rows)[0])
            rep_plane, rep_votes, partial_t = _rep_plane_update(
                self.rep_plane, self.rep_votes, assoc.first_id, assoc.last_id,
                torch.from_numpy(slot_of).to(dev), assignment,
                chunk_frames=self.chunk_frames,
                min_points=max(cfg.dbscan_split_min_points, 1))
            # the per-chunk accumulator digest, pulled with the partial count
            chunk_vec_dev = sentinel.digest_stream(assignment, active, rep_plane)
            with sanctioned_pull("stream.partials"):
                partial = int(partial_t)
                chunk_vec = sentinel.vector_host(chunk_vec_dev)
            obs.count("stream.host_sync")
            # fault seam: silent corruption of the pulled chunk digest, seen
            # only as drift, never as a retryable error
            if faults.take_corruption("chunk", self.seq_name):
                chunk_vec = chunk_vec.copy()
                chunk_vec[0] ^= 0x1

            # ---- transaction point: every program ran; bind ----
            with self._bind_lock:
                stale = epoch != self._epoch
                if not stale:
                    self._bind_state(visible, contained, active, n_tot, assignment, node_visible,
                                     rep_plane, rep_votes, table_k, offset, num_k, chunk_tensors,
                                     real_frames, partial)
            if stale:
                obs.count("stream.stale_binds_dropped")
                raise StaleChunkAttempt(self.seq_name, ci)
            if self.single:
                self._single_assoc = assoc
                self._single_points = np.asarray(padded.scene_points)  # mct-ok: AST.HOSTSYNC (host numpy; pad_scene_tensors keeps host frames host)
                self._single_frame_ids = list(padded.frame_ids)
                self._single_table = table_k
            state_bytes = sum(t.numel() * t.element_size() for t in (
                self.visible, self.contained, self.active, self.n_tot, self.assignment,
                self.node_visible, self.rep_plane, self.rep_votes))
            obs.gauge_max("stream.state_bytes", float(state_bytes))
            obs.gauge("stream.partial_instances", float(partial))
            obs.count("stream.chunks")
            obs.count("stream.frames", real_frames)
            sp.set(partial_instances=partial, masks=self.masks_used)
        seconds = time.perf_counter() - t0
        self.timings["stream.chunks"] = self.timings.get("stream.chunks", 0.0) + seconds
        return {"chunk": ci, "frames": real_frames,
                "frames_done": self.frames_done,
                "total_frames": self.total_frames,
                "masks": self.masks_used,
                "partial_instances": partial,
                "plane_bytes": int(plane_bytes),
                "seconds": round(seconds, 4),
                "digest": sentinel.chunk_digest_hex(chunk_vec),
                "done": self.frames_done >= self.total_frames}

    # -- global table / export ----------------------------------------------

    def global_table(self) -> MaskTable:
        valid = np.zeros(self.m_pad, dtype=bool)
        valid[:self.masks_used] = self.g_mask_id[:self.masks_used] >= 0
        return MaskTable(frame=self.g_frame.copy(), mask_id=self.g_mask_id.copy(), valid=valid,
                         num_masks=int(valid.sum()), num_frames=self.total_frames,
                         k_max=self.k_max)

    def partial_objects(self) -> SceneObjects:
        """Anytime partial instances from the current rep plane (the export
        the finalize path uses, valid after any chunk)."""
        if self.chunks_done == 0:
            raise ValueError("partial_objects() before any chunk was pushed")
        return self._objects_from_rep_plane()

    def _objects_from_rep_plane(self) -> SceneObjects:
        cfg = self.cfg
        with sanctioned_pull("stream.rep_plane"):
            rep_h = self.rep_plane.cpu().numpy()[:self.n_real]
            assign_h = self.assignment.cpu().numpy()
            active_h = self.active.cpu().numpy()
        obs.count("stream.host_sync")
        member_count = np.bincount(assign_h[active_h], minlength=self.m_pad) \
            if active_h.any() else np.zeros(self.m_pad, np.int64)
        reps = np.unique(rep_h[rep_h > 0]) - 1
        reps = [int(r) for r in reps if member_count[r] >= cfg.min_masks_per_object]
        rep_points = {r: np.nonzero(rep_h == r + 1)[0] for r in reps}
        reps = [r for r in reps if len(rep_points[r]) >= cfg.dbscan_split_min_points]
        t0 = time.perf_counter()
        labels_by_rep = dict(zip(reps, dbscan_labels_parallel(
            [self.scene_points[rep_points[r]] for r in reps],
            cfg.dbscan_split_eps, cfg.dbscan_split_min_points)))
        self.timings["stream.dbscan"] = time.perf_counter() - t0
        members: Dict[int, List[int]] = {}
        for m in np.nonzero(active_h)[0]:
            members.setdefault(int(assign_h[m]), []).append(int(m))
        point_ids, bboxes, mask_lists = [], [], []
        for r in reps:
            pts = rep_points[r]
            labels = labels_by_rep[r]
            # noise (-1) keeps its own candidate group, like the batch
            # post-process's group 0
            for g in range(int(labels.max()) + 2):
                sel = (labels + 1) == g
                if not sel.any():
                    continue
                obj_pts = pts[sel]
                if len(obj_pts) < cfg.dbscan_split_min_points:
                    continue
                share = len(obj_pts) / max(len(pts), 1)
                # the rep's whole mask list rides every split component, its
                # coverage the component's point share (per-mask point sets
                # are not kept at O(M^2) state)
                mlist = [(self.frame_ids[self.g_frame[m]], int(self.g_mask_id[m]), share)
                         for m in members.get(r, [])
                         if self.g_frame[m] < len(self.frame_ids)]
                if len(mlist) < cfg.min_masks_per_object:
                    continue
                pts3d = self.scene_points[obj_pts]
                point_ids.append(obj_pts)
                bboxes.append((pts3d.min(axis=0), pts3d.max(axis=0)))
                mask_lists.append(mlist)
        point_ids, mask_lists = _merge_overlapping(point_ids, bboxes, mask_lists,
                                                   cfg.overlap_merge_ratio)
        return SceneObjects(point_ids_list=point_ids, mask_list=mask_lists,
                            num_points=self.n_real)

    def finalize(self, *, export: bool = False, object_dict_dir: Optional[str] = None,
                 prediction_root: str = "data/prediction") -> SceneResult:
        """The stream's answer. A single-chunk stream hands the chunk's planes
        and the accumulated assignment to the batch host phase (artifacts and
        digest dict equal to ``run_scene``'s); a multi-chunk stream exports
        from the rep plane, with an artifact-only digest."""
        if self.chunks_done == 0:
            raise ValueError("finalize() before any chunk was pushed")
        if self.single:
            assoc = self._single_assoc
            handoff = DeviceHandoff(
                table=self._single_table, assignment=self.assignment, active=self.active,
                node_visible=self.node_visible, first_id=assoc.first_id,
                last_id=assoc.last_id, scene_points=self._single_points,
                frame_ids=self._single_frame_ids, k_max=self.k_max, n_real=self.n_real,
                seq_name=self.seq_name, timings=dict(self.timings))
            return run_scene_host(handoff, self.cfg, export=export,
                                  object_dict_dir=object_dict_dir,
                                  prediction_root=prediction_root)
        with obs.span("stream.finalize", scene=self.seq_name):
            t0 = time.perf_counter()
            objects = self._objects_from_rep_plane()
            with sanctioned_pull("stream.assignment"):
                assignment = self.assignment.cpu().numpy()
            if export:
                if self.seq_name is None or object_dict_dir is None:
                    raise ValueError("export=True requires seq_name and object_dict_dir")
                faults.inject("export", self.seq_name)
                export_artifacts(objects, self.seq_name, self.cfg.config_name, object_dict_dir,
                                 prediction_root=prediction_root,
                                 top_k_repre=self.cfg.num_representative_masks)
            self.timings["stream.finalize"] = time.perf_counter() - t0
        digest = sentinel.artifact_only_digest(
            objects, bucket=sentinel.bucket_label(self.k_max, self.f_chunk_pad, self.n_pad),
            count_dtype=self.cfg.count_dtype)
        return SceneResult(objects=objects, table=self.global_table(), assignment=assignment,
                           timings=dict(self.timings), digest=digest)

    # -- accumulator journal (crash resume) ---------------------------------

    def save_state(self, path: str) -> None:
        """Atomic accumulator snapshot in the JAX package's npz layout
        (multi-chunk streams only: a single chunk re-runs instead)."""
        if self.single:
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # a temporary file of this writer's own: two slices that journal one
        # scene into one state directory never share a file
        with atomic_write.replacing(path, ".npz") as tmp, \
                sanctioned_pull("stream.state_journal"):
            np.savez(
                tmp,
                version=STREAM_STATE_VERSION,
                config_name=self.cfg.config_name,
                count_dtype=self.cfg.count_dtype,
                total_frames=self.total_frames,
                chunk_frames=self.chunk_frames,
                k_max=self.k_max,
                n_pad=self.n_pad,
                m_pad=self.m_pad,
                masks_used=self.masks_used,
                chunks_done=self.chunks_done,
                frames_done=self.frames_done,
                partial_instances=self.partial_instances,
                g_frame=self.g_frame, g_mask_id=self.g_mask_id,
                frame_ids=np.asarray(self.frame_ids, dtype=object),
                visible=self.visible.cpu().numpy(),
                contained=self.contained.cpu().numpy(),
                active=self.active.cpu().numpy(),
                n_tot=self.n_tot.cpu().numpy(),
                assignment=self.assignment.cpu().numpy(),
                node_visible=self.node_visible.cpu().numpy(),
                rep_plane=self.rep_plane.cpu().numpy(),
                rep_votes=self.rep_votes.cpu().numpy(),
                scene_points=self.scene_points,
            )
        obs.count("stream.state_saves")

    def load_state(self, path: str) -> bool:
        """Resume from a journaled accumulator; False = not resumable
        (missing, torn, or another stream's coordinates)."""
        if self.single or not os.path.exists(path):
            return False
        dev = self.device
        try:
            with np.load(path, allow_pickle=True) as z:
                if int(z["version"]) != STREAM_STATE_VERSION:
                    return False
                if (str(z["config_name"]) != self.cfg.config_name
                        or str(z["count_dtype"]) != self.cfg.count_dtype
                        or int(z["total_frames"]) != self.total_frames
                        or int(z["chunk_frames"]) != self.chunk_frames
                        or int(z["n_pad"]) != self.n_pad):
                    return False

                def put(key):
                    return torch.from_numpy(np.ascontiguousarray(z[key])).to(dev)

                self.k_max = int(z["k_max"])
                self.m_pad = int(z["m_pad"])
                self.masks_used = int(z["masks_used"])
                self.chunks_done = int(z["chunks_done"])
                self.frames_done = int(z["frames_done"])
                self.partial_instances = int(z["partial_instances"])
                self.g_frame = z["g_frame"].copy()
                self.g_mask_id = z["g_mask_id"].copy()
                self.frame_ids = list(z["frame_ids"])
                self.visible = put("visible")
                self.contained = put("contained")
                self.active = put("active")
                self.n_tot = put("n_tot")
                self.assignment = put("assignment")
                self.node_visible = put("node_visible")
                self.rep_plane = put("rep_plane")
                self.rep_votes = put("rep_votes")
                self.scene_points = z["scene_points"].copy()
        except Exception:  # noqa: BLE001 — a torn snapshot restarts clean
            log.exception("stream %s: unreadable state journal %s (restarting the stream)",
                          self.seq_name, path)
            return False
        obs.count("stream.state_resumes")
        log.info("stream %s: resumed at chunk %d/%d from %s", self.seq_name,
                 self.chunks_done, self.n_chunks, path)
        return True


# ---------------------------------------------------------------------------
# the scene-level driver (run.py's streaming mode)
# ---------------------------------------------------------------------------


def stream_state_path(state_dir: str, seq_name: str) -> str:
    return os.path.join(state_dir, f"{seq_name}.stream.npz")


def stream_scene(tensors: SceneTensors, cfg: PipelineConfig, *,
                 seq_name: Optional[str] = None, export: bool = False,
                 object_dict_dir: Optional[str] = None,
                 prediction_root: str = "data/prediction",
                 state_dir: Optional[str] = None, resume: bool = True,
                 device: DeviceLike = None) -> SceneResult:
    """Cluster one scene through the chunked accumulator
    (``streaming.py:907-993``), the streaming counterpart of ``run_scene``.

    Frames feed in ``cfg.streaming_chunk``-sized chunks; a failed chunk
    retries (up to ``cfg.stream_chunk_retries``, each attempt under the
    device watchdog) with the accumulator intact; with ``state_dir`` every
    chunk but the last journals the accumulator, so a killed process resumes
    mid-stream, and the journal is removed once the scene is done.
    ``device=None`` runs on CUDA and raises when no card is present.
    """
    dev = resolve_device(device)
    k_max = bucket_k_max(max_seg_id(tensors.segmentations))
    acc = StreamAccumulator(cfg, total_frames=tensors.num_frames,
                            num_points=tensors.num_points, k_max=k_max,
                            seq_name=seq_name, device=dev)
    state_path = stream_state_path(state_dir, seq_name) if state_dir and seq_name else None
    if state_path and resume:
        acc.load_state(state_path)
    policy = faults.RetryPolicy(attempts=cfg.stream_chunk_retries + 1,
                                base_s=cfg.retry_backoff_s,
                                cap_s=max(cfg.retry_backoff_s * 8.0, 0.0))
    t0 = time.perf_counter()
    with obs.span("stream.scene", scene=seq_name, chunks=acc.n_chunks,
                  chunk_frames=acc.chunk_frames):
        for ci in range(acc.chunks_done, acc.n_chunks):
            chunk = slice_scene_frames(tensors, ci * acc.chunk_frames,
                                       min((ci + 1) * acc.chunk_frames, tensors.num_frames))
            attempt = 0
            while True:
                try:
                    digest = faults.call_with_deadline(
                        lambda chunk=chunk: acc.push_chunk(chunk),
                        cfg.watchdog_device_s, seam="device", scene=seq_name)
                    break
                except Exception as e:  # noqa: BLE001 — the chunk retry loop
                    if (faults.classify_error(e) == "terminal"
                            or attempt >= cfg.stream_chunk_retries
                            or faults.stop_requested()):
                        raise
                    attempt += 1
                    delay = policy.backoff(attempt)
                    obs.count("stream.chunk_retries")
                    log.warning("stream %s: chunk %d failed (%s); retry %d/%d in %.2fs",
                                seq_name, ci, e, attempt, cfg.stream_chunk_retries, delay)
                    if delay > 0:
                        time.sleep(delay)
            log.info("stream %s: chunk %d/%d, %d frames, %d partial instance(s)", seq_name,
                     digest["chunk"] + 1, acc.n_chunks, digest["frames_done"],
                     digest["partial_instances"])
            # the journal cadence (cfg.stream_journal_every, 0 = never); the last
            # chunk never journals: finalize follows and removes the file
            if state_path and cfg.stream_journal_every > 0 \
                    and (ci + 1) % cfg.stream_journal_every == 0 and ci + 1 < acc.n_chunks:
                acc.save_state(state_path)
        result = faults.call_with_deadline(
            lambda: acc.finalize(export=export, object_dict_dir=object_dict_dir,
                                 prediction_root=prediction_root),
            cfg.watchdog_host_s, seam="host", scene=seq_name)
    if state_path and os.path.exists(state_path):
        # a finished scene's journal must not resume into a double count
        os.remove(state_path)
    timings = dict(result.timings)
    timings["stream.total"] = round(time.perf_counter() - t0, 4)
    timings["stream.num_chunks"] = float(acc.n_chunks)
    return SceneResult(objects=result.objects, table=result.table,
                       assignment=result.assignment, timings=timings, digest=result.digest)
