"""The fused scene-batch step over a device mesh (``parallel/sharded.py:63-266, 390-422``).

The whole per-scene device pipeline, association -> graph statistics ->
observer schedule -> iterative clustering, for a batch of scenes, with the
scenes over the mesh's ``scene`` axis, their frames over ``frame`` and, on a
3-axis mesh, their points over ``point``. The JAX package writes it as one
jitted program and lets XLA place the shards and insert the collectives;
here one controller process places every shard itself (``parallel/mesh.py``):

- **scene lanes**: each scene of the batch runs in its own thread, on its
  row of the mesh, so lanes on distinct cards overlap (the clustering reads
  a host flag every sweep, which would serialise a loop over lanes). A lane
  depends only on its own inputs, so the result does not depend on the
  order the threads finish in;
- **association**: every (frame shard, point shard) block claims its points
  on its device against its frames, through the port's association kernels
  (``models/backprojection.claim_frames``). The coverage voxel comes from
  ``estimate_spacing`` over the whole sentinel-padded cloud, once a lane,
  never per point shard. A mask's claim count is the sum of its blocks'
  partial counts over the point shards; its validity then decides each
  block's assignment (``assign_frames``), and the boundary is the OR over
  frame shards;
- **graph**: each point shard's claim planes are gathered over the frame
  shards onto the shard's first device, which counts its co-occurrences
  (``models/graph.cooccurrence_counts``); the partial counts are summed on
  the lane's first device in shard order (exact integers: any order gives
  the same bytes), where the unchanged threshold code, the schedule and the
  clustering run.

Every copy between two mesh coordinates goes through :func:`_send`, which
books its bytes on the cost observatory's census (``obs/cost.py``) by
coordinate, not by physical card: a mesh that repeats one card makes the
copies no-ops, and they still count. ``build_stage_step`` and
``stage_arg_shapes`` are the observatory's per-stage seams (JAX
``parallel/sharded.py:302-388``); ``fused_step_aot_key`` names the launch
keys the step makes, the census the retrace family pins.

The fused step uses a *dense* mask slot table (slot = frame * k_max + id,
``M_pad = F_pad * k_max``) and never compacts masks, so it has no
mid-program pull; the single-device path (``models/pipeline.py``) compacts
the valid masks first. Inactive slots change no artifact byte.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from maskclustering_tpu_torch.device import DeviceLike, resolve_device
from maskclustering_tpu_torch.io.feed import FUSED_FEED_DEPTH_SCALE, decode_depth
from maskclustering_tpu_torch.models.backprojection import (
    _frame_counts,
    _vox_size_jit,
    assign_frames,
    claim_frames,
    mask_validity,
)
from maskclustering_tpu_torch.models.clustering import iterative_clustering
from maskclustering_tpu_torch.models.graph import (
    cooccurrence_counts,
    graph_stats_from_counts,
    observer_schedule_device,
)
from maskclustering_tpu_torch.parallel.mesh import MESH_AXIS_NAMES, Mesh
from maskclustering_tpu_torch.utils.daemon_future import DaemonFuture


class FusedStepResult(NamedTuple):
    """Outputs of the fused step, one entry per scene lane.

    Each lane's tensors live on the lane's first device, except the (F, N)
    claim planes, which stay split by point shard: one (F, N / P) tensor per
    shard, on the first device of the shard's column of the mesh.
    :meth:`stacked` gives the JAX result's (S, ...) arrays.
    """

    assignment: List[torch.Tensor]  # (M_pad,) int32 representative slot per mask slot
    node_visible: List[torch.Tensor]  # (M_pad, F) bool aggregated visible_frame per rep
    mask_active: List[torch.Tensor]  # (M_pad,) bool valid & not undersegmented
    mask_of_point: List[List[torch.Tensor]]  # per point shard (F, N / P) int32
    first_id: List[List[torch.Tensor]]  # per point shard (F, N / P) int16
    last_id: List[List[torch.Tensor]]  # per point shard (F, N / P) int16
    num_objects: List[torch.Tensor]  # () int32 live representative count

    def lane_plane(self, name: str, lane: int) -> torch.Tensor:
        """Claim plane ``name`` of one lane, its point shards joined on the
        lane's first device."""
        home = self.assignment[lane].device
        return torch.cat([s.to(home) for s in getattr(self, name)[lane]], dim=1)

    def stacked(self) -> "FusedStepResult":
        """Host numpy arrays with a leading scene axis, point shards joined."""
        def lanes(xs):
            return np.stack([x.cpu().numpy() for x in xs])

        def planes(name):
            return np.stack([self.lane_plane(name, i).cpu().numpy()
                             for i in range(len(self.assignment))])

        return FusedStepResult(
            assignment=lanes(self.assignment), node_visible=lanes(self.node_visible),
            mask_active=lanes(self.mask_active), mask_of_point=planes("mask_of_point"),
            first_id=planes("first_id"), last_id=planes("last_id"),
            num_objects=lanes(self.num_objects))


def _send(x: torch.Tensor, row: np.ndarray, src: Tuple[int, int], dst: Tuple[int, int]
          ) -> torch.Tensor:
    """``x`` from the lane's (frame, point) coordinate ``src`` to ``dst``,
    its bytes booked as a cross-device copy when the coordinates differ."""
    if src != dst:
        from maskclustering_tpu_torch.obs import cost

        cost.book_transfer(x.numel() * x.element_size())
    return x.to(row[dst])


def _dense_mask_table(num_frames: int, k_max: int, device):
    """(frame, id) of every dense mask slot, int32 on ``device``."""
    mask_frame = torch.arange(num_frames, dtype=torch.int32, device=device).repeat_interleave(k_max)
    mask_id = torch.arange(1, k_max + 1, dtype=torch.int32, device=device).repeat(num_frames)
    return mask_frame, mask_id


def _device_grid(mesh: Optional[Mesh], device: DeviceLike) -> np.ndarray:
    """The (scene, frame, point) array of devices; a 2-axis mesh gets a point
    axis of 1, and ``mesh=None`` is one ``device`` for everything."""
    if mesh is None:
        grid = np.empty((1, 1, 1), dtype=object)
        grid[0, 0, 0] = resolve_device(device)
        return grid
    if mesh.axis_names not in (MESH_AXIS_NAMES[:2], MESH_AXIS_NAMES):
        raise ValueError(f"the fused step needs a (scene, frame) or (scene, frame, point) mesh, "
                         f"got axes {mesh.axis_names}")
    return mesh.devices if mesh.devices.ndim == 3 else mesh.devices[..., None]


def _frames_on(depths: torch.Tensor, segs: torch.Tensor, device):
    """Decode a frame shard on its device: uint16 depth carries
    ``FUSED_FEED_DEPTH_SCALE`` quanta (the dtype is the only flag); float32
    passes through; ids become int32."""
    d = depths.to(device)
    d = decode_depth(d, FUSED_FEED_DEPTH_SCALE) if d.dtype == torch.uint16 else d.to(torch.float32)
    return d, segs.to(device).to(torch.int32)


def _assoc_stage(cfg, k_max: int, row: np.ndarray, scene_points, depths, segs, intrinsics,
                 cam_to_world, frame_valid, held: Optional[list]):
    """Association of one lane over its (frame, point) row of devices.

    Returns, per point shard, the frame-gathered ``(mask_of_point, first,
    last, boundary)`` on the shard's column device ``row[0, p]``, and the
    (F, k_max + 1) mask validity on the lane's first device. ``held``
    (``donate=False``) keeps every device copy of the depth and id stacks.
    """
    f_axis, p_axis = row.shape
    home = row[0, 0]
    f_pad, n_pad = depths.shape[0], scene_points.shape[0]
    if f_pad % f_axis or n_pad % p_axis:
        raise ValueError(f"({f_pad} frames, {n_pad} points) do not split over a "
                         f"{f_axis} x {p_axis} (frame, point) row")
    fs, ns = f_pad // f_axis, n_pad // p_axis
    # a scalar statistic of the whole padded cloud: once a lane, never per shard
    vox_size = _vox_size_jit(scene_points.to(home), distance_threshold=cfg.distance_threshold)
    kw = dict(k_max=k_max, window=cfg.association_window,
              distance_threshold=cfg.distance_threshold, depth_trunc=cfg.depth_trunc)
    blocks = [[None] * p_axis for _ in range(f_axis)]  # (mop, first, last) per block
    valid_rows = []
    for fi in range(f_axis):
        frames = slice(fi * fs, (fi + 1) * fs)
        claims = []
        for pi in range(p_axis):
            dev = row[fi, pi]
            d, s = _frames_on(depths[frames], segs[frames], dev)
            intr, c2w = intrinsics[frames].to(dev), cam_to_world[frames].to(dev)
            if pi == 0:  # per frame, so once a frame shard, on its first device
                n_pixels, n_voxels = _frame_counts(
                    d, s, intr, c2w, _send(vox_size, row, (0, 0), (fi, pi)), k_max=k_max,
                    distance_threshold=cfg.distance_threshold, depth_trunc=cfg.depth_trunc)
            pts = scene_points[pi * ns:(pi + 1) * ns].to(dev)
            claims.append((pts, claim_frames(pts, d, s, intr, c2w, **kw)))
            if held is not None:
                held += [d, s]
        # a mask's claim count over the whole cloud: the point shards' partials
        n_claimed = claims[0][1].n_claimed
        for pi, (_, c) in enumerate(claims[1:], start=1):
            n_claimed = n_claimed + _send(c.n_claimed, row, (fi, pi), (fi, 0))
        mask_valid = mask_validity(n_pixels, n_voxels, n_claimed, frame_valid[frames],
                                   k_max=k_max, few_points_threshold=cfg.few_points_threshold,
                                   coverage_threshold=cfg.coverage_threshold)
        for pi, (pts, c) in enumerate(claims):
            blocks[fi][pi] = assign_frames(pts, c, _send(mask_valid, row, (fi, 0), (fi, pi)),
                                           k_max=k_max, window=cfg.association_window)
        valid_rows.append(_send(mask_valid, row, (fi, 0), (0, 0)))
        del claims  # the pixel tables
    shards = []
    for pi in range(p_axis):
        col = row[0, pi]
        mop, first, last = (torch.cat([_send(blocks[fi][pi][k], row, (fi, pi), (0, pi))
                                       for fi in range(f_axis)])
                            for k in range(3))
        boundary = torch.zeros(ns, dtype=torch.bool, device=col)
        for fi in range(f_axis):  # the OR over frame shards, in shard order
            _, bf, bl = blocks[fi][pi]
            boundary = boundary | _send((bf != bl).any(dim=0), row, (fi, pi), (0, pi))
        shards.append((mop, first, last, boundary))
    return shards, torch.cat(valid_rows)


def _graph_stage(cfg, k_max: int, row: np.ndarray, shards, active0):
    """Mask-graph statistics over the dense slot table: each point shard's
    co-occurrence counts on its column device, summed on the lane's first."""
    home = row[0, 0]
    f = shards[0][0].shape[0]
    c = n_tot = None
    for pi, (mop, _, _, boundary) in enumerate(shards):
        mask_frame, mask_id = _dense_mask_table(f, k_max, row[0, pi])
        cp, tp = cooccurrence_counts(mop, boundary, mask_frame, mask_id, cfg.point_chunk,
                                     cfg.count_dtype)
        cp, tp = _send(cp, row, (0, pi), (0, 0)), _send(tp, row, (0, pi), (0, 0))
        c, n_tot = (cp, tp) if c is None else (c + cp, n_tot + tp)
    mask_frame, _ = _dense_mask_table(f, k_max, home)
    return graph_stats_from_counts(
        c, n_tot, mask_frame, active0, num_frames=f, k_max=k_max,
        mask_visible_threshold=cfg.mask_visible_threshold,
        contained_threshold=cfg.contained_threshold,
        undersegment_filter_threshold=cfg.undersegment_filter_threshold,
        big_mask_point_count=cfg.big_mask_point_count, count_dtype=cfg.count_dtype)


def _cluster_stage(cfg, visible, contained, active, schedule):
    """Iterative view-consensus clustering of one lane."""
    return iterative_clustering(visible, contained, active, schedule,
                                view_consensus_threshold=cfg.view_consensus_threshold,
                                count_dtype=cfg.count_dtype)


def _host_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


def build_fused_step(mesh: Optional[Mesh], cfg, *, k_max: int = 15, donate: bool = False,
                     device: DeviceLike = None):
    """The fused pipeline step over ``mesh``.

    Returns a function of the batched scene arrays ``(scene_points (S, N, 3),
    depths (S, F, H, W), segs (S, F, H, W), intrinsics (S, F, 3, 3),
    cam_to_world (S, F, 4, 4), frame_valid (S, F))`` (numpy or torch)
    returning a :class:`FusedStepResult`. S must be a multiple of the
    ``scene`` axis; lane i runs on scene row ``i // (S / scene axis)``, as
    the JAX program's contiguous scene sharding places it. F must split
    over the ``frame`` axis and N over the ``point`` axis. ``mesh=None`` is
    the unsharded step on ``device`` (default: the CUDA card).

    ``donate=True`` drops the step's references to its device copies of the
    depth and id stacks, the batch's largest tenants, as soon as the
    association has read them; ``donate=False`` holds them to the end of
    the step. The results are the same. Each lane runs on a thread of its
    own; when the calling thread is under the cost census, each lane is
    observed too (``obs.cost.lane``).
    """
    grid = _device_grid(mesh, device)

    def per_scene(row, scene_points, depths, segs, intrinsics, cam_to_world, frame_valid):
        held = None if donate else []
        shards, mask_valid = _assoc_stage(cfg, k_max, row, scene_points, depths, segs,
                                          intrinsics, cam_to_world, frame_valid, held)
        home = row[0, 0]
        mask_frame, mask_id = _dense_mask_table(depths.shape[0], k_max, home)
        active0 = mask_valid[mask_frame.long(), mask_id.long()]  # (M_pad,) slot validity
        stats = _graph_stage(cfg, k_max, row, shards, active0)
        schedule = observer_schedule_device(stats.observer_hist,
                                            max_len=cfg.max_cluster_iterations)
        active = active0 & ~stats.undersegment
        result = _cluster_stage(cfg, stats.visible, stats.contained, active, schedule)
        num_objects = (result.node_active & active).sum().to(torch.int32)
        return (result.assignment, result.node_visible, active,
                *([s[k] for s in shards] for k in range(3)), num_objects)

    def step(scene_points, depths, segs, intrinsics, cam_to_world, frame_valid):
        arrays = [_host_tensor(a) for a in (scene_points, depths, segs, intrinsics,
                                            cam_to_world, frame_valid)]
        s = arrays[0].shape[0]
        s_axis = grid.shape[0]
        if s % s_axis:
            raise ValueError(f"a batch of {s} scenes does not split over a scene axis of "
                             f"{s_axis}")
        per_row = s // s_axis
        from maskclustering_tpu_torch.obs import cost

        futures = [DaemonFuture(cost.lane(lambda i=i: per_scene(grid[i // per_row],
                                                                *(a[i] for a in arrays))),
                                name=f"fused-lane-{i}")
                   for i in range(s)]
        lanes, errors = [], []
        for fut in futures:  # every lane ends before the step raises
            try:
                lanes.append(fut.result())
            except Exception as e:  # noqa: BLE001 — the first lane's error is raised
                errors.append(e)
        if errors:
            raise errors[0]
        return FusedStepResult(*(list(col) for col in zip(*lanes)))

    return step


def fused_step_example_args(num_scenes: int = 2, num_frames: int = 8, num_points: int = 4096,
                            image_hw=(32, 48), seed: int = 0, spacing: float = 0.08):
    """Tiny synthetic scene batch: each cloud padded to ``num_points`` by
    tiling (harmless duplicates), never truncated."""
    from maskclustering_tpu_torch.utils.synthetic import make_scene

    scenes = [make_scene(num_boxes=3, num_frames=num_frames, image_hw=image_hw,
                         spacing=spacing, seed=seed + i)
              for i in range(num_scenes)]
    n = num_points

    def pad_points(p):
        if p.shape[0] > n:
            raise ValueError(f"scene has {p.shape[0]} points > budget {n}; "
                             f"raise num_points or spacing")
        reps = -(-n // p.shape[0])
        return np.tile(p, (reps, 1))[:n]

    return (
        np.stack([pad_points(s.scene_points) for s in scenes]).astype(np.float32),
        np.stack([s.depths for s in scenes]),
        np.stack([s.segmentations for s in scenes]),
        np.stack([s.intrinsics for s in scenes]),
        np.stack([s.cam_to_world for s in scenes]),
        np.stack([s.frame_valid for s in scenes]),
    )


# ---------------------------------------------------------------------------
# per-stage seams of the cost observatory (obs/cost.py) and the retrace census
# ---------------------------------------------------------------------------

# the stages the observatory runs one by one, in pipeline order; "fused"
# (the whole step) is build_fused_step itself
STAGE_NAMES = ("backprojection", "graph", "clustering", "postprocess")


def build_stage_step(stage: str, mesh: Optional[Mesh], cfg, *, k_max: int = 15,
                     r_pad: int = 64, device: DeviceLike = None):
    """One pipeline stage as a callable over ``mesh`` (JAX
    ``parallel/sharded.py:302-356``).

    The stages are the very sections the fused step runs (``_assoc_stage``,
    ``_graph_stage``, ``_cluster_stage``), over the batched (S, ...) inputs
    of :func:`stage_arg_shapes`, lane after lane in the calling thread.
    ``postprocess`` is the ``post.claims`` node-statistics kernel
    (``models/postprocess_device._node_stats_kernel``) of one scene on the
    lane's first device, whatever the mesh, as in production.
    """
    from maskclustering_tpu_torch.models.postprocess_device import _node_stats_kernel

    if stage not in STAGE_NAMES:
        raise ValueError(f"unknown stage {stage!r}; valid: {STAGE_NAMES}")
    grid = _device_grid(mesh, device)

    def lanes(arrays, fn):
        arrays = [_host_tensor(a) for a in arrays]
        s = arrays[0].shape[0]
        if s % grid.shape[0]:
            raise ValueError(f"a batch of {s} scenes does not split over a scene axis of "
                             f"{grid.shape[0]}")
        per_row = s // grid.shape[0]
        return [fn(grid[i // per_row], *(a[i] for a in arrays)) for i in range(s)]

    if stage == "postprocess":
        home = grid[0, 0, 0]

        def post(first, last, rep_tab, node_visible, live_slots, live_valid):
            args = [_host_tensor(a).to(home) for a in (first, last, rep_tab, node_visible,
                                                       live_slots, live_valid)]
            return _node_stats_kernel(*args, r_pad=r_pad,
                                      point_filter_threshold=float(cfg.point_filter_threshold),
                                      count_dtype=cfg.count_dtype)

        return post
    if stage == "backprojection":
        def assoc(row, scene_points, depths, segs, intrinsics, cam_to_world, frame_valid):
            return _assoc_stage(cfg, k_max, row, scene_points, depths, segs, intrinsics,
                                cam_to_world, frame_valid, None)

        return lambda *arrays: lanes(arrays, assoc)
    if stage == "graph":
        def graph(row, mask_of_point, boundary, active0):
            p_axis = row.shape[1]
            ns = mask_of_point.shape[1] // p_axis
            shards = [(mask_of_point[:, pi * ns:(pi + 1) * ns].to(row[0, pi]), None, None,
                       boundary[pi * ns:(pi + 1) * ns].to(row[0, pi])) for pi in range(p_axis)]
            return _graph_stage(cfg, k_max, row, shards, active0.to(row[0, 0]))

        return lambda *arrays: lanes(arrays, graph)

    def cluster(row, visible, contained, active, schedule):
        home = row[0, 0]
        return _cluster_stage(cfg, visible.to(home), contained.to(home), active.to(home),
                              schedule.to(home))

    return lambda *arrays: lanes(arrays, cluster)


def stage_arg_shapes(stage: str, *, scenes: int = 1, frames: int = 8, points: int = 4096,
                     image_hw: Tuple[int, int] = (32, 48), k_max: int = 15,
                     max_iters: int = 20, r_pad: int = 64) -> Tuple[Tuple, ...]:
    """The ((shape), dtype) of each argument of ``build_stage_step(stage)``
    (JAX ``parallel/sharded.py:358-388``): the fused path's dense slot
    layout, ``M_pad = F * k_max``; the clustering schedule is the
    fixed-length observer-threshold vector; ``postprocess`` takes the claim
    planes and the node-statistics tables of one scene (``k2 = k_max + 2``
    local-id rows, ``r_pad`` live representative slots)."""
    s, f, n = scenes, frames, points
    h, w = image_hw
    m_pad = f * k_max
    if stage in ("backprojection", "fused"):
        return (((s, n, 3), torch.float32), ((s, f, h, w), torch.float32),
                ((s, f, h, w), torch.int32), ((s, f, 3, 3), torch.float32),
                ((s, f, 4, 4), torch.float32), ((s, f), torch.bool))
    if stage == "graph":
        return (((s, f, n), torch.int32), ((s, n), torch.bool), ((s, m_pad), torch.bool))
    if stage == "clustering":
        return (((s, m_pad, f), torch.bool), ((s, m_pad, m_pad), torch.bool),
                ((s, m_pad), torch.bool), ((s, max_iters), torch.float32))
    if stage == "postprocess":
        k2 = k_max + 2
        return (((f, n), torch.int16), ((f, n), torch.int16), ((f, k2), torch.int32),
                ((m_pad, f), torch.bool), ((r_pad,), torch.int32), ((r_pad,), torch.bool))
    raise ValueError(f"unknown stage {stage!r}; valid: {STAGE_NAMES + ('fused',)}")


def stage_example_args(stage: str, cfg, *, mesh: Optional[Mesh] = None,
                       device: DeviceLike = None, scenes: int = 1, frames: int = 8,
                       points: int = 4096, image_hw: Tuple[int, int] = (32, 48),
                       k_max: int = 15, seed: int = 0, batch=None):
    """Inputs of ``build_stage_step(stage)`` made from a seed: a synthetic
    batch (``fused_step_example_args``, or ``batch``: the same six arrays of
    a real scene set), run through the stages upstream of ``stage``.
    Returns ``(args, r_pad)``; the args have :func:`stage_arg_shapes`'s
    shapes and dtypes."""
    from maskclustering_tpu_torch.models.postprocess_device import _prep_kernel, _rep_bucket

    if batch is None:
        batch = _seeded_batch(scenes, frames, points, image_hw, seed)
    batch = tuple(_host_tensor(a) for a in batch)
    batch = (batch[0].float(), batch[1].float(), batch[2].to(torch.int32), batch[3].float(),
             batch[4].float(), batch[5].bool())
    if stage in ("backprojection", "fused"):
        return batch, 64
    grid = _device_grid(mesh, device)
    home = grid[0, 0, 0]
    f = batch[1].shape[1]
    mask_frame, mask_id = _dense_mask_table(f, k_max, home)
    assoc = build_stage_step("backprojection", mesh, cfg, k_max=k_max, device=device)(*batch)
    mops, bounds, actives = [], [], []
    for shards, mask_valid in assoc:
        mops.append(torch.cat([sh[0].to(home) for sh in shards], dim=1))
        bounds.append(torch.cat([sh[3].to(home) for sh in shards]))
        actives.append(mask_valid.to(home)[mask_frame.long(), mask_id.long()])
    graph_args = (torch.stack(mops), torch.stack(bounds), torch.stack(actives))
    if stage == "graph":
        return graph_args, 64
    stats = build_stage_step("graph", mesh, cfg, k_max=k_max, device=device)(*graph_args)
    schedules = [observer_schedule_device(st.observer_hist, max_len=cfg.max_cluster_iterations)
                 for st in stats]
    cluster_args = (torch.stack([st.visible for st in stats]),
                    torch.stack([st.contained for st in stats]),
                    torch.stack([a & ~st.undersegment for a, st in zip(graph_args[2], stats)]),
                    torch.stack(schedules))
    if stage == "clustering":
        return cluster_args, 64
    # postprocess: lane 0's claim planes and its clustering's live reps
    res = build_stage_step("clustering", None, cfg, k_max=k_max,
                           device=home)(*(a[:1] for a in cluster_args))[0]
    first = torch.cat([sh[1].to(home) for sh in assoc[0][0]], dim=1)
    last = torch.cat([sh[2].to(home) for sh in assoc[0][0]], dim=1)
    active = cluster_args[2][0]
    m = int(cfg.min_masks_per_object)
    live = int((torch.bincount(res.assignment[active].long(), minlength=active.shape[0])
                >= m).sum())
    r_pad = _rep_bucket(live)
    rep_tab, live_slots, live_valid, *_ = _prep_kernel(
        res.assignment, active, mask_frame, mask_id, r_pad=r_pad, f=f, k2=k_max + 2,
        min_masks_per_object=m)
    return (first, last, rep_tab, res.node_visible, live_slots, live_valid), r_pad


def _seeded_batch(scenes: int, frames: int, points: int, image_hw, seed: int):
    """``fused_step_example_args`` at the widest spacing step that fits
    ``points`` (a small image needs sparser boxes to stay in budget)."""
    for spacing in (0.08, 0.12, 0.16, 0.24, 0.32):
        try:
            return fused_step_example_args(num_scenes=scenes, num_frames=frames,
                                           num_points=points, image_hw=image_hw, seed=seed,
                                           spacing=spacing)
        except ValueError:
            continue
    raise ValueError(f"no synthetic scene of {frames} frames at {image_hw} fits {points} points")


def fused_step_aot_key(mesh_shape: Tuple[int, ...], cfg, *, frames: int, points: int,
                       image_hw: Tuple[int, int], k_max: int) -> List[str]:
    """The launch keys one lane of the fused step makes on a card, as the
    retrace sanitizer names them (``entry shape`` rows): each (frame shard,
    point shard) block builds its pixel table and claims and assigns its
    points, one launch each (JAX ``parallel/sharded.py:269-290`` keys one
    executable a mesh; the port's surface is its launches)."""
    f_axis = mesh_shape[1]
    p_axis = mesh_shape[2] if len(mesh_shape) == 3 else 1
    fs, ns = frames // f_axis, points // p_axis
    h, w = image_hw
    taps = (2 * int(cfg.association_window) + 1) ** 2
    return sorted({f"associate_table {fs}x{h}x{w}",
                   f"associate_claim {fs}x{ns}x{h}x{w}x{taps}",
                   f"associate_assign {fs}x{ns}x{h}x{w}x{taps}"})
