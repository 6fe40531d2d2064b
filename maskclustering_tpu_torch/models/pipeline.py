"""Per-scene pipeline: association -> graph -> clustering -> post-process.

Counterpart of ``maskclustering_tpu/models/pipeline.py:59-404``, single
device, whole scenes. Two associations: the dense projective association
(the default, ``use_exact_ball_query=False``), which pads the scene to the
JAX package's (F_pad, N_pad) shape bucket and runs on the device, and the
exact-parity one (``use_exact_ball_query=True``), host numpy around the
ball-query kernel. Two post-process rungs: on the device (the default,
``device_postprocess=True``) or on the host. Streaming runs the same stages
chunk by chunk (``models/streaming.py``), and the fused multi-device step
(``parallel/``) over a dense mask slot table; this module ignores
``mesh_shape``, as the JAX ``run_scene`` does.

Fault seams (``utils/faults.inject``, the JAX package's sites): ``device``
at the head of the device phase, ``pull`` before the mask-table pull,
``host`` at the head of the host phase, ``export`` before the artifacts are
written, and the ``corrupt`` bit-flip of the pulled assignment before the
digest (``post`` heads the device post-process,
``models/postprocess_device.py``).

Device traffic per scene: ``mask_valid`` comes back once, to build the
mask table (the pipeline's one mid-program pull); the 20-float schedule is
read once by the clustering loop; then the post-process rung pulls what it
needs (the device rung a few scalars per phase and the survivors' bit
planes; the host rung the claim planes), and the scene's digest vector
(``obs/digest.py``) comes back beside the assignment. The pulls are
counted in ``timings["pulls"]`` and on the ``pipeline.host_sync`` counter,
and the span of each carries a ``host_pull`` attribute.

Under the host-sync guard (``run.py --transfer-guard``,
``analysis/transfer_guard.py``) the device phase runs inside
``device_phase_guard`` and every host read or upload it keeps is a named
``sanctioned_pull`` window: ``scene.upload`` and ``mask_table.upload`` (the
explicit uploads, JAX's ``device_put``), ``mask_valid`` (the one pull JAX
has), ``cluster.schedule`` and one ``cluster.sweep`` a propagation sweep
(``models/clustering.py``), and ``fence.<stage>`` for each stage's
synchronize; the exact-parity association, host numpy around the
ball-query kernel by design, is one ``associate.exact`` window. Any other
read raises.

Stages book the JAX package's spans into ``obs.scene_tracer()``:
``associate``, ``graph`` (the mask-table pull), ``cluster`` (with its
``cluster.solve`` child), ``postprocess`` with its ``post.*`` children,
and ``export``. Each stage ends in a device synchronize whether obs is
armed or not, so ``timings`` is the same either way; armed, the
synchronize's wait is the span's ``sync_s`` (device time). Disarmed, the
spans add no synchronize and no launch.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from maskclustering_tpu_torch import obs
from maskclustering_tpu_torch.analysis.transfer_guard import device_phase_guard, sanctioned_pull
from maskclustering_tpu_torch.config import PipelineConfig
from maskclustering_tpu_torch.datasets.base import SceneTensors
from maskclustering_tpu_torch.device import DeviceLike, resolve_device, synchronize
from maskclustering_tpu_torch.models.backprojection import associate_scene_tensors
from maskclustering_tpu_torch.models.clustering import iterative_clustering
from maskclustering_tpu_torch.models.exact_backprojection import associate_scene_exact
from maskclustering_tpu_torch.models.graph import (
    MaskTable,
    build_mask_table,
    compute_graph_stats,
    observer_schedule_device,
)
from maskclustering_tpu_torch.models.postprocess import SceneObjects, export_artifacts
from maskclustering_tpu_torch.models.postprocess_device import run_postprocess
from maskclustering_tpu_torch.obs import digest as sentinel
from maskclustering_tpu_torch.utils import faults
from maskclustering_tpu_torch.utils.compile_cache import (
    bucket_k_max,
    max_seg_id,
    record_shape_bucket,
    scene_pads,
)

log = logging.getLogger("maskclustering_tpu_torch")


class SceneResult(NamedTuple):
    objects: SceneObjects
    table: MaskTable
    assignment: np.ndarray
    timings: Dict[str, float]
    # the scene's invariant digest (``obs/digest.py``): both post-process
    # rungs and both associations carry the plane lane
    digest: Optional[Dict] = None


class DeviceHandoff(NamedTuple):
    """Everything the host phase needs from the device phase of one scene."""

    table: MaskTable
    assignment: torch.Tensor  # (M_pad,) int32
    active: torch.Tensor  # (M_pad,) bool — valid & not undersegmented
    node_visible: torch.Tensor  # (M_pad, F) bool
    first_id: torch.Tensor  # (F, N) int16
    last_id: torch.Tensor  # (F, N) int16
    scene_points: np.ndarray  # (N_pad, 3) f32, host (padded on the dense path)
    frame_ids: Sequence  # padded frame identifiers
    k_max: int
    n_real: int  # true (pre-pad) point count
    seq_name: Optional[str]
    timings: Dict[str, float]  # associate/graph/cluster stage walls


class _Stage:
    """Wall time of one stage, ending in a device synchronize, booked as a
    span of the scene tracer: the synchronize's wait is the span's
    ``sync_s``, the device time the stage dispatched."""

    def __init__(self, timings: Dict[str, float], name: str, device: torch.device,
                 **attrs):
        self.timings, self.name, self.device = timings, name, device
        self.span = obs.scene_tracer().span(name, **attrs)

    def __enter__(self):
        self.span.__enter__()
        self.t0 = time.perf_counter()
        return self.span

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        with sanctioned_pull(f"fence.{self.name}"):
            synchronize(self.device)
        now = time.perf_counter()
        self.span.sync_s += now - t1
        self.timings[self.name] = now - self.t0
        return self.span.__exit__(*exc)


def _count_pulls(timings: Dict[str, float], n: int) -> None:
    """Book ``n`` host pulls in ``timings["pulls"]`` and on
    ``pipeline.host_sync`` (the two always agree)."""
    timings["pulls"] = timings.get("pulls", 0) + n
    obs.count("pipeline.host_sync", n)


def pad_scene_tensors(tensors: SceneTensors, f_pad: int, n_pad: int) -> SceneTensors:
    """Pad a scene to a (F_pad, N_pad) shape bucket (``pipeline.py:111-149``).

    Padded frames are invalid (no claims); padded points sit at the far
    sentinel coordinate 1.0e4, which no frustum reaches within depth_trunc.
    Frame stacks pad where they live: tensors (the device scene generator's
    frames) with ``torch.cat`` on their device, host numpy with ``np.pad``,
    so host frames still reach the feed's encoder (``io/feed.py``).
    """
    f, n = tensors.num_frames, tensors.num_points
    if f == f_pad and n == n_pad:
        return tensors
    if f_pad < f or n_pad < n:
        raise ValueError(f"bucket ({f_pad}, {n_pad}) smaller than scene ({f}, {n})")
    pts = np.full((n_pad, 3), 1.0e4, dtype=np.float32)
    pts[:n] = tensors.scene_points
    df = f_pad - f

    def pad_frames(arr, constant_values=0.0):
        if isinstance(arr, torch.Tensor):
            fill = torch.full((df, *arr.shape[1:]), constant_values, dtype=arr.dtype,
                              device=arr.device)
            return torch.cat([arr, fill])
        widths = ((0, df),) + ((0, 0),) * (np.ndim(arr) - 1)
        return np.pad(np.asarray(arr), widths, constant_values=constant_values)

    return dataclasses.replace(
        tensors,
        scene_points=pts,
        depths=pad_frames(tensors.depths),
        segmentations=pad_frames(tensors.segmentations),
        intrinsics=pad_frames(tensors.intrinsics, constant_values=1.0),
        cam_to_world=pad_frames(tensors.cam_to_world, constant_values=0.0),
        frame_valid=np.concatenate([np.asarray(tensors.frame_valid), np.zeros(df, dtype=bool)]),
        frame_ids=list(tensors.frame_ids) + [None] * df,
    )


def run_scene_device(tensors: SceneTensors, cfg: PipelineConfig, *,
                     k_max: Optional[int] = None, seq_name: Optional[str] = None,
                     device: DeviceLike = None) -> DeviceHandoff:
    """Device phase of one scene: associate -> graph -> cluster, under the
    host-sync guard when it is armed (``analysis/transfer_guard.py``)."""
    device = resolve_device(device)
    with device_phase_guard():
        return _run_scene_device_impl(tensors, cfg, k_max=k_max, seq_name=seq_name,
                                      device=device)


def _run_scene_device_impl(tensors: SceneTensors, cfg: PipelineConfig, *,
                           k_max: Optional[int], seq_name: Optional[str],
                           device: torch.device) -> DeviceHandoff:
    faults.inject("device", seq_name)
    timings: Dict[str, float] = {}
    if k_max is None:
        k_max = bucket_k_max(max_seg_id(tensors.segmentations))
    n_real = tensors.num_points

    with _Stage(timings, "associate", device, scene=seq_name, k_max=k_max,
                num_frames=tensors.num_frames, num_points=n_real) as sp:
        if cfg.use_exact_ball_query:
            with sanctioned_pull("associate.exact"):
                assoc = associate_scene_exact(tensors, cfg, k_max=k_max, device=device,
                                              timings=timings)
        else:
            # the JAX package's shape bucket: the padded point count decides
            # the spacing sample, hence the coverage voxel size
            f_pad, n_pad = scene_pads(cfg, tensors.num_frames, n_real)
            tensors = pad_scene_tensors(tensors, f_pad, n_pad)
            record_shape_bucket("scene", k_max, f_pad, n_pad)
            sp.set(f_pad=f_pad, n_pad=n_pad)
            assoc = associate_scene_tensors(tensors, cfg, k_max=k_max, device=device)

    with _Stage(timings, "graph", device, scene=seq_name) as sp:
        # the one mid-program pull: M_pad depends on the valid-mask count
        faults.inject("pull", seq_name)
        with sanctioned_pull("mask_valid"):
            mask_valid_host = assoc.mask_valid.cpu().numpy()
        _count_pulls(timings, 1)
        sp.set(host_pull="mask_valid")
        table = build_mask_table(mask_valid_host, pad_multiple=cfg.mask_pad_multiple)
        sp.set(m_pad=table.m_pad)
        with sanctioned_pull("mask_table.upload"):
            frame = torch.from_numpy(table.frame).to(device)
            mask_id = torch.from_numpy(table.mask_id).to(device)
            valid = torch.from_numpy(table.valid).to(device)
        stats = compute_graph_stats(
            assoc.mask_of_point, assoc.boundary, frame, mask_id, valid,
            k_max=k_max,
            point_chunk=cfg.point_chunk,
            mask_visible_threshold=cfg.mask_visible_threshold,
            contained_threshold=cfg.contained_threshold,
            undersegment_filter_threshold=cfg.undersegment_filter_threshold,
            big_mask_point_count=cfg.big_mask_point_count,
            count_dtype=cfg.count_dtype,
        )
        schedule = observer_schedule_device(stats.observer_hist,
                                            max_len=cfg.max_cluster_iterations)

    with _Stage(timings, "cluster", device, scene=seq_name) as sp:
        active = valid & ~stats.undersegment
        with obs.span("cluster.solve", m_pad=int(stats.visible.shape[0]),
                      schedule_len=int(schedule.shape[0])):
            result = iterative_clustering(
                stats.visible, stats.contained, active, schedule,
                view_consensus_threshold=cfg.view_consensus_threshold,
                count_dtype=cfg.count_dtype,
            )
        _count_pulls(timings, 1)  # the schedule read that bounds the loop
        sp.set(host_pull="schedule")

    return DeviceHandoff(
        table=table, assignment=result.assignment, active=active,
        node_visible=result.node_visible, first_id=assoc.first_id,
        last_id=assoc.last_id, scene_points=np.asarray(tensors.scene_points),
        frame_ids=tensors.frame_ids, k_max=k_max, n_real=n_real, seq_name=seq_name,
        timings=timings)


def run_scene_host(handoff: DeviceHandoff, cfg: PipelineConfig, *,
                   export: bool = False, object_dict_dir: Optional[str] = None,
                   prediction_root: str = "data/prediction") -> SceneResult:
    """Host phase of one scene: post-process (device or host rung) + export.

    A ``PostprocessCapacityError`` of the device rung propagates: retrying
    on the host rung is the batch runner's decision, not this function's.
    """
    timings = dict(handoff.timings)
    faults.inject("host", handoff.seq_name)
    post_timings: Dict[str, float] = {}
    pulls = [0]
    with obs.scene_tracer().span("postprocess", scene=handoff.seq_name) as sp:
        # the plane lane reads the handoff before any post-process kernel
        # runs; its (8,) vector is pulled after, beside the assignment
        digest_dev = sentinel.digest_scene_device(handoff)
        objects = run_postprocess(
            cfg, handoff.scene_points, handoff.first_id, handoff.last_id,
            handoff.table.frame, handoff.table.mask_id, handoff.active, handoff.assignment,
            handoff.node_visible, handoff.frame_ids, k_max=handoff.k_max,
            timings=post_timings, n_real=handoff.n_real, pulls=pulls,
            seq_name=handoff.seq_name)
        with obs.span("post.assignment.pull", host_pull="assignment"):
            assignment = handoff.assignment.cpu().numpy()
        obs.count_transfer("d2h", assignment.nbytes, "post.drain")
        with obs.span("post.digest.pull", host_pull="digest"):
            digest_vec = sentinel.vector_host(digest_dev)
        obs.count_transfer("d2h", digest_vec.nbytes, "post.drain")
        # the digest vector is one pull on either rung; the host rung pulled
        # the assignment with the claim planes
        pulls[0] += 2 if cfg.device_postprocess else 1
        _count_pulls(timings, pulls[0])
    timings["postprocess"] = sp.duration
    for k, v in post_timings.items():
        # the post-process phases' walls become child spans of
        # "postprocess": same event schema, no double-timing
        obs.record_span(f"post.{k}", v, parent="postprocess")
        timings[f"post.{k}"] = v

    if export:
        if handoff.seq_name is None or object_dict_dir is None:
            raise ValueError("export=True requires seq_name and object_dict_dir")
        t1 = time.perf_counter()
        faults.inject("export", handoff.seq_name)
        export_artifacts(objects, handoff.seq_name, cfg.config_name, object_dict_dir,
                         prediction_root=prediction_root,
                         top_k_repre=cfg.num_representative_masks)
        timings["export"] = time.perf_counter() - t1

    # "corrupt" flips a bit of the pulled assignment and raises nothing, so
    # neither the retries nor the ladder heal it: only the digest sees it
    if faults.take_corruption("host", handoff.seq_name):
        assignment = assignment.copy()
        assignment[0] ^= 0x1
    digest = sentinel.compose_scene_digest(digest_vec, handoff, assignment, objects,
                                           count_dtype=cfg.count_dtype)
    log.info("scene %s: %d objects, timings %s", handoff.seq_name,
             len(objects.point_ids_list), {k: round(v, 3) for k, v in timings.items()})
    return SceneResult(objects=objects, table=handoff.table, assignment=assignment,
                       timings=timings, digest=digest)


def run_scene(tensors: SceneTensors, cfg: PipelineConfig, *, k_max: Optional[int] = None,
              seq_name: Optional[str] = None, export: bool = False,
              object_dict_dir: Optional[str] = None,
              prediction_root: str = "data/prediction",
              device: DeviceLike = None) -> SceneResult:
    """Cluster one scene; returns objects + artifacts (optionally written).

    ``device=None`` runs on CUDA and raises when no card is present; pass
    ``device="cpu"`` for the plain torch path.
    """
    handoff = run_scene_device(tensors, cfg, k_max=k_max, seq_name=seq_name, device=device)
    return run_scene_host(handoff, cfg, export=export, object_dict_dir=object_dict_dir,
                          prediction_root=prediction_root)
