"""Per-scene pipeline: association -> graph -> clustering -> post-process.

Counterpart of ``maskclustering_tpu/models/pipeline.py:59-404`` for the
configuration this port runs so far: the exact-parity association
(``use_exact_ball_query=True``) and the host post-process
(``device_postprocess=False``), single device, whole scenes. Any other
configuration raises ``NotImplementedError`` naming the ROADMAP item that
will port it; nothing is substituted silently.

Device traffic per scene: the association planes are built on the host and
uploaded once; ``mask_valid`` comes back once, to build the mask table (the
pipeline's one sanctioned mid-program pull); the 20-float schedule is read
once by the clustering loop; and the host post-process pulls ``first``,
``last``, ``node_visible``, ``active`` and ``assignment``, as the JAX host
rung does. The ball queries of the association return their neighbour
lists to the host, where the reference's per-mask logic runs. The pulls
are counted in ``timings``.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from maskclustering_tpu_torch.config import PipelineConfig
from maskclustering_tpu_torch.datasets.base import SceneTensors
from maskclustering_tpu_torch.device import DeviceLike, resolve_device, synchronize
from maskclustering_tpu_torch.models.clustering import iterative_clustering
from maskclustering_tpu_torch.models.exact_backprojection import associate_scene_exact
from maskclustering_tpu_torch.models.graph import (
    MaskTable,
    build_mask_table,
    compute_graph_stats,
    observer_schedule_device,
)
from maskclustering_tpu_torch.models.postprocess import (
    SceneObjects,
    export_artifacts,
    postprocess_scene,
)

log = logging.getLogger("maskclustering_tpu_torch")

K_MAX_CEILING = 1023


class SceneResult(NamedTuple):
    objects: SceneObjects
    table: MaskTable
    assignment: np.ndarray
    timings: Dict[str, float]


class DeviceHandoff(NamedTuple):
    """Everything the host phase needs from the device phase of one scene."""

    table: MaskTable
    assignment: torch.Tensor  # (M_pad,) int32
    active: torch.Tensor  # (M_pad,) bool — valid & not undersegmented
    node_visible: torch.Tensor  # (M_pad, F) bool
    first_id: torch.Tensor  # (F, N) int16
    last_id: torch.Tensor  # (F, N) int16
    scene_points: np.ndarray  # (N, 3) f32, host
    frame_ids: Sequence
    k_max: int
    seq_name: Optional[str]
    timings: Dict[str, float]  # associate/graph/cluster stage walls


def check_supported(cfg: PipelineConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration the port does not run yet."""
    if not cfg.use_exact_ball_query:
        raise NotImplementedError(
            "the dense projective association (use_exact_ball_query=False) is not "
            "ported yet: ROADMAP.md queue A, item A1")
    if cfg.device_postprocess:
        raise NotImplementedError(
            "the device post-process (device_postprocess=True) is not ported yet: "
            "ROADMAP.md queue A, item A2; set device_postprocess=False")
    if cfg.streaming_chunk > 0:
        raise NotImplementedError(
            "streaming (streaming_chunk > 0) is not ported yet: ROADMAP.md queue A, item A6")
    if cfg.mesh_shape:
        raise NotImplementedError(
            "multi-device meshes (mesh_shape) are not ported yet: ROADMAP.md queue A, item A7")


def max_seg_id(segmentations) -> int:
    """Largest mask id in a scene's id-maps (0 for an empty stack)."""
    return int(np.max(segmentations)) if np.size(segmentations) else 0


def bucket_k_max(max_id: int, minimum: int = 63, ceiling: int = K_MAX_CEILING) -> int:
    """Smallest (2^b - 1) >= max(max_id, minimum), clamped at ``ceiling``;
    ids above k_max are dropped as background."""
    k = minimum
    while k < max_id and k < ceiling:
        k = k * 2 + 1
    if max_id > k:
        log.warning("segmentation ids up to %d exceed k_max ceiling %d; "
                    "masks with larger ids are treated as background", max_id, k)
    return k


class _Stage:
    """Wall time of one stage, ending in a device synchronize."""

    def __init__(self, timings: Dict[str, float], name: str, device: torch.device):
        self.timings, self.name, self.device = timings, name, device

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        synchronize(self.device)
        self.timings[self.name] = time.perf_counter() - self.t0
        return False


def run_scene_device(tensors: SceneTensors, cfg: PipelineConfig, *,
                     k_max: Optional[int] = None, seq_name: Optional[str] = None,
                     device: DeviceLike = None) -> DeviceHandoff:
    """Device phase of one scene: associate -> graph -> cluster."""
    check_supported(cfg)
    device = resolve_device(device)
    timings: Dict[str, float] = {}
    if k_max is None:
        k_max = bucket_k_max(max_seg_id(tensors.segmentations))

    with _Stage(timings, "associate", device):
        assoc = associate_scene_exact(tensors, cfg, k_max=k_max, device=device,
                                      timings=timings)

    with _Stage(timings, "graph", device):
        # the one mid-program pull: M_pad depends on the valid-mask count
        mask_valid_host = assoc.mask_valid.cpu().numpy()
        timings["pulls"] = timings.get("pulls", 0) + 1
        table = build_mask_table(mask_valid_host, pad_multiple=cfg.mask_pad_multiple)
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

    with _Stage(timings, "cluster", device):
        active = valid & ~stats.undersegment
        result = iterative_clustering(
            stats.visible, stats.contained, active, schedule,
            view_consensus_threshold=cfg.view_consensus_threshold,
            count_dtype=cfg.count_dtype,
        )
        timings["pulls"] += 1  # the schedule read that bounds the loop

    return DeviceHandoff(
        table=table, assignment=result.assignment, active=active,
        node_visible=result.node_visible, first_id=assoc.first_id,
        last_id=assoc.last_id, scene_points=np.asarray(tensors.scene_points),
        frame_ids=tensors.frame_ids, k_max=k_max, seq_name=seq_name, timings=timings)


def run_scene_host(handoff: DeviceHandoff, cfg: PipelineConfig, *,
                   export: bool = False, object_dict_dir: Optional[str] = None,
                   prediction_root: str = "data/prediction") -> SceneResult:
    """Host phase of one scene: post-process (host rung) + artifact export."""
    timings = dict(handoff.timings)
    t0 = time.perf_counter()
    # the host rung pulls the claim planes, as postprocess_device.py:150-163
    first = handoff.first_id.cpu().numpy()
    last = handoff.last_id.cpu().numpy()
    node_visible = handoff.node_visible.cpu().numpy()
    active = handoff.active.cpu().numpy()
    assignment = handoff.assignment.cpu().numpy()
    timings["pulls"] = timings.get("pulls", 0) + 5
    timings["post.host_pull"] = time.perf_counter() - t0

    post_timings: Dict[str, float] = {}
    objects = postprocess_scene(
        handoff.scene_points, first, last, first > 0, handoff.table.frame,
        handoff.table.mask_id, active, assignment, node_visible, handoff.frame_ids,
        k_max=handoff.k_max,
        point_filter_threshold=cfg.point_filter_threshold,
        dbscan_eps=cfg.dbscan_split_eps,
        dbscan_min_points=cfg.dbscan_split_min_points,
        overlap_merge_ratio=cfg.overlap_merge_ratio,
        min_masks_per_object=cfg.min_masks_per_object,
        timings=post_timings,
    )
    timings["postprocess"] = time.perf_counter() - t0
    for k, v in post_timings.items():
        timings[f"post.{k}"] = v

    if export:
        if handoff.seq_name is None or object_dict_dir is None:
            raise ValueError("export=True requires seq_name and object_dict_dir")
        t1 = time.perf_counter()
        export_artifacts(objects, handoff.seq_name, cfg.config_name, object_dict_dir,
                         prediction_root=prediction_root,
                         top_k_repre=cfg.num_representative_masks)
        timings["export"] = time.perf_counter() - t1

    log.info("scene %s: %d objects, timings %s", handoff.seq_name,
             len(objects.point_ids_list), {k: round(v, 3) for k, v in timings.items()})
    return SceneResult(objects=objects, table=handoff.table, assignment=assignment,
                       timings=timings)


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
