"""Typed pipeline configuration (the port's own copy of the JAX config).

Same frozen dataclass, field for field, as ``maskclustering_tpu.config``:
a JAX ``PipelineConfig`` turned into a plain dict (``dataclasses.asdict``)
rebuilds here unchanged through :func:`from_jax_config`, so one config can
drive both packages. The port runs only some of these knobs; the pipeline
(``models/pipeline.py``) raises ``NotImplementedError`` for the rest.
Reads the repo's ``configs/*.json`` data files.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

_CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs")

# operand encodings of the counting contractions (ops/counting.py)
COUNT_DTYPES = ("bf16", "int8")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """All knobs for one pipeline run (reference configs/*.json semantics)."""

    # --- identity ---
    config_name: str = "demo"
    dataset: str = "demo"
    seq_name: Optional[str] = None

    # --- clustering thresholds ---
    mask_visible_threshold: float = 0.3
    undersegment_filter_threshold: float = 0.3
    view_consensus_threshold: float = 0.9
    contained_threshold: float = 0.8
    point_filter_threshold: float = 0.5
    step: int = 10

    # --- backprojection constants ---
    coverage_threshold: float = 0.3
    distance_threshold: float = 0.01
    few_points_threshold: int = 25
    depth_trunc: float = 20.0

    # --- post-processing ---
    dbscan_split_eps: float = 0.1
    dbscan_split_min_points: int = 4
    denoise_eps: float = 0.04
    denoise_min_points: int = 4
    overlap_merge_ratio: float = 0.8
    min_masks_per_object: int = 2
    num_representative_masks: int = 5
    big_mask_point_count: int = 500

    # --- device-program knobs ---
    backend: str = "tpu"
    association_window: int = 1
    association_frame_batch: int = 1
    count_dtype: str = "bf16"
    point_chunk: int = 8192
    mask_pad_multiple: int = 256
    frame_pad_multiple: int = 32
    max_cluster_iterations: int = 20
    use_exact_ball_query: bool = False
    device_postprocess: bool = True
    post_group_cap: int = 512
    post_neighbor_cap: int = 256
    mesh_shape: Tuple[int, ...] = ()
    point_shards: int = 1

    # --- streaming ---
    streaming_chunk: int = 0
    stream_recluster_every: int = 1
    stream_mask_headroom: float = 1.5
    stream_chunk_retries: int = 2
    stream_journal_every: int = 1

    # --- scene executor ---
    scene_overlap: bool = True
    prefetch_depth: int = 1
    donate_buffers: bool = True
    claims_pull_chunk: int = 64

    # --- fault tolerance and serving ---
    scene_retries: int = 2
    retry_backoff_s: float = 0.25
    watchdog_load_s: float = 0.0
    watchdog_device_s: float = 0.0
    watchdog_host_s: float = 0.0
    worker_heartbeat_s: float = 20.0
    worker_respawns: int = 2
    serve_batch_max: int = 1
    serve_batch_linger_s: float = 0.05
    serve_workers: int = 1
    serve_carve: str = ""
    serve_tenants: str = ""
    serve_journal_keep: int = 512
    serve_journal_max_age_s: float = 0.0
    serve_prune_interval_s: float = 300.0
    aot_cache_dir: str = ""

    # --- paths ---
    data_root: str = "./data"
    cropformer_path: str = ""
    debug: bool = False
    compilation_cache_dir: Optional[str] = None

    def __post_init__(self):
        for name in ("mask_visible_threshold", "view_consensus_threshold"):
            if not 0.0 <= getattr(self, name) <= 1.0:
                raise ValueError(f"{name} must be in [0,1], got {getattr(self, name)}")
        if self.step < 1:
            raise ValueError(f"step must be >= 1, got {self.step}")
        if self.distance_threshold <= 0:
            raise ValueError("distance_threshold must be positive")
        if self.backend not in ("tpu", "cpu", "gpu"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.count_dtype not in COUNT_DTYPES:
            raise ValueError(f"count_dtype must be one of {COUNT_DTYPES}, "
                             f"got {self.count_dtype!r}")
        if self.mesh_shape and len(self.mesh_shape) != 2:
            raise ValueError(f"mesh_shape must be (scene, frame), got {self.mesh_shape}")
        for name in ("association_frame_batch", "point_shards", "point_chunk",
                     "mask_pad_multiple", "max_cluster_iterations"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.streaming_chunk < 0:
            raise ValueError(f"streaming_chunk must be >= 0, got {self.streaming_chunk}")
        # the streaming refusals and their messages are the JAX config's
        if self.streaming_chunk > 0 and self.mesh_shape:
            raise ValueError(
                "streaming_chunk is a single-chip mode — the fused mesh "
                "path (mesh_shape) consumes whole scenes; unset one")
        if self.streaming_chunk > 0 and self.use_exact_ball_query:
            raise ValueError(
                "streaming_chunk cannot run the exact ball-query parity "
                "path (host-only, no chunk planes); unset one")
        if self.stream_recluster_every < 1:
            raise ValueError(
                f"stream_recluster_every must be >= 1, got {self.stream_recluster_every}")
        if self.stream_mask_headroom < 1.0:
            raise ValueError(
                f"stream_mask_headroom must be >= 1.0, got {self.stream_mask_headroom}")
        if self.stream_chunk_retries < 0:
            raise ValueError(
                f"stream_chunk_retries must be >= 0, got {self.stream_chunk_retries}")
        if self.stream_journal_every < 0:
            raise ValueError(
                f"stream_journal_every must be >= 0, got {self.stream_journal_every}")

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def _check_keys(raw: Dict[str, Any], where: str = "") -> None:
    unknown = set(raw) - {f.name for f in dataclasses.fields(PipelineConfig)}
    if unknown:
        raise ValueError(f"unknown config keys{where}: {sorted(unknown)}")


def _build(raw: Dict[str, Any]) -> PipelineConfig:
    _check_keys(raw)
    raw = dict(raw)
    if isinstance(raw.get("mesh_shape"), list):
        raw["mesh_shape"] = tuple(raw["mesh_shape"])
    return PipelineConfig(**raw)


def from_jax_config(d: Dict[str, Any]) -> PipelineConfig:
    """The port's config from ``dataclasses.asdict`` of a JAX ``PipelineConfig``.

    Field for field; an unknown key raises, as the JAX loader does.
    """
    return _build(d)


def load_config(name: str, config_dir: Optional[str] = None, **overrides) -> PipelineConfig:
    """Load ``configs/<name>.json`` relative to the repo (unknown keys raise)."""
    path = os.path.join(config_dir or _CONFIG_DIR, f"{name}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no config named {name!r}: {path} does not exist")
    with open(path) as f:
        raw = json.load(f)
    _check_keys(raw, f" in {path}")  # a typo in the file fails before overrides
    raw["config_name"] = name
    raw.update(overrides)
    return _build(raw)
