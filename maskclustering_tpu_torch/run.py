"""Batch driver (L6): scans on disk through the steps of a run.

Port of ``maskclustering_tpu/run.py:42-1345, 1361-1605``:

    python -m maskclustering_tpu_torch.run --config scannet \\
        --data_root DATA --seq_name_list a+b --encoder hash:1024

- **masks**: the 2D mask id-maps must exist for every scene (precomputed,
  or made by ``mask_command``); scenes without them are excluded.
- **cluster**: the scene queue. Each scene is loaded from disk
  (``datasets/``, PNG through the port's codec), clustered by
  ``models.pipeline`` (or, under ``--streaming-chunk``, streamed through
  ``models.streaming.stream_scene`` by the sequential loop, its state
  journal under ``<prediction_root>/<config>_stream_state``) and exported.
  Loads run ahead on daemon threads (``prefetch_depth``). A config with a
  ``mesh_shape`` runs batches of scenes through the fused multi-device step
  (``cluster_scenes_mesh``, ``parallel/``), and ``workers > 1`` spawns one
  process per round-robin shard of the scene list, worker ``i`` on card
  ``i % device_count``. Otherwise the overlapped executor
  (``scene_overlap``, the default) runs scene i's device phase on the main
  thread while scene i-1's host tail (post-process, export) runs on a
  worker thread; both issue their device work to the one current stream,
  so the artifacts are bit-equal to the sequential loop's whatever the
  interleaving. A ``SceneSupervisor`` retries failed scenes, drops a
  degradation-ladder rung after a round with device-class failures
  (overlapped -> sequential executor -> single device, with a mesh -> host
  post-process; a post-process capacity overflow heals on the last), and
  skips scenes a run journal records as done. ``--fault-plan`` scripts
  faults at the seams (``utils/faults.py``).
- **features**: per-mask features of every scene's representative masks
  (``semantics/features.py``), by the encoder of ``--encoder``: ``hash``
  or ``hash:<dim>`` (the JAX default, a deterministic stand-in), or
  ``hf:<checkpoint dir>`` (CLIP, ``semantics/clip.py``, on the run's
  device). The spec is checked before any scene runs; the checkpoint is
  loaded where the JAX driver loads it, after ``cluster`` and ``eval_ca``;
- **label_features**: the vocabulary's text features, cached on disk;
- **query**: the class-aware prediction of every scene
  (``semantics/query.py``);
- **eval_ca** / **eval**: ScanNet-protocol AP of the class-agnostic /
  class-labelled predictions (``evaluation/``).

- **vis**: instance-coloured scene clouds (``instances.ply``, ``rgb.ply``)
  of every clustered scene (``visualize/scene.py``);
- **top_images**: per object, its representative frames with a red box
  around the pixels its points hit, and a 3x3 grid of them
  (``visualize/top_images.py``): the z-buffered splat of the object into
  each frame launches the kernels of ``ops/cuda/splat.cu`` on the card.

The defaults are the JAX package's seven steps; ``TASMAP_STEPS`` is its
TASMap variant (masks, cluster, vis, top_images).
Everything runs on the CUDA card unless the caller passes ``device="cpu"``
(``--device cpu``); a mesh runs on every visible card unless the caller
passes ``mesh_devices`` (a list that may repeat a device). Exit codes: 0 ok, 1
a scene or step failed, 143 stopped by SIGTERM (the report and journal are
still written).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
import traceback
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from maskclustering_tpu_torch import obs
from maskclustering_tpu_torch.config import PipelineConfig, load_config
from maskclustering_tpu_torch.datasets import get_dataset
from maskclustering_tpu_torch.device import DeviceLike, resolve_device
from maskclustering_tpu_torch.models.pipeline import run_scene_device, run_scene_host
from maskclustering_tpu_torch.models.streaming import stream_scene
from maskclustering_tpu_torch.obs.digest import digest_coord
from maskclustering_tpu_torch.semantics import (
    HashEncoder,
    HFCLIPEncoder,
    extract_label_features,
    extract_mask_features,
    get_vocab,
    run_query,
    save_mask_features,
    vocab_name,
)
from maskclustering_tpu_torch.semantics.encoder import find_local_clip_checkpoint
from maskclustering_tpu_torch.utils import faults
from maskclustering_tpu_torch.utils.daemon_future import DaemonFuture

log = logging.getLogger("maskclustering_tpu_torch")

# the JAX package's steps (run.py:43-48)
DEFAULT_STEPS = ("masks", "cluster", "eval_ca", "features", "label_features",
                 "query", "eval")
# the TASMap/demo variant: no evaluation or CLIP, plus the visualisation
TASMAP_STEPS = ("masks", "cluster", "vis", "top_images")
ALL_STEPS = DEFAULT_STEPS + ("vis", "top_images")

# dataset -> (gt dir, split file) under data_root (run.py:50-59)
_DATASET_LAYOUT = {
    "scannet": ("scannet/gt", "scannet.txt"),
    "scannetpp": ("scannetpp/gt", "scannetpp.txt"),
    "matterport3d": ("matterport3d/gt", "matterport3d.txt"),
    "tasmap": ("tasmap/gt", "tasmap.txt"),
    "demo": ("demo/gt", "demo.txt"),
}


@dataclasses.dataclass
class SceneStatus:
    seq_name: str
    status: str  # "ok" | "skipped" | "failed" | "interrupted"
    seconds: float = 0.0
    error: str = ""
    num_objects: int = -1
    # per-stage wall seconds (associate/graph/cluster/postprocess + post.*)
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)
    # fault attribution: attempts this process made (0 = never ran: a
    # journal skip or interrupted before dispatch), the ladder rung it last
    # ran at, and the error class of its last failure ("" = never failed)
    attempts: int = 1
    degradation_rung: int = 0
    error_class: str = ""
    # the scene's invariant digest (obs/digest.py) and the coordinate it
    # was observed at, ``<bucket>|<count_dtype>|<mesh>|r<rung>|c<chunk>``
    digest: Optional[Dict] = None
    digest_coord: str = ""


@dataclasses.dataclass
class RunReport:
    config_name: str
    step_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    scenes: List[SceneStatus] = dataclasses.field(default_factory=list)
    step_errors: Dict[str, str] = dataclasses.field(default_factory=dict)
    # the local CLIP checkpoint directory found on disk, or None
    clip_checkpoint: Optional[str] = None
    # AP summaries of the evaluation steps ({"eval_ca": avgs, "eval": ...};
    # None where a step found no predictions)
    evaluation: Dict[str, Optional[Dict]] = dataclasses.field(default_factory=dict)
    # the obs digest (obs/report.RunData.summary) of an obs-armed run
    obs: Optional[Dict] = None
    # the cluster step's fault digest: scene_retries, device_stalls,
    # journal_skips, degradations{rung: 1}, final_rung, interrupted
    faults: Optional[Dict] = None

    @property
    def failed(self) -> List[SceneStatus]:
        return [s for s in self.scenes if s.status == "failed"]

    @property
    def interrupted(self) -> List[SceneStatus]:
        return [s for s in self.scenes if s.status == "interrupted"]

    @property
    def ok(self) -> bool:
        return not self.failed and not self.step_errors and not self.interrupted

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({
                "config_name": self.config_name,
                "step_seconds": self.step_seconds,
                "scenes": [dataclasses.asdict(s) for s in self.scenes],
                "step_errors": self.step_errors,
                "clip_checkpoint": self.clip_checkpoint,
                "evaluation": self.evaluation,
                "obs": self.obs,
                "faults": self.faults,
            }, f, indent=2)


def get_seq_name_list(dataset: str, splits_dir: str = "splits",
                      seq_name_list: Optional[str] = None) -> List[str]:
    """Scene list from an explicit +-joined string or the split file."""
    if seq_name_list:
        return [s for s in seq_name_list.split("+") if s]
    _, split_file = _DATASET_LAYOUT[dataset]
    path = os.path.join(splits_dir, split_file)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no split file {path}; pass seq_name_list explicitly")
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def parse_encoder_spec(spec: str) -> Tuple[str, str]:
    """(kind, argument) of an encoder spec, by the JAX factory's rules:
    ``hash[:dim]`` or ``hf:<path>``. Raises ``ValueError`` for anything else,
    or a dimension that is not an integer."""
    if spec.startswith("hash"):
        _, _, dim = spec.partition(":")
        if dim:
            int(dim)
        return "hash", dim
    if spec.startswith("hf:"):
        return "hf", spec[3:]
    raise ValueError(f"unknown encoder spec {spec!r} (use hash[:dim] or hf:<path>)")


def make_encoder(spec: str, device: DeviceLike = None):
    """Encoder factory (``run.py:148-157``): ``hash[:dim]`` | ``hf:<local
    path>``, the CLIP encoder with its weights on ``device``."""
    kind, arg = parse_encoder_spec(spec)
    if kind == "hash":
        return HashEncoder(int(arg) if arg else 64)
    return HFCLIPEncoder(arg, device=device)


def check_steps(steps: Sequence[str], encoder_spec: str = "hash") -> None:
    """Raise ``ValueError``, before any scene runs, for an unknown step or a
    malformed encoder spec. The encoder itself is built by the step that
    uses it."""
    unknown = set(steps) - set(ALL_STEPS)
    if unknown:
        raise ValueError(f"unknown steps {sorted(unknown)}; valid: {ALL_STEPS}")
    if {"features", "label_features"} & set(steps):
        parse_encoder_spec(encoder_spec)


# ---------------------------------------------------------------------------
# step 1: masks
# ---------------------------------------------------------------------------


def check_masks(cfg: PipelineConfig, seq_names: Sequence[str],
                mask_command: Optional[str] = None,
                mask_predictor=None,
                predictor_spec: Optional[str] = None,
                device: DeviceLike = None) -> List[str]:
    """Step 1: ensure 2D mask id-maps exist for every scene (``run.py:165-224``).

    The contract is a PNG id-map per frame under ``<scene>/output/mask``.
    Scenes with missing masks are filled by ``mask_predictor`` (a
    ``mask_prediction.MaskPredictor`` run in process) or ``mask_command``
    (a template with ``{seq_name}``, one subprocess a scene); returns the
    scenes still missing. ``predictor_spec`` (``cfg.cropformer_path``) is
    built into a predictor on ``device`` lazily, only once some scene
    misses masks; a spec that cannot be built is logged, not raised, and
    a scene whose prediction fails stays missing for ``mask_command``.
    """
    missing = []
    for seq in seq_names:
        seg_dir = get_dataset(cfg.dataset, seq, data_root=cfg.data_root).segmentation_dir
        if not (os.path.isdir(seg_dir) and os.listdir(seg_dir)):
            missing.append(seq)
    if missing and mask_predictor is None and predictor_spec:
        from maskclustering_tpu_torch.mask_prediction import predictor_from_spec

        try:
            mask_predictor = predictor_from_spec(predictor_spec, device=device)
        except Exception:  # noqa: BLE001 — a bad spec must not abort the step
            log.exception("could not build mask predictor from spec %r", predictor_spec)
    if missing and mask_predictor is not None:
        from maskclustering_tpu_torch.mask_prediction import predict_scene_masks

        for seq in missing:
            try:
                ds = get_dataset(cfg.dataset, seq, data_root=cfg.data_root)
                log.info("predicting masks for %s", seq)
                predict_scene_masks(ds, mask_predictor, stride=cfg.step)
            except Exception:  # noqa: BLE001 — one corrupt scene must not abort the step
                log.exception("mask prediction failed for %s", seq)
        # mask_command stays the fallback for scenes the predictor could not fill
        return check_masks(cfg, missing, mask_command=mask_command)
    if missing and mask_command:
        for seq in missing:
            cmd = mask_command.format(seq_name=seq)
            log.info("running mask predictor: %s", cmd)
            if os.system(cmd) != 0:
                log.error("mask predictor failed for %s", seq)
        return check_masks(cfg, missing)
    return missing


# ---------------------------------------------------------------------------
# step 2: cluster
# ---------------------------------------------------------------------------


def _load_for_cluster(cfg: PipelineConfig, seq_name: str, resume: bool,
                      prediction_root: str):
    """(dataset, tensors): the host-IO half of one scene; tensors None = skip."""
    faults.inject("load", seq_name)
    ds = get_dataset(cfg.dataset, seq_name, data_root=cfg.data_root)
    npz_path = os.path.join(prediction_root, cfg.config_name + "_class_agnostic",
                            f"{seq_name}.npz")
    if resume and os.path.exists(npz_path):
        return ds, None
    return ds, ds.load_scene_tensors(cfg.step)


class _FaultCtx:
    """Per-round fault bookkeeping shared by the executors: attempt numbers
    across rounds, each SceneStatus stamped with its attempts / rung, and
    attempt + outcome journal rows written as they happen."""

    def __init__(self, journal: Optional[faults.RunJournal] = None,
                 rung: int = 0, attempts: Optional[Dict[str, int]] = None):
        self.journal = journal
        self.rung = rung
        self.attempts = attempts if attempts is not None else {}

    def begin(self, seq: str) -> None:
        self.attempts[seq] = self.attempts.get(seq, 0) + 1
        if self.journal is not None:
            self.journal.attempt(seq, self.attempts[seq], self.rung)

    def finish(self, st: SceneStatus) -> SceneStatus:
        st.attempts = self.attempts.get(st.seq_name, 0)
        st.degradation_rung = self.rung
        if self.journal is not None:
            self.journal.outcome(
                st.seq_name, st.status, attempt=st.attempts, rung=st.degradation_rung,
                error_class=st.error_class, error=st.error,
                seconds=st.seconds, num_objects=st.num_objects)
        return st


def _ok_status(seq: str, seconds: float, result) -> SceneStatus:
    return SceneStatus(seq, "ok", seconds, num_objects=len(result.objects.point_ids_list),
                       timings={k: round(v, 4) for k, v in result.timings.items()},
                       digest=result.digest)


def _stamp_coord(st: SceneStatus, cfg: PipelineConfig) -> SceneStatus:
    """Stamp the digest's coordinate on a rung-attributed SceneStatus
    (``run.py:272-285``): one device, the rung it ran at, the chunk (0 = batch)."""
    st.digest_coord = digest_coord(st.digest, mesh="single", rung=st.degradation_rung,
                                   chunk=cfg.streaming_chunk)
    return st


def _failed_status(seq: str, seconds: float, exc: BaseException) -> SceneStatus:
    return SceneStatus(seq, "failed", seconds, error=traceback.format_exc(limit=20),
                       error_class=faults.classify_error(exc))


def cluster_scene(cfg: PipelineConfig, seq_name: str, *, resume: bool = True,
                  prediction_root: Optional[str] = None, device: DeviceLike = None,
                  _preloaded=None, _ctx: Optional[_FaultCtx] = None) -> SceneStatus:
    """Step 2 for one scene: load -> device phase -> host phase -> export.

    ``_preloaded``: zero-arg callable returning ``(dataset, tensors)`` (the
    prefetcher's resolve), so a prefetched scene's load error re-raises
    here and is that scene's failure. Each phase runs under its watchdog
    budget (``cfg.watchdog_*_s``; 0 = inline).
    """
    prediction_root = prediction_root or os.path.join(cfg.data_root, "prediction")
    ctx = _ctx if _ctx is not None else _FaultCtx()
    t0 = time.perf_counter()
    ctx.begin(seq_name)
    try:
        loader = (_preloaded if _preloaded is not None
                  else lambda: _load_for_cluster(cfg, seq_name, resume, prediction_root))
        ds, tensors = faults.call_with_deadline(loader, cfg.watchdog_load_s, seam="load",
                                                scene=seq_name)
        if tensors is None:
            obs.count("run.scenes_skipped")
            return ctx.finish(SceneStatus(seq_name, "skipped"))
        if faults.stop_requested():
            return ctx.finish(SceneStatus(seq_name, "interrupted"))
        if cfg.streaming_chunk > 0:
            # chunk retries and the per-chunk watchdog run inside the stream;
            # its state journal resumes a killed process mid-scene
            result = stream_scene(
                tensors, cfg, seq_name=seq_name, export=True,
                object_dict_dir=ds.object_dict_dir, prediction_root=prediction_root,
                state_dir=os.path.join(prediction_root, cfg.config_name + "_stream_state"),
                resume=resume, device=device)
        else:
            handoff = faults.call_with_deadline(
                lambda: run_scene_device(tensors, cfg, seq_name=seq_name, device=device),
                cfg.watchdog_device_s, seam="device", scene=seq_name)
            result = faults.call_with_deadline(
                lambda: run_scene_host(handoff, cfg, export=True,
                                       object_dict_dir=ds.object_dict_dir,
                                       prediction_root=prediction_root),
                cfg.watchdog_host_s, seam="host", scene=seq_name)
        obs.count("run.scenes_ok")
        return _stamp_coord(ctx.finish(_ok_status(seq_name, time.perf_counter() - t0, result)),
                            cfg)
    except Exception as e:
        log.exception("scene %s failed", seq_name)
        obs.count("run.scenes_failed")
        return ctx.finish(_failed_status(seq_name, time.perf_counter() - t0, e))


def _prefetched_loads(cfg: PipelineConfig, seq_names: Sequence[str], resume: bool,
                      prediction_root: str, depth: int = 1):
    """Yield (seq_name, resolve) with a ``depth``-scene disk-prefetch lookahead
    (``run.py:383-412``).

    Daemon threads load scenes i+1..i+depth while scene i runs; ``depth ==
    0`` loads inline. Scenes yield in list order, and a failed load
    re-raises at its own scene's ``resolve()``.
    """
    def load(seq):
        with obs.span("exec.load", scene=seq):
            return _load_for_cluster(cfg, seq, resume, prediction_root)

    def spawn(seq):
        return DaemonFuture(lambda: load(seq), name=f"prefetch-{seq}").result

    if depth <= 0:
        for seq in seq_names:
            yield seq, (lambda seq=seq: load(seq))
        return
    pending = deque(spawn(seq_names[i]) for i in range(min(depth, len(seq_names))))
    for i, seq in enumerate(seq_names):
        if i + depth < len(seq_names):
            pending.append(spawn(seq_names[i + depth]))
        yield seq, pending.popleft()


def _cluster_scenes_sequential(cfg: PipelineConfig, seq_names: Sequence[str], *,
                               resume: bool, prediction_root: str, device,
                               ctx: _FaultCtx) -> List[SceneStatus]:
    """The serialised scene loop (disk prefetch is its only overlap): the
    ``scene_overlap=False`` path and the order the overlapped executor is
    held to."""
    out: List[SceneStatus] = []
    with obs.span("exec.scene_loop", scenes=len(seq_names), mode="sequential"):
        for seq, resolve in _prefetched_loads(cfg, seq_names, resume, prediction_root,
                                              depth=cfg.prefetch_depth):
            if faults.stop_requested():
                out.append(ctx.finish(SceneStatus(seq, "interrupted")))
                continue
            out.append(cluster_scene(cfg, seq, resume=resume, prediction_root=prediction_root,
                                     device=device, _preloaded=resolve, _ctx=ctx))
    return out


def _cluster_scenes_overlapped(cfg: PipelineConfig, seq_names: Sequence[str], *,
                               resume: bool, prediction_root: str, device,
                               ctx: _FaultCtx) -> List[SceneStatus]:
    """Step 2, software-pipelined (``run.py:437-556``): three timelines.

    - **load** (daemon threads): disk IO of scenes i+1..i+depth;
    - **device** (this thread): upload + associate/graph/cluster of scene i
      (``run_scene_device``);
    - **host tail** (one worker thread): scene i-1's post-process and
      export (``run_scene_host``).

    At most one tail is in flight, so at most two scenes' claim tensors
    coexist on the device. Both threads enqueue on the device's current
    stream, so the tail's kernels read the handoff after the kernels that
    wrote it and the artifacts equal the sequential loop's. A scene's
    ``seconds`` run from its device phase to the end of its tail; its stage
    walls each end in a device synchronize, which also waits for the other
    thread's queued kernels.
    """
    statuses: Dict[str, SceneStatus] = {}
    in_flight = None  # (seq_name, t0, DaemonFuture of the host tail)

    def finish(entry) -> None:
        # the tail's outcome and end time were taken inside the worker: this
        # join may come a whole device phase later, which is not the scene's
        seq, t0, fut = entry
        try:
            result, err, t_end = fut.result(
                cfg.watchdog_host_s if cfg.watchdog_host_s > 0 else None)
        except TimeoutError:
            fut.abandon()
            stall = faults.DeviceStallError("host", seq, cfg.watchdog_host_s)
            obs.count("run.device_stalls")
            obs.count("run.scenes_failed")
            log.error("scene %s failed: %s", seq, stall)
            statuses[seq] = ctx.finish(SceneStatus(
                seq, "failed", time.perf_counter() - t0, error=str(stall),
                error_class="device"))
            return
        if err is not None:
            log.error("scene %s failed\n%s", seq, err.error)
            obs.count("run.scenes_failed")
            err.seconds = t_end - t0
            statuses[seq] = ctx.finish(err)
            return
        obs.count("run.scenes_ok")
        statuses[seq] = _stamp_coord(ctx.finish(_ok_status(seq, t_end - t0, result)), cfg)

    with obs.span("exec.scene_loop", scenes=len(seq_names), mode="overlapped"):
        for seq, resolve in _prefetched_loads(cfg, seq_names, resume, prediction_root,
                                              depth=cfg.prefetch_depth):
            if faults.stop_requested():
                statuses[seq] = ctx.finish(SceneStatus(seq, "interrupted"))
                continue
            t0 = time.perf_counter()
            ctx.begin(seq)
            try:
                ds, tensors = faults.call_with_deadline(resolve, cfg.watchdog_load_s,
                                                        seam="load", scene=seq)
                if tensors is None:
                    obs.count("run.scenes_skipped")
                    statuses[seq] = ctx.finish(SceneStatus(seq, "skipped"))
                    continue
                if faults.stop_requested():
                    statuses[seq] = ctx.finish(SceneStatus(seq, "interrupted"))
                    continue
                with obs.span("exec.device", scene=seq):
                    handoff = faults.call_with_deadline(
                        lambda: run_scene_device(tensors, cfg, seq_name=seq, device=device),
                        cfg.watchdog_device_s, seam="device", scene=seq)
            except Exception as e:
                log.exception("scene %s failed", seq)
                obs.count("run.scenes_failed")
                statuses[seq] = ctx.finish(_failed_status(seq, time.perf_counter() - t0, e))
                continue
            # backpressure: the previous tail retires before another handoff
            # goes live, bounding the device memory to two scenes
            if in_flight is not None:
                finish(in_flight)

            def host_tail(handoff=handoff, seq=seq, ds=ds):
                try:
                    with obs.span("exec.host_tail", scene=seq):
                        result = run_scene_host(handoff, cfg, export=True,
                                                object_dict_dir=ds.object_dict_dir,
                                                prediction_root=prediction_root)
                    return result, None, time.perf_counter()
                except Exception as e:  # noqa: BLE001 — attributed in finish()
                    return None, _failed_status(seq, 0.0, e), time.perf_counter()

            in_flight = (seq, t0, DaemonFuture(host_tail, name=f"host-tail-{seq}"))
        if in_flight is not None:
            finish(in_flight)
    return [statuses[s] for s in seq_names if s in statuses]


def _cluster_worker(payload) -> List[SceneStatus]:
    """One spawned process's shard of the scene list (``run.py:559-567``)."""
    cfg, seq_names, resume, prediction_root, device = payload
    return [cluster_scene(cfg, s, resume=resume, prediction_root=prediction_root,
                          device=device) for s in seq_names]


def cluster_scenes_mesh(cfg: PipelineConfig, seq_names: Sequence[str], *, resume: bool = True,
                        prediction_root: Optional[str] = None,
                        ctx: Optional[_FaultCtx] = None,
                        mesh_devices: Optional[Sequence] = None) -> List[SceneStatus]:
    """Step 2 over a device mesh (``run.py:570-680``): fused batches ->
    per-scene artifacts.

    Scenes stream through the mesh in batches of the ``scene`` axis size
    (loads prefetched); each batch runs the fused step
    (``parallel.cluster_scene_batch``), then export writes the artifacts
    the single-device path writes. A failed export fails its scene only; a
    batch that fails, or stalls past ``cfg.watchdog_device_s``
    (``DeviceStallError``, device-class), fails the whole batch, which the
    supervisor retries down the ladder to the ``single-chip`` rung. The
    statuses carry the artifact-only digest (the fused path builds no
    ``DeviceHandoff``) at the coordinate ``fused|<count_dtype>|<SxF>|r|c0``.
    """
    from maskclustering_tpu_torch.models.postprocess import export_artifacts
    from maskclustering_tpu_torch.obs import digest as sentinel
    from maskclustering_tpu_torch.parallel.batch import cluster_scene_batch, make_run_mesh
    from maskclustering_tpu_torch.parallel.mesh import mesh_label

    prediction_root = prediction_root or os.path.join(cfg.data_root, "prediction")
    mesh = make_run_mesh(cfg, mesh_devices)
    s_axis = int(mesh.shape["scene"])
    ctx = ctx if ctx is not None else _FaultCtx()
    statuses: Dict[str, SceneStatus] = {}
    pending: List[tuple] = []  # (seq, dataset, tensors)

    def flush():
        if not pending:
            return
        batch, pending[:] = list(pending), []
        t0 = time.perf_counter()

        def dispatch_batch():
            # the injection runs inside the guarded call, so a scripted stall
            # surfaces as DeviceStallError through the watchdog
            for seq, _, _ in batch:
                faults.inject("device", seq)
            return cluster_scene_batch(cfg, mesh, [b[2] for b in batch],
                                       seq_names=[b[0] for b in batch])

        try:
            objects_list = faults.call_with_deadline(
                dispatch_batch, cfg.watchdog_device_s, seam="device",
                scene=",".join(b[0] for b in batch))
        except Exception as e:
            log.exception("mesh batch %s failed", [b[0] for b in batch])
            obs.count("run.scenes_failed", len(batch))
            for seq, _, _ in batch:
                statuses[seq] = ctx.finish(_failed_status(seq, time.perf_counter() - t0, e))
            return
        per_scene = (time.perf_counter() - t0) / len(batch)
        for (seq, ds, _), objects in zip(batch, objects_list):
            try:
                faults.inject("export", seq)
                export_artifacts(objects, seq, cfg.config_name, ds.object_dict_dir,
                                 prediction_root=prediction_root,
                                 top_k_repre=cfg.num_representative_masks)
            except Exception as e:
                log.exception("scene %s export failed", seq)
                obs.count("run.scenes_failed")
                statuses[seq] = ctx.finish(_failed_status(seq, per_scene, e))
                continue
            obs.count("run.scenes_ok")
            st = ctx.finish(SceneStatus(seq, "ok", per_scene,
                                        num_objects=len(objects.point_ids_list)))
            st.digest = sentinel.artifact_only_digest(objects, bucket="fused",
                                                      count_dtype=cfg.count_dtype)
            st.digest_coord = digest_coord(st.digest, mesh=mesh_label(cfg.mesh_shape),
                                           rung=st.degradation_rung, chunk=0)
            statuses[seq] = st

    # the next scenes' disk loads overlap the current batch's device work
    for seq, resolve in _prefetched_loads(cfg, seq_names, resume, prediction_root,
                                          depth=cfg.prefetch_depth):
        if faults.stop_requested():
            statuses[seq] = ctx.finish(SceneStatus(seq, "interrupted"))
            continue
        ctx.begin(seq)
        try:
            ds, tensors = faults.call_with_deadline(resolve, cfg.watchdog_load_s, seam="load",
                                                    scene=seq)
        except Exception as e:
            log.exception("scene %s failed to load", seq)
            statuses[seq] = ctx.finish(_failed_status(seq, 0.0, e))
            continue
        if tensors is None:
            statuses[seq] = ctx.finish(SceneStatus(seq, "skipped"))
            continue
        pending.append((seq, ds, tensors))
        if len(pending) == s_axis:
            flush()
    flush()
    return [statuses[s] for s in seq_names if s in statuses]


def _worker_device(device: torch.device, i: int) -> str:
    """Worker ``i``'s device: card ``i % device_count`` on CUDA (so on one
    card every worker shares it), else the run's device."""
    if device.type == "cuda":
        return f"cuda:{i % torch.cuda.device_count()}"
    return str(device)


def _dispatch_scenes(cfg: PipelineConfig, seq_names: Sequence[str], *, workers: int,
                     resume: bool, prediction_root: str, device, ctx: _FaultCtx,
                     mesh_devices: Optional[Sequence] = None) -> List[SceneStatus]:
    """One executor pass over ``seq_names`` at the current ladder rung
    (``run.py:683-726``): a ``cfg.mesh_shape`` routes through the fused mesh
    path; else ``workers <= 1`` runs in this process, overlapped when
    ``cfg.scene_overlap`` and more than one scene, else sequential
    (streaming scenes pipeline inside the scene, sequentially); and
    ``workers > 1`` spawns processes over round-robin scene shards."""
    if cfg.mesh_shape:
        return cluster_scenes_mesh(cfg, seq_names, resume=resume,
                                   prediction_root=prediction_root, ctx=ctx,
                                   mesh_devices=mesh_devices)
    if workers <= 1:
        run = (_cluster_scenes_overlapped
               if cfg.scene_overlap and len(seq_names) > 1 and cfg.streaming_chunk <= 0
               else _cluster_scenes_sequential)
        return run(cfg, seq_names, resume=resume, prediction_root=prediction_root,
                   device=device, ctx=ctx)
    import multiprocessing as mp

    shards = [list(seq_names[i::workers]) for i in range(workers)]
    payloads = [(cfg, shard, resume, prediction_root, _worker_device(device, i))
                for i, shard in enumerate(shards) if shard]
    # spawn: this process may already hold a CUDA context, which fork breaks
    with mp.get_context("spawn").Pool(len(payloads)) as pool:
        out = pool.map(_cluster_worker, payloads)
    order = {name: i for i, name in enumerate(seq_names)}
    statuses = sorted((st for chunk in out for st in chunk), key=lambda st: order[st.seq_name])
    for st in statuses:
        # the children keep no journal or attempt state: this process stamps
        # and journals their outcomes after the fact
        ctx.begin(st.seq_name)
        ctx.finish(st)
    return statuses


class SceneSupervisor:
    """The fault-supervised scene queue (``run.py:728-891``).

    Each executor pass captures per-scene failures; the supervisor then

    - **retries** failed scenes whose error class is not terminal, up to
      ``cfg.scene_retries`` extra rounds with exponential backoff
      (``cfg.retry_backoff_s``); device-class failures keep retrying while
      the ladder still has a rung to drop, so a deterministic device fault
      (a post-process capacity overflow) reaches the rung that heals it
      even at the default retry budget;
    - **degrades** one ladder rung before each round that follows a
      device-class failure;
    - **journal-skips** scenes the journal records as done;
    - stops retrying once a SIGTERM requested stop.

    Two callers share these semantics: the batch cluster step (one
    supervisor per run) and the serving worker (``serve/worker.py``, one
    supervisor PER REQUEST, so a sick request's ladder drop cannot poison
    its neighbours). ``on_event`` observes decisions without changing them:
    ``on_event("retry", scenes=[...], round=n, delay_s=d, rung=r)`` before
    each retry round and ``on_event("degrade", rung=name, rung_index=i)`` on
    each ladder drop. ``should_continue`` is polled beside
    ``stop_requested()`` before a failed scene may retry (the worker wires
    the request's deadline here). ``initial_rungs`` starts the ladder that
    many rungs down (a request that crashed its worker re-runs
    pre-degraded).
    """

    def __init__(self, cfg: PipelineConfig, *, workers: int = 1, resume: bool = True,
                 journal: Optional[faults.RunJournal] = None,
                 on_event: Optional[Callable] = None,
                 should_continue: Optional[Callable[[], bool]] = None,
                 initial_rungs: int = 0,
                 prediction_root: Optional[str] = None, device: DeviceLike = None,
                 mesh_devices: Optional[Sequence] = None):
        self.cfg = cfg
        self.workers = workers
        self.mesh_devices = mesh_devices
        self.resume = resume
        self.journal = journal
        self.on_event = on_event
        self.should_continue = should_continue
        self.prediction_root = prediction_root or os.path.join(cfg.data_root, "prediction")
        self.device = resolve_device(device)
        self.ladder = faults.DegradationLadder(cfg)
        self.stats = {"scene_retries": 0, "device_stalls": 0, "journal_skips": 0}
        for _ in range(max(int(initial_rungs), 0)):
            if self.ladder.degrade(reason="worker crash carry-over") is None:
                break

    def _notify(self, kind: str, **info) -> None:
        if self.on_event is None:
            return
        try:
            self.on_event(kind, **info)
        except Exception:  # noqa: BLE001 — an observer must not sink the queue
            log.exception("scene supervisor on_event(%r) observer failed", kind)

    def _may_retry(self) -> bool:
        if faults.stop_requested():
            return False
        return self.should_continue is None or bool(self.should_continue())

    def run(self, seq_names: Sequence[str]) -> List[SceneStatus]:
        cfg, ladder, journal = self.cfg, self.ladder, self.journal
        policy = faults.RetryPolicy(base_s=cfg.retry_backoff_s,
                                    cap_s=max(cfg.retry_backoff_s * 8.0, 0.0))
        statuses: Dict[str, SceneStatus] = {}
        attempts: Dict[str, int] = {}
        pending = list(seq_names)
        if journal is not None and self.resume:
            done = journal.resume_done()
            for seq in pending:
                if seq in done:
                    obs.count("run.journal_skips")
                    statuses[seq] = SceneStatus(seq, "skipped", attempts=0)
                    journal.outcome(seq, "skipped", attempt=0, rung=0)
                    self.stats["journal_skips"] += 1
            pending = [s for s in pending if s not in done]
        round_no = 1
        while pending:
            ctx = _FaultCtx(journal=journal, rung=ladder.rung, attempts=attempts)
            batch = _dispatch_scenes(ladder.apply(cfg), pending, workers=self.workers,
                                     resume=self.resume, prediction_root=self.prediction_root,
                                     device=self.device, ctx=ctx,
                                     mesh_devices=self.mesh_devices)
            retry: List[str] = []
            saw_device = False
            for st in batch:
                statuses[st.seq_name] = st
                if st.status != "failed":
                    continue
                self.stats["device_stalls"] += "DeviceStallError" in st.error
                saw_device = saw_device or st.error_class == "device"
                in_budget = round_no <= cfg.scene_retries
                ladder_can_help = st.error_class == "device" and not ladder.exhausted
                if (st.error_class != "terminal" and (in_budget or ladder_can_help)
                        and self._may_retry()):
                    retry.append(st.seq_name)
            if not retry:
                break
            if saw_device:
                rung_name = ladder.degrade(reason=f"device-class failure(s) in round {round_no}")
                if rung_name:
                    self._notify("degrade", rung=rung_name, rung_index=ladder.rung)
            delay = policy.backoff(round_no)
            self.stats["scene_retries"] += len(retry)
            obs.count("run.scene_retries", len(retry))
            self._notify("retry", scenes=list(retry), round=round_no + 1, delay_s=delay,
                         rung=ladder.rung)
            log.warning("retrying %d scene(s) in %.2fs (round %d, rung %d%s)",
                        len(retry), delay, round_no + 1, ladder.rung,
                        f": {'+'.join(ladder.applied_names)}" if ladder.applied_names else "")
            if delay > 0:
                time.sleep(delay)
            pending = retry
            round_no += 1
        return [statuses[s] for s in seq_names if s in statuses]

    def fault_summary(self, scenes: Sequence[SceneStatus]) -> Dict:
        """The run report's fault digest."""
        return {**self.stats,
                "degradations": {name: 1 for name in self.ladder.applied_names},
                "final_rung": self.ladder.rung,
                "interrupted": (faults.stop_requested()
                                or any(s.status == "interrupted" for s in scenes))}


def cluster_scenes(cfg: PipelineConfig, seq_names: Sequence[str], *, workers: int = 1,
                   resume: bool = True, journal: Optional[faults.RunJournal] = None,
                   prediction_root: Optional[str] = None, device: DeviceLike = None,
                   mesh_devices: Optional[Sequence] = None) -> List[SceneStatus]:
    """Step 2: one SceneSupervisor pass over the run's scene list."""
    return SceneSupervisor(cfg, workers=workers, resume=resume, journal=journal,
                           prediction_root=prediction_root, device=device,
                           mesh_devices=mesh_devices).run(seq_names)


# ---------------------------------------------------------------------------
# steps 3 and 7: evaluation
# ---------------------------------------------------------------------------


def evaluate_step(cfg: PipelineConfig, *, no_class: bool,
                  seq_names: Optional[Sequence[str]] = None,
                  prediction_root: Optional[str] = None,
                  device: DeviceLike = None) -> Optional[dict]:
    """AP evaluation over the run's scenes (``run.py:940-978``); restricted
    to ``seq_names`` when given so stale predictions cannot skew the AP.
    A prediction without its GT file raises."""
    from maskclustering_tpu_torch.evaluation.ap import evaluate_scans

    prediction_root = prediction_root or os.path.join(cfg.data_root, "prediction")
    suffix = "_class_agnostic" if no_class else ""
    pred_dir = os.path.join(prediction_root, cfg.config_name + suffix)
    gt_dir = os.path.join(cfg.data_root, _DATASET_LAYOUT[cfg.dataset][0])
    if not os.path.isdir(pred_dir):
        log.warning("no predictions at %s; skipping evaluation", pred_dir)
        return None
    names = sorted(f for f in os.listdir(pred_dir) if f.endswith(".npz"))
    if seq_names is not None:
        wanted = set(seq_names)
        names = [n for n in names if n[:-len(".npz")] in wanted]
    if not names:
        log.warning("no predictions for this run's scenes in %s", pred_dir)
        return None
    pred_files = [os.path.join(pred_dir, n) for n in names]
    gt_files = [os.path.join(gt_dir, n.replace(".npz", ".txt")) for n in names]
    missing_gt = [g for g in gt_files if not os.path.isfile(g)]
    if missing_gt:
        raise FileNotFoundError(
            f"missing GT for {len(missing_gt)}/{len(gt_files)} scenes under "
            f"{gt_dir}, e.g. {missing_gt[:3]}")
    out = os.path.join(cfg.data_root, "evaluation", cfg.dataset,
                       f"{cfg.config_name}{suffix}.txt")
    return evaluate_scans(pred_files, gt_files, vocab_name(cfg.dataset),
                          no_class=no_class, output_file=out, device=device)


# ---------------------------------------------------------------------------
# steps 4-6: semantics
# ---------------------------------------------------------------------------


def features_step(cfg: PipelineConfig, seq_names: Sequence[str], encoder, *,
                  resume: bool = True, device: DeviceLike = None) -> None:
    """Step 4 (``run.py:981-996``): per-mask features of every scene's
    representative masks. A scene without an object dict is skipped."""
    device = resolve_device(device)
    for seq in seq_names:
        ds = get_dataset(cfg.dataset, seq, data_root=cfg.data_root)
        out_path = os.path.join(ds.object_dict_dir, cfg.config_name,
                                "open-vocabulary_features.npy")
        if resume and os.path.exists(out_path):
            continue
        od_path = os.path.join(ds.object_dict_dir, cfg.config_name, "object_dict.npy")
        if not os.path.exists(od_path):
            log.warning("no object_dict for %s; run the cluster step first", seq)
            continue
        object_dict = np.load(od_path, allow_pickle=True).item()
        feats = extract_mask_features(ds, object_dict, encoder, device=device)
        save_mask_features(feats, ds.object_dict_dir, cfg.config_name)


def label_features_step(cfg: PipelineConfig, encoder, *, resume: bool = True) -> str:
    """Step 5 (``run.py:999-1008``): the vocabulary's text features, cached at
    ``<data_root>/text_features/<vocab>.npy``."""
    path = os.path.join(cfg.data_root, "text_features", f"{vocab_name(cfg.dataset)}.npy")
    if resume and os.path.exists(path):
        return path
    labels, _ = get_vocab(cfg.dataset)
    return extract_label_features(labels, encoder, path)


def query_step(cfg: PipelineConfig, seq_names: Sequence[str], *, resume: bool = True,
               prediction_root: Optional[str] = None, device: DeviceLike = None) -> None:
    """Step 6 (``run.py:1011-1028``): the class-aware npz of every scene. A
    scene missing its object dict or features is skipped, not fatal."""
    device = resolve_device(device)
    prediction_root = prediction_root or os.path.join(cfg.data_root, "prediction")
    for seq in seq_names:
        out_path = os.path.join(prediction_root, cfg.config_name, f"{seq}.npz")
        if resume and os.path.exists(out_path):
            continue
        ds = get_dataset(cfg.dataset, seq, data_root=cfg.data_root)
        needed = [os.path.join(ds.object_dict_dir, cfg.config_name, n)
                  for n in ("object_dict.npy", "open-vocabulary_features.npy")]
        missing = [p for p in needed if not os.path.exists(p)]
        if missing:
            log.warning("skipping query for %s: missing %s", seq, missing)
            continue
        run_query(ds, cfg.config_name, seq, prediction_root=prediction_root, device=device)


# ---------------------------------------------------------------------------
# steps vis + top_images (the TASMap variant)
# ---------------------------------------------------------------------------


def _scene_points_cached(cfg: PipelineConfig, seq: str,
                         cache: Optional[Dict[str, np.ndarray]]) -> np.ndarray:
    """Load a scene's cloud once a run when the vis steps share a cache."""
    if cache is not None and seq in cache:
        return cache[seq]
    pts = get_dataset(cfg.dataset, seq, data_root=cfg.data_root).get_scene_points()
    if cache is not None:
        cache[seq] = pts
    return pts


def vis_step(cfg: PipelineConfig, seq_names: Sequence[str],
             prediction_root: Optional[str] = None, *, resume: bool = True,
             scene_points_cache: Optional[Dict[str, np.ndarray]] = None,
             device: DeviceLike = None) -> List[str]:
    """Instance-coloured scene artifacts of each scene
    (``run.py:1051-1073``): ``<data_root>/vis/<seq>/instances.ply``. A scene
    with no prediction is skipped with a warning; with ``resume``, one whose
    ``instances.ply`` exists is skipped. ``device`` is accepted for the
    steps' common signature: the step runs on the host."""
    from maskclustering_tpu_torch.visualize import vis_scene

    del device
    prediction_root = prediction_root or os.path.join(cfg.data_root, "prediction")
    written = []
    for seq in seq_names:
        npz_path = os.path.join(prediction_root, cfg.config_name + "_class_agnostic",
                                f"{seq}.npz")
        if not os.path.exists(npz_path):
            log.warning("no prediction for %s; run the cluster step first", seq)
            continue
        out_dir = os.path.join(cfg.data_root, "vis", seq)
        if resume and os.path.exists(os.path.join(out_dir, "instances.ply")):
            continue
        pred = np.load(npz_path)
        out = vis_scene(_scene_points_cached(cfg, seq, scene_points_cache),
                        pred["pred_masks"], out_dir)
        written.append(out["instances"])
    return written


def top_images_step(cfg: PipelineConfig, seq_names: Sequence[str],
                    max_objects: Optional[int] = None, *, resume: bool = True,
                    scene_points_cache: Optional[Dict[str, np.ndarray]] = None,
                    device: DeviceLike = None) -> List[str]:
    """Per-object bbox grids over the representative frames
    (``run.py:1076-1099``), the splats on ``device`` (default: the CUDA
    card): ``<data_root>/vis/<seq>/top_images/{grid,bbox}/``. A scene with no
    ``object_dict.npy`` is skipped with a warning; with ``resume``, one whose
    grid directory holds a file is skipped."""
    from maskclustering_tpu_torch.visualize import save_debug_grids

    device = resolve_device(device)
    written = []
    for seq in seq_names:
        ds = get_dataset(cfg.dataset, seq, data_root=cfg.data_root)
        od_path = os.path.join(ds.object_dict_dir, cfg.config_name, "object_dict.npy")
        if not os.path.exists(od_path):
            log.warning("no object_dict for %s; run the cluster step first", seq)
            continue
        out_dir = os.path.join(cfg.data_root, "vis", seq, "top_images")
        grid_dir = os.path.join(out_dir, "grid")
        if resume and os.path.isdir(grid_dir) and os.listdir(grid_dir):
            continue
        object_dict = np.load(od_path, allow_pickle=True).item()
        written.extend(save_debug_grids(
            ds, object_dict, _scene_points_cached(cfg, seq, scene_points_cache), out_dir,
            max_objects=max_objects, device=device))
    return written


# ---------------------------------------------------------------------------
# pipeline driver
# ---------------------------------------------------------------------------


def run_pipeline(
    cfg: PipelineConfig,
    seq_names: Sequence[str],
    *,
    steps: Sequence[str] = DEFAULT_STEPS,
    workers: int = 1,
    resume: bool = True,
    mask_command: Optional[str] = None,
    mask_predictor=None,
    report_path: Optional[str] = None,
    obs_events: Optional[str] = None,
    ledger_path: Optional[str] = None,
    ledger: bool = True,
    journal_path: Optional[str] = None,
    journal: bool = True,
    prediction_root: Optional[str] = None,
    encoder_spec: str = "hash",
    device: DeviceLike = None,
    mesh_devices: Optional[Sequence] = None,
) -> RunReport:
    """Run ``steps`` over ``seq_names`` (``run.py:1102-1345``).

    ``workers > 1`` clusters in that many spawned processes; a config with
    a ``mesh_shape`` clusters on a mesh over ``mesh_devices`` (default:
    every visible card). Raises before any scene runs for an unknown step, a
    malformed encoder spec or a missing card (``device=None``); a CLIP
    checkpoint that cannot be loaded raises after ``cluster`` and
    ``eval_ca``, as in the JAX ``run_pipeline``. The
    ``masks`` step fills scenes without id-maps through ``mask_predictor``,
    else a predictor built on ``device`` from ``cfg.cropformer_path``
    (``"grid"``: ``mask_prediction.GridSegmenter``), else ``mask_command``. A failed
    scene or step is recorded in the report, not raised. ``prediction_root``
    defaults to ``<data_root>/prediction``.

    ``obs_events`` arms obs for the run (spans fence, events land in that
    file, started afresh) and embeds its digest as ``report.obs``. With a
    ``report_path`` and ``ledger``, one row goes to the perf ledger at
    ``ledger_path`` (default ``obs.ledger.default_ledger_path()``, never
    the JAX package's ``PERF_LEDGER.jsonl``); a ledger failure never
    fails the run.
    """
    check_steps(steps, encoder_spec)
    kw = dict(steps=steps, workers=workers, resume=resume, mask_command=mask_command,
              mask_predictor=mask_predictor, report_path=report_path, obs_events=obs_events,
              ledger_path=ledger_path, ledger=ledger, journal_path=journal_path, journal=journal,
              prediction_root=prediction_root, encoder_spec=encoder_spec, device=device,
              mesh_devices=mesh_devices)
    if not obs_events:
        return _run_pipeline_body(cfg, seq_names, **kw)
    # truncate: this call owns the path (typically derived from --report);
    # appending to an earlier run's capture would pool stale spans
    obs.configure(obs_events, truncate=True,
                  meta={"tool": "run", "config": cfg.config_name})
    try:
        return _run_pipeline_body(cfg, seq_names, **kw)
    finally:
        # this call armed obs; it disarms it on every path
        obs.disable()


def _run_pipeline_body(cfg: PipelineConfig, seq_names: Sequence[str], *, steps, workers,
                       resume, mask_command, mask_predictor, report_path, obs_events,
                       ledger_path, ledger, journal_path, journal, prediction_root,
                       encoder_spec, device, mesh_devices) -> RunReport:
    device = resolve_device(device)
    if cfg.debug:
        log.setLevel(logging.DEBUG)
    report = RunReport(config_name=cfg.config_name,
                       clip_checkpoint=find_local_clip_checkpoint())

    def timed(name, fn):
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception:
            # a failed step is recorded (and fails the run) without sinking
            # the steps that can still run
            log.exception("step %s failed", name)
            report.step_errors[name] = traceback.format_exc(limit=20)
            out = None
        report.step_seconds[name] = time.perf_counter() - t0
        log.info("step %s: %.1fs", name, report.step_seconds[name])
        return out

    if "masks" in steps:
        # the spec's predictor is built lazily inside check_masks (so inside
        # timed(): a bad spec lands in the log, runs with every mask on
        # disk never build it) on the run's device
        missing = timed("masks", lambda: check_masks(
            cfg, seq_names, mask_command, mask_predictor=mask_predictor,
            predictor_spec=cfg.cropformer_path, device=device))
        if missing:
            log.warning("scenes with no 2D masks (excluded): %s", missing)
            seq_names = [s for s in seq_names if s not in set(missing)]

    if "cluster" in steps:
        jr = None
        if journal:
            jp = journal_path
            if jp is None and report_path:
                jp = os.path.join(os.path.dirname(report_path) or ".", "run_journal.jsonl")
            if jp:
                jr = faults.RunJournal(jp, cfg.config_name)
                jr.begin_run()
        sup = SceneSupervisor(cfg, workers=workers, resume=resume, journal=jr,
                              prediction_root=prediction_root, device=device,
                              mesh_devices=mesh_devices)
        try:
            report.scenes = timed("cluster", lambda: sup.run(seq_names)) or []
        finally:
            report.faults = sup.fault_summary(report.scenes)
            if jr is not None:
                jr.end_run(interrupted=report.faults["interrupted"])
                jr.close()
        ok = sum(1 for s in report.scenes if s.status != "failed")
        log.info("clustered %d/%d scenes", ok, len(report.scenes))
        if report.faults["scene_retries"] or report.faults["degradations"]:
            log.warning("fault summary: %s", report.faults)

    def evaluate(step: str, no_class: bool) -> None:
        report.evaluation[step] = timed(step, lambda: evaluate_step(
            cfg, no_class=no_class, seq_names=seq_names, prediction_root=prediction_root,
            device=device))

    # the JAX order (run.py:1277-1289)
    if "eval_ca" in steps:
        evaluate("eval_ca", True)
    encoder = None
    if {"features", "label_features"} & set(steps):
        encoder = make_encoder(encoder_spec, device)
    if "features" in steps:
        timed("features", lambda: features_step(cfg, seq_names, encoder, resume=resume,
                                                device=device))
    if "label_features" in steps:
        timed("label_features", lambda: label_features_step(cfg, encoder, resume=resume))
    if "query" in steps:
        timed("query", lambda: query_step(cfg, seq_names, resume=resume,
                                          prediction_root=prediction_root, device=device))
    if "eval" in steps:
        evaluate("eval", False)
    if {"vis", "top_images"} & set(steps):
        pts_cache: Dict[str, np.ndarray] = {}
        if "vis" in steps:
            timed("vis", lambda: vis_step(cfg, seq_names, prediction_root, resume=resume,
                                          scene_points_cache=pts_cache, device=device))
        if "top_images" in steps:
            timed("top_images", lambda: top_images_step(
                cfg, seq_names, resume=resume, scene_points_cache=pts_cache, device=device))

    if obs_events and obs.enabled():
        from maskclustering_tpu_torch.analysis import lock_sanitizer

        if lock_sanitizer.enabled():
            # book the sanitizer digest (locks.* counters) before the
            # flush so the report's Faults section renders it
            lock_sanitizer.emit_counters()
        obs.flush_metrics()
        try:
            from maskclustering_tpu_torch.obs.report import RunData

            report.obs = RunData(obs_events).summary()
        except Exception:  # noqa: BLE001 — a digest failure must not fail the run
            log.exception("obs digest failed for %s", obs_events)
            report.obs = {"events": obs_events}
    if report_path:
        report.save(report_path)
    if ledger and report_path and report.scenes:
        # one trajectory row per reported run: `obs.report --history`
        # renders it, `--regress` gates it
        try:
            from maskclustering_tpu_torch.obs import ledger as led

            led.append_row(
                ledger_path or led.default_ledger_path(),
                led.run_row({"config_name": report.config_name,
                             "scenes": [dataclasses.asdict(s) for s in report.scenes],
                             "obs": report.obs,
                             "faults": report.faults},
                            # knob attribution, the JAX row's keys: --regress
                            # names a flip instead of blaming code
                            count_dtype=cfg.count_dtype,
                            plane_dtype="int16",
                            point_shards=int(cfg.point_shards),
                            streaming_chunk=int(cfg.streaming_chunk),
                            postprocess_path=("device" if cfg.device_postprocess
                                              else "host")))
        except Exception:  # noqa: BLE001 — the ledger must never fail the run
            log.exception("perf ledger append failed")
    return report


# the item the unported JAX flags wait for: XLA's tooling
XLA_TOOLING_ITEM = "ROADMAP A10"


def build_parser():
    """The CLI's parser: every option string of the JAX ``run.py`` parser,
    plus ``--device``. The JAX flags whose subsystem the port does not have
    are accepted and raise in ``main`` (``_refuse_unported``)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="maskclustering_tpu_torch.run",
        description="mask-clustering batch driver on one CUDA card (PyTorch port)")
    parser.add_argument("--config", required=True,
                        help="config name under configs/, or the path of a JSON config "
                             "file (its file name without .json names the config)")
    parser.add_argument("--seq_name_list", default=None,
                        help="+-joined scene names (default: split file)")
    parser.add_argument("--splits_dir", default="splits")
    parser.add_argument("--steps", default=",".join(DEFAULT_STEPS),
                        help=f"comma-separated subset of {ALL_STEPS}")
    parser.add_argument("--workers", type=int, default=1,
                        help="scene-queue worker processes (1 = in-process); worker i "
                             "runs on card i %% device_count")
    parser.add_argument("--point-shards", type=int, default=None,
                        help="split the scene points over this many devices (the mesh's "
                             "third axis; needs the config's mesh_shape, and the device "
                             "count becomes scene*frame*point); artifacts are the same at "
                             "any shard count")
    parser.add_argument("--prefetch-depth", type=int, default=None,
                        help="disk-load lookahead of the scene prefetcher (0 = load "
                             "inline; default: config prefetch_depth)")
    parser.add_argument("--no-overlap", action="store_true",
                        help="serialize the scene loop (artifacts are identical)")
    parser.add_argument("--streaming-chunk", type=int, default=None, metavar="F",
                        help="stream each scene in chunks of F frames through the "
                             "accumulator (models/streaming.py): one chunk's claim planes "
                             "resident, partial instances per chunk, byte-equal to the "
                             "batch result when one chunk covers the scene; 0 = batch "
                             "(default: config streaming_chunk)")
    parser.add_argument("--fault-plan", default=None,
                        help="deterministic fault injection spec (e.g. 'load:scene2, "
                             "stall:scene4.device, flaky:scene5:2'; default: "
                             "$MCT_FAULT_PLAN); a drill knob, never for production")
    parser.add_argument("--no-resume", action="store_true",
                        help="recompute even when artifacts exist")
    parser.add_argument("--encoder", default="hash",
                        help="feature encoder spec: hash[:dim] or hf:<local checkpoint dir> "
                             "(CLIP, on --device)")
    parser.add_argument("--mask_command", default=None,
                        help="external mask-predictor template with {seq_name}: run for "
                             "each scene whose 2D masks are missing")
    parser.add_argument("--profile_dir", default=None,
                        help="the JAX driver's profiler trace of the cluster step (no "
                             "torch counterpart yet: ROADMAP A10)")
    parser.add_argument("--report", default=None, help="run report JSON path")
    parser.add_argument("--obs_events", default=None,
                        help="obs span/metrics JSONL path (default: derived from "
                             "--report; render with python -m "
                             "maskclustering_tpu_torch.obs.report)")
    parser.add_argument("--no-obs", action="store_true",
                        help="disable obs capture even when --report is set")
    parser.add_argument("--xprof", default=None, metavar="STAGE",
                        help="span-triggered profiler capture (no torch counterpart "
                             "yet: ROADMAP A10)")
    parser.add_argument("--xprof_dir", default=None,
                        help="trace output dir for --xprof (ROADMAP A10)")
    parser.add_argument("--ledger", default=None,
                        help="perf ledger JSONL the run digest appends to (default: "
                             "PERF_LEDGER_TORCH.jsonl / $MCT_PERF_LEDGER)")
    parser.add_argument("--no-ledger", action="store_true",
                        help="do not append this run to the perf ledger")
    parser.add_argument("--journal", default=None,
                        help="crash-safe scene journal JSONL (default: "
                             "run_journal.jsonl next to --report)")
    parser.add_argument("--no-journal", action="store_true",
                        help="disable the scene journal (artifact-exists resume only)")
    parser.add_argument("--scene-retries", type=int, default=None,
                        help="extra attempts per failed scene (default: config "
                             "scene_retries; 0 = fail fast)")
    parser.add_argument("--watchdog-device", type=float, default=None,
                        help="device-phase watchdog budget in seconds (0 = off)")
    parser.add_argument("--transfer-guard", action="store_true",
                        help="XLA's transfer guard around each scene's device phase "
                             "(no torch counterpart yet: ROADMAP A10)")
    parser.add_argument("--lock-sanitizer", action="store_true",
                        help="record every named lock's acquisition order and hold times "
                             "(analysis/lock_sanitizer.py; also MCT_LOCK_SANITIZER=1): the "
                             "report renders the locks.* counters, and with --report the "
                             "observed order graph goes to <report>_locks.json")
    parser.add_argument("--retrace-sanitizer", action="store_true",
                        help="XLA's compile-event sanitizer (no torch counterpart "
                             "yet: ROADMAP A10)")
    parser.add_argument("--aot-cache", default=None, nargs="?", const="auto",
                        metavar="DIR",
                        help="XLA's persistent AOT executable cache (no torch "
                             "counterpart yet: ROADMAP A10)")
    parser.add_argument("--data_root", default=None, help="override the config's data root")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the "
                             "plain torch path on the CPU)")
    parser.add_argument("--init_timeout", type=float, default=120.0,
                        help="watchdog seconds for the device's first use")
    parser.add_argument("--debug", action="store_true")
    return parser


def _refuse_unported(args) -> None:
    """Raise for a JAX flag whose subsystem the port does not have yet."""
    for flag, given in (("--profile_dir", args.profile_dir is not None),
                        ("--xprof", args.xprof is not None),
                        ("--xprof_dir", args.xprof_dir is not None),
                        ("--transfer-guard", args.transfer_guard),
                        ("--retrace-sanitizer", args.retrace_sanitizer),
                        ("--aot-cache", args.aot_cache is not None)):
        if given:
            raise NotImplementedError(
                f"{flag} (XLA tooling) has no torch counterpart yet ({XLA_TOOLING_ITEM})")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)

    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    overrides = {"data_root": args.data_root} if args.data_root else {}
    if args.prefetch_depth is not None:
        overrides["prefetch_depth"] = args.prefetch_depth
    if args.no_overlap:
        overrides["scene_overlap"] = False
    if args.point_shards is not None:
        overrides["point_shards"] = args.point_shards
    if args.scene_retries is not None:
        overrides["scene_retries"] = args.scene_retries
    if args.watchdog_device is not None:
        overrides["watchdog_device_s"] = args.watchdog_device
    if args.streaming_chunk is not None:
        overrides["streaming_chunk"] = args.streaming_chunk
    if args.debug:
        overrides["debug"] = True
    if args.config.endswith(".json") and os.path.isfile(args.config):
        cfg = load_config(os.path.basename(args.config)[:-len(".json")],
                          config_dir=os.path.dirname(os.path.abspath(args.config)), **overrides)
    else:
        cfg = load_config(args.config, **overrides)
    if args.lock_sanitizer:
        from maskclustering_tpu_torch.analysis import lock_sanitizer

        lock_sanitizer.arm(True)
        # the plan/registry locks already exist (import time): re-wrap them
        # in place; per-instance locks arm at creation from here on
        lock_sanitizer.instrument_known_locks()
    if args.fault_plan:
        faults.set_plan(faults.FaultPlan.from_spec(args.fault_plan))
    faults.install_sigterm_handler()
    seq_names = get_seq_name_list(cfg.dataset, args.splits_dir, args.seq_name_list)
    log.info("there are %d scenes", len(seq_names))

    obs_events = args.obs_events
    if obs_events is None and args.report:
        # a reported run captures events by default: the report JSON then
        # carries the digest and the path to the full span stream
        obs_events = os.path.splitext(args.report)[0] + "_events.jsonl"
    if args.no_obs:
        obs_events = None

    device = resolve_device(args.device)
    # the first use of the card creates its context: bounded, so a wedged
    # driver fails the run instead of hanging it
    faults.call_with_deadline(lambda: torch.zeros(1, device=device),
                              args.init_timeout, seam="load", scene="device-init")

    t0 = time.time()
    report = run_pipeline(cfg, seq_names, steps=tuple(s for s in args.steps.split(",") if s),
                          workers=args.workers, resume=not args.no_resume, report_path=args.report,
                          obs_events=obs_events, ledger_path=args.ledger,
                          ledger=not args.no_ledger,
                          journal_path=args.journal, journal=not args.no_journal,
                          mask_command=args.mask_command,
                          encoder_spec=args.encoder, device=args.device)
    total = time.time() - t0
    log.info("total time %.1f min (%.1f s/scene)", total / 60, total / max(len(seq_names), 1))
    if args.lock_sanitizer and args.report:
        # the observed graph, for the embeds-in-static cross-check
        # (lock_sanitizer.check_embeds against concurrency.build_lock_order_graph)
        from maskclustering_tpu_torch.analysis import lock_sanitizer

        with open(os.path.splitext(args.report)[0] + "_locks.json", "w") as f:
            json.dump(lock_sanitizer.report(), f, indent=2)
    if report.interrupted or faults.stop_requested():
        return 143
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
