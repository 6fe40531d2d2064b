"""mct-serve router: shape-bucket classification + serving-vocabulary warm-up
(the port's copy of ``maskclustering_tpu/serve/router.py``).

"Bucket" means exactly one thing across the whole serving stack:
``utils/compile_cache.scene_bucket`` — the (k_max, f_pad, n_pad) key
``run_scene_device`` pads every scene to, and the daemon's routing/warmth
vocabulary. The router

- **classifies** requests through that one classifier (synthetic requests
  at materialization, disk scenes as the worker's executor records their
  buckets);
- tracks which buckets this process has **served warm** (the first
  dispatch of a bucket is cold: on the card the allocator grows to its
  shapes, the kernels load and cuBLAS creates its handles; later requests
  against it are warm);
- builds **warm-up workloads**: either explicit scene names, or synthetic
  tensors fitted to the bucket coordinates of
  ``compile_surface_baseline.json``'s canonical workload (a data file of
  the repository, read, not imported), so a daemon started with
  ``--warm-baseline`` pays the serving vocabulary's cold dispatches at
  startup instead of on the first unlucky request.

Baseline-driven warm-up fits a small synthetic scene to each workload
entry's exact (frames, points, max_id): frame count is exact by
construction, the cloud is tiled/trimmed to the point count (duplicate
points are geometrically harmless), and one border pixel of one frame's
id-map is raised to ``max_id`` (a 1-pixel mask the coverage filter
rejects — it exists only to pin ``bucket_k_max``).
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from maskclustering_tpu_torch.utils.compile_cache import scene_bucket

log = logging.getLogger("maskclustering_tpu_torch")

Bucket = Tuple[int, int, int]  # (k_max, f_pad, n_pad)


def fit_tensors_to_bucket(tensors, frames: int, points: int, max_id: int):
    """Reshape a synthetic scene's tensors to exact bucket coordinates.

    ``frames`` must already match (make_scene's num_frames is exact); the
    cloud is resized by cyclic tiling/trimming and the id-map's [0, 0]
    pixel of frame 0 is raised to ``max_id`` when the scene's own ids
    fall short. Returns a new SceneTensors; never mutates the input.
    """
    import dataclasses

    if tensors.num_frames != frames:
        raise ValueError(f"warm-up scene has {tensors.num_frames} frames, "
                         f"bucket needs {frames} (generate, don't resize)")
    pts = tensors.scene_points
    if pts.shape[0] != points:
        pts = np.resize(pts, (points, pts.shape[1]))
    seg = tensors.segmentations
    if int(np.max(seg)) < max_id:
        seg = seg.copy()
        seg[0, 0, 0] = max_id
    return dataclasses.replace(tensors, scene_points=pts, segmentations=seg)


class Router:
    """Bucket bookkeeping for one daemon (one cfg, one process)."""

    def __init__(self, cfg, baseline_path: Optional[str] = None):
        self.cfg = cfg
        self._lock = threading.Lock()
        self._warm: Set[Bucket] = set()
        # scene name -> bucket, filled as requests classify: repeat
        # synthetic requests must not regenerate a whole scene host-side
        # just to re-derive a bucket that cannot have changed
        self._by_scene: Dict[str, Bucket] = {}
        # bucket -> warm synthetic SceneTensors: the packing scheduler's
        # pad-lane source (serve/worker.py fills it at warm-up/first-serve;
        # a partial batch pads to full width with THESE tensors so every
        # occupancy reuses the one full-width executable)
        self._pad_tensors: Dict[Bucket, object] = {}
        self.vocabulary: List[Dict] = []  # baseline workload entries
        if baseline_path:
            self.vocabulary = self._load_vocabulary(baseline_path)

    @staticmethod
    def _load_vocabulary(path: str) -> List[Dict]:
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            log.warning("serve router: no usable surface baseline at %s; "
                        "starting with an empty serving vocabulary", path)
            return []
        out = []
        for entry in doc.get("workload", ()):
            if all(isinstance(entry.get(k), int)
                   for k in ("frames", "points", "max_id")):
                out.append({k: entry[k]
                            for k in ("scene", "frames", "points", "max_id")
                            if k in entry})
        return out

    def classify(self, frames: int, points: int, max_id: int) -> Bucket:
        return scene_bucket(self.cfg, frames, points, max_id)

    def classify_tensors(self, tensors) -> Bucket:
        from maskclustering_tpu_torch.utils.compile_cache import scene_bucket_of

        return scene_bucket_of(self.cfg, tensors)

    def bucket_for(self, scene: str) -> Optional[Bucket]:
        with self._lock:
            return self._by_scene.get(scene)

    def remember(self, scene: str, bucket: Bucket) -> None:
        with self._lock:
            self._by_scene[scene] = bucket

    def is_warm(self, bucket: Bucket) -> bool:
        with self._lock:
            return bucket in self._warm

    def note_served(self, bucket: Bucket) -> bool:
        """Record a served bucket; True when it was new (cold dispatch)."""
        with self._lock:
            if bucket in self._warm:
                return False
            self._warm.add(bucket)
        return True

    def warm_buckets(self) -> Set[Bucket]:
        with self._lock:
            return set(self._warm)

    def vocabulary_buckets(self) -> Set[Bucket]:
        """The baseline workload's bucket set — what EVERY worker warms at
        startup (the pool seeds each slice's affinity set with these:
        a vocabulary bucket is warm on every slice by construction)."""
        return {self.classify(e["frames"], e["points"], e["max_id"])
                for e in self.vocabulary}

    def remember_pad_tensors(self, bucket: Bucket, tensors) -> None:
        """Retain one scene's tensors as the bucket's warm pad lane (first
        writer wins — pad bytes must stay stable across a daemon's life so
        partial-batch dispatches are reproducible)."""
        with self._lock:
            self._pad_tensors.setdefault(bucket, tensors)

    def pad_tensors_for(self, bucket: Bucket):
        """The bucket's warm pad-lane tensors, or None before any scene of
        that bucket has been warmed/served."""
        with self._lock:
            return self._pad_tensors.get(bucket)

    def warmup_workload(self) -> Iterable[Tuple[str, "object"]]:
        """(name, SceneTensors) per DISTINCT baseline-vocabulary bucket.

        Tensors are synthetic scenes fitted to each entry's exact
        coordinates; repeated buckets (the baseline workload includes a
        deliberate repeat) are emitted once.
        """
        from maskclustering_tpu_torch.utils.synthetic import (make_scene,
                                                              to_scene_tensors)

        seen: Set[Bucket] = set()
        for i, entry in enumerate(self.vocabulary):
            bucket = self.classify(entry["frames"], entry["points"],
                                   entry["max_id"])
            if bucket in seen:
                continue
            seen.add(bucket)
            scene = make_scene(num_boxes=3, num_frames=entry["frames"],
                               image_hw=(60, 80), spacing=0.06,
                               seed=1000 + i)
            tensors = fit_tensors_to_bucket(
                to_scene_tensors(scene), entry["frames"], entry["points"],
                entry["max_id"])
            fitted = self.classify_tensors(tensors)
            if fitted != bucket:
                # a mis-fitted warm-up scene would silently warm the WRONG
                # executable; skip it loudly rather than lie about warmth
                log.warning("serve router: warm-up scene for %s landed in "
                            "bucket %s; skipping", entry, fitted)
                continue
            yield entry.get("scene", f"warm-{i}"), tensors
