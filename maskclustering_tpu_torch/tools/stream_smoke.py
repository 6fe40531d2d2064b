"""Streaming smoke: the chunked-accumulation contract on a 2-scene run (the
port's counterpart of the JAX package's ``scripts/stream_smoke.py``).

The CI gate's drill of the streaming layer (``tools/ci.py``), the three
claims checked deterministically at chunk 8 on ``--device`` (the CUDA card
by default, which must exist; ``--device cpu`` for the plain torch path):

1. **convergence** — a scene one chunk covers entirely produces
   BYTE-IDENTICAL artifacts to the batch path, and a 3-chunk scene's final
   instances match the batch object count;
2. **a warm steady state** — the build/launch-surface sanitizer freezes
   after chunk 1 of a fresh stream; chunks 2..K book no post-freeze
   ``nvcc`` build and no new (kernel, launch shape) key;
3. **capped residency** — ``stream.max_plane_bytes`` stays strictly under
   the full-scene claim-plane set.

    python -m maskclustering_tpu_torch.tools.stream_smoke [--device cpu]

The runs' (scene, status, objects) rows and the checks' figures go to
stdout as one JSON line (``"kind": "stream_smoke"``). Exit 0 = every
expectation held; a failed one prints and exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict, List, Tuple

SCENE_ONE = "scene0000_00"  # 8 frames: one chunk covers it (byte identity)
SCENE_MULTI = "scene0001_00"  # 24 frames: 3 chunks at chunk 8
CHUNK = 8


def _cfg(root, name, **kw):
    from maskclustering_tpu_torch.config import load_config

    return load_config("scannet").replace(
        data_root=root, config_name=name, step=1, distance_threshold=0.05,
        mask_pad_multiple=32, frame_pad_multiple=4, point_chunk=2048,
        retry_backoff_s=0.01, **kw)


def _artifact(root, name, scene):
    return os.path.join(root, "prediction", name + "_class_agnostic", f"{scene}.npz")


def write_layout(root: str):
    """The two scenes under ``root``; returns the multi-chunk scene."""
    from maskclustering_tpu_torch.utils.synthetic import make_scene, write_scannet_layout

    write_scannet_layout(make_scene(num_boxes=3, num_frames=8, image_hw=(48, 64), seed=7,
                                    spacing=0.05), root, SCENE_ONE)
    scene_b = make_scene(num_boxes=3, num_frames=24, image_hw=(48, 64), seed=11,
                         spacing=0.05)
    write_scannet_layout(scene_b, root, SCENE_MULTI)
    return scene_b


def run_checks(root: str, device) -> Tuple[Dict, List[str]]:
    """The three claims over a fresh layout at ``root``: (report, failures).
    The report holds each run's (scene, status, objects) rows, the frozen
    chunks' violations and the residency figures."""
    from maskclustering_tpu_torch import obs
    from maskclustering_tpu_torch.analysis import retrace_sanitizer
    from maskclustering_tpu_torch.models.pipeline import bucket_k_max
    from maskclustering_tpu_torch.models.streaming import StreamAccumulator, slice_scene_frames
    from maskclustering_tpu_torch.run import cluster_scenes
    from maskclustering_tpu_torch.utils.compile_cache import max_seg_id, scene_pads
    from maskclustering_tpu_torch.utils.synthetic import to_scene_tensors

    failures: List[str] = []
    report: Dict = {}

    def check(ok, msg):
        print(("ok   " if ok else "FAIL ") + msg, flush=True)
        if not ok:
            failures.append(msg)

    scene_b = write_layout(root)
    scenes = [SCENE_ONE, SCENE_MULTI]

    batch = cluster_scenes(_cfg(root, "smoke_batch"), scenes, resume=False, device=device)
    report["batch"] = [[s.seq_name, s.status, s.num_objects] for s in batch]
    check(all(s.status == "ok" for s in batch),
          f"batch run ok ({[s.status for s in batch]})")
    batch_objects = {s.seq_name: s.num_objects for s in batch}

    # the streaming run at chunk 8, the sanitizer armed for the whole drill
    retrace_sanitizer.reset()
    retrace_sanitizer.arm(True)
    retrace_sanitizer.install()
    try:
        stream = cluster_scenes(_cfg(root, "smoke_stream", streaming_chunk=CHUNK), scenes,
                                resume=False, device=device)
        report["stream"] = [[s.seq_name, s.status, s.num_objects] for s in stream]
        check(all(s.status == "ok" for s in stream),
              f"streaming run ok ({[s.status for s in stream]})")
        stream_objects = {s.seq_name: s.num_objects for s in stream}

        # 1a. single-chunk convergence: byte-identical artifacts
        with open(_artifact(root, "smoke_batch", SCENE_ONE), "rb") as f:
            a = f.read()
        with open(_artifact(root, "smoke_stream", SCENE_ONE), "rb") as f:
            b = f.read()
        check(a == b, f"chunk>=F artifacts byte-identical ({len(a)} bytes)")
        # 1b. multi-chunk convergence: the batch instance count
        check(stream_objects.get(SCENE_MULTI) == batch_objects.get(SCENE_MULTI),
              f"multi-chunk instance count {stream_objects.get(SCENE_MULTI)} == batch "
              f"{batch_objects.get(SCENE_MULTI)}")

        # 2. a fresh stream frozen after chunk 1 (which builds and launches
        # the stream's kernels): the remaining chunks run entirely warm
        cfg = _cfg(root, "smoke_freeze", streaming_chunk=CHUNK)
        tensors = to_scene_tensors(scene_b)
        acc = StreamAccumulator(cfg, total_frames=tensors.num_frames,
                                num_points=tensors.num_points,
                                k_max=bucket_k_max(max_seg_id(tensors.segmentations)),
                                seq_name="freeze-drill", device=device)
        acc.push_chunk(slice_scene_frames(tensors, 0, CHUNK))
        retrace_sanitizer.freeze()
        for ci in range(1, acc.n_chunks):
            acc.push_chunk(slice_scene_frames(
                tensors, ci * CHUNK, min((ci + 1) * CHUNK, tensors.num_frames)))
        digest = retrace_sanitizer.digest()
    finally:
        retrace_sanitizer.uninstall()
        retrace_sanitizer.arm(None)
        retrace_sanitizer.reset()
    post_freeze = [v for v in digest["violations"] if v["kind"] == "post_freeze"]
    repeats = [v for v in digest["violations"] if v["kind"] == "repeat"]
    report["chunks"] = acc.n_chunks
    report["post_freeze"] = len(post_freeze)
    report["repeats"] = len(repeats)
    check(not post_freeze,
          f"zero post-freeze builds and launch keys across chunks 2..{acc.n_chunks} "
          f"(violations: {post_freeze or 'none'})")
    check(not repeats, f"zero repeat builds (violations: {repeats or 'none'})")

    # 3. residency: the largest chunk-plane materialisation stays strictly
    # under the full-scene plane set the batch path keeps resident
    mx = obs.registry().snapshot()["gauges"].get("stream.max_plane_bytes")
    f_full, n_pad = scene_pads(cfg, tensors.num_frames, tensors.num_points)
    full_set = f_full * n_pad * (4 + 2 + 2 + 1) + n_pad
    report["max_plane_bytes"] = mx
    report["full_plane_set"] = full_set
    check(mx is not None and mx < full_set,
          f"stream.max_plane_bytes {mx} < full-scene plane set {full_set}")
    return report, failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m maskclustering_tpu_torch.tools.stream_smoke",
                                description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card, which must exist; 'cpu' "
                        "runs the plain torch path)")
    args = p.parse_args(argv)

    from maskclustering_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="mct_stream_smoke_") as root:
        report, failures = run_checks(root, device)
    print(json.dumps({"kind": "stream_smoke", "ok": not failures, "device": str(device),
                      **report}), flush=True)
    print(f"stream_smoke: {'PASS' if not failures else 'FAIL'} "
          f"({len(failures)} failure(s)) on {device}", flush=True)
    return 0 if not failures else 1


if __name__ == "__main__":
    raise SystemExit(main())
