"""Benchmark the fused multi-device path (the port's ``scripts/mesh_bench.py``).

``parallel/batch.cluster_scene_batch`` over a ``(scene, frame[, point])``
mesh, end to end through the post-process, at real scale (>= 128k points a
scene): a warm-up batch of one scene-axis width, then all ``--scenes``
scenes. Reported: s/scene, the peak device memory
(``torch.cuda.max_memory_allocated``) beside the process's peak RSS, and
the objects of each scene. The mesh takes distinct cards while the host
has enough; on fewer cards it repeats ``--device`` (on one card every
coordinate is that card: the numbers measure the path's orchestration and
its memory on one card, not a multi-card speed-up), and the table says
which devices it ran on::

    python -m maskclustering_tpu_torch.tools.mesh_bench [--scenes 8] [--mesh 2 4] [--device cpu]

The markdown goes to ``--out`` (default under ``build/tools/``, never a
tracked file). On the card unless ``--device`` names another device; asked
for the card on a host without one, it raises.
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import time
from typing import List, Optional

DEFAULT_OUT = os.path.join("build", "tools", "MESH_BENCH.md")


def peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def mesh_devices(dev, count: int) -> list:
    """``count`` devices for the mesh: distinct cards from ``dev``'s index
    on while the host has them, else ``dev`` repeated."""
    import torch

    if dev.type == "cuda":
        first = dev.index or 0
        if torch.cuda.device_count() - first >= count:
            return [torch.device("cuda", first + i) for i in range(count)]
    return [dev] * count


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m maskclustering_tpu_torch.tools.mesh_bench")
    p.add_argument("--scenes", type=int, default=8)
    p.add_argument("--points", type=int, default=131072)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--boxes", type=int, default=12)
    p.add_argument("--image-h", type=int, default=240)
    p.add_argument("--image-w", type=int, default=320)
    p.add_argument("--mesh", type=int, nargs=2, default=(2, 4), metavar=("SCENE", "FRAME"))
    p.add_argument("--point-shards", type=int, default=1,
                   help="shard the point axis over this many devices (third mesh axis); "
                        "artifacts are byte-identical at any value")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    args = p.parse_args(argv)

    import torch

    from maskclustering_tpu_torch.config import PipelineConfig
    from maskclustering_tpu_torch.device import resolve_device, synchronize
    from maskclustering_tpu_torch.parallel.batch import cluster_scene_batch, make_run_mesh
    from maskclustering_tpu_torch.utils.synthetic import (
        make_scene,
        resize_scene_points,
        to_scene_tensors,
    )

    dev = resolve_device(args.device)
    cfg = PipelineConfig(config_name="mesh_bench", dataset="demo",
                         backend="gpu" if dev.type == "cuda" else "cpu",
                         distance_threshold=0.03, point_chunk=8192, frame_pad_multiple=8,
                         mesh_shape=tuple(args.mesh), point_shards=args.point_shards)
    count = args.mesh[0] * args.mesh[1] * args.point_shards
    devices = mesh_devices(dev, count)
    mesh = make_run_mesh(cfg, devices)
    distinct = sorted({str(d) for d in devices})
    if dev.type == "cuda":
        names = sorted({torch.cuda.get_device_name(d) for d in devices})
        dev_desc = (f"{count} mesh coordinates on {len(distinct)} card(s) "
                    f"({', '.join(names)}: {', '.join(distinct)})")
    else:
        dev_desc = f"{count} mesh coordinates on the CPU (plain path)"
    print(f"[mesh-bench] {dev_desc}", file=sys.stderr, flush=True)

    t0 = time.time()
    tensors = []
    for i in range(args.scenes):
        s = make_scene(num_boxes=args.boxes, num_frames=args.frames,
                       image_hw=(args.image_h, args.image_w), spacing=0.02, seed=i)
        t = to_scene_tensors(s)
        t.scene_points = resize_scene_points(t.scene_points, args.points, seed=i)
        tensors.append(t)
    gen_s = time.time() - t0
    print(f"[mesh-bench] {args.scenes} scenes generated in {gen_s:.1f}s", file=sys.stderr,
          flush=True)

    s_axis = args.mesh[0]
    t0 = time.time()
    cluster_scene_batch(cfg, mesh, tensors[:s_axis])
    synchronize(dev)
    warm_s = time.time() - t0
    print(f"[mesh-bench] warm-up batch ({s_axis} scenes, kernel builds included): "
          f"{warm_s:.1f}s", file=sys.stderr, flush=True)

    if dev.type == "cuda":
        for d in distinct:
            torch.cuda.reset_peak_memory_stats(torch.device(d))
    t0 = time.time()
    objs = cluster_scene_batch(cfg, mesh, tensors)
    synchronize(dev)
    run_s = time.time() - t0
    per_scene = run_s / args.scenes
    rss = peak_rss_gb()
    peak = (max(torch.cuda.max_memory_allocated(torch.device(d)) for d in distinct) / 2**30
            if dev.type == "cuda" else None)
    peak_txt = f"{peak:.2f} GiB" if peak is not None else "not measured (cpu)"
    counts = [len(o.point_ids_list) for o in objs]
    print(f"[mesh-bench] {args.scenes} scenes in {run_s:.1f}s ({per_scene:.2f} s/scene), "
          f"objects {counts}, peak device memory {peak_txt}, peak RSS {rss:.2f} GB",
          file=sys.stderr, flush=True)

    notes = ("Notes: one card repeated over the mesh: these are the path's wall and its "
             "memory on one card,\nnot a multi-card speed-up."
             if dev.type == "cuda" and len(distinct) < count else
             "Notes: distinct cards, real wall-clock numbers, comparable across meshes in one "
             "run." if dev.type == "cuda" else
             "Notes: the CPU's plain path measures the orchestration, not the card.")
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write(f"""# Mesh-path benchmark ({dev_desc})

Fused multi-device pipeline (`parallel/batch.cluster_scene_batch`) over a
`(scene={args.mesh[0]}, frame={args.mesh[1]}, point={args.point_shards})` mesh, end to end
through the device post-process and the host merge.

| quantity | value |
|---|---|
| scenes | {args.scenes} ({args.boxes} objects, {args.frames} frames, {args.image_h}x{args.image_w}, {args.points // 1024}k pts each) |
| mesh | scene={args.mesh[0]} x frame={args.mesh[1]} x point={args.point_shards} |
| devices | {dev_desc} |
| warm-up batch (kernel builds included) | {warm_s:.1f} s |
| full run | {run_s:.1f} s |
| **s/scene** | **{per_scene:.2f}** |
| peak device memory | {peak_txt} |
| peak RSS | {rss:.2f} GB |
| objects recovered | {counts} |

{notes} Generated by `python -m maskclustering_tpu_torch.tools.mesh_bench`.
""")
    print(f"[mesh-bench] OK: wrote {args.out}; {per_scene:.3f} s/scene, objects {counts}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
