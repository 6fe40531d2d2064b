"""Three ``run_scene`` runs at the post-process profile's shape, each with
its ``timings`` (the port's ``scripts/profile_postprocess.py``).

The scene is the JAX script's: ``make_scene`` with 12 boxes and 150 frames
of 240x320 at spacing 0.02, the cloud resized to 196,608 points, the bench
thresholds (``distance_threshold`` 0.03, ``few_points_threshold`` 25),
``k_max`` 63. The first run pays the kernel builds; the ``post.*`` entries
of the later two are the device post-process's phases::

    python -m maskclustering_tpu_torch.tools.profile_postprocess [--device cpu]

The runs are on the card unless ``--device`` names another device; asked
for the card on a host without one, it raises.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m maskclustering_tpu_torch.tools.profile_postprocess")
    p.add_argument("--frames", type=int, default=150)
    p.add_argument("--points", type=int, default=196608)
    p.add_argument("--boxes", type=int, default=12)
    p.add_argument("--image-h", type=int, default=240)
    p.add_argument("--image-w", type=int, default=320)
    p.add_argument("--k-max", type=int, default=63)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    args = p.parse_args(argv)

    from maskclustering_tpu_torch.config import PipelineConfig
    from maskclustering_tpu_torch.device import resolve_device, synchronize
    from maskclustering_tpu_torch.models.pipeline import run_scene
    from maskclustering_tpu_torch.utils.synthetic import (
        make_scene,
        resize_scene_points,
        to_scene_tensors,
    )

    dev = resolve_device(args.device)
    t0 = time.time()
    scene = make_scene(num_boxes=args.boxes, num_frames=args.frames,
                       image_hw=(args.image_h, args.image_w), spacing=0.02, seed=0)
    tensors = to_scene_tensors(scene)
    tensors.scene_points = resize_scene_points(tensors.scene_points, args.points)
    print(f"scene ready {time.time() - t0:.1f}s", file=sys.stderr)

    cfg = PipelineConfig(config_name="bench", dataset="demo", distance_threshold=0.03,
                         few_points_threshold=25, point_chunk=8192)
    walls = []
    for i in range(args.runs):
        t0 = time.time()
        result = run_scene(tensors, cfg, k_max=args.k_max, device=dev)
        synchronize(dev)
        walls.append(time.time() - t0)
        print(f"run {i}: {walls[-1]:.2f}s  "
              f"{ {k: round(v, 3) for k, v in result.timings.items()} }", file=sys.stderr)
    print(f"[profile_postprocess] OK: {args.runs} runs on {dev}, walls "
          f"{[round(w, 3) for w in walls]} s, {len(result.objects.point_ids_list)} objects",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
