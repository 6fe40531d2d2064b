"""Capture a ``torch.profiler`` trace of one bench-scale ``run_scene``
(the port's ``scripts/profile_scene_tpu.py``).

The bench's synthetic scene (``utils/synthetic.make_scene_device``: 36
boxes, 250 frames of 480x640 rendered on the card, the cloud resized to
196,608 points) runs once to warm the process (kernel builds, the caching
allocator), then once under the profiler, as ``run.py --profile_dir``
captures it (CUDA and CPU activity, ``obs/xprof.profiler_activities``). The
Chrome trace goes to ``<trace-dir>/trace.json``; the tool prints the traced
run's wall and ``timings``, the card's busy share of the traced run
(``obs/xprof.trace_busy``) and its top kernels::

    python -m maskclustering_tpu_torch.tools.profile_scene [--trace-dir DIR] [--device cpu]

Open the trace in Perfetto or ``chrome://tracing``. The run is on the card
unless ``--device`` names another device; asked for the card on a host
without one, it raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

DEFAULT_TRACE_DIR = os.path.join("build", "tools", "profile_scene")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m maskclustering_tpu_torch.tools.profile_scene")
    p.add_argument("--trace-dir", default=DEFAULT_TRACE_DIR)
    p.add_argument("--frames", type=int, default=250)
    p.add_argument("--points", type=int, default=196608)
    p.add_argument("--boxes", type=int, default=36)
    p.add_argument("--image-h", type=int, default=480)
    p.add_argument("--image-w", type=int, default=640)
    p.add_argument("--distance-threshold", type=float, default=0.01)
    p.add_argument("--top", type=int, default=8, help="kernels to list")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    args = p.parse_args(argv)

    import torch

    from maskclustering_tpu_torch.config import PipelineConfig
    from maskclustering_tpu_torch.device import resolve_device, synchronize
    from maskclustering_tpu_torch.models.pipeline import run_scene
    from maskclustering_tpu_torch.obs.xprof import profiler_activities, trace_busy
    from maskclustering_tpu_torch.utils.synthetic import make_scene_device, resize_scene_points

    dev = resolve_device(args.device)
    print(f"[profile_scene] device: {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""),
          file=sys.stderr, flush=True)
    tensors, _, _ = make_scene_device(num_boxes=args.boxes, num_frames=args.frames,
                                      image_hw=(args.image_h, args.image_w), seed=0,
                                      device=dev)
    tensors.scene_points = resize_scene_points(tensors.scene_points, args.points)
    cfg = PipelineConfig(config_name="profile", dataset="demo",
                         distance_threshold=args.distance_threshold, point_chunk=8192)

    t0 = time.time()
    run_scene(tensors, cfg, k_max=63, device=dev)  # warm-up: builds outside the trace
    synchronize(dev)
    print(f"[profile_scene] warm-up {time.time() - t0:.1f}s", file=sys.stderr, flush=True)

    os.makedirs(args.trace_dir, exist_ok=True)
    trace = os.path.join(args.trace_dir, "trace.json")
    with torch.profiler.profile(activities=profiler_activities()) as prof:
        t0 = time.time()
        result = run_scene(tensors, cfg, k_max=63, device=dev)
        synchronize(dev)
        dt = time.time() - t0
    prof.export_chrome_trace(trace)
    print(f"[profile_scene] traced run: {dt:.2f}s, timings "
          f"{ {k: round(v, 3) for k, v in result.timings.items()} }", file=sys.stderr, flush=True)
    busy, span, by_name = trace_busy(trace)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    for name, (ms, cnt) in top:
        print(f"  {ms:9.3f} ms  x{cnt:<6d} {name[:100]}", file=sys.stderr)
    share = f"{100 * busy / dt:.1f} % of the traced run" if dev.type == "cuda" else "not measured"
    print(f"[profile_scene] OK: trace {trace} ({os.path.getsize(trace)} bytes); "
          f"{len(result.objects.point_ids_list)} objects; card busy {busy:.4f}s ({share}); "
          f"{sum(c for _, c in by_name.values())} kernel launches", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
