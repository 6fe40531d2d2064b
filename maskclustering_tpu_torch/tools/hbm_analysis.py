"""Device memory of the fused multi-device step at the honest bucket (the
port's ``scripts/hbm_analysis.py``).

The JAX tool reads XLA's memory plan of the compiled step per chip. The
port compiles nothing, so it runs the fused step
(``parallel/sharded.build_fused_step``) once under the cost observatory's
census (``obs/cost.observe_costs``) at the honest ScanNet operating point
(250 -> 256 frames, 480x640, 196,608 points, ``k_max`` 63) over a
(scene=1, frame=8) mesh, on the bench's scene rendered at that bucket
(``make_scene_device``), and reports what the census and its lane peaks
give: argument and output bytes, the peak of the whole step (on one card
repeated over the mesh, every coordinate's share is on that card), that
peak per mesh coordinate, the cross-coordinate copies and the op census.
The headroom is read against the card's own ``total_memory`` (the host's
RAM on the CPU); exit 0 when the per-coordinate headroom is positive, 1
when not, 2 when the step failed::

    python -m maskclustering_tpu_torch.tools.hbm_analysis [--frames 256] [--device cpu] [--out -]

On the card unless ``--device`` names another device; asked for the card on
a host without one, it raises.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np


def device_memory_bytes(dev) -> int:
    """The card's ``total_memory``, or the host's physical RAM on the CPU."""
    import torch

    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m maskclustering_tpu_torch.tools.hbm_analysis")
    p.add_argument("--scenes", type=int, default=1)
    p.add_argument("--frames", type=int, default=256,
                   help="honest bucket 250 rounds to the next multiple of 8")
    p.add_argument("--points", type=int, default=196608)
    p.add_argument("--image-h", type=int, default=480)
    p.add_argument("--image-w", type=int, default=640)
    p.add_argument("--k-max", type=int, default=63)
    p.add_argument("--mesh", type=int, nargs=2, default=(1, 8), metavar=("SCENE", "FRAME"))
    p.add_argument("--out", default="-", help="markdown output path, or - for stdout only")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    args = p.parse_args(argv)

    import torch

    from maskclustering_tpu_torch.config import PipelineConfig
    from maskclustering_tpu_torch.device import resolve_device
    from maskclustering_tpu_torch.obs.cost import observe_costs

    dev = resolve_device(args.device)
    cfg = PipelineConfig(config_name="hbm_analysis", dataset="demo", distance_threshold=0.01,
                         few_points_threshold=25, point_chunk=8192)
    s, f = args.scenes, args.frames
    if f % args.mesh[1]:
        f = -(-f // args.mesh[1]) * args.mesh[1]
        print(f"[hbm] frames {args.frames} -> {f} (next multiple of the frame mesh dim "
              f"{args.mesh[1]})", file=sys.stderr, flush=True)
    h, w, n = args.image_h, args.image_w, args.points
    mesh = (s, args.mesh[1])
    print(f"[hbm] fused step under the census: S={s} F={f} {h}x{w} N={n} k_max={args.k_max} "
          f"mesh={mesh} on {dev}", file=sys.stderr, flush=True)
    # the bench's scene at this bucket, rendered on the device, as the step's
    # (S, ...) host arrays
    from maskclustering_tpu_torch.io.feed import host_frames
    from maskclustering_tpu_torch.utils.synthetic import make_scene_device, resize_scene_points

    tensors, _, _ = make_scene_device(num_boxes=36, num_frames=f, image_hw=(h, w),
                                      spacing=0.025, seed=0, device=dev)
    batch = tuple(np.stack([a] * s) for a in (
        resize_scene_points(tensors.scene_points, n), host_frames(tensors.depths, "hbm.frames"),
        host_frames(tensors.segmentations, "hbm.frames"), tensors.intrinsics,
        tensors.cam_to_world, tensors.frame_valid))
    rows = observe_costs([mesh], stages=("fused",), frames=f, points=n, image_hw=(h, w),
                         k_max=args.k_max, cfg=cfg, device=dev, batch=batch)
    row = rows[0] if rows else {"error": "no row"}
    if "error" in row:
        print(f"[hbm] the fused step failed: {row['error']}", file=sys.stderr)
        return 2

    def gb(x):
        return x / (1 << 30)

    coords = int(row["devices"])
    peak = float(row["peak_bytes"])
    per_coord = peak / coords
    total = device_memory_bytes(dev)
    headroom = gb(total - per_coord)
    what = (f"{torch.cuda.get_device_name(dev)} total_memory" if dev.type == "cuda"
            else "host RAM (cpu)")
    lines = [
        f"shape: S={s} F={f} {h}x{w} N={n} k_max={args.k_max} "
        f"mesh=(scene={mesh[0]},frame={mesh[1]}) on {dev}",
        f"argument_size: {gb(row['arg_bytes']):.3f} GB (the whole mesh)",
        f"output_size:   {gb(row['out_bytes']):.3f} GB (the whole mesh)",
        f"peak:          {gb(peak):.3f} GB for all {coords} coordinates on this device",
        f"per coordinate: {gb(per_coord):.3f} GB ({what} {gb(total):.1f} GB -> headroom "
        f"{headroom:.1f} GB)",
    ]
    census = row.get("collectives") or {}
    if census:
        lines.append("collectives: " + ", ".join(
            f"{op} x{int(c['count'])} ({c['bytes']:.0f} B)" for op, c in sorted(census.items()))
            + f" -> cross-coordinate payload {row['ici_bytes']:.0f} B")
    else:
        lines.append("collectives: none (no cross-coordinate copies)")
    ops = row.get("ops") or {}
    lines.append(f"op census: {ops.get('fusion', 0)} launches, {ops.get('copy', 0)} copies, "
                 f"{ops.get('transpose', 0)} transposes; flops {row.get('flops')}, "
                 f"bytes {row.get('hbm_bytes')}")
    print("\n".join(lines))
    if args.out != "-":
        out_dir = os.path.dirname(args.out)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write("\n".join(lines) + "\n")
    print(f"[hbm] {'OK' if headroom > 0 else 'FAIL'}: headroom {headroom:.1f} GB a coordinate",
          flush=True)
    return 0 if headroom > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
