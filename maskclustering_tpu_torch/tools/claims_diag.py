"""Attribute the post-process's ``post.claims`` time: the node-stats kernel
against the device-to-host drain (the port's ``scripts/claims_diag.py``).

It replays the bench's scene (``make_scene_device``: 36 boxes, 250 frames
of 480x640 rendered on the card, 196,608 points) through associate ->
graph -> cluster (``models.pipeline.run_scene_device``), then times, each
with CUDA events on the card, over 5 repeats after a warm call:

  kernel        the node statistics alone (``_prep_kernel`` +
                ``_node_stats_kernel``, ``models/postprocess_device.py``)
  postprocess   the whole device post-process (its emit-only drain)
  pull_plane16  a pull of one (F, N) int16 claim plane: the unit the host
                rung pulls twice a scene, the device rung never
  pull_calib    a pull of a device buffer of the emit drain's byte size

and prints the bytes the drain moved (``d2h.bytes.post.drain``, booked by
the path itself) beside the claim plane's::

    python -m maskclustering_tpu_torch.tools.claims_diag [--frames 250 --points 196608 --boxes 36]

On the card unless ``--device`` names another device (on the CPU the times
are the host clock's); asked for the card on a host without one, it raises.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np


def time_ms(name: str, fn, device, iters: int = 5) -> float:
    """Median ms of ``fn()`` over ``iters`` calls after one warm call: CUDA
    events on a card, the host clock elsewhere. Prints the runs."""
    import torch

    fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            torch.cuda.synchronize(device)
            times.append(t0.elapsed_time(t1))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(times))
    print(f"  {name:14s} {med:9.3f} ms  (runs: " + " ".join(f"{t:.3f}" for t in times) + ")",
          flush=True)
    return med


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m maskclustering_tpu_torch.tools.claims_diag")
    p.add_argument("--frames", type=int, default=250)
    p.add_argument("--points", type=int, default=196608)
    p.add_argument("--boxes", type=int, default=36)
    p.add_argument("--image-h", type=int, default=480)
    p.add_argument("--image-w", type=int, default=640)
    p.add_argument("--k-max", type=int, default=63)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    args = p.parse_args(argv)

    import torch

    from maskclustering_tpu_torch.config import PipelineConfig
    from maskclustering_tpu_torch.device import resolve_device, synchronize
    from maskclustering_tpu_torch.models.pipeline import run_scene_device
    from maskclustering_tpu_torch.models.postprocess_device import (
        _bucket_pow2,
        _live_count_kernel,
        _node_stats_kernel,
        _prep_kernel,
        _rep_bucket,
        run_postprocess,
    )
    from maskclustering_tpu_torch.obs.metrics import registry
    from maskclustering_tpu_torch.utils.synthetic import make_scene_device, resize_scene_points

    dev = resolve_device(args.device)
    cfg = PipelineConfig(config_name="bench", dataset="demo", distance_threshold=0.01,
                         few_points_threshold=25, point_chunk=8192, donate_buffers=False)
    print(f"[claims_diag] scene: F={args.frames} N={args.points} boxes={args.boxes} on {dev}",
          flush=True)
    tensors, _, _ = make_scene_device(num_boxes=args.boxes, num_frames=args.frames,
                                      image_hw=(args.image_h, args.image_w), spacing=0.025,
                                      seed=0, device=dev)
    tensors.scene_points = resize_scene_points(tensors.scene_points, args.points)

    # associate -> graph -> cluster, exactly as pipeline.run_scene
    h = run_scene_device(tensors, cfg, k_max=args.k_max, device=dev)
    f, n = h.first_id.shape
    k2 = args.k_max + 2
    live = int(_live_count_kernel(h.assignment, h.active,
                                  min_masks_per_object=cfg.min_masks_per_object))
    if live == 0:
        print(f"[claims_diag] OK: no live reps on {dev} — nothing to time", flush=True)
        return 0
    r_pad = _rep_bucket(live)
    frame_d = torch.from_numpy(h.table.frame).to(dev)
    mask_id_d = torch.from_numpy(h.table.mask_id).to(dev)
    print(f"[claims_diag] reps={live} r_pad={r_pad} plane={(r_pad * (n // 8)) / 1e6:.2f} MB",
          flush=True)

    def kernel():
        rep_tab, live_slots, live_valid, *_ = _prep_kernel(
            h.assignment, h.active, frame_d, mask_id_d, r_pad=r_pad, f=f, k2=k2,
            min_masks_per_object=cfg.min_masks_per_object)
        out = _node_stats_kernel(h.first_id, h.last_id, rep_tab, h.node_visible, live_slots,
                                 live_valid, r_pad=r_pad,
                                 point_filter_threshold=float(cfg.point_filter_threshold),
                                 count_dtype=cfg.count_dtype)
        synchronize(dev)
        return out

    def postprocess():
        return run_postprocess(cfg, h.scene_points, h.first_id, h.last_id, h.table.frame,
                               h.table.mask_id, h.active, h.assignment, h.node_visible,
                               h.frame_ids, k_max=args.k_max, n_real=h.n_real)

    # the drain bytes the path books (obs counters are unconditional)
    postprocess()
    registry().reset()
    objects = postprocess()
    emit_b = int(registry().snapshot()["counters"].get("d2h.bytes.post.drain", 0))
    registry().reset()
    o = len(objects.point_ids_list)
    o_pad = _bucket_pow2(o, minimum=8)
    emit_mb = emit_b / 1e6
    calib_src = torch.zeros((max(emit_b, 1),), dtype=torch.uint8, device=dev)

    assert h.first_id.dtype == torch.int16, h.first_id.dtype
    plane_mb = (f * n * 2) / 1e6
    print("[claims_diag] timings (median of 5):", flush=True)
    t_kernel = time_ms("kernel", kernel, dev)
    t_post = time_ms("postprocess", postprocess, dev)
    t_plane = time_ms("pull_plane16", lambda: h.first_id.cpu(), dev)
    t_calib = time_ms("pull_calib", lambda: calib_src.cpu(), dev)
    print(f"[claims_diag] kernel={t_kernel:.3f}ms postprocess={t_post:.3f}ms "
          f"calib({emit_mb:.2f}MB)={t_calib:.3f}ms -> link "
          f"{emit_mb / max(t_calib / 1e3, 1e-9):.1f} MB/s", flush=True)
    print(f"[claims_diag] emit-only drain: {emit_mb:.2f} MB/scene ({o} objects -> {o_pad} x "
          f"{n // 8}B packed planes + {o}x{o} inter + O(M+S) scalars); claim planes stay on "
          f"the device", flush=True)
    print(f"[claims_diag] int16 claim plane pull: {plane_mb:.1f} MB/plane x2/scene on the "
          f"host-postprocess path (int32 layout would be {plane_mb * 2:.1f} MB) in "
          f"{t_plane:.3f}ms -> {plane_mb / max(t_plane / 1e3, 1e-9):.1f} MB/s; the emit-only "
          f"drain moves {emit_mb:.2f} MB instead ({2 * plane_mb / max(emit_mb, 1e-9):.0f}x less)",
          flush=True)
    print(f"[claims_diag] OK: drain {emit_b} bytes, {o} objects on {dev}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
