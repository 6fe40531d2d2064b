#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Imports nothing of JAX or of the JAX package. In order:

1. card: its name and power limit (nvidia-smi) and torch's device name;
2. build: every CUDA kernel of the port, from the sources in this checkout;
3. kernels against their plain torch versions on the card, bit-equal, on
   edge cases (ragged lengths with empty rows, a single candidate, scan
   order rather than nearest, batches larger than the TPU's batch chunk,
   full rows that stop early, k above every row's hit count);
4. the slice at full size through ``models.run_scene``: a 480x640 synthetic
   scan of 371,180 points, 32 frames, 2 mm depth noise, scannet thresholds,
   the reference radius 0.01, exact ball-query association, host
   post-process, on ``cuda``; every kernel of the path must have launched;
5. each kernel timed with CUDA events at the largest shape the full-size
   run gave it, beside its plain version and its bound;
6. a mid-size scene on ``cuda`` and on ``cpu``: equal artifact digests.

Any mismatch or failure exits non-zero. The last three lines are the card
line, the per-kernel JSON and the result JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# NVIDIA's H100 SXM data sheet (dense, no sparsity), at its 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# per ball-query pair test: 3 subtractions, 3 multiplications, 2 additions
# and the radius comparison
BALL_QUERY_OPS_PER_PAIR = 9


def _say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ball_query_edge_cases():
    """(name, q, c, ql, cl, k, radius) numpy cases of the kernel contract."""
    import numpy as np

    rng = np.random.default_rng(1)
    cases = []
    b, p, s = 4, 70, 260
    cases.append(("ragged, ql=0 and cl=1",
                  rng.uniform(-1, 1, (b, p, 3)).astype(np.float32),
                  rng.uniform(-1, 1, (b, s, 3)).astype(np.float32),
                  np.array([70, 33, 0, 64], np.int32), np.array([260, 100, 50, 1], np.int32),
                  6, 0.4))
    cases.append(("scan order, not nearest", np.zeros((1, 1, 3), np.float32),
                  np.array([[[0.3, 0, 0], [0.1, 0, 0], [0.2, 0, 0]]], np.float32),
                  np.array([1], np.int32), np.array([3], np.int32), 2, 0.5))
    b, p, s = 10, 16, 40
    cases.append(("batch above the TPU batch chunk",
                  rng.uniform(-1, 1, (b, p, 3)).astype(np.float32),
                  rng.uniform(-1, 1, (b, s, 3)).astype(np.float32),
                  np.full(b, p, np.int32), np.full(b, s, np.int32), 4, 0.5))
    b, p, s = 3, 300, 2000
    cases.append(("full rows stop early, several candidate tiles",
                  rng.uniform(0, 0.2, (b, p, 3)).astype(np.float32),
                  rng.uniform(0, 0.2, (b, s, 3)).astype(np.float32),
                  np.array([300, 129, 255], np.int32), np.array([2000, 700, 257], np.int32),
                  20, 0.05))
    cases.append(("k above every row's hit count",
                  rng.uniform(-1, 1, (2, 50, 3)).astype(np.float32),
                  rng.uniform(-1, 1, (2, 90, 3)).astype(np.float32),
                  np.array([50, 20], np.int32), np.array([90, 90], np.int32), 64, 0.2))
    return cases


def check_ball_query_edges(dev) -> None:
    import numpy as np
    import torch

    from maskclustering_tpu_torch.ops.neighbor import ball_query, ball_query_reference

    for name, q, c, ql, cl, k, r in ball_query_edge_cases():
        args = [torch.from_numpy(a).to(dev) for a in (q, c, ql, cl)]
        got = ball_query(*args, k=k, radius=r)
        want = ball_query_reference(*args, k=k, radius=r)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"ball_query kernel != plain version on '{name}': "
                                 f"{bad} slots differ")
        if not np.array_equal(want.cpu().numpy(), ball_query_reference(
                *[torch.from_numpy(a) for a in (q, c, ql, cl)], k=k, radius=r).numpy()):
            raise AssertionError(f"plain ball query differs between cuda and cpu on '{name}'")
        _say(f"  ball_query == plain on '{name}' {tuple(q.shape)}x{tuple(c.shape)} k={k}")


def largest_group_inputs(tensors, cfg, shape):
    """The real padded inputs of the first ball-query group of ``shape``
    (B, P_pad, S_pad) that the scene's association builds."""
    import numpy as np

    from maskclustering_tpu_torch.models.exact_backprojection import (
        ball_query_groups,
        frame_mask_candidates,
    )

    pts = np.asarray(tensors.scene_points, dtype=np.float64)
    for fi in range(tensors.num_frames):
        if not tensors.frame_valid[fi]:
            continue
        cands = frame_mask_candidates(
            pts, tensors.depths[fi], tensors.segmentations[fi], tensors.intrinsics[fi],
            tensors.cam_to_world[fi], distance_threshold=cfg.distance_threshold,
            depth_trunc=cfg.depth_trunc, few_points_threshold=cfg.few_points_threshold,
            denoise_eps=cfg.denoise_eps, denoise_min_points=cfg.denoise_min_points)
        if not cands:
            continue
        for _, q, c, ql, cl in ball_query_groups([x[1] for x in cands], [x[2] for x in cands]):
            if (q.shape[0], q.shape[1], c.shape[1]) == tuple(shape):
                return fi, q, c, ql, cl
    raise AssertionError(f"no ball-query group of shape {shape} found on a second pass")


def time_ball_query(dev, q, c, ql, cl, k, radius):
    """Kernel and plain-version times, bound and agreement at one real group."""
    import torch

    from maskclustering_tpu_torch.ops.cuda import ball_query_cuda
    from maskclustering_tpu_torch.ops.neighbor import ball_query_reference

    args = [torch.from_numpy(a).to(dev) for a in (q, c, ql, cl)]
    got = ball_query_cuda(*args, k=k, radius=radius)
    want = ball_query_reference(*args, k=k, radius=radius)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"ball_query kernel != plain version at {tuple(q.shape)}: "
                             f"{int((got != want).sum())} slots differ")
    max_abs_err = float((got.long() - want.long()).abs().max()) if got.numel() else 0.0
    ms = cuda_time_ms(lambda: ball_query_cuda(*args, k=k, radius=radius), reps=20)
    plain_ms = cuda_time_ms(lambda: ball_query_reference(*args, k=k, radius=radius), reps=3,
                            warmup=1)

    # work these inputs need: each valid row scans candidates up to its k-th
    # hit (the candidate index of slot k-1, plus one) or to the end
    out = want.cpu().long()
    b, p, _ = q.shape
    pairs = 0
    for bi in range(b):
        rows = out[bi, : int(ql[bi])]
        full = rows[:, k - 1] >= 0
        pairs += int((rows[full, k - 1] + 1).sum()) + int((~full).sum()) * int(cl[bi])
    ops = pairs * BALL_QUERY_OPS_PER_PAIR
    nbytes = q.nbytes + c.nbytes + ql.nbytes + cl.nbytes + b * p * k * 4
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": max_abs_err,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "pair_tests": pairs, "bytes": nbytes}


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "maskclustering_tpu_torch")):
        print("chip_smoke: the maskclustering_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    import numpy as np

    from maskclustering_tpu_torch.config import load_config
    from maskclustering_tpu_torch.models import run_scene
    from maskclustering_tpu_torch.obs.digest import artifact_digest
    from maskclustering_tpu_torch.ops import cuda as kernels
    from maskclustering_tpu_torch.utils.synthetic import (
        add_depth_noise,
        make_scene,
        to_scene_tensors,
    )

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    _say(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    # 2. build
    t0 = time.perf_counter()
    built = kernels.build()
    _say(f"[build] {len(kernels.KERNELS)} kernel(s) in {time.perf_counter() - t0:.2f} s "
         f"(nvcc per kernel: {json.dumps({k: round(v, 2) for k, v in built.items()})})")

    # 3. kernels against their plain versions on edge cases
    _say("[kernels] edge cases")
    check_ball_query_edges(dev)

    # 4. the slice at full size
    t0 = time.perf_counter()
    scene = make_scene(num_boxes=8, num_frames=32, image_hw=(480, 640), spacing=0.008,
                       floor_spacing=0.016, seed=0)
    add_depth_noise(scene, sigma=0.002, seed=1000)
    tensors = to_scene_tensors(scene)
    _say(f"[slice] scene built in {time.perf_counter() - t0:.1f} s: "
         f"N={tensors.num_points} F={tensors.num_frames} HxW={tensors.depths.shape[1:]}")
    cfg = load_config("scannet", config_name="chip_smoke", distance_threshold=0.01,
                      use_exact_ball_query=True, device_postprocess=False)
    kernels.LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = run_scene(tensors, cfg, k_max=63, seq_name="chip_smoke_full", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES.counts)
    shapes = {k: dict(v) for k, v in kernels.LAUNCHES.shapes.items()}
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    tm = res.timings
    n_obj = len(res.objects.point_ids_list)
    digest = artifact_digest(res.objects)
    _say(f"[slice] N={tensors.num_points} F={tensors.num_frames} M_pad={res.table.m_pad} "
         f"masks={res.table.num_masks} objects={n_obj} digest={digest} wall={wall:.2f} s "
         f"peak_device_mem={peak_mib:.1f} MiB")
    _say("[slice] stage walls (s): " + json.dumps(
        {"associate.host": round(tm["associate"] - tm.get("associate.ball_query", 0.0), 3),
         **{k: round(v, 3) for k, v in tm.items()}}))
    _say(f"[slice] kernel launches: {json.dumps(launches)}; shapes: "
         + json.dumps({k: {str(s): n for s, n in v.items()} for k, v in shapes.items()}))
    missing = [k for k in kernels.KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing} kernel")
    if n_obj == 0:
        raise AssertionError("the full-size scene produced no objects")
    for pids in res.objects.point_ids_list:
        if pids.size == 0 or int(pids.min()) < 0 or int(pids.max()) >= tensors.num_points:
            raise AssertionError("an object holds point ids outside the scene")
    if not np.isfinite(tensors.scene_points).all():
        raise AssertionError("non-finite scene points")

    # 5. kernels timed at the largest shape the main path gave them
    big = max(shapes["ball_query"], key=lambda s: s[0] * s[1] * s[2])
    fi, q, c, ql, cl = largest_group_inputs(tensors, cfg, big)
    bq = time_ball_query(dev, q, c, ql, cl, k=20, radius=cfg.distance_threshold)
    _say(f"[kernels] ball_query at {big} (frame {fi}): kernel {bq['ms']:.4f} ms, "
         f"plain {bq['plain_ms']:.4f} ms, bound {bq['bound_ms']:.5f} ms ({bq['bound_by']}: "
         f"{bq['pair_tests']} pair tests, {bq['bytes']} bytes), "
         f"{launches['ball_query']} launches per scene")

    # 6. card against cpu on a mid-size scene
    mid = to_scene_tensors(make_scene(num_boxes=4, num_frames=12, image_hw=(240, 320), seed=1))
    mid_cfg = load_config("scannet", config_name="chip_smoke_mid", distance_threshold=0.03,
                          few_points_threshold=10, use_exact_ball_query=True,
                          device_postprocess=False)
    on_card = run_scene(mid, mid_cfg, seq_name="mid", device=dev)
    on_cpu = run_scene(mid, mid_cfg, seq_name="mid", device="cpu")
    d_card, d_cpu = artifact_digest(on_card.objects), artifact_digest(on_cpu.objects)
    _say(f"[mid] objects cuda={len(on_card.objects.point_ids_list)} "
         f"cpu={len(on_cpu.objects.point_ids_list)} digest cuda={d_card} cpu={d_cpu}")
    if d_card != d_cpu or not np.array_equal(on_card.assignment, on_cpu.assignment):
        raise AssertionError("cuda and cpu runs of the mid-size scene differ")
    if not on_card.objects.point_ids_list:
        raise AssertionError("the mid-size scene produced no objects")

    _say(f"[done] {time.perf_counter() - t_start:.1f} s")
    _say(card)
    _say(json.dumps({"kernels": [{
        "name": "ball_query", "route": "cuda",
        "source": "maskclustering_tpu_torch/ops/cuda/ball_query.cu",
        "replaces": "maskclustering_tpu/ops/pallas/ball_query.py:127",
        "launches": launches["ball_query"], "max_abs_err": bq["max_abs_err"],
        "ms": bq["ms"], "plain_ms": bq["plain_ms"], "bound_ms": bq["bound_ms"],
        "bound_by": bq["bound_by"], "library_ms": None}]}))
    _say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
