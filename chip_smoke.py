#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Imports nothing of JAX or of the JAX package. In order:

1. card: its name and power limit (nvidia-smi) and torch's device name;
2. build: every CUDA kernel of the port, from the sources in this checkout;
3. kernels against their plain torch versions on the card, bit-equal, on
   the edge cases of ``ops/neighbor_cases.py`` (ragged lengths with empty
   rows, scan order rather than nearest, rows that fill in the middle of a
   warp step or exactly, k = 1, partial warps and blocks, S not a multiple
   of 4, partial last steps, no candidates, many tiles through the ring of
   buffers, blocks that stop with copies in flight);
4. the slice at full size through ``models.run_scene``: a 480x640 synthetic
   scan of 371,180 points, 32 frames, 2 mm depth noise, scannet thresholds,
   the reference radius 0.01, exact ball-query association, host
   post-process, on ``cuda``; every kernel of the path must have launched.
   The padded inputs of every ball-query group it launched are kept;
5. the ball-query kernel bit-equal to its plain version on every one of
   those groups; timed with CUDA events at the largest group beside its
   plain version, its bound and the no-FMA ceiling, and summed over the
   scene's groups;
6. a mid-size scene on ``cuda`` and on ``cpu``: equal artifact digests;
7. the association kernels (``ops/cuda/associate.cu``) bit-equal to their
   plain versions on the edge cases of ``ops/association_cases.py`` (points
   behind the camera, footprints off every border, pixel centres on .5,
   claim distances at and a few ulps around r2, windows 0-3, k_max 63 and
   1023, an invalid frame, N not a multiple of the block), and the whole
   frame on ``cuda`` equal to ``cpu``; ``torch.addcmul`` on the card rounds
   once, as on the CPU;
8. the default configuration (dense association, device post-process) at
   full size through ``models.run_scene``: the scene of phase 4,
   ``distance_threshold`` 0.01, ``k_max`` 63, ``post_neighbor_cap`` raised
   to the smallest power of two that holds the scene's largest DBSCAN
   degree (printed). Every frame's kernel inputs are kept; both kernels
   must have launched on every padded frame, and are bit-equal to their
   plain versions on every frame and timed per frame with CUDA events,
   beside the plain versions and the bound. One more run under
   ``torch.profiler`` gives the card's busy share of the scene and the
   kernels that take most of it (trace in ``build/dense_trace.json``);
9. the default configuration on the mid-size scene of phase 6 on ``cuda``
   and on ``cpu``: equal artifact digests and assignments.

Any mismatch or failure exits non-zero. The last three lines are the card
line, the per-kernel JSON and the result JSON.
"""

from __future__ import annotations

import contextlib
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
# the share of that bound a kernel without fused multiply-adds can reach:
# the FP32 peak above counts an FMA as two operations
NO_FMA_CEILING = 0.5
# FP32 operations of the claim kernel (associate.cu), an FMA counted as two
# and comparisons not at all: per point the rotation (3 multiplies, 6 FMAs,
# 3 additions = 18) and the projection (2 divisions, 2 FMAs = 6); per
# window pixel the backprojection (2 subtractions, 2 multiplies, 2
# divisions), the difference (3 subtractions) and the squared distance (a
# multiply and 2 FMAs) = 14
CLAIM_OPS_PER_POINT = 24
CLAIM_OPS_PER_PIXEL = 14
# phase 8's DBSCAN neighbour table: the smallest power of two holding the
# full-size scene's largest same-rep degree (the default, 256, does not)
FULL_NEIGHBOR_CAP = 1024


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


def check_ball_query_edges(dev) -> None:
    import numpy as np
    import torch

    from maskclustering_tpu_torch.ops.neighbor import ball_query, ball_query_reference
    from maskclustering_tpu_torch.ops.neighbor_cases import BALL_QUERY_CASES, ball_query_case

    for name in BALL_QUERY_CASES:
        q, c, ql, cl, k, r = ball_query_case(name)
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


@contextlib.contextmanager
def recording_ball_query_groups(groups: list):
    """Keep, in ``groups``, the padded host inputs ``(q, c, ql, cl, k,
    radius)`` of every ball-query group the exact association launches
    while the context is open."""
    from maskclustering_tpu_torch.models import exact_backprojection

    launch = exact_backprojection._ball_query_group

    def record(q, c, ql, cl, k, radius, device):
        groups.append((q, c, ql, cl, k, radius))
        return launch(q, c, ql, cl, k, radius, device)

    exact_backprojection._ball_query_group = record
    try:
        yield groups
    finally:
        exact_backprojection._ball_query_group = launch


def pair_tests(out, ql, cl, k: int, s: int) -> int:
    """The pair tests these inputs need: each valid row scans candidates up
    to its k-th hit (the candidate index in slot k-1, plus one) or to the
    end of its candidates."""
    total = 0
    for bi in range(out.shape[0]):
        rows = out[bi, : max(0, min(int(ql[bi]), out.shape[1]))]
        full = rows[:, k - 1] >= 0
        total += (int((rows[full, k - 1].astype("int64") + 1).sum())
                  + int((~full).sum()) * max(0, min(int(cl[bi]), s)))
    return total


def bound_ms(ops: int, nbytes: int):
    """(least ms on the card, what bounds it) for ``ops`` FP32 operations
    moving ``nbytes``."""
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_and_time_groups(dev, groups):
    """Phase 5 over the scene's ball-query groups: the kernel bit-equal to
    the plain version on every group; its time at the largest group (20
    launches) beside the plain version's (3) and the bound; its time summed
    over all groups (3 launches each after one warm-up)."""
    import numpy as np
    import torch

    from maskclustering_tpu_torch.ops.cuda import ball_query_cuda
    from maskclustering_tpu_torch.ops.neighbor import ball_query_reference

    on_card = []
    pairs_sum = bytes_sum = 0
    max_abs_err = 0.0
    for gi, (q, c, ql, cl, k, r) in enumerate(groups):
        args = [torch.from_numpy(a).to(dev) for a in (q, c, ql, cl)]
        got = ball_query_cuda(*args, k=k, radius=r)
        want = ball_query_reference(*args, k=k, radius=r)
        if not torch.equal(got, want):
            raise AssertionError(f"ball_query kernel != plain version on scene group {gi} "
                                 f"{tuple(q.shape)}x{tuple(c.shape)}: "
                                 f"{int((got != want).sum())} slots differ")
        if got.numel():
            max_abs_err = max(max_abs_err, float((got.long() - want.long()).abs().max()))
        out = want.cpu().numpy()
        pairs = pair_tests(out, ql, cl, k, c.shape[1])
        nbytes = q.nbytes + c.nbytes + ql.nbytes + cl.nbytes + out.nbytes
        pairs_sum += pairs
        bytes_sum += nbytes
        on_card.append((args, k, r, pairs, nbytes))
    # the largest group by padded shape; the heaviest in pair tests may be
    # another, and the scene sum below times every group
    big = max(range(len(groups)), key=lambda i: int(np.prod(groups[i][0].shape[:2]))
              * groups[i][1].shape[1])

    def kernel(i):
        args, k, r = on_card[i][:3]
        return lambda: ball_query_cuda(*args, k=k, radius=r)

    args, k, r, pairs, nbytes = on_card[big]
    res = {"group": big, "shape": tuple(args[0].shape[:2]) + (args[1].shape[1],),
           "ms": cuda_time_ms(kernel(big), reps=20),
           "plain_ms": cuda_time_ms(lambda: ball_query_reference(*args, k=k, radius=r), reps=3,
                                    warmup=1),
           "scene_ms": sum(cuda_time_ms(kernel(i), reps=3, warmup=1)
                           for i in range(len(on_card))),
           "max_abs_err": max_abs_err,
           "pair_tests": pairs, "bytes": nbytes, "scene_pair_tests": pairs_sum,
           "scene_bytes": bytes_sum}
    res["bound_ms"], res["bound_by"] = bound_ms(pairs * BALL_QUERY_OPS_PER_PAIR, nbytes)
    res["scene_bound_ms"], res["scene_bound_by"] = bound_ms(
        pairs_sum * BALL_QUERY_OPS_PER_PAIR, bytes_sum)
    return res


def check_addcmul(dev) -> int:
    """``torch.addcmul`` (the plain versions' FMA) rounds once on the card,
    as on the CPU; returns how many of a million products an unfused
    multiply-add rounds otherwise."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    a, b, c = (torch.from_numpy(rng.standard_normal(1000003).astype(np.float32))
               for _ in range(3))
    on_cpu = torch.addcmul(c, a, b)
    on_card = torch.addcmul(c.to(dev), a.to(dev), b.to(dev)).cpu()
    if not torch.equal(on_card, on_cpu):
        raise AssertionError(f"addcmul differs between cuda and cpu on "
                             f"{int((on_card != on_cpu).sum())} elements")
    return int((a * b + c != on_cpu).sum())


def _frame_tensors(case, dev):
    import numpy as np
    import torch

    t = [torch.from_numpy(np.asarray(case[k])).to(dev)
         for k in ("points", "depth", "seg", "intrinsics", "cam_to_world")]
    return (*t, torch.tensor(case["frame_valid"]).to(dev))


def check_association_edges(dev) -> None:
    """Phase 7: both association kernels bit-equal to their plain versions
    on the card, and the whole frame on the card equal to the CPU."""
    import torch

    from maskclustering_tpu_torch.models import backprojection as bp
    from maskclustering_tpu_torch.ops.association_cases import CASES, association_case
    from maskclustering_tpu_torch.ops.cuda import associate_assign_cuda, associate_claim_cuda
    from maskclustering_tpu_torch.ops.geometry import invert_se3

    kw_names = ("k_max", "window", "distance_threshold", "depth_trunc",
                "few_points_threshold", "coverage_threshold")
    for name in CASES:
        case = association_case(name)
        pts, depth, seg, intr, c2w, fv = _frame_tensors(case, dev)
        prm = bp.claim_params(intr, invert_se3(c2w), distance_threshold=case["distance_threshold"],
                              depth_trunc=case["depth_trunc"])
        k_max, window = case["k_max"], case["window"]
        cand, n_claimed = associate_claim_cuda(pts, depth, seg, prm, k_max=k_max, window=window)
        want_cand, want_n = bp.claim_candidates_reference(pts, depth, seg, prm, k_max=k_max,
                                                          window=window)
        mask_valid = torch.rand(k_max + 1, device=dev) < 0.7
        got = associate_assign_cuda(cand, mask_valid, k_max=k_max)
        want = bp.assign_claims_reference(cand, mask_valid, k_max=k_max)
        torch.cuda.synchronize()
        bad = [what for what, g, w in zip(("cand", "n_claimed", "mask_of_point", "first", "last"),
                                          (cand, n_claimed, *got), (want_cand, want_n, *want))
               if not torch.equal(g, w)]
        kw = {k: case[k] for k in kw_names}
        on_card = bp.associate_frame(pts, depth, seg, intr, c2w, fv, None, **kw)
        on_cpu = bp.associate_frame(*_frame_tensors(case, "cpu"), None, **kw)
        bad += [f"frame {f}" for f in on_cpu._fields
                if not torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f))]
        if bad:
            raise AssertionError(f"association kernels != plain version on '{name}': {bad}")
        _say(f"  associate_claim/assign == plain on '{name}' N={pts.shape[0]} "
             f"HxW={tuple(depth.shape)} window={window} k_max={k_max}; frame cuda == cpu")


@contextlib.contextmanager
def recording_association_frames(frames: list):
    """Keep, in ``frames``, the inputs of every claim and assignment step
    the dense association runs while the context is open (one dict a
    frame), and the DBSCAN degrees of the post-process."""
    from maskclustering_tpu_torch.models import backprojection as bp
    from maskclustering_tpu_torch.ops import grid_dbscan as gd

    claim, assign, pack = bp.claim_candidates, bp.assign_claims, gd.pack_neighbors

    def rec_claim(scene_points, depth, seg, params, *, k_max, window=1):
        frames.append({"claim": (scene_points, depth, seg, params, k_max, window)})
        return claim(scene_points, depth, seg, params, k_max=k_max, window=window)

    def rec_assign(cand, mask_valid, *, k_max):
        frames[-1]["assign"] = (cand, mask_valid, k_max)
        return assign(cand, mask_valid, k_max=k_max)

    def rec_pack(*args, **kw):
        nb, degree = pack(*args, **kw)
        frames.append({"degree": degree.max()})
        return nb, degree

    bp.claim_candidates, bp.assign_claims, gd.pack_neighbors = rec_claim, rec_assign, rec_pack
    try:
        yield frames
    finally:
        bp.claim_candidates, bp.assign_claims, gd.pack_neighbors = claim, assign, pack


def check_and_time_frames(frames):
    """Phase 8 over the scene's frames: both kernels bit-equal to their
    plain versions on every frame, timed per frame (10 launches after a
    warm-up; the plain versions 2), with each frame's bound."""
    import torch

    from maskclustering_tpu_torch.models import backprojection as bp
    from maskclustering_tpu_torch.ops.cuda import associate_assign_cuda, associate_claim_cuda

    rows = {"associate_claim": [], "associate_assign": []}
    max_abs_err = 0
    for fi, fr in enumerate(frames):
        pts, depth, seg, prm, k_max, window = fr["claim"]
        cand_in, mask_valid, _ = fr["assign"]
        cand, n_claimed = associate_claim_cuda(pts, depth, seg, prm, k_max=k_max, window=window)
        want_cand, want_n = bp.claim_candidates_reference(pts, depth, seg, prm, k_max=k_max,
                                                          window=window)
        got = associate_assign_cuda(cand_in, mask_valid, k_max=k_max)
        want = bp.assign_claims_reference(cand_in, mask_valid, k_max=k_max)
        bad = [what for what, g, w in zip(("cand", "n_claimed", "mask_of_point", "first", "last"),
                                          (cand, n_claimed, *got), (want_cand, want_n, *want))
               if not torch.equal(g, w)]
        if not torch.equal(cand, cand_in):
            bad.append("cand of the main path")
        for g, w in zip((cand, n_claimed, *got), (want_cand, want_n, *want)):
            if g.numel():
                max_abs_err = max(max_abs_err, int((g.long() - w.long()).abs().max()))
        if bad:
            raise AssertionError(f"association kernels != plain version on frame {fi}: {bad}")
        n, (h, w), k = pts.shape[0], depth.shape, cand.shape[1]
        claim_bytes = (pts.numel() * 4 + depth.numel() * 4 + seg.numel() * 4 + prm.numel() * 4
                       + cand.numel() * 2 + n_claimed.numel() * 4)
        claim_ops = n * (CLAIM_OPS_PER_POINT + k * CLAIM_OPS_PER_PIXEL)
        assign_bytes = cand.numel() * 2 + mask_valid.numel() + n * (4 + 2 + 2)
        rows["associate_claim"].append({
            "ms": cuda_time_ms(lambda: associate_claim_cuda(pts, depth, seg, prm, k_max=k_max,
                                                            window=window), reps=10),
            "plain_ms": cuda_time_ms(lambda: bp.claim_candidates_reference(
                pts, depth, seg, prm, k_max=k_max, window=window), reps=2, warmup=1),
            "bound": bound_ms(claim_ops, claim_bytes), "ops": claim_ops, "bytes": claim_bytes})
        rows["associate_assign"].append({
            "ms": cuda_time_ms(lambda: associate_assign_cuda(cand_in, mask_valid, k_max=k_max),
                               reps=10),
            "plain_ms": cuda_time_ms(lambda: bp.assign_claims_reference(
                cand_in, mask_valid, k_max=k_max), reps=2, warmup=1),
            "bound": bound_ms(0, assign_bytes), "ops": 0, "bytes": assign_bytes})
    out = {}
    for name, rs in rows.items():
        f = len(rs)
        scene_bound = bound_ms(sum(r["ops"] for r in rs), sum(r["bytes"] for r in rs))
        out[name] = {
            "ms": sum(r["ms"] for r in rs) / f, "plain_ms": sum(r["plain_ms"] for r in rs) / f,
            "bound_ms": sum(r["bound"][0] for r in rs) / f, "bound_by": rs[0]["bound"][1],
            "scene_ms": sum(r["ms"] for r in rs), "scene_plain_ms": sum(r["plain_ms"] for r in rs),
            "scene_bound_ms": scene_bound[0], "max_frame_ms": max(r["ms"] for r in rs),
            "bytes_per_frame": rs[0]["bytes"], "ops_per_frame": rs[0]["ops"], "frames": f,
            "max_abs_err": float(max_abs_err)}
    return out


def dense_default_full(dev, tensors, distance_threshold: float = 0.01):
    """Phase 8: the default configuration at full size."""
    import numpy as np
    import torch

    from maskclustering_tpu_torch.config import load_config
    from maskclustering_tpu_torch.models import run_scene
    from maskclustering_tpu_torch.obs.digest import artifact_digest
    from maskclustering_tpu_torch.ops import cuda as kernels
    from maskclustering_tpu_torch.utils.compile_cache import scene_pads

    cfg = load_config("scannet", config_name="chip_smoke_dense",
                      distance_threshold=distance_threshold, post_neighbor_cap=FULL_NEIGHBOR_CAP)
    if cfg.use_exact_ball_query or not cfg.device_postprocess:
        raise AssertionError("the scannet config's default is the dense device path")
    f_pad, n_pad = scene_pads(cfg, tensors.num_frames, tensors.num_points)
    recorded = []
    with recording_association_frames(recorded):
        kernels.LAUNCHES.reset()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = run_scene(tensors, cfg, k_max=63, seq_name="chip_smoke_dense", device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES.counts)
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    frames = [fr for fr in recorded if "claim" in fr]
    degrees = [int(fr["degree"]) for fr in recorded if "degree" in fr]
    n_obj = len(res.objects.point_ids_list)
    digest = artifact_digest(res.objects)
    _say(f"[dense] N={tensors.num_points} N_pad={n_pad} F={tensors.num_frames} F_pad={f_pad} "
         f"M_pad={res.table.m_pad} masks={res.table.num_masks} objects={n_obj} digest={digest} "
         f"wall={wall:.2f} s peak_device_mem={peak_mib:.1f} MiB")
    _say("[dense] stage walls (s): " + json.dumps({k: round(v, 4) for k, v in res.timings.items()}))
    _say(f"[dense] DBSCAN: largest same-rep degree {max(degrees, default=0)} (post_neighbor_cap "
         f"{FULL_NEIGHBOR_CAP}, default {load_config('scannet').post_neighbor_cap})")
    _say(f"[dense] kernel launches: {json.dumps(launches)}")
    for name in ("associate_claim", "associate_assign"):
        if launches.get(name, 0) != f_pad:
            raise AssertionError(f"{name} launched {launches.get(name, 0)} times, not on every "
                                 f"one of the {f_pad} padded frames")
    if launches.get("ball_query", 0):
        raise AssertionError("the dense path launched the ball query")
    if len(frames) != f_pad:
        raise AssertionError(f"{len(frames)} frames kept, {f_pad} padded frames")
    if n_obj == 0:
        raise AssertionError("the full-size default configuration produced no objects")
    for pids in res.objects.point_ids_list:
        if pids.size == 0 or int(pids.min()) < 0 or int(pids.max()) >= tensors.num_points:
            raise AssertionError("an object holds point ids outside the scene")
    if not np.isfinite(tensors.scene_points).all():
        raise AssertionError("non-finite scene points")
    t0 = time.perf_counter()
    timed = check_and_time_frames(frames)
    _say(f"[kernels] associate_claim/assign == plain on all {len(frames)} frames of the scene "
         f"({time.perf_counter() - t0:.1f} s)")
    for name, t in timed.items():
        _say(f"[kernels] {name} per frame: kernel {t['ms']:.5f} ms (slowest frame "
             f"{t['max_frame_ms']:.5f}), plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
             f"({t['bound_by']}: {t['bytes_per_frame']} bytes, {t['ops_per_frame']} FP32 ops), "
             f"{100 * t['bound_ms'] / t['ms']:.1f} % of the bound; summed over the "
             f"{t['frames']} frames: kernel {t['scene_ms']:.4f} ms, plain "
             f"{t['scene_plain_ms']:.3f} ms, bound {t['scene_bound_ms']:.5f} ms")
    profile_dense(dev, tensors, cfg, wall)
    return {"launches": launches, "timed": timed, "digest": digest, "wall": wall}


def busy_seconds(trace_path: str):
    """(seconds the card was busy, {kernel name: (ms, launches)}) from a
    chrome trace: the union of its kernel, copy and fill intervals."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    spans, by_name = [], {}
    for ev in events:
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in ev:
            spans.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
            if ev["cat"] == "kernel":
                ms, cnt = by_name.get(ev["name"], (0.0, 0))
                by_name[ev["name"]] = (ms + float(ev["dur"]) / 1e3, cnt + 1)
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy / 1e6, by_name


def profile_dense(dev, tensors, cfg, wall: float) -> None:
    """Phase 8's breakdown: one more run of the default configuration under
    ``torch.profiler``, its card-busy time against that run's own wall and
    the kernels that took most of it; and the host grid build of
    the post-process's DBSCAN alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from maskclustering_tpu_torch.models import run_scene
    from maskclustering_tpu_torch.ops.grid_dbscan import build_grid

    t0 = time.perf_counter()
    build_grid(tensors.scene_points, cfg.dbscan_split_eps)
    grid_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_scene(tensors, cfg, k_max=63, seq_name="chip_smoke_dense", device=dev)
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "dense_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    busy, by_name = busy_seconds(path)
    _say(f"[dense] host grid build (numpy, the DBSCAN's cell ranges): {grid_s:.4f} s")
    if not by_name:
        _say("[dense] card busy: not measured (the profiler trace holds no device events)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    _say(f"[dense] profiled run: wall {profiled_wall:.4f} s (unprofiled {wall:.4f} s), card busy "
         f"{busy:.4f} s = {100 * busy / profiled_wall:.1f} % of its own wall, idle "
         f"{100 * (1 - busy / profiled_wall):.1f} %; "
         f"{sum(c for _, c in by_name.values())} kernel launches")
    for name, (ms, cnt) in top:
        _say(f"  {ms:10.3f} ms {cnt:7d} x {name[:110]}")


def dense_default_mid(dev) -> str:
    """Phase 9: the default configuration on the mid-size scene, cuda
    against cpu."""
    import numpy as np

    from maskclustering_tpu_torch.config import load_config
    from maskclustering_tpu_torch.models import run_scene
    from maskclustering_tpu_torch.obs.digest import artifact_digest
    from maskclustering_tpu_torch.utils.synthetic import make_scene, to_scene_tensors

    mid = to_scene_tensors(make_scene(num_boxes=4, num_frames=12, image_hw=(240, 320), seed=1))
    cfg = load_config("scannet", config_name="chip_smoke_mid_dense", distance_threshold=0.03,
                      few_points_threshold=10)
    on_card = run_scene(mid, cfg, seq_name="mid", device=dev)
    on_cpu = run_scene(mid, cfg, seq_name="mid", device="cpu")
    d_card, d_cpu = artifact_digest(on_card.objects), artifact_digest(on_cpu.objects)
    _say(f"[mid-dense] objects cuda={len(on_card.objects.point_ids_list)} "
         f"cpu={len(on_cpu.objects.point_ids_list)} digest cuda={d_card} cpu={d_cpu}")
    if d_card != d_cpu or not np.array_equal(on_card.assignment, on_cpu.assignment):
        raise AssertionError("cuda and cpu runs of the mid-size default configuration differ")
    if not on_card.objects.point_ids_list:
        raise AssertionError("the mid-size default configuration produced no objects")
    return d_card


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
    _say(f"[build] {len(kernels.KERNELS)} kernel source(s), entries {list(kernels.ENTRIES)}, in "
         f"{time.perf_counter() - t0:.2f} s "
         f"(nvcc per source: {json.dumps({k: round(v, 2) for k, v in built.items()})})")

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
    groups = []
    with recording_ball_query_groups(groups):
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
    if launches.get("ball_query", 0) == 0:
        raise AssertionError("the exact path launched no ball_query kernel")
    if n_obj == 0:
        raise AssertionError("the full-size scene produced no objects")
    for pids in res.objects.point_ids_list:
        if pids.size == 0 or int(pids.min()) < 0 or int(pids.max()) >= tensors.num_points:
            raise AssertionError("an object holds point ids outside the scene")
    if not np.isfinite(tensors.scene_points).all():
        raise AssertionError("non-finite scene points")

    if len(groups) != launches["ball_query"]:
        raise AssertionError(f"{len(groups)} ball-query groups kept, "
                             f"{launches['ball_query']} launched")

    # 5. the kernel on every group of the scene, timed
    t0 = time.perf_counter()
    bq = check_and_time_groups(dev, groups)
    share = bq["bound_ms"] / bq["ms"]
    _say(f"[kernels] ball_query == plain on all {len(groups)} groups of the scene "
         f"({time.perf_counter() - t0:.1f} s)")
    _say(f"[kernels] ball_query at its largest group {bq['shape']} (group {bq['group']}): "
         f"kernel {bq['ms']:.4f} ms, plain {bq['plain_ms']:.4f} ms, bound {bq['bound_ms']:.5f} ms "
         f"({bq['bound_by']}: {bq['pair_tests']} pair tests, {bq['bytes']} bytes), "
         f"{100 * share:.1f} % of the bound; without FMA the ceiling is "
         f"{100 * NO_FMA_CEILING:.0f} % of it, {bq['bound_ms'] / NO_FMA_CEILING:.5f} ms")
    _say(f"[kernels] ball_query summed over the scene's {len(groups)} groups: kernel "
         f"{bq['scene_ms']:.4f} ms, bound {bq['scene_bound_ms']:.5f} ms ({bq['scene_bound_by']}: "
         f"{bq['scene_pair_tests']} pair tests, {bq['scene_bytes']} bytes), "
         f"{100 * bq['scene_bound_ms'] / bq['scene_ms']:.1f} % of the bound")

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

    # 7. the association kernels on edge cases
    _say("[kernels] association edge cases")
    unfused = check_addcmul(dev)
    _say(f"  addcmul rounds once on cuda as on cpu (a separate multiply and add differ on "
         f"{unfused} of 1000003)")
    check_association_edges(dev)

    # 8. the default configuration at full size
    dense = dense_default_full(dev, tensors)

    # 9. the default configuration, card against cpu, on the mid-size scene
    dense_default_mid(dev)

    _say(f"[done] {time.perf_counter() - t_start:.1f} s")
    _say(card)
    rows = [{
        "name": "ball_query", "route": "cuda", "kind": "pallas",
        "source": "maskclustering_tpu_torch/ops/cuda/ball_query.cu",
        "replaces": "maskclustering_tpu/ops/pallas/ball_query.py:127",
        "launches": launches["ball_query"], "max_abs_err": bq["max_abs_err"],
        "ms": bq["ms"], "plain_ms": bq["plain_ms"], "bound_ms": bq["bound_ms"],
        "bound_by": bq["bound_by"], "library_ms": None, "scene_kernel_ms": bq["scene_ms"]}]
    for name, t in dense["timed"].items():
        rows.append({
            "name": name, "route": "cuda", "kind": "xla_program",
            "source": "maskclustering_tpu_torch/ops/cuda/associate.cu",
            "replaces": "maskclustering_tpu/models/backprojection.py:191",
            "launches": dense["launches"][name], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "scene_kernel_ms": t["scene_ms"]})
    _say(json.dumps({"kernels": rows}))
    _say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
