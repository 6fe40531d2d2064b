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
7. the association's three scene entries (``ops/cuda/associate.cu``: the
   pixel table, the claim and the assignment, one launch each over a stack
   of frames) bit-equal to their plain scene versions on
   the edge cases of ``ops/association_cases.py``: every one-frame case as
   a scene of one frame (points behind the camera, footprints off every
   border, pixel centres on .5, claim distances at and a few ulps around
   r2, windows 0-3, k_max 63 and 1023, an invalid frame, N not a multiple
   of the block) and the multi-frame cases (an invalid frame and a padded
   all-zero pose, a frame with every point behind the camera, every lane
   claiming one id, a different id on every lane at k_max 1023, N not a
   multiple of the block); the frame or scene on ``cuda`` equal to
   ``cpu``; ``torch.addcmul`` on the card rounds once, as on the CPU;
8. the default configuration (dense association, device post-process) at
   full size through ``models.run_scene``: the scene of phase 4,
   ``distance_threshold`` 0.01, ``k_max`` 63, ``post_neighbor_cap`` raised
   to the smallest power of two that holds the scene's largest DBSCAN
   degree (printed). The scene entries' inputs and outputs are kept; each
   must have launched once for the scene, and all three are bit-equal to
   their plain versions on all frames and timed per scene with CUDA
   events, beside the plain versions and the bound. The association stage alone
   is timed and its host synchronisations counted
   (``torch.cuda.set_sync_debug_mode``). One more run under
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
# FP32 operations of the association kernels (associate.cu), an FMA
# counted as two and comparisons not at all. The pixel table, per pixel:
# the backprojection (2 subtractions, 2 multiplies, 2 divisions) = 6. The
# window walk, the same in the claim and the assignment: per point and
# frame the rotation (3 multiplies, 6 FMAs, 3 additions = 18) and the
# projection (2 divisions, 2 FMAs = 6); per window pixel that can claim (in
# front, in the image and the window, depth and id set) the difference (3
# subtractions) and the squared distance (a multiply and 2 FMAs) = 8
TABLE_OPS_PER_PIXEL = 6
CLAIM_OPS_PER_POINT = 24
CLAIM_OPS_PER_PIXEL = 8
# the association kernels, in the order the path launches them
ASSOCIATION_KERNELS = ("associate_table", "associate_claim", "associate_assign")
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


def _scene_tensors(case, dev):
    import numpy as np
    import torch

    return [torch.from_numpy(np.asarray(case[k])).to(dev)
            for k in ("points", "depths", "segs", "intrinsics", "cam_to_world", "frame_valid")]


ASSOCIATION_KW = ("k_max", "window", "distance_threshold", "depth_trunc", "few_points_threshold",
                  "coverage_threshold")


def check_association_edges(dev) -> None:
    """Phase 7: both scene entries bit-equal to their plain scene versions
    on the card, on every one-frame case as a scene of one frame and on the
    multi-frame cases; the frame or scene on the card equal to the CPU."""
    import torch

    from maskclustering_tpu_torch.models import backprojection as bp
    from maskclustering_tpu_torch.ops.association_cases import (
        CASES,
        SCENE_CASES,
        as_scene,
        association_case,
        association_scene_case,
    )
    from maskclustering_tpu_torch.ops.cuda import (
        associate_assign_scene_cuda,
        associate_claim_scene_cuda,
        associate_table_cuda,
    )
    from maskclustering_tpu_torch.ops.geometry import invert_se3

    cases = ([(n, association_case(n), True) for n in CASES]
             + [(n, association_scene_case(n), False) for n in SCENE_CASES])
    for name, case, one_frame in cases:
        scene = as_scene(case) if one_frame else case
        pts, depths, segs, intr, c2w, fv = _scene_tensors(scene, dev)
        prm = bp.claim_params(intr, invert_se3(c2w), distance_threshold=case["distance_threshold"],
                              depth_trunc=case["depth_trunc"])
        k_max, window = case["k_max"], case["window"]
        table = associate_table_cuda(depths, segs, prm, k_max=k_max)
        want_table = bp.pixel_table_reference(depths, segs, prm, k_max=k_max)
        n_claimed = associate_claim_scene_cuda(pts, table, prm, k_max=k_max, window=window)
        want_n = bp.claim_scene_reference(pts, table, prm, k_max=k_max, window=window)
        mask_valid = torch.rand((depths.shape[0], k_max + 1), device=dev) < 0.7
        got = associate_assign_scene_cuda(pts, table, prm, mask_valid, k_max=k_max,
                                          window=window)
        want = bp.assign_scene_reference(pts, table, prm, mask_valid, k_max=k_max, window=window)
        torch.cuda.synchronize()
        bad = [what for what, g, w in zip(
            ("table", "n_claimed", "mask_of_point", "first", "last"),
            (table, n_claimed, *got), (want_table, want_n, *want)) if not torch.equal(g, w)]
        kw = {k: case[k] for k in ASSOCIATION_KW}
        if one_frame:
            on_card = bp.associate_frame(*_frame_tensors(case, dev), None, **kw)
            on_cpu = bp.associate_frame(*_frame_tensors(case, "cpu"), None, **kw)
        else:
            on_card = bp.associate_scene(pts, depths, segs, intr, c2w, fv, **kw)
            on_cpu = bp.associate_scene(*_scene_tensors(scene, "cpu"), **kw)
        bad += [f"on cuda != cpu: {f}" for f in on_cpu._fields
                if not torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f))]
        if bad:
            raise AssertionError(f"association kernels != plain version on '{name}': {bad}")
        _say(f"  associate_table/claim/assign == plain on '{name}' F={depths.shape[0]} "
             f"N={pts.shape[0]} HxW={tuple(depths.shape[1:])} window={window} k_max={k_max}; "
             f"{'frame' if one_frame else 'scene'} cuda == cpu")


@contextlib.contextmanager
def recording_association_frames(calls: list):
    """Keep, in ``calls``, the inputs and outputs of the scene entries
    (pixel table, claim and assignment over every frame) that the dense
    association runs while the context is open, one dict a scene, and the
    DBSCAN degrees of the post-process."""
    from maskclustering_tpu_torch.models import backprojection as bp
    from maskclustering_tpu_torch.ops import grid_dbscan as gd

    table_of, claim, assign = bp.pixel_table, bp.claim_scene, bp.assign_scene
    pack = gd.pack_neighbors

    def rec_table(depths, segs, params, *, k_max):
        table = table_of(depths, segs, params, k_max=k_max)
        calls.append({"table": (depths, segs, params, k_max), "table_out": table})
        return table

    def rec_claim(scene_points, table, params, *, k_max, window=1):
        n_claimed = claim(scene_points, table, params, k_max=k_max, window=window)
        calls[-1].update(claim=(scene_points, table, params, k_max, window), n_claimed=n_claimed)
        return n_claimed

    def rec_assign(scene_points, table, params, mask_valid, *, k_max, window=1):
        out = assign(scene_points, table, params, mask_valid, k_max=k_max, window=window)
        calls[-1].update(mask_valid=mask_valid, assigned=out)
        return out

    def rec_pack(*args, **kw):
        nb, degree = pack(*args, **kw)
        calls.append({"degree": degree.max()})
        return nb, degree

    bp.pixel_table, bp.claim_scene, bp.assign_scene = rec_table, rec_claim, rec_assign
    gd.pack_neighbors = rec_pack
    try:
        yield calls
    finally:
        bp.pixel_table, bp.claim_scene, bp.assign_scene = table_of, claim, assign
        gd.pack_neighbors = pack


def claiming_pixels(pts, depths, segs, params, *, k_max: int, window: int) -> int:
    """Window pixels of this scene that reach the claim's distance test:
    in front of the camera, in the image and the window, with a depth and
    an id (the plain claim's own tests, in torch)."""
    import torch

    from maskclustering_tpu_torch.models import backprojection as bp
    from maskclustering_tpu_torch.ops.geometry import fma, rotate

    total = 0
    h, w = depths.shape[1:]
    for f in range(depths.shape[0]):
        prm = params[f]
        cam = rotate(pts, prm[:9].reshape(3, 3)) + prm[9:12]
        in_front = cam[:, 2] > 1e-6
        safe_z = torch.where(in_front, cam[:, 2], torch.ones_like(cam[:, 2]))
        ui = bp._round_to_int32(fma(cam[:, 0] / safe_z, prm[12], prm[14].expand_as(safe_z)))
        vi = bp._round_to_int32(fma(cam[:, 1] / safe_z, prm[13], prm[15].expand_as(safe_z)))
        uc, vc = ui.clamp(0, w - 1), vi.clamp(0, h - 1)
        live = ((depths[f] > 0) & (depths[f] <= prm[17]) & (segs[f] > 0)
                & (segs[f] <= k_max)).reshape(-1)
        for dv in range(-window, window + 1):
            for du in range(-window, window + 1):
                uu, vv = uc + du, vc + dv
                ok = (in_front & (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
                      & ((uu.long() - ui.long()).abs() <= window)
                      & ((vv.long() - vi.long()).abs() <= window))
                idx = (vv.clamp(0, h - 1) * w + uu.clamp(0, w - 1)).long()
                total += int((ok & live[idx]).sum())
    return total


def association_bounds(call):
    """The least time of each association kernel on this scene's inputs, as
    {name: (ms, bound_by, bytes, ops)}: each input of the function read
    once, each output written once, and the FP32 operations this data
    needs. The claim and the assignment are counted as functions of the
    scene's depth and id stacks, not of the pixel table they read, which
    the table's own count holds as an output."""
    depths, segs, prm, k_max = call["table"]
    pts, _, _, _, window = call["claim"]
    f, n = depths.shape[0], pts.shape[0]
    maps = depths.numel() * 4 + segs.numel() * 4 + prm.numel() * 4
    table_bytes = maps + call["table_out"].numel() * 4
    table_ops = depths.numel() * TABLE_OPS_PER_PIXEL
    reads = pts.numel() * 4 + maps
    ops = (f * n * CLAIM_OPS_PER_POINT
           + claiming_pixels(pts, depths, segs, prm, k_max=k_max, window=window)
           * CLAIM_OPS_PER_PIXEL)
    claim_bytes = reads + call["n_claimed"].numel() * 4
    assign_bytes = reads + call["mask_valid"].numel() + f * n * (4 + 2 + 2)
    return {"associate_table": (*bound_ms(table_ops, table_bytes), table_bytes, table_ops),
            "associate_claim": (*bound_ms(ops, claim_bytes), claim_bytes, ops),
            "associate_assign": (*bound_ms(ops, assign_bytes), assign_bytes, ops)}


def check_and_time_scene(call):
    """Phase 8 over the scene's one call of each entry: the three kernels
    bit-equal to their plain scene versions on every frame and to what the
    main path returned, each fed the inputs the main path gave it; timed
    per scene (10 launches after a warm-up; the plain versions once after
    one), with the bound."""
    import torch

    from maskclustering_tpu_torch.models import backprojection as bp
    from maskclustering_tpu_torch.ops.cuda import (
        associate_assign_scene_cuda,
        associate_claim_scene_cuda,
        associate_table_cuda,
    )

    depths, segs, prm, k_max = call["table"]
    pts, table, _, _, window = call["claim"]
    mask_valid = call["mask_valid"]
    kw = dict(k_max=k_max, window=window)
    runs = {"associate_table": (
        lambda: (associate_table_cuda(depths, segs, prm, k_max=k_max),),
        lambda: (bp.pixel_table_reference(depths, segs, prm, k_max=k_max),)),
        "associate_claim": (
        lambda: (associate_claim_scene_cuda(pts, table, prm, **kw),),
        lambda: (bp.claim_scene_reference(pts, table, prm, **kw),)),
        "associate_assign": (
        lambda: associate_assign_scene_cuda(pts, table, prm, mask_valid, **kw),
        lambda: bp.assign_scene_reference(pts, table, prm, mask_valid, **kw))}
    main = {"associate_table": (call["table_out"],), "associate_claim": (call["n_claimed"],),
            "associate_assign": call["assigned"]}
    bounds = association_bounds(call)
    out = {}
    for name in ASSOCIATION_KERNELS:
        kernel, plain = runs[name]
        got, want = kernel(), plain()
        bad = [i for i, (g, w, m) in enumerate(zip(got, want, main[name]))
               if not (torch.equal(g, w) and torch.equal(m, w))]
        if bad:
            raise AssertionError(f"{name} != plain version on the full-size scene (outputs {bad})")
        err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
        ms_, by, nbytes, ops = bounds[name]
        out[name] = {"ms": cuda_time_ms(kernel, reps=10),
                     "plain_ms": cuda_time_ms(plain, reps=1, warmup=1),
                     "bound_ms": ms_, "bound_by": by, "bytes": nbytes, "ops": ops,
                     "frames": depths.shape[0], "max_abs_err": float(err)}
    return out


def count_syncs(fn):
    """(``fn()``, {"file:line": times}): where ``fn`` made the host wait for
    the card, from ``torch.cuda.set_sync_debug_mode``'s warnings, each at
    the innermost frame of this repository's code."""
    import traceback
    import warnings
    from collections import Counter

    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    where = Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            ours = [fr for fr in traceback.extract_stack()[:-1] if fr.filename.startswith(here)]
            fr = ours[-1] if ours else None
            where[f"{os.path.relpath(fr.filename, here)}:{fr.lineno}" if fr
                  else f"{filename}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, where


def association_stage(dev, tensors, cfg, k_max: int = 63):
    """The dense association stage alone, as ``run_scene`` runs it: its
    warm wall (best of 3), its host synchronisations from the host arrays,
    and those on tensors already on the card."""
    import numpy as np
    import torch

    from maskclustering_tpu_torch.models.backprojection import (
        associate_scene,
        associate_scene_tensors,
    )
    from maskclustering_tpu_torch.models.pipeline import pad_scene_tensors
    from maskclustering_tpu_torch.utils.compile_cache import scene_pads

    padded = pad_scene_tensors(tensors, *scene_pads(cfg, tensors.num_frames,
                                                    tensors.num_points))
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        associate_scene_tensors(padded, cfg, k_max=k_max, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    _, syncs = count_syncs(lambda: associate_scene_tensors(padded, cfg, k_max=k_max, device=dev))
    arrays = [torch.as_tensor(np.asarray(a)).to(dev) for a in (
        padded.scene_points, padded.depths, padded.segmentations, padded.intrinsics,
        padded.cam_to_world, padded.frame_valid)]
    torch.cuda.synchronize()
    _, resident = count_syncs(lambda: associate_scene(
        *arrays, k_max=k_max, window=cfg.association_window,
        distance_threshold=cfg.distance_threshold, depth_trunc=cfg.depth_trunc,
        few_points_threshold=cfg.few_points_threshold,
        coverage_threshold=cfg.coverage_threshold))
    return {"wall_s": min(walls), "walls_s": walls, "syncs": syncs, "syncs_resident": resident,
            "uploads": len(arrays)}


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
    calls = [c for c in recorded if "table" in c]
    degrees = [int(c["degree"]) for c in recorded if "degree" in c]
    n_obj = len(res.objects.point_ids_list)
    digest = artifact_digest(res.objects)
    _say(f"[dense] N={tensors.num_points} N_pad={n_pad} F={tensors.num_frames} F_pad={f_pad} "
         f"M_pad={res.table.m_pad} masks={res.table.num_masks} objects={n_obj} digest={digest} "
         f"wall={wall:.2f} s peak_device_mem={peak_mib:.1f} MiB")
    _say("[dense] stage walls (s): " + json.dumps({k: round(v, 4) for k, v in res.timings.items()}))
    _say(f"[dense] DBSCAN: largest same-rep degree {max(degrees, default=0)} (post_neighbor_cap "
         f"{FULL_NEIGHBOR_CAP}, default {load_config('scannet').post_neighbor_cap})")
    _say(f"[dense] kernel launches: {json.dumps(launches)}")
    for name in ASSOCIATION_KERNELS:
        if launches.get(name, 0) != 1:
            raise AssertionError(f"{name} launched {launches.get(name, 0)} times for the scene, "
                                 f"not once")
    if launches.get("ball_query", 0):
        raise AssertionError("the dense path launched the ball query")
    if len(calls) != 1 or calls[0]["table"][0].shape[0] != f_pad:
        raise AssertionError(f"{len(calls)} scene calls kept, not one over the {f_pad} frames")
    if n_obj == 0:
        raise AssertionError("the full-size default configuration produced no objects")
    for pids in res.objects.point_ids_list:
        if pids.size == 0 or int(pids.min()) < 0 or int(pids.max()) >= tensors.num_points:
            raise AssertionError("an object holds point ids outside the scene")
    if not np.isfinite(tensors.scene_points).all():
        raise AssertionError("non-finite scene points")
    t0 = time.perf_counter()
    timed = check_and_time_scene(calls[0])
    _say(f"[kernels] associate_table/claim/assign == plain on all {f_pad} frames of the scene "
         f"({time.perf_counter() - t0:.1f} s)")
    for name, t in timed.items():
        _say(f"[kernels] {name} per scene ({t['frames']} frames, one launch): kernel "
             f"{t['ms']:.5f} ms, plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.5f} ms "
             f"({t['bound_by']}: {t['bytes']} bytes, {t['ops']} FP32 ops), "
             f"{100 * t['bound_ms'] / t['ms']:.1f} % of the bound")
    stage = association_stage(dev, tensors, cfg)
    _say(f"[dense] association stage alone: wall {stage['wall_s']:.4f} s (best of 3: "
         + ", ".join(f"{w:.4f}" for w in stage["walls_s"])
         + f"); host syncs {sum(stage['syncs'].values())} from host arrays "
         f"({stage['uploads']} uploads) {json.dumps(stage['syncs'])}, "
         f"{sum(stage['syncs_resident'].values())} on tensors already on the card "
         f"{json.dumps(stage['syncs_resident'])}")
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
    for name, (ms, cnt) in by_name.items():
        if "scene_kernel" in name or "table_kernel" in name:
            _say(f"  association: {ms:10.4f} ms {cnt:3d} x {name[:100]}")


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
    # the JAX lines each association kernel computes (associate_frame, :191)
    replaces = {"associate_table": "maskclustering_tpu/models/backprojection.py:264",
                "associate_claim": "maskclustering_tpu/models/backprojection.py:229",
                "associate_assign": "maskclustering_tpu/models/backprojection.py:347"}
    for name, t in dense["timed"].items():
        rows.append({
            "name": name, "route": "cuda", "kind": "xla_program",
            "source": "maskclustering_tpu_torch/ops/cuda/associate.cu",
            "replaces": replaces[name],
            "launches": dense["launches"][name], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "scene_kernel_ms": t["ms"]})
    _say(json.dumps({"kernels": rows}))
    _say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
