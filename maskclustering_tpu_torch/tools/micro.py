"""Micro-benchmarks of the primitive costs behind the post-process and
association designs, on the card (the port's ``scripts/micro_tpu.py``).

The JAX tool's eight primitives at its shapes (F = 150 frames, N = 192k
points, R = 128 representatives, a 240x320 pixel table), in torch on the
card, each timed with CUDA events (a warm call first):

1. segment sums, claims-scale (7.3M updates into R*N segments) and into
   64k segments (58M updates): ``index_add_``;
2. a per-representative loop of R compares over an (F, N) int16 plane;
3. a sort of a (2F, N) int32 array along the frame axis;
4. a flat sort of 58M int32;
5. 27 gathers of N from the pixel table (one frame's association window);
6. the (R, F) @ (F, N) counting product: float32 over {0, 1} operands, the
   port's counting class;
7. a scan over F frames accumulating one-hot (R, N) planes;
8. a scan over F frames of column scatter-adds into (R, N);

then ``overhead()``: a trivial op and a synchronize, the launch-and-sync
round trip::

    python -m maskclustering_tpu_torch.tools.micro [--frames 150 --points 196608] [--device cpu]

On the card unless ``--device`` names another device (on the CPU the times
are the host clock's); asked for the card on a host without one, it raises.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np


def timeit(name: str, fn: Callable, device, iters: int = 5) -> float:
    """Mean ms of ``fn()`` over ``iters`` calls after a warm one: CUDA events
    on a card, the host clock elsewhere. Prints one line."""
    import torch

    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize(device)
        ms = t0.elapsed_time(t1) / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / iters
    print(f"{name:55s} {ms:9.3f} ms", flush=True)
    return ms


def primitives(device, *, frames: int = 150, points: int = 192 * 1024, reps: int = 128,
               pixels: int = 240 * 320, seed: int = 0) -> Dict[str, float]:
    """Time the eight primitives at (F, N, R, HW); returns {name: ms}."""
    import torch

    rng = np.random.default_rng(seed)
    f_, n_, r_, hw = frames, points, reps, pixels

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out: Dict[str, float] = {}
    # 1. segment sums: claims-scale scatter into R*N segments, then 64k
    ids_big = up(rng.integers(0, r_ * n_, size=2 * f_ * n_ // 8, dtype=np.int32)).long()
    ones_big = torch.ones(ids_big.shape[0], dtype=torch.int32, device=device)
    out["segsum_big"] = timeit(
        f"index_add_ {ids_big.shape[0] / 1e6:.1f}M -> {r_ * n_ / 1e6:.1f}M segs",
        lambda: torch.zeros(r_ * n_, dtype=torch.int32, device=device).index_add_(
            0, ids_big, ones_big), device, iters=2)
    ids_small = up(rng.integers(0, 65536, size=2 * f_ * n_, dtype=np.int32)).long()
    ones_small = torch.ones(ids_small.shape[0], dtype=torch.int32, device=device)
    out["segsum_small"] = timeit(
        f"index_add_ {ids_small.shape[0] / 1e6:.1f}M -> 64k segs",
        lambda: torch.zeros(65536, dtype=torch.int32, device=device).index_add_(
            0, ids_small, ones_small), device, iters=2)

    # 2. per-rep dense loop: R x (F, N) compares
    a = up(rng.integers(-1, r_, size=(f_, n_), dtype=np.int16))
    nv = up(rng.random((r_, f_)) < 0.5)

    def perrep():
        res = []
        for r in range(r_):
            eq = a == r
            res.append((eq.any(dim=0), (eq & nv[r][:, None]).sum(dim=0, dtype=torch.int32)))
        return res
    out["perrep"] = timeit(f"per-rep loop R={r_} over (F,N) int16", perrep, device, iters=2)

    # 3. column sort along the frame axis (2F, N)
    k2 = up(rng.integers(0, r_, size=(2 * f_, n_), dtype=np.int32))
    out["sort_cols"] = timeit(f"sort ({2 * f_}, {n_ // 1024}k) along axis0",
                              lambda: torch.sort(k2, dim=0), device, iters=2)

    # 4. big flat sort
    flat = up(rng.integers(0, 2**31 - 1, size=2 * f_ * n_, dtype=np.int32))
    out["sort_flat"] = timeit(f"flat sort {flat.numel() / 1e6:.0f}M int32",
                              lambda: torch.sort(flat), device, iters=1)

    # 5. random gathers: one frame's association window reads, 9 x 3
    table = up(rng.random(hw, dtype=np.float32))
    idx = up(rng.integers(0, hw, size=n_, dtype=np.int32)).long()

    def gather27():
        acc = torch.zeros(n_, dtype=torch.float32, device=device)
        for k in range(27):
            acc = acc + table[(idx + k) % hw]
        return acc
    out["gather27"] = timeit(f"27x gather({n_ // 1024}k from {hw / 1e3:.1f}k)  [1 frame assoc]",
                             gather27, device, iters=5)

    # 6. the counting product (R, F) @ (F, N), float32 over {0, 1}
    nvf = nv.to(torch.float32)
    pv = up(rng.random((f_, n_)) < 0.5).to(torch.float32)
    out["matmul"] = timeit(f"matmul ({r_},{f_})@({f_},{n_ // 1024}k) f32 {{0,1}}",
                           lambda: nvf @ pv, device, iters=5)

    # 7. one-hot accumulate over a scan of F frames
    a32 = a.to(torch.int32)
    rows = torch.arange(r_, dtype=torch.int32, device=device)[:, None]
    nvt = nv.t().to(torch.float32)

    def onehot_scan():
        acc = torch.zeros((r_, n_), dtype=torch.float32, device=device)
        for fi in range(f_):
            acc = acc + (a32[fi][None, :] == rows).to(torch.float32) * nvt[fi][:, None]
        return acc
    out["onehot_scan"] = timeit("scan-F onehot accumulate (R,N)", onehot_scan, device, iters=2)

    # 8. column scatter-adds over a scan of F frames
    cols = torch.arange(n_, device=device)
    nvi = nv.t().to(torch.int32)

    def scatter_cols():
        acc = torch.zeros((r_, n_), dtype=torch.int32, device=device)
        for fi in range(f_):
            ac = a32[fi].clamp(0, r_ - 1).long()
            acc.index_put_((ac, cols), nvi[fi][ac], accumulate=True)
        return acc
    out["scatter_cols"] = timeit("scan-F scatter-add cols into (R,N)", scatter_cols, device,
                                 iters=1)
    return out


def overhead(device, iters: int = 10) -> float:
    """ms of a trivial op and a synchronize (the launch-and-sync round trip)."""
    import torch

    x = torch.zeros((), device=device)

    def once():
        y = x + 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return y
    once()
    t0 = time.perf_counter()
    for _ in range(iters):
        once()
    ms = (time.perf_counter() - t0) / iters * 1e3
    print(f"sync+trivial-op roundtrip: {ms:.3f} ms", flush=True)
    return ms


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m maskclustering_tpu_torch.tools.micro")
    p.add_argument("--frames", type=int, default=150)
    p.add_argument("--points", type=int, default=192 * 1024)
    p.add_argument("--reps", type=int, default=128)
    p.add_argument("--pixels", type=int, default=240 * 320)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    args = p.parse_args(argv)

    import torch

    from maskclustering_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev, flush=True)
    times = primitives(dev, frames=args.frames, points=args.points, reps=args.reps,
                       pixels=args.pixels)
    rt = overhead(dev)
    print(f"[micro] OK: {len(times)} primitives on {dev.type}, round trip {rt:.3f} ms",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
