"""The cost observatory: per-stage censuses and rooflines of the port
(counterpart of ``maskclustering_tpu/obs/cost.py``).

The JAX observatory AOT-lowers each stage and reads XLA's cost and memory
analyses and HLO censuses. The port has no compiled module to read, so it
runs each stage once through ``parallel/sharded.build_stage_step`` at the
shapes ``stage_arg_shapes`` gives, on inputs made from a seed, under a
``TorchDispatchMode`` census that counts, per (stage, mesh):

- **aten ops** (``ops``: every op; ``fusion``, the column the JAX table
  gives XLA's fusions, counts the ops that launch work, the hand-written
  kernels included; ``copy`` and ``transpose`` the layout ops);
- **FLOPs** of the products, through ``torch.utils.flop_counter``'s
  registry, and the product census by operand class (``dots``, keyed as
  JAX's ``f32xf32->f32``), with the float32 products over {0, 1} operands
  counted apart (``counting_products``: the port's counting class);
- **bytes** read and written: each op's inputs read once and its outputs
  written once, XLA's bytes-accessed convention (views move nothing). The
  hand-written kernels are ``ctypes`` calls the dispatcher never sees;
  their wrappers book their bytes and operations here
  (``ops.cuda.KERNEL_CENSUS``) by the same rule;
- **peak memory**: ``max_memory_allocated`` on a card, the census's own
  live bytes on the CPU;
- **cross-device bytes** on a mesh, booked by mesh coordinate
  (``parallel/sharded._send``), the counterpart of the collective census:
  a mesh that repeats one card makes the copies no-ops, and they still
  count;
- **float64 ops** by source site (the IR family holds them to the audited
  ``ops.geometry.sqrt_f32`` entries).

Rates are the H100's (``H100_*``): 67 TFLOP/s FP32, 3.35 TB/s HBM3 and
450 GB/s of NVLink a direction. With ``time_stages`` on a card each row
also carries the stage's measured time (CUDA events, a run apart from the
census, which is not timed) and its share of the roofline. Rows go out as
``cost`` events in the JAX schema; render them with ``python -m
maskclustering_tpu_torch.obs.report --cost``, or run this module::

    python -m maskclustering_tpu_torch.obs.cost --mesh 1x8 --mesh 8x1 \\
        --events /tmp/cost_events.jsonl [--device cpu]
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
import weakref
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from maskclustering_tpu_torch.analysis.lock_sanitizer import mct_lock
from maskclustering_tpu_torch.obs.events import KIND_COST, EventSink

log = logging.getLogger("maskclustering_tpu_torch")

# H100 SXM peak rates (the ones PERF.md's bounds use): FP32 non-tensor-core
# FLOP/s, HBM3 bytes/s, NVLink 4 bytes/s a direction
H100_FP32_TFLOPS = 67.0
H100_HBM_GBPS = 3350.0
H100_NVLINK_GBPS = 450.0

DEFAULT_MESHES: Tuple[Tuple[int, ...], ...] = ((1, 8), (8, 1))
ALL_STAGES = ("backprojection", "graph", "clustering", "postprocess", "fused")

_DTYPE_NAMES = {"float32": "f32", "float64": "f64", "float16": "f16", "bfloat16": "bf16",
                "int8": "i8", "uint8": "ui8", "int16": "i16", "int32": "i32", "int64": "i64",
                "bool": "i1"}
_PRODUCTS = frozenset({"mm", "bmm", "addmm", "baddbmm", "mv", "dot", "addmv", "_scaled_mm"})
_TRANSPOSES = frozenset({"transpose", "t", "permute", "movedim"})
_COPIES = frozenset({"copy_", "_to_copy", "clone", "contiguous"})
# ops that only describe tensors: no launch, no bytes
_META = frozenset({"detach", "lift_fresh", "alias", "_unsafe_view", "view", "reshape",
                   "expand", "as_strided", "squeeze", "unsqueeze", "slice", "select",
                   "split", "unbind", "t", "transpose", "permute", "_reshape_alias"})

_TLS = threading.local()
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dtype_name(dtype) -> str:
    return _DTYPE_NAMES.get(str(dtype).replace("torch.", ""), str(dtype).replace("torch.", ""))


def book_transfer(nbytes: int) -> None:
    """One copy between two mesh coordinates (``parallel/sharded._send``),
    booked on this thread's census when one observes."""
    census = getattr(_TLS, "census", None)
    if census is not None:
        census.transfers += 1
        census.transfer_bytes += int(nbytes)


def _site() -> str:
    """``module.function<-caller`` of the innermost frames in this package
    (outside this module): where a float64 op came from."""
    frames: List[str] = []
    f = sys._getframe(2)
    while f is not None and len(frames) < 2:
        path = f.f_code.co_filename
        if path.startswith(_PKG) and not path.endswith(os.path.join("obs", "cost.py")):
            rel = os.path.relpath(path, _PKG)[:-3].replace(os.sep, ".")
            frames.append(f"{rel}.{f.f_code.co_name}")
        f = f.f_back
    return "<-".join(frames) or "<outside the package>"


def _tensors(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _binary(t) -> bool:
    """Whether every value of ``t`` is 0 or 1."""
    return bool(((t == 0) | (t == 1)).all())


class Census:
    """The counts of one observed run (see the module docstring)."""

    def __init__(self):
        self.ops: Counter = Counter()
        self.launches = 0
        self.copies = 0
        self.transposes = 0
        self.flops = 0.0
        self.bytes = 0.0
        self.dots: Dict[str, Dict[str, float]] = {}
        self.counting_products = 0
        self.wide_products = 0
        self.f64: Counter = Counter()
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.transfers = 0
        self.transfer_bytes = 0
        self.live = 0
        self.peak_live = 0
        self._storages: Dict[int, List[int]] = {}
        self._lane_peaks = 0
        self._lock = mct_lock("obs.cost.Census._lock")

    # -- a lane of the fused step (``lane``) -------------------------------------
    def merge(self, lane: "Census") -> None:
        """Add the counts of a lane observed on its own thread. Lanes run
        at once, so their peaks add."""
        with self._lock:
            self.ops.update(lane.ops)
            self.f64.update(lane.f64)
            for field in ("launches", "copies", "transposes", "flops", "bytes",
                          "counting_products", "wide_products", "transfers",
                          "transfer_bytes"):
                setattr(self, field, getattr(self, field) + getattr(lane, field))
            for mine, theirs in ((self.dots, lane.dots), (self.kernels, lane.kernels)):
                for key, row in theirs.items():
                    into = mine.setdefault(key, dict.fromkeys(row, 0))
                    for k, v in row.items():
                        into[k] += v
            self._lane_peaks += lane.peak_live
            self.peak_live = max(self.peak_live, self.live + self._lane_peaks)

    # -- hand-written kernels (ops.cuda.KERNEL_CENSUS) -----------------------
    def book_kernel(self, name: str, ops: int, nbytes: int) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += float(ops)
        k["bytes"] += float(nbytes)
        self.launches += 1

    # -- live bytes (the CPU's peak) -------------------------------------------
    def _track(self, t) -> None:
        try:
            st = t.untyped_storage()
        except Exception:  # noqa: BLE001 — a tensor without storage holds no bytes
            return
        key, nbytes = st.data_ptr(), st.nbytes()
        if not nbytes:
            return
        slot = self._storages.get(key)
        if slot is None:
            self._storages[key] = [nbytes, 1]
            self.live += nbytes
            self.peak_live = max(self.peak_live, self.live)
        else:
            slot[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        slot = self._storages.get(key)
        if slot is None:
            return
        slot[1] -= 1
        if slot[1] <= 0:
            self.live -= slot[0]
            del self._storages[key]

    # -- one aten op ---------------------------------------------------------
    def record(self, func, args, kwargs, out) -> None:
        import torch
        from torch.utils.flop_counter import flop_registry

        name = func._overloadpacket.__name__
        self.ops[name] += 1
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if any(t.dtype == torch.float64 for t in ins + outs):
            self.f64[_site()] += 1
        for t in outs:
            self._track(t)
        if getattr(func, "is_view", False) or name in _META:
            if name in _TRANSPOSES:
                self.transposes += 1
            return
        self.launches += 1
        if name in _COPIES:
            self.copies += 1
        seen = set()
        for t in ins + outs:
            if id(t) not in seen:
                seen.add(id(t))
                self.bytes += t.numel() * t.element_size()
        flop_fn = flop_registry.get(func._overloadpacket)
        if flop_fn is not None:
            try:
                self.flops += float(flop_fn(*args, **kwargs, out_val=out))
            except Exception:  # noqa: BLE001 — an op the registry cannot size adds none
                pass
        if name in _PRODUCTS:
            a, b = (args[1], args[2]) if name in ("addmm", "baddbmm", "addmv") else args[:2]
            res = outs[0]
            key = f"{_dtype_name(a.dtype)}x{_dtype_name(b.dtype)}->{_dtype_name(res.dtype)}"
            row = self.dots.setdefault(key, {"count": 0, "operand_bytes": 0.0})
            row["count"] += 1
            row["operand_bytes"] += float(a.numel() * a.element_size()
                                          + b.numel() * b.element_size())
            if a.dtype == torch.float32 and b.dtype == torch.float32:
                if _binary(a) and _binary(b):
                    self.counting_products += 1
                else:
                    self.wide_products += 1


def _census_mode(census: Census):
    from torch.utils._python_dispatch import TorchDispatchMode

    class _CensusMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            census.record(func, args, kwargs, out)
            return out

    return _CensusMode()


def lane(fn):
    """``fn`` made ready for a lane thread of the fused step
    (``parallel/sharded.build_fused_step``): when the calling thread is
    observed, the lane is observed into a census of its own, merged into
    the caller's when the lane ends (the census is thread-local)."""
    parent = getattr(_TLS, "census", None)
    if parent is None:
        return fn

    def observed():
        with observe() as census:
            out = fn()
        parent.merge(census)
        return out

    return observed


class observe:
    """``with observe() as census:`` counts this thread's aten ops, kernel
    launches and cross-device copies."""

    def __enter__(self) -> Census:
        from maskclustering_tpu_torch.ops import cuda

        self.census = Census()
        self._prev = getattr(_TLS, "census", None)
        self._prev_book = getattr(cuda.KERNEL_CENSUS, "book", None)
        _TLS.census = self.census
        cuda.KERNEL_CENSUS.book = self.census.book_kernel
        self._mode = _census_mode(self.census)
        self._mode.__enter__()
        return self.census

    def __exit__(self, *exc):
        from maskclustering_tpu_torch.ops import cuda

        self._mode.__exit__(*exc)
        _TLS.census = self._prev
        cuda.KERNEL_CENSUS.book = self._prev_book
        return False


def bound_ms(flops: float, nbytes: float) -> Tuple[float, str]:
    """(least ms on an H100, what bounds it) for this work."""
    t_ops = flops / (H100_FP32_TFLOPS * 1e12) * 1e3
    t_bytes = nbytes / (H100_HBM_GBPS * 1e9) * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def default_pipeline_cfg(point_chunk: int):
    """The observatory's config, also the IR family's (JAX ``obs/cost.py``)."""
    from maskclustering_tpu_torch.config import PipelineConfig

    return PipelineConfig(config_name="cost_observatory", dataset="demo",
                          distance_threshold=0.01, few_points_threshold=25,
                          point_chunk=point_chunk)


def parse_mesh_specs(specs: Sequence[str]) -> List[Tuple[int, ...]]:
    """``SCENExFRAME[xPOINT]`` items, each optionally comma-joined; raises
    ValueError with a message the CLIs surface."""
    meshes: List[Tuple[int, ...]] = []
    for item in specs:
        for m in item.split(","):
            if not m:
                continue
            parts = m.split("x")
            try:
                if len(parts) not in (2, 3):
                    raise ValueError
                meshes.append(tuple(int(p) for p in parts))
            except ValueError:
                raise ValueError(f"bad mesh spec {m!r}: expected SCENExFRAME[xPOINT], "
                                 f"e.g. 1x8 or 1x2x4") from None
    return meshes


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_ms(step, args, device, reps: int = 3) -> float:
    """Median ms of ``step(*args)`` on the card (CUDA events, warm)."""
    import torch

    step(*args)
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        step(*args)
        t1.record()
        torch.cuda.synchronize(device)
        times.append(t0.elapsed_time(t1))
    return sorted(times)[len(times) // 2]


def observe_costs(
    mesh_shapes: Sequence[Tuple[int, ...]] = DEFAULT_MESHES,
    *,
    stages: Sequence[str] = ALL_STAGES,
    frames: int = 8,
    points: int = 1024,
    image_hw: Tuple[int, int] = (24, 32),
    k_max: int = 7,
    cfg=None,
    sink: Optional[EventSink] = None,
    device=None,
    batch=None,
    seed: int = 0,
    time_stages: bool = False,
) -> List[Dict]:
    """Run every (stage, mesh) pair once under the census; return/emit the
    rows. A mesh of S x F x P coordinates repeats ``device`` (default: the
    CUDA card) that many times, with S scenes. ``batch`` replaces the
    seeded synthetic scenes with a real batch's six arrays (its scene count
    must be the largest scene axis asked for). ``time_stages`` (a card
    only) adds each stage's measured ms and roofline share."""
    import torch

    from maskclustering_tpu_torch.device import resolve_device
    from maskclustering_tpu_torch.parallel.mesh import make_mesh
    from maskclustering_tpu_torch.parallel.sharded import (
        build_fused_step,
        build_stage_step,
        stage_arg_shapes,
        stage_example_args,
    )

    dev = resolve_device(device)
    if cfg is None:
        cfg = default_pipeline_cfg(point_chunk=max(256, points // 4))
    rows: List[Dict] = []
    fingerprint = {"frames": frames, "points": points, "image_hw": list(image_hw),
                   "k_max": k_max, "backend": dev.type}
    for mesh_shape in mesh_shapes:
        s_ax, f_ax = mesh_shape[0], mesh_shape[1]
        p_ax = mesh_shape[2] if len(mesh_shape) == 3 else 1
        if frames % f_ax or points % p_ax:
            log.warning("cost observatory: (%d frames, %d points) do not split over mesh "
                        "%s; skipped", frames, points, mesh_shape)
            continue
        mesh = make_mesh(tuple(mesh_shape), devices=[dev] * (s_ax * f_ax * p_ax))
        lane_batch = None if batch is None else tuple(np.asarray(a)[:s_ax] for a in batch)
        dims = (dict(frames=frames, points=points, image_hw=tuple(image_hw))
                if lane_batch is None else
                dict(frames=lane_batch[1].shape[1], points=lane_batch[0].shape[1],
                     image_hw=tuple(lane_batch[1].shape[2:])))
        for stage in stages:
            t0 = time.perf_counter()
            try:
                args, r_pad = stage_example_args(
                    stage, cfg, mesh=mesh, device=dev, scenes=s_ax, frames=frames,
                    points=points, image_hw=image_hw, k_max=k_max, seed=seed,
                    batch=lane_batch)
                want = stage_arg_shapes(stage, scenes=s_ax, k_max=k_max, r_pad=r_pad,
                                        max_iters=cfg.max_cluster_iterations, **dims)
                got = tuple((tuple(a.shape), a.dtype) for a in args)
                if got != want:
                    raise ValueError(f"{stage} inputs {got} are not stage_arg_shapes' {want}")
                if stage == "fused":
                    step = build_fused_step(mesh, cfg, k_max=k_max,
                                            donate=bool(cfg.donate_buffers), device=dev)
                else:
                    step = build_stage_step(stage, mesh, cfg, k_max=k_max, r_pad=r_pad,
                                            device=dev)
                _sync(dev)
                arg_bytes = float(sum(a.numel() * a.element_size() for a in args))
                if dev.type == "cuda":
                    base = torch.cuda.memory_allocated(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                with observe() as census:
                    out = step(*args)
                    _sync(dev)
                t1 = time.perf_counter()
                if dev.type == "cuda":
                    peak = float(torch.cuda.max_memory_allocated(dev) - base) + arg_bytes
                else:
                    peak = float(census.peak_live) + arg_bytes
                out_bytes = float(sum(t.numel() * t.element_size() for t in _tensors(
                    out if not hasattr(out, "_asdict") else list(out))))
            except Exception as e:  # noqa: BLE001 — one stage must not sink the sweep
                log.exception("cost observatory: %s @ mesh %s failed", stage, mesh_shape)
                rows.append({"stage": stage, "mesh": list(mesh_shape),
                             "error": f"{type(e).__name__}: {e}", "fingerprint": fingerprint})
                continue
            kernel_bytes = sum(k["bytes"] for k in census.kernels.values())
            kernel_flops = sum(k["flops"] for k in census.kernels.values())
            row: Dict = {
                "stage": stage, "mesh": list(mesh_shape), "devices": s_ax * f_ax * p_ax,
                "count_dtype": cfg.count_dtype, "fingerprint": fingerprint,
                "census": True, "lower_s": round(t1 - t0, 3), "compile_s": 0.0,
                "flops": census.flops + kernel_flops,
                "hbm_bytes": census.bytes + kernel_bytes,
                "arg_bytes": arg_bytes, "out_bytes": out_bytes, "peak_bytes": peak,
                "collectives": ({"device-copy": {"count": census.transfers,
                                                 "bytes": float(census.transfer_bytes)}}
                                if census.transfers else {}),
                "ici_bytes": float(census.transfer_bytes),
                "ops": {"fusion": census.launches, "copy": census.copies,
                        "transpose": census.transposes, "aten": sum(census.ops.values())},
                "dots": census.dots, "counting_products": census.counting_products,
                "wide_products": census.wide_products, "f64_ops": dict(census.f64),
                "kernels": census.kernels, "kernel_bytes": kernel_bytes,
                "kernel_flops": kernel_flops, "r_pad": r_pad,
            }
            if stage in ("backprojection", "fused"):
                row["claim_plane_dtypes"] = _claim_plane_dtypes(stage, out)
            if time_stages and dev.type == "cuda":
                ms = _time_ms(step, args, dev)
                b_ms, b_by = bound_ms(row["flops"], row["hbm_bytes"])
                row.update({"device_ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                            "roofline_share": b_ms / ms if ms > 0 else None})
            if sink is not None:
                sink.emit(KIND_COST, row)
            rows.append(row)
            log.info("cost observatory: %s @ mesh %s: %d aten op(s), %.0f bytes, %.0f "
                     "cross-device bytes", stage, mesh_shape, row["ops"]["aten"],
                     row["hbm_bytes"], row["ici_bytes"])
    return rows


def _claim_plane_dtypes(stage: str, out) -> List[str]:
    """The dtypes of the (F, N) first/last claim planes a stage emitted."""
    if stage == "fused":
        planes = [t for lane in (out.first_id + out.last_id) for t in lane]
    else:
        planes = [t for shards, _ in out for sh in shards for t in sh[1:3]]
    return sorted({_dtype_name(t.dtype) for t in planes})


def compare_dtypes(
    mesh_shapes: Sequence[Tuple[int, ...]] = DEFAULT_MESHES,
    *,
    stages: Sequence[str] = ALL_STAGES,
    frames: int = 8,
    points: int = 1024,
    image_hw: Tuple[int, int] = (24, 32),
    k_max: int = 7,
    cfg=None,
    sink: Optional[EventSink] = None,
    device=None,
) -> Tuple[Dict[str, List[Dict]], List[Dict]]:
    """The observatory across ``count_dtype`` bf16 and int8, with one diff
    row per (stage, mesh) in the JAX schema. The port's counting products
    are float32 over {0, 1} under either encoding, so no class narrows:
    the diff rows say so (``narrowed_*`` empty, every class stays)."""
    if cfg is None:
        cfg = default_pipeline_cfg(point_chunk=max(256, points // 4))
    rows_by: Dict[str, List[Dict]] = {}
    for cd in ("bf16", "int8"):
        rows_by[cd] = observe_costs(mesh_shapes, stages=stages, frames=frames, points=points,
                                    image_hw=image_hw, k_max=k_max,
                                    cfg=cfg.replace(count_dtype=cd), sink=sink, device=device)

    def _key(r):
        return (r.get("stage"), tuple(r.get("mesh") or ()))

    bf_rows = {_key(r): r for r in rows_by["bf16"]}
    diffs: List[Dict] = []
    for r8 in rows_by["int8"]:
        rb = bf_rows.get(_key(r8))
        if rb is None or "error" in r8 or "error" in rb:
            continue
        dots_b, dots_8 = rb.get("dots") or {}, r8.get("dots") or {}
        stable = {k: dots_b[k] for k in dots_b if k in dots_8 and dots_8[k] == dots_b[k]}
        narrowed_b = {k: v for k, v in dots_b.items() if k not in stable}
        narrowed_8 = {k: v for k, v in dots_8.items() if k not in stable}
        nb = float(sum(c["operand_bytes"] for c in narrowed_b.values()))
        n8 = float(sum(c["operand_bytes"] for c in narrowed_8.values()))
        diffs.append({
            "stage": r8["stage"], "mesh": r8.get("mesh"),
            "narrowed_bf16": narrowed_b, "narrowed_int8": narrowed_8,
            "narrowed_bytes_bf16": nb, "narrowed_bytes_int8": n8,
            "operand_byte_ratio": (nb / n8) if n8 else None,
            "stable_dots": stable,
            "peak_bytes_bf16": rb.get("peak_bytes"), "peak_bytes_int8": r8.get("peak_bytes"),
            "arg_bytes": r8.get("arg_bytes"), "out_bytes_bf16": rb.get("out_bytes"),
            "out_bytes_int8": r8.get("out_bytes"), "fingerprint": r8.get("fingerprint"),
        })
    return rows_by, diffs


def claim_plane_bytes(frames: int, points: int) -> Dict[str, float]:
    """Size of the two (F, N) first/last claim planes of a scene: int16,
    against the historical int32 layout's."""
    return {"int16": 2.0 * frames * points * 2, "int32_historical": 2.0 * frames * points * 4}


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m maskclustering_tpu_torch.obs.cost",
        description="cost observatory: per-(stage, mesh) census of aten ops, FLOPs, bytes, "
                    "peak memory and cross-device bytes, with H100 rooflines")
    p.add_argument("--mesh", action="append", default=None, metavar="SxF[xP]",
                   help="mesh config, e.g. 1x8 or 1x2x4, repeating the device (repeatable; "
                        "default: 1x8 and 8x1)")
    p.add_argument("--stages", default=",".join(ALL_STAGES),
                   help=f"comma-separated subset of {ALL_STAGES}")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--points", type=int, default=1024)
    p.add_argument("--image-h", type=int, default=24)
    p.add_argument("--image-w", type=int, default=32)
    p.add_argument("--k-max", type=int, default=7)
    p.add_argument("--events", default=None,
                   help="append cost events to this JSONL (render later with "
                        "obs.report --cost)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card, where each stage is also "
                        "timed apart from its census; 'cpu' for the plain path)")
    p.add_argument("--compare-dtypes", action="store_true",
                   help="the observatory under count_dtype bf16 and int8, diffed")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    try:
        meshes = parse_mesh_specs(args.mesh or ["1x8", "8x1"])
    except ValueError as e:
        p.error(str(e))
    sink = EventSink(args.events) if args.events else None
    stages = tuple(s for s in args.stages.split(",") if s)
    shape = dict(frames=args.frames, points=args.points,
                 image_hw=(args.image_h, args.image_w), k_max=args.k_max)
    if args.compare_dtypes:
        from maskclustering_tpu_torch.obs.report import render_dtype_compare

        rows_by, diffs = compare_dtypes(meshes, stages=stages, sink=sink, device=args.device,
                                        **shape)
        if sink is not None:
            sink.close()
        print(render_dtype_compare(diffs, planes=claim_plane_bytes(args.frames, args.points)))
        ok = [r for rows in rows_by.values() for r in rows if "error" not in r]
        return 0 if diffs and ok else 1
    from maskclustering_tpu_torch.device import resolve_device

    rows = observe_costs(meshes, stages=stages, sink=sink, device=args.device,
                         time_stages=resolve_device(args.device).type == "cuda", **shape)
    if sink is not None:
        sink.close()
    from maskclustering_tpu_torch.obs.report import render_cost

    print(render_cost(rows))
    return 0 if [r for r in rows if "error" not in r] else 1


if __name__ == "__main__":
    sys.exit(main())
