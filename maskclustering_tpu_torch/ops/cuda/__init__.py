"""Build, bind and count the port's hand-written CUDA kernels.

Each kernel is one ``*.cu`` file beside this module with a plain
``extern "C"`` entry. It is compiled at first use with ``nvcc`` for
``sm_90a`` into ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``), under a name keyed by the source and flags, and loaded with
``ctypes``. Entries take raw device pointers, the ordinal of the tensors'
card (each entry sets it as its runtime's current device before launching)
and PyTorch's current stream on that card, and return
``cudaGetLastError()``; the wrappers here raise when it is not 0.

No fallback: a failed build or launch raises. The plain torch versions
live beside the callers (``ops/neighbor.py``, ``models/backprojection.py``,
``visualize/top_images.py``)
and run only for CPU tensors.

Each wrapper adds one to ``LAUNCHES`` under its entry's name
(``ENTRIES``) where it launches its kernel, so a run can show that its
main path went through the kernels. Building, loading and counting are
thread-safe: the batch driver's overlapped executor calls in from two
threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from typing import Dict, Iterable, List, Tuple

import torch

from maskclustering_tpu_torch.analysis.lock_sanitizer import mct_lock

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_SRC_DIR)))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_kernels")

# -fmad=false: no multiply-add contraction the source does not state, so
# float32 arithmetic rounds exactly as the plain torch versions do (the
# association states its FMAs with __fmaf_rn)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

# one shared library per source file
KERNELS = ("ball_query", "associate", "splat")
# the launch counts' names: one per kernel entry
ENTRIES = ("ball_query", "associate_table", "associate_claim", "associate_assign",
           "splat_depth", "splat_color")


class LaunchLog:
    """Launch counts per kernel, and the shapes each was launched at."""

    def __init__(self) -> None:
        self.counts: Counter = Counter()
        self.shapes: Dict[str, Counter] = {}
        self._lock = mct_lock("ops.cuda.LaunchLog._lock")

    def add(self, name: str, shape: Tuple[int, ...]) -> None:
        with self._lock:
            self.counts[name] += 1
            self.shapes.setdefault(name, Counter())[shape] += 1

    def reset(self) -> None:
        with self._lock:
            self.counts.clear()
            self.shapes.clear()


LAUNCHES = LaunchLog()
# {name: seconds} of every nvcc build this process ran (a serving worker
# subprocess reports it on its ready/bye lines)
BUILT: Dict[str, float] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
# one nvcc per source at a time, and one binding per library
_LOAD_LOCK = mct_lock("ops.cuda._LOAD_LOCK")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's usual ``/usr/local/cuda``."""
    cands: List[str] = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for path in cands:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME)")


def library_path(name: str) -> str:
    """Where kernel ``name``'s shared library lives once built."""
    with open(os.path.join(_SRC_DIR, f"{name}.cu"), "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libmc_{name}-{key}.so")


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every kernel in ``names`` that is not built yet, one ``nvcc``
    per source, all started together. Returns {name: seconds} of the builds
    that ran; raises with the compiler's output if any fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(_SRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out, time.perf_counter())
    seconds: Dict[str, float] = {}
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a half-written library is never loaded
        seconds[name] = time.perf_counter() - t0
    BUILT.update(seconds)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The bound library of kernel ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(library_path(name))
                _bind(name, lib)
                _LIBS[name] = lib
    return lib


def _bind(name: str, lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "ball_query":
        lib.mc_ball_query.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, p, i, p]
        lib.mc_ball_query.restype = ctypes.c_int
    elif name == "associate":
        lib.mc_associate_table.argtypes = [p, p, i, i, i, p, i, p, i, p]
        lib.mc_associate_claim_scene.argtypes = [p, i, p, i, i, i, p, i, i, p, i, p]
        lib.mc_associate_assign_scene.argtypes = [p, i, p, i, i, i, p, p, i, i, p, p, p, i, p]
        for entry in (lib.mc_associate_table, lib.mc_associate_claim_scene,
                      lib.mc_associate_assign_scene):
            entry.restype = ctypes.c_int
    elif name == "splat":
        lib.mc_splat_depth.argtypes = [p, i, p, i, i, p, i, p]
        lib.mc_splat_color.argtypes = [p, p, i, p, i, i, p, p, p, i, p]
        for entry in (lib.mc_splat_depth, lib.mc_splat_color):
            entry.restype = ctypes.c_int


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def bulk_copy_ready(candidates: torch.Tensor, candidate_lengths: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidates as the ball-query kernel's bulk copies take them: a
    16-byte aligned start and S % 4 == 0, so every tile of whole groups of 4
    candidates is a multiple of 16 bytes. Returns the inputs themselves when
    they already are; else a zero-padded copy with the lengths clamped to
    the old S, which leaves the answer unchanged."""
    s = candidates.shape[1]
    if s % 4 == 0 and candidates.data_ptr() % 16 == 0:
        return candidates, candidate_lengths
    padded = candidates.new_zeros((candidates.shape[0], -(-s // 4) * 4, 3))
    padded[:, :s] = candidates
    return padded, candidate_lengths.clamp(max=s)


def ball_query_cuda(query: torch.Tensor, candidates: torch.Tensor,
                    query_lengths: torch.Tensor, candidate_lengths: torch.Tensor,
                    *, k: int, radius: float) -> torch.Tensor:
    """The CUDA ball query: (B, P, k) int32, -1 padded (see ``ball_query.cu``)."""
    dev = query.device
    _check(dev.type == "cuda", f"ball_query_cuda needs CUDA tensors, got {dev}")
    for t in (candidates, query_lengths, candidate_lengths):
        _check(t.device == dev, "ball_query_cuda: all inputs must be on one device")
    _check(query.dim() == 3 and query.shape[2] == 3,
           f"query must be (B, P, 3), got {tuple(query.shape)}")
    b, p, _ = query.shape
    _check(candidates.dim() == 3 and candidates.shape[0] == b and candidates.shape[2] == 3,
           f"candidates must be ({b}, S, 3), got {tuple(candidates.shape)}")
    s = candidates.shape[1]
    for t in (query, candidates):
        _check(t.dtype == torch.float32 and t.is_contiguous(),
               "ball_query_cuda: points must be contiguous float32")
    for t in (query_lengths, candidate_lengths):
        _check(t.dtype == torch.int32 and t.is_contiguous() and tuple(t.shape) == (b,),
               f"ball_query_cuda: lengths must be contiguous int32 of shape ({b},)")
    _check(k >= 1 and radius > 0, f"need k >= 1 and radius > 0, got k={k}, radius={radius}")
    _check(b <= 65535, f"ball_query_cuda: at most 65535 batch rows (grid y), got {b}")

    out = torch.full((b, p, k), -1, dtype=torch.int32, device=dev)
    if b == 0 or p == 0:
        return out
    lib = load("ball_query")
    r2 = float(radius) * float(radius)
    with torch.cuda.device(dev):
        cand, cand_lengths = bulk_copy_ready(candidates, candidate_lengths)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mc_ball_query(query.data_ptr(), cand.data_ptr(),
                                query_lengths.data_ptr(), cand_lengths.data_ptr(),
                                b, p, cand.shape[1], k, ctypes.c_float(r2), out.data_ptr(),
                                dev.index, stream)
    if err != 0:
        raise RuntimeError(f"ball_query kernel launch failed: CUDA error {err}")
    LAUNCHES.add("ball_query", (b, p, s))
    return out


# windows the association kernels are instantiated for (associate.cu)
ASSOCIATE_MAX_WINDOW = 3


def _on_one_card(name: str, tensors) -> torch.device:
    dev = tensors[0].device
    _check(dev.type == "cuda", f"{name} needs CUDA tensors, got {dev}")
    for t in tensors[1:]:
        _check(t.device == dev, f"{name}: all inputs must be on one device")
    return dev


def _check_params(name: str, params: torch.Tensor, f: int, k_max: int) -> None:
    _check(params.shape == (f, 18) and params.dtype == torch.float32 and params.is_contiguous(),
           f"{name}: params must be the contiguous float32 ({f}, 18) table of claim_params, "
           f"got {tuple(params.shape)}")
    _check(1 <= k_max <= 1023, f"{name}: k_max must be in 1..1023 (int16 ids), got {k_max}")
    _check(f <= 65535, f"{name}: at most 65535 frames (grid y), got {f}")


def associate_table_cuda(depths: torch.Tensor, segs: torch.Tensor, params: torch.Tensor, *,
                         k_max: int) -> torch.Tensor:
    """The CUDA pixel table of a stack of F frames, one launch (see
    ``associate.cu``): (F, H, W, 4) int32, the float32 bits of each pixel's
    backprojection ``qx``, ``qy`` and masked depth, and its masked id, as
    ``models.backprojection.pixel_table_reference``."""
    name = "associate_table_cuda"
    _check(depths.dim() == 3 and depths.dtype == torch.float32 and depths.is_contiguous(),
           f"{name}: depths must be a contiguous float32 (F, H, W) stack")
    f, h, w = depths.shape
    _check(segs.shape == depths.shape and segs.dtype == torch.int32 and segs.is_contiguous(),
           f"{name}: segs must be a contiguous int32 stack of the depths' shape "
           f"{tuple(depths.shape)}, got {tuple(segs.shape)}")
    _check_params(name, params, f, k_max)
    dev = _on_one_card(name, (depths, segs, params))
    table = torch.empty((f, h, w, 4), dtype=torch.int32, device=dev)
    if table.numel() == 0:
        return table
    lib = load("associate")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mc_associate_table(depths.data_ptr(), segs.data_ptr(), f, h, w,
                                     params.data_ptr(), k_max, table.data_ptr(), dev.index,
                                     stream)
    if err != 0:
        raise RuntimeError(f"associate_table kernel launch failed: CUDA error {err}")
    LAUNCHES.add("associate_table", (f, h, w))
    return table


def _scene_inputs(name: str, scene_points: torch.Tensor, table: torch.Tensor,
                  params: torch.Tensor, k_max: int, window: int) -> Tuple[int, int, int]:
    """Check the inputs the claim and the assignment share; returns (F, H, W)."""
    _check(scene_points.dim() == 2 and scene_points.shape[1] == 3
           and scene_points.dtype == torch.float32 and scene_points.is_contiguous(),
           f"{name}: scene_points must be contiguous float32 (N, 3), "
           f"got {tuple(scene_points.shape)}")
    _check(table.dim() == 4 and table.shape[3] == 4 and table.dtype == torch.int32
           and table.is_contiguous(),
           f"{name}: table must be the contiguous int32 (F, H, W, 4) pixel table, "
           f"got {tuple(table.shape)} {table.dtype}")
    f, h, w = table.shape[:3]
    _check_params(name, params, f, k_max)
    _check(0 <= window <= ASSOCIATE_MAX_WINDOW,
           f"{name} takes windows 0..{ASSOCIATE_MAX_WINDOW}, got {window}")
    return f, h, w


def associate_claim_scene_cuda(scene_points: torch.Tensor, table: torch.Tensor,
                               params: torch.Tensor, *, k_max: int, window: int) -> torch.Tensor:
    """The CUDA claim over a stack of F frames, one launch (see
    ``associate.cu``): the (F, k_max + 1) int32 distinct claim counts, as
    ``models.backprojection.claim_scene_reference``."""
    name = "associate_claim_scene_cuda"
    f, h, w = _scene_inputs(name, scene_points, table, params, k_max, window)
    dev = _on_one_card(name, (scene_points, table, params))
    n = scene_points.shape[0]
    n_claimed = torch.zeros((f, k_max + 1), dtype=torch.int32, device=dev)
    if n == 0 or f == 0:
        return n_claimed
    lib = load("associate")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mc_associate_claim_scene(scene_points.data_ptr(), n, table.data_ptr(), f, h, w,
                                           params.data_ptr(), k_max, window,
                                           n_claimed.data_ptr(), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"associate_claim kernel launch failed: CUDA error {err}")
    LAUNCHES.add("associate_claim", (f, n, h, w, (2 * window + 1) ** 2))
    return n_claimed


def associate_assign_scene_cuda(scene_points: torch.Tensor, table: torch.Tensor,
                                params: torch.Tensor, mask_valid: torch.Tensor, *, k_max: int,
                                window: int):
    """The CUDA assignment over a stack of F frames, one launch (see
    ``associate.cu``): (F, N) ``(mask_of_point int32, first int16, last
    int16)``, as ``models.backprojection.assign_scene_reference``."""
    name = "associate_assign_scene_cuda"
    f, h, w = _scene_inputs(name, scene_points, table, params, k_max, window)
    _check(mask_valid.shape == (f, k_max + 1) and mask_valid.dtype == torch.bool
           and mask_valid.is_contiguous(),
           f"{name}: mask_valid must be contiguous bool ({f}, {k_max + 1}), "
           f"got {tuple(mask_valid.shape)}")
    dev = _on_one_card(name, (scene_points, table, params, mask_valid))
    n = scene_points.shape[0]
    mop = torch.empty((f, n), dtype=torch.int32, device=dev)
    first = torch.empty((f, n), dtype=torch.int16, device=dev)
    last = torch.empty((f, n), dtype=torch.int16, device=dev)
    if n == 0 or f == 0:
        return mop, first, last
    lib = load("associate")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mc_associate_assign_scene(
            scene_points.data_ptr(), n, table.data_ptr(), f, h, w, params.data_ptr(),
            mask_valid.data_ptr(), k_max, window, mop.data_ptr(), first.data_ptr(),
            last.data_ptr(), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"associate_assign kernel launch failed: CUDA error {err}")
    LAUNCHES.add("associate_assign", (f, n, h, w, (2 * window + 1) ** 2))
    return mop, first, last


# the (16,) float32 parameters of a splat: world-to-camera rotation
# (row-major 9) and translation (3), then fx, fy, cx, cy
SPLAT_PARAMS = 16


def _splat_inputs(name: str, points: torch.Tensor, params: torch.Tensor, height: int,
                  width: int) -> None:
    _check(points.dim() == 2 and points.shape[1] == 3 and points.dtype == torch.float32
           and points.is_contiguous(),
           f"{name}: points must be contiguous float32 (N, 3), got {tuple(points.shape)}")
    _check(tuple(params.shape) == (SPLAT_PARAMS,) and params.dtype == torch.float32
           and params.is_contiguous(),
           f"{name}: params must be the contiguous float32 ({SPLAT_PARAMS},) camera, "
           f"got {tuple(params.shape)}")
    _check(height > 0 and width > 0 and height * width < 2 ** 31 - 1,
           f"{name}: need a positive image size under 2**31 pixels, got {height}x{width}")
    _check(points.shape[0] < 2 ** 31, f"{name}: at most 2**31 - 1 points")


def splat_depth_cuda(points: torch.Tensor, params: torch.Tensor, *, height: int,
                     width: int) -> torch.Tensor:
    """The CUDA depth pass of a splat (see ``splat.cu``): the (H*W + 1) int32
    buffer of the float32 bits of each pixel's nearest depth, +inf where no
    point lands (the last slot is the dump slot, always +inf)."""
    name = "splat_depth_cuda"
    _splat_inputs(name, points, params, height, width)
    dev = _on_one_card(name, (points, params))
    zbuf = torch.full((height * width + 1,), 0x7F800000, dtype=torch.int32, device=dev)
    n = points.shape[0]
    if n == 0:
        return zbuf
    lib = load("splat")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mc_splat_depth(points.data_ptr(), n, params.data_ptr(), height, width,
                                 zbuf.data_ptr(), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"splat_depth kernel launch failed: CUDA error {err}")
    LAUNCHES.add("splat_depth", (n, height, width))
    return zbuf


def splat_color_cuda(points: torch.Tensor, colors: torch.Tensor, params: torch.Tensor,
                     zbuf: torch.Tensor, *, height: int, width: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA colour pass of a splat (see ``splat.cu``) after
    :func:`splat_depth_cuda`: ``(codebuf (H*W + 1) int32, visible (N,)
    bool)``, each pixel's largest packed colour among its visible points (0
    where none)."""
    name = "splat_color_cuda"
    _splat_inputs(name, points, params, height, width)
    _check(colors.shape == points.shape and colors.dtype == torch.float32
           and colors.is_contiguous(),
           f"{name}: colors must be contiguous float32 of the points' shape "
           f"{tuple(points.shape)}, got {tuple(colors.shape)}")
    _check(tuple(zbuf.shape) == (height * width + 1,) and zbuf.dtype == torch.int32
           and zbuf.is_contiguous(),
           f"{name}: zbuf must be the contiguous int32 ({height * width + 1},) buffer of "
           f"splat_depth_cuda, got {tuple(zbuf.shape)} {zbuf.dtype}")
    dev = _on_one_card(name, (points, colors, params, zbuf))
    n = points.shape[0]
    codebuf = torch.zeros((height * width + 1,), dtype=torch.int32, device=dev)
    visible = torch.zeros((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return codebuf, visible
    lib = load("splat")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mc_splat_color(points.data_ptr(), colors.data_ptr(), n, params.data_ptr(),
                                 height, width, zbuf.data_ptr(), codebuf.data_ptr(),
                                 visible.data_ptr(), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"splat_color kernel launch failed: CUDA error {err}")
    LAUNCHES.add("splat_color", (n, height, width))
    return codebuf, visible
