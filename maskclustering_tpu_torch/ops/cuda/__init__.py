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
``visualize/top_images.py``, ``utils/synthetic.py``) and run only for CPU
tensors.

Each wrapper adds one to ``LAUNCHES`` under its entry's name
(``ENTRIES``) where it launches its kernel, so a run can show that its
main path went through the kernels. Building, loading and counting are
thread-safe: the batch driver's overlapped executor calls in from two
threads.

The tooling observes this module through three seams, each idle unless
armed: the kernel build cache (``utils/aot_cache.py``) moves the
libraries into its directory and loads them at process start
(:func:`adopt`); the retrace sanitizer (``analysis/retrace_sanitizer.py``)
sees every ``nvcc`` run and every launch key through ``BUILD_HOOKS`` and
``LAUNCH_HOOKS``; and the cost observatory's census (``obs/cost.py``)
reads each launch's bytes and operations through ``KERNEL_CENSUS``, since
a ``ctypes`` call is invisible to torch's dispatcher: each input counted
read once, each output written once.
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
from typing import Callable, Dict, Iterable, List, Tuple

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
KERNELS = ("ball_query", "associate", "splat", "render")
# the launch counts' names: one per kernel entry
ENTRIES = ("ball_query", "associate_table", "associate_claim", "associate_assign",
           "splat_depth", "splat_color", "splat_bbox", "render_depth_seg")


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
# observers of every nvcc run (name, library path) and every launch key
# (name, shape); the retrace sanitizer installs itself here when armed
BUILD_HOOKS: List[Callable[[str, str], None]] = []
LAUNCH_HOOKS: List[Callable[[str, Tuple[int, ...]], None]] = []
# the calling thread's cost census: ``KERNEL_CENSUS.book(name, ops, bytes)``
# while obs/cost.py observes a stage on this thread
KERNEL_CENSUS = threading.local()

# FP32 operations a unit of work does, an FMA counted as two and
# comparisons not at all (the count of the bounds in chip_smoke.py and of
# the census bookings below). A ball-query pair test: 3 subtractions, 3
# multiplications, 2 additions and the radius comparison. The pixel table,
# per pixel: the backprojection (2 subtractions, 2 multiplies, 2
# divisions). The window walk, the same in the claim and the assignment:
# per point and frame the rotation (3 multiplies, 6 FMAs, 3 additions =
# 18) and the projection (2 divisions, 2 FMAs = 6); per window pixel that
# can claim (in front, in the image and the window, depth and id set) the
# difference (3 subtractions) and the squared distance (a multiply and 2
# FMAs) = 8, which depends on the data and is left out of the bookings
BALL_QUERY_OPS_PER_PAIR = 9
TABLE_OPS_PER_PIXEL = 6
CLAIM_OPS_PER_POINT = 24
CLAIM_OPS_PER_PIXEL = 8
# The renderer: per pixel the ray (2 subtractions and 2 divisions for the
# camera direction, 3 rows of a multiply, an FMA and an addition = 12) and
# the floor (a division) = 17; per (pixel, box) the slab test's 6 divisions;
# per (frame, box) the 6 corner-minus-centre subtractions
RENDER_OPS_PER_PIXEL = 17
RENDER_OPS_PER_PIXEL_BOX = 6
RENDER_OPS_PER_FRAME_BOX = 6


def note_plain(name: str, shape: Tuple[int, ...]) -> None:
    """Tell the armed launch observers that entry ``name``'s plain version
    ran at ``shape`` on the CPU (the same launch key the kernel would book;
    ``LAUNCHES`` counts kernel launches only)."""
    for hook in LAUNCH_HOOKS:
        hook(name, shape)


def _launched(name: str, shape: Tuple[int, ...], ops: int, nbytes: int) -> None:
    """Count one launch of entry ``name`` and tell the armed observers."""
    LAUNCHES.add(name, shape)
    for hook in LAUNCH_HOOKS:
        hook(name, shape)
    book = getattr(KERNEL_CENSUS, "book", None)
    if book is not None:
        book(name, ops, nbytes)
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


def source_path(name: str) -> str:
    return os.path.join(_SRC_DIR, f"{name}.cu")


def source_sha256(name: str) -> str:
    """The SHA-256 of kernel ``name``'s source file."""
    with open(source_path(name), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def library_path(name: str) -> str:
    """Where kernel ``name``'s shared library lives once built: the armed
    build cache's directory, else ``BUILD_DIR``, under a name keyed by the
    source and flags."""
    from maskclustering_tpu_torch.utils import aot_cache

    cache = aot_cache.active()
    if cache is not None:
        return cache.library_path(name)
    with open(source_path(name), "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libmc_{name}-{key}.so")


def _start_nvcc(cmd: List[str]) -> subprocess.Popen:
    """One ``nvcc`` run (tests without a toolkit replace this)."""
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _open_library(path: str) -> ctypes.CDLL:
    """Load a built library (tests without a toolkit replace this)."""
    return ctypes.CDLL(path)


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every kernel in ``names`` that is not built yet, one ``nvcc``
    per source, all started together. Returns {name: seconds} of the builds
    that ran; raises with the compiler's output if any fails."""
    from maskclustering_tpu_torch.utils import aot_cache

    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
        procs[name] = (_start_nvcc(cmd), tmp, out, time.perf_counter())
        for hook in BUILD_HOOKS:
            hook(name, out)
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
    cache = aot_cache.active()
    if cache is not None and seconds:
        cache.record(seconds)
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
                lib = _open_library(library_path(name))
                _bind(name, lib)
                _LIBS[name] = lib
    return lib


def adopt(name: str, path: str) -> None:
    """Bind an already-built library of kernel ``name`` (the build cache's
    warm start): later calls use it and build nothing."""
    with _LOAD_LOCK:
        lib = _open_library(path)
        _bind(name, lib)
        _LIBS[name] = lib


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
        lib.mc_splat_depth.argtypes = [p, i, p, i, i, i, p, i, p]
        lib.mc_splat_color.argtypes = [p, p, i, p, i, i, i, p, p, p, i, p]
        lib.mc_splat_bbox.argtypes = [p, i, p, i, i, i, p, i, p]
        for entry in (lib.mc_splat_depth, lib.mc_splat_color, lib.mc_splat_bbox):
            entry.restype = ctypes.c_int
    elif name == "render":
        for entry in (lib.mc_render_depth_seg, lib.mc_render_depth_seg_exact):
            entry.argtypes = [p, i, p, p, p, i, i, i, p, p, i, p]
            entry.restype = ctypes.c_int
        lib.mc_render_quotients.argtypes = [p, p, p, ctypes.c_longlong, i, p]
        lib.mc_render_quotients.restype = ctypes.c_int


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
    # each input read once, the output written once; operations: every
    # query row against every candidate (the data-dependent early exit the
    # chip smoke's bound counts is not known here)
    nbytes = (query.numel() + candidates.numel()) * 4 + 8 * b + out.numel() * 4
    _launched("ball_query", (b, p, s), b * p * s * BALL_QUERY_OPS_PER_PAIR, nbytes)
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
    nbytes = (depths.numel() + segs.numel() + params.numel() + table.numel()) * 4
    _launched("associate_table", (f, h, w), depths.numel() * TABLE_OPS_PER_PIXEL, nbytes)
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
    # counted as a function of the depth and id stacks the table holds
    # (8 bytes a pixel), as the chip smoke's bound does; operations: the
    # per-(frame, point) projection only (the claiming pixels' share
    # depends on the data)
    nbytes = scene_points.numel() * 4 + f * h * w * 8 + params.numel() * 4 + n_claimed.numel() * 4
    _launched("associate_claim", (f, n, h, w, (2 * window + 1) ** 2),
              f * n * CLAIM_OPS_PER_POINT, nbytes)
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
    nbytes = (scene_points.numel() * 4 + f * h * w * 8 + params.numel() * 4
              + mask_valid.numel() + f * n * (4 + 2 + 2))
    _launched("associate_assign", (f, n, h, w, (2 * window + 1) ** 2),
              f * n * CLAIM_OPS_PER_POINT, nbytes)
    return mop, first, last


# the (16,) float32 parameters of a splat camera: world-to-camera rotation
# (row-major 9) and translation (3), then fx, fy, cx, cy
SPLAT_PARAMS = 16


def _splat_inputs(name: str, points: torch.Tensor, params: torch.Tensor, height: int,
                  width: int) -> int:
    """Check the inputs every splat entry takes; returns F, the number of
    cameras of ``params`` (F, 16)."""
    _check(points.dim() == 2 and points.shape[1] == 3 and points.dtype == torch.float32
           and points.is_contiguous(),
           f"{name}: points must be contiguous float32 (N, 3), got {tuple(points.shape)}")
    _check(params.dim() == 2 and params.shape[1] == SPLAT_PARAMS
           and params.dtype == torch.float32 and params.is_contiguous(),
           f"{name}: params must be the contiguous float32 (F, {SPLAT_PARAMS}) cameras, "
           f"got {tuple(params.shape)}")
    _check(height > 0 and width > 0 and height * width < 2 ** 31 - 1,
           f"{name}: need a positive image size under 2**31 pixels, got {height}x{width}")
    _check(points.shape[0] < 2 ** 31, f"{name}: at most 2**31 - 1 points")
    return params.shape[0]


def _splat_buffers(name: str, dev: torch.device, f: int, height: int,
                   width: int) -> torch.Tensor:
    """The (F, H*W + 1) int32 buffers an entry fills itself, 16-byte aligned
    for its vector stores."""
    buf = torch.empty((f, height * width + 1), dtype=torch.int32, device=dev)
    _check(buf.data_ptr() % 16 == 0, f"{name}: the allocator gave an unaligned buffer")
    return buf


def splat_bytes(name: str, n: int, f: int, height: int, width: int) -> int:
    """The bytes splat entry ``name`` must move for N points and F cameras,
    each input read once and each output written once. The depth pass:
    points and cameras in, the (F, H*W + 1) buffers out (their fill
    included). The colour pass: points, colours and cameras in, the depth
    of each pixel a point lands on (at most one a point and frame, at most
    the buffer), the code buffers and the (F, N) visible bytes out. The
    box: points and cameras in, (F, 4) int32 out."""
    pix = f * (height * width + 1)
    head = 12 * n + 4 * SPLAT_PARAMS * f
    if name == "splat_depth":
        return head + 4 * pix
    if name == "splat_color":
        return head + 12 * n + 4 * min(f * n, pix) + 4 * pix + f * n
    if name == "splat_bbox":
        return head + 16 * f
    raise ValueError(f"no splat entry {name!r}")


def splat_depth_cuda(points: torch.Tensor, params: torch.Tensor, *, height: int,
                     width: int) -> torch.Tensor:
    """The CUDA depth pass of a splat into the F frames of ``params`` (F,
    16), one launch (see ``splat.cu``): the (F, H*W + 1) int32 buffers of
    the float32 bits of each pixel's nearest depth, +inf where no point
    lands (the last slot of each is the dump slot, always +inf)."""
    name = "splat_depth_cuda"
    f = _splat_inputs(name, points, params, height, width)
    dev = _on_one_card(name, (points, params))
    zbuf = _splat_buffers(name, dev, f, height, width)
    if f == 0:
        return zbuf
    n = points.shape[0]
    lib = load("splat")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mc_splat_depth(points.data_ptr(), n, params.data_ptr(), f, height, width,
                                 zbuf.data_ptr(), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"splat_depth kernel launch failed: CUDA error {err}")
    _launched("splat_depth", (f, n, height, width), 0,
              splat_bytes("splat_depth", n, f, height, width))
    return zbuf


def splat_color_cuda(points: torch.Tensor, colors: torch.Tensor, params: torch.Tensor,
                     zbuf: torch.Tensor, *, height: int, width: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA colour pass of a splat into the F frames of ``params`` (F,
    16), one launch (see ``splat.cu``), after :func:`splat_depth_cuda`:
    ``(codebuf (F, H*W + 1) int32, visible (F, N) bool)``, each pixel's
    largest packed colour among its visible points (0 where none)."""
    name = "splat_color_cuda"
    f = _splat_inputs(name, points, params, height, width)
    _check(colors.shape == points.shape and colors.dtype == torch.float32
           and colors.is_contiguous(),
           f"{name}: colors must be contiguous float32 of the points' shape "
           f"{tuple(points.shape)}, got {tuple(colors.shape)}")
    want = (f, height * width + 1)
    _check(tuple(zbuf.shape) == want and zbuf.dtype == torch.int32 and zbuf.is_contiguous(),
           f"{name}: zbuf must be the contiguous int32 {want} buffer of splat_depth_cuda, "
           f"got {tuple(zbuf.shape)} {zbuf.dtype}")
    dev = _on_one_card(name, (points, colors, params, zbuf))
    n = points.shape[0]
    codebuf = _splat_buffers(name, dev, f, height, width)
    visible = torch.empty((f, n), dtype=torch.bool, device=dev)
    if f == 0:
        return codebuf, visible
    lib = load("splat")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mc_splat_color(points.data_ptr(), colors.data_ptr(), n, params.data_ptr(), f,
                                 height, width, zbuf.data_ptr(), codebuf.data_ptr(),
                                 visible.data_ptr(), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"splat_color kernel launch failed: CUDA error {err}")
    _launched("splat_color", (f, n, height, width), 0,
              splat_bytes("splat_color", n, f, height, width))
    return codebuf, visible


def splat_bbox_cuda(points: torch.Tensor, params: torch.Tensor, *, height: int,
                    width: int) -> torch.Tensor:
    """The CUDA box of a splat into the F frames of ``params`` (F, 16), one
    launch (see ``splat.cu``): (F, 4) int32 (min px, min py, max px, max py)
    of the pixels whose depth :func:`splat_depth_cuda` would leave finite;
    (INT32_MAX, INT32_MAX, INT32_MIN, INT32_MIN) where none is."""
    name = "splat_bbox_cuda"
    f = _splat_inputs(name, points, params, height, width)
    dev = _on_one_card(name, (points, params))
    box = torch.empty((f, 4), dtype=torch.int32, device=dev)
    if f == 0:
        return box
    n = points.shape[0]
    lib = load("splat")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mc_splat_bbox(points.data_ptr(), n, params.data_ptr(), f, height, width,
                                box.data_ptr(), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"splat_bbox kernel launch failed: CUDA error {err}")
    _launched("splat_bbox", (f, n, height, width), 0,
              splat_bytes("splat_bbox", n, f, height, width))
    return box


# boxes the renderer takes in one launch (their corners sit in shared memory)
RENDER_MAX_BOXES = 2048


def render_ops(f: int, k: int, height: int, width: int) -> int:
    """FP32 operations of one render of F frames of K boxes (the counts
    above: comparisons, minima and maxima not counted)."""
    return (f * height * width * (RENDER_OPS_PER_PIXEL + k * RENDER_OPS_PER_PIXEL_BOX)
            + f * k * RENDER_OPS_PER_FRAME_BOX)


def render_bytes(f: int, k: int, height: int, width: int) -> int:
    """Bytes a render must move: the boxes (24 B each), poses (64 B),
    intrinsics (36 B) and id permutations (4 B a box) a frame read once, the
    float32 depth and int32 id of every pixel written once."""
    return 24 * k + f * (64 + 36 + 4 * k) + 8 * f * height * width


def render_depth_seg_cuda(boxes: torch.Tensor, poses: torch.Tensor, intrinsics: torch.Tensor,
                          perms: torch.Tensor, *, height: int, width: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA box-and-floor renderer of F frames, one launch (see
    ``render.cu``): ``(depths (F, H, W) float32, segs (F, H, W) int32)``, as
    ``utils.synthetic.render_depth_seg_reference``. ``boxes`` (K, 2, 3) are
    the real boxes only (a padded box never hits)."""
    name = "render_depth_seg_cuda"
    _check(boxes.dim() == 3 and boxes.shape[1:] == (2, 3) and boxes.dtype == torch.float32
           and boxes.is_contiguous(),
           f"{name}: boxes must be contiguous float32 (K, 2, 3), got {tuple(boxes.shape)}")
    k = boxes.shape[0]
    _check(k <= RENDER_MAX_BOXES, f"{name}: at most {RENDER_MAX_BOXES} boxes, got {k}")
    _check(poses.dim() == 3 and poses.shape[1:] == (4, 4) and poses.dtype == torch.float32
           and poses.is_contiguous(),
           f"{name}: poses must be contiguous float32 (F, 4, 4), got {tuple(poses.shape)}")
    f = poses.shape[0]
    _check(f <= 65535, f"{name}: at most 65535 frames (grid y), got {f}")
    _check(tuple(intrinsics.shape) == (f, 3, 3) and intrinsics.dtype == torch.float32
           and intrinsics.is_contiguous(),
           f"{name}: intrinsics must be contiguous float32 ({f}, 3, 3), "
           f"got {tuple(intrinsics.shape)}")
    _check(tuple(perms.shape) == (f, k) and perms.dtype == torch.int32 and perms.is_contiguous(),
           f"{name}: perms must be contiguous int32 ({f}, {k}), got {tuple(perms.shape)}")
    _check(height > 0 and width > 0 and height * width < 2 ** 31,
           f"{name}: need a positive image size under 2**31 pixels, got {height}x{width}")
    dev = _on_one_card(name, (boxes, poses, intrinsics, perms))
    depths = torch.empty((f, height, width), dtype=torch.float32, device=dev)
    segs = torch.empty((f, height, width), dtype=torch.int32, device=dev)
    if f == 0:
        return depths, segs
    lib = load("render")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mc_render_depth_seg(boxes.data_ptr(), k, poses.data_ptr(), intrinsics.data_ptr(),
                                      perms.data_ptr(), f, height, width, depths.data_ptr(),
                                      segs.data_ptr(), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"render_depth_seg kernel launch failed: CUDA error {err}")
    _launched("render_depth_seg", (f, k, height, width), render_ops(f, k, height, width),
              render_bytes(f, k, height, width))
    return depths, segs


def render_quotients_cuda(num: torch.Tensor, sd: torch.Tensor) -> torch.Tensor:
    """The renderer's division form (``render.cu``'s ``quotient``, a
    reciprocal taken per divisor) applied to pairs: ``num / sd`` rounded as
    IEEE division rounds it, for pairs in the range ``render.cu`` states.
    A test entry, on no path of the program: it counts no launch."""
    name = "render_quotients_cuda"
    _check(num.shape == sd.shape and num.dim() == 1,
           f"{name}: need two 1-D tensors of one shape, got {tuple(num.shape)} and "
           f"{tuple(sd.shape)}")
    for t in (num, sd):
        _check(t.dtype == torch.float32 and t.is_contiguous(),
               f"{name}: inputs must be contiguous float32")
    dev = _on_one_card(name, (num, sd))
    out = torch.empty_like(num)
    lib = load("render")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mc_render_quotients(num.data_ptr(), sd.data_ptr(), out.data_ptr(),
                                      num.shape[0], dev.index, stream)
    if err != 0:
        raise RuntimeError(f"render_quotients kernel launch failed: CUDA error {err}")
    return out
