"""Build, bind and count the port's hand-written CUDA kernels.

Each kernel is one ``*.cu`` file beside this module with a plain
``extern "C"`` entry. It is compiled at first use with ``nvcc`` for
``sm_90a`` into ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``), under a name keyed by the source and flags, and loaded with
``ctypes``. Entries take raw device pointers and PyTorch's current stream
and return ``cudaGetLastError()``; the wrappers here raise when it is not 0.

No fallback: a failed build or launch raises. The plain torch versions
live beside the callers (``ops/neighbor.py``, ``models/backprojection.py``)
and run only for CPU tensors.

Each wrapper adds one to ``LAUNCHES`` under its entry's name
(``ENTRIES``) where it launches its kernel, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from typing import Dict, Iterable, List, Tuple

import torch

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_SRC_DIR)))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_kernels")

# -fmad=false: no multiply-add contraction the source does not state, so
# float32 arithmetic rounds exactly as the plain torch versions do (the
# association states its FMAs with __fmaf_rn)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

# one shared library per source file
KERNELS = ("ball_query", "associate")
# the launch counts' names: one per kernel entry
ENTRIES = ("ball_query", "associate_claim", "associate_assign")


class LaunchLog:
    """Launch counts per kernel, and the shapes each was launched at."""

    def __init__(self) -> None:
        self.counts: Counter = Counter()
        self.shapes: Dict[str, Counter] = {}

    def add(self, name: str, shape: Tuple[int, ...]) -> None:
        self.counts[name] += 1
        self.shapes.setdefault(name, Counter())[shape] += 1

    def reset(self) -> None:
        self.counts.clear()
        self.shapes.clear()


LAUNCHES = LaunchLog()
_LIBS: Dict[str, ctypes.CDLL] = {}


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
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The bound library of kernel ``name`` (built on first use)."""
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
        lib.mc_ball_query.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, p, p]
        lib.mc_ball_query.restype = ctypes.c_int
    elif name == "associate":
        lib.mc_associate_claim.argtypes = [p, i, p, p, i, i, p, i, i, p, p, p]
        lib.mc_associate_claim.restype = ctypes.c_int
        lib.mc_associate_assign.argtypes = [p, i, i, p, i, p, p, p, p]
        lib.mc_associate_assign.restype = ctypes.c_int


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
                                stream)
    if err != 0:
        raise RuntimeError(f"ball_query kernel launch failed: CUDA error {err}")
    LAUNCHES.add("ball_query", (b, p, s))
    return out


# windows the claim kernel is instantiated for (associate.cu)
ASSOCIATE_MAX_WINDOW = 3


def associate_claim_cuda(scene_points: torch.Tensor, depth: torch.Tensor, seg: torch.Tensor,
                         params: torch.Tensor, *, k_max: int, window: int):
    """The CUDA claim step of one frame (see ``associate.cu``): returns the
    (N, (2w+1)^2) int16 candidate plane and the (k_max + 1,) int32 distinct
    claim counts, as ``models.backprojection.claim_candidates_reference``."""
    dev = scene_points.device
    _check(dev.type == "cuda", f"associate_claim_cuda needs CUDA tensors, got {dev}")
    for t in (depth, seg, params):
        _check(t.device == dev, "associate_claim_cuda: all inputs must be on one device")
    _check(scene_points.dim() == 2 and scene_points.shape[1] == 3
           and scene_points.dtype == torch.float32 and scene_points.is_contiguous(),
           f"scene_points must be contiguous float32 (N, 3), got {tuple(scene_points.shape)}")
    _check(depth.dim() == 2 and depth.dtype == torch.float32 and depth.is_contiguous(),
           "depth must be a contiguous float32 (H, W) map")
    _check(seg.shape == depth.shape and seg.dtype == torch.int32 and seg.is_contiguous(),
           "seg must be a contiguous int32 map of the depth's shape")
    _check(params.shape == (18,) and params.dtype == torch.float32 and params.is_contiguous(),
           "params must be the 18 contiguous float32 values of claim_params")
    _check(0 <= window <= ASSOCIATE_MAX_WINDOW,
           f"associate_claim_cuda takes windows 0..{ASSOCIATE_MAX_WINDOW}, got {window}")
    _check(1 <= k_max <= 1023, f"k_max must be in 1..1023 (int16 ids), got {k_max}")
    n = scene_points.shape[0]
    h, w = depth.shape
    k = (2 * window + 1) ** 2
    cand = torch.empty((n, k), dtype=torch.int16, device=dev)
    n_claimed = torch.zeros(k_max + 1, dtype=torch.int32, device=dev)
    if n == 0:
        return cand, n_claimed
    lib = load("associate")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mc_associate_claim(scene_points.data_ptr(), n, depth.data_ptr(),
                                     seg.data_ptr(), h, w, params.data_ptr(), k_max, window,
                                     cand.data_ptr(), n_claimed.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"associate_claim kernel launch failed: CUDA error {err}")
    LAUNCHES.add("associate_claim", (n, h, w, k))
    return cand, n_claimed


def associate_assign_cuda(cand: torch.Tensor, mask_valid: torch.Tensor, *, k_max: int):
    """The CUDA assignment step (see ``associate.cu``): returns
    ``(mask_of_point int32, first int16, last int16)``, as
    ``models.backprojection.assign_claims_reference``."""
    dev = cand.device
    _check(dev.type == "cuda", f"associate_assign_cuda needs CUDA tensors, got {dev}")
    _check(mask_valid.device == dev, "associate_assign_cuda: all inputs must be on one device")
    _check(cand.dim() == 2 and cand.dtype == torch.int16 and cand.is_contiguous(),
           "cand must be a contiguous int16 (N, K) plane")
    _check(mask_valid.shape == (k_max + 1,) and mask_valid.dtype == torch.bool
           and mask_valid.is_contiguous(), f"mask_valid must be contiguous bool ({k_max + 1},)")
    n, k = cand.shape
    mop = torch.empty(n, dtype=torch.int32, device=dev)
    first = torch.empty(n, dtype=torch.int16, device=dev)
    last = torch.empty(n, dtype=torch.int16, device=dev)
    if n == 0:
        return mop, first, last
    lib = load("associate")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mc_associate_assign(cand.data_ptr(), n, k, mask_valid.data_ptr(), k_max,
                                      mop.data_ptr(), first.data_ptr(), last.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"associate_assign kernel launch failed: CUDA error {err}")
    LAUNCHES.add("associate_assign", (n, k))
    return mop, first, last
