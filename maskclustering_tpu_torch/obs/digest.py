"""Invariant digests of a scene: the device ``plane`` lane and the host composition.

Port of ``maskclustering_tpu/obs/digest.py:49-258``. An exact integer
reduction over the claim planes, the cluster assignment and the graph
state collapses a scene's intermediate state into a small uint32 vector
on the handoff's device; the host folds in the mask table, the pulled
assignment, the NaN/Inf count of the geometry and the canonical hash of
the exported instances (``artifact``). Equal digests between two runs
(two devices, two packages, two ladder rungs) mean the same state.

Everything is modular uint32 arithmetic, associative and commutative, so
the vector does not depend on the order of the reduction. torch has few
uint32 operations: the reductions here run in int64 and mask to 32 bits,
and every product is split so that no int64 operation overflows.

Digest schema (``DIGEST_VERSION``)::

    {"v": 1, "bucket": "k63:f32:n16384", "count_dtype": "bf16",
     "plane": "<crc32 hex8>", "artifact": "<crc32 hex8>", "nan_inf": 0}

``plane`` is empty on paths that never build a ``DeviceHandoff``
(``artifact_only_digest``); the port has none yet, the JAX package's
fused mesh batch and multi-chunk streaming finalize are two.
"""

from __future__ import annotations

import zlib
from typing import Dict, Optional

import numpy as np
import torch

DIGEST_VERSION = 1

# Knuth multiplicative hash constants: position weights of the wrapped
# uint32 checksums, weight(i) = i * MULT + OFFS mod 2**32
_W_MULT = 2654435761
_W_OFFS = 0x9E3779B9
_U32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 image of an integer or bool tensor, as int64: a negative
    value wraps as ``astype(uint32)`` does (-1 -> 0xFFFFFFFF)."""
    return x.reshape(-1).to(torch.int64) & _U32


def _mul_u32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2**32`` for int64 tensors holding values below 2**32.

    ``b`` is split into 16-bit halves, so each partial product stays below
    2**48 and int64 never overflows:
    ``a*b = a*b_lo + ((a*b_hi) mod 2**16) * 2**16  (mod 2**32)``.
    """
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _wsum(x: torch.Tensor) -> torch.Tensor:
    """Position-weighted uint32 checksum (exact, order-invariant), as a
    0-d int64 tensor in [0, 2**32)."""
    v = _u32(x)
    i = torch.arange(v.shape[0], dtype=torch.int64, device=v.device)
    # i < 2**31 (a tensor's length), so i * MULT < 2**63
    w = (i * _W_MULT + _W_OFFS) & _U32
    # each term is below 2**32, so a sum of fewer than 2**31 terms fits
    return _mul_u32(v, w).sum() & _U32


def _count(x: torch.Tensor) -> torch.Tensor:
    return torch.count_nonzero(x).to(torch.int64)


def digest_scene(first_id: torch.Tensor, last_id: torch.Tensor,
                 assignment: torch.Tensor, active: torch.Tensor,
                 node_visible: torch.Tensor) -> torch.Tensor:
    """Scene invariant vector (``_digest_scene_impl``, ``digest.py:64-92``):
    (8,) int64 holding uint32 values, exact integer reductions only.

    Claim-plane popcounts and position checksums (first/last), the
    assignment histogram checksum, the active popcount, the node-visible
    row-sum checksum and the active-masked assignment checksum.
    """
    m = assignment.shape[0]
    idx = assignment.to(torch.int64).clamp(0, m)
    # scatter_add_, not bincount: bincount reads the largest index on the host
    hist = torch.zeros(m + 1, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))
    row_sums = node_visible.to(torch.int64).sum(dim=1)
    return torch.stack([
        _count(first_id),
        _wsum(first_id),
        _count(last_id),
        _wsum(last_id),
        _wsum(hist),
        _count(active),
        _wsum(row_sums),
        _wsum(torch.where(active, assignment.to(torch.int64) + 1, 0)),
    ])


def digest_stream(assignment: torch.Tensor, active: torch.Tensor,
                  rep_plane: torch.Tensor) -> torch.Tensor:
    """Streaming-accumulator vector (``_digest_stream_impl``,
    ``digest.py:96-113``): (4,) int64 holding uint32 values over one
    chunk's post-bind state (assignment, active set, point -> rep plane)."""
    return torch.stack([
        _count(active),
        _wsum(torch.where(active, assignment.to(torch.int64) + 1, 0)),
        _count(rep_plane),
        _wsum(rep_plane),
    ])


def digest_scene_device(handoff) -> torch.Tensor:
    """The scene vector over a ``DeviceHandoff``'s tensors, on their device
    (no pull): computed before the post-process, pulled after it."""
    return digest_scene(handoff.first_id, handoff.last_id, handoff.assignment,
                        handoff.active, handoff.node_visible)


def vector_host(vec: torch.Tensor) -> np.ndarray:
    """Pull a digest vector as the uint32 array the host composition hashes."""
    return vec.cpu().numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# host composition
# ---------------------------------------------------------------------------


def _crc(data: bytes, seed: int = 0) -> int:
    return zlib.crc32(data, seed) & 0xFFFFFFFF


def table_hash(table) -> int:
    """Exact uint32 hash of a MaskTable's identifying rows."""
    seed = _crc(np.asarray(table.frame, np.int32).tobytes())
    seed = _crc(np.asarray(table.mask_id, np.int32).tobytes(), seed)
    seed = _crc(np.asarray(table.valid, np.uint8).tobytes(), seed)
    return _crc(np.asarray([table.num_masks, table.k_max], np.int32).tobytes(), seed)


def nan_inf_count(scene_points: np.ndarray) -> int:
    """Non-finite count over the f32 geometry (host numpy)."""
    return int(np.count_nonzero(~np.isfinite(scene_points)))


def artifact_digest(objects) -> str:
    """Hex8 fingerprint of a SceneObjects in its deterministic export order:
    every instance's point ids and (frame, mask, coverage) support rows."""
    seed = _crc(np.asarray([len(objects.point_ids_list),
                            int(objects.num_points)], np.int64).tobytes())
    for pids, masks in zip(objects.point_ids_list, objects.mask_list):
        seed = _crc(np.asarray(pids, np.int64).tobytes(), seed)
        for row in masks:
            frame_id, mask_id, coverage = row[0], row[1], row[2]
            seed = _crc(str(frame_id).encode(), seed)
            seed = _crc(np.asarray([int(mask_id)], np.int64).tobytes(), seed)
            seed = _crc(np.asarray([coverage], np.float64).tobytes(), seed)
    return f"{seed:08x}"


def plane_digest(vec_host: np.ndarray, table, assignment_host: np.ndarray,
                 nan_inf: int) -> str:
    """Hex8 of the device vector + mask table + pulled assignment."""
    seed = _crc(np.asarray(vec_host, np.uint32).tobytes())
    seed = _crc(np.asarray([table_hash(table)], np.uint32).tobytes(), seed)
    seed = _crc(np.asarray(assignment_host, np.int32).tobytes(), seed)
    seed = _crc(np.asarray([nan_inf], np.int64).tobytes(), seed)
    return f"{seed:08x}"


def bucket_label(k_max: int, f_pad: int, n_pad: int) -> str:
    """The census bucket coordinate string: ``k63:f32:n16384``."""
    return f"k{k_max}:f{f_pad}:n{n_pad}"


def compose_scene_digest(vec_host: np.ndarray, handoff, assignment_host: np.ndarray,
                         objects, *, count_dtype: str) -> Dict:
    """Fold the device vector and the host components into the digest dict."""
    f_pad, n_pad = handoff.first_id.shape
    nan_inf = nan_inf_count(handoff.scene_points)
    return {
        "v": DIGEST_VERSION,
        "bucket": bucket_label(handoff.k_max, f_pad, n_pad),
        "count_dtype": count_dtype,
        "plane": plane_digest(vec_host, handoff.table, assignment_host, nan_inf),
        "artifact": artifact_digest(objects),
        "nan_inf": nan_inf,
    }


def artifact_only_digest(objects, *, bucket: str, count_dtype: str) -> Dict:
    """Digest of a path that never builds a DeviceHandoff: artifact hash only."""
    return {
        "v": DIGEST_VERSION,
        "bucket": bucket,
        "count_dtype": count_dtype,
        "plane": "",
        "artifact": artifact_digest(objects),
        "nan_inf": 0,
    }


def chunk_digest_hex(vec_host: np.ndarray) -> str:
    """Hex8 of one streaming chunk's accumulator vector."""
    return f"{_crc(np.asarray(vec_host, np.uint32).tobytes()):08x}"


# ---------------------------------------------------------------------------
# coordinates
# ---------------------------------------------------------------------------


def digest_coord(digest: Optional[Dict], *, mesh: str = "single",
                 rung: int = 0, chunk: int = 0) -> str:
    """``<bucket>|<count_dtype>|<mesh>|r<rung>|c<chunk>``: the coordinate a
    digest was observed at (``chunk`` 0 = batch). ``rung`` is the package's
    own ladder rung, which differs between the packages (``utils/faults.py``)."""
    if not digest:
        return ""
    return (f"{digest.get('bucket', '?')}|{digest.get('count_dtype', '?')}"
            f"|{mesh or 'single'}|r{int(rung)}|c{int(chunk)}")


def digests_match(a: Optional[Dict], b: Optional[Dict]) -> bool:
    """Byte-for-byte digest equality; a version skew is a mismatch."""
    if not a or not b:
        return False
    return all(a.get(k) == b.get(k) for k in ("v", "plane", "artifact", "nan_inf"))


def diff_digests(a: Optional[Dict], b: Optional[Dict]) -> list:
    """Field names that differ between two digests."""
    if not a or not b:
        return ["missing"]
    return [k for k in ("v", "plane", "artifact", "nan_inf") if a.get(k) != b.get(k)]
