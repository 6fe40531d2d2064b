"""Fixed-radius first-K neighbour search (ball query), pytorch3d semantics.

Counterpart of ``maskclustering_tpu/ops/neighbor.py:25-96`` and of the
Pallas kernel ``ops/pallas/ball_query.py``. For each valid query point
(index < ``query_lengths[b]``): the indices of the FIRST k candidates
(index < ``candidate_lengths[b]``, ascending index order, not the nearest
k) whose float32 squared distance ``(qx-cx)^2 + (qy-cy)^2 + (qz-cz)^2``
is ``<= radius^2``; unused slots are -1, rows past the query length all -1.

``ball_query`` dispatches on the tensors' device: the CUDA kernel
(``ops/cuda/ball_query.cu``) for CUDA tensors, the plain torch version
``ball_query_reference`` for CPU tensors, and nothing else.
"""

from __future__ import annotations

import numpy as np
import torch

# elements of the (B, rows, S) distance block the plain version holds at once
_REFERENCE_BLOCK = 1 << 24


def ball_query(query: torch.Tensor, candidates: torch.Tensor,
               query_lengths: torch.Tensor, candidate_lengths: torch.Tensor,
               *, k: int = 20, radius: float = 0.01) -> torch.Tensor:
    """(B, P, k) int32 first-K-within-radius indices, -1 padded."""
    if query.device.type == "cuda":
        from maskclustering_tpu_torch.ops.cuda import ball_query_cuda

        return ball_query_cuda(query, candidates, query_lengths, candidate_lengths,
                               k=k, radius=radius)
    if query.device.type == "cpu":
        from maskclustering_tpu_torch.ops.cuda import note_plain

        note_plain("ball_query", (query.shape[0], query.shape[1], candidates.shape[1]))
        return ball_query_reference(query, candidates, query_lengths, candidate_lengths,
                                    k=k, radius=radius)
    raise ValueError(f"ball_query runs on cuda or cpu tensors, got {query.device}")


def ball_query_reference(query: torch.Tensor, candidates: torch.Tensor,
                         query_lengths: torch.Tensor, candidate_lengths: torch.Tensor,
                         *, k: int = 20, radius: float = 0.01) -> torch.Tensor:
    """Plain torch ball query over query-row chunks, on any device.

    Per chunk: the f32 hit matrix ``d2 <= r2`` masked by the candidate
    length, an int32 ``cumsum`` rank of each hit in scan order, and a
    scatter of the first k hits into their slots.
    """
    b, p, _ = query.shape
    s = candidates.shape[1]
    dev = query.device
    out = torch.full((b, p, k), -1, dtype=torch.int32, device=dev)
    if b == 0 or p == 0 or s == 0:
        return out
    query = query.to(torch.float32)
    candidates = candidates.to(torch.float32)
    r2 = torch.tensor(float(radius) * float(radius), dtype=torch.float32, device=dev)
    cand_idx = torch.arange(s, dtype=torch.int32, device=dev)
    cvalid = cand_idx[None, :] < candidate_lengths.to(dev).reshape(b, 1)  # (B, S)
    ql = query_lengths.to(dev).reshape(b, 1)
    cx, cy, cz = (candidates[:, None, :, i] for i in range(3))  # (B, 1, S)
    chunk = max(1, min(p, _REFERENCE_BLOCK // (b * s)))
    for start in range(0, p, chunk):
        q = query[:, start:start + chunk]  # (B, C, 3)
        dx = q[:, :, None, 0] - cx
        dy = q[:, :, None, 1] - cy
        dz = q[:, :, None, 2] - cz
        d2 = dx * dx + dy * dy + dz * dz  # (B, C, S), f32, this order
        hit = (d2 <= r2) & cvalid[:, None, :]
        rank = torch.cumsum(hit, dim=2, dtype=torch.int32) - 1
        take = hit & (rank < k)
        slot = torch.where(take, rank, k).long()  # slot k collects the dropped
        vals = torch.where(take, cand_idx, -1)
        buf = torch.full(slot.shape[:2] + (k + 1,), -1, dtype=torch.int32, device=dev)
        buf.scatter_reduce_(2, slot, vals, reduce="amax")
        rows = torch.arange(start, start + q.shape[1], device=dev)
        qvalid = rows[None, :] < ql  # (B, C)
        out[:, start:start + q.shape[1]] = torch.where(qvalid[..., None], buf[..., :k], -1)
    return out


def ball_query_brute(query, candidates, query_lengths, candidate_lengths, k, radius):
    """Numpy oracle: literal first-K-within-radius (int64)."""
    query = np.asarray(query)
    candidates = np.asarray(candidates)
    b, p, _ = query.shape
    out = np.full((b, p, k), -1, dtype=np.int64)
    for bi in range(b):
        for pi in range(int(query_lengths[bi])):
            found = 0
            for si in range(int(candidate_lengths[bi])):
                d = query[bi, pi] - candidates[bi, si]
                if float(d @ d) <= radius * radius:
                    out[bi, pi, found] = si
                    found += 1
                    if found == k:
                        break
    return out
