"""Iterative view-consensus clustering (counterpart of ``models/clustering.py``).

The assignment begins as singletons (the batch path) or, warm, as a prior
assignment (``init``: the streaming re-cluster). Cluster state is one
vector ``a[m] -> representative mask index`` over the M_pad slots. Each
schedule step re-aggregates the mask features into their representatives
(a segment-OR as a counting product), forms the observer and supporter
affinities V V^T and C C^T (reference iterative_clustering.py:20-23),
thresholds them, and merges by connected components (min-label
propagation with pointer jumping, in place of networkx). The loop stops at
the first +inf of the schedule, as the JAX ``while_loop`` does.

Host traffic: the 20-float schedule is read once, and each propagation
sweep reads one "changed" flag, each in a named ``sanctioned_pull`` window
(``cluster.schedule``, ``cluster.sweep``) of the host-sync guard
(``analysis/transfer_guard.py``). The JAX package keeps both loops on the
device (``lax.while_loop``); taking them off the host is ROADMAP B2.3.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from maskclustering_tpu_torch.analysis.transfer_guard import sanctioned_pull
from maskclustering_tpu_torch.ops import counting


class ClusterResult(NamedTuple):
    assignment: torch.Tensor  # (M_pad,) int32: final representative per mask
    node_visible: torch.Tensor  # (M_pad, F) bool: per-rep aggregated visible_frame
    node_active: torch.Tensor  # (M_pad,) bool: slot is a live representative


def _connected_components(adj: torch.Tensor) -> torch.Tensor:
    """Min-label propagation to fixpoint; ``adj`` must be symmetric (M, M) bool."""
    m = adj.shape[0]
    labels = torch.arange(m, device=adj.device)
    sentinel = torch.full((), m, dtype=labels.dtype, device=adj.device)
    while True:
        neigh = torch.where(adj, labels[None, :], sentinel)
        best = torch.minimum(labels, neigh.min(dim=1).values)
        best = torch.minimum(best, best[best])  # pointer jumping: two hops per sweep
        with sanctioned_pull("cluster.sweep"):
            changed = bool((best != labels).any())
        labels = best
        if not changed:
            return labels


def iterative_clustering(
    visible: torch.Tensor,  # (M_pad, F) bool mask-level visible_frame
    contained: torch.Tensor,  # (M_pad, M_pad) bool mask-level contained_mask
    active: torch.Tensor,  # (M_pad,) bool: valid & not undersegmented
    schedule: torch.Tensor,  # (T,) f32 observer thresholds, +inf padded
    init: Optional[torch.Tensor] = None,  # (M_pad,) int prior assignment
    *,
    view_consensus_threshold: float = 0.9,
    count_dtype: str = "bf16",
) -> ClusterResult:
    """``init`` warm-starts the merge from a prior assignment instead of
    singletons (``clustering.py:68-118``); ``init=None`` is the cold start.
    An ``init`` that refines the final components (``arange`` among them)
    gives the cold start's result: min-label propagation does not depend on
    such a starting partition."""
    m_pad = visible.shape[0]
    dev = visible.device
    arange = torch.arange(m_pad, device=dev)
    eye = torch.eye(m_pad, dtype=torch.bool, device=dev)
    vis_m = visible & active[:, None]
    con_m = contained & active[:, None]
    consensus = torch.full((), view_consensus_threshold, dtype=torch.float32, device=dev)

    def aggregate(assign):
        """Segment-OR of mask features into representative slots."""
        onehot = (assign[None, :] == arange[:, None]) & active[None, :]  # (rep, member)
        v = counting.count_dot(onehot, vis_m, count_dtype=count_dtype, out_dtype=None) > 0
        c = counting.count_dot(onehot, con_m, count_dtype=count_dtype, out_dtype=None) > 0
        return v, c, onehot.any(dim=1)

    assign = arange if init is None else init.to(device=dev, dtype=arange.dtype)
    with sanctioned_pull("cluster.schedule"):
        # one 20-float read decides the loop length
        is_inf = torch.isinf(schedule).cpu().tolist()
    for t in range(schedule.shape[0]):
        if is_inf[t]:
            break
        v, c, rep_active = aggregate(assign)
        observers = counting.count_dot(v, v.T, count_dtype=count_dtype)
        supporters = counting.count_dot(c, c.T, count_dtype=count_dtype)
        rate = supporters / (observers + torch.full_like(observers, 1e-7))
        adj = (rate >= consensus) & (observers >= schedule[t])
        adj = adj & ~eye & rep_active[:, None] & rep_active[None, :]
        labels = _connected_components(adj)
        assign = labels[assign]  # members follow their representative
    v, _, rep_active = aggregate(assign)
    return ClusterResult(assignment=assign.to(torch.int32), node_visible=v,
                         node_active=rep_active)
