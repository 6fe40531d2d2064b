"""DBSCAN labels on the host, with scipy (counterpart of ``ops/dbscan.py:26-57``).

The JAX package dispatches to its native C++ grid DBSCAN, else sklearn;
the port needs neither. The labels follow the native contract
(``maskclustering_tpu/native/src/mc_native.cpp:86-90``), which is also
sklearn's and Open3D's:

- ``min_points`` counts the point itself; a point is core when at least
  ``min_points`` points (itself included) lie within ``eps``;
- core points within ``eps`` of each other share a cluster; clusters are
  numbered 0, 1, ... in ascending order of their lowest core index;
- a border point (not core, within ``eps`` of a core point) takes the
  lowest cluster label among its in-range core points;
- everything else is noise, -1.

The post-process uses these labels directly as group ids, so the numbering
is part of the exported artifacts.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree


def dbscan_labels(points: np.ndarray, eps: float, min_points: int) -> np.ndarray:
    """Standard DBSCAN labels (int64); -1 = noise."""
    points = np.ascontiguousarray(np.asarray(points, dtype=np.float64))
    n = len(points)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    pairs = cKDTree(points).query_pairs(eps, output_type="ndarray")  # (E, 2), i < j
    a, b = pairs[:, 0], pairs[:, 1]
    degree = 1 + np.bincount(a, minlength=n) + np.bincount(b, minlength=n)
    core = degree >= min_points

    both = core[a] & core[b]
    graph = coo_matrix((np.ones(int(both.sum()), dtype=np.int8), (a[both], b[both])),
                       shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    core_idx = np.nonzero(core)[0]
    labels = np.full(n, -1, dtype=np.int64)
    if len(core_idx):
        comp_core = comp[core_idx]
        # number components by their lowest core index (first appearance)
        comps, first = np.unique(comp_core, return_index=True)
        label_of = np.empty(comp.max() + 1, dtype=np.int64)
        label_of[comps[np.argsort(first)]] = np.arange(len(comps))
        labels[core_idx] = label_of[comp_core]

    # border points: lowest label among their in-range core neighbours
    to_a = ~core[a] & core[b]
    to_b = core[a] & ~core[b]
    border = np.concatenate([a[to_a], b[to_b]])
    if len(border):
        best = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(best, border, np.concatenate([labels[b[to_a]], labels[a[to_b]]]))
        hit = ~core & (best != np.iinfo(np.int64).max)
        labels[hit] = best[hit]
    return labels


def dbscan_labels_parallel(point_sets, eps: float, min_points: int):
    """``dbscan_labels`` over many point sets, in their order, on a thread
    pool of up to ``os.cpu_count()`` workers, as ``ops/dbscan.py:41-57``
    does; a plain loop for 0 or 1 sets."""
    point_sets = list(point_sets)
    if len(point_sets) <= 1:
        return [dbscan_labels(p, eps, min_points) for p in point_sets]
    workers = min(len(point_sets), os.cpu_count() or 4)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(lambda p: dbscan_labels(p, eps, min_points), point_sets))
