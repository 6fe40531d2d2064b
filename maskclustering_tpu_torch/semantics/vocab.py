"""Benchmark label vocabularies (ScanNet / Matterport3D / ScanNet++).

Copy of ``maskclustering_tpu/semantics/vocab.py:16-35``: fixed label lists
stored as JSON under ``vocab_data/`` (copies of the JAX package's files).
"""

from __future__ import annotations

import functools
import json
import os
from typing import List, Tuple

_VOCAB_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vocab_data")

_ALIASES = {"matterport": "matterport3d", "demo": "scannet"}


def vocab_name(dataset: str) -> str:
    """Canonical vocabulary name for a dataset (demo shares scannet's)."""
    return _ALIASES.get(dataset, dataset)


@functools.lru_cache(maxsize=None)
def get_vocab(dataset: str) -> Tuple[List[str], List[int]]:
    """Return (labels, ids) for a dataset's benchmark vocabulary."""
    dataset = vocab_name(dataset)
    path = os.path.join(_VOCAB_DIR, f"{dataset}.json")
    if not os.path.exists(path):
        raise KeyError(f"no vocabulary for dataset {dataset!r}")
    with open(path) as f:
        d = json.load(f)
    return d["labels"], d["ids"]
