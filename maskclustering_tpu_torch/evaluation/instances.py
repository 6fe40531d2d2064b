"""Ground-truth instance encoding and grouping.

Copy of ``maskclustering_tpu/evaluation/instances.py:17-60``. The GT
contract follows the ScanNet benchmark (reference evaluation/utils_3d.py:11-65):
a per-vertex integer file where ``instance_id = label_id * 1000 + inst + 1`` and
0 means unannotated. Instances are grouped per class label; ids whose label is
outside the benchmark vocabulary are "void" and ignored by the matcher.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np


def load_gt_ids(path: str) -> np.ndarray:
    """Load a per-vertex GT id file (one integer per line)."""
    return np.loadtxt(path, dtype=np.int64)


@dataclasses.dataclass
class GTInstance:
    """One ground-truth instance (reference utils_3d.py:11-41)."""

    instance_id: int
    label_id: int
    vert_count: int
    med_dist: float = -1.0
    dist_conf: float = 0.0

    @classmethod
    def from_ids(cls, gt_ids: np.ndarray, instance_id: int) -> "GTInstance":
        return cls(
            instance_id=int(instance_id),
            label_id=int(instance_id // 1000),
            vert_count=int((gt_ids == instance_id).sum()),
        )


def group_instances(
    gt_ids: np.ndarray,
    valid_ids: Sequence[int],
    labels: Sequence[str],
    id_to_label: Dict[int, str],
) -> Dict[str, List[GTInstance]]:
    """Group GT instances by class label (reference utils_3d.py:54-65).

    id 0 (unannotated) is skipped; ids with out-of-vocabulary labels are
    dropped here and counted as void by the matcher.
    """
    valid = set(int(v) for v in valid_ids)
    grouped: Dict[str, List[GTInstance]] = {label: [] for label in labels}
    for iid in np.unique(gt_ids):
        if iid == 0:
            continue
        inst = GTInstance.from_ids(gt_ids, int(iid))
        if inst.label_id in valid:
            grouped[id_to_label[inst.label_id]].append(inst)
    return grouped
