"""ScanNet-benchmark AP evaluation (L5), port of ``maskclustering_tpu/evaluation``."""

from maskclustering_tpu_torch.evaluation.instances import (
    GTInstance,
    group_instances,
    load_gt_ids,
)
from maskclustering_tpu_torch.evaluation.ap import (
    DEFAULT_OVERLAPS,
    MIN_REGION_SIZE,
    assign_instances_for_scan,
    compute_averages,
    evaluate_matches,
    evaluate_scans,
    format_results,
    write_result_file,
)

__all__ = [
    "GTInstance",
    "group_instances",
    "load_gt_ids",
    "DEFAULT_OVERLAPS",
    "MIN_REGION_SIZE",
    "assign_instances_for_scan",
    "compute_averages",
    "evaluate_matches",
    "evaluate_scans",
    "format_results",
    "write_result_file",
]
