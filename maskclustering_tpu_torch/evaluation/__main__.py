"""CLI: ``python -m maskclustering_tpu_torch.evaluation`` (``evaluation/__main__.py:17-67``).

Evaluates a directory of prediction npz files against GT txt files and writes
``data/evaluation/<dataset>/<config>[_class_agnostic].txt``. The intersection
counts run on ``--device`` (default: the CUDA card; ``--device cpu`` asks
for the CPU).
"""

from __future__ import annotations

import argparse
import os
import sys

from maskclustering_tpu_torch.config import COUNT_DTYPES
from maskclustering_tpu_torch.evaluation.ap import evaluate_scans


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="maskclustering_tpu_torch.evaluation",
        description="ScanNet-protocol AP evaluation")
    parser.add_argument("--pred_path", required=True,
                        help="directory of predicted .npz files")
    parser.add_argument("--gt_path", required=True,
                        help="directory of ground-truth .txt files")
    parser.add_argument("--dataset", required=True,
                        help="dataset vocabulary: scannet | matterport3d | scannetpp")
    parser.add_argument("--output_file", default="",
                        help="result txt path (default: data/evaluation/<dataset>/<pred dirname>.txt)")
    parser.add_argument("--no_class", action="store_true",
                        help="class-agnostic evaluation")
    parser.add_argument("--count_dtype", default="bf16",
                        choices=COUNT_DTYPES,
                        help="accumulator of the intersection products "
                             "(ops/counting.py; identical counts either way)")
    parser.add_argument("--device", default=None,
                        help="device of the intersection products (default: "
                             "the CUDA card; 'cpu' runs them on the CPU)")
    args = parser.parse_args(argv)

    output_file = args.output_file
    if not output_file:
        output_file = os.path.join(
            "data", "evaluation", args.dataset,
            os.path.basename(os.path.normpath(args.pred_path)) + ".txt")
    if args.no_class and "class_agnostic" not in output_file:
        root, ext = os.path.splitext(output_file)
        output_file = f"{root}_class_agnostic{ext or '.txt'}"

    pred_names = sorted(
        f for f in os.listdir(args.pred_path)
        if f.endswith(".npz") and not f.startswith("semantic_instance_evaluation"))
    pred_files, gt_files = [], []
    for name in pred_names:
        gt_file = os.path.join(args.gt_path, name.replace(".npz", ".txt"))
        if not os.path.isfile(gt_file):
            print(f"prediction {name} has no matching GT file {gt_file}",
                  file=sys.stderr)
            return 1
        pred_files.append(os.path.join(args.pred_path, name))
        gt_files.append(gt_file)

    evaluate_scans(pred_files, gt_files, args.dataset,
                   no_class=args.no_class, output_file=output_file,
                   count_dtype=args.count_dtype, device=args.device)
    print(f"saved results to {output_file}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
