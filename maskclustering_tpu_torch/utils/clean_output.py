"""Remove per-scene output dirs across a split (``utils/clean_output.py``;
reference utils/clean_all_output.py:9-25).

Deletes ``<scene>/output`` (masks + object dicts) for every scene of a
dataset split so a benchmark run can start clean. Dry-run by default from
the CLI to avoid the reference's silent rm -r behavior.

Usage: python -m maskclustering_tpu_torch.utils.clean_output --config scannet [--yes]
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import List, Optional, Sequence


def clean_scene_outputs(cfg, seq_names: Sequence[str],
                        dry_run: bool = False) -> List[str]:
    """Remove each scene's output dir; returns the paths (to be) removed."""
    from maskclustering_tpu_torch.datasets import get_dataset

    removed = []
    for seq in seq_names:
        ds = get_dataset(cfg.dataset, seq, data_root=cfg.data_root)
        out_dir = os.path.join(ds.root, "output")
        if os.path.isdir(out_dir):
            removed.append(out_dir)
            if not dry_run:
                shutil.rmtree(out_dir)
    return removed


def main(argv: Optional[Sequence[str]] = None) -> None:
    from maskclustering_tpu_torch.config import load_config
    from maskclustering_tpu_torch.run import get_seq_name_list

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--seq_name_list", default=None,
                        help="+-joined scene names (defaults to the split file)")
    parser.add_argument("--yes", action="store_true",
                        help="actually delete (default: dry-run listing)")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    seqs = get_seq_name_list(cfg.dataset, seq_name_list=args.seq_name_list)
    removed = clean_scene_outputs(cfg, seqs, dry_run=not args.yes)
    verb = "removed" if args.yes else "would remove"
    for path in removed:
        print(f"{verb} {path}")
    print(f"{verb} {len(removed)} scene output dirs")


if __name__ == "__main__":
    main()
