"""ScanNet++ preprocessing: config emission for the official toolkit
(``preprocess/scannetpp.py``, its YAML emitter copied).

The reference preprocesses ScanNet++ entirely through the external
`scannetpp` toolkit, shipping only yml configs for its four stages
(reference preprocess/scannetpp/*.yml, README.md:125-137): download,
iPhone RGB extraction, depth rendering, and training-data / semantic-GT
preparation (mesh sampled x0.25, instance GT in the ScanNet
`sem*1000 + inst` encoding). This module emits those configs
programmatically with the paths/knobs parameterised instead of hardcoded,
so a user points them at their data root and runs the toolkit unchanged.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence


def _dump_yaml(obj, indent: int = 0) -> str:
    """Minimal YAML emitter for the flat/nested dict+list configs we write."""
    lines = []
    pad = "  " * indent
    if isinstance(obj, dict):
        for k, v in obj.items():
            if isinstance(v, dict):
                lines.append(f"{pad}{k}:")
                lines.append(_dump_yaml(v, indent + 1))
            elif isinstance(v, list) and v and isinstance(v[0], str) and len(v) <= 12:
                lines.append(f"{pad}{k}: [{', '.join(v)}]")
            elif isinstance(v, list):
                lines.append(f"{pad}{k}:")
                for item in v:
                    lines.append(f"{pad}  - {item}")
            elif isinstance(v, bool):
                lines.append(f"{pad}{k}: {str(v).lower()}")
            else:
                lines.append(f"{pad}{k}: {v}")
    return "\n".join(lines)


def write_toolkit_configs(
    out_dir: str,
    data_root: str = "data",
    split: str = "nvs_sem_val",
    sample_factor: float = 0.25,
    near: float = 0.05,
    far: float = 20.0,
    token: Optional[str] = None,
    splits_list: Optional[Sequence[str]] = None,
) -> dict:
    """Write the four toolkit configs into out_dir; returns {name: path}.

    sample_factor is the mesh point-sampling density for the processed
    cloud (reference prepare_training_data.yml:20 `sample_factor: 0.25`);
    near/far bound the iPhone depth render (reference render.yml).
    """
    os.makedirs(out_dir, exist_ok=True)
    splits_list = list(splits_list) if splits_list is not None else [split]
    configs = {
        "download_scannetpp.yml": {
            "token": token or "YOUR_TOKEN_HERE",
            "data_root": data_root,
            "root_url": "https://kaldir.vc.in.tum.de/scannetpp/download?token=TOKEN&file=FILEPATH",
            "metadata_only": False,
            "verbose": False,
            "download_splits": splits_list,
            "default_assets": [
                "scan_mesh_path", "scan_mesh_mask_path",
                "scan_mesh_segs_path", "scan_anno_json_path", "scan_sem_mesh_path",
                "iphone_video_path", "iphone_video_mask_path", "iphone_depth_path",
                "iphone_pose_intrinsic_imu_path", "iphone_colmap_dir", "iphone_exif_path",
            ],
        },
        "prepare_iphone_data.yml": {
            "extract_rgb": True,
            "extract_masks": False,
            "extract_depth": False,
            "data_root": data_root,
            "splits": splits_list,
        },
        "render.yml": {
            "data_root": data_root,
            "render_iphone": True,
            "render_dslr": False,
            "splits": splits_list,
            "near": near,
            "far": far,
            "output_dir": os.path.join(data_root, "data"),
        },
        "prepare_training_data.yml": {
            "data": {
                "data_root": os.path.join(data_root, "data"),
                "labels_path": os.path.join(data_root, "metadata/semantic_classes.txt"),
                "use_instances": True,
                "instance_labels_path": os.path.join(data_root, "metadata/instance_classes.txt"),
                "mapping_file": os.path.join(data_root, "metadata/semantic_benchmark/map_benchmark.csv"),
                "list_path": os.path.join(data_root, f"splits/{split}.txt"),
                "ignore_label": -100,
                "sample_factor": sample_factor,
                "transforms": [
                    "add_mesh_vertices", "map_label_to_index",
                    "get_labels_on_vertices", "sample_points_on_mesh",
                ],
            },
            "out_dir": os.path.join(data_root, f"pcld_{sample_factor}"),
        },
        "prepare_semantic_gt.yml": {
            "pth_dir": os.path.join(data_root, f"pcld_{sample_factor}"),
            "scene_list": os.path.join(data_root, f"splits/{split}.txt"),
            "save_npy": False,
            "save_txt": True,
            "save_semantic": False,
            "save_instance": True,
            "inst_gt_format": True,  # sem*1000 + inst, ScanNet encoding
            "inst_gtformat_out_dir": os.path.join(data_root, "gt"),
            "inst_preds_format": False,
        },
    }
    paths = {}
    for name, cfg in configs.items():
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            f.write(_dump_yaml(cfg) + "\n")
        paths[name] = path
    return paths
