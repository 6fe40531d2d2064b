"""3D scene visualisation: instance-coloured clouds (``visualize/scene.py``).

Port of the JAX package's module. The portable artifacts are coloured PLY
files, ``instances.ply`` and ``rgb.ply``, byte-equal to the JAX package's.
The JAX package also writes a pyviz3d bundle when that package happens to
be importable; the port imports torch, numpy, scipy and the standard
library only, so it has no pyviz3d branch and writes what the JAX package
writes where pyviz3d is missing.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from maskclustering_tpu_torch.io.ply import write_ply_points


def instance_palette(num: int, seed: int = 0) -> np.ndarray:
    """(num, 3) uint8 deterministic distinct-ish colours (the reference's
    random colour draw, made reproducible)."""
    rng = np.random.default_rng(seed)
    return rng.integers(40, 255, size=(num, 3)).astype(np.uint8)


def vis_scene(scene_points: np.ndarray, pred_masks: np.ndarray, out_dir: str,
              scene_colors: Optional[np.ndarray] = None, point_size: int = 20,
              seed: int = 0) -> Dict[str, str]:
    """Write instance-coloured scene artifacts; returns {name: path}.

    ``pred_masks`` is the (N_points, N_instances) bool matrix of the
    prediction npz. Writes ``instances.ply`` (labelled points only, one
    colour an instance, centred on the cloud's mean) and, given
    ``scene_colors``, ``rgb.ply`` (the scan colours, gamma tone-mapped).
    ``point_size`` sized the pyviz3d bundle in the JAX package and is
    accepted for its signature."""
    del point_size
    scene_points = np.asarray(scene_points, dtype=np.float64)
    centered = scene_points - scene_points.mean(axis=0)
    pred_masks = np.asarray(pred_masks, dtype=bool)
    num_instances = pred_masks.shape[1] if pred_masks.ndim == 2 else 0
    palette = instance_palette(num_instances, seed)

    instance_colors = np.zeros((len(centered), 3), dtype=np.uint8)
    for idx in range(num_instances):
        instance_colors[pred_masks[:, idx]] = palette[idx]

    os.makedirs(out_dir, exist_ok=True)
    out: Dict[str, str] = {}
    labeled = instance_colors.sum(axis=1) != 0
    inst_path = os.path.join(out_dir, "instances.ply")
    write_ply_points(inst_path, centered[labeled], instance_colors[labeled])
    out["instances"] = inst_path

    if scene_colors is not None:
        colors = np.asarray(scene_colors, dtype=np.float64)
        if colors.max(initial=0.0) > 1.0:
            colors = colors / 255.0
        toned = (np.power(colors, 1 / 2.2) * 255).astype(np.uint8)
        rgb_path = os.path.join(out_dir, "rgb.ply")
        write_ply_points(rgb_path, centered, toned)
        out["rgb"] = rgb_path
    return out
