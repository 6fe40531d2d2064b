"""Matterport3D GT preparation: house mesh + segment jsons -> per-vertex ids
(``preprocess/matterport.py``).

Reference preprocess/matterport3d/process.py:41-68: faces of the
house_segmentations ply carry a raw `category_id`; fsegs.json maps faces to
segment ids; semseg.json groups segments into instances. Face attributes
are splatted onto vertices (last face writing a vertex wins), raw category
ids map to NYU ids through the category_mapping tsv, ids outside the valid
set drop to 0, and the GT encoding is `nyu_id*1000 + instance + 1`.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Optional, Sequence

import numpy as np

from maskclustering_tpu_torch.io.ply import read_ply_mesh

# GT keeps wall(4)/floor(11)/ceiling(21) although evaluation's 157-class
# vocabulary excludes them (reference preprocess/matterport3d/constants.py
# MATTERPORT_VALID_IDS vs evaluation/constants.py MATTERPORT_IDS).
GT_ONLY_IDS = (4, 11, 21)


def load_raw_to_nyu(tsv_path: str) -> np.ndarray:
    """RAW category id -> NYU id lookup from category_mapping.tsv.

    Index 0 is the unknown category; row i of the tsv is raw id i+1
    (reference preprocess/matterport3d/constants.py:3-4).
    """
    nyu = [0]
    with open(tsv_path, newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            try:
                nyu.append(int(float(row["nyuId"])))
            except (ValueError, TypeError):
                nyu.append(0)
    return np.asarray(nyu, dtype=np.int64)


def _faces_to_vertices(values: np.ndarray, faces: np.ndarray, n_verts: int) -> np.ndarray:
    """Splat one per-face value onto each of its 3 vertices (last wins)."""
    out = np.zeros(n_verts, dtype=np.int64)
    out[faces.reshape(-1)] = np.repeat(values.astype(np.int64), 3)
    return out


def convert_matterport_gt(
    root_dir: str,
    seq_name: str,
    output_dir: str,
    category_mapping_tsv: str,
    valid_ids: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Write `<seq_name>.txt` GT for one house scan; returns the id array."""
    if valid_ids is None:
        from maskclustering_tpu_torch.semantics.vocab import get_vocab

        valid_ids = list(get_vocab("matterport3d")[1]) + list(GT_ONLY_IDS)
    scene_dir = os.path.join(root_dir, seq_name, seq_name, "house_segmentations")
    verts, faces, face_props = read_ply_mesh(
        os.path.join(scene_dir, f"{seq_name}.ply"))
    if "category_id" not in face_props:
        raise ValueError(f"{seq_name}.ply faces carry no category_id")
    vert_semantic = _faces_to_vertices(
        np.asarray(face_props["category_id"], dtype=np.int64), faces, len(verts))

    with open(os.path.join(scene_dir, f"{seq_name}.fsegs.json")) as f:
        face_segment = np.asarray(json.load(f)["segIndices"], dtype=np.int64)
    vert_segment = _faces_to_vertices(face_segment, faces, len(verts))

    with open(os.path.join(scene_dir, f"{seq_name}.semseg.json")) as f:
        seg_groups = json.load(f)["segGroups"]
    segment_instance = np.full(int(vert_segment.max()) + 1, -1, dtype=np.int64)
    for instance_id, group in enumerate(seg_groups):
        members = np.asarray(group["segments"], dtype=np.int64)
        members = members[members < len(segment_instance)]
        segment_instance[members] = instance_id
    vert_instance = segment_instance[vert_segment]
    if vert_instance.min() < 0:
        raise ValueError(f"{seq_name}: vertices outside every instance group")

    raw_to_nyu = load_raw_to_nyu(category_mapping_tsv)
    # ids outside the mapping table are unknown, not the last row's label
    vert_semantic[(vert_semantic < 0) | (vert_semantic >= len(raw_to_nyu))] = 0
    vert_semantic = raw_to_nyu[vert_semantic]
    vert_semantic[~np.isin(vert_semantic, np.asarray(list(valid_ids)))] = 0

    gt = vert_semantic * 1000 + vert_instance + 1
    os.makedirs(output_dir, exist_ok=True)
    np.savetxt(os.path.join(output_dir, f"{seq_name}.txt"),
               gt.astype(np.int64), fmt="%d")
    return gt
