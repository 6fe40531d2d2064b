"""Open-vocabulary label assignment for clustered objects.

Port of ``maskclustering_tpu/semantics/query.py:25-115`` (reference
semantics/open-voc_query.py:8-55): each object's feature is the mean of
its representative masks' features; the class is the argmax of
``softmax(feature . text_features^T * 100)``, written into the class-aware
prediction npz. The (O, D) x (D, L) product and the softmax run on the
caller's device in float32; the rest is host numpy, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from maskclustering_tpu_torch.device import DeviceLike, check_full_float32, resolve_device

LOGIT_SCALE = 100.0  # reference open-voc_query.py:43


def object_features(object_dict: Dict, mask_features: Dict[str, np.ndarray],
                    feature_dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """(O, D) object features = mean over representative-mask features.

    Objects with no representative masks (or all features missing) get a
    zero feature and valid=False; their class stays 0.
    """
    num = len(object_dict)
    feats = np.zeros((num, feature_dim), dtype=np.float32)
    valid = np.zeros(num, dtype=bool)
    for idx, value in enumerate(object_dict.values()):
        rows = [mask_features[f"{mi[0]}_{mi[1]}"]
                for mi in value.get("repre_mask_list", [])
                if f"{mi[0]}_{mi[1]}" in mask_features]
        if rows:
            feats[idx] = np.mean(np.stack(rows), axis=0)
            valid[idx] = True
    return feats, valid


def classify_objects(obj_feats: np.ndarray, text_feats: np.ndarray,
                     logit_scale: float = LOGIT_SCALE, *,
                     device: DeviceLike = None) -> np.ndarray:
    """(O,) vocabulary indices: softmax(sim * scale), then argmax, one matmul.

    Full float32 on the card: the JAX package asks for
    ``precision="highest"`` because a reduced-precision product can flip the
    argmax between close labels, so a process that has allowed TF32 float32
    matmuls is refused here rather than silently rounded.
    """
    device = resolve_device(device)
    check_full_float32(device, "classify_objects")
    obj = torch.from_numpy(np.ascontiguousarray(obj_feats, dtype=np.float32)).to(device)
    text = torch.from_numpy(np.ascontiguousarray(text_feats, dtype=np.float32)).to(device)
    sim = torch.matmul(obj, text.T)
    prob = torch.softmax(sim * logit_scale, dim=-1)
    return torch.argmax(prob, dim=-1).cpu().numpy()


def assign_labels(
    object_dict: Dict,
    mask_features: Dict[str, np.ndarray],
    label_features: Dict[str, np.ndarray],
    label_to_id: Dict[str, int],
    num_points: int,
    *,
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """Build the class-aware prediction dict (open-voc_query.py:23-53)."""
    descriptions = list(label_features.keys())
    text_feats = np.stack([np.asarray(label_features[d]) for d in descriptions])
    feature_dim = text_feats.shape[1]

    obj_feats, valid = object_features(object_dict, mask_features, feature_dim)
    classes = np.zeros(len(object_dict), dtype=np.int32)
    if valid.any():
        vocab_idx = classify_objects(obj_feats[valid], text_feats, device=device)
        ids = np.asarray([label_to_id[descriptions[i]] for i in vocab_idx], dtype=np.int32)
        classes[valid] = ids

    pred_masks = np.zeros((num_points, len(object_dict)), dtype=bool)
    for idx, value in enumerate(object_dict.values()):
        if not valid[idx]:
            # an object without features keeps an all-False column, which the
            # evaluator drops as sub-minimum (open-voc_query.py:33-35)
            continue
        pred_masks[np.asarray(list(value["point_ids"]), dtype=np.int64), idx] = True
    return {
        "pred_masks": pred_masks,
        "pred_score": np.ones(len(object_dict)),
        "pred_classes": classes,
    }


def run_query(dataset, config_name: str, seq_name: str,
              prediction_root: str = "data/prediction", *,
              device: DeviceLike = None) -> str:
    """File-level step: object_dict + features npy -> class-aware npz."""
    num_points = dataset.get_scene_points().shape[0]
    object_dict = np.load(
        os.path.join(dataset.object_dict_dir, config_name, "object_dict.npy"),
        allow_pickle=True).item()
    mask_features = np.load(
        os.path.join(dataset.object_dict_dir, config_name, "open-vocabulary_features.npy"),
        allow_pickle=True).item()
    label_features = dataset.get_label_features()
    label_to_id = dataset.get_label_id()[0]

    pred = assign_labels(object_dict, mask_features, label_features, label_to_id, num_points,
                         device=device)
    out_dir = os.path.join(prediction_root, config_name)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{seq_name}.npz")
    np.savez(out_path, **pred)
    return out_path
