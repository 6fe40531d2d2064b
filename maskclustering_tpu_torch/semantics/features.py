"""Per-mask open-vocabulary features: crop, encode, pool over scales.

Port of ``maskclustering_tpu/semantics/features.py:28-107`` (reference
semantics/get_open-voc_features.py:109-149): gather the representative
masks of every object from ``object_dict.npy``, crop each at 3 scales,
encode, and average the scales into one feature per (frame, mask). The
artifact is the JAX package's:
``<object_dict_dir>/<config>/open-vocabulary_features.npy`` maps
``"{frame_id}_{mask_id}"`` to a (D,) float32 vector.

The scale mean runs on the caller's device (``pool_scale_features``);
frames decode on a thread pool.
"""

from __future__ import annotations

import collections
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from maskclustering_tpu_torch.device import DeviceLike, resolve_device
from maskclustering_tpu_torch.io.image import read_mask_png, read_rgb
from maskclustering_tpu_torch.semantics.crops import CROP_SCALES, multiscale_crops
from maskclustering_tpu_torch.semantics.encoder import ImageEncoder


def pool_scale_features(features: np.ndarray, num_scales: int = CROP_SCALES, *,
                        device: DeviceLike = None) -> np.ndarray:
    """(B*S, D) per-crop features -> (B, D) per-mask features, on ``device``.

    The plain mean over scales, not re-normalised (reference
    get_open-voc_features.py:140-143). It rounds as the JAX package's
    ``jnp.mean`` does: the scales summed in order, then a multiply by the
    reciprocal of the count rounded to float32 (XLA turns the division by
    a constant into that multiply). ``torch.mean`` rounds differently and
    would change every saved feature.
    """
    device = resolve_device(device)
    b = features.shape[0] // num_scales
    f = torch.from_numpy(np.ascontiguousarray(features, dtype=np.float32)).to(device)
    f = f.reshape(b, num_scales, -1)
    total = f[:, 0]
    for s in range(1, num_scales):
        total = total + f[:, s]
    inv = torch.tensor(1.0 / num_scales, dtype=torch.float32, device=device)
    return (total * inv).cpu().numpy()


def representative_mask_index(object_dict: Dict) -> List[Tuple[str, int]]:
    """Unique (frame_id, mask_id) pairs over all objects' representative masks."""
    seen = []
    seen_set = set()
    for value in object_dict.values():
        for mask_info in value.get("repre_mask_list", []):
            key = (mask_info[0], int(mask_info[1]))
            if key not in seen_set:
                seen_set.add(key)
                seen.append(key)
    return seen


def extract_mask_features(
    dataset,
    object_dict: Dict,
    encoder: ImageEncoder,
    *,
    batch_size: int = 64,
    io_workers: int = 16,
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """Feature dict ``"{frame}_{mask}" -> (D,)`` for all representative masks.

    ``dataset`` provides ``get_frame_path(frame_id) -> (rgb_path, seg_path)``.
    Unlike the JAX package, which reads the frame again for every (frame,
    mask) pair, each distinct colour frame and id-map of the call is decoded
    once and kept until its last pair is cropped: the same bytes give the
    same pixels, so the features are the same.
    """
    device = resolve_device(device)
    pairs = representative_mask_index(object_dict)
    if not pairs:
        return {}
    uses = collections.Counter(frame_id for frame_id, _ in pairs)
    frames: Dict = {}

    def load_frame(frame_id):
        rgb_path, seg_path = dataset.get_frame_path(frame_id)
        return read_rgb(rgb_path), read_mask_png(seg_path)

    def crops_of(pair):
        frame_id, mask_id = pair
        rgb, seg = frames[frame_id]
        return multiscale_crops(rgb, seg == mask_id)

    out: Dict[str, np.ndarray] = {}
    with ThreadPoolExecutor(max_workers=io_workers) as pool:
        for start in range(0, len(pairs), batch_size):
            chunk = pairs[start:start + batch_size]
            new = list(dict.fromkeys(f for f, _ in chunk if f not in frames))
            frames.update(zip(new, pool.map(load_frame, new)))
            crops_per_mask = list(pool.map(crops_of, chunk))
            for frame_id, _ in chunk:
                uses[frame_id] -= 1
                if not uses[frame_id]:
                    del frames[frame_id]
            flat = [c for crops in crops_per_mask for c in crops]
            pooled = pool_scale_features(encoder.encode_images(flat), device=device)
            for (frame_id, mask_id), feat in zip(chunk, pooled):
                out[f"{frame_id}_{mask_id}"] = feat
    return out


def save_mask_features(features: Dict[str, np.ndarray], object_dict_dir: str,
                       config_name: str) -> str:
    path = os.path.join(object_dict_dir, config_name, "open-vocabulary_features.npy")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, features, allow_pickle=True)
    return path


def extract_label_features(labels: Sequence[str], encoder, save_path: str) -> str:
    """Text features of a benchmark vocabulary, saved as a dict label -> (D,)."""
    feats = encoder.encode_texts(list(labels))
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    np.save(save_path, {label: feats[i] for i, label in enumerate(labels)}, allow_pickle=True)
    return save_path
