"""Compact host-to-device feed of the per-frame stacks (``io/feed.py:41-146``).

ScanNet-family depth is natively uint16 (millimetres, or 0.25 mm) and mask
ids fit uint16, so uploading float32 depth and int32 ids moves two to four
times the bytes the data holds. The feed encodes a stack to uint16 on the
host when, and only when, the round trip is bit-exact, uploads that, and
decodes on the device with one cast and one float32 multiply, the same
operation the loader's ``read_depth_png`` made (``io/image.py``). The
decoded tensor therefore has the host float32 array's bits, and every
stage downstream is unchanged. Depth that never was quantised (synthetic
scenes with noise) passes through as float32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from maskclustering_tpu_torch.device import DeviceLike, resolve_device

# depth quantisation steps tried in order: millimetres (ScanNet, demo and
# TASMap PNG scale 1000), then 0.25 mm (Matterport3D and ScanNet++ iPhone
# scale 4000)
DEPTH_SCALES = (1000.0, 4000.0)

# The fused mesh step (``parallel/sharded.py``) carries the feed encoding in
# the dtype alone, so uint16 there means exactly this one quantisation: its
# encoder (``parallel/batch.pad_scene_batch``) tries no other scale
FUSED_FEED_DEPTH_SCALE = 1000.0


def _roundtrips(arr: np.ndarray, scale: float) -> Tuple[bool, np.ndarray]:
    """(ok, quanta): uint16 quanta reproduce ``arr`` bit-exactly at ``scale``.

    Non-finite values fail the range comparisons (NaN compares False).
    """
    q = np.rint(arr * np.float32(scale))
    with np.errstate(invalid="ignore"):
        if not ((q >= 0) & (q <= 65535)).all():
            return False, q
    q16 = q.astype(np.uint16)
    return bool((q16.astype(np.float32) * np.float32(1.0 / scale) == arr).all()), q16


def encode_depth(depths: np.ndarray,
                 scales: Tuple[float, ...] = DEPTH_SCALES) -> Tuple[np.ndarray, float]:
    """(encoded, scale): uint16 quanta at the first of ``scales`` that is
    bit-exact, else (float32, 0.0).

    A strided probe of about 4k elements rejects never-quantised depth
    before any full-array pass.
    """
    depths = np.asarray(depths)
    if depths.dtype != np.float32:
        return np.asarray(depths, np.float32), 0.0
    flat = depths.ravel()
    probe = flat[:: max(flat.size // 4096, 1)]
    for scale in scales:
        if not _roundtrips(probe, scale)[0]:
            continue
        ok, q16 = _roundtrips(flat, scale)
        if ok:
            return q16.reshape(depths.shape), scale
    return depths, 0.0


def decode_depth(encoded: torch.Tensor, scale: float) -> torch.Tensor:
    """Inverse of :func:`encode_depth` on ``encoded``'s device: the float32
    cast times ``float32(1 / scale)`` (a float32 tensor, not a host scalar);
    scale 0.0 is the float32 passthrough."""
    if scale == 0.0:
        return encoded
    inv = torch.full((), 1.0 / scale, dtype=torch.float32, device=encoded.device)
    return encoded.to(torch.float32) * inv


def encode_seg(segs: np.ndarray) -> np.ndarray:
    """uint16 when every id fits (CropFormer ids are uint16), else int32."""
    segs = np.asarray(segs)
    if segs.dtype == np.uint16:
        return segs
    if segs.size and (segs.min() >= 0) and (segs.max() <= 65535):
        return segs.astype(np.uint16)
    return np.asarray(segs, np.int32)


def to_device_frames(depths: np.ndarray, segs: np.ndarray, device: DeviceLike = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Upload host (depths, segs) compactly; returns the decoded float32
    depth and int32 id tensors on ``device``."""
    dev = resolve_device(device)
    enc, scale = encode_depth(depths)
    d_dev = decode_depth(torch.from_numpy(np.ascontiguousarray(enc)).to(dev), scale)
    # torch has no uint16 arithmetic on every device; the cast is exact
    s_dev = torch.from_numpy(np.ascontiguousarray(encode_seg(segs))).to(dev).to(torch.int32)
    return d_dev, s_dev
