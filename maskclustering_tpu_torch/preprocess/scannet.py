"""ScanNet raw-data preprocessing: .sens export + GT preparation
(``preprocess/scannet.py``).

The .sens container is ScanNet's public binary capture format (version 4):
a header (sensor name, color/depth intrinsics+extrinsics as 4x4 float32,
compression enums, image sizes, depth shift, frame count) followed by
per-frame records (camera-to-world 4x4 float32, two uint64 timestamps,
length-prefixed color/depth payloads; depth is zlib'd uint16, color JPEG).
``iter_sens_frames`` streams records lazily so a multi-GB scan never has to
fit in host memory.

``export_sens_scene`` writes the processed layout with the JAX module's
bytes: colour through ``io/jpeg.encode_jpeg`` at quality 95 (PIL's
``Image.save(..., quality=95)``), resized through
``io/image.resize_bilinear`` (PIL's ``BILINEAR``) when ``image_size`` asks;
depth through ``io/image.write_depth_png`` (cv2's ``imwrite``).

GT preparation follows reference preprocess/scannet/prepare_gt.py:22-95:
per-vertex ``label_id*1000 + instance_id + 1`` from the ``.segs.json``
segment map and ``.aggregation.json`` groups, with raw category names
mapped through the scannetv2-labels tsv and restricted to the ScanNet
benchmark ids.
"""

from __future__ import annotations

import csv
import json
import multiprocessing
import os
import struct
import zlib
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from maskclustering_tpu_torch.io.image import (
    decode_rgb,
    resize_bilinear,
    resize_nearest,
    write_depth_png,
)
from maskclustering_tpu_torch.io.jpeg import write_jpeg

_COLOR_COMPRESSION = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
_DEPTH_COMPRESSION = {-1: "unknown", 0: "raw_ushort", 1: "zlib_ushort", 2: "occi_ushort"}

CLOUD_FILE_SUFFIX = "_vh_clean_2"
SEGMENTS_FILE_SUFFIX = ".0.010000.segs.json"
AGGREGATIONS_FILE_SUFFIX = ".aggregation.json"
# the export's colour quality (the JAX module's PIL save)
EXPORT_JPEG_QUALITY = 95


@dataclass
class SensHeader:
    sensor_name: str
    intrinsic_color: np.ndarray
    extrinsic_color: np.ndarray
    intrinsic_depth: np.ndarray
    extrinsic_depth: np.ndarray
    color_compression: str
    depth_compression: str
    color_width: int
    color_height: int
    depth_width: int
    depth_height: int
    depth_shift: float
    num_frames: int


@dataclass
class SensFrame:
    index: int
    camera_to_world: np.ndarray  # (4,4) float32
    timestamp_color: int
    timestamp_depth: int
    color_bytes: bytes  # compressed payload (jpeg/png/raw)
    depth_bytes: bytes  # compressed payload

    def depth(self, header: SensHeader) -> np.ndarray:
        """Decode the depth payload to (H,W) uint16 (raw sensor units)."""
        if header.depth_compression == "zlib_ushort":
            raw = zlib.decompress(self.depth_bytes)
        elif header.depth_compression == "raw_ushort":
            raw = self.depth_bytes
        else:
            raise NotImplementedError(
                f"depth compression {header.depth_compression!r}")
        return np.frombuffer(raw, dtype=np.uint16).reshape(
            header.depth_height, header.depth_width)

    def color(self, header: SensHeader) -> np.ndarray:
        """Decode the color payload to (H,W,3) uint8 RGB: JPEG and PNG
        through the port's codecs (``io/image.decode_rgb``)."""
        if header.color_compression in ("jpeg", "png"):
            return decode_rgb(self.color_bytes, name=f"sens frame {self.index}")
        if header.color_compression == "raw":
            return np.frombuffer(self.color_bytes, dtype=np.uint8).reshape(
                header.color_height, header.color_width, 3)
        raise NotImplementedError(f"color compression {header.color_compression!r}")


def _read_mat4(f) -> np.ndarray:
    return np.frombuffer(f.read(64), dtype="<f4").reshape(4, 4).copy()


def read_sens_header(f) -> SensHeader:
    (version,) = struct.unpack("<I", f.read(4))
    if version != 4:
        raise ValueError(f"unsupported .sens version {version} (expected 4)")
    (strlen,) = struct.unpack("<Q", f.read(8))
    sensor_name = f.read(strlen).decode("ascii", errors="replace")
    intrinsic_color = _read_mat4(f)
    extrinsic_color = _read_mat4(f)
    intrinsic_depth = _read_mat4(f)
    extrinsic_depth = _read_mat4(f)
    color_comp, depth_comp = struct.unpack("<ii", f.read(8))
    cw, ch, dw, dh = struct.unpack("<IIII", f.read(16))
    (depth_shift,) = struct.unpack("<f", f.read(4))
    (num_frames,) = struct.unpack("<Q", f.read(8))
    return SensHeader(
        sensor_name=sensor_name,
        intrinsic_color=intrinsic_color, extrinsic_color=extrinsic_color,
        intrinsic_depth=intrinsic_depth, extrinsic_depth=extrinsic_depth,
        color_compression=_COLOR_COMPRESSION[color_comp],
        depth_compression=_DEPTH_COMPRESSION[depth_comp],
        color_width=cw, color_height=ch, depth_width=dw, depth_height=dh,
        depth_shift=depth_shift, num_frames=num_frames)


def iter_sens_frames(path: str) -> Iterator[Tuple[SensHeader, SensFrame]]:
    """Stream (header, frame) records from a .sens file without loading it."""
    with open(path, "rb") as f:
        header = read_sens_header(f)
        for i in range(header.num_frames):
            cam_to_world = _read_mat4(f)
            ts_color, ts_depth = struct.unpack("<QQ", f.read(16))
            color_n, depth_n = struct.unpack("<QQ", f.read(16))
            color_bytes = f.read(color_n)
            depth_bytes = f.read(depth_n)
            yield header, SensFrame(
                index=i, camera_to_world=cam_to_world,
                timestamp_color=ts_color, timestamp_depth=ts_depth,
                color_bytes=color_bytes, depth_bytes=depth_bytes)


def write_sens(path: str, header: SensHeader, frames: Sequence[SensFrame]) -> None:
    """Write a version-4 .sens file (synthetic captures + round-trip tests)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<I", 4))
        name = header.sensor_name.encode("ascii")
        f.write(struct.pack("<Q", len(name)) + name)
        for mat in (header.intrinsic_color, header.extrinsic_color,
                    header.intrinsic_depth, header.extrinsic_depth):
            f.write(np.asarray(mat, dtype="<f4").tobytes())
        rev_c = {v: k for k, v in _COLOR_COMPRESSION.items()}
        rev_d = {v: k for k, v in _DEPTH_COMPRESSION.items()}
        f.write(struct.pack("<ii", rev_c[header.color_compression],
                            rev_d[header.depth_compression]))
        f.write(struct.pack("<IIII", header.color_width, header.color_height,
                            header.depth_width, header.depth_height))
        f.write(struct.pack("<f", header.depth_shift))
        f.write(struct.pack("<Q", len(frames)))
        for fr in frames:
            f.write(np.asarray(fr.camera_to_world, dtype="<f4").tobytes())
            f.write(struct.pack("<QQ", fr.timestamp_color, fr.timestamp_depth))
            f.write(struct.pack("<QQ", len(fr.color_bytes), len(fr.depth_bytes)))
            f.write(fr.color_bytes)
            f.write(fr.depth_bytes)


def export_sens_scene(
    sens_path: str,
    output_path: str,
    frame_skip: int = 10,
    image_size: Optional[Tuple[int, int]] = None,
    export_depth: bool = True,
    export_color: bool = True,
    export_pose: bool = True,
    export_intrinsics: bool = True,
) -> int:
    """Export a .sens capture to the processed scene layout.

    Writes `depth/<i>.png` (16-bit), `color/<i>.jpg`, `pose/<i>.txt`
    (4x4 camera-to-world), and `intrinsic/intrinsic_{color,depth}.txt` +
    `extrinsic_*` at the given frame stride — the directory contract the
    dataset loaders consume (reference preprocess/scannet/reader.py:28-35,
    dataset/scannet.py:25-54). image_size is (H, W); depth is resized
    nearest-neighbor to preserve values, colour bilinearly. Returns #frames
    exported.
    """
    for sub in ("depth", "color", "pose"):
        os.makedirs(os.path.join(output_path, sub), exist_ok=True)
    os.makedirs(os.path.join(output_path, "intrinsic"), exist_ok=True)
    # header is readable even for a zero-frame capture
    with open(sens_path, "rb") as f:
        header = read_sens_header(f)
    n_exported = 0
    for header, frame in iter_sens_frames(sens_path):
        if frame.index % frame_skip != 0:
            continue
        fid = str(frame.index)
        if export_depth:
            depth = frame.depth(header)
            if image_size is not None:
                depth = resize_nearest(depth, (image_size[1], image_size[0]))
            write_depth_png(os.path.join(output_path, "depth", fid + ".png"), depth)
        if export_color:
            color = frame.color(header)
            if image_size is not None and color.shape[:2] != tuple(image_size):
                color = resize_bilinear(color, image_size[0], image_size[1])
            write_jpeg(os.path.join(output_path, "color", fid + ".jpg"), color,
                       EXPORT_JPEG_QUALITY)
        if export_pose:
            np.savetxt(os.path.join(output_path, "pose", fid + ".txt"),
                       frame.camera_to_world, fmt="%f")
        n_exported += 1
    if export_intrinsics:
        for name, mat in (("intrinsic_color", header.intrinsic_color),
                          ("extrinsic_color", header.extrinsic_color),
                          ("intrinsic_depth", header.intrinsic_depth),
                          ("extrinsic_depth", header.extrinsic_depth)):
            np.savetxt(os.path.join(output_path, "intrinsic", name + ".txt"),
                       mat, fmt="%f")
    return n_exported


# ---------------------------------------------------------------------------
# GT preparation


def load_label_map(tsv_path: str) -> dict:
    """raw_category name -> benchmark id from scannetv2-labels.combined.tsv."""
    mapping = {}
    with open(tsv_path, newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            try:
                mapping[row["raw_category"]] = int(row["id"])
            except (KeyError, ValueError, TypeError):
                continue
    return mapping


def scannet_scene_gt(scene_path: str, output_path: str, label_map: dict,
                     valid_ids: Optional[Sequence[int]] = None) -> np.ndarray:
    """Per-vertex GT ids for one scene; writes `<scene>.txt`, returns the ids.

    Matches reference prepare_gt.py:22-73: vertices outside any aggregation
    group get label 0 / instance 0; grouped vertices get the tsv-mapped
    label (0 if not a benchmark id) and instance `group_id + 1`; the final
    encoding is `label*1000 + instance + 1`.
    """
    if valid_ids is None:
        from maskclustering_tpu_torch.semantics.vocab import get_vocab

        valid_ids = get_vocab("scannet")[1]
    valid = set(int(v) for v in valid_ids)
    scene_id = os.path.basename(os.path.normpath(scene_path))
    segs_file = os.path.join(
        scene_path, f"{scene_id}{CLOUD_FILE_SUFFIX}{SEGMENTS_FILE_SUFFIX}")
    agg_file = os.path.join(scene_path, f"{scene_id}{AGGREGATIONS_FILE_SUFFIX}")
    with open(segs_file) as f:
        seg_indices = np.asarray(json.load(f)["segIndices"])
    with open(agg_file) as f:
        groups = json.load(f)["segGroups"]

    labels = np.zeros(len(seg_indices), dtype=np.int64)
    instances = np.zeros(len(seg_indices), dtype=np.int64)
    for group in groups:
        label_id = label_map.get(group["label"], 0)
        if label_id not in valid:
            label_id = 0
        member = np.isin(seg_indices, np.asarray(group["segments"]))
        labels[member] = label_id
        instances[member] = group["id"] + 1
    gt = labels * 1000 + instances + 1
    if output_path:
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        np.savetxt(output_path, gt, fmt="%d")
    return gt


def _gt_worker(job):
    scene_path, out_file, label_map = job
    scannet_scene_gt(scene_path, out_file, label_map)
    return os.path.basename(out_file)


def prepare_scannet_gt(raw_scans_dir: str, gt_dir: str, label_map_tsv: str,
                       scenes: Sequence[str], num_workers: int = 16) -> None:
    """Fan GT prep out over a process pool (reference prepare_gt.py:92-95),
    its workers spawned: a forked child of a process that holds torch's
    threads or a CUDA context can hang."""
    label_map = load_label_map(label_map_tsv)
    os.makedirs(gt_dir, exist_ok=True)
    jobs = [(os.path.join(raw_scans_dir, s), os.path.join(gt_dir, f"{s}.txt"),
             label_map) for s in scenes]
    if num_workers <= 1 or len(jobs) <= 1:
        for job in jobs:
            _gt_worker(job)
        return
    with ProcessPoolExecutor(max_workers=num_workers,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        list(pool.map(_gt_worker, jobs))
