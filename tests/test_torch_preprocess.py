"""The port's ingestion front (``preprocess/``, ``utils/clean_output.py``,
the JPEG encoder and bilinear resize they write through) against the JAX
package and PIL, byte for byte.

The encoder must write PIL's bytes (libjpeg-turbo at PIL's defaults) for
every size and quality tested; the resize PIL's pixels. Every converter,
fed the same seeded inputs as the JAX one, must write the same files, PNG
and PLY bytes included. C5: both packages' synthetic writers give equal
files. Expected results are exact.
"""

import hashlib
import importlib.util
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from maskclustering_tpu.config import load_config as jax_load_config
from maskclustering_tpu.preprocess import matterport as jax_matterport
from maskclustering_tpu.preprocess import scannet as jax_scannet
from maskclustering_tpu.preprocess import scannetpp as jax_scannetpp
from maskclustering_tpu.preprocess import tasmap as jax_tasmap
from maskclustering_tpu.utils import clean_output as jax_clean
from maskclustering_tpu.utils import synthetic as jax_synthetic
from maskclustering_tpu_torch.config import load_config
from maskclustering_tpu_torch.io import jpeg
from maskclustering_tpu_torch.io.image import resize_bilinear
from maskclustering_tpu_torch.preprocess import matterport, scannet, scannetpp, tasmap
from maskclustering_tpu_torch.utils import clean_output, synthetic

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pil_jpeg(img, quality):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _images(h, w, seed):
    """Random samples, smooth gradients and a flat colour (DC only)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    grad = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x + y) * 255 // max(h + w - 2, 1)], axis=-1).astype(np.uint8)
    return {"random": rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "gradient": grad,
            "flat": np.broadcast_to(rng.integers(0, 256, 3, dtype=np.uint8),
                                    (h, w, 3)).copy()}


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _assert_same_tree(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    assert [k for k in ta if ta[k] != tb[k]] == []
    return ta


# ---------------------------------------------------------------------------
# the encoder and the resize


@pytest.mark.parametrize("quality", [1, 50, 75, 90, 95, 100])
@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (8, 8), (9, 17), (16, 16), (17, 33),
                                (37, 53)])
def test_encode_jpeg_is_pils_bytes(hw, quality):
    """Every partial-MCU shape (odd block rows and columns, dummy blocks,
    an odd row replicated before the 2x2 downsample) at each quality."""
    for kind, img in _images(*hw, seed=hw[0] * 100 + quality).items():
        assert jpeg.encode_jpeg(img, quality) == _pil_jpeg(img, quality), kind


@pytest.mark.parametrize("hw,quality,kind", [((480, 640), 75, "random"),
                                             ((480, 640), 95, "gradient"),
                                             ((968, 1296), 95, "photo")])
def test_encode_jpeg_is_pils_bytes_at_frame_sizes(hw, quality, kind):
    if kind == "photo":
        rng = np.random.default_rng(3)
        y, x = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float32)
        shade = 60.0 * np.sin(x / 41.0) * np.cos(y / 29.0)
        img = np.clip((120.0 + shade)[..., None] + rng.normal(0, 5, hw + (3,)),
                      0, 255).astype(np.uint8)
    else:
        img = _images(*hw, seed=quality)[kind]
    assert jpeg.encode_jpeg(img, quality) == _pil_jpeg(img, quality)


def test_chip_smoke_probe_hash_is_pils():
    """The SHA-256 constant that chip_smoke.py's phase 18 holds the port's
    encoder to on the card (which has no PIL) is PIL's bytes' hash."""
    spec = importlib.util.spec_from_file_location("chip_smoke_probe",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    img = smoke.jpeg_probe_image()
    want = smoke.JPEG_PROBE_SHA256
    assert hashlib.sha256(_pil_jpeg(img, smoke.INGEST_QUALITY)).hexdigest() == want
    assert hashlib.sha256(jpeg.encode_jpeg(img, smoke.INGEST_QUALITY)).hexdigest() == want


@pytest.mark.parametrize("src,dst", [((968, 1296), (480, 640)), ((37, 53), (80, 120)),
                                     ((60, 80), (17, 23)), ((5, 7), (1, 1)),
                                     ((1, 1), (3, 4)), ((100, 100), (100, 37))])
def test_resize_bilinear_is_pils(src, dst):
    img = np.random.default_rng(src[0] + dst[1]).integers(0, 256, src + (3,), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]), Image.BILINEAR))
    np.testing.assert_array_equal(resize_bilinear(img, *dst), want)


# ---------------------------------------------------------------------------
# .sens


def _capture(pkg, n_frames=7, dw=24, dh=18, cw=37, ch=27, color="jpeg", seed=0):
    """The same seeded capture as each package's own (header, frames)."""
    rng = np.random.default_rng(seed)
    intr_d = np.eye(4, dtype=np.float32)
    intr_d[0, 0] = intr_d[1, 1] = 20.0
    intr_d[0, 2], intr_d[1, 2] = dw / 2, dh / 2
    header = pkg.SensHeader(
        sensor_name="StructureSensor", intrinsic_color=np.eye(4, dtype=np.float32) * 1.5,
        extrinsic_color=np.eye(4, dtype=np.float32), intrinsic_depth=intr_d,
        extrinsic_depth=np.eye(4, dtype=np.float32), color_compression=color,
        depth_compression="zlib_ushort", color_width=cw, color_height=ch, depth_width=dw,
        depth_height=dh, depth_shift=1000.0, num_frames=n_frames)
    frames = []
    for i in range(n_frames):
        depth = rng.integers(0, 4000, size=(dh, dw)).astype(np.uint16)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = rng.normal(size=3)
        rgb = rng.integers(0, 256, size=(ch, cw, 3), dtype=np.uint8)
        if color == "jpeg":
            payload = _pil_jpeg(rgb, 90)
        elif color == "png":
            buf = io.BytesIO()
            Image.fromarray(rgb).save(buf, format="PNG")
            payload = buf.getvalue()
        else:
            payload = rgb.tobytes()
        frames.append(pkg.SensFrame(index=i, camera_to_world=pose, timestamp_color=i,
                                    timestamp_depth=2 * i, color_bytes=payload,
                                    depth_bytes=zlib.compress(depth.tobytes())))
    return header, frames


def test_write_sens_bytes_equal_and_read_across(tmp_path):
    paths = {}
    for name, pkg in (("jax", jax_scannet), ("port", scannet)):
        paths[name] = str(tmp_path / f"{name}.sens")
        pkg.write_sens(paths[name], *_capture(pkg))
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    for reader, path in ((scannet, paths["jax"]), (jax_scannet, paths["port"])):
        other = jax_scannet if reader is scannet else scannet
        got = list(reader.iter_sens_frames(path))
        want = list(other.iter_sens_frames(path))
        assert len(got) == len(want) == 7
        for (hg, fg), (hw, fw) in zip(got, want):
            assert hg.sensor_name == hw.sensor_name and hg.num_frames == hw.num_frames
            np.testing.assert_array_equal(hg.intrinsic_depth, hw.intrinsic_depth)
            np.testing.assert_array_equal(fg.camera_to_world, fw.camera_to_world)
            assert (fg.timestamp_color, fg.timestamp_depth) == (fw.timestamp_color,
                                                                fw.timestamp_depth)
            np.testing.assert_array_equal(fg.depth(hg), fw.depth(hw))
            np.testing.assert_array_equal(fg.color(hg), fw.color(hw))


@pytest.mark.parametrize("color,kw", [
    ("jpeg", dict(frame_skip=3)),
    ("jpeg", dict(frame_skip=2, image_size=(18, 24))),
    ("jpeg", dict(frame_skip=1, image_size=(27, 37))),
    ("png", dict(frame_skip=2, image_size=(30, 40))),
    ("raw", dict(frame_skip=3)),
    ("jpeg", dict(frame_skip=10, export_color=False, export_pose=False)),
], ids=["skip3", "resize-down", "resize-same", "png-resize-up", "raw", "depth-only"])
def test_export_sens_scene_trees_equal(tmp_path, color, kw):
    n = {}
    for name, pkg in (("jax", jax_scannet), ("port", scannet)):
        sens = str(tmp_path / f"{name}.sens")
        pkg.write_sens(sens, *_capture(pkg, color=color))
        n[name] = pkg.export_sens_scene(sens, str(tmp_path / name / "out"), **kw)
    assert n["jax"] == n["port"] > 0
    tree = _assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert any(k.startswith(os.path.join("out", "depth")) for k in tree)


def test_export_zero_frame_capture(tmp_path):
    """A capture of no frames still writes its intrinsics (JAX
    test_preprocess.py:340), in both packages alike."""
    for name, pkg in (("jax", jax_scannet), ("port", scannet)):
        header, _ = _capture(pkg, n_frames=0)
        sens = str(tmp_path / f"{name}.sens")
        pkg.write_sens(sens, header, [])
        assert pkg.export_sens_scene(sens, str(tmp_path / name / "out")) == 0
    tree = _assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert sorted(tree) == sorted(os.path.join("out", "intrinsic", f"{k}.txt") for k in (
        "intrinsic_color", "extrinsic_color", "intrinsic_depth", "extrinsic_depth"))


# ---------------------------------------------------------------------------
# GT preparation and the other converters


def _scannet_raw(root, scenes):
    rng = np.random.default_rng(5)
    tsv = root / "labels.tsv"
    tsv.write_text("id\traw_category\tcategory\n5\tchair\tchair\n999\tweird\tweird\n"
                   "3\ttable\ttable\nx\tbroken\tbroken\n")
    for i, scene in enumerate(scenes):
        d = root / "scans" / scene
        d.mkdir(parents=True)
        seg = rng.integers(0, 12, size=200 + 10 * i).tolist()
        with open(d / f"{scene}_vh_clean_2.0.010000.segs.json", "w") as f:
            json.dump({"segIndices": seg}, f)
        groups = [{"id": 0, "label": "chair", "segments": [0, 1, 2]},
                  {"id": 1, "label": "weird", "segments": [3]},
                  {"id": 2, "label": "nosuch", "segments": [4, 5]},
                  {"id": 3, "label": "table", "segments": [7, 11]}]
        with open(d / f"{scene}.aggregation.json", "w") as f:
            json.dump({"segGroups": groups}, f)
    return str(tsv)


def test_scannet_scene_gt_equal(tmp_path):
    tsv = _scannet_raw(tmp_path, ["scene0000_00"])
    label_map = scannet.load_label_map(tsv)
    assert label_map == jax_scannet.load_label_map(tsv)
    scene = str(tmp_path / "scans" / "scene0000_00")
    for valid in (None, [5, 999]):
        got = scannet.scannet_scene_gt(scene, str(tmp_path / "p.txt"), label_map, valid)
        want = jax_scannet.scannet_scene_gt(scene, str(tmp_path / "j.txt"), label_map, valid)
        np.testing.assert_array_equal(got, want)
        assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


@pytest.mark.parametrize("num_workers", [1, 2])
def test_prepare_scannet_gt_equal(tmp_path, num_workers):
    scenes = ["scene0000_00", "scene0001_00", "scene0002_00"]
    tsv = _scannet_raw(tmp_path, scenes)
    raw = str(tmp_path / "scans")
    scannet.prepare_scannet_gt(raw, str(tmp_path / "port"), tsv, scenes, num_workers)
    jax_scannet.prepare_scannet_gt(raw, str(tmp_path / "jax"), tsv, scenes, 1)
    assert len(_assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))) == 3


def _matterport_house(root, seq, category_ids):
    d = root / seq / seq / "house_segmentations"
    d.mkdir(parents=True)
    rng = np.random.default_rng(7)
    verts = rng.normal(size=(9, 3)).astype("<f4")
    faces = [[0, 1, 2], [2, 3, 4], [5, 6, 7], [6, 7, 8]]
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex 9\n"
              "property float x\nproperty float y\nproperty float z\nelement face 4\n"
              "property list uchar int vertex_indices\nproperty int category_id\nend_header\n")
    with open(d / f"{seq}.ply", "wb") as f:
        f.write(header.encode("ascii") + verts.tobytes())
        for face, cid in zip(faces, category_ids):
            f.write(struct.pack("<B3ii", 3, *face, cid))
    with open(d / f"{seq}.fsegs.json", "w") as f:
        json.dump({"segIndices": [0, 1, 2, 2]}, f)
    with open(d / f"{seq}.semseg.json", "w") as f:
        json.dump({"segGroups": [{"segments": [0]}, {"segments": [1, 9]}, {"segments": [2]}]}, f)


@pytest.mark.parametrize("category_ids,valid", [([1, 2, 3, 1], [7, 11]),
                                                ([1, 5000, -3, 2], None)],
                         ids=["valid-ids", "out-of-range-raw-id"])
def test_convert_matterport_gt_equal(tmp_path, category_ids, valid):
    tsv = tmp_path / "category_mapping.tsv"
    tsv.write_text("index\traw_category\tnyuId\n1\tchair\t7\n2\tblob\t42\n3\twall\t4.0\n"
                   "4\tbad\tnan\n")
    _matterport_house(tmp_path, "houseA", category_ids)
    got = matterport.convert_matterport_gt(str(tmp_path), "houseA", str(tmp_path / "port"),
                                           str(tsv), valid)
    want = jax_matterport.convert_matterport_gt(str(tmp_path), "houseA", str(tmp_path / "jax"),
                                                str(tsv), valid)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(matterport.load_raw_to_nyu(str(tsv)),
                                  jax_matterport.load_raw_to_nyu(str(tsv)))
    _assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_write_toolkit_configs_equal(tmp_path):
    kw = dict(data_root="/data/spp", split="nvs_sem_train", sample_factor=0.5, near=0.1,
              far=12.0, token="T", splits_list=["a", "b"])
    paths = scannetpp.write_toolkit_configs(str(tmp_path / "port"), **kw)
    want = jax_scannetpp.write_toolkit_configs(str(tmp_path / "jax"), **kw)
    assert sorted(paths) == sorted(want)
    _assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    scannetpp.write_toolkit_configs(str(tmp_path / "p2"))
    jax_scannetpp.write_toolkit_configs(str(tmp_path / "j2"))
    _assert_same_tree(str(tmp_path / "j2"), str(tmp_path / "p2"))


def test_tasmap_helpers_equal():
    for realsense in (False, True):
        assert tasmap.omni_intrinsics(realsense) == jax_tasmap.omni_intrinsics(realsense)
    q = np.array([0.1, -0.3, 0.2, 0.9])
    q = q / np.linalg.norm(q)
    np.testing.assert_array_equal(tasmap.quat_xyzw_to_rotmat(q),
                                  jax_tasmap.quat_xyzw_to_rotmat(q))
    for a, b in zip(tasmap.pose_to_extrinsic(np.array([1.0, 2.0, -0.5]), q),
                    jax_tasmap.pose_to_extrinsic(np.array([1.0, 2.0, -0.5]), q)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rgb_hw", [(12, 16), (8, 10)], ids=["same-size", "resized"])
def test_convert_tasmap_scene_equal(tmp_path, rgb_hw):
    rng = np.random.default_rng(1)
    extra = tmp_path / "extra_info"
    for i in range(5):
        fdir = extra / f"{i:05d}"
        fdir.mkdir(parents=True)
        rgb = rng.integers(0, 256, size=rgb_hw + (3,), dtype=np.uint8)
        Image.fromarray(rgb).save(fdir / "original_image.png")
        depth = rng.uniform(0.5, 3.0, size=(12, 16)).astype(np.float32)
        depth[0, :3] = 0.0  # invalid pixels drop out of the cloud
        np.save(fdir / "depth.npy", depth)
        quat = rng.normal(size=4)
        np.save(fdir / "pose_ori.npy", np.array([rng.normal(size=3), quat / np.linalg.norm(quat)],
                                                dtype=object))
    kw = dict(voxel_size=0.05, buffer_size=2, stride=1)
    ply = tasmap.convert_tasmap_scene(str(extra), str(tmp_path / "port"), "scene0000_00", **kw)
    jax_ply = jax_tasmap.convert_tasmap_scene(str(extra), str(tmp_path / "jax"), "scene0000_00",
                                              **kw)
    assert os.path.basename(ply) == os.path.basename(jax_ply)
    tree = _assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert len(tree["scene0000_00_vh_clean_2.ply"]) > 200


# ---------------------------------------------------------------------------
# clean_output and C5


def _outputs(root, names):
    for name in names:
        out = os.path.join(root, "scannet", "processed", name, "output", "mask")
        os.makedirs(out)
        open(os.path.join(out, "0.png"), "wb").close()


def test_clean_scene_outputs_dry_run_and_yes(tmp_path, monkeypatch, capsys):
    names = ["scene0000_00", "scene0001_00", "scene0002_00"]
    for pkg in ("jax", "port"):
        _outputs(str(tmp_path / pkg / "data"), names[:2])
    cfgs = {"jax": jax_load_config("scannet").replace(data_root=str(tmp_path / "jax" / "data")),
            "port": load_config("scannet", data_root=str(tmp_path / "port" / "data"))}
    dry = {"jax": jax_clean.clean_scene_outputs(cfgs["jax"], names, dry_run=True),
           "port": clean_output.clean_scene_outputs(cfgs["port"], names, dry_run=True)}
    assert [os.path.relpath(p, tmp_path / "port") for p in dry["port"]] == [
        os.path.relpath(p, tmp_path / "jax") for p in dry["jax"]]
    assert len(dry["port"]) == 2 and all(os.path.isdir(p) for p in dry["port"])
    # the CLI: a listing without --yes, the removal with it, the same lines
    printed = {}
    for pkg, mod in (("jax", jax_clean), ("port", clean_output)):
        monkeypatch.chdir(tmp_path / pkg)
        for argv in (["--config", "scannet", "--seq_name_list", "+".join(names)],
                     ["--config", "scannet", "--seq_name_list", "+".join(names), "--yes"]):
            mod.main(argv)
        printed[pkg] = capsys.readouterr().out
    assert printed["port"] == printed["jax"]
    assert "would remove 2 scene output dirs" in printed["port"]
    assert "removed 2 scene output dirs" in printed["port"]
    assert not any(os.path.exists(p) for p in dry["port"])


@pytest.mark.parametrize("kw", [dict(seed=0),
                                dict(num_boxes=3, num_frames=6, image_hw=(60, 80), seed=60,
                                     spacing=0.05)])
def test_synthetic_layouts_equal_file_for_file(tmp_path, kw):
    """C5: the port's write_scannet_layout writes the JAX writer's files:
    colour JPEGs (PIL's quality-75 bytes), depth and mask PNGs, poses,
    intrinsics, the cloud and the GT."""
    jax_synthetic.write_scannet_layout(jax_synthetic.make_scene(**kw), str(tmp_path / "jax"),
                                       "scene0000_00")
    synthetic.write_scannet_layout(synthetic.make_scene(**kw), str(tmp_path / "port"),
                                   "scene0000_00")
    tree = _assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert sum(k.endswith(".jpg") for k in tree) == sum(k.startswith(
        os.path.join("scannet", "processed", "scene0000_00", "depth")) for k in tree) > 0
