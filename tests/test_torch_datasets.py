"""The port's dataset loaders against the JAX package's, on the same files.

Mirrors ``tests/test_datasets.py`` (ScanNet, the invalid pose, the
Matterport3D conf, ScanNet++ COLMAP parsing, TASMap string ids, the unknown
dataset) with the port's ``get_dataset``, and holds every loader's output,
``load_scene_tensors`` included, equal array for array to the JAX loader's.
The files are written by PIL (as the JAX tests write them) and by both
packages' ``write_scannet_layout``.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from maskclustering_tpu.datasets import get_dataset as jax_get_dataset
from maskclustering_tpu.io.ply import write_ply_points
from maskclustering_tpu.utils.synthetic import make_scene as jax_make_scene
from maskclustering_tpu.utils.synthetic import write_scannet_layout as jax_write_layout
from maskclustering_tpu_torch.datasets import get_dataset
from maskclustering_tpu_torch.utils.synthetic import make_scene, write_scannet_layout

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

TENSOR_FIELDS = ("scene_points", "depths", "segmentations", "intrinsics", "cam_to_world",
                 "frame_valid")


def _write_png16(path, arr):
    Image.fromarray(arr.astype(np.uint16)).save(path)


def _make_scannet_scene(root, seq="scene0000_00", n_frames=2, hw=(480, 640), mask_hw=None):
    h, w = hw
    mh, mw = mask_hw or hw
    base = os.path.join(root, "scannet", "processed", seq)
    for d in ("color", "depth", "pose", "intrinsic", "output/mask"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    rng = np.random.default_rng(0)
    np.savetxt(os.path.join(base, "intrinsic", "intrinsic_depth.txt"),
               np.array([[500.0, 0, 320, 0], [0, 500, 240, 0], [0, 0, 1, 0], [0, 0, 0, 1]]))
    for i in range(0, n_frames * 10, 10):
        Image.new("RGB", (w, h)).save(os.path.join(base, "color", f"{i}.jpg"))
        _write_png16(os.path.join(base, "depth", f"{i}.png"),
                     rng.integers(500, 3000, size=(h, w)))
        np.savetxt(os.path.join(base, "pose", f"{i}.txt"), np.eye(4))
        Image.fromarray(rng.integers(0, 5, size=(mh, mw)).astype(np.uint8)).save(
            os.path.join(base, "output", "mask", f"{i}.png"))
    write_ply_points(os.path.join(base, f"{seq}_vh_clean_2.ply"),
                     rng.normal(size=(50, 3)).astype(np.float32))
    return seq


def _assert_tensors_equal(got, want):
    for name in TENSOR_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.frame_ids == want.frame_ids


def test_scannet_loader(tmp_path):
    root = str(tmp_path)
    seq = _make_scannet_scene(root)
    ds = get_dataset("scannet", seq, data_root=root)
    frames = ds.get_frame_list(10)
    assert frames == [0, 10]
    k = ds.get_intrinsics(0)
    assert k.shape == (3, 3) and k[0, 0] == 500
    assert ds.get_extrinsic(0).shape == (4, 4)
    d = ds.get_depth(0)
    assert d.shape == (480, 640) and d.dtype == np.float32 and 0.4 < d.mean() < 3.5
    seg = ds.get_segmentation(0, align_with_depth=True)
    assert seg.shape == (480, 640)
    assert ds.get_scene_points().shape == (50, 3)
    assert ds.image_size == (640, 480)
    tensors = ds.load_scene_tensors(stride=10)
    assert tensors.num_frames == 2
    assert tensors.frame_valid.all()
    _assert_tensors_equal(tensors, jax_get_dataset("scannet", seq, data_root=root)
                          .load_scene_tensors(stride=10))


def test_scannet_masks_resized_to_depth_like_jax(tmp_path):
    """Masks at 1296x968 (ScanNet's color resolution) against 640x480 depth:
    aligned with the port's nearest rule, equal to the JAX loader's cv2."""
    root = str(tmp_path)
    seq = _make_scannet_scene(root, n_frames=1, mask_hw=(968, 1296))
    got = get_dataset("scannet", seq, data_root=root).get_segmentation(0)
    want = jax_get_dataset("scannet", seq, data_root=root).get_segmentation(0)
    assert got.shape == (480, 640)
    np.testing.assert_array_equal(got, want)


def test_scannet_invalid_pose_marked(tmp_path):
    root = str(tmp_path)
    seq = _make_scannet_scene(root)
    bad = np.eye(4)
    bad[0, 0] = np.inf
    np.savetxt(os.path.join(root, "scannet", "processed", seq, "pose", "10.txt"), bad)
    tensors = get_dataset("scannet", seq, data_root=root).load_scene_tensors(stride=10)
    np.testing.assert_array_equal(tensors.frame_valid, [True, False])
    _assert_tensors_equal(tensors, jax_get_dataset("scannet", seq, data_root=root)
                          .load_scene_tensors(stride=10))


def test_matterport_conf_parsing(tmp_path):
    root = str(tmp_path)
    seq = "17DRP5sb8fy"
    base = os.path.join(root, "matterport3d", "scans", seq, seq)
    os.makedirs(os.path.join(base, "undistorted_camera_parameters"))
    os.makedirs(os.path.join(base, "undistorted_depth_images"))
    os.makedirs(os.path.join(base, "house_segmentations"))
    ext = np.eye(4)
    ext_line = " ".join(str(float(x)) for x in ext.flatten())
    with open(os.path.join(base, "undistorted_camera_parameters", f"{seq}.conf"), "w") as f:
        f.write("dataset matterport\n")
        f.write("intrinsics_matrix 1000 0 640  0 1000 512  0 0 1\n")
        f.write(f"scan d0.png c0.jpg {ext_line}\n")
        f.write(f"scan d1.png c1.jpg {ext_line}\n")
    rng = np.random.default_rng(1)
    for name in ("d0.png", "d1.png"):
        _write_png16(os.path.join(base, "undistorted_depth_images", name),
                     rng.integers(2000, 8000, size=(32, 40)))
    write_ply_points(os.path.join(base, "house_segmentations", f"{seq}.ply"),
                     rng.normal(size=(30, 3)).astype(np.float32))

    ds = get_dataset("matterport3d", seq, data_root=root)
    jds = jax_get_dataset("matterport3d", seq, data_root=root)
    assert ds.get_frame_list(1) == [0, 1]
    k = ds.get_intrinsics(0)
    assert k[0, 0] == 1000 and k[1, 2] == 512
    e = ds.get_extrinsic(0)
    # GL->CV flip: columns 1,2 of the identity rotation are negated
    np.testing.assert_allclose(e[:3, 1], [0, -1, 0])
    np.testing.assert_allclose(e[:3, 2], [0, 0, -1])
    d = ds.get_depth(0)
    assert d.shape == (32, 40)
    # 0.25mm per unit scale
    assert 0.4 < d.mean() < 2.1
    assert ds.get_scene_points().shape == (30, 3)
    for fid in (0, 1):
        for getter in ("get_intrinsics", "get_extrinsic", "get_depth"):
            np.testing.assert_array_equal(getattr(ds, getter)(fid), getattr(jds, getter)(fid))
    np.testing.assert_array_equal(ds.get_scene_points(), jds.get_scene_points())


def test_scannetpp_colmap_parsing(tmp_path):
    root = str(tmp_path)
    seq = "abc123"
    base = os.path.join(root, "scannetpp", "data", seq)
    colmap = os.path.join(base, "iphone", "colmap")
    os.makedirs(colmap)
    os.makedirs(os.path.join(base, "iphone", "render_depth"))
    os.makedirs(os.path.join(root, "scannetpp", "pcld_0.25"))
    with open(os.path.join(colmap, "cameras.txt"), "w") as f:
        f.write("# cameras\n1 PINHOLE 1920 1440 1500 1500 960 720\n")
    # identity quaternion, translation (1,2,3): w2c -> c2w has t = -(1,2,3)
    with open(os.path.join(colmap, "images.txt"), "w") as f:
        f.write("# images\n")
        f.write("1 1 0 0 0 1 2 3 1 frame_000000.jpg\n")
        f.write("0.0 0.0 -1\n")
        f.write("2 0.7071067811865476 0 0.7071067811865476 0 0 0 0 1 frame_000010.jpg\n")
        f.write("\n")
    rng = np.random.default_rng(2)
    for i in (0, 10):
        _write_png16(os.path.join(base, "iphone", "render_depth", f"frame_{i:06d}.png"),
                     rng.integers(500, 3000, size=(24, 32)))
    torch.save({"sampled_coords": rng.normal(size=(40, 3))},
               os.path.join(root, "scannetpp", "pcld_0.25", f"{seq}.pth"))

    ds = get_dataset("scannetpp", seq, data_root=root)
    jds = jax_get_dataset("scannetpp", seq, data_root=root)
    assert ds.get_frame_list(1) == [0, 10]
    assert ds.get_frame_list(2) == [0]
    k = ds.get_intrinsics(0)
    assert k[0, 0] == 1500 and k[0, 2] == 960
    e0 = ds.get_extrinsic(0)
    np.testing.assert_allclose(e0[:3, 3], [-1, -2, -3], atol=1e-12)
    e1 = ds.get_extrinsic(10)
    # 90-degree rotation about y
    np.testing.assert_allclose(e1[:3, :3] @ e1[:3, :3].T, np.eye(3), atol=1e-12)
    assert ds.get_depth(0).shape == (24, 32)
    assert ds.get_scene_points().shape == (40, 3)
    for fid in (0, 10):
        for getter in ("get_intrinsics", "get_extrinsic", "get_depth"):
            np.testing.assert_array_equal(getattr(ds, getter)(fid), getattr(jds, getter)(fid))
    np.testing.assert_array_equal(ds.get_scene_points(), jds.get_scene_points())


def test_tasmap_string_frame_ids(tmp_path):
    root = str(tmp_path)
    seq = "task1"
    base = os.path.join(root, "tasmap", "processed", seq)
    for d in ("color", "depth", "pose", "intrinsic"):
        os.makedirs(os.path.join(base, d))
    for fid in ("3", "12", "101"):
        Image.new("RGB", (8, 8)).save(os.path.join(base, "color", f"{fid}.jpg"))
    ds = get_dataset("tasmap", seq, data_root=root)
    assert ds.get_frame_list(1) == ["3", "12", "101"]
    assert ds.get_frame_list(2) == ["3", "101"]
    assert ds.image_size == (1024, 1024)
    assert ds.get_frame_list(1) == jax_get_dataset("tasmap", seq, data_root=root).get_frame_list(1)


def test_unknown_dataset():
    with pytest.raises(KeyError):
        get_dataset("nope", "seq")


@pytest.mark.parametrize("seed,wide_ids", [(3, False), (4, True)])
def test_write_scannet_layout_loads_like_jax(seed, wide_ids, tmp_path):
    """The port's writer and the JAX writer give the same scan on disk: both
    packages' loaders return equal tensors from either layout (depth
    quantised to millimetres by the writers, ids above 255 in uint16)."""
    kw = dict(num_boxes=3, num_frames=5, image_hw=(36, 48), seed=seed)
    scene, jscene = make_scene(**kw), jax_make_scene(**kw)
    if wide_ids:
        for s in (scene, jscene):  # ids above 255 take the uint16 mask files
            s.segmentations[s.segmentations > 0] += 300
    root = str(tmp_path)
    write_scannet_layout(scene, os.path.join(root, "port"), "scene0000_00")
    jax_write_layout(jscene, os.path.join(root, "jax"), "scene0000_00")
    want = jax_get_dataset("scannet", "scene0000_00", data_root=os.path.join(root, "jax")) \
        .load_scene_tensors(1)
    for layout in ("port", "jax"):
        data_root = os.path.join(root, layout)
        _assert_tensors_equal(get_dataset("scannet", "scene0000_00", data_root=data_root)
                              .load_scene_tensors(1), want)
        _assert_tensors_equal(jax_get_dataset("scannet", "scene0000_00", data_root=data_root)
                              .load_scene_tensors(1), want)
    np.testing.assert_array_equal(want.depths, (np.round(scene.depths * 1000.0)).astype(
        np.float32) * np.float32(1 / 1000.0))
    np.testing.assert_array_equal(want.segmentations, scene.segmentations)
    gt = "scannet/gt/scene0000_00.txt"
    assert open(os.path.join(root, "port", gt)).read() == open(os.path.join(root, "jax", gt)).read()
