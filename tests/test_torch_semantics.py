"""The port's semantics layer against ``maskclustering_tpu.semantics``.

Seeded inputs go through both packages: the crop geometry, the scale
pooling (bit-equal to the jitted ``jnp.mean``), the query (``classify_objects``,
``object_features``, ``assign_labels``, over the full ScanNet++ vocabulary at
ViT-H-14's width as the JAX ``test_semantics_scale.py`` does), the feature
extraction from files on disk (JPEG and PNG colour frames) and the label
features. Everything runs with ``device="cpu"``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from maskclustering_tpu import semantics as jsem
from maskclustering_tpu.evaluation import evaluate_scans as jax_evaluate_scans
from maskclustering_tpu_torch import semantics as sem
from maskclustering_tpu_torch.evaluation import evaluate_scans
from maskclustering_tpu_torch.io.png import write_png

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

VIT_H_DIM = 1024


def _mask(shape, rows, cols):
    m = np.zeros(shape, bool)
    m[rows, cols] = True
    return m


@pytest.mark.parametrize("shape,rows,cols", [
    ((100, 200), slice(40, 61), slice(50, 91)),
    ((20, 20), slice(0, 20), slice(0, 20)),
    ((30, 40), slice(7, 8), slice(3, 30)),  # one row: the tight crop is empty
    ((30, 40), slice(2, 29), slice(39, 40)),  # the last column
])
def test_crops_equal_jax(shape, rows, cols):
    rng = np.random.default_rng(1)
    mask = _mask(shape, rows, cols)
    for level in range(4):
        assert sem.mask_to_box(mask, level) == jsem.mask_to_box(mask, level)
    rgb = rng.integers(0, 255, shape + (3,), dtype=np.uint8)
    for got, want in zip(sem.multiscale_crops(rgb, mask), jsem.multiscale_crops(rgb, mask),
                         strict=True):
        np.testing.assert_array_equal(got, want)
    img = rng.integers(0, 255, (10, 4, 3), dtype=np.uint8)
    np.testing.assert_array_equal(sem.pad_to_square(img), jsem.pad_to_square(img))
    with pytest.raises(ValueError, match="empty"):
        sem.mask_to_box(np.zeros(shape, bool), 0)


@pytest.mark.parametrize("rgb_hw,mask_hw", [((968, 1296), (480, 640)), ((100, 130), (37, 53)),
                                            ((37, 53), (100, 130))])
def test_crops_resize_the_mask_like_jax(rgb_hw, mask_hw):
    """A mask stored at another resolution is nearest-resized to the colour
    frame's, as cv2 does it for the JAX package."""
    rng = np.random.default_rng(2)
    mask = np.zeros(mask_hw, bool)
    mask[mask_hw[0] // 5:mask_hw[0] // 2, mask_hw[1] // 3:mask_hw[1] - 3] = True
    rgb = rng.integers(0, 255, rgb_hw + (3,), dtype=np.uint8)
    for got, want in zip(sem.multiscale_crops(rgb, mask), jsem.multiscale_crops(rgb, mask),
                         strict=True):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,d,seed", [(8, VIT_H_DIM, 0), (64, VIT_H_DIM, 1), (5, 64, 2),
                                      (4000, 64, 3)])
def test_pool_scale_features_bit_equal_jnp_mean(b, d, seed):
    """The scale mean rounds as ``jnp.mean`` does, bit for bit, where
    ``torch.mean`` does not."""
    feats = jsem.l2_normalize(
        np.random.default_rng(seed).standard_normal((b * 3, d)).astype(np.float32))
    got = sem.pool_scale_features(feats, device="cpu")
    want = jsem.pool_scale_features(feats)
    assert got.dtype == np.float32 and got.shape == (b, d)
    np.testing.assert_array_equal(got, want)
    if b == 4000:
        plain = torch.from_numpy(feats).reshape(b, 3, d).mean(dim=1).numpy()
        assert not np.array_equal(plain, want)  # the trap the port avoids


def test_pool_scale_features_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sem.pool_scale_features(np.zeros((3, 4), np.float32))


@pytest.fixture(scope="module")
def planted():
    """Objects whose mask features are noisy copies of known vocabulary
    entries of the full ScanNet++ vocabulary, at ViT-H-14's width, plus an
    object with no features on record."""
    labels, ids = jsem.get_vocab("scannetpp")
    rng = np.random.default_rng(42)
    text = jsem.l2_normalize(rng.standard_normal((len(labels), VIT_H_DIM)).astype(np.float32))
    class_idx = rng.choice(len(labels), size=12, replace=False)
    object_dict, mask_features = {}, {}
    for o in range(12):
        repre = [(f"f{o}", m, 0.5) for m in range(1 + o % 3)]
        for frame, mid, _ in repre:
            noisy = text[class_idx[o]] + 0.05 * rng.standard_normal(VIT_H_DIM).astype(np.float32)
            mask_features[f"{frame}_{mid}"] = jsem.l2_normalize(noisy)
        object_dict[o] = {"point_ids": set(range(o * 150, (o + 1) * 150)),
                          "repre_mask_list": repre}
    object_dict[12] = {"point_ids": {12 * 150}, "repre_mask_list": [("missing", 0, 0.1)]}
    label_features = {label: text[i] for i, label in enumerate(labels)}
    return object_dict, mask_features, label_features, dict(zip(labels, ids)), class_idx


def test_object_features_equal_jax(planted):
    object_dict, mask_features = planted[:2]
    got = sem.object_features(object_dict, mask_features, VIT_H_DIM)
    want = jsem.object_features(object_dict, mask_features, VIT_H_DIM)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert not got[1][12] and got[1][:12].all()


def test_classify_objects_equal_jax(planted):
    object_dict, mask_features, label_features, _, class_idx = planted
    text = np.stack(list(label_features.values()))
    feats, valid = jsem.object_features(object_dict, mask_features, VIT_H_DIM)
    got = sem.classify_objects(feats[valid], text, device="cpu")
    np.testing.assert_array_equal(got, jsem.classify_objects(feats[valid], text))
    np.testing.assert_array_equal(got, class_idx)
    # hash features: unrelated directions, no planted answer
    rng = np.random.default_rng(5)
    obj = jsem.l2_normalize(rng.standard_normal((40, 64)).astype(np.float32))
    txt = jsem.l2_normalize(rng.standard_normal((200, 64)).astype(np.float32))
    np.testing.assert_array_equal(sem.classify_objects(obj, txt, device="cpu"),
                                  jsem.classify_objects(obj, txt))


def test_assign_labels_and_class_ap_equal_jax(planted, tmp_path):
    object_dict, mask_features, label_features, label_to_id, _ = planted
    got = sem.assign_labels(object_dict, mask_features, label_features, label_to_id,
                            13 * 150 + 1, device="cpu")
    want = jsem.assign_labels(object_dict, mask_features, label_features, label_to_id,
                              13 * 150 + 1)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not got["pred_masks"][:, 12].any() and got["pred_classes"][12] == 0
    # the class-aware AP of the port's prediction over the full vocabulary
    gt = np.zeros(13 * 150 + 1, np.int64)
    for o in range(12):
        gt[o * 150:(o + 1) * 150] = got["pred_classes"][o] * 1000 + o + 1
    np.savez(tmp_path / "s.npz", **got)
    np.savetxt(tmp_path / "s.txt", gt, fmt="%d")
    args = ([str(tmp_path / "s.npz")], [str(tmp_path / "s.txt")], "scannetpp")
    avgs = evaluate_scans(*args, device="cpu")
    assert avgs["all_ap"] == pytest.approx(1.0)
    assert _equal_with_nan(avgs, jax_evaluate_scans(*args))


def _equal_with_nan(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _equal_with_nan(a[k], b[k]) for k in a)
    return a == b or (np.isnan(a) and np.isnan(b))


class _DiskDataset:
    """Duck-typed dataset over colour and id-map files in one directory."""

    def __init__(self, root, ext):
        self.root, self.ext = root, ext

    def get_frame_path(self, frame_id):
        return (f"{self.root}/rgb_{frame_id}.{self.ext}", f"{self.root}/seg_{frame_id}.png")


def _write_frames(root, ext, rgb_hw, seg_hw, n_frames=3):
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:rgb_hw[0], 0:rgb_hw[1]]
    object_dict = {}
    for f in range(n_frames):
        rgb = np.clip(np.stack([x * 2 + f * 9, y * 3, x + y], -1)
                      + rng.normal(0, 12, rgb_hw + (3,)), 0, 255).astype(np.uint8)
        if ext == "jpg":
            Image.fromarray(rgb).save(f"{root}/rgb_{f:03d}.jpg", quality=85)
        else:
            write_png(f"{root}/rgb_{f:03d}.png", rgb)
        seg = np.zeros(seg_hw, np.uint8)
        h, w = seg_hw
        seg[h // 6:h // 2, w // 4:w // 2 + f] = 1
        seg[h // 2 + 1:h - 2, 2:w // 3] = 2
        write_png(f"{root}/seg_{f:03d}.png", seg)
        for m in (1, 2):
            object_dict.setdefault(m, {"point_ids": [m], "repre_mask_list": []})
            object_dict[m]["repre_mask_list"].append((f"{f:03d}", m, 0.9))
    return object_dict


@pytest.mark.parametrize("ext,rgb_hw,seg_hw,batch", [
    ("jpg", (60, 80), (60, 80), 64), ("jpg", (96, 128), (48, 64), 2),
    ("png", (45, 61), (45, 61), 1)])
def test_extract_mask_features_from_disk_equal_jax(tmp_path, ext, rgb_hw, seg_hw, batch):
    """Colour frames as PIL JPEG or PNG, id-maps at the colour or at half
    resolution, batches that split a frame's masks: the feature dicts are
    equal, key for key and bit for bit, and each frame is decoded once."""
    object_dict = _write_frames(str(tmp_path), ext, rgb_hw, seg_hw)
    ds = _DiskDataset(str(tmp_path), ext)
    got = sem.extract_mask_features(ds, object_dict, sem.HashEncoder(VIT_H_DIM),
                                    batch_size=batch, io_workers=2, device="cpu")
    want = jsem.extract_mask_features(ds, object_dict, jsem.HashEncoder(VIT_H_DIM),
                                      batch_size=batch, io_workers=2)
    assert list(got) == list(want) and len(got) == 6
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    path = sem.save_mask_features(got, str(tmp_path / "object"), "cfg")
    assert path.endswith(os.path.join("cfg", "open-vocabulary_features.npy"))
    saved = np.load(path, allow_pickle=True).item()
    assert list(saved) == list(want)


def test_extract_mask_features_decodes_each_frame_once(tmp_path, monkeypatch):
    import maskclustering_tpu_torch.semantics.features as features

    object_dict = _write_frames(str(tmp_path), "png", (30, 40), (30, 40), n_frames=4)
    decoded = []
    real = features.read_rgb
    monkeypatch.setattr(features, "read_rgb", lambda p: decoded.append(p) or real(p))
    feats = sem.extract_mask_features(_DiskDataset(str(tmp_path), "png"), object_dict,
                                      sem.HashEncoder(8), batch_size=3, device="cpu")
    assert len(feats) == 8 and sorted(decoded) == sorted(set(decoded)) and len(decoded) == 4
    assert sem.extract_mask_features(None, {}, sem.HashEncoder(8), device="cpu") == {}


def test_representative_mask_index_and_label_features_equal_jax(tmp_path):
    object_dict = {0: {"repre_mask_list": [("f1", 1, 0.9), ("f2", 2, 0.8)]},
                   1: {"repre_mask_list": [("f1", 1, 0.5), (3, 4, 0.1)]}, 2: {}}
    assert sem.representative_mask_index(object_dict) == \
        jsem.representative_mask_index(object_dict) == [("f1", 1), ("f2", 2), (3, 4)]
    labels, _ = jsem.get_vocab("scannet")
    assert sem.get_vocab("scannet") == jsem.get_vocab("scannet")
    got = np.load(sem.extract_label_features(labels, sem.HashEncoder(VIT_H_DIM),
                                             str(tmp_path / "p" / "scannet.npy")),
                  allow_pickle=True).item()
    want = np.load(jsem.extract_label_features(labels, jsem.HashEncoder(VIT_H_DIM),
                                               str(tmp_path / "j" / "scannet.npy")),
                   allow_pickle=True).item()
    assert list(got) == list(want) == labels
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_encoders_equal_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 255, (9, 9, 3), dtype=np.uint8) for _ in range(4)]
    for dim in (8, 64):
        np.testing.assert_array_equal(sem.HashEncoder(dim).encode_images(images),
                                      jsem.HashEncoder(dim).encode_images(images))
        np.testing.assert_array_equal(sem.HashEncoder(dim).encode_texts(["a", "chair"]),
                                      jsem.HashEncoder(dim).encode_texts(["a", "chair"]))
    x = rng.standard_normal((5, 7)).astype(np.float32)
    np.testing.assert_array_equal(sem.l2_normalize(x), jsem.l2_normalize(x))
    np.save(tmp_path / "f.npy", {"0_1": np.ones(6, np.float64)}, allow_pickle=True)
    store = sem.PrecomputedFeatures(str(tmp_path / "f.npy"))
    assert store.feature_dim == 6 and "0_1" in store and store.get("x") is None
    assert store.get("0_1").dtype == np.float32 and list(store.keys()) == ["0_1"]
    # the checkpoint search finds what the JAX one finds
    hub = tmp_path / "hub"
    snap = hub / "models--openai--clip-vit" / "snapshots" / "abc"
    snap.mkdir(parents=True)
    monkeypatch.setenv("HF_HUB_CACHE", str(hub))
    monkeypatch.delenv("MCT_CLIP_PATH", raising=False)
    assert sem.encoder.find_local_clip_checkpoint() is None
    (snap / "config.json").write_text("{}")
    (snap / "model.safetensors").write_bytes(b"")
    assert sem.encoder.find_local_clip_checkpoint() == str(snap) == \
        jsem.encoder.find_local_clip_checkpoint()
    # the empty snapshot raises what the JAX encoder raises: its empty
    # model.safetensors has no header
    with pytest.raises(Exception) as want:
        jsem.HFCLIPEncoder(str(snap))
    with pytest.raises(sem.checkpoint.SafetensorError) as got:
        sem.HFCLIPEncoder(str(snap), device="cpu")
    assert (type(got.value).__name__, str(got.value)) == \
        (type(want.value).__name__, str(want.value))


def test_jnp_mean_is_the_reference_rounding():
    """The rounding the port matches: jnp.mean over 3 scales equals a sum and
    a float32 reciprocal multiply."""
    x = np.random.default_rng(9).standard_normal((1000, 3, 16)).astype(np.float32)
    want = np.asarray(jnp.mean(jnp.asarray(x), axis=1))
    np.testing.assert_array_equal(want, (x[:, 0] + x[:, 1] + x[:, 2]) * np.float32(1 / 3))
