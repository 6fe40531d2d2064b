"""The port's mask prediction (``mask_prediction.py``) and the masks step
against the JAX package, on the CPU.

The id-map contract (reference mask_predict.py:94-114), the connected
components, the grid segmenter's labels and scores and the PNG bytes it
writes must equal the JAX module's exactly: all of it is integer (the
scores are computed on the host in float64, as in JAX). ``check_masks``
with the spec ``"grid"`` fills the same masks; ``run_pipeline`` with an
in-process predictor gives JAX's artifacts and digest. A ``gpu`` case
holds the card's labels against the CPU's.
"""

import importlib
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from maskclustering_tpu_torch import mask_prediction as mp
from maskclustering_tpu_torch.config import load_config
from maskclustering_tpu_torch.run import check_masks, run_pipeline
from maskclustering_tpu_torch.utils.synthetic import make_scene, write_scannet_layout

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)


def _jax(name):
    """A module of the JAX package, imported inside the tests that compare
    with it: the card's machine, which runs the ``gpu`` case, has no JAX."""
    return importlib.import_module(f"maskclustering_tpu.{name}")

SCENE = "scene0000_00"


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _random_masks(seed, k=8, h=40, w=50):
    rng = np.random.default_rng(seed)
    masks = np.zeros((k, h, w), dtype=bool)
    for i in range(k):
        y, x = rng.integers(0, h - 25), rng.integers(0, w - 30)
        masks[i, y:y + rng.integers(8, 25), x:x + rng.integers(10, 30)] = True
    return masks, rng.uniform(0.2, 1.0, size=k).astype(np.float32)


def _uint16_case():
    k, h, w = 300, 40, 600
    masks = np.zeros((k, h, w), dtype=bool)
    for i in range(k):
        masks[i, :, 2 * i:2 * i + 2] = True  # 80 px each
    return masks, np.linspace(0.5, 1.0, k), dict(min_pixels=50)


def _overwrite_case():
    masks = np.zeros((2, 30, 30), dtype=bool)
    masks[0, :20, :20] = True
    masks[1, 10:, 10:] = True
    return masks, np.array([0.6, 0.9]), dict(min_pixels=10)


def _small_skip_case():
    masks = np.zeros((3, 40, 40), dtype=bool)
    masks[0, :20, :20] = True
    masks[1, 0, :5] = True
    masks[2, 20:, 20:] = True
    return masks, np.array([0.7, 0.8, 0.9]), {}


@pytest.mark.parametrize("case", [
    lambda: (*_random_masks(0), dict(min_pixels=100)),
    lambda: (*_random_masks(1), dict(min_pixels=100, confidence_threshold=0.7)),
    lambda: (*_random_masks(2, k=70), dict(min_pixels=50)),
    _overwrite_case, _small_skip_case, _uint16_case,
    lambda: (np.ones((1, 30, 30), dtype=bool), np.array([0.3]), {}),
    lambda: (np.zeros((0, 8, 8), dtype=bool), np.zeros(0), {}),
], ids=["random", "threshold", "many-chunks", "overwrite", "small-skip", "uint16",
        "below-confidence", "empty"])
def test_rasterize_id_map_equal_jax(case):
    masks, scores, kw = case()
    want = _jax("mask_prediction").rasterize_id_map(masks, scores, **kw)
    for m in (masks, torch.as_tensor(masks)):
        got = mp.rasterize_id_map(m, scores, **kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match=r"masks must be \(K,H,W\), got \(8, 8\)"):
        mp.rasterize_id_map(np.zeros((8, 8), bool), np.zeros(1))


def _snake(h=40, w=40):
    key = np.zeros((h, w), dtype=np.int64)
    for i, r in enumerate(range(0, h, 4)):
        key[r, :] = 1
        key[r:r + 4, w - 1 if i % 2 == 0 else 0] = 1
    return key


def _photo_key(h, w, seed):
    """A photo-like frame's quantised key: flat regions, shading, noise."""
    rgb = _photo(h, w, seed)
    q = rgb.astype(np.int64) // 48
    return q[..., 0] * 65536 + q[..., 1] * 256 + q[..., 2]


def _photo(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    regions = ((x // 23 + y // 17) % 5).astype(np.int64)
    palette = rng.integers(40, 216, (5, 3)).astype(np.float32)
    shade = 18.0 * np.sin(x / 11.0) * np.cos(y / 7.0)
    img = palette[regions] + shade[..., None] + rng.normal(0.0, 5.0, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("key", [
    lambda: np.array([[1, 1, 2], [1, 2, 2]]), lambda: np.array([[1, 2], [2, 1]]),
    _snake, lambda: np.random.default_rng(0).integers(0, 4, size=(480, 640)),
    lambda: _photo_key(96, 128, 4), lambda: np.zeros((1, 7), np.int64),
    lambda: np.arange(12).reshape(3, 4)],
    ids=["two-regions", "diagonal", "snake", "random-480x640", "photo", "one-row", "all-distinct"])
def test_connected_components_equal_jax(key):
    key = key()
    want = _jax("mask_prediction")._connected_components(key)
    got, sweeps = mp._connected_components(key, return_sweeps=True)
    assert sweeps >= 1
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,kw", [(4, {}), (5, dict(quant=16, min_region=20)),
                                     (6, dict(quant=1, min_region=50))])
def test_grid_segmenter_labels_and_scores_equal_jax(seed, kw):
    rgb = _photo(72, 96, seed)
    want_m, want_s = _jax("mask_prediction").GridSegmenter(**kw)(rgb)
    got_m, got_s = mp.GridSegmenter(device="cpu", **kw)(rgb)
    assert isinstance(got_m, torch.Tensor) and got_s.dtype == want_s.dtype == np.float32
    np.testing.assert_array_equal(_np(got_m), want_m)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(mp.rasterize_id_map(got_m, got_s),
                                  _jax("mask_prediction").rasterize_id_map(want_m, want_s))


def test_grid_segmenter_device_rules(monkeypatch):
    """``device=None`` is the card; without one it raises, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mp.GridSegmenter()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mp.GridSegmenter(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mp.predictor_from_spec("grid")
    assert isinstance(mp.predictor_from_spec("grid", device="cpu"), mp.GridSegmenter)
    for spec in ("cropformer.pth", ""):
        with pytest.raises(ValueError) as got:
            mp.predictor_from_spec(spec, device="cpu")
        with pytest.raises(ValueError) as want:
            _jax("mask_prediction").predictor_from_spec(spec)
        assert str(got.value) == str(want.value)
    with pytest.raises(ImportError, match="detectron2"):
        mp.predictor_from_spec("a.yaml::b.pth", device="cpu")


class _Frames:
    """A duck-typed dataset of in-memory frames, with the ScanNet++ name
    scheme when ``contract`` (``get_frame_path``)."""

    def __init__(self, root, rgbs, contract=False):
        self.segmentation_dir = os.path.join(root, "seg")
        self._rgbs, self._root = rgbs, root
        if contract:
            self.get_frame_path = lambda fid: (
                os.path.join(root, "rgb", f"frame_{fid:06d}.jpg"),
                os.path.join(root, "seg", f"frame_{fid:06d}.png"))

    def get_frame_list(self, stride):
        return list(range(0, len(self._rgbs), stride))

    def get_rgb(self, fid):
        return self._rgbs[fid]


@pytest.mark.parametrize("contract,stride", [(False, 1), (True, 2)],
                         ids=["plain-names", "scannetpp-names"])
def test_predict_scene_masks_writes_jax_bytes(tmp_path, contract, stride):
    rgbs = [_photo(72, 96, s) for s in range(3)]
    written, jax_mp = {}, _jax("mask_prediction")
    for name, mod, seg in (("jax", jax_mp, jax_mp.GridSegmenter()),
                           ("port", mp, mp.GridSegmenter(device="cpu"))):
        ds = _Frames(str(tmp_path / name), rgbs, contract)
        written[name] = [os.path.relpath(p, tmp_path / name)
                         for p in mod.predict_scene_masks(ds, seg, stride=stride)]
        # resume: nothing left to write
        assert mod.predict_scene_masks(ds, seg, stride=stride) == []
    assert written["port"] == written["jax"] and written["port"]
    if contract:
        assert written["port"][-1] == os.path.join("seg", "frame_000002.png")
    for rel in written["port"]:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


def _scan(root, seed=3, frames=4, hw=(48, 64)):
    write_scannet_layout(make_scene(num_boxes=2, num_frames=frames, image_hw=hw,
                                    seed=seed, spacing=0.05), root, SCENE)
    seg_dir = os.path.join(root, "scannet", "processed", SCENE, "output", "mask")
    shutil.rmtree(seg_dir)  # the step must fill them
    return seg_dir


def test_check_masks_grid_spec_fills_jax_masks(tmp_path):
    dirs = {}
    for name in ("jax", "port"):
        dirs[name] = _scan(str(tmp_path / name))
    cfg = load_config("scannet", data_root=str(tmp_path / "port"), step=1,
                      cropformer_path="grid")
    jcfg = _jax("config").load_config("scannet").replace(data_root=str(tmp_path / "jax"), step=1,
                                              cropformer_path="grid")
    assert check_masks(cfg, [SCENE], predictor_spec=cfg.cropformer_path, device="cpu") == []
    assert _jax("run").check_masks(jcfg, [SCENE], predictor_spec=jcfg.cropformer_path) == []
    names = sorted(os.listdir(dirs["port"]))
    assert names == sorted(os.listdir(dirs["jax"])) and len(names) == 4
    for n in names:
        with open(os.path.join(dirs["port"], n), "rb") as a, \
                open(os.path.join(dirs["jax"], n), "rb") as b:
            assert a.read() == b.read()


def test_check_masks_bad_spec_logged_not_raised(tmp_path, caplog):
    """A spec that builds no predictor is logged in both packages; the scene
    stays missing, and mask_command still runs as the fallback."""
    for name in ("jax", "port"):
        _scan(str(tmp_path / name))
    cfg = load_config("scannet", data_root=str(tmp_path / "port"), step=1)
    jcfg = _jax("config").load_config("scannet").replace(data_root=str(tmp_path / "jax"), step=1)
    with caplog.at_level(logging.ERROR):
        got = check_masks(cfg, [SCENE], predictor_spec="cropformer.pth", device="cpu")
        want = _jax("run").check_masks(jcfg, [SCENE], predictor_spec="cropformer.pth")
    assert got == want == [SCENE]
    assert sum("could not build mask predictor" in r.getMessage() for r in caplog.records) == 2
    marker = tmp_path / "ran.txt"
    got = check_masks(cfg, [SCENE], mask_command=f"echo {{seq_name}} >> {marker}",
                      predictor_spec="cropformer.pth", device="cpu")
    assert got == [SCENE] and marker.read_text() == f"{SCENE}\n"


def test_check_masks_failed_prediction_stays_missing(tmp_path, caplog):
    _scan(str(tmp_path))
    cfg = load_config("scannet", data_root=str(tmp_path), step=1)

    def broken(rgb):
        raise RuntimeError("corrupt frame")

    with caplog.at_level(logging.ERROR):
        assert check_masks(cfg, [SCENE], mask_predictor=broken, device="cpu") == [SCENE]
    assert any("mask prediction failed" in r.getMessage() for r in caplog.records)


def _stub(rgb):
    """A deterministic in-process predictor: one mask a grey level of the
    synthetic frame (the id-map times 40), scored by the level."""
    grey = np.asarray(rgb)[..., 0].astype(np.int64)
    level = (grey + 20) // 40
    ids = [v for v in np.unique(level) if v > 0]
    masks = np.stack([level == v for v in ids]) if ids else np.zeros((0,) + grey.shape, bool)
    return masks, np.asarray([0.5 + v / 100.0 for v in ids], np.float32)


def test_run_pipeline_with_predictor_equals_jax(tmp_path):
    kw = dict(step=1, distance_threshold=0.05, mask_pad_multiple=32)
    for name in ("jax", "port"):
        # frames wide enough for the stub's masks to pass the 400-pixel floor
        _scan(str(tmp_path / name), seed=5, frames=6, hw=(120, 160))
    jcfg = _jax("config").load_config("scannet").replace(
        data_root=str(tmp_path / "jax"), config_name="mp", **kw)
    jrep = _jax("run").run_pipeline(jcfg, [SCENE], steps=("masks", "cluster"), resume=False,
                                    mask_predictor=_stub)
    rep = run_pipeline(load_config("scannet", data_root=str(tmp_path / "port"),
                                   config_name="mp", **kw),
                       [SCENE], steps=("masks", "cluster"), resume=False,
                       mask_predictor=_stub, device="cpu")
    assert rep.ok and jrep.ok
    (got,), (want,) = rep.scenes, jrep.scenes
    assert got.num_objects == want.num_objects > 0
    assert got.digest == want.digest
    processed = os.path.join("scannet", "processed", SCENE)
    for rel in sorted(os.listdir(tmp_path / "jax" / processed / "output" / "mask")):
        path = os.path.join(processed, "output", "mask", rel)
        assert (tmp_path / "port" / path).read_bytes() == (tmp_path / "jax" / path).read_bytes()
    with np.load(tmp_path / "port" / "prediction" / "mp_class_agnostic" / f"{SCENE}.npz") as a, \
            np.load(tmp_path / "jax" / "prediction" / "mp_class_agnostic" / f"{SCENE}.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.gpu
def test_grid_segmenter_cuda_labels_equal_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (4, 5):
        rgb = _photo(480, 640, seed)
        cm, cs = mp.GridSegmenter(device="cuda")(rgb)
        hm, hs = mp.GridSegmenter(device="cpu")(rgb)
        assert cm.device.type == "cuda"
        np.testing.assert_array_equal(_np(cm), _np(hm))
        np.testing.assert_array_equal(cs, hs)
        np.testing.assert_array_equal(mp.rasterize_id_map(cm, cs), mp.rasterize_id_map(hm, hs))
    key = torch.as_tensor(_snake(64, 64))
    np.testing.assert_array_equal(mp._connected_components(key.cuda()).cpu().numpy(),
                                  mp._connected_components(key).numpy())
