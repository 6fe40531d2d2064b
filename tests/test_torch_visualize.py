"""The port's visualisation (``maskclustering_tpu_torch/visualize/``)
against the JAX package's, on the CPU.

``project_zbuffer`` must give the jitted JAX program's image, depth buffer
and visibility bit for bit (random posed clouds, the cases of
``ops/splat_cases.py`` and those of ``tests/test_visualize.py``: behind the
camera, pixel coordinates on .5, depth ties with different colours, no
valid point); ``bbox_by_projection``, ``draw_bbox`` and ``stitch_grid`` the
JAX arrays; every file of ``save_debug_grids``, ``vis_scene``,
``depth_preview``, ``compare_mask_dirs`` and ``fused_cloud_preview`` the
JAX package's bytes. ``vis_mask_frame`` stamps its own digit glyphs: every
pixel outside the boxes cv2's Hershey font takes is JAX's, and each box
holds a black pixel of the port's. PNG bytes are PIL's; the reader takes
what PIL reads. ``gpu`` cases hold the kernels against the plain version.
"""

import importlib
import io
import os

import numpy as np
import pytest
import torch

from maskclustering_tpu_torch import visualize as pv
from maskclustering_tpu_torch.io.png import decode_png_rgb, encode_png_pillow
from maskclustering_tpu_torch.ops.splat_cases import SPLAT_BATCHES, SPLAT_CASES
from maskclustering_tpu_torch.visualize import top_images as pt

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

needs_gpu = pytest.mark.gpu


def _jax(name):
    """A module of the JAX package, imported inside the tests that compare
    with it: the card's machine, which runs the ``gpu`` cases, has no JAX."""
    return importlib.import_module(f"maskclustering_tpu.{name}")


def _pil():
    return importlib.import_module("PIL.Image")


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8) if a.dtype != bool else a


def _jax_zbuffer(case):
    jnp = importlib.import_module("jax.numpy")
    out = _jax("visualize.top_images").project_zbuffer(
        jnp.asarray(case["points"]), jnp.asarray(case["colors"]),
        jnp.asarray(case["intrinsics"]), jnp.asarray(case["cam_to_world"]),
        case["height"], case["width"])
    return [np.asarray(x) for x in out]


def _random_case(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 3000))
    h, w = int(rng.integers(4, 90)), int(rng.integers(4, 120))
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    q *= np.sign(np.linalg.det(q))
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3], c2w[:3, 3] = q, rng.normal(size=3)
    k = np.array([[rng.uniform(20, 500), 0, rng.uniform(0, w)],
                  [0, rng.uniform(20, 500), rng.uniform(0, h)], [0, 0, 1]], np.float32)
    cam = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(-0.5, 4, n)], 1)
    pts = (cam @ q.T + c2w[:3, 3]).astype(np.float32)
    if n > 12:
        pts[n // 2:n // 2 + 6] = pts[:6]
    return {"points": pts, "colors": rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32),
            "intrinsics": k, "cam_to_world": c2w, "height": h, "width": w}


# the cases of tests/test_visualize.py:72-119
_K50 = np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]], np.float32)
_JAX_TEST_CASES = {
    "oracle_cloud": dict(
        points=np.stack([np.random.default_rng(3).uniform(-0.5, 0.5, 300),
                         np.random.default_rng(4).uniform(-0.4, 0.4, 300),
                         np.random.default_rng(5).uniform(1.0, 3.0, 300)], 1).astype(np.float32),
        colors=np.random.default_rng(6).uniform(size=(300, 3)).astype(np.float32),
        intrinsics=_K50, cam_to_world=np.eye(4, dtype=np.float32), height=48, width=64),
    "behind_camera": dict(points=np.array([[0, 0, -1.0], [0, 0, 2.0]], np.float32),
                          colors=np.ones((2, 3), np.float32), intrinsics=_K50,
                          cam_to_world=np.eye(4, dtype=np.float32), height=48, width=64),
    "bbox_half_even": dict(points=np.array([[0.0, 0.0, 2.0], [0.2, 0.1, 2.0]], np.float32),
                           colors=np.zeros((2, 3), np.float32), intrinsics=_K50,
                           cam_to_world=np.eye(4, dtype=np.float32), height=48, width=64),
}


@pytest.mark.parametrize("name", sorted(SPLAT_CASES) + sorted(_JAX_TEST_CASES)
                         + [f"random_{s}" for s in range(8)])
def test_project_zbuffer_bit_equal_to_jax(name):
    case = (SPLAT_CASES.get(name) or _JAX_TEST_CASES.get(name)
            or _random_case(int(name.split("_")[1])))
    want = _jax_zbuffer(case)
    got = [t.numpy() for t in pv.project_zbuffer(
        case["points"], case["colors"], case["intrinsics"], case["cam_to_world"],
        case["height"], case["width"], device="cpu")]
    for what, g, w in zip(("image", "zbuf", "visible"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert np.array_equal(_bits(g), _bits(w)), f"{name}: {what} differs"


def test_pixel_on_half_rounds_to_even_and_a_contracted_fma_breaks_it(monkeypatch):
    """50 * 0.1 / 2 + 32 = 34.5 -> 34 and 26.5 -> 26; the camera transform
    is an index-order FMA chain, and one product rounded alone on a posed
    camera moves a pixel: the test would see it."""
    img, zbuf, vis = pv.project_zbuffer(np.array([[0.1, 0.1, 2.0]], np.float32),
                                        np.ones((1, 3), np.float32), _K50,
                                        np.eye(4, dtype=np.float32), 48, 64, device="cpu")
    assert vis.tolist() == [True] and torch.isfinite(zbuf[26, 34]).item()
    case = SPLAT_CASES["random_4097"]
    want = _jax_zbuffer(case)
    from maskclustering_tpu_torch.ops import geometry

    monkeypatch.setattr(geometry, "fma", lambda a, b, c: a * b + c)
    got = pv.project_zbuffer(case["points"], case["colors"], case["intrinsics"],
                             case["cam_to_world"], case["height"], case["width"], device="cpu")
    # a product rounded before the add lands some point one pixel over
    assert not all(np.array_equal(_bits(g.numpy()), _bits(w)) for g, w in zip(got, want))


def test_cuda_tensor_never_takes_the_plain_version_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pv.project_zbuffer(np.zeros((1, 3)), np.zeros((1, 3)), _K50, np.eye(4), 4, 4)
    from maskclustering_tpu_torch.ops.cuda import splat_depth_cuda

    with pytest.raises(ValueError, match="needs CUDA tensors"):
        splat_depth_cuda(torch.zeros((2, 3)), torch.zeros((1, 16)), height=4, width=4)


@pytest.mark.parametrize("name", ["behind_camera", "half_pixel", "depth_ties", "all_invalid",
                                  "random_1000", "random_4097", "saturating"])
def test_bbox_by_projection_equal_to_jax(name):
    case = SPLAT_CASES[name]
    hw = (case["height"], case["width"])
    want = _jax("visualize.top_images").bbox_by_projection(
        case["points"], case["intrinsics"], case["cam_to_world"], hw)
    got = pv.bbox_by_projection(case["points"], case["intrinsics"], case["cam_to_world"], hw,
                                device="cpu")
    assert got == want
    # the JAX test's box: the centre pixel and 26.5 rounded to 26
    c = _JAX_TEST_CASES["bbox_half_even"]
    assert pv.bbox_by_projection(c["points"], c["intrinsics"], c["cam_to_world"], (48, 64),
                                 device="cpu") == (32, 24, 37, 26)


def _random_batch(seed, frames):
    """A random case's points under ``frames`` random posed cameras."""
    cams = [_random_case(seed * 100 + k) for k in range(frames)]
    case = dict(_random_case(seed))
    case["intrinsics"] = np.stack([c["intrinsics"] for c in cams])
    case["cam_to_world"] = np.stack([c["cam_to_world"] for c in cams])
    return case


_BATCH_NAMES = sorted(SPLAT_BATCHES) + ["random_f4", "random_f5"]


def _batch(name):
    if name in SPLAT_BATCHES:
        return SPLAT_BATCHES[name]
    return _random_batch(int(name[-1]), int(name[-1]))


def _frame(case, k):
    out = dict(case)
    out["intrinsics"], out["cam_to_world"] = case["intrinsics"][k], case["cam_to_world"][k]
    return out


def _params(case):
    return pt.splat_params(torch.from_numpy(case["intrinsics"]),
                           torch.from_numpy(case["cam_to_world"]))


@pytest.mark.parametrize("name", _BATCH_NAMES)
def test_bboxes_by_projection_equal_to_jax(name):
    """F cameras (F = 3..5) and each alone (F = 1): the batched box, its
    plain version and the one-frame call equal F calls of the JAX
    ``bbox_by_projection``."""
    case = _batch(name)
    hw = (case["height"], case["width"])
    f = case["intrinsics"].shape[0]
    jt = _jax("visualize.top_images")
    want = [jt.bbox_by_projection(case["points"], case["intrinsics"][k],
                                  case["cam_to_world"][k], hw) for k in range(f)]
    got = pv.bboxes_by_projection(case["points"], case["intrinsics"], case["cam_to_world"], hw,
                                  device="cpu")
    assert got == want
    pts = torch.from_numpy(case["points"])
    box = pt.splat_bbox_reference(pts, _params(case), *hw)
    assert box.shape == (f, 4) and box.dtype == torch.int32
    for k in range(f):
        row = tuple(box[k].tolist())
        assert (None if row[0] > row[2] else row) == want[k]
        one = _frame(case, k)
        assert pv.bbox_by_projection(case["points"], one["intrinsics"], one["cam_to_world"], hw,
                                     device="cpu") == want[k]
        assert tuple(pt.splat_bbox_reference(pts, _params(one)[None], *hw)[0].tolist()) == row
    if want.count(None):  # an empty frame keeps the reduction's start values
        k = want.index(None)
        assert box[k].tolist() == [2 ** 31 - 1, 2 ** 31 - 1, -2 ** 31, -2 ** 31]


@pytest.mark.parametrize("name", _BATCH_NAMES)
def test_project_zbuffers_equal_to_jax(name):
    """The F-camera plain depth and colour passes (the kernels' plain
    versions, one pass for all the frames) equal F calls of the JAX
    ``project_zbuffer``, frame by frame, and each frame alone equals the
    port's ``project_zbuffer``."""
    case = _batch(name)
    h, w = case["height"], case["width"]
    pts, cols = torch.from_numpy(case["points"]), torch.from_numpy(case["colors"])
    prm = _params(case)
    zbuf = pt.splat_depth_reference(pts, prm, h, w)
    codebuf, visible = pt.splat_color_reference(pts, cols, prm, zbuf, h, w)
    f = case["intrinsics"].shape[0]
    assert zbuf.shape == codebuf.shape == (f, h * w + 1) and visible.shape == (f, len(pts))
    for k in range(f):
        got = (pt._unpack(codebuf[k], h, w), zbuf[k, :h * w].view(torch.float32).reshape(h, w),
               visible[k])
        one = _frame(case, k)
        port = pv.project_zbuffer(one["points"], one["colors"], one["intrinsics"],
                                  one["cam_to_world"], h, w, device="cpu")
        for what, g, p, r in zip(("image", "zbuf", "visible"), got, port, _jax_zbuffer(one)):
            g = g.numpy()
            assert g.dtype == r.dtype and g.shape == r.shape, what
            assert np.array_equal(_bits(g), _bits(r)), f"{name} frame {k}: {what} differs"
            assert np.array_equal(_bits(p.numpy()), _bits(r)), f"{name} frame {k}: {what}"


def test_box_traps_are_live():
    """The cases aim where they say: the point at z = +inf lands in the
    image and leaves its pixel +inf; the NaN pixel x fills column 0; the
    middle frame of ``empty_between`` is empty between two full ones."""
    c = SPLAT_CASES["z_inf_in_bounds"]
    prm = _params(c)[None]
    valid, lin, z = pt._project(torch.from_numpy(c["points"]), prm, c["height"], c["width"])
    assert bool(valid[0, 0]) and torch.isinf(z[0, 0]) and int(lin[0, 0]) == 0
    zbuf = pt.splat_depth_reference(torch.from_numpy(c["points"]), prm, c["height"], c["width"])
    assert int(zbuf[0, 0]) == 0x7F800000
    c = SPLAT_CASES["nan_x"]
    _, zmap, _ = pv.project_zbuffer(c["points"], c["colors"], c["intrinsics"],
                                    c["cam_to_world"], c["height"], c["width"], device="cpu")
    filled = torch.isfinite(zmap)
    assert filled[:, 0].any() and not filled[:, 1:].any()
    boxes = pv.bboxes_by_projection(SPLAT_BATCHES["empty_between"]["points"],
                                    SPLAT_BATCHES["empty_between"]["intrinsics"],
                                    SPLAT_BATCHES["empty_between"]["cam_to_world"], (48, 64),
                                    device="cpu")
    assert boxes[0] is not None and boxes[1] is None and boxes[2] is not None


def test_stacked_splat_params_bit_equal_to_single_calls():
    """A stack of cameras gives each camera's bits as a call of its own."""
    rng = np.random.default_rng(11)
    for f in (1, 2, 5, 9):
        cases = [_random_case(int(rng.integers(1000))) for _ in range(f)]
        intr = np.stack([c["intrinsics"] for c in cases])
        c2w = np.stack([c["cam_to_world"] for c in cases])
        c2w[-1, :3, 3] *= np.float32(1e30)  # far translations round on their own
        if f > 2:
            c2w[1] = np.inf  # an invalid pose: its row is NaN, the others not
        stacked = pt.splat_params(torch.from_numpy(intr), torch.from_numpy(c2w))
        assert stacked.shape == (f, 16) and stacked.dtype == torch.float32
        single = torch.stack([pt.splat_params(torch.from_numpy(intr[k]),
                                              torch.from_numpy(c2w[k])) for k in range(f)])
        assert np.array_equal(_bits(stacked.numpy()), _bits(single.numpy()))


def test_draw_bbox_equal_to_jax():
    jt = _jax("visualize.top_images")
    rng = np.random.default_rng(7)
    for _ in range(30):
        h, w = int(rng.integers(3, 60)), int(rng.integers(3, 60))
        rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        box = tuple(int(v) for v in rng.integers(-5, 70, 4))
        t = int(rng.integers(1, 7))
        assert np.array_equal(pv.draw_bbox(rgb, box, thickness=t),
                              jt.draw_bbox(rgb, box, thickness=t))
    assert np.array_equal(pv.draw_bbox(rgb, None), rgb)


@pytest.mark.parametrize("count", [0, 1, 2, 5, 9, 11])
def test_stitch_grid_equal_to_jax(count):
    rng = np.random.default_rng(count)
    images = [rng.integers(0, 256, (int(rng.integers(5, 70)), int(rng.integers(5, 90)), 3))
              .astype(np.uint8) for _ in range(count)]
    want = _jax("visualize.top_images").stitch_grid(images, cell=48)
    got = pt.stitch_grid(images, cell=48)
    assert got.shape == want.shape and np.array_equal(got, want)


class _DS:
    """A dataset duck-type over seeded arrays (both packages' viewers take it)."""

    def __init__(self, seed=0, n_frames=4, hw=(30, 40), rgb_hw=None):
        rng = np.random.default_rng(seed)
        self.hw = hw
        h, w = hw
        self.depth = [np.where(rng.random(hw) < 0.1, 0.0, rng.uniform(0.5, 3.0, hw))
                      .astype(np.float32) for _ in range(n_frames)]
        rh, rw = rgb_hw or hw
        self.rgb = [rng.integers(0, 256, (rh, rw, 3)).astype(np.uint8) for _ in range(n_frames)]
        self.seg = []
        for _ in range(n_frames):
            seg = np.zeros(hw, np.uint16)
            for m in range(1, 4):
                y, x = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
                seg[y:y + h // 2, x:x + w // 2] = m
            self.seg.append(seg)
        self.intr = np.array([[35.0, 0, w / 2 - 0.5], [0, 35.0, h / 2 - 0.5], [0, 0, 1]])
        self.pose = []
        for i in range(n_frames):
            m = np.eye(4)
            m[:3, 3] = [0.05 * i, -0.02 * i, 0.0]
            self.pose.append(m)
        if n_frames > 2:
            self.pose[2] = np.full((4, 4), np.inf)  # an invalid pose: no points

    def get_frame_list(self, stride):
        return list(range(0, len(self.depth), stride))

    def get_depth(self, f):
        return self.depth[f]

    def get_rgb(self, f):
        return self.rgb[f]

    def get_intrinsics(self, f):
        return self.intr

    def get_extrinsic(self, f):
        return self.pose[f]

    def get_segmentation(self, f, align_with_depth=True):
        return self.seg[f]


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def test_save_debug_grids_files_equal_to_jax(tmp_path):
    ds = _DS(seed=1, n_frames=4, hw=(36, 48))
    rng = np.random.default_rng(2)
    cloud = np.stack([rng.uniform(-0.6, 0.6, 800), rng.uniform(-0.4, 0.4, 800),
                      rng.uniform(1.0, 2.5, 800)], 1)
    objects = {
        0: {"point_ids": np.arange(0, 300), "mask_list": [],
            "repre_mask_list": [(0, 1, 0.51234), (1, 2, 0.25), (3, 1, 0.9)]},
        3: {"point_ids": np.arange(300, 800), "mask_list": [],
            "repre_mask_list": [(f % 4, 1, 0.1 * f) for f in range(11)]},
        7: {"point_ids": np.array([5]), "mask_list": [], "repre_mask_list": []},
        8: {"point_ids": np.arange(10, 20), "mask_list": [], "repre_mask_list": [(2, 1, 0.3)]},
    }
    ja = _jax("visualize.top_images").save_debug_grids(ds, objects, cloud, str(tmp_path / "j"))
    po = pv.save_debug_grids(ds, objects, cloud, str(tmp_path / "p"), device="cpu")
    assert [os.path.relpath(p, tmp_path / "p") for p in po] == \
        [os.path.relpath(p, tmp_path / "j") for p in ja]
    want, got = _files(tmp_path / "j"), _files(tmp_path / "p")
    assert len(want) == 4 + 3 + 11 + 1 and got == want
    # max_objects keeps the first keys
    assert len(pv.save_debug_grids(ds, objects, cloud, str(tmp_path / "m"), max_objects=2,
                                   device="cpu")) == 2


def test_save_debug_grids_books_one_splat_bbox_an_object(tmp_path, monkeypatch):
    """On the CPU the step books one ``splat_bbox`` plain launch key an
    object with frames, with all its frames, and no depth or colour pass."""
    from maskclustering_tpu_torch.ops import cuda as kernels

    keys = []
    monkeypatch.setattr(kernels, "LAUNCH_HOOKS", [lambda name, shape: keys.append((name, shape))])
    ds = _DS(seed=3, n_frames=4, hw=(36, 48))
    cloud = np.random.default_rng(4).uniform(-0.5, 0.5, (400, 3)) + [0.0, 0.0, 2.0]
    objects = {
        1: {"point_ids": np.arange(0, 150), "mask_list": [],
            "repre_mask_list": [(0, 1, 0.5), (2, 1, 0.25), (3, 2, 0.75)]},
        2: {"point_ids": np.arange(150, 400), "mask_list": [], "repre_mask_list": [(1, 1, 0.5)]},
        4: {"point_ids": np.arange(5), "mask_list": [], "repre_mask_list": []},
    }
    pv.save_debug_grids(ds, objects, cloud, str(tmp_path), device="cpu")
    assert keys == [("splat_bbox", (3, 150, 36, 48)), ("splat_bbox", (1, 250, 36, 48))]


def test_vis_scene_files_equal_to_jax(tmp_path):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(500, 3)) * [2.0, 1.0, 0.5] + [3.0, -1.0, 0.2]
    masks = rng.random((500, 6)) < 0.15
    masks[:, 4] = False  # an empty instance
    for colors in (rng.integers(0, 256, (500, 3)), rng.random((500, 3)), None):
        j = _jax("visualize.scene").vis_scene(pts, masks, str(tmp_path / "j"), scene_colors=colors)
        p = pv.vis_scene(pts, masks, str(tmp_path / "p"), scene_colors=colors)
        assert sorted(j) == sorted(p) and _files(tmp_path / "p") == _files(tmp_path / "j")
    # no instances at all
    pv.vis_scene(pts, np.zeros((500, 0), bool), str(tmp_path / "p0"))
    _jax("visualize.scene").vis_scene(pts, np.zeros((500, 0), bool), str(tmp_path / "j0"))
    assert _files(tmp_path / "p0") == _files(tmp_path / "j0")
    assert np.array_equal(pv.instance_palette(9, seed=3),
                          _jax("visualize.scene").instance_palette(9, seed=3))


def test_depth_preview_and_fused_cloud_equal_to_jax(tmp_path):
    jv = _jax("visualize.debug_viewers")
    ds = _DS(seed=5, n_frames=4, hw=(30, 40), rgb_hw=(60, 80))  # colour resized nearest
    for f in (0, 1, 2):
        jv.depth_preview(ds, f, str(tmp_path / "j"))
        pv.depth_preview(ds, f, str(tmp_path / "p"))
    zero = _DS(seed=6, n_frames=1)
    zero.depth[0][:] = 0.0  # all invalid: dmax 0
    jv.depth_preview(zero, 0, str(tmp_path / "jz"))
    pv.depth_preview(zero, 0, str(tmp_path / "pz"))
    for kw in (dict(), dict(stride=2), dict(max_points_per_frame=100),
               dict(frame_ids=[3, 0])):
        jv.fused_cloud_preview(ds, str(tmp_path / "j" / "fused.ply"), **kw)
        pv.fused_cloud_preview(ds, str(tmp_path / "p" / "fused.ply"), **kw)
        assert _files(tmp_path / "p") == _files(tmp_path / "j"), kw
    assert _files(tmp_path / "pz") == _files(tmp_path / "jz")


def _png_bytes(arr, mode=None, **save):
    b = io.BytesIO()
    im = _pil().fromarray(arr) if mode is None else _pil().fromarray(arr).convert(mode)
    im.save(b, format="PNG", **save)
    return b.getvalue()


def test_compare_mask_dirs_equal_to_jax(tmp_path):
    rng = np.random.default_rng(8)
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    rgb = lambda h, w: rng.integers(0, 256, (h, w, 3)).astype(np.uint8)  # noqa: E731
    pal = _pil().new("P", (13, 7))
    pal.putpalette(list(rng.integers(0, 256, 12)))
    pal.putdata(list(rng.integers(0, 4, 91)))
    buf = io.BytesIO()
    pal.save(buf, format="PNG")
    entries = {
        "0.png": (_png_bytes(rgb(20, 30)), _png_bytes(rgb(25, 18))),
        "1.png": (_png_bytes(rng.integers(0, 256, (9, 11)).astype(np.uint8)),
                  _png_bytes(rng.integers(0, 65536, (9, 11)).astype(np.uint16))),
        "2.png": (buf.getvalue(), _png_bytes(rng.integers(0, 256, (5, 6, 4)).astype(np.uint8))),
        "3.png": (_png_bytes(rng.integers(0, 2, (8, 9)).astype(bool)), _png_bytes(rgb(8, 9))),
        "4.jpg": (None, None),
        "notes.txt": (b"not an image", b"neither"),
        "only_a.png": (_png_bytes(rgb(4, 4)), None),
    }
    jpeg = importlib.import_module("maskclustering_tpu_torch.io.jpeg")
    entries["4.jpg"] = (jpeg.encode_jpeg(rgb(16, 24), 90), jpeg.encode_jpeg(rgb(8, 8), 75))
    for name, (x, y) in entries.items():
        if x is not None:
            (a / name).write_bytes(x)
        if y is not None:
            (b / name).write_bytes(y)
    want = _jax("visualize.debug_viewers").compare_mask_dirs(str(a), str(b), str(tmp_path / "j"))
    got = pv.compare_mask_dirs(str(a), str(b), str(tmp_path / "p"), separator_height=2)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 5 and _files(tmp_path / "p") == _files(tmp_path / "j")


@pytest.mark.parametrize("hw", [(1, 1), (1, 7), (5, 1), (17, 33), (64, 100), (240, 320)])
def test_encode_png_pillow_rgb_equal_to_pil(hw):
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    h, w = hw
    for img in (rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
                np.full((h, w, 3), (9, 200, 31), np.uint8),
                np.clip(np.cumsum(rng.integers(-4, 5, (h, w, 3)), axis=1) + 128, 0, 255)
                .astype(np.uint8)):
        assert encode_png_pillow(img) == _png_bytes(img)
        assert np.array_equal(decode_png_rgb(encode_png_pillow(img)), img)


def _handmade_png(rows: np.ndarray, width: int, bit_depth: int, color_type: int,
                  palette: bytes = b"") -> bytes:
    """A PNG file of already-packed filter-0 rows (sub-byte depths)."""
    import struct
    import zlib

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + r.tobytes() for r in rows)
    head = struct.pack(">IIBBBBB", width, len(rows), bit_depth, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", head)
            + (chunk(b"PLTE", palette) if palette else b"")
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("color_type", [0, 3])
def test_decode_png_rgb_palette_and_low_bit_grey_equal_to_pil(bits, color_type):
    rng = np.random.default_rng(bits * 10 + color_type)
    width, height = 13, 6
    stride = (width * bits + 7) // 8
    rows = rng.integers(0, 256, (height, stride)).astype(np.uint8)
    palette = rng.integers(0, 256, 3 * (1 << bits)).astype(np.uint8).tobytes() \
        if color_type == 3 else b""
    data = _handmade_png(rows, width, bits, color_type, palette)
    want = np.asarray(_pil().open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(decode_png_rgb(data), want)


def _label_boxes(seg):
    """Union of the boxes cv2's Hershey simplex takes for each id at scale
    1, thickness 2 about its centroid (the text origin), plus the
    thickness: (H, W) bool at the id-map's resolution."""
    cv2 = importlib.import_module("cv2")
    h, w = seg.shape
    box = np.zeros((h, w), bool)
    t = 2
    for mid in np.unique(seg):
        if mid == 0:
            continue
        ys, xs = np.nonzero(seg == mid)
        ox, oy = int(xs.mean()), int(ys.mean())
        (tw, th), base = cv2.getTextSize(str(int(mid)), cv2.FONT_HERSHEY_SIMPLEX, 1, t)
        box[max(0, oy - th - t):max(0, oy + base + t + 1),
            max(0, ox - t):max(0, ox + tw + t + 1)] = True
    return box


@pytest.mark.parametrize("seed,max_id", [(0, 3), (1, 12), (2, 250)])
def test_vis_mask_frame_equal_to_jax_outside_the_label_boxes(tmp_path, seed, max_id):
    rng = np.random.default_rng(seed)
    h, w = 80, 120
    seg = np.zeros((h, w), np.uint16)
    for m in sorted(rng.choice(np.arange(1, max_id + 1), min(max_id, 4), replace=False)):
        y, x = int(rng.integers(0, h - 40)), int(rng.integers(0, w - 60))
        seg[y:y + 40, x:x + 60] = m

    class DS:
        def get_segmentation(self, f, align_with_depth=True):
            return seg

        def get_rgb(self, f):
            return np.random.default_rng(seed + 100).integers(0, 256, (h, w, 3)).astype(np.uint8)

    jpath = _jax("visualize.mask2d").vis_mask_frame(DS(), 5, str(tmp_path / "j"))
    ppath = pv.vis_mask_frame(DS(), 5, str(tmp_path / "p"))
    assert os.path.basename(jpath) == os.path.basename(ppath) == "5.png"
    want = np.asarray(_pil().open(jpath).convert("RGB"))
    got = np.asarray(_pil().open(ppath).convert("RGB"))
    assert got.shape == want.shape == (h // 2, w, 3)
    # the seg half of the half-scale composite, and the boxes sampled alike
    boxes = np.zeros((h, 2 * w), bool)
    boxes[:, w:] = _label_boxes(seg)
    boxes = boxes[::2, ::2]
    assert np.array_equal(got[~boxes], want[~boxes])
    plain = np.concatenate([DS().get_rgb(0), pv.colorize_id_map(seg)], axis=1)[::2, ::2]
    for mid in np.unique(seg)[1:]:
        one = np.zeros((h, 2 * w), bool)
        one[:, w:] = _label_boxes(np.where(seg == mid, seg, 0))
        one = one[::2, ::2]
        drawn = one & (got == 0).all(axis=2) & (plain != 0).any(axis=2)
        assert drawn.any(), f"no glyph pixel for id {mid}"


def test_colormaps_equal_to_jax():
    jm = _jax("visualize.mask2d")
    assert np.array_equal(pv.create_colormap(), jm.create_colormap())
    assert np.array_equal(pv.create_colormap(17, seed=4), jm.create_colormap(17, seed=4))
    seg = np.random.default_rng(0).integers(0, 40, (9, 7))
    assert np.array_equal(pv.colorize_id_map(seg), jm.colorize_id_map(seg))
    cmap = pv.create_colormap(10)
    assert np.array_equal(pv.colorize_id_map(seg, cmap), jm.colorize_id_map(seg, cmap))


def test_visualize_exports_every_jax_name():
    jax_names = {n for n in dir(_jax("visualize")) if not n.startswith("_")}
    jax_names -= {"debug_viewers", "mask2d", "scene", "top_images"}
    assert jax_names <= set(dir(pv))


@needs_gpu
@pytest.mark.parametrize("name", sorted(SPLAT_CASES))
def test_splat_kernels_equal_to_plain_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from maskclustering_tpu_torch.ops import cuda as kernels

    c = SPLAT_CASES[name]
    dev = torch.device("cuda", 0)
    pts, cols = (torch.from_numpy(c[k]).to(dev) for k in ("points", "colors"))
    prm = pt.splat_params(torch.from_numpy(c["intrinsics"]).to(dev),
                          torch.from_numpy(c["cam_to_world"]).to(dev))[None]
    h, w = c["height"], c["width"]
    zb = kernels.splat_depth_cuda(pts, prm, height=h, width=w)
    cb, vis = kernels.splat_color_cuda(pts, cols, prm, zb, height=h, width=w)
    zr = pt.splat_depth_reference(pts, prm, h, w)
    cr, vr = pt.splat_color_reference(pts, cols, prm, zr, h, w)
    assert torch.equal(zb, zr) and torch.equal(cb, cr) and torch.equal(vis, vr)
    assert torch.equal(kernels.splat_bbox_cuda(pts, prm, height=h, width=w),
                       pt.splat_bbox_reference(pts, prm, h, w))
    # the three entries over F cameras: the case's own and two more
    b = SPLAT_BATCHES[name]
    prm = pt.splat_params(torch.from_numpy(b["intrinsics"]).to(dev),
                          torch.from_numpy(b["cam_to_world"]).to(dev))
    zb = kernels.splat_depth_cuda(pts, prm, height=h, width=w)
    cb, vis = kernels.splat_color_cuda(pts, cols, prm, zb, height=h, width=w)
    zr = pt.splat_depth_reference(pts, prm, h, w)
    cr, vr = pt.splat_color_reference(pts, cols, prm, zr, h, w)
    assert torch.equal(zb, zr) and torch.equal(cb, cr) and torch.equal(vis, vr)
    assert torch.equal(kernels.splat_bbox_cuda(pts, prm, height=h, width=w),
                       pt.splat_bbox_reference(pts, prm, h, w))
    assert pv.bboxes_by_projection(b["points"], b["intrinsics"], b["cam_to_world"], (h, w),
                                   device=dev) == \
        pv.bboxes_by_projection(b["points"], b["intrinsics"], b["cam_to_world"], (h, w),
                                device="cpu")
    card = pv.project_zbuffer(c["points"], c["colors"], c["intrinsics"], c["cam_to_world"],
                              h, w, device=dev)
    host = pv.project_zbuffer(c["points"], c["colors"], c["intrinsics"], c["cam_to_world"],
                              h, w, device="cpu")
    for g, r in zip(card, host):
        assert torch.equal(g.cpu().view(torch.uint8), r.view(torch.uint8))
