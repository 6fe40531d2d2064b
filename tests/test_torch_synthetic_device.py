"""The port's device scene generator (``utils/synthetic.py``:
``make_scene_device``, ``render_depth_seg_device``, ``visibility_count``,
``resize_scene_points``) against the JAX package's, on the CPU.

``make_scene_device(device="cpu")`` must return every array the jitted JAX
``make_scene_device`` returns, the depth and id frames bit for bit: at the
sizes of ``tests/test_pipeline.py::test_device_renderer_matches_numpy``,
with 11 boxes (a padded chunk of 8) and at the default floor. The plain
renderer must equal the jitted JAX renderer on the crafted cases of
``ops/render_cases.py`` and on random poses; a misplaced FMA in the ray
directions must show. ``gpu`` cases hold the ``render_depth_seg`` kernel
against the plain version on the card.
"""

import importlib

import numpy as np
import pytest
import torch

from maskclustering_tpu_torch.ops import cuda as kernels
from maskclustering_tpu_torch.ops import geometry
from maskclustering_tpu_torch.ops.render_cases import RENDER_CASES
from maskclustering_tpu_torch.utils import synthetic as ps

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)


def _js():
    """The JAX package's generator, imported inside the tests: the card's
    machine, which runs the ``gpu`` cases, has no JAX."""
    return importlib.import_module("maskclustering_tpu.utils.synthetic")


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


SCENES = {
    # tests/test_pipeline.py:161-165
    "pipeline_test": dict(num_boxes=4, num_frames=6, image_hw=(96, 128), spacing=0.02, seed=7,
                          room_half=2.0, camera_radius=3.2, floor_spacing=None,
                          camera_height=2.5),
    "eleven_boxes": dict(num_boxes=11, num_frames=5, image_hw=(60, 80), spacing=0.05, seed=5),
    "default_floor": dict(num_boxes=6, num_frames=4, image_hw=(48, 64), seed=2),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_make_scene_device_equals_jax(name):
    kw = SCENES[name]
    j_t, j_gt, j_oom = _js().make_scene_device(**kw)
    p_t, p_gt, p_oom = ps.make_scene_device(**kw, device="cpu")
    assert isinstance(p_t.depths, torch.Tensor) and p_t.depths.device.type == "cpu"
    assert p_t.depths.dtype == torch.float32 and p_t.segmentations.dtype == torch.int32
    for field in ("scene_points", "intrinsics", "cam_to_world", "frame_valid"):
        got, want = getattr(p_t, field), np.asarray(getattr(j_t, field))
        assert got.dtype == want.dtype and np.array_equal(got, want), field
    assert p_t.frame_ids == list(j_t.frame_ids)
    np.testing.assert_array_equal(_bits(p_t.depths.numpy()), _bits(j_t.depths))
    np.testing.assert_array_equal(p_t.segmentations.numpy(), np.asarray(j_t.segmentations))
    np.testing.assert_array_equal(p_gt, j_gt)
    np.testing.assert_array_equal(p_oom, j_oom)
    assert (p_t.segmentations > 0).any() and (p_t.depths > 0).any()


def _render_both(case):
    args = (case["boxes"], case["poses"], case["intrinsics"], case["perms"], case["image_hw"])
    j_d, j_s = (np.asarray(x) for x in _js().render_depth_seg_device(*args))
    p_d, p_s = ps.render_depth_seg_device(*args, device="cpu")
    return (j_d, j_s), (p_d.numpy(), p_s.numpy())


@pytest.mark.parametrize("name", sorted(RENDER_CASES))
def test_plain_renderer_equals_jax_on_the_crafted_cases(name):
    (j_d, j_s), (p_d, p_s) = _render_both(RENDER_CASES[name])
    np.testing.assert_array_equal(_bits(p_d), _bits(j_d))
    np.testing.assert_array_equal(p_s, j_s)


def test_crafted_cases_hit_what_they_aim_at():
    """Each case shows its edge: the tie goes to the lower index, the camera
    inside sees its box on every pixel, the box behind and the one under
    the floor never show, the floor shows, the padded boxes never hit."""
    def seg(name):
        c = RENDER_CASES[name]
        return c, ps.render_depth_seg_device(c["boxes"], c["poses"], c["intrinsics"],
                                             c["perms"], c["image_hw"], device="cpu")[1].numpy()

    c, s = seg("identical_boxes")
    for f in range(len(c["poses"])):
        assert set(np.unique(s[f])) == {0, int(c["perms"][f, 0])}
    c, s = seg("tie_across_chunks")
    assert int(c["perms"][0, 3]) in s[0] and int(c["perms"][0, 11]) not in s[0]
    c, s = seg("camera_inside")
    assert (s[0] == c["perms"][0, 0]).all()
    c, s = seg("box_behind")
    assert int(c["perms"][0, 0]) not in s[0] and int(c["perms"][0, 1]) in s[0]
    c, s = seg("floor_nearer")
    assert int(c["perms"][0, 0]) not in s[0] and int(c["perms"][0, 1]) in s[0] and 0 in s[0]
    c, s = seg("padded_chunk")
    assert set(np.unique(s)) - {0} == set(range(1, 12))


def test_zero_direction_case_reaches_safe_d():
    """The horizontal camera's centre column has x = 0 and its centre row
    z = -0 exactly: ``safe_d`` replaces them (a NaN or an inf would differ
    from JAX's answer above)."""
    c = RENDER_CASES["zero_direction"]
    h, w = c["image_hw"]
    assert (w - 1) % 2 == 0 and (h - 1) % 2 == 0
    d, _ = ps.render_depth_seg_device(c["boxes"], c["poses"], c["intrinsics"], c["perms"],
                                      c["image_hw"], device="cpu")
    assert torch.isfinite(d).all() and (d[:, :, (w - 1) // 2] > 0).any()


def _random_case(seed: int, f: int = 6, k: int = 9, hw=(40, 52)):
    rng = np.random.default_rng(seed)
    boxes = []
    for _ in range(k):
        c = rng.uniform(-2, 2, 2)
        half = rng.uniform(0.2, 0.6, 2)
        boxes.append([[c[0] - half[0], c[1] - half[1], 0.0],
                      [c[0] + half[0], c[1] + half[1], rng.uniform(0.3, 1.0)]])
    poses = [ps._look_at(np.array([*rng.uniform(-5, 5, 2), rng.uniform(0.5, 3)]),
                         np.array([*rng.uniform(-1, 1, 2), rng.uniform(0, 0.8)]))
             for _ in range(f)]
    h, w = hw
    fx = 1.1 * max(h, w)
    intr = np.tile(np.array([[fx, 0, (w - 1) / 2], [0, fx, (h - 1) / 2], [0, 0, 1]],
                            np.float32)[None], (f, 1, 1))
    perms = np.stack([rng.permutation(k) + 1 for _ in range(f)]).astype(np.int32)
    return {"boxes": np.array(boxes), "poses": np.stack(poses).astype(np.float32),
            "intrinsics": intr, "perms": perms, "image_hw": hw}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_renderer_equals_jax_on_random_poses(seed):
    (j_d, j_s), (p_d, p_s) = _render_both(_random_case(seed))
    np.testing.assert_array_equal(_bits(p_d), _bits(j_d))
    np.testing.assert_array_equal(p_s, j_s)


def test_a_separately_rounded_ray_direction_differs(monkeypatch):
    """The FMA of ``d_cam @ R.T`` is where XLA:CPU's rounding bites: the
    same renderer with the multiply and the add rounded apart gives other
    depth bits on these poses."""
    case = _random_case(0)
    (j_d, _), _ = _render_both(case)
    monkeypatch.setattr(geometry, "fma", lambda a, b, c: a * b + c)
    p_d, _ = ps.render_depth_seg_device(case["boxes"], case["poses"], case["intrinsics"],
                                        case["perms"], case["image_hw"], device="cpu")
    assert (_bits(p_d.numpy()) != _bits(j_d)).any()


def test_cpu_tensors_take_the_plain_version_and_others_raise():
    case = RENDER_CASES["padded_chunk"]
    kernels.LAUNCHES.reset()
    ps.render_depth_seg_device(case["boxes"], case["poses"], case["intrinsics"],
                               case["perms"], case["image_hw"], device="cpu")
    assert kernels.LAUNCHES.counts.get("render_depth_seg", 0) == 0
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ps.render_depth_seg_device(case["boxes"], case["poses"], case["intrinsics"],
                                   case["perms"], case["image_hw"], device="meta")
    assert "render_depth_seg" in kernels.ENTRIES and "render" in kernels.KERNELS


def test_render_bound_counts():
    """The bench scene's bound inputs: operations from the per-pixel,
    per-(pixel, box) and per-(frame, box) counts; bytes the inputs read
    once and 8 B a pixel written."""
    f, k, h, w = 250, 36, 480, 640
    assert kernels.render_ops(f, k, h, w) == f * h * w * (17 + 6 * k) + f * k * 6
    assert kernels.render_bytes(f, k, h, w) == 24 * k + f * (100 + 4 * k) + 8 * f * h * w


def test_resize_scene_points_equals_jax():
    pts = np.random.default_rng(4).standard_normal((1000, 3)).astype(np.float64)
    for n in (1000, 2500, 333):  # as is, the tiling branch, the subsample branch
        for seed in (0, 7):
            got = ps.resize_scene_points(pts, n, seed=seed)
            want = _js().resize_scene_points(pts, n, seed=seed)
            assert got.dtype == want.dtype == np.float32 and got.flags["C_CONTIGUOUS"]
            np.testing.assert_array_equal(got, want)


def test_visibility_count_equals_jax():
    kw = dict(num_boxes=3, num_frames=5, image_hw=(48, 64), spacing=0.05, seed=11)
    got = ps.visibility_count(ps.make_scene(**kw))
    want = _js().visibility_count(_js().make_scene(**kw))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (got > 0).any()
    np.testing.assert_array_equal(ps.visibility_count(ps.make_scene(**kw), tol=0.001),
                                  _js().visibility_count(_js().make_scene(**kw), tol=0.001))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(RENDER_CASES))
def test_kernel_equals_plain_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = RENDER_CASES[name]
    dev = torch.device("cuda", 0)
    kernels.LAUNCHES.reset()
    d_k, s_k = ps.render_depth_seg_device(c["boxes"], c["poses"], c["intrinsics"], c["perms"],
                                          c["image_hw"], device=dev)
    assert kernels.LAUNCHES.counts["render_depth_seg"] == 1
    d_p, s_p = ps.render_depth_seg_device(c["boxes"], c["poses"], c["intrinsics"], c["perms"],
                                          c["image_hw"], device="cpu")
    assert torch.equal(d_k.cpu().view(torch.int32), d_p.view(torch.int32))
    assert torch.equal(s_k.cpu(), s_p)
