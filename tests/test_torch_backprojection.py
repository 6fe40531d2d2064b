"""The port's dense association against the JAX package's, bit for bit.

Geometry, counting helpers, the voxel hash, ``estimate_spacing``, one
frame's ``associate_frame`` on the edge cases of
``ops/association_cases.py`` (both table forms) and ``associate_scene`` on
fixture scenes (every ``SceneAssociation`` field, window 1 and 2,
``frame_batch`` 1 and 2, both ``count_dtype`` values), each against the
jitted JAX function on the same numpy inputs. Tolerance zero everywhere.

Rounding contract: the port states an FMA exactly where XLA:CPU contracts
a multiply into an add (``ops.geometry.fma``). The ``half_pixel`` and
``dist2_near_r2`` cases sit on rounding boundaries, and
``test_cases_see_the_fma`` checks that an unfused version fails them, so a
misplaced FMA cannot pass unseen.

The CUDA kernels (``ops/cuda/associate.cu``, one launch each over a
stack of frames) are held against the plain scene versions on the same
cases, each as a scene of one frame, in the ``gpu`` tests, which skip
without a card; ``tests/test_torch_associate_scene.py`` adds the
multi-frame cases. The JAX package is imported inside the tests that
compare with it, so that on a machine with a card and no JAX the ``gpu``
tests run alone:

    python -m pytest -m gpu --noconftest tests/test_torch_backprojection.py
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from maskclustering_tpu_torch.models import backprojection as bp
from maskclustering_tpu_torch.ops import counting, geometry
from maskclustering_tpu_torch.ops.association_cases import CASES, association_case
from maskclustering_tpu_torch.utils.compile_cache import scene_pads

# one intra-op thread: the suite runs in parallel worker processes, where
# torch's CPU thread pool oversubscribes the cores and each of the many
# small ops waits at a barrier for descheduled threads
torch.set_num_threads(1)

KW = ("k_max", "window", "distance_threshold", "depth_trunc", "few_points_threshold",
      "coverage_threshold")
SCENES = {"seed4": dict(num_boxes=3, num_frames=10, image_hw=(60, 80), seed=4),
          "seed21": dict(num_boxes=4, num_frames=10, seed=21)}


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    return jax, jnp


def _bits_equal(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32), err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _pose(seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = q
    m[:3, 3] = rng.uniform(-5, 5, 3)
    return m


@pytest.mark.parametrize("seed", range(4))
def test_geometry_matches_jax(seed):
    jax, jnp = _jax()
    from maskclustering_tpu.ops import geometry as jg

    rng = np.random.default_rng(seed)
    m = _pose(seed)
    k = np.array([[577.6, 0, 319.5], [0, 578.7, 239.5], [0, 0, 1]], np.float32)
    pts = rng.uniform(-4, 4, (20011, 3)).astype(np.float32)
    depth = rng.uniform(0.3, 5, (48, 64)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.1] = 0.0
    origin = rng.uniform(-1, 1, 3).astype(np.float32)
    t = torch.from_numpy
    _bits_equal(geometry.invert_se3(t(m)), jax.jit(jg.invert_se3)(m), "invert_se3")
    _bits_equal(geometry.transform_points(t(pts), t(m)), jax.jit(jg.transform_points)(pts, m))
    uv, z = geometry.project_points(t(pts), t(k), t(m))
    juv, jz = jax.jit(jg.project_points)(pts, k, m)
    _bits_equal(uv, juv, "project uv")
    _bits_equal(z, jz, "project z")
    w, v = geometry.unproject_depth(t(depth), t(k), t(m), 4.0)
    jw, jv = jax.jit(jg.unproject_depth, static_argnames="depth_trunc")(depth, k, m,
                                                                       depth_trunc=4.0)
    _bits_equal(w, jw, "unproject points")
    _bits_equal(v, jv, "unproject valid")
    for vs in (0.02, 0.05):
        want = jax.jit(jg.voxel_keys, static_argnames="voxel_size")(pts, voxel_size=vs,
                                                                    origin=origin)
        _bits_equal(geometry.voxel_keys(t(pts), vs, t(origin)), want, f"voxel_keys {vs}")


def test_counting_helpers_match_jax():
    jax, jnp = _jax()
    from maskclustering_tpu.ops import counting as jc

    rng = np.random.default_rng(0)
    ids = rng.integers(-2, 9, (3, 5, 40)).astype(np.int32)
    for axis in (-1, 1, 0):
        want = np.asarray(jc.count_onehot(ids, 7, axis=axis)).astype(np.float32)
        _bits_equal(counting.count_onehot(torch.from_numpy(ids), 7, axis=axis), want)
    a = (rng.random((4, 6, 30)) < 0.4).astype(np.float32)
    b = (rng.random((30, 6, 5)) < 0.5).astype(np.float32)
    dn = (((2, 1), (0, 1)), ((), ()))
    for cd in ("bf16", "int8"):
        want = jc.count_dot_general(a, b, dn, count_dtype=cd, out_dtype=None)
        got = counting.count_dot_general(torch.from_numpy(a), torch.from_numpy(b), dn,
                                         count_dtype=cd, out_dtype=None)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        _bits_equal(got, want)
    a3 = (rng.random((2, 4, 9)) < 0.5).astype(np.float32)
    b3 = (rng.random((2, 9, 3)) < 0.5).astype(np.float32)
    dn = (((2,), (1,)), ((0,), (0,)))
    _bits_equal(counting.count_dot_general(torch.from_numpy(a3), torch.from_numpy(b3), dn),
                jc.count_dot_general(a3, b3, dn))


def test_voxel_hash_matches_jax():
    jax, jnp = _jax()
    from maskclustering_tpu.models import backprojection as jb

    rng = np.random.default_rng(1)
    keys = rng.integers(-2**31, 2**31, (5000, 3), dtype=np.int64).astype(np.int32)
    keys[:4] = [[-2**31, 0, 0], [2**31 - 1, 2**31 - 1, 2**31 - 1], [0, 0, 0], [29, -29, 7]]
    for num_ids in (64, 128, 1024):
        bits = bp._hash_bits(num_ids)
        assert bits == jb._hash_bits(num_ids)
        want = jax.jit(jb._hash_voxel, static_argnums=1)(keys, bits)
        _bits_equal(bp._hash_voxel(torch.from_numpy(keys), bits), want)


def _spacing_clouds():
    rng = np.random.default_rng(7)
    clouds = []
    for n, pad in ((5000, 3192), (16384, 0), (700, 324), (40000, 9152)):
        pts = np.full((n + pad, 3), 1.0e4, np.float32)
        pts[:n] = rng.uniform(-1, 1, (n, 3)) * rng.uniform(0.2, 3, 3)
        pts[n // 3: n // 3 + 50] = pts[:50]  # exact duplicates
        clouds.append(pts)
    clouds.append(np.full((4096, 3), 1.0e4, np.float32))  # all padding
    clouds.append(rng.uniform(0, 0.01, (9, 3)).astype(np.float32))  # tiny
    return clouds


@pytest.mark.parametrize("idx", range(6))
def test_estimate_spacing_matches_jax(idx):
    jax, jnp = _jax()
    from maskclustering_tpu.models import backprojection as jb

    pts = _spacing_clouds()[idx]
    want = jb.estimate_spacing(jnp.asarray(pts))
    got = bp.estimate_spacing(torch.from_numpy(pts))
    _bits_equal(got, want)
    _bits_equal(bp._vox_size_jit(torch.from_numpy(pts), distance_threshold=0.01),
                jb._vox_size_jit(jnp.asarray(pts), distance_threshold=0.01))


def test_estimate_spacing_rounds_as_jax_on_many_clouds(monkeypatch):
    """40 small clouds: each median lands on one point's nearest squared
    distance, so together they see where the FMAs of that sum fall (a
    version that rounds every product fails some of them)."""
    jax, jnp = _jax()
    from maskclustering_tpu.models import backprojection as jb

    rng = np.random.default_rng(11)
    clouds = [(rng.uniform(-1, 1, (64, 3)) * rng.uniform(0.05, 2, 3)).astype(np.float32)
              for _ in range(40)]
    want = [np.asarray(jb.estimate_spacing(jnp.asarray(c))) for c in clouds]
    got = [bp.estimate_spacing(torch.from_numpy(c)).numpy() for c in clouds]
    for g, w in zip(got, want):
        _bits_equal(g, w)
    monkeypatch.setattr(bp, "fma", lambda a, b, c: a * b + c)
    twice = [bp.estimate_spacing(torch.from_numpy(c)).numpy() for c in clouds]
    assert any(t.view(np.uint32) != w.view(np.uint32) for t, w in zip(twice, want))


def _frame_args(case, device="cpu"):
    t = [torch.from_numpy(np.asarray(case[k])).to(device)
         for k in ("points", "depth", "seg", "intrinsics", "cam_to_world")]
    return (*t, torch.tensor(case["frame_valid"]).to(device))


def _port_frame(case, vox=None, device="cpu"):
    return bp.associate_frame(*_frame_args(case, device), vox, **{k: case[k] for k in KW})


@pytest.mark.parametrize("name", list(CASES))
def test_associate_frame_matches_jax(name):
    """The port's one gather table against both of the JAX package's
    table forms."""
    jax, jnp = _jax()
    from maskclustering_tpu.models import backprojection as jb

    case = association_case(name)
    got = _port_frame(case)
    for full in (True, False):
        want = jb.associate_frame(
            jnp.asarray(case["points"]), case["depth"], case["seg"], case["intrinsics"],
            case["cam_to_world"], jnp.asarray(case["frame_valid"]), None,
            full_tile_table=full, **{k: case[k] for k in KW})
        for field in want._fields:
            w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
            assert g.dtype == w.dtype, field
            _bits_equal(g, w, f"{name} full_tile_table={full} {field}")


@pytest.mark.parametrize("name", ["half_pixel", "dist2_near_r2"])
def test_cases_see_the_fma(name, monkeypatch):
    """Rounding the FMA sites of the claim twice changes the answer on
    these cases: they can tell a right contraction from a wrong one."""
    case = association_case(name)
    right = _port_frame(case)
    monkeypatch.setattr(bp, "fma", lambda a, b, c: a * b + c)
    twice = _port_frame(case)
    assert any(not torch.equal(getattr(right, f), getattr(twice, f)) for f in right._fields)


def test_associate_frame_with_vox_size_matches_jax():
    jax, jnp = _jax()
    from maskclustering_tpu.models import backprojection as jb

    case = association_case("filters_on")
    vox = np.float32(0.037)
    want = jb.associate_frame(
        jnp.asarray(case["points"]), case["depth"], case["seg"], case["intrinsics"],
        case["cam_to_world"], jnp.asarray(True), jnp.float32(vox), **{k: case[k] for k in KW})
    got = _port_frame(case, vox=torch.tensor(vox))
    for field in want._fields:
        _bits_equal(getattr(got, field), getattr(want, field), field)


def _padded_scene(name):
    from maskclustering_tpu_torch.config import PipelineConfig
    from maskclustering_tpu_torch.models.pipeline import pad_scene_tensors
    from maskclustering_tpu_torch.utils.synthetic import make_scene, to_scene_tensors

    t = to_scene_tensors(make_scene(**SCENES[name]))
    return pad_scene_tensors(t, *scene_pads(PipelineConfig(), t.num_frames, t.num_points))


_PADDED = {}


@pytest.mark.parametrize("scene,window,frame_batch,count_dtype", [
    ("seed4", 1, 1, "bf16"), ("seed4", 2, 1, "int8"), ("seed4", 1, 2, "int8"),
    ("seed4", 2, 2, "bf16"), ("seed21", 1, 1, "int8"), ("seed21", 2, 2, "bf16")])
def test_associate_scene_matches_jax(scene, window, frame_batch, count_dtype):
    jax, jnp = _jax()
    from maskclustering_tpu.models import backprojection as jb

    if scene not in _PADDED:
        _PADDED[scene] = _padded_scene(scene)
    padded = _PADDED[scene]

    kw = dict(k_max=31, window=window, distance_threshold=0.03, depth_trunc=20.0,
              few_points_threshold=10, coverage_threshold=0.3)
    arrays = (padded.scene_points, padded.depths, padded.segmentations, padded.intrinsics,
              padded.cam_to_world, padded.frame_valid)
    # the port's counts are exact integers and its frames run one at a time:
    # one association for either count_dtype and any frame_batch
    want = jb.associate_scene(*(jnp.asarray(a) for a in arrays), count_dtype=count_dtype,
                              frame_batch=frame_batch, **kw)
    got = bp.associate_scene(*(torch.from_numpy(np.asarray(a)) for a in arrays), **kw)
    assert int(np.asarray(want.mask_valid).sum()) > 10
    for field in want._fields:
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype, field
        _bits_equal(g, w, field)


@pytest.mark.parametrize("frames,points", [(10, 59877), (34, 60000), (1, 1), (33, 8193)])
def test_scene_pads_and_padding_match_jax(frames, points):
    pytest.importorskip("jax")
    from maskclustering_tpu.config import PipelineConfig as JaxConfig
    from maskclustering_tpu.models.pipeline import pad_scene_tensors as jax_pad
    from maskclustering_tpu.utils.compile_cache import scene_pads as jax_scene_pads
    from maskclustering_tpu_torch.config import from_jax_config
    from maskclustering_tpu_torch.datasets.base import SceneTensors
    from maskclustering_tpu_torch.models.pipeline import pad_scene_tensors

    for kw in ({}, dict(point_chunk=4096, frame_pad_multiple=8)):
        cfg = JaxConfig(**kw)
        pads = scene_pads(from_jax_config(dataclasses.asdict(cfg)), frames, points)
        assert pads == jax_scene_pads(cfg, frames, points)
    shards = SimpleNamespace(point_chunk=8192, frame_pad_multiple=32, point_shards=3)
    assert scene_pads(shards, frames, points) == jax_scene_pads(shards, frames, points)
    rng = np.random.default_rng(frames)
    t = SceneTensors(scene_points=rng.standard_normal((points, 3)).astype(np.float32),
                     depths=rng.random((frames, 4, 5)).astype(np.float32),
                     segmentations=rng.integers(0, 9, (frames, 4, 5)).astype(np.int32),
                     intrinsics=rng.random((frames, 3, 3)).astype(np.float32),
                     cam_to_world=rng.random((frames, 4, 4)).astype(np.float32),
                     frame_valid=rng.random(frames) < 0.8, frame_ids=list(range(frames)))
    f_pad, n_pad = scene_pads(from_jax_config(dataclasses.asdict(JaxConfig())), frames, points)
    got, want = pad_scene_tensors(t, f_pad, n_pad), jax_pad(t, f_pad, n_pad)
    for field in dataclasses.fields(want):
        g, w = getattr(got, field.name), getattr(want, field.name)
        if field.name == "frame_ids":
            assert list(g) == list(w)
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype, field.name
            _bits_equal(g, w, field.name)
    with pytest.raises(ValueError, match="smaller than scene"):
        pad_scene_tensors(t, f_pad, points - 1)


def test_claim_dispatch_refuses_other_devices():
    p = torch.zeros((1, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        bp.pixel_table(p, p, p, k_max=7)
    with pytest.raises(ValueError, match="cuda or cpu"):
        bp.claim_scene(p, p, p, k_max=7)
    with pytest.raises(ValueError, match="cuda or cpu"):
        bp.assign_scene(p, p, p, p, k_max=7)


def _scene_args(case, device="cpu"):
    """A one-frame case as the scene entries take it: the cloud, the
    (1, H, W) stacks and the (1, 18) parameters."""
    pts, depth, seg, intr, c2w, _ = _frame_args(case, device)
    prm = bp.claim_params(intr[None], geometry.invert_se3(c2w[None]),
                          distance_threshold=case["distance_threshold"],
                          depth_trunc=case["depth_trunc"])
    return pts, depth[None], seg[None], prm


def test_cuda_wrappers_refuse_cpu_tensors():
    from maskclustering_tpu_torch.ops.cuda import (
        associate_assign_scene_cuda,
        associate_claim_scene_cuda,
        associate_table_cuda,
    )

    pts, depths, segs, prm = _scene_args(association_case("n_one"))
    table = bp.pixel_table_reference(depths, segs, prm, k_max=63)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        associate_table_cuda(depths, segs, prm, k_max=63)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        associate_claim_scene_cuda(pts, table, prm, k_max=63, window=1)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        associate_assign_scene_cuda(pts, table, prm, torch.zeros((1, 64), dtype=torch.bool),
                                    k_max=63, window=1)


def check_kernels_match_plain(pts, depths, segs, prm, *, k_max, window):
    """The three association kernels against their plain scene versions on
    the card, bit for bit, one launch each; each kernel fed the inputs its
    plain version takes."""
    from maskclustering_tpu_torch.ops.cuda import LAUNCHES

    kw = dict(k_max=k_max, window=window)
    before = dict(LAUNCHES.counts)
    table = bp.pixel_table(depths, segs, prm, k_max=k_max)
    assert torch.equal(table, bp.pixel_table_reference(depths, segs, prm, k_max=k_max))
    n_claimed = bp.claim_scene(pts, table, prm, **kw)
    assert torch.equal(n_claimed, bp.claim_scene_reference(pts, table, prm, **kw))
    mask_valid = torch.rand((depths.shape[0], k_max + 1), device=pts.device) < 0.7
    got = bp.assign_scene(pts, table, prm, mask_valid, **kw)
    want = bp.assign_scene_reference(pts, table, prm, mask_valid, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for name in ("associate_table", "associate_claim", "associate_assign"):
        assert LAUNCHES.counts[name] == before.get(name, 0) + 1, name


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_kernels_match_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA association kernels need a CUDA card")
    case = association_case(name)
    dev = torch.device("cuda", 0)
    check_kernels_match_plain(*_scene_args(case, dev), k_max=case["k_max"],
                              window=case["window"])
    # the whole frame on the card equals the plain version on the CPU
    on_card, on_cpu = _port_frame(case, device=dev), _port_frame(case)
    for field in on_cpu._fields:
        assert torch.equal(getattr(on_card, field).cpu(), getattr(on_cpu, field)), field
