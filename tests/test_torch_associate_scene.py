"""The dense association over a stack of frames, against the JAX package
and against the port's own per-frame path, bit for bit.

The scene entries (``models.backprojection.pixel_table``, ``claim_scene``
and ``assign_scene``) run every frame of a scene at once: one CUDA launch
each on the card, the plain scene versions on the CPU. Here, on the CPU:

- the integer counting helper against the ``bincount`` it replaced;
- the batched geometry (``invert_se3``, ``claim_params``,
  ``unproject_depth``) against one frame at a time;
- every field of ``associate_scene`` on the multi-frame cases of
  ``ops/association_cases.py`` against the jitted JAX function (both
  ``count_dtype`` values, both ``frame_batch`` values), and every frame's
  ``associate_frame`` against the JAX one;
- the plain pixel table against the backprojection in numpy float32;
- the plain scene functions against the per-frame path on the fixture
  scenes;
- the CUDA wrappers' refusals.

The ``gpu`` tests hold the kernels against the plain scene versions on
every multi-frame case, one launch each (the one-frame cases are
``tests/test_torch_backprojection.py``'s); they skip without a card. The
JAX package is imported inside the tests that compare with it, so the
``gpu`` tests run alone on a machine without JAX:

    python -m pytest -m gpu --noconftest tests/test_torch_associate_scene.py
"""

import numpy as np
import pytest
import torch

from maskclustering_tpu_torch.models import backprojection as bp
from maskclustering_tpu_torch.ops import geometry
from maskclustering_tpu_torch.ops.association_cases import SCENE_CASES, association_scene_case

# one intra-op thread: the suite runs in parallel worker processes (see
# tests/test_torch_backprojection.py)
torch.set_num_threads(1)

KW = ("k_max", "window", "distance_threshold", "depth_trunc", "few_points_threshold",
      "coverage_threshold")
ARRAYS = ("points", "depths", "segs", "intrinsics", "cam_to_world", "frame_valid")


def _bits_equal(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _tensors(case, device="cpu"):
    return [torch.from_numpy(np.asarray(case[k])).to(device) for k in ARRAYS]


def _old_counts_by_id(weights, ids, num_ids):
    # the helper before the scatter-add: a boolean select and a bincount,
    # each of which waits for the card on CUDA
    return torch.bincount(ids.reshape(-1)[weights.reshape(-1).bool()].long(),
                          minlength=num_ids)[:num_ids].to(torch.int32)


@pytest.mark.parametrize("kind", ["random", "empty", "all_background", "ids_at_k_max",
                                  "all_weights_zero"])
def test_counts_by_id_matches_bincount(kind):
    rng = np.random.default_rng(3)
    k_max = 63
    ids = torch.from_numpy({"random": rng.integers(0, k_max + 1, (50, 100)),
                            "empty": np.zeros(0, np.int64),
                            "all_background": np.zeros(3000, np.int64),
                            "ids_at_k_max": np.full(700, k_max),
                            "all_weights_zero": rng.integers(0, k_max + 1, 900)}[kind]
                           .astype(np.int32))
    weights = torch.from_numpy(rng.random(tuple(ids.shape)) < 0.6)
    if kind == "all_weights_zero":
        weights = torch.zeros_like(weights)
    for w in (weights, torch.ones_like(ids)):
        got = bp._counts_by_id(w, ids, k_max + 1)
        want = _old_counts_by_id(w, ids, k_max + 1)
        assert got.dtype == torch.int32
        assert torch.equal(got, want), kind


def test_count_distinct_keys_carry_the_frame():
    """One sort over a stack of frames counts as one sort per frame."""
    rng = np.random.default_rng(4)
    num_ids, f, p = 64, 5, 4000
    bits = bp._hash_bits(num_ids)
    ids = torch.from_numpy(rng.integers(0, num_ids, (f, p)).astype(np.int32))
    ids[3] = 0  # a frame of background only
    hashes = torch.from_numpy(rng.integers(0, 40, (f, p)).astype(np.int32))
    valid = torch.from_numpy(rng.random((f, p)) < 0.8) & (ids > 0)
    got = bp._count_distinct_per_mask(ids, hashes, valid, num_ids, bits)
    for fi in range(f):
        one = bp._count_distinct_per_mask(ids[fi:fi + 1], hashes[fi:fi + 1], valid[fi:fi + 1],
                                          num_ids, bits)
        assert torch.equal(got[fi], one[0]), fi
    # slot 0 holds the one collapsed key of a frame with an invalid entry
    assert got[3, 0] == 1 and int(got[3, 1:].sum()) == 0


def test_batched_geometry_matches_per_frame():
    case = association_scene_case("three_frames_invalid_padded")
    _, depths, _, intr, c2w, _ = _tensors(case)
    w2c = geometry.invert_se3(c2w)
    prm = bp.claim_params(intr, w2c, distance_threshold=0.05, depth_trunc=20.0)
    assert prm.shape == (3, 18)
    world, valid = geometry.unproject_depth(depths, intr, c2w, 20.0)
    for f in range(3):
        one = geometry.invert_se3(c2w[f])
        assert torch.equal(w2c[f], one)
        assert torch.equal(prm[f], bp.claim_params(intr[f], one, distance_threshold=0.05,
                                                   depth_trunc=20.0))
        w1, v1 = geometry.unproject_depth(depths[f], intr[f], c2w[f], 20.0)
        assert torch.equal(world[f].view(torch.int32), w1.view(torch.int32))
        assert torch.equal(valid[f], v1)
    # the padded frame's all-zero pose inverts to a rotation of zeros
    assert not bool(w2c[2, :3, :3].any())


def _jax_scene(case, frame_batch, count_dtype):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from maskclustering_tpu.models import backprojection as jb

    return jb.associate_scene(*(jnp.asarray(case[k]) for k in ARRAYS), frame_batch=frame_batch,
                              count_dtype=count_dtype, **{k: case[k] for k in KW})


@pytest.mark.parametrize("frame_batch,count_dtype", [(1, "bf16"), (2, "int8")])
@pytest.mark.parametrize("name", list(SCENE_CASES))
def test_scene_case_matches_jax(name, frame_batch, count_dtype):
    case = association_scene_case(name)
    want = _jax_scene(case, frame_batch, count_dtype)
    got = bp.associate_scene(*_tensors(case), **{k: case[k] for k in KW})
    for field in want._fields:
        _bits_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                    f"{name} frame_batch={frame_batch} {count_dtype} {field}")


@pytest.mark.parametrize("name", list(SCENE_CASES))
def test_scene_case_frames_match_jax(name):
    """Every frame of the case through ``associate_frame``, the port's and
    the JAX package's, and the stacked path's rows equal to them."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from maskclustering_tpu.models import backprojection as jb

    case = association_scene_case(name)
    pts, depths, segs, intr, c2w, fv = _tensors(case)
    kw = {k: case[k] for k in KW}
    vox = bp._vox_size_jit(pts, distance_threshold=case["distance_threshold"])
    stacked = bp._associate_frames(pts, depths, segs, intr, c2w, fv, vox, **kw)
    for f in range(depths.shape[0]):
        got = bp.associate_frame(pts, depths[f], segs[f], intr[f], c2w[f], fv[f], vox, **kw)
        want = jb.associate_frame(jnp.asarray(case["points"]), case["depths"][f],
                                  case["segs"][f], case["intrinsics"][f],
                                  case["cam_to_world"][f], jnp.asarray(case["frame_valid"][f]),
                                  jnp.float32(vox.numpy()), **kw)
        for field in want._fields:
            _bits_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                        f"{name} frame {f} {field}")
            _bits_equal(getattr(stacked, field)[f].numpy(), getattr(got, field).numpy(),
                        f"{name} frame {f} {field} stacked")
    if name == "three_frames_invalid_padded":
        assert not bool(stacked.n_claimed[2].any()), "the padded pose claimed points"
        assert not bool(stacked.mask_valid[1:].any())
    if name == "all_behind_camera":
        assert bool(stacked.n_claimed[0].any()) and not bool(stacked.n_claimed[1].any())


@pytest.mark.parametrize("scene", ["seed4", "seed21"])
def test_plain_scene_functions_match_per_frame(scene):
    """On the fixture scenes (padded as the pipeline pads them), the plain
    scene claim and assignment give each frame's ``associate_frame``
    fields; ``tests/test_torch_backprojection.py`` holds the same scenes'
    ``associate_scene`` against the jitted JAX one."""
    from maskclustering_tpu_torch.config import PipelineConfig
    from maskclustering_tpu_torch.models.pipeline import pad_scene_tensors
    from maskclustering_tpu_torch.utils.compile_cache import scene_pads
    from maskclustering_tpu_torch.utils.synthetic import make_scene, to_scene_tensors

    t = to_scene_tensors(make_scene(**{
        "seed4": dict(num_boxes=3, num_frames=10, image_hw=(60, 80), seed=4),
        "seed21": dict(num_boxes=4, num_frames=10, seed=21)}[scene]))
    padded = pad_scene_tensors(t, *scene_pads(PipelineConfig(), t.num_frames, t.num_points))
    arrays = [torch.from_numpy(np.asarray(a)) for a in (
        padded.scene_points, padded.depths, padded.segmentations, padded.intrinsics,
        padded.cam_to_world, padded.frame_valid)]
    pts, depths, segs, intr, c2w, fv = arrays
    kw = dict(k_max=31, window=1, distance_threshold=0.03, depth_trunc=20.0,
              few_points_threshold=10, coverage_threshold=0.3)
    vox = bp._vox_size_jit(pts, distance_threshold=0.03)
    prm = bp.claim_params(intr, geometry.invert_se3(c2w), distance_threshold=0.03,
                          depth_trunc=20.0)
    table = bp.pixel_table_reference(depths, segs, prm, k_max=31)
    n_claimed = bp.claim_scene_reference(pts, table, prm, k_max=31, window=1)
    scene = bp.associate_scene(*arrays, **kw)
    mop, first, last = bp.assign_scene_reference(pts, table, prm, scene.mask_valid, k_max=31,
                                                 window=1)
    for f in range(depths.shape[0]):
        fa = bp.associate_frame(pts, depths[f], segs[f], intr[f], c2w[f], fv[f], vox, **kw)
        assert torch.equal(n_claimed[f], fa.n_claimed), f
        assert torch.equal(scene.mask_valid[f], fa.mask_valid), f
        for got, want in ((mop, fa.mask_of_point), (first, fa.first_id), (last, fa.last_id)):
            assert torch.equal(got[f], want), f
    assert torch.equal(scene.mask_of_point, mop) and torch.equal(scene.first_id, first)
    assert torch.equal(scene.last_id, last)


@pytest.mark.parametrize("name", list(SCENE_CASES))
def test_pixel_table_is_the_backprojection(name):
    """Each pixel's entry of the plain table: the depth and id as the claim
    masks them, and ``((u - c) * d) / f`` rounded once an operation, as
    numpy float32 computes it."""
    case = association_scene_case(name)
    _, depths, segs, intr, c2w, _ = _tensors(case)
    prm = bp.claim_params(intr, geometry.invert_se3(c2w),
                          distance_threshold=case["distance_threshold"],
                          depth_trunc=case["depth_trunc"])
    k_max = case["k_max"]
    table = bp.pixel_table_reference(depths, segs, prm, k_max=k_max).numpy()
    dep, seg, p = case["depths"], case["segs"], prm.numpy()
    f, h, w = dep.shape
    assert table.shape == (f, h, w, 4) and table.dtype == np.int32
    for fi in range(f):
        fx, fy, cx, cy, trunc = (p[fi, i] for i in (12, 13, 14, 15, 17))
        d = np.where((dep[fi] > 0) & (dep[fi] <= trunc), dep[fi], np.float32(0))
        u = np.arange(w, dtype=np.float32)[None, :]
        v = np.arange(h, dtype=np.float32)[:, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            want = [(u - cx) * d / fx, (v - cy) * d / fy, d]
        for ch, x in enumerate(want):
            _bits_equal(table[fi, ..., ch], x.astype(np.float32).view(np.int32),
                        f"{name} frame {fi} channel {ch}")
        _bits_equal(table[fi, ..., 3], np.where((seg[fi] < 0) | (seg[fi] > k_max), 0,
                                                seg[fi]).astype(np.int32), f"{name} ids")


WRAPPERS = {"associate_table_cuda": ("depths", "segs", "params", "k_max"),
            "associate_claim_scene_cuda": ("scene_points", "table", "params", "k_max", "window"),
            "associate_assign_scene_cuda": ("scene_points", "table", "params", "mask_valid",
                                            "k_max", "window")}


def _wrapper_args(change):
    case = association_scene_case("three_frames_invalid_padded")
    pts, depths, segs, intr, c2w, _ = _tensors(case)
    prm = bp.claim_params(intr, geometry.invert_se3(c2w), distance_threshold=0.05,
                          depth_trunc=20.0)
    args = dict(scene_points=pts, depths=depths, segs=segs, params=prm,
                table=bp.pixel_table_reference(depths, segs, prm, k_max=63),
                mask_valid=torch.zeros((3, 64), dtype=torch.bool), k_max=63, window=1)
    changed = change(args)
    return {**args, **changed}, set(changed)


@pytest.mark.parametrize("change,match", [
    (lambda a: {}, "needs CUDA tensors"),
    (lambda a: {"params": a["params"][:, :17].contiguous()}, "params must be"),
    (lambda a: {"params": torch.cat([a["params"], a["params"][:1]])}, "params must be"),
    (lambda a: {"segs": a["segs"][:2].contiguous()}, "segs must be"),
    (lambda a: {"depths": a["depths"].double()}, "depths must be"),
    (lambda a: {"table": a["table"][:, :, :, :3].contiguous()}, "table must be"),
    (lambda a: {"table": a["table"].view(torch.float32)}, "table must be"),
    (lambda a: {"window": 4}, "windows 0..3"),
    (lambda a: {"k_max": 1024, "mask_valid": torch.zeros((3, 1025), dtype=torch.bool)},
     "k_max must be in 1..1023"),
], ids=["cpu_tensors", "params_not_18", "params_frames", "segs_frames", "depth_dtype",
        "table_not_4", "table_dtype", "window_4", "k_max_1024"])
def test_scene_wrappers_refuse(change, match):
    """Each wrapper that takes the changed input refuses it (every wrapper
    refuses CPU tensors)."""
    from maskclustering_tpu_torch.ops import cuda as kernels

    args, changed = _wrapper_args(change)
    called = 0
    for name, takes in WRAPPERS.items():
        if changed and not changed & set(takes):
            continue
        kw = {k: args[k] for k in takes}
        with pytest.raises(ValueError, match=match):
            getattr(kernels, name)(**kw)
        called += 1
    assert called


def test_assign_wrapper_refuses_mask_valid_of_other_frames():
    from maskclustering_tpu_torch.ops.cuda import associate_assign_scene_cuda

    args, _ = _wrapper_args(lambda a: {})
    with pytest.raises(ValueError, match="mask_valid must be"):
        associate_assign_scene_cuda(args["scene_points"], args["table"], args["params"],
                                    torch.zeros((2, 64), dtype=torch.bool), k_max=63, window=1)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SCENE_CASES))
def test_scene_kernels_match_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA association kernels need a CUDA card")
    # pytest puts this directory on sys.path (rootdir-less "prepend" import)
    from test_torch_backprojection import check_kernels_match_plain

    case = association_scene_case(name)
    dev = torch.device("cuda", 0)
    pts, depths, segs, intr, c2w, fv = _tensors(case, dev)
    prm = bp.claim_params(intr, geometry.invert_se3(c2w),
                          distance_threshold=case["distance_threshold"],
                          depth_trunc=case["depth_trunc"])
    check_kernels_match_plain(pts, depths, segs, prm, k_max=case["k_max"], window=case["window"])
    # the whole scene on the card equals the plain version on the CPU
    on_card = bp.associate_scene(pts, depths, segs, intr, c2w, fv, **{k: case[k] for k in KW})
    on_cpu = bp.associate_scene(*_tensors(case), **{k: case[k] for k in KW})
    for field in on_cpu._fields:
        assert torch.equal(getattr(on_card, field).cpu(), getattr(on_cpu, field)), field
