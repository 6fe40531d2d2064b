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

The kernel's fast path (``ops/cuda/render.cu``) divides by a reciprocal
taken once a pixel and axis. Its quotient step is emulated here exactly
(float32 values; products in float64, which holds them exactly, and sums
rounded once through a two-sum tail) and held equal to IEEE float32
division across the range the comment in ``render.cu`` states; the whole
kernel (routing, fast loop, exact loop) is emulated and held equal to the
plain renderer on the crafted cases and on random frames.
"""

import importlib
from fractions import Fraction

import numpy as np
import pytest
import torch

from maskclustering_tpu_torch.ops import cuda as kernels
from maskclustering_tpu_torch.ops import geometry
from maskclustering_tpu_torch.ops.render_cases import RENDER_CASES, random_frames
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
    c, s = seg("nan_direction")
    assert (s[0] > 0).any() and (s[1] == 0).all()
    c, s = seg("mixed_routes")
    centre = (c["image_hw"][1] - 1) // 2
    assert (s[0][:, centre] > 0).any() and len(set(np.unique(s[0])) - {0}) == 2
    c, s = seg("behind_and_front")
    for f in range(2):
        assert int(c["perms"][f, 0]) not in s[f] and int(c["perms"][f, 1]) in s[f]


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


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_renderer_equals_jax_on_random_frames(seed):
    """``random_frames``: random rotations and focal lengths, the extremes
    (directions beyond the kernel's range, nearly parallel rays) included."""
    (j_d, j_s), (p_d, p_s) = _render_both(random_frames(16, seed=seed))
    np.testing.assert_array_equal(_bits(p_d), _bits(j_d))
    np.testing.assert_array_equal(p_s, j_s)


# -- the kernel's division form, emulated exactly ------------------------------

F32, F64 = np.float32, np.float64


def _round_sum(s, e):
    """RN to float32 of s + e, the float64 s and the tail e of a two-sum
    (|e| <= half an ulp of s). float32 midpoints are float64 numbers, so s
    rounds right unless it sits on one and the tail breaks the tie."""
    r = s.astype(F32)
    with np.errstate(invalid="ignore"):
        up = s > r.astype(F64)
        nb = np.nextafter(r, np.where(up, F32(np.inf), F32(-np.inf)))
        mid = (r.astype(F64) + nb.astype(F64)) / 2
        away = (s == mid) & (s != r.astype(F64)) & (e != 0) & ((e > 0) == up)
    return np.where(np.isfinite(s) & away, nb, r)


def _fma32(a, b, c):
    """fma(a, b, c) in float32, one rounding (__fmaf_rn)."""
    p = a.astype(F64) * b.astype(F64)  # 24 x 24 bits: exact
    c = c.astype(F64)
    s = p + c
    v = s - p
    e = (p - (s - v)) + (c - v)  # p + c == s + e exactly
    return _round_sum(s, e)


def _mul32(a, b):
    return (a.astype(F64) * b.astype(F64)).astype(F32)  # exact, then one rounding


def _quotient(a, b):
    """The kernel's ``quotient(a, divisor(b))``: yh = RN(1/b) (float64
    1/b cannot land on a float32 midpoint, so one more rounding is RN),
    e = fma(-b, yh, 1), yl = RN(e yh), q0 = fma(a, yh, RN(a yl)),
    q = fma(fma(-b, q0, a), yh, q0)."""
    a, b = np.asarray(a, F32), np.asarray(b, F32)
    yh = (1.0 / b.astype(F64)).astype(F32)
    yl = _mul32(_fma32(-b, yh, np.ones_like(b)), yh)
    q0 = _fma32(a, yh, _mul32(a, yl))
    return _fma32(_fma32(-b, q0, a), yh, q0)


# render.cu's range for the fast path
MAX_DIVISOR, MIN_NUMERATOR, MAX_NUMERATOR = 2.0 ** 40, 2.0 ** -32, 2.0 ** 32


def _numerator_in_range(a):
    m = np.abs(np.asarray(a, F32))
    with np.errstate(invalid="ignore"):
        return (m == 0) | ((m >= MIN_NUMERATOR) & (m <= MAX_NUMERATOR))


def _divisor_in_range(b):
    with np.errstate(invalid="ignore"):
        return np.abs(np.asarray(b, F32)) <= MAX_DIVISOR  # NaN: False


def _assert_ieee(a, b):
    """The form's quotient equals float32 division, bit for bit; a zero may
    carry the other sign (render.cu: no zero's sign reaches an output)."""
    a, b = np.asarray(a, F32), np.asarray(b, F32)
    assert _numerator_in_range(a).all() and _divisor_in_range(b).all()
    assert (np.abs(b) >= 2.0 ** -40).all()  # the proof's floor; safe_d's 1e-12 is above it
    got, want = _quotient(a, b), a / b
    bad = (got.view(np.int32) != want.view(np.int32)) & ~((got == 0) & (want == 0))
    assert not bad.any(), (a[bad][:5], b[bad][:5], got[bad][:5], want[bad][:5])


def _random_floats(rng, n, lo_exp, hi_exp):
    """Floats of uniform random mantissa and sign, exponents lo..hi-1."""
    bits = (rng.integers(0, 2 ** 23, n) | ((rng.integers(lo_exp, hi_exp, n) + 127) << 23))
    v = bits.astype(np.int32).view(F32)
    return np.where(rng.random(n) < 0.5, -v, v).astype(F32)


def test_fma_emulation_rounds_once():
    """``_fma32`` against exact rational arithmetic, on random triples and on
    sums that sit exactly on a float32 midpoint, with and without a tail far
    below float64's precision to break the tie."""
    rng = np.random.default_rng(21)
    a, b = _random_floats(rng, 2000, -10, 10), _random_floats(rng, 2000, -10, 10)
    c = _random_floats(rng, 2000, -40, 12)
    mid = F32(1 + 2.0 ** -23)  # (1 + 2^-23) * 1.5 is a midpoint of [1.5, 2)
    a = np.concatenate([a, [mid] * 5]).astype(F32)
    b = np.concatenate([b, [1.5] * 5]).astype(F32)
    c = np.concatenate([c, [0.0, 2.0 ** -80, -(2.0 ** -80), 2.0 ** -60, -(2.0 ** -60)]]).astype(F32)
    got = _fma32(a, b, c)
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        near = F32(float(exact))
        cands = [np.nextafter(near, F32(-np.inf)), near, np.nextafter(near, F32(np.inf))]
        err = [abs(Fraction(float(v)) - exact) for v in cands]
        best = [v for v, e in zip(cands, err) if e == min(err)]
        if len(best) > 1:
            best = [v for v in best if v.view(np.int32) % 2 == 0]
        assert best[0].view(np.int32) == g.view(np.int32), (x, y, z, g, best[0])
    # the tie goes to the even neighbour above; a tail below it takes it down
    assert got[-4] == got[-5] > got[-3]


@pytest.mark.parametrize("draw", ["whole_range", "realistic", "one_binade", "near_midpoints"])
def test_division_form_equals_ieee_division(draw):
    """200,000 pairs a draw: numerators and divisors of any exponent in
    range, scene-like ones (corners minus eye in metres, ray components),
    one binade (where the reciprocal's error is largest), and quotients
    within float32 rounding of a midpoint between two floats."""
    rng = np.random.default_rng(["whole_range", "realistic", "one_binade",
                                 "near_midpoints"].index(draw))
    n = 200_000
    if draw == "whole_range":
        a, b = _random_floats(rng, n, -32, 32), _random_floats(rng, n, -40, 40)
    elif draw == "realistic":
        a = rng.uniform(-20, 20, n).astype(F32)
        b = rng.uniform(-3, 3, n).astype(F32)
        b = np.where(np.abs(b) < 1e-12, F32(1e-12), b)
    elif draw == "one_binade":
        a, b = _random_floats(rng, n, 0, 1), _random_floats(rng, n, 0, 1)
    else:
        b = _random_floats(rng, n, -20, 20)
        q = _random_floats(rng, n, -10, 10)
        m = q.astype(F64) + np.spacing(q).astype(F64) / 2  # a midpoint above q
        a = (b.astype(F64) * m).astype(F32)  # a / b within float32 rounding of m
        keep = _numerator_in_range(a) & np.isfinite(a)
        a, b = a[keep], b[keep]
    _assert_ieee(a, b)


def test_division_form_crafted_pairs():
    """Zero numerators of both signs, divisors at +-1e-12 (safe_d's floor)
    and at the range's edges, numerators at the range's edges, powers of
    two, and the largest and smallest mantissas."""
    edges = np.array([1e-12, -1e-12, 2.0 ** 40, -(2.0 ** 40), 1.0, -1.0, 1.5, 3.0,
                      F32(2 - 2.0 ** -23), F32(1 + 2.0 ** -23), 0.1, -7.0], F32)
    nums = np.array([0.0, -0.0, MIN_NUMERATOR, -MIN_NUMERATOR, MAX_NUMERATOR, -MAX_NUMERATOR,
                     1.0, F32(2 - 2.0 ** -23), F32(1 + 2.0 ** -23), 0.3, -12.5, 1e-9, 4e9],
                    F32)
    a, b = np.meshgrid(nums, edges)
    _assert_ieee(a.ravel(), b.ravel())
    assert (_quotient(np.zeros(len(edges), F32), edges) == 0).all()


def test_pairs_out_of_range_take_the_exact_path():
    """What the fast path hands to __fdiv_rn: a numerator below 2^-32 or
    above 2^32 (or not a number) sends its frame to the exact path, a
    divisor above 2^40 in magnitude (or inf or NaN) its pixel. Out there the
    form can be wrong: a last bit off for a numerator near float32's
    smallest normal, NaN for an overflowing quotient."""
    inside = np.array([0.0, -0.0, 2.0 ** -32, 2.0 ** 32, 1.0], F32)
    outside = np.array([2.0 ** -33, -(2.0 ** 33), 1e-40, np.inf, -np.inf, np.nan], F32)
    assert _numerator_in_range(inside).all() and not _numerator_in_range(outside).any()
    assert _divisor_in_range(np.array([1e-12, 2.0 ** 40, -(2.0 ** 40)], F32)).all()
    assert not _divisor_in_range(np.array([2.0 ** 41, -np.inf, np.nan], F32)).any()
    a = np.array([3.3020853e-38, -5.6877032e+29], F32)
    b = np.array([-0.42383745, 7.1433859e-11], F32)
    with np.errstate(all="ignore"):
        assert (_quotient(a, b).view(np.int32) != (a / b).view(np.int32)).all()


def _directions(case, f):
    """The pixel rays of frame ``f`` as the plain renderer forms them."""
    h, w = case["image_hw"]
    k = torch.from_numpy(np.asarray(case["intrinsics"][f], F32))
    c2w = torch.from_numpy(np.asarray(case["poses"][f], F32))
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.int32),
                          torch.arange(w, dtype=torch.int32), indexing="ij")
    u, v = u.reshape(-1).float(), v.reshape(-1).float()
    dx, dy = (u - k[0, 2]) / k[0, 0], (v - k[1, 2]) / k[1, 1]
    return torch.stack([geometry.fma(dy, c2w[i, 1], dx * c2w[i, 0]) + c2w[i, 2]
                        for i in range(3)], dim=-1).numpy()


def _warp_keep(d, lo, hi, fast, w):
    """The kernel's warp cull (``slab_warp``): (eligible warps, keep (W, K)).
    A warp is 32 consecutive pixels (blocks of 256 start at multiples of
    32); it is eligible when all its pixels take the fast path, it lies on
    one row and each axis's end rays are both >= 1e-12 or both <= -1e-12.
    A box is kept when the end rays' far-plane upper bound is > 0 and not
    below their near-plane lower bound."""
    n = len(d)
    n_w = -(-n // 32)
    pad = n_w * 32 - n
    fast_w = np.concatenate([fast, np.zeros(pad, bool)]).reshape(n_w, 32).all(axis=1)
    first = np.arange(n_w) * 32
    last = np.minimum(first + 31, n - 1)
    one_row = (last % w == first % w + 31) & (last // w == first // w)
    e0, e1 = d[first], d[last]
    with np.errstate(invalid="ignore"):
        clear = (((e0 >= 1e-12) & (e1 >= 1e-12)) | ((e0 <= -1e-12) & (e1 <= -1e-12))).all(axis=1)
    ok = fast_w & one_row & clear
    keep = np.ones((n_w, len(lo)), bool)
    if ok.any():
        a0, a1 = e0[ok], e1[ok]
        pos = a0 > 0
        fr = np.where(pos[:, None, :], hi[None], lo[None])  # (W, K, 3)
        nr = np.where(pos[:, None, :], lo[None], hi[None])
        q0 = [_quotient(x, np.broadcast_to(a0[:, None, :], x.shape)) for x in (fr, nr)]
        q1 = [_quotient(x, np.broadcast_to(a1[:, None, :], x.shape)) for x in (fr, nr)]
        far_hi = np.maximum(q0[0], q1[0]).min(axis=2)
        near_lo = np.minimum(q0[1], q1[1]).max(axis=2)
        keep[ok] = (far_hi > 0) & (far_hi >= near_lo)
    return ok, keep


def _emulated_kernel(case):
    """``render.cu``'s kernel in numpy, step for step: corners minus eye,
    ordered per axis; the frame's numerators and each pixel's divisors
    tested against the range; the warp cull; fast pixels through the
    division form, far planes first, plain minima and maxima; the others
    through IEEE division and NaN-propagating minima and maxima; then the
    floor. Returns (depths, segs, the fast pixels of the last frame, the
    boxes the cull skipped in all)."""
    boxes = np.asarray(case["boxes"], F32)
    h, w = case["image_hw"]
    depths, segs, culled = [], [], 0
    for f in range(len(case["poses"])):
        eye = np.asarray(case["poses"][f][:3, 3], F32)
        r0, r1 = boxes[:, 0] - eye, boxes[:, 1] - eye
        with np.errstate(invalid="ignore"):
            keep = r0 < r1
        lo, hi = np.where(keep, r0, r1), np.where(keep, r1, r0)
        d = _directions(case, f)
        with np.errstate(invalid="ignore"):
            sd = np.where(np.abs(d) < 1e-12, F32(1e-12), d).astype(F32)
        fast = (_numerator_in_range(r0).all() and _numerator_in_range(r1).all()) \
            & _divisor_in_range(sd).all(axis=1)
        eligible, kept = _warp_keep(d, lo, hi, fast, w)
        culled += int((~kept[eligible]).sum())
        tested = kept[np.arange(h * w) // 32]  # (P, K): boxes each pixel tests
        best = np.full(h * w, np.inf, F32)
        hit = np.zeros(h * w, np.int32)
        sf, se = sd[fast], sd[~fast]
        pos = sf > 0
        for b in range(len(boxes)):
            with np.errstate(all="ignore"):
                tmax = _quotient(np.where(pos, hi[b], lo[b]), sf).min(axis=1)
                tmin = _quotient(np.where(pos, lo[b], hi[b]), sf).max(axis=1)
                t = np.where(tmin > 0, tmin, tmax)
                win = (tmax > 0) & (tmax >= tmin) & (t < best[fast]) & tested[fast, b]
                t1, t2 = lo[b] / se, hi[b] / se
                emin = np.minimum(t1, t2).max(axis=1)  # np.minimum/max propagate NaN
                emax = np.maximum(t1, t2).min(axis=1)
                te = np.where(emin > 0, emin, emax)
                win_e = (emax >= emin) & (emax > 0) & (te > 0) & (te < best[~fast])
            for sel, won, tt in ((fast, win, t), (~fast, win_e, te)):
                idx = np.flatnonzero(sel)[won]
                best[idx], hit[idx] = tt[won], b + 1
        with np.errstate(all="ignore"):
            t_floor = -eye[2] / sd[:, 2]
            floor = (t_floor > 0) & (t_floor < best)
        best, hit = np.where(floor, t_floor, best), np.where(floor, 0, hit)
        lut = np.concatenate([[0], np.asarray(case["perms"][f], np.int32)])
        depths.append(np.where(np.isfinite(best), best, F32(0)).reshape(h, w))
        segs.append(lut[hit].reshape(h, w))
    return np.stack(depths).astype(F32), np.stack(segs), fast, culled


@pytest.mark.parametrize("name", sorted(RENDER_CASES) + ["random_0", "random_1"])
def test_emulated_kernel_equals_plain(name):
    case = RENDER_CASES.get(name) or random_frames(16, seed=int(name[-1]))
    d_e, s_e, _, _ = _emulated_kernel(case)
    d_p, s_p = ps.render_depth_seg_device(case["boxes"], case["poses"], case["intrinsics"],
                                          case["perms"], case["image_hw"], device="cpu")
    np.testing.assert_array_equal(_bits(d_e), _bits(d_p.numpy()))
    np.testing.assert_array_equal(s_e, s_p.numpy())


def test_mixed_routes_case_reaches_both_paths():
    """Its first frame sends the centre columns to the fast path and the
    outer ones (x beyond 2^40) to the exact path in the same warps."""
    c = RENDER_CASES["mixed_routes"]
    one = {k: (v[:1] if k in ("poses", "intrinsics", "perms") else v) for k, v in c.items()}
    fast = _emulated_kernel(one)[2].reshape(c["image_hw"])
    assert fast[:, (c["image_hw"][1] - 1) // 2].all() and not fast.all()


def _generator_case(num_boxes=12, num_frames=4, image_hw=(32, 64), seed=0):
    """The renderer's inputs as ``make_scene_device`` draws them (boxes:
    the first draws of its seed; frame f's id of box k: the mask whose
    object is k + 1), as chip_smoke.py's phase 25 rebuilds them."""
    t, _, object_of_mask = ps.make_scene_device(num_boxes=num_boxes, num_frames=num_frames,
                                                image_hw=image_hw, seed=seed, device="cpu")
    boxes = np.array([[lo, hi] for lo, hi in ps._place_boxes(
        num_boxes, 4.0, np.random.default_rng(seed))[0]])
    return {"boxes": boxes, "poses": t.cam_to_world, "intrinsics": t.intrinsics,
            "perms": np.argsort(object_of_mask[:, 1:], axis=1) + 1, "image_hw": image_hw,
            "frames": (t.depths.numpy(), t.segmentations.numpy())}


def test_the_warp_cull_skips_most_boxes_on_generator_frames():
    """On the scene generator's frames (rows of whole warps) the cull skips
    most (warp, box) pairs, and the emulated kernel still gives the frames
    ``make_scene_device`` rendered."""
    case = _generator_case()
    d_e, s_e, _, culled = _emulated_kernel(case)
    assert culled > 0.5 * 4 * (32 * 64 // 32) * 12
    np.testing.assert_array_equal(_bits(d_e), _bits(case["frames"][0]))
    np.testing.assert_array_equal(s_e, case["frames"][1])


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


@pytest.mark.gpu
def test_kernel_equals_plain_on_random_frames_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = random_frames(32, image_hw=(120, 160), seed=7)
    args = (c["boxes"], c["poses"], c["intrinsics"], c["perms"], c["image_hw"])
    d_k, s_k = ps.render_depth_seg_device(*args, device=torch.device("cuda", 0))
    d_p, s_p = ps.render_depth_seg_device(*args, device="cpu")
    assert torch.equal(d_k.cpu().view(torch.int32), d_p.view(torch.int32))
    assert torch.equal(s_k.cpu(), s_p)


@pytest.mark.gpu
def test_quotient_entry_equals_division_on_the_card():
    """``render.cu``'s division form (``render_quotients_cuda``) against
    torch's float32 division on the card, over its whole range."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(3)
    a, b = _random_floats(rng, 1 << 20, -32, 32), _random_floats(rng, 1 << 20, -40, 40)
    a[:64] = 0.0
    dev = torch.device("cuda", 0)
    num, sd = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    got, want = kernels.render_quotients_cuda(num, sd), num / sd
    same = (got.view(torch.int32) == want.view(torch.int32)) | ((got == 0) & (want == 0))
    assert bool(same.all())
