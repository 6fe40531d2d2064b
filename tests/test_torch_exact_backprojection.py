"""The port's exact-parity association and DBSCAN against the JAX package's.

The JAX exact path answers its ball queries on the CPU with a float64
KD-tree; the port, like the Pallas kernel, tests distances in float32. So
the JAX side here routes ``_ball_query_group`` to the jnp f32 ball query
(``ops/neighbor.ball_query``, the Pallas contract) for the test's
duration. Everything compared is bit-equal.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import maskclustering_tpu.models.exact_backprojection as jax_exact
from maskclustering_tpu.config import PipelineConfig
from maskclustering_tpu.ops.dbscan import dbscan_labels as jax_dbscan_labels
from maskclustering_tpu.ops.neighbor import ball_query as jax_ball_query
from maskclustering_tpu.utils.synthetic import make_scene, to_scene_tensors
from maskclustering_tpu_torch.config import from_jax_config
from maskclustering_tpu_torch.models import exact_backprojection as port_exact
from maskclustering_tpu_torch.ops.dbscan import dbscan_labels
from maskclustering_tpu_torch.utils.synthetic import make_scene as port_make_scene
from maskclustering_tpu_torch.utils.synthetic import to_scene_tensors as port_to_scene_tensors

# one intra-op thread: the suite runs in parallel worker processes, where
# torch's CPU thread pool oversubscribes the cores and each of the many
# small ops waits at a barrier for descheduled threads
torch.set_num_threads(1)


def _jnp_group(q, c, ql, cl, k, radius):
    return np.asarray(jax_ball_query(jnp.asarray(q), jnp.asarray(c), jnp.asarray(ql),
                                     jnp.asarray(cl), k=k, radius=radius))


@pytest.fixture
def jax_f32_ball_query(monkeypatch):
    monkeypatch.setattr(jax_exact, "_ball_query_group", _jnp_group)


def _clouds():
    """Point sets with shared border points, noise and several clusters."""
    rng = np.random.default_rng(7)
    out = []
    # two dense blobs joined only through border points that touch both
    a = rng.normal(scale=0.01, size=(40, 3))
    b = rng.normal(scale=0.01, size=(40, 3)) + [0.1, 0, 0]
    bridge = np.array([[0.05, 0, 0], [0.05, 0.003, 0]])
    out.append((np.concatenate([bridge, a, b]), 0.045, 6))
    # random clouds at several densities, min_points 1..7
    for i in range(12):
        n = int(rng.integers(5, 300))
        pts = rng.uniform(0, 1, (n, 3)) * rng.uniform(0.2, 2.0)
        out.append((pts, float(rng.uniform(0.05, 0.25)), int(rng.integers(1, 8))))
    out.append((np.zeros((0, 3)), 0.1, 4))
    out.append((np.ones((1, 3)), 0.1, 1))
    return out


@pytest.mark.parametrize("idx", range(len(_clouds())))
def test_dbscan_labels_match_jax(idx):
    pts, eps, min_points = _clouds()[idx]
    got = dbscan_labels(pts, eps, min_points)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jax_dbscan_labels(pts, eps, min_points))
    try:
        from sklearn.cluster import DBSCAN
    except ImportError:
        return
    if len(pts):
        np.testing.assert_array_equal(
            got, DBSCAN(eps=eps, min_samples=min_points).fit(pts).labels_)


def test_dbscan_border_point_takes_lowest_cluster():
    pts, eps, min_points = _clouds()[0]
    labels = dbscan_labels(pts, eps, min_points)
    assert labels[2:42].max() == labels[2:42].min()  # blob a: one cluster
    assert set(labels[:2]) <= {labels[2], labels[42], -1}
    assert labels[0] == min(labels[2], labels[42])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_statistical_outlier_and_denoise_match_jax(seed):
    rng = np.random.default_rng(seed)
    main = rng.normal(scale=0.01, size=(120, 3))
    minor = rng.normal(scale=0.01, size=(12, 3)) + 10.0
    outlier = np.array([[5.0, 5.0, 5.0]])
    pts = np.concatenate([main, minor, outlier])
    np.testing.assert_array_equal(port_exact.statistical_outlier_mask(pts),
                                  jax_exact.statistical_outlier_mask(pts))
    np.testing.assert_array_equal(port_exact.denoise_mask_points(pts),
                                  jax_exact.denoise_mask_points(pts))
    np.testing.assert_array_equal(port_exact.denoise_mask_points(pts, eps=0.02, min_points=6),
                                  jax_exact.denoise_mask_points(pts, eps=0.02, min_points=6))


def _plane_scene(n_side=40, z=2.0):
    """tests/test_exact_backprojection.py:83-103: a jittered flat square seen
    head-on by an identity camera, two masks inside it."""
    xs = np.linspace(-0.5, 0.5, n_side)
    gx, gy = np.meshgrid(xs, xs)
    pts = np.stack([gx.ravel(), gy.ravel(), np.full(n_side * n_side, z)], axis=1)
    h = w = 64
    intr = np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]])
    jitter = 0.002 * np.sin(np.arange(h * w)).reshape(h, w).astype(np.float32)
    depth = np.full((h, w), z, dtype=np.float32) + jitter
    seg = np.zeros((h, w), dtype=np.int32)
    seg[18:31, 18:31] = 1
    seg[34:46, 34:46] = 2
    return pts, depth, seg, intr


@pytest.mark.parametrize("variant", ["two_masks", "absent_object", "bad_pose"])
def test_frame_backprojection_matches_jax(variant, jax_f32_ball_query):
    pts, depth, seg, intr = _plane_scene()
    pose = np.eye(4)
    if variant == "absent_object":
        depth = depth.copy()
        depth[34:46, 34:46] = 1.0
    if variant == "bad_pose":
        pose = np.full((4, 4), np.inf)
    kw = dict(distance_threshold=0.05, few_points_threshold=10)
    want = jax_exact.frame_backprojection_exact(pts, depth, seg, intr, pose, **kw)
    got = port_exact.frame_backprojection_exact(pts, depth, seg, intr, pose, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for mask_id in want:
        np.testing.assert_array_equal(got[mask_id], want[mask_id])
    if variant == "two_masks":
        assert set(got) == {1, 2}


def test_associate_scene_matches_jax(jax_f32_ball_query):
    kw = dict(num_boxes=3, num_frames=10, image_hw=(60, 80), seed=4)
    cfg = PipelineConfig(config_name="parity", dataset="demo", distance_threshold=0.03,
                         few_points_threshold=10, use_exact_ball_query=True)
    want = jax_exact.associate_scene_exact(to_scene_tensors(make_scene(**kw)), cfg, k_max=31)
    timings = {}
    got = port_exact.associate_scene_exact(
        port_to_scene_tensors(port_make_scene(**kw)), from_jax_config(dataclasses.asdict(cfg)),
        k_max=31, device="cpu", timings=timings)
    assert timings["ball_query.pulls"] > 0
    for field in want._fields:
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert np.asarray(want.mask_valid).sum() > 0


def test_synthetic_scene_matches_jax_generator():
    kw = dict(num_boxes=3, num_frames=4, image_hw=(48, 64), seed=6, ghost_box=True)
    want, got = make_scene(**kw), port_make_scene(**kw)
    for field in dataclasses.fields(want):
        np.testing.assert_array_equal(np.asarray(getattr(got, field.name)),
                                      np.asarray(getattr(want, field.name)), err_msg=field.name)
