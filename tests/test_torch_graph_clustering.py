"""The port's mask table, graph statistics, schedule and clustering against
the JAX package's, bit for bit, under both ``count_dtype`` encodings.

Both packages get the same association planes (the JAX exact association
of a fixture scene, passed as numpy), so each stage is compared on its own.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import maskclustering_tpu.models.exact_backprojection as jax_exact
from maskclustering_tpu.config import PipelineConfig
from maskclustering_tpu.models import clustering as jax_clustering
from maskclustering_tpu.models import graph as jax_graph
from maskclustering_tpu.ops.neighbor import ball_query as jax_ball_query
from maskclustering_tpu.utils.synthetic import make_scene, to_scene_tensors
from maskclustering_tpu_torch.models import clustering as port_clustering
from maskclustering_tpu_torch.models import graph as port_graph

# one intra-op thread: the suite runs in parallel worker processes, where
# torch's CPU thread pool oversubscribes the cores and each of the many
# small ops waits at a barrier for descheduled threads
torch.set_num_threads(1)

K_MAX = 31
SCENES = {"seed4": dict(num_boxes=3, num_frames=10, image_hw=(60, 80), seed=4),
          "seed21": dict(num_boxes=4, num_frames=10, seed=21)}


def _jnp_group(q, c, ql, cl, k, radius):
    return np.asarray(jax_ball_query(jnp.asarray(q), jnp.asarray(c), jnp.asarray(ql),
                                     jnp.asarray(cl), k=k, radius=radius))


@pytest.fixture(scope="module", params=sorted(SCENES))
def planes(request):
    """Association planes of a fixture scene, as numpy."""
    cfg = PipelineConfig(distance_threshold=0.03, few_points_threshold=10,
                         use_exact_ball_query=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_exact, "_ball_query_group", _jnp_group)
        assoc = jax_exact.associate_scene_exact(
            to_scene_tensors(make_scene(**SCENES[request.param])), cfg, k_max=K_MAX)
    return {f: np.array(getattr(assoc, f)) for f in assoc._fields}


def _stats_kwargs(count_dtype):
    return dict(k_max=K_MAX, point_chunk=2048, mask_visible_threshold=0.3,
                contained_threshold=0.8, undersegment_filter_threshold=0.3,
                big_mask_point_count=500, count_dtype=count_dtype)


def _both_stats(planes, count_dtype):
    table = jax_graph.build_mask_table(planes["mask_valid"], pad_multiple=64)
    want = jax_graph.compute_graph_stats(
        jnp.asarray(planes["mask_of_point"]), jnp.asarray(planes["boundary"]),
        jnp.asarray(table.frame), jnp.asarray(table.mask_id), jnp.asarray(table.valid),
        **_stats_kwargs(count_dtype))
    got = port_graph.compute_graph_stats(
        torch.from_numpy(planes["mask_of_point"]), torch.from_numpy(planes["boundary"]),
        torch.from_numpy(table.frame), torch.from_numpy(table.mask_id),
        torch.from_numpy(table.valid), **_stats_kwargs(count_dtype))
    return table, want, got


def test_build_mask_table_matches_jax(planes):
    for pad in (1, 64, 256):
        want = jax_graph.build_mask_table(planes["mask_valid"], pad_multiple=pad)
        got = port_graph.build_mask_table(planes["mask_valid"], pad_multiple=pad)
        for field in want._fields:
            np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                          np.asarray(getattr(want, field)), err_msg=field)
        assert got.m_pad == want.m_pad


@pytest.mark.parametrize("value,multiple", [(0, 64), (1, 64), (65, 64), (200, 64),
                                            (3000, 256), (12345, 256)])
def test_bucket_size_matches_jax(value, multiple):
    from maskclustering_tpu.utils.compile_cache import bucket_size

    assert port_graph.bucket_size(value, multiple) == bucket_size(value, multiple)


@pytest.mark.parametrize("count_dtype", ["bf16", "int8"])
def test_graph_stats_match_jax(planes, count_dtype):
    _, want, got = _both_stats(planes, count_dtype)
    for field in want._fields:
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert np.asarray(want.visible).any()


def test_frame_segment_stats_ties_go_to_lowest_column():
    c = np.array([[3.0, 5.0, 5.0, 1.0, 1.0, 0.0],
                  [2.0, 2.0, 2.0, 4.0, 0.0, 4.0]], np.float32)
    frame = np.array([0, 0, 0, 1, 1, 1, 3, 3], np.int32)  # frame 2 empty, 3 = padding
    c_pad = np.zeros((2, 8), np.float32)
    c_pad[:, :6] = c
    want = jax_graph.frame_segment_stats(jnp.asarray(c_pad), jnp.asarray(frame), 3, 4)
    got = port_graph.frame_segment_stats(torch.from_numpy(c_pad), torch.from_numpy(frame), 3, 4)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[1].numpy(), [[1, 3, 6], [0, 3, 6]])


def _hists():
    rng = np.random.default_rng(3)
    hists = [np.zeros(11, np.int32), np.array([5, 0, 0], np.int32),
             np.array([0, 1], np.int32), np.array([9, 4, 4, 1], np.int32)]
    for f in (4, 10, 33):
        hists.append(rng.integers(0, 500, f + 1).astype(np.int32))
        hists.append((rng.integers(0, 3, f + 1) * rng.integers(0, 90000, f + 1)).astype(np.int32))
    return hists


# the JAX pipeline runs the schedule jitted (pipeline.py:98), where XLA turns
# the division by 100 into a product with its reciprocal and contracts an FMA;
# op-by-op dispatch of the same function rounds otherwise
_jax_schedule = jax.jit(jax_graph.observer_schedule_device, static_argnames="max_len")


@pytest.mark.parametrize("idx", range(len(_hists())))
def test_observer_schedule_bit_equal(idx):
    hist = _hists()[idx]
    for max_len in (20, 7):
        want = np.asarray(_jax_schedule(jnp.asarray(hist), max_len=max_len))
        got = port_graph.observer_schedule_device(torch.from_numpy(hist), max_len=max_len).numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_observer_schedule_of_fixture_matches_jax(planes):
    _, want, got = _both_stats(planes, "bf16")
    w = np.asarray(_jax_schedule(want.observer_hist, max_len=20))
    g = port_graph.observer_schedule_device(got.observer_hist, max_len=20).numpy()
    np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))
    assert np.isfinite(g[0])


@pytest.mark.parametrize("idx", range(len(_hists())))
def test_host_observer_schedule_matches_jax(idx):
    hist = _hists()[idx]
    for max_len in (20, 7):
        want = jax_graph.observer_schedule(hist, max_len=max_len)
        got = port_graph.observer_schedule(hist, max_len=max_len)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("count_dtype", ["bf16", "int8"])
def test_iterative_clustering_matches_jax(planes, count_dtype):
    table, want_stats, got_stats = _both_stats(planes, count_dtype)
    schedule = np.array(jax_graph.observer_schedule_device(want_stats.observer_hist))
    active = table.valid & ~np.asarray(want_stats.undersegment)
    want = jax_clustering.iterative_clustering(
        want_stats.visible, want_stats.contained, jnp.asarray(active), jnp.asarray(schedule),
        view_consensus_threshold=0.9, count_dtype=count_dtype)
    got = port_clustering.iterative_clustering(
        got_stats.visible, got_stats.contained, torch.from_numpy(active),
        torch.from_numpy(schedule), view_consensus_threshold=0.9, count_dtype=count_dtype)
    for field in want._fields:
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert len(np.unique(np.asarray(want.assignment)[active])) < active.sum()  # merges happen


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_connected_components_matches_jax(seed):
    rng = np.random.default_rng(seed)
    m = 48
    adj = rng.random((m, m)) < rng.uniform(0.01, 0.08)
    adj = adj | adj.T
    np.testing.assert_array_equal(
        port_clustering._connected_components(torch.from_numpy(adj)).numpy(),
        np.asarray(jax_clustering._connected_components(jnp.asarray(adj))))
