"""The port's device post-process and grid DBSCAN against the JAX package's.

``build_grid`` and ``grid_dbscan_pairs`` (labels, root counts, overflow
flag) bit for bit against the jitted JAX functions, including pairs that
sit within a few ulps of eps, where the FMAs of the squared distance
decide; the grid DBSCAN against the port's float64 host DBSCAN on data
away from eps, the one comparison where the reference allows f32 and f64
to differ (``grid_dbscan.py:42-45``) and none does here. The device
post-process on the JAX package's device-phase handoff of two fixture
scenes: artifacts equal to the JAX device rung's and to the port's host
rung, byte for byte, under both ``count_dtype`` values; and
``PostprocessCapacityError`` out of ``run_scene`` at tiny capacities.
"""

import dataclasses

import numpy as np
import pytest
import torch

from maskclustering_tpu_torch.models import postprocess_device as ppd
from maskclustering_tpu_torch.models.postprocess import postprocess_scene
from maskclustering_tpu_torch.obs.digest import artifact_digest
from maskclustering_tpu_torch.ops import grid_dbscan as gd
from maskclustering_tpu_torch.ops.dbscan import dbscan_labels

# one intra-op thread: the suite runs in parallel worker processes, where
# torch's CPU thread pool oversubscribes the cores and each of the many
# small ops waits at a barrier for descheduled threads
torch.set_num_threads(1)

SCENES = {"seed4": dict(num_boxes=3, num_frames=10, image_hw=(60, 80), seed=4),
          "seed21": dict(num_boxes=4, num_frames=10, seed=21)}


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    return jax, jnp


def _clusters(seed, n=1500, k=5, scale=0.04):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, (k, 3))
    pts = centers[rng.integers(0, k, n)] + rng.normal(0, scale, (n, 3))
    return pts.astype(np.float32)


def _dumbbells(seed, eps, reps=256):
    """Rep r holds two points, the origin and one at distance eps in a
    random direction: each pair's squared distance lies within a few ulps
    of eps^2, so the rounding of d2 decides whether it is a cluster."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((reps, 3))
    d *= eps / np.linalg.norm(d, axis=1, keepdims=True)
    pts = np.zeros((2 * reps, 3), np.float32)
    pts[1::2] = d
    rows = np.zeros((reps, 2 * reps), bool)
    rows[np.arange(reps), 2 * np.arange(reps)] = True
    rows[np.arange(reps), 2 * np.arange(reps) + 1] = True
    return pts, rows


def _pairs(valid_rows, c_min=8):
    r_pad, n = valid_rows.shape
    rep, pt = np.nonzero(valid_rows)
    c_pad = gd._bucket_pow2(max(len(rep), 1), minimum=c_min)
    pair_rep = np.full(c_pad, r_pad, np.int32)
    pair_pt = np.zeros(c_pad, np.int32)
    pair_valid = np.zeros(c_pad, bool)
    pair_rep[:len(rep)] = rep
    pair_pt[:len(rep)] = pt
    pair_valid[:len(rep)] = True
    return pair_rep, pair_pt, pair_valid


def _dbscan_inputs(kind):
    if kind.startswith("dumbbells"):
        pts, rows = _dumbbells(int(kind[-1]), 0.1)
        return pts, rows, 0.1, 2, 8
    pts = _clusters(int(kind[-1]))
    rng = np.random.default_rng(int(kind[-1]) + 10)
    rows = rng.random((6, len(pts))) < rng.uniform(0.2, 0.9, (6, 1))
    rows[3] = False  # an empty rep
    n_real = len(pts) - 100
    pts[n_real:] = 1.0e4  # sentinel pads, never valid
    rows[:, n_real:] = False
    return pts, rows, 0.1, 4, 16 if kind == "overflow1" else 512


@pytest.mark.parametrize("kind", ["clusters1", "clusters2", "dumbbells1", "dumbbells2",
                                  "overflow1"])
def test_grid_dbscan_pairs_matches_jax(kind):
    jax, jnp = _jax()
    from maskclustering_tpu.ops import grid_dbscan as jgd

    pts, rows, eps, min_points, cap = _dbscan_inputs(kind)
    n_real = int((pts[:, 0] < 1e3).sum())
    grid = gd.build_grid(pts, eps, n_real=n_real)
    jgrid = jgd.build_grid(pts, eps, n_real=n_real)
    for field in grid._fields:
        np.testing.assert_array_equal(np.asarray(getattr(grid, field)),
                                      np.asarray(getattr(jgrid, field)), err_msg=field)
    pair_rep, pair_pt, pair_valid = _pairs(rows)
    kw = dict(r_pad=rows.shape[0], cell_cap=grid.cell_cap, neighbor_cap=cap, eps=eps,
              min_points=min_points)
    want = jgd._pairs_jit()(*(jnp.asarray(a) for a in (pts, grid.order, grid.start,
                                                        grid.length, pair_rep, pair_pt,
                                                        pair_valid)), **kw)
    got = gd.grid_dbscan_pairs(*(torch.from_numpy(np.asarray(a)) for a in (
        pts, grid.order, grid.start, grid.length, pair_rep, pair_pt, pair_valid)), **kw)
    assert bool(got[2]) == bool(want[2]) == (kind == "overflow1")
    for g, w, what in zip(got[:2], want[:2], ("dense_local", "root_count")):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=what)
    assert int(got[1].sum()) > 0


def test_dumbbells_see_the_fma(monkeypatch):
    """The dumbbells sit on eps: rounding the squared distance's products
    on their own changes the labels."""
    pts, rows, eps, min_points, cap = _dbscan_inputs("dumbbells1")
    grid = gd.build_grid(pts, eps)

    def labels():
        return gd.grid_dbscan_reference(pts, rows, grid, neighbor_cap=cap, eps=eps,
                                        min_points=min_points, device="cpu")

    right = labels()
    monkeypatch.setattr(gd, "fma", lambda a, b, c: a * b + c)
    assert not np.array_equal(labels(), right)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_grid_dbscan_matches_host_dbscan(seed):
    """Away from eps the f32 grid kernel and the f64 host DBSCAN agree
    label for label, per rep, with the host's numbering."""
    pts = _clusters(seed, n=1200, k=4, scale=0.03)
    rng = np.random.default_rng(seed)
    rows = rng.random((3, len(pts))) < 0.6
    eps = 0.1
    d = np.sqrt(((pts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1))
    # no pair within f32 reach of eps (d2 in f32 is good to ~1e-8 in d here)
    assert np.abs(d - eps).min() > 5e-8
    labels = gd.grid_dbscan_reference(pts, rows, gd.build_grid(pts, eps), neighbor_cap=1024,
                                      eps=eps, min_points=4, device="cpu")
    for r in range(rows.shape[0]):
        idx = np.nonzero(rows[r])[0]
        np.testing.assert_array_equal(labels[r, idx], dbscan_labels(pts[idx], eps, 4))
        assert (labels[r, ~rows[r]] == -1).all()


def test_grid_dbscan_reference_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    pts = _clusters(1, n=50, k=2, scale=0.03)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gd.grid_dbscan_reference(pts, np.ones((1, len(pts)), bool), gd.build_grid(pts, 0.1),
                                 neighbor_cap=64, eps=0.1, min_points=4)


def test_pack_bits_matches_numpy():
    rng = np.random.default_rng(0)
    x = rng.random((5, 37)) < 0.5
    packed = ppd._pack_bits(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(packed, np.packbits(x, axis=1))
    np.testing.assert_array_equal(ppd._unpack_bits(packed, 37), x)
    assert [c.shape[0] for c in ppd._row_chunks(torch.zeros(10, 3), 10, 4)] == [4, 4, 2]
    assert [c.shape[0] for c in ppd._row_chunks(torch.zeros(10, 3), 9, 0)] == [9]


def _jax_cfg(count_dtype, **kw):
    from maskclustering_tpu.config import PipelineConfig

    return PipelineConfig(config_name="post", dataset="demo", distance_threshold=0.03,
                          few_points_threshold=10, mask_pad_multiple=64,
                          count_dtype=count_dtype, **kw)


@pytest.fixture(scope="module", params=[(s, d) for s in sorted(SCENES) for d in ("bf16", "int8")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def handoff(request):
    """The JAX package's device-phase handoff of a fixture scene (dense
    association, graph, clustering), as numpy, with the JAX device rung's
    objects on it."""
    _jax()
    from maskclustering_tpu.models.pipeline import run_scene_device
    from maskclustering_tpu.models.postprocess_device import run_postprocess as jax_run_post
    from maskclustering_tpu.utils.synthetic import make_scene, to_scene_tensors

    scene, count_dtype = request.param
    cfg = _jax_cfg(count_dtype)
    h = run_scene_device(to_scene_tensors(make_scene(**SCENES[scene])), cfg, k_max=31,
                         seq_name=scene)
    host = {f: np.array(getattr(h, f)) for f in ("assignment", "active", "node_visible",
                                                 "first_id", "last_id")}
    want = jax_run_post(cfg, h.scene_points, h.first_id, h.last_id, h.table.frame,
                        h.table.mask_id, h.active, h.assignment, h.node_visible, h.frame_ids,
                        k_max=h.k_max, n_real=h.n_real)
    return dict(h=h, host=host, want=want, cfg=cfg)


def _port_post(handoff, **over):
    """The port's post-process on the handoff; the default run is kept in
    the handoff, since both tests of a scene compare with it."""
    from maskclustering_tpu_torch.config import from_jax_config

    if not over and "port" in handoff:
        return handoff["port"]
    h, host = handoff["h"], handoff["host"]
    cfg = from_jax_config(dataclasses.asdict(handoff["cfg"])).replace(**over)
    t = {k: torch.from_numpy(v) for k, v in host.items()}
    pulls = [0]
    objects = ppd.run_postprocess(
        cfg, h.scene_points, t["first_id"], t["last_id"], h.table.frame, h.table.mask_id,
        t["active"], t["assignment"], t["node_visible"], h.frame_ids, k_max=h.k_max,
        n_real=h.n_real, pulls=pulls)
    if not over:
        handoff["port"] = (objects, pulls[0])
    return objects, pulls[0]


def test_device_postprocess_matches_jax_and_host_rung(handoff):
    from maskclustering_tpu.obs.digest import artifact_digest as jax_digest

    want = handoff["want"]
    got, pulls = _port_post(handoff)
    host, host_pulls = _port_post(handoff, device_postprocess=False)
    assert len(got.point_ids_list) >= 3
    assert artifact_digest(got) == jax_digest(want) == artifact_digest(host)
    assert got.num_points == want.num_points == host.num_points == handoff["h"].n_real
    for a, b, c in zip(got.point_ids_list, want.point_ids_list, host.point_ids_list):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert got.mask_list == want.mask_list == host.mask_list
    # live count, node sizes (2), group counts (2), 8 drain scalars, one
    # chunk of survivor planes and their intersection counts
    assert host_pulls == 5 and pulls == 15


def test_device_postprocess_pull_chunks_change_nothing(handoff):
    got, _ = _port_post(handoff)
    chunked, pulls = _port_post(handoff, claims_pull_chunk=1)
    assert artifact_digest(got) == artifact_digest(chunked)
    assert pulls >= 14 + 8  # one pull per chunk of one row, 8 rows at least


def test_device_postprocess_of_a_scene_with_no_live_cluster():
    dev = torch.device("cpu")
    f, n, m = 4, 50, 8
    first = torch.zeros((f, n), dtype=torch.int16)
    objects = ppd.postprocess_scene_device(
        np.zeros((n, 3), np.float32), first, first.clone(), np.zeros(m, np.int32),
        np.full(m, -1, np.int32), torch.zeros(m, dtype=torch.bool, device=dev),
        torch.arange(m, dtype=torch.int32), torch.zeros((m, f), dtype=torch.bool),
        list(range(f)), k_max=7)
    assert objects.point_ids_list == [] and objects.num_points == n
    host = postprocess_scene(np.zeros((n, 3), np.float32), first.numpy(), first.numpy(),
                             first.numpy() > 0, np.zeros(m, np.int32), np.full(m, -1, np.int32),
                             np.zeros(m, bool), np.arange(m, dtype=np.int32),
                             np.zeros((m, f), bool), list(range(f)), k_max=7)
    assert host.point_ids_list == []


@pytest.mark.parametrize("over,knob", [(dict(post_group_cap=2), "post_group_cap"),
                                       (dict(post_neighbor_cap=2), "post_neighbor_cap")])
def test_capacity_overflow_raises_out_of_run_scene(over, knob):
    from maskclustering_tpu_torch.config import load_config
    from maskclustering_tpu_torch.models import run_scene
    from maskclustering_tpu_torch.utils.synthetic import make_scene, to_scene_tensors

    cfg = load_config("scannet", distance_threshold=0.03, few_points_threshold=10,
                      mask_pad_multiple=64, **over)
    tensors = to_scene_tensors(make_scene(**SCENES["seed4"]))
    with pytest.raises(ppd.PostprocessCapacityError, match=knob) as err:
        run_scene(tensors, cfg, k_max=31, device="cpu")
    assert err.value.knob == knob and err.value.cap == 2
