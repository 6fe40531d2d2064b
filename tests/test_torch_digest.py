"""The port's digest lanes (``obs/digest.py``) against the JAX package's.

The device vectors against the jitted ``_digest_scene_impl`` and
``_digest_stream_impl`` on seeded planes (the int16 extremes and -1, sizes
whose position weights wrap 2**32 many times, padded assignments with -1
and out-of-range entries); every host helper against its JAX original; and
the full scene digest dict of ``run_scene`` against the JAX ``run_scene`` on
both fixture scenes, both ``count_dtype`` values and both post-process
rungs. The canary goldens are held in ``test_torch_pipeline.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskclustering_tpu.config import PipelineConfig
from maskclustering_tpu.models.pipeline import run_scene as jax_run_scene
from maskclustering_tpu.obs import digest as jd
from maskclustering_tpu.utils.synthetic import make_scene, to_scene_tensors
from maskclustering_tpu_torch.config import from_jax_config
from maskclustering_tpu_torch.models import run_scene
from maskclustering_tpu_torch.obs import digest as pd

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

SCENES = {"seed4": dict(num_boxes=3, num_frames=10, image_hw=(60, 80), seed=4),
          "seed21": dict(num_boxes=4, num_frames=10, seed=21)}


def _planes(f, n, m, seed):
    rng = np.random.default_rng(seed)
    first = rng.integers(-32768, 32768, (f, n)).astype(np.int16)
    first[rng.random((f, n)) < 0.6] = 0
    last = first.copy()
    last.ravel()[:4] = [-1, -32768, 32767, 1]
    assignment = rng.integers(-1, m + 3, m).astype(np.int32)  # -1 pads, ids past m clip
    active = rng.random(m) < 0.7
    node_visible = rng.random((m, f)) < 0.4
    return first, last, assignment, active, node_visible


def _vector(x):
    return np.asarray(x).astype(np.uint32)


@pytest.mark.parametrize("f,n,m,seed", [(4, 33, 16, 0), (32, 16384, 64, 1), (64, 70000, 256, 2),
                                        (1, 4, 1, 3)])
def test_scene_vector_equals_jax(f, n, m, seed):
    planes = _planes(f, n, m, seed)
    want = _vector(jd._digest_scene_impl(*(jnp.asarray(p) for p in planes)))
    got = pd.digest_scene(*(torch.from_numpy(p) for p in planes))
    assert got.dtype == torch.int64 and got.shape == (8,)
    np.testing.assert_array_equal(pd.vector_host(got), want)
    # one flipped sample moves the vector
    first = planes[0].copy()
    first.ravel()[-1] ^= 0x10
    moved = pd.digest_scene(torch.from_numpy(first), *(torch.from_numpy(p) for p in planes[1:]))
    assert not np.array_equal(pd.vector_host(moved), want)


@pytest.mark.parametrize("m,n,seed", [(16, 33, 0), (256, 70000, 1), (1, 1, 2)])
def test_stream_vector_equals_jax(m, n, seed):
    rng = np.random.default_rng(seed)
    assignment = rng.integers(-1, m, m).astype(np.int32)
    assignment[0] = np.iinfo(np.int32).max  # + 1 wraps in int32 for the JAX program
    active = rng.random(m) < 0.5
    active[0] = True
    rep_plane = rng.integers(-5, m + 1, n).astype(np.int32)
    want = _vector(jd._digest_stream_impl(jnp.asarray(assignment), jnp.asarray(active),
                                          jnp.asarray(rep_plane)))
    got = pd.digest_stream(torch.from_numpy(assignment), torch.from_numpy(active),
                           torch.from_numpy(rep_plane))
    np.testing.assert_array_equal(pd.vector_host(got), want)


def test_host_helpers_equal_jax():
    from maskclustering_tpu_torch.models.graph import build_mask_table
    from maskclustering_tpu_torch.models.postprocess import SceneObjects

    rng = np.random.default_rng(5)
    table = build_mask_table(rng.random((6, 32)) < 0.3, pad_multiple=16)
    vec = rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32)
    assignment = rng.integers(-1, 20, table.m_pad).astype(np.int32)
    pts = rng.standard_normal((50, 3)).astype(np.float32)
    pts[3, 1], pts[7, 0] = np.nan, np.inf
    objects = SceneObjects(point_ids_list=[np.array([1, 5, 9]), np.array([2])],
                           mask_list=[[(0, 3, 0.5), ("7", 1, 1.0)], [(2, 2, 0.25)]],
                           num_points=50)
    assert pd.table_hash(table) == jd.table_hash(table)
    assert pd.nan_inf_count(pts) == jd.nan_inf_count(pts) == 2
    assert pd.artifact_digest(objects) == jd.artifact_digest(objects)
    assert pd.plane_digest(vec, table, assignment, 2) == jd.plane_digest(vec, table, assignment, 2)
    assert pd.bucket_label(63, 32, 16384) == jd.bucket_label(63, 32, 16384) == "k63:f32:n16384"
    assert pd.chunk_digest_hex(vec[:4]) == jd.chunk_digest_hex(vec[:4])
    assert pd.DIGEST_VERSION == jd.DIGEST_VERSION
    kw = dict(bucket="k63:f32:n16384", count_dtype="int8")
    only = pd.artifact_only_digest(objects, **kw)
    assert only == jd.artifact_only_digest(objects, **kw) and only["plane"] == ""
    for args in ((only,), (only, "mesh2x2", 2, 3), (None,), ({},)):
        kws = dict(zip(("mesh", "rung", "chunk"), args[1:]))
        assert pd.digest_coord(args[0], **kws) == jd.digest_coord(args[0], **kws)
    other = {**only, "plane": "00000000", "v": 2}
    for a, b in ((only, only), (only, other), (None, only), (only, {})):
        assert pd.digests_match(a, b) == jd.digests_match(a, b)
        assert pd.diff_digests(a, b) == jd.diff_digests(a, b)


def _cfg(count_dtype, device_postprocess):
    return PipelineConfig(config_name="digest", dataset="demo", distance_threshold=0.03,
                          few_points_threshold=10, mask_pad_multiple=64,
                          count_dtype=count_dtype, device_postprocess=device_postprocess)


@pytest.mark.parametrize("scene,count_dtype", [(s, d) for s in sorted(SCENES)
                                               for d in ("bf16", "int8")])
def test_scene_digest_dict_equals_jax_on_both_rungs(scene, count_dtype):
    """The dense association through both post-process rungs of the port
    gives the JAX device rung's digest dict, field for field."""
    want = jax_run_scene(to_scene_tensors(make_scene(**SCENES[scene])),
                         _cfg(count_dtype, True), k_max=31).digest
    assert want["plane"] and want["count_dtype"] == count_dtype
    for device_postprocess in (True, False):
        cfg = from_jax_config(dataclasses.asdict(_cfg(count_dtype, device_postprocess)))
        got = run_scene(to_scene_tensors(make_scene(**SCENES[scene])), cfg, k_max=31,
                        device="cpu").digest
        assert got == want, device_postprocess
