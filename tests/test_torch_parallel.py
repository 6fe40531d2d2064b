"""The port's fused multi-device path (``maskclustering_tpu_torch/parallel``)
against the JAX package's, on the CPU.

The port's meshes repeat the ``"cpu"`` device; the JAX side runs on the 8
virtual host devices of ``tests/conftest.py``. The statics are the JAX mesh
tests' (``tests/test_parallel.py``, ``tests/test_point_sharding.py``): 32x48
scenes of 8 frames, ``k_max`` 7, ``distance_threshold`` 0.06. Everything
compared is an integer, a bool or an exact count, so every comparison is
exact:

- the mesh helpers and their errors;
- ``build_fused_step`` field for field against JAX's on six meshes, under
  both ``count_dtype`` values, and with the frame stacks donated;
- ``cluster_scene_batch`` on the JAX test's three scenes (a short batch on
  a scene axis of 2 among them): the port's ``run_scene`` and JAX's
  ``cluster_scene_batch`` give the same objects and digests; a server's
  ``pads`` / ``width`` / ``pad_tensors`` lanes change no real lane;
- point sharding: byte identity with the unsharded step, each shard holding
  its column slice, and the batch path's artifacts;
- the configuration refusals, message for message.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskclustering_tpu import parallel as jax_parallel
from maskclustering_tpu.config import PipelineConfig
from maskclustering_tpu.models.pipeline import run_scene as jax_run_scene
from maskclustering_tpu.obs.digest import artifact_digest as jax_artifact_digest
from maskclustering_tpu.parallel.batch import cluster_scene_batch as jax_cluster_scene_batch
from maskclustering_tpu.utils.synthetic import make_scene, to_scene_tensors
from maskclustering_tpu_torch import parallel
from maskclustering_tpu_torch.config import from_jax_config
from maskclustering_tpu_torch.models import run_scene
from maskclustering_tpu_torch.obs.digest import artifact_digest
from maskclustering_tpu_torch.parallel.batch import (
    batch_shapes,
    cluster_scene_batch,
    make_run_mesh,
)
from maskclustering_tpu_torch.utils.synthetic import make_scene as port_make_scene
from maskclustering_tpu_torch.utils.synthetic import to_scene_tensors as port_to_scene_tensors

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

K_MAX = 7
STEP_CFG = PipelineConfig(config_name="test", dataset="demo", distance_threshold=0.06,
                          few_points_threshold=10, point_chunk=1024, max_cluster_iterations=20)
BATCH_CFG = PipelineConfig(config_name="meshtest", dataset="demo", distance_threshold=0.06,
                           few_points_threshold=10, point_chunk=1024, frame_pad_multiple=8,
                           mask_pad_multiple=8)
MESHES = [(1, 8), (2, 4), (4, 2), (8, 1), (2, 2, 2), None]
DTYPES = ("bf16", "int8")


def _port(cfg, **kw):
    return from_jax_config(dataclasses.asdict(cfg)).replace(**kw)


def _cpu_mesh(shape):
    return parallel.make_mesh(shape, devices=["cpu"] * int(np.prod(shape)))


def _scenes(n: int) -> int:
    """The batch of a mesh: at least 2, and a multiple of its scene axis."""
    return 2 if n is None else max(2, n)


@functools.lru_cache(maxsize=None)
def _jax_step_out(shape, count_dtype):
    mesh = jax_parallel.make_mesh(shape) if shape is not None else None
    args = jax_parallel.fused_step_example_args(
        num_scenes=_scenes(shape and shape[0]), num_frames=8)
    step = jax_parallel.build_fused_step(mesh, STEP_CFG.replace(count_dtype=count_dtype),
                                         k_max=K_MAX)
    out = jax.block_until_ready(step(*map(jnp.asarray, args)))
    return type(out)(*(np.asarray(x) for x in out))


def _port_step_out(shape, count_dtype, donate=False):
    mesh = _cpu_mesh(shape) if shape is not None else None
    args = parallel.fused_step_example_args(num_scenes=_scenes(shape and shape[0]),
                                            num_frames=8)
    step = parallel.build_fused_step(mesh, _port(STEP_CFG, count_dtype=count_dtype),
                                     k_max=K_MAX, donate=donate, device="cpu")
    return step(*args)


def _assert_fields_equal(want, got, label):
    for name in want._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name)
        assert a.dtype == b.dtype and a.shape == b.shape, (label, name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{label}:{name}")


# ---------------------------------------------------------------------------
# the mesh helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8,), (2, 4), (1, 8), (2, 2, 2), (1, 2, 4), None])
def test_mesh_helpers_match_jax(shape):
    want = jax_parallel.make_mesh(shape)
    got = parallel.make_mesh(shape, devices=["cpu"] * 8)
    assert got.axis_names == want.axis_names
    assert got.shape == dict(want.shape)
    assert got.devices.shape == want.devices.shape
    assert all(d == torch.device("cpu") for d in got.devices.flat)
    label = tuple(got.devices.shape)
    assert parallel.mesh_label(label) == jax_parallel.mesh_label(label)
    assert parallel.point_spec(got) == jax_parallel.point_spec(want)
    assert parallel.point_axis_size(got) == jax_parallel.point_axis_size(want)
    assert parallel.point_spec(None) is jax_parallel.point_spec(None) is None
    assert parallel.point_axis_size(None) == jax_parallel.point_axis_size(None) == 1


@pytest.mark.parametrize("shape", [(2, 3), (1, 1, 2, 4)])
def test_mesh_errors_match_jax(shape):
    with pytest.raises(ValueError) as want:
        jax_parallel.make_mesh(shape)
    with pytest.raises(ValueError) as got:
        parallel.make_mesh(shape, devices=["cpu"] * 8)
    assert str(got.value) == str(want.value)


def test_default_mesh_devices_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default devices are usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh((1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.build_fused_step(None, _port(STEP_CFG), k_max=K_MAX)


def test_make_run_mesh_appends_the_point_axis():
    cfg = _port(BATCH_CFG, mesh_shape=(1, 4), point_shards=2)
    mesh = make_run_mesh(cfg, ["cpu"] * 8)
    assert mesh.axis_names == ("scene", "frame", "point")
    assert parallel.mesh_label(mesh.devices.shape) == "1x4x2"
    assert make_run_mesh(cfg.replace(point_shards=1), ["cpu"] * 4).axis_names == (
        "scene", "frame")
    with pytest.raises(ValueError, match="does not cover 4 devices"):
        make_run_mesh(cfg, ["cpu"] * 4)


# ---------------------------------------------------------------------------
# the fused step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("count_dtype", DTYPES)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "none" if s is None else
                         "x".join(map(str, s)))
def test_fused_step_matches_jax(shape, count_dtype):
    want = _jax_step_out(shape, count_dtype)
    got = _port_step_out(shape, count_dtype)
    _assert_fields_equal(want, got.stacked(), f"{shape}:{count_dtype}")
    assert (np.asarray(want.num_objects) >= 3).all()


def test_fused_step_donate_matches():
    args = parallel.fused_step_example_args(num_scenes=2, num_frames=8)
    kept = [a.copy() for a in args]
    base = _port_step_out((2, 4), "bf16").stacked()
    got = _port_step_out((2, 4), "bf16", donate=True).stacked()
    _assert_fields_equal(base, got, "donate")
    # the step reads its operands and never writes them
    donated = parallel.build_fused_step(_cpu_mesh((2, 4)), _port(STEP_CFG), k_max=K_MAX,
                                        donate=True)
    donated(*args)
    for a, b in zip(args, kept):
        np.testing.assert_array_equal(a, b)


def test_fused_step_needs_a_whole_scene_axis():
    args = parallel.fused_step_example_args(num_scenes=3, num_frames=8)
    step = parallel.build_fused_step(_cpu_mesh((2, 4)), _port(STEP_CFG), k_max=K_MAX)
    with pytest.raises(ValueError, match="does not split over a scene axis of 2"):
        step(*args)


@pytest.mark.parametrize("count_dtype", DTYPES)
def test_point_sharded_step_byte_identity_and_residency(count_dtype):
    """A 2-shard point split equals the unsharded step under both encodings,
    and each shard of a lane's claim planes holds only its columns, on its
    column of the mesh."""
    base = _port_step_out((2, 4), count_dtype).stacked()
    mesh = _cpu_mesh((2, 2, 2))
    out = _port_step_out((2, 2, 2), count_dtype)
    _assert_fields_equal(base, out.stacked(), count_dtype)
    n = base.first_id.shape[2]
    for lane in range(2):
        for name in ("first_id", "last_id", "mask_of_point"):
            shards = getattr(out, name)[lane]
            assert len(shards) == 2
            for p, shard in enumerate(shards):
                assert tuple(shard.shape) == (8, n // 2), (name, shard.shape)
                assert shard.device == mesh.devices[lane, 0, p]


# ---------------------------------------------------------------------------
# the batch path
# ---------------------------------------------------------------------------


SEEDS = (0, 1, 2)  # three scenes: a short batch on a scene axis of 2


@pytest.fixture(scope="module")
def batch_refs():
    jax_tensors = [to_scene_tensors(make_scene(num_boxes=3, num_frames=8, image_hw=(32, 48),
                                               spacing=0.08, seed=s)) for s in SEEDS]
    tensors = [port_to_scene_tensors(port_make_scene(num_boxes=3, num_frames=8,
                                                     image_hw=(32, 48), spacing=0.08, seed=s))
               for s in SEEDS]
    cfg = _port(BATCH_CFG)
    return {
        "tensors": tensors,
        "run_scene": [run_scene(t, cfg, k_max=K_MAX, device="cpu").objects for t in tensors],
        "jax_run_scene": [jax_run_scene(t, BATCH_CFG, k_max=K_MAX).objects
                          for t in jax_tensors],
        "jax_batch": jax_cluster_scene_batch(BATCH_CFG, jax_parallel.make_mesh((2, 4)),
                                             jax_tensors, k_max=K_MAX),
    }


def _assert_objects_equal(got, want):
    assert got.num_points == want.num_points
    assert len(got.point_ids_list) == len(want.point_ids_list)
    for a, b in zip(got.point_ids_list, want.point_ids_list):
        np.testing.assert_array_equal(a, b)
    assert got.mask_list == want.mask_list


@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (4, 2), (8, 1), (2, 2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cluster_scene_batch_matches_run_scene_and_jax(batch_refs, shape):
    cfg = _port(BATCH_CFG, mesh_shape=shape[:2], point_shards=shape[2] if len(shape) > 2 else 1)
    objs = cluster_scene_batch(cfg, _cpu_mesh(shape), batch_refs["tensors"], k_max=K_MAX)
    assert len(objs) == 3
    for got, ref, jref, jbatch in zip(objs, batch_refs["run_scene"],
                                      batch_refs["jax_run_scene"], batch_refs["jax_batch"]):
        _assert_objects_equal(got, ref)
        _assert_objects_equal(got, jbatch)
        assert artifact_digest(got) == artifact_digest(ref) == jax_artifact_digest(jref)
        assert len(got.point_ids_list) >= 3


def test_cluster_scene_batch_serving_lanes(batch_refs):
    """A server's shape floor, lane floor and warm pad scene: four lanes
    on a scene axis of 2 for two real scenes, which alone are returned."""
    pad = port_to_scene_tensors(port_make_scene(num_boxes=2, num_frames=6, image_hw=(32, 48),
                                                spacing=0.08, seed=9))
    cfg = _port(BATCH_CFG)
    mesh = _cpu_mesh((2, 4))
    f_pad, n_pad = batch_shapes(batch_refs["tensors"][:2], cfg, mesh)
    objs = cluster_scene_batch(cfg, mesh, batch_refs["tensors"][:2], k_max=K_MAX,
                               pads=(f_pad + 1, n_pad + 1), width=3, pad_tensors=pad)
    assert len(objs) == 2
    for got, ref in zip(objs, batch_refs["run_scene"]):
        _assert_objects_equal(got, ref)
    assert cluster_scene_batch(cfg, mesh, []) == []


def test_point_sharded_batch_matches_run_scene(batch_refs):
    cfg = _port(BATCH_CFG, mesh_shape=(1, 4), point_shards=2)
    mesh = make_run_mesh(cfg, ["cpu"] * 8)
    tensors = batch_refs["tensors"][:2]
    f_pad, n_pad = batch_shapes(tensors, cfg, mesh)
    assert f_pad % 4 == 0 and n_pad % 2 == 0
    for got, ref in zip(cluster_scene_batch(cfg, mesh, tensors, k_max=K_MAX),
                        batch_refs["run_scene"]):
        _assert_objects_equal(got, ref)


# ---------------------------------------------------------------------------
# configuration refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(point_shards=2), dict(mesh_shape=(1, 2, 2)),
                                dict(mesh_shape=(4,)),
                                dict(mesh_shape=(1, 2), streaming_chunk=4)],
                         ids=["point-shards-without-mesh", "mesh-rank-3", "mesh-rank-1",
                              "streaming-with-mesh"])
def test_config_refusals_match_jax(kw):
    with pytest.raises(ValueError) as want:
        PipelineConfig(**kw)
    with pytest.raises(ValueError) as got:
        _port(PipelineConfig()).replace(**kw)
    assert str(got.value) == str(want.value)
    assert _port(PipelineConfig(mesh_shape=(1, 2), point_shards=4)).point_shards == 4
