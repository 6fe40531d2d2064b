"""Frames that already are tensors through every entry of the port (C12),
against host numpy frames and the JAX package's ``jnp`` frames, on the CPU.

The device scene generator (``utils/synthetic.make_scene_device``) returns
its depth and id stacks as tensors where they were rendered. The JAX
package takes such frames as they are (``io/feed.py:111-146``,
``models/pipeline.py:133-136``); the port now does too:

- the default configuration (dense association, device post-process):
  tensor frames give the digest of numpy frames and of JAX's ``run_scene``
  on ``jnp`` frames, with no host encode in the feed and no numpy
  conversion of a frame stack anywhere on the path (a tensor subclass whose
  ``__array__`` raises, and ``encode_depth`` / ``encode_seg`` raising);
- the exact configuration pulls the frames once, in the named
  ``exact.frames`` window, and gives the same digests;
- streaming keeps the chunks where they lie and gives the same digests;
- the mesh batch stacks pulled frames (``batch.frames``) and gives the
  artifact digest of the single-device run.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maskclustering_tpu.models.exact_backprojection as jax_exact
from maskclustering_tpu.config import load_config as jax_load_config
from maskclustering_tpu.models.pipeline import run_scene as jax_run_scene
from maskclustering_tpu.models.streaming import stream_scene as jax_stream_scene
from maskclustering_tpu.obs.digest import artifact_digest as jax_artifact_digest
from maskclustering_tpu.ops.neighbor import ball_query as jax_ball_query
from maskclustering_tpu.utils.synthetic import make_scene as jax_make_scene
from maskclustering_tpu.utils.synthetic import to_scene_tensors as jax_to_scene_tensors
from maskclustering_tpu_torch.analysis import transfer_guard
from maskclustering_tpu_torch.config import from_jax_config
from maskclustering_tpu_torch.io import feed
from maskclustering_tpu_torch.models import run_scene
from maskclustering_tpu_torch.models.streaming import stream_scene
from maskclustering_tpu_torch.obs.digest import artifact_digest
from maskclustering_tpu_torch.parallel import cluster_scene_batch, make_mesh
from maskclustering_tpu_torch.utils.compile_cache import max_seg_id
from maskclustering_tpu_torch.utils.synthetic import make_scene, to_scene_tensors

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

SCENE = dict(num_boxes=3, num_frames=12, image_hw=(48, 64), seed=7, spacing=0.05)


class NoArray(torch.Tensor):
    """A frame stack that refuses numpy conversion."""

    def __array__(self, *args, **kwargs):
        raise AssertionError("a frame stack was converted to numpy")


def _jax_cfg(**kw):
    base = dict(config_name="framestest", step=1, distance_threshold=0.05,
                mask_pad_multiple=32, frame_pad_multiple=4, point_chunk=2048)
    return jax_load_config("scannet").replace(**{**base, **kw})


def _cfg(**kw):
    return from_jax_config(dataclasses.asdict(_jax_cfg(**kw)))


def _jnp_group(q, c, ql, cl, k, radius):
    return np.asarray(jax_ball_query(jnp.asarray(q), jnp.asarray(c), jnp.asarray(ql),
                                     jnp.asarray(cl), k=k, radius=radius))


@pytest.fixture(scope="module")
def scenes():
    host = to_scene_tensors(make_scene(**SCENE))
    on_device = dataclasses.replace(
        host, depths=torch.from_numpy(host.depths.copy()).as_subclass(NoArray),
        segmentations=torch.from_numpy(host.segmentations.copy()).as_subclass(NoArray))
    jax_scene = jax_to_scene_tensors(jax_make_scene(**SCENE))
    jax_dev = dataclasses.replace(jax_scene, depths=jnp.asarray(jax_scene.depths),
                                  segmentations=jnp.asarray(jax_scene.segmentations))
    return host, on_device, jax_dev


@pytest.fixture
def no_host_encode(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the feed encoded device-resident frames on the host")

    monkeypatch.setattr(feed, "encode_depth", refuse)
    monkeypatch.setattr(feed, "encode_seg", refuse)


def test_feed_passes_tensor_frames_through(scenes, no_host_encode):
    host, on_device, _ = scenes
    assert feed.device_resident(on_device.depths) and not feed.device_resident(host.depths)
    d, s = feed.to_device_frames(on_device.depths.to(torch.float64),
                                 on_device.segmentations.to(torch.int16), "cpu")
    assert d.dtype == torch.float32 and s.dtype == torch.int32
    assert torch.equal(d, torch.from_numpy(host.depths))
    assert torch.equal(s, torch.from_numpy(host.segmentations))
    assert max_seg_id(on_device.segmentations) == int(host.segmentations.max())


@pytest.mark.parametrize("k_max", [None, 63])
def test_default_configuration_equals_numpy_and_jax(scenes, no_host_encode, k_max):
    host, on_device, jax_dev = scenes
    want = jax_run_scene(jax_dev, _jax_cfg(), k_max=k_max)
    got = run_scene(on_device, _cfg(), k_max=k_max, device="cpu")
    assert got.digest == want.digest and got.digest["artifact"]
    np.testing.assert_array_equal(got.assignment, np.asarray(want.assignment))
    assert len(got.objects.point_ids_list) == 3


def test_default_configuration_numpy_frames_equal_tensor_frames(scenes):
    host, on_device, _ = scenes
    a = run_scene(host, _cfg(), device="cpu")
    b = run_scene(on_device, _cfg(), device="cpu")
    assert a.digest == b.digest and a.timings["pulls"] == b.timings["pulls"]


def test_guarded_default_path_names_the_max_id_read(scenes):
    """Under the host-sync guard the one read of a tensor stack the default
    path makes, the largest id for ``k_max``, is the named ``frames.max_id``
    window; no frame stack is pulled."""
    _, on_device, _ = scenes
    transfer_guard.arm(True)
    try:
        got = run_scene(on_device, _cfg(), device="cpu")
        pulls = transfer_guard.scene_pulls()
    finally:
        transfer_guard.arm(None)
    assert got.digest["artifact"]
    assert pulls.get("frames.max_id") == 1 and "exact.frames" not in pulls, pulls


def test_exact_configuration_equals_numpy_and_jax(scenes, monkeypatch):
    host, on_device, jax_dev = scenes
    kw = dict(use_exact_ball_query=True, device_postprocess=False, distance_threshold=0.03,
              few_points_threshold=10)
    monkeypatch.setattr(jax_exact, "_ball_query_group", _jnp_group)
    want = jax_run_scene(jax_dev, _jax_cfg(**kw), k_max=31)
    got = run_scene(on_device, _cfg(**kw), k_max=31, device="cpu")
    ref = run_scene(host, _cfg(**kw), k_max=31, device="cpu")
    assert got.digest == ref.digest == want.digest and got.digest["artifact"]
    np.testing.assert_array_equal(got.assignment, np.asarray(want.assignment))


def test_streaming_equals_numpy_and_jax(scenes, no_host_encode):
    host, on_device, jax_dev = scenes
    want = jax_stream_scene(jax_dev, _jax_cfg(streaming_chunk=4), seq_name="frames")
    got = stream_scene(on_device, _cfg(streaming_chunk=4), seq_name="frames", device="cpu")
    assert got.timings["stream.num_chunks"] == 3
    assert got.digest == want.digest and got.digest["artifact"]
    np.testing.assert_array_equal(got.assignment, np.asarray(want.assignment))


def test_streaming_numpy_frames_equal_tensor_frames(scenes):
    host, on_device, _ = scenes
    a = stream_scene(host, _cfg(streaming_chunk=4), seq_name="frames", device="cpu")
    b = stream_scene(on_device, _cfg(streaming_chunk=4), seq_name="frames", device="cpu")
    assert a.digest == b.digest


def test_mesh_batch_equals_the_single_device_run_and_jax(scenes):
    host, on_device, jax_dev = scenes
    cfg = _cfg(mesh_shape=(1, 2), point_shards=1)
    mesh = make_mesh((1, 2), devices=["cpu"] * 2)
    got = cluster_scene_batch(cfg, mesh, [on_device])
    ref = cluster_scene_batch(cfg, mesh, [host])
    want = jax_run_scene(jax_dev, _jax_cfg(), k_max=63)
    assert artifact_digest(got[0]) == artifact_digest(ref[0]) \
        == jax_artifact_digest(want.objects)
    assert got[0].point_ids_list
