"""The port's slice end to end against the JAX package, plus its isolation.

``run_scene`` of the port (``device="cpu"``) against the JAX ``run_scene``
with ``use_exact_ball_query=True, device_postprocess=False`` on two fixture
scenes under both ``count_dtype`` values: the artifact digest, the
assignment, the mask table and the exported files must be bit-equal. The
JAX side answers its ball queries with the jnp f32 version (the Pallas
contract) instead of its float64 CPU KD-tree.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import maskclustering_tpu.models.exact_backprojection as jax_exact
from maskclustering_tpu.config import PipelineConfig
from maskclustering_tpu.config import load_config as jax_load_config
from maskclustering_tpu.models.pipeline import run_scene as jax_run_scene
from maskclustering_tpu.obs.digest import artifact_digest as jax_artifact_digest
from maskclustering_tpu.ops.neighbor import ball_query as jax_ball_query
from maskclustering_tpu.utils.synthetic import make_scene, to_scene_tensors
from maskclustering_tpu_torch.config import from_jax_config, load_config
from maskclustering_tpu_torch.models import run_scene
from maskclustering_tpu_torch.obs.digest import artifact_digest
from maskclustering_tpu_torch.utils.synthetic import make_scene as port_make_scene
from maskclustering_tpu_torch.utils.synthetic import to_scene_tensors as port_to_scene_tensors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = {"seed4": dict(num_boxes=3, num_frames=10, image_hw=(60, 80), seed=4),
          "seed21": dict(num_boxes=4, num_frames=10, seed=21)}


def _jnp_group(q, c, ql, cl, k, radius):
    return np.asarray(jax_ball_query(jnp.asarray(q), jnp.asarray(c), jnp.asarray(ql),
                                     jnp.asarray(cl), k=k, radius=radius))


def _cfg(count_dtype="bf16", **kw):
    return PipelineConfig(config_name="slice", dataset="demo", distance_threshold=0.03,
                          few_points_threshold=10, mask_pad_multiple=64,
                          use_exact_ball_query=True, device_postprocess=False,
                          count_dtype=count_dtype, **kw)


@pytest.fixture(scope="module", params=[(s, d) for s in sorted(SCENES) for d in ("bf16", "int8")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def runs(request, tmp_path_factory):
    scene, count_dtype = request.param
    cfg = _cfg(count_dtype)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_exact, "_ball_query_group", _jnp_group)
        root = tmp_path_factory.mktemp(f"jax-{scene}-{count_dtype}")
        out["jax"] = (jax_run_scene(
            to_scene_tensors(make_scene(**SCENES[scene])), cfg, k_max=31, seq_name=scene,
            export=True, object_dict_dir=str(root / "object"),
            prediction_root=str(root / "prediction")), root)
    root = tmp_path_factory.mktemp(f"port-{scene}-{count_dtype}")
    out["port"] = (run_scene(
        port_to_scene_tensors(port_make_scene(**SCENES[scene])),
        from_jax_config(dataclasses.asdict(cfg)), k_max=31, seq_name=scene, export=True,
        object_dict_dir=str(root / "object"), prediction_root=str(root / "prediction"),
        device="cpu"), root)
    out["scene"] = scene
    return out


def test_artifact_digest_and_assignment_match_jax(runs):
    want, got = runs["jax"][0], runs["port"][0]
    assert artifact_digest(got.objects) == jax_artifact_digest(want.objects)
    assert len(got.objects.point_ids_list) >= 3
    assert got.assignment.dtype == np.int32
    np.testing.assert_array_equal(got.assignment, np.asarray(want.assignment))
    for field in want.table._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got.table, field)),
                                      np.asarray(getattr(want.table, field)), err_msg=field)


def test_exported_artifacts_match_jax(runs):
    scene = runs["scene"]
    (_, jroot), (got, proot) = runs["jax"], runs["port"]
    rel = os.path.join("prediction", "slice_class_agnostic", f"{scene}.npz")
    with np.load(jroot / rel) as want_npz, np.load(proot / rel) as got_npz:
        assert sorted(got_npz.files) == sorted(want_npz.files)
        for name in want_npz.files:
            assert got_npz[name].dtype == want_npz[name].dtype, name
            np.testing.assert_array_equal(got_npz[name], want_npz[name], err_msg=name)
    rel = os.path.join("object", "slice", "object_dict.npy")
    want_od = np.load(jroot / rel, allow_pickle=True).item()
    got_od = np.load(proot / rel, allow_pickle=True).item()
    assert sorted(got_od) == sorted(want_od)
    for i, obj in want_od.items():
        np.testing.assert_array_equal(got_od[i]["point_ids"], obj["point_ids"])
        assert got_od[i]["mask_list"] == obj["mask_list"]
        assert got_od[i]["repre_mask_list"] == obj["repre_mask_list"]
    assert got.timings["pulls"] == 7  # mask_valid, schedule, five post-process planes


def test_run_scene_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    tensors = port_to_scene_tensors(port_make_scene(**SCENES["seed4"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_scene(tensors, from_jax_config(dataclasses.asdict(_cfg())), k_max=31)


@pytest.mark.parametrize("override,item", [
    (dict(use_exact_ball_query=False), "A1"),
    (dict(device_postprocess=True), "A2"),
    (dict(mesh_shape=(1, 2)), "A7"),
])
def test_unported_configurations_raise(override, item):
    cfg = from_jax_config(dataclasses.asdict(_cfg())).replace(**override)
    tensors = port_to_scene_tensors(port_make_scene(**SCENES["seed4"]))
    with pytest.raises(NotImplementedError, match=item):
        run_scene(tensors, cfg, k_max=31, device="cpu")


def test_streaming_configuration_raises():
    cfg = from_jax_config(dataclasses.asdict(_cfg())).replace(streaming_chunk=4)
    with pytest.raises(NotImplementedError, match="A6"):
        run_scene(port_to_scene_tensors(port_make_scene(**SCENES["seed4"])), cfg, device="cpu")


@pytest.mark.parametrize("name", sorted(f[:-5] for f in os.listdir(os.path.join(REPO, "configs"))
                                        if f.endswith(".json")))
def test_configs_load_field_for_field(name):
    want = dataclasses.asdict(jax_load_config(name, step=3))
    assert dataclasses.asdict(load_config(name, step=3)) == want
    assert dataclasses.asdict(from_jax_config(want)) == want


def test_from_jax_config_rejects_unknown_keys():
    with pytest.raises(ValueError, match="unknown config keys"):
        from_jax_config({**dataclasses.asdict(_cfg()), "no_such_knob": 1})


def test_port_imports_no_jax_and_no_reference_package():
    """Every module of the port, imported in a fresh interpreter, pulls in
    neither jax nor anything of maskclustering_tpu."""
    code = r"""
import importlib, pkgutil, sys
import maskclustering_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "maskclustering_tpu"
             or m.startswith("maskclustering_tpu."))
assert not bad, bad
assert len(names) >= 15, names
print(len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
