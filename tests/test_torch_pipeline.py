"""The port's pipeline end to end against the JAX package, plus its isolation.

``run_scene`` of the port (``device="cpu"``) against the JAX ``run_scene``
on two fixture scenes under both ``count_dtype`` values, in the
exact-parity configuration (``use_exact_ball_query=True,
device_postprocess=False``) and in the default one (dense association,
device post-process), plus each mixed configuration and ``frame_batch=2``:
the artifact digest, the assignment, the mask table and the exported files
must be bit-equal. The committed canary goldens (``canary_goldens.json``)
are reproduced. The JAX exact path answers its ball queries with the jnp
f32 version (the Pallas contract) instead of its float64 CPU KD-tree.
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

# one intra-op thread: the suite runs in parallel worker processes, where
# torch's CPU thread pool oversubscribes the cores and each of the many
# small ops waits at a barrier for descheduled threads
torch.set_num_threads(1)

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
    (dict(mesh_shape=(1, 2)), "A7"),
])
def test_unported_configurations_raise(override, item):
    cfg = from_jax_config(dataclasses.asdict(_cfg())).replace(**override)
    tensors = port_to_scene_tensors(port_make_scene(**SCENES["seed4"]))
    with pytest.raises(NotImplementedError, match=item):
        run_scene(tensors, cfg, k_max=31, device="cpu")


def _compare_with_jax(scene, cfg, k_max=31):
    """Run both packages on one fixture scene under ``cfg`` (a JAX config);
    assert equal digests, assignments and mask tables; return the port's
    result."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_exact, "_ball_query_group", _jnp_group)
        want = jax_run_scene(to_scene_tensors(make_scene(**SCENES[scene])), cfg, k_max=k_max,
                             seq_name=scene)
    got = run_scene(port_to_scene_tensors(port_make_scene(**SCENES[scene])),
                    from_jax_config(dataclasses.asdict(cfg)), k_max=k_max, seq_name=scene,
                    device="cpu")
    assert artifact_digest(got.objects) == jax_artifact_digest(want.objects)
    assert len(got.objects.point_ids_list) >= 3
    np.testing.assert_array_equal(got.assignment, np.asarray(want.assignment))
    for field in want.table._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got.table, field)),
                                      np.asarray(getattr(want.table, field)), err_msg=field)
    return got


@pytest.mark.parametrize("scene,count_dtype", [(s, d) for s in sorted(SCENES)
                                               for d in ("bf16", "int8")])
def test_default_configuration_matches_jax(scene, count_dtype):
    """The default configuration: dense association, device post-process."""
    cfg = _cfg(count_dtype).replace(use_exact_ball_query=False, device_postprocess=True)
    got = _compare_with_jax(scene, cfg)
    # mask_valid, schedule, 15 device post-process pulls, the assignment
    assert got.timings["pulls"] == 18


def test_dense_association_with_host_rung_matches_jax():
    """The configuration the A1 refusal covered: dense association."""
    _compare_with_jax("seed21", _cfg("int8").replace(use_exact_ball_query=False))


def test_exact_association_with_device_rung_matches_jax():
    """The configuration the A2 refusal covered: the device post-process."""
    _compare_with_jax("seed4", _cfg("bf16").replace(device_postprocess=True))


def test_frame_batch_2_matches_jax():
    _compare_with_jax("seed4", _cfg("bf16").replace(
        use_exact_ball_query=False, device_postprocess=True, association_frame_batch=2,
        association_window=2))


def test_scannet_config_runs_with_no_overrides():
    cfg = load_config("scannet")
    assert not cfg.use_exact_ball_query and cfg.device_postprocess
    res = run_scene(port_to_scene_tensors(port_make_scene(**SCENES["seed4"])), cfg,
                    device="cpu")
    assert res.objects.num_points == 59877 and res.assignment.dtype == np.int32


@pytest.mark.parametrize("idx,frames,points,max_id,golden", [
    (0, 10, 16000, 14, "0ae5783a"), (1, 34, 60000, 100, "742bb72e")])
def test_canary_goldens_reproduced(idx, frames, points, max_id, golden):
    """The committed canary scenes (built as ``serve/router.py:158-188``
    does, under ``obs/canary.goldens_config()``) give the goldens'
    artifact digests."""
    import json

    from maskclustering_tpu.obs.canary import goldens_config
    from maskclustering_tpu.serve.router import fit_tensors_to_bucket
    from maskclustering_tpu_torch.datasets.base import SceneTensors

    goldens = json.load(open(os.path.join(REPO, "canary_goldens.json")))["goldens"]
    assert golden in {g["artifact"] for g in goldens.values()}
    t = fit_tensors_to_bucket(
        to_scene_tensors(make_scene(num_boxes=3, num_frames=frames, image_hw=(60, 80),
                                    spacing=0.06, seed=1000 + idx)), frames, points, max_id)
    tensors = SceneTensors(**{f.name: getattr(t, f.name) for f in dataclasses.fields(t)})
    res = run_scene(tensors, from_jax_config(dataclasses.asdict(goldens_config())),
                    device="cpu")
    assert artifact_digest(res.objects) == golden


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
    neither jax nor anything of maskclustering_tpu, nor PIL or cv2 (the
    card's machine has neither; the port decodes PNG itself)."""
    code = r"""
import importlib, pkgutil, sys
import maskclustering_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "maskclustering_tpu", "PIL", "cv2"))
assert not bad, bad
assert len(names) >= 30, names
print(len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
