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
    assert got.digest == want.digest and got.digest["plane"]
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
    # mask_valid, schedule, five post-process planes, the digest vector
    assert got.timings["pulls"] == 8


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
    """Meshes (A7) are ported (``parallel/``): ``run_scene`` ignores
    ``mesh_shape``, as the JAX ``run_scene`` does, and clusters the scene on
    its one device."""
    cfg = from_jax_config(dataclasses.asdict(_cfg()))
    tensors = port_to_scene_tensors(port_make_scene(**SCENES["seed4"]))
    got = run_scene(tensors, cfg.replace(**override), k_max=31, device="cpu")
    want = run_scene(tensors, cfg, k_max=31, device="cpu")
    assert got.digest == want.digest and got.digest["artifact"]


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
    assert got.digest == want.digest
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
    # mask_valid, schedule, 15 device post-process pulls, the assignment,
    # the digest vector
    assert got.timings["pulls"] == 19


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
    does, under ``obs/canary.goldens_config()``) give the goldens' digest
    dicts in full: plane, artifact, bucket, count_dtype, nan_inf and v, at
    the coordinate each golden is stored under."""
    from maskclustering_tpu_torch.obs.digest import digest_coord

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
    coord = digest_coord(res.digest)
    want = {k: v for k, v in goldens[coord].items() if k != "scene"}
    assert res.digest == want
    assert want["artifact"] == golden and want["plane"] in ("57810067", "c4c735f3")


def test_streaming_configuration_raises():
    """Streaming is ported (``models/streaming.py``): the pipeline accepts a
    streaming configuration, and the combinations the JAX config refuses
    raise its ValueError, message for message, in both packages."""
    dense = _cfg().replace(use_exact_ball_query=False, device_postprocess=True)
    assert from_jax_config(dataclasses.asdict(dense)).replace(streaming_chunk=4).streaming_chunk
    for bad in (dict(mesh_shape=(1, 2)), dict(use_exact_ball_query=True)):
        with pytest.raises(ValueError) as want:
            dense.replace(streaming_chunk=4, **bad)
        with pytest.raises(ValueError) as got:
            from_jax_config(dataclasses.asdict(dense)).replace(streaming_chunk=4, **bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", sorted(f[:-5] for f in os.listdir(os.path.join(REPO, "configs"))
                                        if f.endswith(".json")))
def test_configs_load_field_for_field(name):
    want = dataclasses.asdict(jax_load_config(name, step=3))
    assert dataclasses.asdict(load_config(name, step=3)) == want
    assert dataclasses.asdict(from_jax_config(want)) == want


def test_from_jax_config_rejects_unknown_keys():
    with pytest.raises(ValueError, match="unknown config keys"):
        from_jax_config({**dataclasses.asdict(_cfg()), "no_such_knob": 1})


def _write_port_clip_dir(d):
    """A tiny CLIP checkpoint in the HF layout written with the port alone:
    config.json, pytorch_model.bin of the port's towers (seeded), a tiny
    vocabulary and a 32-pixel preprocessor."""
    import json

    from maskclustering_tpu_torch.semantics.clip import CLIP
    from maskclustering_tpu_torch.semantics.clip_config import CLIPSpec

    vocab = ["a", "b", "a</w>", "b</w>", "ab</w>", "<|startoftext|>", "<|endoftext|>"]
    config = {"projection_dim": 8,
              "text_config": {"vocab_size": len(vocab), "hidden_size": 16,
                              "intermediate_size": 32, "num_hidden_layers": 1,
                              "num_attention_heads": 2},
              "vision_config": {"hidden_size": 16, "intermediate_size": 32,
                                "num_hidden_layers": 1, "num_attention_heads": 2,
                                "image_size": 32, "patch_size": 8}}
    (d / "config.json").write_text(json.dumps(config))
    torch.manual_seed(0)
    model = CLIP(CLIPSpec.from_hf_dict(config))
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.1)
    torch.save(model.state_dict(), str(d / "pytorch_model.bin"))
    (d / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(vocab)}))
    (d / "merges.txt").write_text("#version: 0.2\na b</w>\n")
    (d / "preprocessor_config.json").write_text(json.dumps(
        {"size": {"shortest_edge": 32}, "crop_size": {"height": 32, "width": 32}}))


def test_port_imports_no_jax_and_no_reference_package(tmp_path):
    """Every module of the port (the serving daemon, its subprocess
    worker, supervisor and pool, the obs core, the visualisation, the
    static checks and the JPEG codec's arithmetic, lossless and smoothing
    modules included), imported in a fresh interpreter, pulls in
    neither jax nor anything of maskclustering_tpu, nor PIL, cv2, pyviz3d, or the
    libraries of HF's CLIP path (transformers, tokenizers, safetensors,
    msgpack, regex, flax, ftfy); nor does building the CLIP encoder on a
    checkpoint and encoding an image and a text, streaming a scene in chunks,
    or clustering a batch on a mesh of repeated CPU devices (the card's
    machine has none of them: the port decodes PNG and JPEG and reads CLIP
    itself)."""
    _write_port_clip_dir(tmp_path)
    code = r"""
import importlib, pkgutil, sys
import numpy as np
import maskclustering_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for name in ("semantics", "semantics.crops", "semantics.encoder", "semantics.features",
             "semantics.query", "semantics.clip", "semantics.clip_config",
             "semantics.checkpoint", "semantics.tokenizer", "semantics.image_processor",
             "io.jpeg", "io.jpeg_arith", "io.jpeg_lossless", "io.jpeg_smooth", "obs.digest", "models.streaming", "utils.faults", "parallel",
             "parallel.mesh", "parallel.sharded", "parallel.batch", "obs", "obs.events",
             "obs.metrics", "obs.flight", "obs.tracer", "obs.telemetry", "obs.slo",
             "obs.report", "obs.ledger", "obs.trace", "obs.top", "obs.canary", "serve",
             "serve.__main__", "serve.protocol", "serve.admission", "serve.router",
             "serve.wal", "serve.client", "serve.worker", "serve.daemon",
             "serve.supervisor", "serve.pool", "serve.worker_main", "preprocess",
             "preprocess.scannet", "preprocess.matterport", "preprocess.scannetpp",
             "preprocess.tasmap", "mask_prediction", "utils.clean_output", "visualize",
             "visualize.scene", "visualize.mask2d", "visualize.top_images",
             "visualize.debug_viewers", "ops.splat_cases", "analysis", "analysis.__main__",
             "analysis.findings", "analysis.ast_checks", "analysis.concurrency",
             "analysis.lock_sanitizer"):
    assert pkg.__name__ + "." + name in names, name
from maskclustering_tpu_torch.config import load_config
from maskclustering_tpu_torch.models.streaming import stream_scene
from maskclustering_tpu_torch.utils.synthetic import make_scene, to_scene_tensors
scan = to_scene_tensors(make_scene(num_boxes=2, num_frames=6, image_hw=(40, 56), seed=3,
                                   spacing=0.05))
res = stream_scene(scan, load_config("scannet", step=1, distance_threshold=0.05,
                                     mask_pad_multiple=32, frame_pad_multiple=4,
                                     point_chunk=2048, streaming_chunk=2),
                   seq_name="iso", device="cpu")
assert res.timings["stream.num_chunks"] == 3 and res.digest["artifact"], res.timings
from maskclustering_tpu_torch.parallel import cluster_scene_batch, make_mesh
objs = cluster_scene_batch(load_config("scannet", step=1, distance_threshold=0.05,
                                       frame_pad_multiple=4, point_chunk=2048,
                                       mesh_shape=(1, 2), point_shards=2),
                           make_mesh((1, 2, 2), devices=["cpu"] * 4), [scan])
assert len(objs) == 1 and objs[0].point_ids_list, objs
from maskclustering_tpu_torch.semantics import HFCLIPEncoder
enc = HFCLIPEncoder(sys.argv[1], device="cpu")
img = enc.encode_images([np.full((20, 30, 3), 7, np.uint8)])
txt = enc.encode_texts(["ab"])
assert img.shape == txt.shape == (1, 8) and enc.layout == "torch", (img.shape, txt.shape)
banned = ("jax", "maskclustering_tpu", "PIL", "cv2", "pyviz3d", "transformers", "tokenizers",
          "safetensors", "msgpack", "regex", "flax", "ftfy")
bad = sorted(m for m in sys.modules if m.split(".")[0] in banned)
assert not bad, bad
assert len(names) >= 40, names
print(len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
