"""The port's batch driver against the JAX package's, on scans written to disk.

Three tiny synthetic scans in the ScanNet layout (the JAX
``write_scannet_layout``, so the colour frames are PIL JPEGs) go through the
JAX ``run_pipeline`` and the port's (``device="cpu"``) with the seven
default steps and the default hash encoder: equal statuses, object counts,
digest dicts and coordinates, exported npz arrays, object dicts, features,
class-aware predictions and both AP tables. The port's overlapped executor
equals its sequential loop; the run journal skips finished scenes; a
post-process capacity overflow heals on the ``host-postprocess`` rung, at
the rung the JAX ladder maps to; unported steps raise before any scene
runs, a missing CLIP checkpoint where the JAX driver raises; a missing GT
file is a step error; ``main`` exits 0, 1 and 143 where the JAX ``main``
does. The fused mesh path (a (2, 1) mesh with two point shards over
repeated CPU devices) equals the JAX driver's mesh run and the
single-device run, a stalled mesh batch heals on the ``single-chip`` rung
in both packages, and ``workers=2`` equals the in-process run.
"""

import math
import os
import shutil
import signal

import numpy as np
import pytest
import torch

from maskclustering_tpu.config import load_config as jax_load_config
from maskclustering_tpu.run import evaluate_step as jax_evaluate_step
from maskclustering_tpu.run import main as jax_main
from maskclustering_tpu.run import run_pipeline as jax_run_pipeline
from maskclustering_tpu.utils import faults as jax_faults
from maskclustering_tpu.utils.synthetic import make_scene, write_scannet_layout
from maskclustering_tpu_torch.config import load_config
from maskclustering_tpu.run import DEFAULT_STEPS as JAX_DEFAULT_STEPS
from maskclustering_tpu_torch.run import (
    DEFAULT_STEPS,
    check_masks,
    check_steps,
    get_seq_name_list,
    main,
    run_pipeline,
)
from maskclustering_tpu_torch.utils import faults

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

NAMES = [f"scene{i:04d}_00" for i in range(3)]
STEPS = ("cluster", "eval_ca")
# the synthetic clouds have 5 cm spacing: the scannet radius of 1 cm claims
# nothing, so the drives widen it (as the JAX package's own run tests do)
KW = dict(step=1, distance_threshold=0.05, mask_pad_multiple=32)


def _cfg(root, name, **kw):
    return load_config("scannet", data_root=root, config_name=name, **KW, **kw)


def _write_scenes(root, names=NAMES):
    for i, name in enumerate(names):
        write_scannet_layout(make_scene(num_boxes=3, num_frames=10, image_hw=(60, 80),
                                        seed=60 + i, spacing=0.05), root, name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    _write_scenes(root)
    jax_cfg = jax_load_config("scannet").replace(data_root=root, config_name="jx", **KW)
    # both packages' default steps, with the default encoder (hash, 64 wide)
    out = {"root": root,
           "jx": jax_run_pipeline(jax_cfg, NAMES, resume=False),
           "jx_ap": jax_evaluate_step(jax_cfg, no_class=True, seq_names=NAMES),
           "jx_class_ap": jax_evaluate_step(jax_cfg, no_class=False, seq_names=NAMES)}
    out["ov"] = run_pipeline(_cfg(root, "ov"), NAMES, resume=False, device="cpu")
    out["sq"] = run_pipeline(_cfg(root, "sq", scene_overlap=False), NAMES, steps=STEPS,
                             resume=False, device="cpu")
    return out


def _equal_with_nan(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_with_nan(a[k], b[k]) for k in a)
    return a == b or (math.isnan(a) and math.isnan(b))


def _assert_same_artifacts(root, name_a, name_b, names=NAMES):
    for seq in names:
        with np.load(os.path.join(root, "prediction", f"{name_a}_class_agnostic",
                                  f"{seq}.npz")) as a, \
                np.load(os.path.join(root, "prediction", f"{name_b}_class_agnostic",
                                     f"{seq}.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{seq} {key}")
        od_dir = os.path.join(root, "scannet", "processed", seq, "output", "object")
        od_a = np.load(os.path.join(od_dir, name_a, "object_dict.npy"), allow_pickle=True).item()
        od_b = np.load(os.path.join(od_dir, name_b, "object_dict.npy"), allow_pickle=True).item()
        assert sorted(od_a) == sorted(od_b)
        for k, obj in od_a.items():
            np.testing.assert_array_equal(od_b[k]["point_ids"], obj["point_ids"])
            assert od_b[k]["mask_list"] == obj["mask_list"]
            assert od_b[k]["repre_mask_list"] == obj["repre_mask_list"]


def test_statuses_and_objects_equal_jax(runs):
    jx, ov = runs["jx"], runs["ov"]
    assert jx.ok and ov.ok
    for want, got in zip(jx.scenes, ov.scenes):
        assert (got.seq_name, got.status, got.num_objects, got.attempts, got.degradation_rung,
                got.error_class) == (want.seq_name, want.status, want.num_objects,
                                     want.attempts, want.degradation_rung, want.error_class)
        assert got.digest == want.digest and got.digest["plane"]
        assert got.digest_coord == want.digest_coord == "k63:f32:n16384|bf16|single|r0|c0"
        assert got.num_objects == 3
    assert ov.faults == {"scene_retries": 0, "device_stalls": 0, "journal_skips": 0,
                         "degradations": {}, "final_rung": 0, "interrupted": False}


def test_exported_artifacts_equal_jax(runs):
    _assert_same_artifacts(runs["root"], "jx", "ov")


def test_ap_equal_jax(runs):
    got = runs["ov"].evaluation["eval_ca"]
    assert _equal_with_nan(got, runs["jx_ap"])
    assert not math.isnan(got["all_ap"])
    ev = os.path.join(runs["root"], "evaluation", "scannet")
    assert (open(os.path.join(ev, "ov_class_agnostic.txt")).read()
            == open(os.path.join(ev, "jx_class_agnostic.txt")).read())


def test_default_steps_are_the_jax_defaults(runs):
    assert DEFAULT_STEPS == JAX_DEFAULT_STEPS
    assert runs["ov"].ok and not runs["ov"].step_errors
    assert set(runs["ov"].step_seconds) == set(DEFAULT_STEPS)
    assert runs["ov"].clip_checkpoint is None  # no CLIP weights on this machine


def test_features_equal_jax_bit_for_bit(runs):
    for seq in NAMES:
        od = os.path.join(runs["root"], "scannet", "processed", seq, "output", "object")
        want = np.load(os.path.join(od, "jx", "open-vocabulary_features.npy"),
                       allow_pickle=True).item()
        got = np.load(os.path.join(od, "ov", "open-vocabulary_features.npy"),
                      allow_pickle=True).item()
        assert list(got) == list(want) and want
        for key in want:
            assert got[key].dtype == want[key].dtype == np.float32 and got[key].shape == (64,)
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{seq} {key}")


def test_class_predictions_and_class_ap_equal_jax(runs):
    root = runs["root"]
    for seq in NAMES:
        with np.load(os.path.join(root, "prediction", "jx", f"{seq}.npz")) as a, \
                np.load(os.path.join(root, "prediction", "ov", f"{seq}.npz")) as b:
            assert sorted(a.files) == sorted(b.files) == ["pred_classes", "pred_masks",
                                                          "pred_score"]
            for key in a.files:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(b[key], a[key], err_msg=f"{seq} {key}")
    got = runs["ov"].evaluation["eval"]
    assert got is not None and _equal_with_nan(got, runs["jx_class_ap"])
    ev = os.path.join(root, "evaluation", "scannet")
    assert open(os.path.join(ev, "ov.txt")).read() == open(os.path.join(ev, "jx.txt")).read()


def test_overlapped_equals_sequential(runs):
    ov, sq = runs["ov"], runs["sq"]
    assert [(s.status, s.num_objects, s.digest) for s in ov.scenes] == \
        [(s.status, s.num_objects, s.digest) for s in sq.scenes]
    _assert_same_artifacts(runs["root"], "ov", "sq")
    assert _equal_with_nan(ov.evaluation["eval_ca"], sq.evaluation["eval_ca"])
    for st in ov.scenes:
        assert {"associate", "graph", "cluster", "postprocess", "export"} <= set(st.timings)


def test_journal_resume_skips_done_scenes(runs, tmp_path):
    cfg = _cfg(runs["root"], "jr")
    journal = str(tmp_path / "run_journal.jsonl")
    first = run_pipeline(cfg, NAMES[:2], steps=("cluster",), journal_path=journal,
                         device="cpu")
    assert [(s.status, s.attempts) for s in first.scenes] == [("ok", 1), ("ok", 1)]
    assert faults.resume_done(journal, config="jr") == set(NAMES[:2])
    again = run_pipeline(cfg, NAMES[:2], steps=("cluster",), journal_path=journal,
                         device="cpu")
    # attempts 0: skipped from the journal, before the artifact check
    assert [(s.status, s.attempts) for s in again.scenes] == [("skipped", 0), ("skipped", 0)]
    assert again.faults["journal_skips"] == 2
    rows = faults.read_journal(journal, config="jr")
    assert [r["event"] for r in rows if r["kind"] == "run"] == ["begin", "end"] * 2
    replay = faults.replay_journal(journal, config="jr")
    assert {seq: st["status"] for seq, st in replay.items()} == {s: "skipped" for s in NAMES[:2]}


def test_capacity_overflow_heals_on_host_postprocess_rung(runs, tmp_path):
    """A DBSCAN neighbour table too small for the scene: round 1 fails on the
    overlapped executor's rung, round 2 on the sequential one, round 3 runs
    the host post-process, at the default retry budget of 2."""
    root = runs["root"]
    journal = str(tmp_path / "journal.jsonl")
    cfg = _cfg(root, "ladder", post_neighbor_cap=2, retry_backoff_s=0.0)
    assert cfg.scene_retries == 2
    rep = run_pipeline(cfg, NAMES[:1], steps=("cluster",), resume=False, journal_path=journal,
                       device="cpu")
    (st,) = rep.scenes
    assert (st.status, st.attempts, st.degradation_rung) == ("ok", 3, 2)
    assert rep.faults["degradations"] == {"sequential-executor": 1, "host-postprocess": 1}
    assert rep.faults["final_rung"] == 2 and rep.faults["scene_retries"] == 2
    outcomes = [r for r in faults.read_journal(journal) if r.get("event") == "outcome"]
    assert [(r["status"], r["rung"], r["error_class"]) for r in outcomes] == [
        ("failed", 0, "device"), ("failed", 1, "device"), ("ok", 2, "")]
    assert "PostprocessCapacityError" in outcomes[0]["error"]
    host = run_pipeline(_cfg(root, "host", device_postprocess=False), NAMES[:1],
                        steps=("cluster",), resume=False, device="cpu")
    assert host.scenes[0].digest == st.digest == runs["ov"].scenes[0].digest
    _assert_same_artifacts(root, "ladder", "host", NAMES[:1])
    _assert_same_artifacts(root, "ladder", "jx", NAMES[:1])


def test_ladder_heals_at_the_rung_the_jax_ladder_maps_to(runs):
    """The same overflowing scan through both packages' ladders: the JAX
    ladder heals at attempt 4 on rung 3 (after an inert donation-off rung),
    the port's at attempt 3 on rung 2. Artifacts and the plane and
    artifact digests are equal; the coordinate differs in its rung only."""
    root = runs["root"]
    jax_cfg = jax_load_config("scannet").replace(
        data_root=root, config_name="jladder", post_neighbor_cap=2, retry_backoff_s=0.0, **KW)
    want = jax_run_pipeline(jax_cfg, NAMES[:1], steps=("cluster",), resume=False,
                            journal=False)
    got = run_pipeline(_cfg(root, "pladder", post_neighbor_cap=2, retry_backoff_s=0.0),
                       NAMES[:1], steps=("cluster",), resume=False, journal=False,
                       device="cpu")
    (w,), (g,) = want.scenes, got.scenes
    assert (w.status, w.attempts, w.degradation_rung) == ("ok", 4, 3)
    assert (g.status, g.attempts, g.degradation_rung) == ("ok", 3, 2)
    assert list(want.faults["degradations"]) == [
        "sequential-executor", "donation-off", "host-postprocess"]
    assert list(got.faults["degradations"]) == ["sequential-executor", "host-postprocess"]
    assert g.digest == w.digest and g.digest["plane"]
    assert g.digest_coord == w.digest_coord.replace("|r3|", "|r2|") != w.digest_coord
    _assert_same_artifacts(root, "pladder", "jladder", NAMES[:1])


@pytest.mark.parametrize("steps", [DEFAULT_STEPS, ("label_features",)],
                         ids=["default_steps", "label_features"])
def test_missing_clip_checkpoint_raises_where_jax_does(runs, steps):
    """``hf:`` with no checkpoint: both drivers raise the same class when the
    encoder is built, after ``cluster`` and ``eval_ca`` have run."""
    root, tag = runs["root"], f"noclip{len(steps)}"
    jax_cfg = jax_load_config("scannet").replace(data_root=root, config_name="j" + tag, **KW)
    with pytest.raises(Exception) as want:
        jax_run_pipeline(jax_cfg, NAMES[:1], steps=steps, encoder_spec="hf:/no/such/clip",
                         resume=False, journal=False)
    with pytest.raises(ValueError) as got:
        run_pipeline(_cfg(root, "p" + tag), NAMES[:1], steps=steps,
                     encoder_spec="hf:/no/such/clip", resume=False, journal=False,
                     device="cpu")
    assert isinstance(want.value, type(got.value)), (want.value, got.value)
    clustered = [os.path.exists(os.path.join(root, "prediction", f"{c}_class_agnostic",
                                             f"{NAMES[0]}.npz")) for c in ("j" + tag, "p" + tag)]
    assert clustered == [("cluster" in steps)] * 2


# explicit ids: each case keeps the name it has always had in test histories
@pytest.mark.parametrize("kwargs,match", [
    # the visualisation steps (A14), worker processes and meshes (A7) and
    # streaming (A6) are ported: they pass the checks made before any scene
    pytest.param(dict(steps=("cluster", "vis")), None, id="kwargs2-A14"),
    pytest.param(dict(steps=("top_images",)), None, id="kwargs3-A14"),
    pytest.param(dict(workers=2), None, id="kwargs4-A7"),
    pytest.param(dict(cfg=dict(mesh_shape=(1, 2))), None, id="kwargs5-A7"),
    pytest.param(dict(cfg=dict(streaming_chunk=4)), None, id="kwargs6-A6"),
])
def test_unported_raise_before_any_scene(runs, kwargs, match):
    kwargs = dict(kwargs)
    cfg = _cfg(runs["root"], "refused", **kwargs.pop("cfg", {}))
    kwargs.setdefault("steps", STEPS)
    if match is None:
        assert (cfg.mesh_shape or cfg.streaming_chunk or kwargs.get("workers", 1) > 1
                or {"vis", "top_images"} & set(kwargs["steps"]))
        check_steps(kwargs["steps"])
        return
    with pytest.raises(NotImplementedError, match=match):
        run_pipeline(cfg, NAMES, device="cpu", **kwargs)
    assert not os.path.exists(os.path.join(runs["root"], "prediction", "refused_class_agnostic"))


def test_unknown_step_and_missing_card_raise(runs):
    with pytest.raises(ValueError, match="unknown steps"):
        run_pipeline(_cfg(runs["root"], "x"), NAMES, steps=("clutser",), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_pipeline(_cfg(runs["root"], "x"), NAMES, steps=STEPS)


def test_missing_gt_is_a_recorded_step_error(tmp_path):
    root = str(tmp_path / "data")
    _write_scenes(root, ["scene0009_00"])
    shutil.rmtree(os.path.join(root, "scannet", "gt"))
    rep = run_pipeline(_cfg(root, "nogt"), ["scene0009_00"], steps=STEPS, device="cpu")
    assert [s.status for s in rep.scenes] == ["ok"]
    assert "eval_ca" in rep.step_errors and "missing GT" in rep.step_errors["eval_ca"]
    assert not rep.ok


def test_eval_without_class_predictions_warns(runs):
    """The class-labelled predictions come from the query step, which the
    ``sq`` run did not take: ``eval`` warns and records no AP."""
    rep = run_pipeline(_cfg(runs["root"], "sq"), NAMES, steps=("eval",), device="cpu")
    assert rep.ok and rep.evaluation == {"eval": None}


def test_check_masks_and_seq_name_list(runs, tmp_path):
    cfg = _cfg(runs["root"], "m", cropformer_path="cropformer.pth")
    # the missing scene is reported; a spec that builds no predictor is logged, not raised
    assert check_masks(cfg, NAMES) == []
    assert check_masks(cfg, NAMES[:1] + ["ghost"]) == ["ghost"]
    (tmp_path / "scannet.txt").write_text("a\nb\n\n")
    assert get_seq_name_list("scannet", str(tmp_path)) == ["a", "b"]
    assert get_seq_name_list("scannet", str(tmp_path), "x+y") == ["x", "y"]
    with pytest.raises(FileNotFoundError):
        get_seq_name_list("matterport3d", str(tmp_path))


@pytest.fixture
def restore_sigterm():
    previous = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, previous)
    faults.clear_stop()


def test_main_exit_codes_match_jax(runs, tmp_path, restore_sigterm):
    root = runs["root"]
    common = ["--config", "scannet", "--data_root", root, "--no-resume"]
    report = str(tmp_path / "report.json")
    # the seven default steps on one scene: rc 0, the report and its
    # journal written
    assert main(common + ["--seq_name_list", NAMES[0], "--report", report,
                          "--device", "cpu"]) == 0
    assert os.path.exists(report) and os.path.exists(tmp_path / "run_journal.jsonl")
    assert jax_main(common + ["--seq_name_list", NAMES[0], "--steps", "masks,cluster,eval_ca",
                              "--no-ledger", "--no-obs"]) == 0
    # a scene that does not exist fails its load: rc 1 in both
    ghost = ["--seq_name_list", f"{NAMES[0]}+ghost", "--steps", "cluster",
             "--scene-retries", "0", "--no-journal"]
    assert main(common + ghost + ["--device", "cpu"]) == 1
    assert jax_main(common + ghost + ["--no-ledger", "--no-obs"]) == 1
    # a stop requested (SIGTERM) before the scenes run: they journal as
    # interrupted and the run exits 143 in both
    faults.request_stop("test")
    jax_faults.request_stop("test")
    try:
        one = ["--seq_name_list", NAMES[0], "--steps", "cluster", "--no-journal"]
        assert main(common + one + ["--device", "cpu"]) == 143
        assert jax_main(common + one + ["--no-ledger", "--no-obs"]) == 143
    finally:
        jax_faults.clear_stop()


def test_kernel_loader_and_launch_counts_are_thread_safe(monkeypatch):
    """The overlapped executor calls into ``ops.cuda`` from two threads: a
    library is built and bound once however many threads ask for it, and no
    launch count is lost. More threads than cores, a tiny switch interval."""
    import sys
    import threading
    import time

    from maskclustering_tpu_torch.ops import cuda as kernels

    builds = []

    def slow_build(names):
        builds.extend(names)
        time.sleep(0.05)  # a wide window for a second thread to enter
        return {}

    monkeypatch.setattr(kernels, "build", slow_build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(kernels, "_bind", lambda name, lib: None)
    monkeypatch.setattr(kernels, "_LIBS", {})
    log = kernels.LaunchLog()
    n_threads, n_adds = 4 * (os.cpu_count() or 2), 2000
    libs = []

    def work():
        libs.append(kernels.load("associate"))
        for _ in range(n_adds):
            log.add("associate_claim", (1,))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert builds == ["associate"]
    assert len(libs) == n_threads and all(lib is libs[0] for lib in libs)
    assert log.counts["associate_claim"] == n_threads * n_adds
    assert log.shapes["associate_claim"][(1,)] == n_threads * n_adds


# ---------------------------------------------------------------------------
# the fused mesh path and worker processes (A7)
# ---------------------------------------------------------------------------

# a (scene 2, frame 1, point 2) mesh: a short last batch of one scene and a
# pad lane; frames pad to 8 (the dense slot table holds F_pad * k_max slots)
MESH_KW = dict(mesh_shape=(2, 1), point_shards=2, frame_pad_multiple=8, scene_overlap=False,
               retry_backoff_s=0.01)
MESH_DEVICES = ["cpu"] * 4
# covers a warm batch of two lanes on either package; a stalled batch costs it
MESH_WATCHDOG_S = 20.0
STALL_S = 3600.0  # the abandoned stall outsleeps the suite


def _jax_run_mesh(cfg):
    """The JAX mesh of ``cfg`` over the first scene * frame * point of the
    eight virtual devices (its ``make_run_mesh`` takes them all)."""
    import jax

    from maskclustering_tpu.parallel.mesh import make_mesh as jax_make_mesh

    shape = tuple(cfg.mesh_shape) + ((cfg.point_shards,) if cfg.point_shards > 1 else ())
    return jax_make_mesh(shape, devices=jax.devices()[:int(np.prod(shape))])


@pytest.fixture(scope="module")
def mesh_runs(runs):
    """Both drivers on the mesh, fault-free and under a stall of the last
    batch; the port's worker pool."""
    import maskclustering_tpu.parallel.batch as jax_batch
    from maskclustering_tpu.datasets import get_dataset as jax_get_dataset
    from maskclustering_tpu.models.pipeline import run_scene as jax_run_scene

    root = runs["root"]
    out = {}
    stall = f"stall:{NAMES[2]}.device"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_batch, "make_run_mesh", _jax_run_mesh)
        jcfg = jax_load_config("scannet").replace(data_root=root, config_name="jm", **KW,
                                                  **MESH_KW)
        out["jm"] = jax_run_pipeline(jcfg, NAMES, steps=STEPS, resume=False, journal=False)
        dcfg = jcfg.replace(config_name="jd", watchdog_device_s=MESH_WATCHDOG_S)
        # compile outside the watchdog what the drill runs under it: the
        # first batch on the mesh, and the stalled scene on one device
        scans = [jax_get_dataset("scannet", s, data_root=root).load_scene_tensors(1)
                 for s in NAMES]
        jax_batch.cluster_scene_batch(dcfg, _jax_run_mesh(dcfg), scans[:2])
        jax_run_scene(scans[2], dcfg.replace(mesh_shape=(), point_shards=1))
        jax_faults.set_plan(jax_faults.FaultPlan.from_spec(stall, stall_s=STALL_S))
        try:
            out["jd"] = jax_run_pipeline(dcfg, NAMES, steps=STEPS, resume=False, journal=False)
        finally:
            jax_faults.set_plan(None)
    out["pm"] = run_pipeline(_cfg(root, "pm", **MESH_KW), NAMES, steps=STEPS, resume=False,
                             journal=False, device="cpu", mesh_devices=MESH_DEVICES)
    faults.set_plan(faults.FaultPlan.from_spec(stall, stall_s=STALL_S))
    try:
        out["pd"] = run_pipeline(_cfg(root, "pd", **MESH_KW, watchdog_device_s=MESH_WATCHDOG_S),
                                 NAMES, steps=STEPS, resume=False, device="cpu",
                                 mesh_devices=MESH_DEVICES,
                                 journal_path=os.path.join(root, "pd_journal.jsonl"))
    finally:
        faults.set_plan(None)
    out["pw"] = run_pipeline(_cfg(root, "pw"), NAMES, steps=STEPS, resume=False, device="cpu",
                             workers=2, journal_path=os.path.join(root, "pw_journal.jsonl"))
    return out


def _status_rows(report):
    return [(s.seq_name, s.status, s.num_objects, s.attempts, s.degradation_rung,
             s.error_class, s.digest, s.digest_coord) for s in report.scenes]


def test_mesh_run_equals_the_jax_mesh_run(runs, mesh_runs):
    jm, pm = mesh_runs["jm"], mesh_runs["pm"]
    assert jm.ok and pm.ok
    assert _status_rows(pm) == _status_rows(jm)
    for s in pm.scenes:
        assert s.digest["bucket"] == "fused" and s.digest["artifact"] and not s.digest["plane"]
        assert s.digest_coord == "fused|bf16|2x1|r0|c0"
    # the fused path's artifacts are the single-device path's
    by_seq = {s.seq_name: s.digest["artifact"] for s in runs["sq"].scenes}
    assert {s.seq_name: s.digest["artifact"] for s in pm.scenes} == by_seq
    _assert_same_artifacts(runs["root"], "jm", "pm")
    _assert_same_artifacts(runs["root"], "sq", "pm")
    assert _equal_with_nan(pm.evaluation["eval_ca"], runs["jx_ap"])


def test_mesh_stall_heals_on_the_single_chip_rung(runs, mesh_runs):
    """The stalled batch fails as a DeviceStallError and heals on the
    ``single-chip`` rung, rung 1 of both ladders on a sequential run."""
    jd, pd = mesh_runs["jd"], mesh_runs["pd"]
    assert jd.ok and pd.ok
    by = {s.seq_name: s for s in pd.scenes}
    assert (by[NAMES[2]].attempts, by[NAMES[2]].degradation_rung) == (2, 1)
    assert by[NAMES[2]].digest_coord.endswith("|single|r1|c0")
    assert [by[n].digest_coord for n in NAMES[:2]] == ["fused|bf16|2x1|r0|c0"] * 2
    assert _status_rows(pd) == _status_rows(jd)
    for report in (jd, pd):
        assert report.faults["degradations"] == {"single-chip": 1}
        assert report.faults["device_stalls"] == 1 and report.faults["final_rung"] == 1
    rows = faults.read_journal(os.path.join(runs["root"], "pd_journal.jsonl"), config="pd")
    failed = [r for r in rows if r.get("event") == "outcome" and r.get("status") == "failed"]
    assert [(r["seq"], r["error_class"]) for r in failed] == [(NAMES[2], "device")]
    assert "DeviceStallError" in failed[0]["error"]
    _assert_same_artifacts(runs["root"], "jd", "pd")
    _assert_same_artifacts(runs["root"], "pm", "pd")


def test_worker_processes_equal_the_in_process_run(runs, mesh_runs):
    pw = mesh_runs["pw"]
    assert pw.ok and [s.seq_name for s in pw.scenes] == NAMES
    assert _status_rows(pw) == _status_rows(runs["sq"])
    _assert_same_artifacts(runs["root"], "sq", "pw")
    assert _equal_with_nan(pw.evaluation["eval_ca"], runs["jx_ap"])
    rows = faults.read_journal(os.path.join(runs["root"], "pw_journal.jsonl"), config="pw")
    assert sorted(r["seq"] for r in rows if r.get("event") == "outcome") == NAMES


def test_tasmap_variant_files_equal_to_jax(tmp_path):
    """TASMAP_STEPS (masks, cluster, vis, top_images) on the scene of
    tests/test_run.py's TASMap test, each package into a root of its own:
    the npz, object_dict.npy, instances.ply and every grid and bbox PNG
    equal; rerun with resume, nothing is rewritten."""
    from maskclustering_tpu.run import TASMAP_STEPS as JAX_TASMAP_STEPS
    from maskclustering_tpu_torch.run import TASMAP_STEPS

    assert TASMAP_STEPS == JAX_TASMAP_STEPS
    scene = make_scene(num_boxes=2, num_frames=8, image_hw=(48, 64), seed=11, spacing=0.05)
    roots = {tag: str(tmp_path / tag) for tag in ("j", "p")}
    for root in roots.values():
        write_scannet_layout(scene, root, "scene0003_00")
    kw = dict(config_name="tvar", step=1, distance_threshold=0.03, mask_pad_multiple=64)
    jrep = jax_run_pipeline(jax_load_config("scannet").replace(data_root=roots["j"], **kw),
                            ["scene0003_00"], steps=JAX_TASMAP_STEPS, journal=False,
                            ledger=False)
    prep = run_pipeline(load_config("scannet", data_root=roots["p"], **kw), ["scene0003_00"],
                        steps=TASMAP_STEPS, journal=False, ledger=False, device="cpu")
    assert set(prep.step_seconds) == set(jrep.step_seconds) == set(TASMAP_STEPS)
    assert prep.ok and not prep.step_errors
    vis = os.path.join("vis", "scene0003_00")
    files = {}
    for tag, root in roots.items():
        files[tag] = sorted(os.path.relpath(os.path.join(d, f), root)
                            for d, _, fs in os.walk(os.path.join(root, vis)) for f in fs)
    assert files["p"] == files["j"] and len(files["p"]) >= 4
    assert any("/grid/" in f for f in files["p"]) and any("/bbox/" in f for f in files["p"])
    for rel in files["p"]:
        with open(os.path.join(roots["j"], rel), "rb") as a, \
                open(os.path.join(roots["p"], rel), "rb") as b:
            assert a.read() == b.read(), rel
    with np.load(os.path.join(roots["j"], "prediction", "tvar_class_agnostic",
                              "scene0003_00.npz")) as a, \
            np.load(os.path.join(roots["p"], "prediction", "tvar_class_agnostic",
                                 "scene0003_00.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    od = os.path.join("scannet", "processed", "scene0003_00", "output", "object", "tvar",
                      "object_dict.npy")
    oa = np.load(os.path.join(roots["j"], od), allow_pickle=True).item()
    ob = np.load(os.path.join(roots["p"], od), allow_pickle=True).item()
    assert sorted(oa) == sorted(ob) and all(
        np.array_equal(oa[k]["point_ids"], ob[k]["point_ids"])
        and oa[k]["repre_mask_list"] == ob[k]["repre_mask_list"] for k in oa)
    # resume: both steps skip a scene whose artifacts exist
    grid = os.path.join(roots["p"], vis, "top_images", "grid")
    stamp = {f: os.path.getmtime(os.path.join(grid, f)) for f in os.listdir(grid)}
    again = run_pipeline(load_config("scannet", data_root=roots["p"], **kw), ["scene0003_00"],
                         steps=("vis", "top_images"), journal=False, ledger=False,
                         device="cpu")
    assert again.ok and {f: os.path.getmtime(os.path.join(grid, f)) for f in stamp} == stamp
