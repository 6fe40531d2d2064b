"""The port's crash-contained worker (``maskclustering_tpu_torch/serve/
supervisor.py`` + ``serve/worker_main.py``) against the JAX package's.

Stub tier (``tests/worker_stub.py``, the pipe protocol in milliseconds,
no JAX and no torch in the child): each case of
``tests/test_serve_supervisor.py`` runs the same scripted stub through the
JAX ``WorkerSupervisor`` and the port's, and the two runs give the same
request events (ids, pids and times masked), ``stats()["counts"]``, worker
panel and journal outcome rows; the port's run also keeps the JAX case's
own assertions. Heartbeat-silence SIGKILL, crash -> typed ``worker_crash``
-> requeue -> respawned-worker ok, the poison-pill bound, idle death, a
drain with a request in flight and the canary round over the pipe.

Real tier, on the CPU: a real ``maskclustering_tpu_torch.serve.worker_main``
child is SIGKILLed by ``crash:<scene>.device:1``; the respawned child
answers ok, its npz and object dict byte-equal to the port's one-shot
``run_pipeline`` and to the JAX package's, and its ``cuda`` key shows no
build. A child's stray ``print``, warning and raw fd-1 write never reach
the wire; constructing a supervisor or pool for ``device="cuda"`` creates
no CUDA context; the wire's config transport round-trips every field.
"""

import dataclasses
import json
import os
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from maskclustering_tpu import run as jax_run
from maskclustering_tpu.config import config_from_json as jax_config_from_json
from maskclustering_tpu.config import load_config as jax_load_config
from maskclustering_tpu.serve import protocol as jax_protocol
from maskclustering_tpu.serve import supervisor as jax_supervisor
from maskclustering_tpu.serve.admission import AdmissionQueue as JaxAdmissionQueue
from maskclustering_tpu.serve.pool import WorkerPool as JaxWorkerPool
from maskclustering_tpu.serve.router import Router as JaxRouter
from maskclustering_tpu.utils import faults as jax_faults
from maskclustering_tpu.utils.synthetic import make_scene, write_scannet_layout
from maskclustering_tpu_torch import run as pt_run
from maskclustering_tpu_torch.config import PipelineConfig, config_from_json, load_config
from maskclustering_tpu_torch.serve import protocol
from maskclustering_tpu_torch.serve import supervisor
from maskclustering_tpu_torch.serve.admission import AdmissionQueue
from maskclustering_tpu_torch.serve.pool import WorkerPool
from maskclustering_tpu_torch.serve.router import Router
from maskclustering_tpu_torch.utils import faults

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = os.path.join(REPO_ROOT, "tests", "worker_stub.py")

PKGS = {
    "jax": SimpleNamespace(
        name="jax", load_config=lambda: jax_load_config("scannet"),
        protocol=jax_protocol, AdmissionQueue=JaxAdmissionQueue, Router=JaxRouter,
        WorkerSupervisor=jax_supervisor.WorkerSupervisor, WorkerPool=JaxWorkerPool,
        MAX_REQUEST_CRASHES=jax_supervisor.MAX_REQUEST_CRASHES, faults=jax_faults,
        device={}),
    "torch": SimpleNamespace(
        name="torch", load_config=lambda: load_config("scannet"),
        protocol=protocol, AdmissionQueue=AdmissionQueue, Router=Router,
        WorkerSupervisor=supervisor.WorkerSupervisor, WorkerPool=WorkerPool,
        MAX_REQUEST_CRASHES=supervisor.MAX_REQUEST_CRASHES, faults=faults,
        device={"device": "cpu"}),
}

# per-run values: ids, pids, wall times; the port-only ``cuda`` key
MASKED = frozenset({"id", "pid", "child_pid", "seconds", "scene_seconds", "ts",
                    "end_ts", "hb_age_s", "warmup_s", "uptime_s", "cuda"})


def mask(doc):
    """``doc`` with its per-run values dropped, recursively."""
    if isinstance(doc, dict):
        return {k: mask(v) for k, v in doc.items() if k not in MASKED}
    if isinstance(doc, list):
        return [mask(v) for v in doc]
    return doc


def cfg_for(pkg, tmp, **kw):
    base = dict(data_root=str(tmp), config_name="sup", step=1,
                distance_threshold=0.05, mask_pad_multiple=32,
                worker_heartbeat_s=1.0, retry_backoff_s=0.05)
    base.update(kw)
    return pkg.load_config().replace(**base)


class Client:
    """Collects one request's events; done on the terminal one."""

    def __init__(self):
        self.events = []
        self.done = threading.Event()

    def send(self, ev):
        self.events.append(ev)
        if ev.get("kind") in ("result", "reject"):
            self.done.set()

    @property
    def terminal(self):
        return self.events[-1] if self.events else None

    def states(self):
        return [e.get("state") for e in self.events if e.get("kind") == "status"]


def submit(pkg, queue, scene, rid, *, op="scene", **kw):
    client = Client()
    req = pkg.protocol.build_request({"op": op, "scene": scene, **kw}, rid)
    req.send = client.send
    queue.submit(req)
    return client


def outcome_rows(pkg, journal_dir, rid):
    """A request journal's outcome rows, as (scene, status, attempt, class)."""
    rows = pkg.faults.read_journal(os.path.join(journal_dir, f"{rid}.jsonl"), request=rid)
    return [(r.get("seq"), r.get("status"), r.get("attempt"), r.get("error_class"))
            for r in rows if r.get("event") == "outcome"]


def stub_supervisor(pkg, tmp, monkeypatch, **cfg_kw):
    """A started supervisor over the stub; its markers under ``tmp``."""
    monkeypatch.setenv("STUB_DIR", str(tmp))
    cfg = cfg_for(pkg, tmp, **cfg_kw)
    queue = pkg.AdmissionQueue(8)
    sup = pkg.WorkerSupervisor(cfg, queue, pkg.Router(cfg),
                               journal_dir=str(tmp / "journals"),
                               child_argv=[sys.executable, STUB],
                               start_timeout_s=15.0, poll_s=0.05, **pkg.device)
    sup.start()
    return sup, queue


def twin(tmp_path, monkeypatch, scenario):
    """Run ``scenario(pkg, tmp)`` for the JAX package, then the port; the
    two records must be equal. Returns the port's record."""
    records = {}
    for name in ("jax", "torch"):
        tmp = tmp_path / name
        tmp.mkdir()
        with monkeypatch.context() as mp:
            records[name] = scenario(PKGS[name], tmp, mp)
    assert records["torch"] == records["jax"]
    return records["torch"]


def _serves_and_drains(pkg, tmp, mp):
    sup, queue = stub_supervisor(pkg, tmp, mp)
    try:
        c = submit(pkg, queue, "stub-ok", "r-000001")
        assert c.done.wait(10.0) and c.terminal["status"] == "ok"
        assert sup.wait_idle(5.0)
        counts = sup.stats()["counts"]
        assert counts["ok"] == 1 and sup.last_ready.get("kind") == "ready"
        # drain with a slow request in flight: it still answers
        slow = submit(pkg, queue, "stub-slow", "r-000002")
        time.sleep(0.3)
        assert sup.stop(timeout_s=15.0)
        assert slow.done.wait(5.0) and slow.terminal["status"] == "ok"
    finally:
        sup.stop(timeout_s=10.0)
    return {"ok": mask(c.events), "slow": mask(slow.events), "counts": counts,
            "final": sup.stats()["counts"], "bye": mask(sup.last_bye)}


def test_stub_serves_and_drains_in_flight(tmp_path, monkeypatch):
    twin(tmp_path, monkeypatch, _serves_and_drains)


def _canary(pkg, tmp, mp):
    sup, queue = stub_supervisor(pkg, tmp, mp)
    try:
        probes = sup.run_canary(timeout_s=10.0)
        assert probes and probes[0]["digest"]["plane"] == "aaaaaaaa"
        c = submit(pkg, queue, "stub-ok", "r-000007")
        probes2 = sup.run_canary(timeout_s=10.0)
        assert c.done.wait(10.0) and c.terminal["status"] == "ok"
    finally:
        sup.stop(timeout_s=10.0)
    return {"probes": probes, "probes2": probes2, "events": mask(c.events)}


def test_stub_canary_round_over_pipe(tmp_path, monkeypatch):
    twin(tmp_path, monkeypatch, _canary)


def _crash(pkg, tmp, mp):
    sup, queue = stub_supervisor(pkg, tmp, mp)
    try:
        crash = submit(pkg, queue, "stub-crash", "r-000001")
        neighbor = submit(pkg, queue, "stub-ok", "r-000002")
        assert crash.done.wait(30.0) and neighbor.done.wait(30.0)
        assert "worker_crash" in crash.states()
        ev = next(e for e in crash.events if e.get("state") == "worker_crash")
        assert ev["requeued"] is True and ev["crashes"] == 1
        assert crash.terminal["status"] == "ok"
        assert crash.terminal["crashes_seen"] == 1
        assert sup.crashes == 1 and sup.respawns == 1
        assert sup.wait_idle(5.0)
        stats = sup.stats()
        replay = pkg.faults.replay_journal(
            os.path.join(sup.journal_dir, "r-000001.jsonl"), request="r-000001")
        assert replay["stub-crash"]["status"] == "interrupted"
        assert replay["stub-crash"]["error_class"] == "device"
    finally:
        sup.stop(timeout_s=10.0)
    return {"crash": mask(crash.events), "neighbor": mask(neighbor.events),
            "counts": stats["counts"], "worker": mask(stats["worker"]),
            "journal": outcome_rows(pkg, sup.journal_dir, "r-000001")}


def test_stub_crash_respawns_requeues_and_pre_degrades(tmp_path, monkeypatch):
    twin(tmp_path, monkeypatch, _crash)


def _wedge(pkg, tmp, mp):
    sup, queue = stub_supervisor(pkg, tmp, mp)
    try:
        t0 = time.monotonic()
        c = submit(pkg, queue, "stub-wedge", "r-000001")
        assert c.done.wait(30.0)
        assert "worker_crash" in c.states() and c.terminal["status"] == "ok"
        # detection is the heartbeat budget's business (1 s), not a timeout
        assert time.monotonic() - t0 < 20.0
        assert sup.crashes == 1
        assert sup.wait_idle(5.0)
        counts = sup.stats()["counts"]
    finally:
        sup.stop(timeout_s=10.0)
    return {"events": mask(c.events), "counts": counts,
            "journal": outcome_rows(pkg, sup.journal_dir, "r-000001")}


def test_stub_wedge_heartbeat_sigkill_heals(tmp_path, monkeypatch):
    twin(tmp_path, monkeypatch, _wedge)


def _poison(pkg, tmp, mp):
    sup, queue = stub_supervisor(pkg, tmp, mp)
    try:
        c = submit(pkg, queue, "stub-crash-always", "r-000001")
        assert c.done.wait(60.0)
        assert c.terminal["kind"] == "result" and c.terminal["status"] == "failed"
        assert c.terminal["error_class"] == "device"
        assert c.terminal["worker_crashes"] == pkg.MAX_REQUEST_CRASHES
        assert "worker crashed" in c.terminal["error"]
        assert sup.crashes == pkg.MAX_REQUEST_CRASHES
        ok = submit(pkg, queue, "stub-ok", "r-000002")
        assert ok.done.wait(20.0) and ok.terminal["status"] == "ok"
        assert sup.wait_idle(5.0)
        counts = sup.stats()["counts"]
    finally:
        sup.stop(timeout_s=10.0)
    return {"poison": mask(c.events), "ok": mask(ok.events), "counts": counts,
            "max": pkg.MAX_REQUEST_CRASHES,
            "journal": outcome_rows(pkg, sup.journal_dir, "r-000001")}


def test_stub_poison_pill_fails_typed_after_bounded_crashes(tmp_path, monkeypatch):
    twin(tmp_path, monkeypatch, _poison)


def _idle_death(pkg, tmp, mp):
    mp.setenv("STUB_START_BEHAVIOR", "dead")
    sup, queue = stub_supervisor(pkg, tmp, mp)
    try:
        c = submit(pkg, queue, "stub-ok", "r-000001")
        assert c.done.wait(20.0) and c.terminal["status"] == "ok"
        assert sup.crashes >= 1 and sup.respawns >= 1
    finally:
        sup.stop(timeout_s=10.0)
    # whether the death lands before or under the first dispatch is a race
    # in both packages: the answer, not the event list, is the contract
    return {"terminal": c.terminal["status"], "ok": sup.stats()["counts"]["ok"]}


def test_stub_idle_death_respawns(tmp_path, monkeypatch):
    twin(tmp_path, monkeypatch, _idle_death)


@pytest.mark.parametrize("spec", ["crash:s1.device, wedge:s2.post:1", "crash:"])
def test_crash_wedge_grammar_and_classification(spec):
    def parse(pkg):
        try:
            plan = pkg.faults.FaultPlan.from_spec(spec)
        except ValueError as e:
            return ("ValueError", str(e))
        return sorted((e.kind, e.seam, e.scene, e.remaining) for e in plan.entries)

    assert parse(PKGS["torch"]) == parse(PKGS["jax"])
    if spec.startswith("crash:s1"):
        assert parse(PKGS["torch"]) == [("crash", "device", "s1", 1),
                                        ("wedge", "post", "s2", 1)]
    err = faults.WorkerCrashError("sceneX", "rc -9")
    jerr = jax_faults.WorkerCrashError("sceneX", "rc -9")
    assert str(err) == str(jerr) and "sceneX" in str(err)
    assert faults.classify_error(err) == jax_faults.classify_error(jerr) == "device"


def test_scene_supervisor_initial_rungs():
    cfg = load_config("scannet", data_root="/tmp", config_name="x")
    jcfg = jax_load_config("scannet").replace(data_root="/tmp", config_name="x")
    sup = pt_run.SceneSupervisor(cfg, initial_rungs=1, device="cpu")
    jsup = jax_run.SceneSupervisor(jcfg, initial_rungs=1)
    assert sup.ladder.rung == jsup.ladder.rung == 1
    assert sup.ladder.applied_names == jsup.ladder.applied_names == ["sequential-executor"]
    # over-asking clamps at the ladder depth instead of raising
    assert pt_run.SceneSupervisor(cfg, initial_rungs=99, device="cpu").ladder.exhausted
    assert jax_run.SceneSupervisor(jcfg, initial_rungs=99).ladder.exhausted


def test_config_json_round_trips_every_field_across_packages():
    """The child reads the daemon's config field for field; each package
    reads the other's ``to_json``."""
    cfg = load_config("scannet", data_root="/d", config_name="wire", step=3,
                      mesh_shape=(2, 1), point_shards=2, serve_workers=2,
                      serve_carve="2x1", serve_tenants="a:3,b:1:2",
                      worker_heartbeat_s=7.5, compilation_cache_dir=None)
    back = config_from_json(cfg.to_json())
    assert back == cfg
    fields = [f.name for f in dataclasses.fields(PipelineConfig)]
    assert all(getattr(back, f) == getattr(cfg, f) for f in fields)
    jcfg = jax_config_from_json(cfg.to_json())
    assert json.loads(jcfg.to_json()) == json.loads(cfg.to_json())
    assert config_from_json(jcfg.to_json()) == cfg
    with pytest.raises(ValueError, match="unknown config keys"):
        config_from_json(json.dumps({**json.loads(cfg.to_json()), "typo": 1}))


def test_constructing_for_cuda_creates_no_context(tmp_path, monkeypatch):
    """The parent stays device-free: building a supervisor or a pool for
    the card (and its carve check) initialises no CUDA."""
    def refuse(*a, **k):
        raise AssertionError("the parent initialised CUDA")

    monkeypatch.setattr(torch.cuda, "init", refuse)
    monkeypatch.setattr(torch.cuda, "_lazy_init", refuse)
    cfg = load_config("scannet", data_root=str(tmp_path), serve_workers=2,
                      serve_carve="2x1")
    queue = AdmissionQueue(4)
    sup = supervisor.WorkerSupervisor(cfg, queue, Router(cfg), device="cuda")
    assert str(sup.device) == "cuda"
    assert "--device" in sup._child_cmd(True) and "cuda" in sup._child_cmd(True)
    pool = WorkerPool(cfg, queue, Router(cfg), device="cuda")
    product = pool._device_product()
    assert product == torch.cuda.device_count()
    assert pool._child_env(1) == {"CUDA_VISIBLE_DEVICES": "1"}
    os.unlink(sup._cfg_path)


# ---------------------------------------------------------------------------
# real children, on the CPU
# ---------------------------------------------------------------------------

SCENE = "scene0000_00"
SPEC = dict(num_boxes=3, num_frames=6, image_hw=(48, 64), spacing=0.08, seed=11)


def _assert_same_scene_artifacts(npz_a, npz_b, od_a, od_b):
    with np.load(npz_a) as a, np.load(npz_b) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    da = np.load(od_a, allow_pickle=True).item()
    db = np.load(od_b, allow_pickle=True).item()
    assert sorted(da) == sorted(db)
    for k, obj in da.items():
        np.testing.assert_array_equal(db[k]["point_ids"], obj["point_ids"])
        assert db[k]["mask_list"] == obj["mask_list"]
        assert db[k]["repre_mask_list"] == obj["repre_mask_list"]


def test_real_worker_crash_respawn_byte_identical(tmp_path, monkeypatch):
    """A scripted SIGKILL under an exporting request -> typed worker_crash
    + requeue -> the respawned real child answers ok, pre-degraded, with
    artifacts byte-equal to the one-shot runs of both packages."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    root = str(tmp_path / "data")
    write_scannet_layout(make_scene(**SPEC), root, SCENE)
    kw = dict(step=1, distance_threshold=0.05, mask_pad_multiple=32)
    ref = pt_run.run_pipeline(load_config("scannet", data_root=root, config_name="ptref", **kw),
                              [SCENE], steps=("cluster",), resume=False, journal=False,
                              ledger=False, device="cpu")
    jref = jax_run.run_pipeline(
        jax_load_config("scannet").replace(data_root=root, config_name="jxref", **kw),
        [SCENE], steps=("cluster",), resume=False, journal=False, ledger=False)
    assert [s.status for s in ref.scenes] == [s.status for s in jref.scenes] == ["ok"]

    cfg = load_config("scannet", data_root=root, config_name="iso", worker_heartbeat_s=30.0,
                      retry_backoff_s=0.1, **kw)
    queue = AdmissionQueue(4)
    sup = supervisor.WorkerSupervisor(
        cfg, queue, Router(cfg), journal_dir=str(tmp_path / "journals"),
        warm_scenes=(SCENE,), fault_plan_spec=f"crash:{SCENE}.device:1",
        start_timeout_s=120.0, poll_s=0.1, device="cpu")
    try:
        sup.start()
        c = submit(PKGS["torch"], queue, SCENE, "r-000001")
        assert c.done.wait(120.0), "request never answered"
        assert "worker_crash" in c.states(), c.events
        assert c.terminal["status"] == "ok", c.terminal
        assert c.terminal["rung"] >= 1  # the respawn served it pre-degraded
        assert sup.crashes == 1 and sup.respawns == 1
        ready = sup.last_ready
        assert ready["retrace"] == {} and ready["aot"] == {} and ready["device"] == "cpu"
        assert ready["cuda"] == {"build_s": {}, "launches": {}, "max_memory_allocated": None}
        replay = faults.replay_journal(os.path.join(sup.journal_dir, "r-000001.jsonl"),
                                       request="r-000001")
        assert replay[SCENE]["status"] == "ok"
        rows = faults.read_journal(os.path.join(sup.journal_dir, "r-000001.jsonl"),
                                   request="r-000001")
        assert any(r.get("status") == "interrupted" for r in rows)
    finally:
        sup.stop(timeout_s=60.0)
    assert sup.last_bye["counts"]["ok"] == 1
    w = sup.stats()["worker"]
    assert w["isolated"] and w["crashes"] == 1 and w["respawns"] == 1
    assert json.dumps(w)
    pred = os.path.join(root, "prediction")
    od = os.path.join(root, "scannet", "processed", SCENE, "output", "object")
    for other in ("ptref", "jxref"):
        _assert_same_scene_artifacts(
            os.path.join(pred, "iso_class_agnostic", f"{SCENE}.npz"),
            os.path.join(pred, f"{other}_class_agnostic", f"{SCENE}.npz"),
            os.path.join(od, "iso", "object_dict.npy"),
            os.path.join(od, other, "object_dict.npy"))


NOISY_CHILD = """
import os, sys, warnings
sys.path.insert(0, {root!r})
from maskclustering_tpu_torch.serve import worker, worker_main
start = worker.ServeWorker.start
def noisy_start(self):
    print("a stray print")
    warnings.warn("a warning in the child")
    os.write(1, b"raw bytes on fd 1\\n")
    return start(self)
worker.ServeWorker.start = noisy_start
sys.exit(worker_main.main(sys.argv[1:]))
"""


def test_child_stdout_is_the_wire_only(tmp_path, monkeypatch, caplog):
    """A print, a warning and a raw write to fd 1 in the child go to its
    stderr: the supervisor reads no unreadable line and serves."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    root = str(tmp_path / "data")
    write_scannet_layout(make_scene(**SPEC), root, SCENE)
    cfg = load_config("scannet", data_root=root, config_name="noisy", step=1,
                      distance_threshold=0.05, mask_pad_multiple=32)
    queue = AdmissionQueue(4)
    sup = supervisor.WorkerSupervisor(cfg, queue, Router(cfg), start_timeout_s=120.0,
                                      poll_s=0.1, device="cpu")
    sup.child_argv = [sys.executable, "-c", NOISY_CHILD.format(root=REPO_ROOT),
                      *sup._child_cmd(True)[3:]]
    try:
        with caplog.at_level("WARNING", logger="maskclustering_tpu_torch"):
            sup.start()
            c = submit(PKGS["torch"], queue, SCENE, "r-000001")
            assert c.done.wait(120.0) and c.terminal["status"] == "ok", c.events
    finally:
        sup.stop(timeout_s=60.0)
    assert sup.crashes == 0 and sup.last_bye.get("kind") == "bye"
    assert not [r for r in caplog.records if "unreadable" in r.getMessage()]


def test_child_that_cannot_initialise_its_device_is_a_failed_spawn(tmp_path):
    """A device the child cannot initialise (card 99): the child exits
    non-zero, every respawn fails the same way, start raises — nothing
    retries on the CPU."""
    cfg = load_config("scannet", data_root=str(tmp_path), config_name="nocard",
                      worker_respawns=1, retry_backoff_s=0.01)
    sup = supervisor.WorkerSupervisor(cfg, AdmissionQueue(2), Router(cfg),
                                      start_timeout_s=60.0, device="cuda:99")
    with pytest.raises(RuntimeError, match="failed to start"):
        sup.start()
    # the first spawn plus worker_respawns + 1 respawn attempts
    assert sup.spawns == 3 and sup.respawns == 2 and not sup.last_ready
    sup.stop(timeout_s=5.0)


@pytest.mark.gpu
def test_card_child_serves_and_reports_its_launches(tmp_path, monkeypatch):
    """On the card: a ``--device cuda`` child pins its card by index on its
    worker thread, answers a request, and its bye counts one launch of each
    association kernel a scene (the warm scene and the request)."""
    if not torch.cuda.is_available():
        pytest.skip("the supervised card worker needs a CUDA card")
    root = str(tmp_path / "data")
    write_scannet_layout(make_scene(**SPEC), root, SCENE)
    cfg = load_config("scannet", data_root=root, config_name="card", step=1,
                      distance_threshold=0.05, mask_pad_multiple=32)
    queue = AdmissionQueue(4)
    sup = supervisor.WorkerSupervisor(cfg, queue, Router(cfg), warm_scenes=(SCENE,),
                                      start_timeout_s=300.0, poll_s=0.1, device="cuda")
    try:
        sup.start()
        c = submit(PKGS["torch"], queue, SCENE, "r-000001")
        assert c.done.wait(120.0) and c.terminal["status"] == "ok", c.events
    finally:
        sup.stop(timeout_s=60.0)
    launches = sup.last_bye["cuda"]["launches"]
    assert {k: launches.get(k) for k in ("associate_table", "associate_claim",
                                         "associate_assign")} == {
        "associate_table": 2, "associate_claim": 2, "associate_assign": 2}
    assert sup.last_ready["device"] == "cuda:0"
