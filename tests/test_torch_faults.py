"""The port's fault drills (``utils/faults.py``) against the JAX package's.

- ``FaultPlan.from_spec`` parses every kind, seam, count and malformed spec
  as the JAX plan does: equal entries, equal error messages;
- the plan's firings (flaky, terminal, stall, post, corrupt, wedge, crash)
  and its activation from ``$MCT_FAULT_PLAN``;
- the watchdog, ``Heartbeat``, ``RetryPolicy`` and the error classes
  (``tests/test_faults.py:82-154``);
- the four-scan drill of ``tests/test_faults.py:301-428`` through the port's
  ``run_pipeline``: one persistent load failure, one device stall under the
  watchdog, one scene flaky twice and one persistent post-process capacity
  fault. The statuses are the ones the JAX test pins; attempts and rungs
  follow the port's two-rung ladder (ROADMAP C1: JAX's rung 3 and attempt 4
  for the capacity fault is the port's rung 2 and attempt 3). Every healed
  scan's artifacts equal the JAX package's fault-free run of the same scans;
- ``corrupt:<scene>.host``: the ``plane`` digest drifts, the artifacts do not;
- ``sigterm``: the run stops at the scene boundary, journals, and the rerun
  resumes to the fault-free artifacts.

Scans are the JAX drill's (``make_scene(num_boxes=2, num_frames=6,
image_hw=(40, 56), spacing=0.05)``); everything runs on the CPU.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from maskclustering_tpu.config import load_config as jax_load_config
from maskclustering_tpu.run import run_pipeline as jax_run_pipeline
from maskclustering_tpu.utils import faults as jax_faults
from maskclustering_tpu.utils.synthetic import make_scene, write_scannet_layout
from maskclustering_tpu_torch.config import load_config
from maskclustering_tpu_torch.models.postprocess_device import PostprocessCapacityError
from maskclustering_tpu_torch.run import run_pipeline
from maskclustering_tpu_torch.utils import faults

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = [f"scene{i:04d}_00" for i in range(4)]
# a healthy tiny-scan device phase takes well under a second here; the
# JAX drill needs 25 s for its first compiles, the port compiles nothing
WATCHDOG_S = 5.0
# the abandoned stall thread outsleeps the whole suite, so it never wakes
# to run a ghost device phase beside later tests
STALL_S = 3600.0
KW = dict(step=1, distance_threshold=0.05, mask_pad_multiple=32, frame_pad_multiple=4,
          point_chunk=2048, retry_backoff_s=0.01)


@pytest.fixture(autouse=True)
def _clean_fault_state():
    for mod in (faults, jax_faults):
        mod.set_plan(None)
        mod.clear_stop()
    yield
    for mod in (faults, jax_faults):
        mod.set_plan(None)
        mod.clear_stop()


def _entries(plan):
    return [(e.kind, e.seam, e.scene, e.remaining) for e in plan.entries]


# ---------------------------------------------------------------------------
# the plan: grammar, firings, activation
# ---------------------------------------------------------------------------

KINDS = sorted(faults._KIND_DEFAULTS)
GOOD_SPECS = (
    [f"{k}:s1" for k in KINDS]
    + [f"{k}:s1.{seam}" for k in KINDS for seam in faults.SEAMS]
    + [f"{k}:s1.{seam}:3" for k in ("flaky", "corrupt") for seam in ("chunk", "host")]
    + ["load:scene2, stall:scene4.device, flaky:scene5:2, fail:scene3.export:1, terminal:s6",
       " load:a,, flaky:b:2 ,", "fail:my.scene.post:1", "", "stall:x:7"])
BAD_SPECS = ["boom:s1", "load:s1.warp", "stall:s1:0", "load:", "justload", "a:b:c:d",
             "load:s1:x", "load:.device", ":s1", "flaky:s1:-2", "load:s1.Device"]


def test_seams_and_kinds_equal_jax():
    assert faults.SEAMS == jax_faults.SEAMS
    assert faults._KIND_DEFAULTS == jax_faults._KIND_DEFAULTS


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_from_spec_entries_equal_jax(spec):
    got = faults.FaultPlan.from_spec(spec, stall_s=0.5)
    want = jax_faults.FaultPlan.from_spec(spec, stall_s=0.5)
    assert _entries(got) == _entries(want)
    assert got.stall_s == want.stall_s and got.spec == want.spec == spec


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_from_spec_refusals_equal_jax(spec):
    with pytest.raises(ValueError) as want:
        jax_faults.FaultPlan.from_spec(spec)
    with pytest.raises(ValueError) as got:
        faults.FaultPlan.from_spec(spec)
    assert str(got.value) == str(want.value)


def test_stall_seconds_from_the_environment(monkeypatch):
    for value, expect in (("0.25", 0.25), ("junk", 5.0)):
        monkeypatch.setenv("MCT_FAULT_STALL_S", value)
        assert faults.FaultPlan.from_spec("stall:a").stall_s == expect
        assert jax_faults.FaultPlan.from_spec("stall:a").stall_s == expect
    monkeypatch.delenv("MCT_FAULT_STALL_S")
    assert faults.FaultPlan.from_spec("stall:a").stall_s == 5.0


def test_plan_fires_as_scripted():
    plan = faults.FaultPlan.from_spec(
        "load:s2, stall:s4.device, flaky:s5:2, fail:s3.export:1, terminal:s6, "
        "corrupt:s7.chunk:1, fail:s8.post:1", stall_s=0.01)
    for _ in range(2):  # flaky: exactly twice, then healed
        with pytest.raises(faults.InjectedFault):
            plan.fire("device", "s5")
    plan.fire("device", "s5")
    with pytest.raises(faults.InjectedFault) as err:
        plan.fire("device", "s6")
    assert not err.value.retryable and faults.classify_error(err.value) == "terminal"
    t0 = time.perf_counter()
    plan.fire("device", "s4")
    assert 0.005 <= time.perf_counter() - t0 < 1.0
    plan.fire("device", "s4")  # count exhausted: no-op
    plan.fire("device", "unlisted")
    plan.fire("load", None)
    for _ in range(3):  # load: every attempt
        with pytest.raises(faults.InjectedFault, match="injected load fault at load seam of s2"):
            plan.fire("load", "s2")
    # the post seam raises the production capacity error: device class
    with pytest.raises(PostprocessCapacityError) as pe:
        plan.fire("post", "s8")
    assert faults.classify_error(pe.value) == "device" and pe.value.knob == "post_group_cap"
    plan.fire("post", "s8")
    # corrupt never fires at a seam; take_corruption consumes it once
    plan.fire("chunk", "s7")
    assert plan.take_corruption("chunk", "s7")
    assert not plan.take_corruption("chunk", "s7")
    assert not plan.take_corruption("host", "s7") and not plan.take_corruption("chunk", None)


def test_wedge_calls_its_hook_before_it_blocks():
    class Silenced(Exception):
        pass

    def hook():
        raise Silenced

    faults.set_wedge_hook(hook)
    try:
        assert faults.wedge_hook() is hook
        with pytest.raises(Silenced):
            faults.FaultPlan.from_spec("wedge:w").fire("device", "w")
    finally:
        faults.set_wedge_hook(None)


def test_crash_kills_the_process_at_the_seam():
    code = ("from maskclustering_tpu_torch.utils import faults\n"
            "faults.set_plan(faults.FaultPlan.from_spec('crash:c.load'))\n"
            "faults.inject('device', 'c')\n"
            "faults.inject('load', 'c')\n"
            "print('survived')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL and "survived" not in proc.stdout


def test_plan_from_the_environment(monkeypatch):
    monkeypatch.setenv("MCT_FAULT_PLAN", "load:envscene")
    faults.set_plan(None)
    assert faults.active_plan() is None  # an explicit set_plan(None) wins
    monkeypatch.setattr(faults, "_PLAN_LOADED", False)  # a fresh read
    plan = faults.active_plan()
    assert plan is not None and _entries(plan) == [("load", "load", "envscene", None)]
    with pytest.raises(faults.InjectedFault):
        faults.inject("load", "envscene")
    faults.inject("device", "envscene")  # other seams untouched
    assert not faults.take_corruption("host", "envscene")
    faults.set_plan(None)
    faults.inject("load", "envscene")


# ---------------------------------------------------------------------------
# watchdog, heartbeat, retry policy, error classes
# ---------------------------------------------------------------------------


def test_deadline_passthrough_and_subsecond_stall():
    assert faults.call_with_deadline(lambda: 41 + 1, 0.0) == 42
    assert faults.call_with_deadline(lambda: "ok", 5.0, seam="pull") == "ok"
    t0 = time.perf_counter()
    with pytest.raises(faults.DeviceStallError) as ei:
        faults.call_with_deadline(lambda: time.sleep(10), 0.05, seam="device", scene="sX")
    assert time.perf_counter() - t0 < 1.0
    assert (ei.value.seam, ei.value.scene, ei.value.budget_s) == ("device", "sX", 0.05)
    assert faults.classify_error(ei.value) == "device"
    with pytest.raises(OSError, match="disk"):
        faults.call_with_deadline(lambda: (_ for _ in ()).throw(OSError("disk gone")), 5.0)


def test_heartbeat_rearms_on_progress():
    hb = faults.Heartbeat(0.5, seam="host", scene="sY")
    for _ in range(3):  # slow but alive: the beats keep it armed
        time.sleep(0.2)
        hb.beat()
        hb.check()
    assert hb.age_s() < 0.5 and hb.remaining() > 0.0
    time.sleep(0.6)
    assert hb.expired()
    with pytest.raises(faults.DeviceStallError) as ei:
        hb.check()
    assert (ei.value.seam, ei.value.scene) == ("host", "sY")
    assert not faults.Heartbeat(0.0).expired()  # budget 0: disarmed


def test_retry_policy_shapes(monkeypatch):
    exp = faults.RetryPolicy(base_s=0.25, cap_s=2.0)
    assert [exp.backoff(a) for a in (1, 2, 3, 4, 5)] == [0.25, 0.5, 1.0, 2.0, 2.0]
    assert exp.attempts == 3 and faults.RetryPolicy(attempts=0).attempts == 1
    bench = faults.RetryPolicy(base_s=20.0, cap_s=120.0, style="linear",
                               scale_env="MCT_BENCH_BACKOFF_SCALE")
    jax_bench = jax_faults.RetryPolicy(base_s=20.0, cap_s=120.0, style="linear",
                                       scale_env="MCT_BENCH_BACKOFF_SCALE")
    for value in (None, "0.05", "not-a-number", "-3"):
        if value is None:
            monkeypatch.delenv("MCT_BENCH_BACKOFF_SCALE", raising=False)
        else:
            monkeypatch.setenv("MCT_BENCH_BACKOFF_SCALE", value)
        got = [bench.backoff(a) for a in (1, 2, 3, 6, 7)]
        assert got == [jax_bench.backoff(a) for a in (1, 2, 3, 6, 7)]
    monkeypatch.delenv("MCT_BENCH_BACKOFF_SCALE")
    assert [bench.backoff(a) for a in (1, 2, 3, 6, 7)] == [20, 40, 60, 120, 120]
    with pytest.raises(ValueError, match="unknown backoff style"):
        faults.RetryPolicy(style="fancy")


def test_error_classification():
    assert faults.classify_error(OSError("io")) == "retryable"
    assert faults.classify_error(RuntimeError("?")) == "retryable"
    assert faults.classify_error(ValueError("bad cfg")) == "terminal"
    assert faults.classify_error(MemoryError()) == "device"
    assert faults.classify_error(faults.InjectedFault("x")) == "retryable"
    assert faults.classify_error(faults.InjectedFault("x", retryable=False)) == "terminal"
    # an injected fault is never read as a device error by its message
    assert faults.classify_error(faults.InjectedFault("CUDA error: x")) == "retryable"
    assert faults.classify_error(RuntimeError("CUDA error: an illegal address")) == "device"


def test_stop_reason():
    assert faults.stop_reason() == ""
    faults.request_stop("drill")
    assert faults.stop_requested() and faults.stop_reason() == "drill"
    faults.clear_stop()
    assert faults.stop_reason() == ""


# ---------------------------------------------------------------------------
# the four-scan drill
# ---------------------------------------------------------------------------


def _cfg(root, name, **kw):
    return load_config("scannet", data_root=root, config_name=name, **KW, **kw)


def _npz(root, config, seq):
    with np.load(os.path.join(root, "prediction", f"{config}_class_agnostic",
                              f"{seq}.npz")) as z:
        return {k: z[k] for k in z.files}


def _assert_artifacts_equal(root, config_a, config_b, seq):
    a, b = _npz(root, config_a, seq), _npz(root, config_b, seq)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """The four scans: the JAX package's fault-free run, then the port's
    run under the JAX drill's plan."""
    root = str(tmp_path_factory.mktemp("drill"))
    for i, seq in enumerate(SCENES):
        write_scannet_layout(make_scene(num_boxes=2, num_frames=6, image_hw=(40, 56),
                                        spacing=0.05, seed=70 + i), root, seq)
    ref = jax_run_pipeline(jax_load_config("scannet", data_root=root, config_name="ref", **KW),
                           SCENES, steps=("cluster",), resume=False, journal=False,
                           ledger=False)
    assert [s.status for s in ref.scenes] == ["ok"] * 4
    plan = faults.FaultPlan.from_spec(
        f"load:{SCENES[0]}, stall:{SCENES[1]}.device, flaky:{SCENES[2]}:2, "
        f"fail:{SCENES[3]}.post", stall_s=STALL_S)
    report_path = os.path.join(root, "flt_report.json")
    faults.set_plan(plan)
    try:
        flt = run_pipeline(_cfg(root, "flt", watchdog_device_s=WATCHDOG_S), SCENES,
                           steps=("cluster",), resume=False, report_path=report_path,
                           device="cpu")
    finally:
        faults.set_plan(None)
    return {"root": root, "ref": {s.seq_name: s for s in ref.scenes}, "flt": flt,
            "report_path": report_path, "journal": os.path.join(root, "run_journal.jsonl")}


def test_drill_statuses_follow_the_jax_drill(drill):
    by = {s.seq_name: s for s in drill["flt"].scenes}
    assert [s.seq_name for s in drill["flt"].scenes] == SCENES
    # the persistent load failure: the only failed scene, after the whole
    # retryable budget (1 + scene_retries 2), as in JAX
    assert [s.seq_name for s in drill["flt"].failed] == [SCENES[0]]
    assert by[SCENES[0]].attempts == 3 and by[SCENES[0]].error_class == "retryable"
    assert "InjectedFault" in by[SCENES[0]].error
    # the stall: a DeviceStallError within the watchdog, healed one rung down
    assert (by[SCENES[1]].status, by[SCENES[1]].attempts,
            by[SCENES[1]].degradation_rung) == ("ok", 2, 1)
    # flaky twice, ok at the third attempt
    assert (by[SCENES[2]].status, by[SCENES[2]].attempts) == ("ok", 3)
    # the capacity fault heals on host-postprocess: JAX rung 3 / attempt 4
    # (after its inert donation-off rung) is the port's rung 2 / attempt 3
    assert (by[SCENES[3]].status, by[SCENES[3]].attempts,
            by[SCENES[3]].degradation_rung) == ("ok", 3, 2)
    digest = drill["flt"].faults
    assert digest["device_stalls"] == 1
    assert digest["degradations"] == {"sequential-executor": 1, "host-postprocess": 1}
    assert digest["final_rung"] == 2 and not digest["interrupted"]
    # four scenes retried after round 1, three after round 2 (JAX: 4 + 3 + 1)
    assert digest["scene_retries"] == 7


def test_drill_stall_is_deadline_bounded(drill):
    rows = faults.read_journal(drill["journal"], config="flt")
    stall = [r for r in rows if r.get("event") == "outcome" and r.get("seq") == SCENES[1]
             and r.get("status") == "failed"]
    assert len(stall) == 1 and stall[0]["error_class"] == "device"
    assert "DeviceStallError" in stall[0]["error"]
    assert stall[0]["seconds"] < 120.0 < STALL_S  # abandoned, not outwaited


def test_drill_healed_artifacts_equal_jax_fault_free(drill):
    for seq in SCENES[1:]:
        _assert_artifacts_equal(drill["root"], "flt", "ref", seq)
        st = next(s for s in drill["flt"].scenes if s.seq_name == seq)
        ref = drill["ref"][seq]
        assert st.digest["artifact"] == ref.digest["artifact"]
        assert st.digest["plane"] == ref.digest["plane"]
    assert not os.path.exists(os.path.join(drill["root"], "prediction", "flt_class_agnostic",
                                           f"{SCENES[0]}.npz"))


def test_drill_journal_replays_the_report(drill):
    replay = faults.replay_journal(drill["journal"], config="flt")
    saved = json.load(open(drill["report_path"]))
    assert saved["faults"]["degradations"] == {"sequential-executor": 1,
                                               "host-postprocess": 1}
    for scene in saved["scenes"]:
        r = replay[scene["seq_name"]]
        for key, field in (("status", "status"), ("attempts", "attempts"),
                           ("degradation_rung", "degradation_rung"),
                           ("error_class", "error_class"), ("num_objects", "num_objects")):
            assert r[key] == scene[field], scene


def test_corrupt_host_drifts_the_plane_digest_only(drill):
    root, seq = drill["root"], SCENES[1]
    faults.set_plan(faults.FaultPlan.from_spec(f"corrupt:{seq}.host:1"))
    rep = run_pipeline(_cfg(root, "bitflip"), [seq], steps=("cluster",), resume=False,
                       journal=False, device="cpu")
    assert rep.ok and rep.faults["scene_retries"] == 0  # nothing raised, nothing healed
    got, ref = rep.scenes[0].digest, drill["ref"][seq].digest
    assert got["plane"] != ref["plane"]
    assert got["artifact"] == ref["artifact"]
    _assert_artifacts_equal(root, "bitflip", "ref", seq)
    assert not faults.active_plan().take_corruption("host", seq)  # consumed once


def test_sigterm_journals_and_resumes(drill):
    """SIGTERM in the second scene's load: the run stops at the scene
    boundary with a valid partial report and journal; the rerun skips the
    journaled-done scene and ends with the fault-free artifacts."""
    root = drill["root"]
    names = SCENES[1:]
    report_a = os.path.join(root, "sig_report.json")
    cfg = _cfg(root, "sig", scene_overlap=False, prefetch_depth=0)
    old_handler = faults.install_sigterm_handler()
    faults.set_plan(faults.FaultPlan.from_spec(f"sigterm:{names[1]}.load"))
    try:
        rep_a = run_pipeline(cfg, names, steps=("cluster",), report_path=report_a,
                             device="cpu")
    finally:
        faults.set_plan(None)
        signal.signal(signal.SIGTERM, old_handler)
    assert [s.status for s in rep_a.scenes] == ["ok", "interrupted", "interrupted"]
    assert not rep_a.ok and rep_a.faults["interrupted"]
    assert faults.stop_reason() == f"signal {int(signal.SIGTERM)}"
    saved = json.load(open(report_a))
    assert [s["status"] for s in saved["scenes"]] == ["ok", "interrupted", "interrupted"]
    replay = faults.replay_journal(os.path.join(root, "run_journal.jsonl"), config="sig")
    assert replay[names[0]]["status"] == "ok"
    assert (replay[names[1]]["status"], replay[names[1]]["attempts"]) == ("interrupted", 1)
    assert replay[names[2]]["attempts"] == 0

    faults.clear_stop()
    rep_b = run_pipeline(cfg, names, steps=("cluster",),
                         report_path=os.path.join(root, "sig_report_b.json"), device="cpu")
    assert [s.status for s in rep_b.scenes] == ["skipped", "ok", "ok"]
    assert rep_b.scenes[0].attempts == 0 and rep_b.faults["journal_skips"] == 1
    assert rep_b.ok
    for seq in names:
        _assert_artifacts_equal(root, "sig", "ref", seq)
