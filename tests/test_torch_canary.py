"""The port's canary sentinel (``maskclustering_tpu_torch/obs/canary.py``)
against the JAX package's ``maskclustering_tpu/obs/canary.py``, on the CPU.

- ``load_goldens``, ``compare_probe``, ``probes_to_goldens`` and
  ``write_goldens`` agree between the packages on clean, drifted and
  uncovered probes and on a stale goldens file.
- ``generate_goldens`` on the CPU reproduces the committed
  ``canary_goldens.json`` (written to a temporary file; the committed one is
  never written).
- A ``CanarySentinel`` over goldens with one digest changed books
  ``canary.drift``, emits the ``canary.drift`` event and dumps the flight
  recorder naming the coordinate; its verdicts and stats equal the JAX
  sentinel's; a busy tick is skipped.
- A daemon (``device="cpu"``) with ``canary_interval_s`` probes its warm
  scene at an idle queue, answers ``status detail="sentinel"`` with the JAX
  sentinel's document, keeps canary rounds out of ``serve.requests`` and
  the latency window, and meets the SLO's ``correctness`` objective; a
  request it serves meanwhile traces with the stage spans nested under it.
"""

import json
import os
import shutil
import tempfile
import time

import pytest
import torch

from maskclustering_tpu.obs import canary as jax_canary
from maskclustering_tpu_torch import obs
from maskclustering_tpu_torch.obs import canary, events, flight, metrics, trace
from maskclustering_tpu_torch.serve.client import ServeClient
from maskclustering_tpu_torch.serve.daemon import ServeDaemon

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "canary_goldens.json")
COORD_A = "k63:f32:n16384|bf16|single|r0|c0"
COORD_B = "k127:f64:n65536|bf16|single|r0|c0"


def _doc():
    with open(GOLDENS) as fh:
        return json.load(fh)


def _probes(doc, tamper=None):
    out = []
    for coord, golden in sorted(doc["goldens"].items()):
        digest = {k: v for k, v in golden.items() if k != "scene"}
        if coord == tamper:
            digest = dict(digest, artifact="deadbeef")
        out.append({"scene": golden["scene"], "coord": coord, "digest": digest,
                    "seconds": 0.25})
    return out


@pytest.fixture
def fresh(tmp_path):
    obs.disable()
    metrics.registry().reset()
    yield
    obs.disable()
    flight.arm(None)
    metrics.registry().reset()


def test_goldens_file_and_comparison_equal(tmp_path):
    doc = canary.load_goldens(GOLDENS)
    assert doc == jax_canary.load_goldens(GOLDENS) and set(doc["goldens"]) == {COORD_A, COORD_B}
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps(dict(doc, version=2)))
    assert canary.load_goldens(str(stale)) is None and jax_canary.load_goldens(str(stale)) is None
    assert canary.load_goldens(str(tmp_path / "none.json")) is None
    probes = _probes(doc, tamper=COORD_B) + [
        {"scene": "C", "coord": "k15:f8:n4096|bf16|single|r0|c0", "digest": {"v": 1}}]
    mine = [canary.compare_probe(p, doc) for p in probes]
    assert mine == [jax_canary.compare_probe(p, doc) for p in probes]
    assert [r["status"] for r in mine] == ["drift", "ok", "uncovered"]
    assert mine[0]["fields"] == ["artifact"]
    assert canary.probes_to_goldens(probes) == jax_canary.probes_to_goldens(probes)
    a = canary.write_goldens(str(tmp_path / "a.json"), canary.probes_to_goldens(_probes(doc)),
                             config=doc["config"])
    jax_canary.write_goldens(str(tmp_path / "b.json"), canary.probes_to_goldens(_probes(doc)),
                             config=doc["config"])
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()
    assert a["goldens"] == doc["goldens"]
    assert canary.goldens_config().replace(config_name="x") == \
        canary.goldens_config().replace(config_name="x")


def test_generate_goldens_reproduces_the_committed_file(tmp_path, fresh):
    before = open(GOLDENS, "rb").read()
    doc = _doc()
    cfg = canary.goldens_config().replace(data_root=str(tmp_path / "data"))
    goldens = canary.generate_goldens(
        cfg, baseline_path=os.path.join(REPO, "compile_surface_baseline.json"), device="cpu")
    written = canary.write_goldens(str(tmp_path / "goldens.json"), goldens,
                                   config=doc["config"])
    assert written["goldens"] == doc["goldens"]
    assert metrics.registry().snapshot()["counters"]["canary.probes"] == 2
    assert open(GOLDENS, "rb").read() == before


def test_sentinel_drift_trips_the_correctness_plane(tmp_path, fresh):
    doc = _doc()
    bad = json.loads(json.dumps(doc))
    bad["goldens"][COORD_A]["artifact"] = "00000000"
    path = str(tmp_path / "events.jsonl")
    obs.configure(path, truncate=True)
    flight.arm(str(tmp_path / "flight"))
    mine = canary.CanarySentinel(run_round=lambda: _probes(doc), goldens=bad, interval_s=60)
    theirs = jax_canary.CanarySentinel(run_round=lambda: _probes(doc), goldens=bad,
                                       interval_s=60)
    results = mine.tick()
    assert results == theirs.tick()
    assert [r["status"] for r in results] == ["ok", "drift"]

    def no_ages(stats):
        return {k: v for k, v in stats.items() if k != "last_verified_age_s"}

    assert no_ages(mine.stats()) == no_ages(theirs.stats())
    assert mine.stats()["drift_coords"] == {COORD_A: 1}
    assert metrics.registry().snapshot()["counters"]["canary.drift"] == 1
    obs.flush_metrics()
    drift = events.read_events(path, kinds=[events.KIND_DRIFT])
    assert [(e["coord"], e["fields"]) for e in drift] == [(COORD_A, ["artifact"])]
    dumps = os.listdir(tmp_path / "flight")
    assert len(dumps) == 1
    _meta, rows = flight.read_dump(str(tmp_path / "flight" / dumps[0]))
    assert any(r.get("kind") == "canary.drift" and r.get("coord") == COORD_A for r in rows)
    busy = canary.CanarySentinel(run_round=lambda: _probes(doc), goldens=doc,
                                 is_idle=lambda: False)
    assert busy.tick() is None and busy.stats()["skipped_busy"] == 1
    assert metrics.registry().snapshot()["counters"]["canary.skipped_busy"] == 1


def _short_socket():
    """AF_UNIX paths hold 107 bytes: a short directory under /tmp."""
    return os.path.join(tempfile.mkdtemp(prefix="mct", dir="/tmp"), "s.sock")


def _wait(pred, timeout_s=120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError("condition not reached")


def test_daemon_sentinel_on_the_cpu(tmp_path, fresh):
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps({"workload": [
        {"scene": "A", "frames": 10, "points": 16000, "max_id": 14}]}))
    # the goldens' pipeline knobs; the scannet layout serves the traced request
    cfg = canary.goldens_config().replace(dataset="scannet", data_root=str(tmp_path / "data"),
                                          step=1)
    events_path = str(tmp_path / "events.jsonl")
    obs.configure(events_path, truncate=True)
    sock = _short_socket()
    journals = str(tmp_path / "journals")
    d = ServeDaemon(cfg, socket_path=sock, journal_dir=journals,
                    warm_baseline=str(baseline), canary_interval_s=0.2,
                    canary_goldens=GOLDENS, telemetry_window_s=0.5, device="cpu")
    d.start()
    try:
        assert d.sentinel is not None
        _wait(lambda: d.sentinel.stats()["rounds"] >= 2)
        with ServeClient(sock, timeout_s=120.0) as c:
            term, _, _ = c.run_scene("traced", synthetic={
                "num_boxes": 3, "num_frames": 8, "image_hw": [32, 48], "spacing": 0.08,
                "seed": 60})
            assert term["status"] == "ok", term
            rounds = d.sentinel.stats()["rounds"]
            _wait(lambda: d.sentinel.stats()["rounds"] > rounds)
            doc = c.sentinel()
            slo = c.slo()
        sent = doc["sentinel"]
        want = jax_canary.CanarySentinel(run_round=lambda: [], goldens=_doc()).stats()
        assert set(sent) == set(want)
        assert sent["rounds"] >= 3 and sent["drift_total"] == 0 and sent["coords"] == [COORD_A]
        assert [r["status"] for r in sent["last_results"]] == ["ok"]
        assert doc["canary"]["drift_total"] == 0 and doc["canary"]["rounds"] >= 3
        # canary rounds are fenced out of the request accounting
        assert doc["counts"]["requests"] == 1 and doc["latency"]["count"] == 1
        counters = metrics.registry().snapshot()["counters"]
        assert counters["serve.requests"] == 1 and counters["canary.probes"] >= 3
        verdict = {o["name"]: o for o in slo["slo"]["objectives"]}
        assert verdict["correctness"]["state"] == "ok"
        assert verdict["correctness"]["observed_long"] == 0.0
        rid = term["id"]
    finally:
        d.request_stop()
        d.shutdown()
        shutil.rmtree(os.path.dirname(sock), ignore_errors=True)
    assert not d.sentinel._thread.is_alive()
    obs.flush_metrics()
    tr = trace.assemble_trace(rid, events_path, journal_dir=journals)
    labels = [s["label"] for s in tr["segments"]]
    assert labels[0] == "queue wait" and "execution" in labels and labels[-1] == "outcome ok"
    kids = [c["label"] for s in tr["segments"] if s["label"] == "execution"
            for c in s["children"]]
    stages = [k for k in kids if k in ("associate", "graph", "cluster", "postprocess")]
    assert stages == ["associate", "graph", "cluster", "postprocess"]


def test_daemon_without_usable_goldens_serves_unarmed(tmp_path, fresh):
    sock = _short_socket()
    cfg = canary.goldens_config().replace(data_root=str(tmp_path / "data"))
    d = ServeDaemon(cfg, socket_path=sock, canary_interval_s=0.2,
                    canary_goldens=str(tmp_path / "missing.json"), device="cpu")
    d.start()
    try:
        assert d.sentinel is None
        with ServeClient(sock, timeout_s=30.0) as c:
            doc = c.sentinel()
        assert doc["sentinel"] == {"armed": False} and doc["canary"] is None
    finally:
        d.request_stop()
        d.shutdown()
        shutil.rmtree(os.path.dirname(sock), ignore_errors=True)
