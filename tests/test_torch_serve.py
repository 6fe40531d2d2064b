"""The port's scene-serving daemon (``maskclustering_tpu_torch/serve``)
against the JAX package's ``maskclustering_tpu/serve``, on the CPU.

Units (no scene runs):

- protocol: ``parse_line`` / ``build_request`` / the event builders and
  ``encode`` on a table of valid and invalid lines, ``ProtocolError``
  messages included;
- admission: the same submits give the same orders, rejects, requeues,
  drains and ``next_batch`` groups (linger and its deadline clip included);
- router: the same buckets, warm bookkeeping and baseline vocabulary;
- WAL: a log written by either package is recovered by the other.

Worker tier (one module-scoped worker per package, capture sinks, the tiny
32x48 8-frame scenes of ``tests/test_serve_batch.py``): the scene op, the
packed batch, the stream ops, a deadline reject and a deadline result after
a device stall give the same event kinds and states and the same terminal
fields (``seconds`` / ``scene_seconds`` aside), digests included.

Daemon tier (the port's daemon on a Unix socket, ``device="cpu"``): served
digests equal the JAX worker's, ``queue_full``, ``draining`` and
``deadline`` rejects, the WAL replay and dedupe, the ``status`` op, the
unported options' ``NotImplementedError`` and the CLI's digest line. The
canary sentinel's daemon tests are in ``tests/test_torch_canary.py``.
"""

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from maskclustering_tpu.config import load_config as jax_load_config
from maskclustering_tpu.serve import admission as jax_admission
from maskclustering_tpu.serve import protocol as jax_protocol
from maskclustering_tpu.serve import router as jax_router
from maskclustering_tpu.serve import wal as jax_wal
from maskclustering_tpu.serve.worker import ServeWorker as JaxServeWorker
from maskclustering_tpu.utils import faults as jax_faults
from maskclustering_tpu.utils.synthetic import make_scene, to_scene_tensors
from maskclustering_tpu_torch.config import load_config
from maskclustering_tpu_torch.serve import admission, protocol, router, wal
from maskclustering_tpu_torch.serve.client import ServeClient
from maskclustering_tpu_torch.serve.daemon import ServeDaemon
from maskclustering_tpu_torch.serve.worker import ServeWorker
from maskclustering_tpu_torch.utils import faults

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the tiny fused-batch scenes of tests/test_serve_batch.py:28-32
SPEC_P = {"num_boxes": 3, "num_frames": 8, "image_hw": [32, 48], "spacing": 0.08, "seed": 60}
SPEC_Q = {"num_boxes": 3, "num_frames": 8, "image_hw": [32, 48], "spacing": 0.08, "seed": 61}
CFG_KW = dict(config_name="served", step=1, distance_threshold=0.05, mask_pad_multiple=32,
              frame_pad_multiple=8)
# terminal fields that are wall times
WALL = ("seconds", "scene_seconds")


def _cfgs(jax_root, port_root, **kw):
    both = dict(CFG_KW, **kw)
    return (jax_load_config("scannet").replace(data_root=str(jax_root), **both),
            load_config("scannet").replace(data_root=str(port_root), **both))


@pytest.fixture(autouse=True)
def _clean_fault_state():
    for f in (faults, jax_faults):
        f.set_plan(None)
        f.clear_stop()
    yield
    for f in (faults, jax_faults):
        f.set_plan(None)
        f.clear_stop()


# ---------------------------------------------------------------------------
# units: protocol
# ---------------------------------------------------------------------------

LINES = [
    '{"op": "scene", "scene": "scene0000_00"}',
    '{"op": "scene", "scene": "s", "deadline_s": 2.5, "resume": true, "tag": "t", '
    '"tenant": "team-a", "idem": "k-1"}',
    json.dumps({"op": "scene", "scene": "syn", "synthetic": SPEC_P}),
    '{"op": "stream_chunk", "scene": "syn", "chunk": 8}',
    '{"op": "stream_end", "scene": "syn"}',
    '{"op": "status"}',
    '{"op": "status", "detail": "slo"}',
    '{"op": "shutdown"}',
    '{"op": "recarve", "carve": "2x4", "workers": 2}',
    "",
    "not json",
    "[1, 2]",
    '{"op": "frobnicate"}',
    '{"op": "status", "detail": "everything"}',
    '{"op": "recarve", "workers": -1}',
    '{"op": "recarve", "carve": 3}',
    '{"op": "scene"}',
    '{"op": "scene", "scene": "../etc"}',
    '{"op": "scene", "scene": "a/b"}',
    '{"op": "scene", "scene": "s", "chunk": 4}',
    '{"op": "stream_chunk", "scene": "s", "chunk": -1}',
    '{"op": "stream_chunk", "scene": "s", "chunk": true}',
    '{"op": "scene", "scene": "s", "synthetic": [1]}',
    '{"op": "scene", "scene": "s", "synthetic": {"bogus": 1}}',
    '{"op": "scene", "scene": "s", "deadline_s": -1}',
    '{"op": "scene", "scene": "s", "deadline_s": "soon"}',
    '{"op": "scene", "scene": "s", "resume": "yes"}',
    '{"op": "scene", "scene": "s", "tenant": ""}',
    json.dumps({"op": "scene", "scene": "s", "tenant": "x" * 200}),
    '{"op": "scene", "scene": "s", "tenant": "a/b"}',
    '{"op": "scene", "scene": "s", "idem": ""}',
    json.dumps({"op": "scene", "scene": "s", "idem": "k" * 500}),
    '{"op": "scene", "scene": "s", "idem": ".."}',
    '{"op": "scene", "scene": "s", "crashes": 1}',
]


def _req_fields(req):
    d = dataclasses.asdict(req)
    for k in ("admitted_at", "deadline_at", "send"):
        d.pop(k, None)
    return d


@pytest.mark.parametrize("line", LINES)
def test_protocol_parse_and_build_equal(line):
    try:
        want = jax_protocol.parse_line(line)
    except jax_protocol.ProtocolError as e:
        with pytest.raises(protocol.ProtocolError) as info:
            protocol.parse_line(line)
        assert str(info.value) == str(e)
        return
    got = protocol.parse_line(line)
    assert got == want
    if got["op"] in protocol.SCENE_OPS:
        a = jax_protocol.build_request(dict(want), "r-000007")
        b = protocol.build_request(dict(got), "r-000007")
        assert _req_fields(a) == _req_fields(b)
        assert math.isinf(a.deadline_at) == math.isinf(b.deadline_at)
        assert jax_protocol.forward_request(a) == protocol.forward_request(b)


def test_protocol_vocabulary_and_events_equal():
    for name in ("OPS", "SCENE_OPS", "STATUS_DETAILS", "REJECT_REASONS", "RESULT_STATUSES",
                 "SYNTHETIC_PARAMS", "PROTOCOL_VERSION", "TENANT_MAX_LEN", "IDEM_MAX_LEN"):
        assert getattr(protocol, name) == getattr(jax_protocol, name), name
    doc = {"op": "scene", "scene": "s", "tag": "t"}
    a = jax_protocol.build_request(dict(doc), "r-000001")
    b = protocol.build_request(dict(doc), "r-000001")
    pairs = [
        (jax_protocol.ack(a, queue_depth=2), protocol.ack(b, queue_depth=2)),
        (jax_protocol.status(a, "running", bucket=[63, 8, 8192], warm=False),
         protocol.status(b, "running", bucket=[63, 8, 8192], warm=False)),
        (jax_protocol.result(a, "ok", seconds=1.5, num_objects=3),
         protocol.result(b, "ok", seconds=1.5, num_objects=3)),
        (jax_protocol.reject("queue_full", detail="8/8 queued", tag="x"),
         protocol.reject("queue_full", detail="8/8 queued", tag="x")),
        (jax_protocol.reject("deadline", req=a), protocol.reject("deadline", req=b)),
        (jax_protocol.forward_batch([a, a]), protocol.forward_batch([b, b])),
    ]
    for ev_a, ev_b in pairs:
        assert ev_a == ev_b
        if "kind" in ev_a:
            assert jax_protocol.encode(ev_a) == protocol.encode(ev_b)


# ---------------------------------------------------------------------------
# units: admission
# ---------------------------------------------------------------------------


def _req(pmod, scene, i, **kw):
    doc = {"op": "scene", "scene": scene, **kw}
    return pmod.build_request(pmod.parse_line(json.dumps(doc)), f"r-{i:06d}")


def _admission_trace(amod, pmod):
    """One scripted sequence of submits, pops, batches, requeues and
    drains; returns what each step answered."""
    q = amod.AdmissionQueue(4, metered=False)
    out = []
    keys = {"a": ("A",), "b": ("B",), "c": None}
    for i, s in enumerate(["a", "b", "a", "c", "a"]):
        try:
            out.append(("submit", q.submit(_req(pmod, s, i))))
        except amod.QueueFullReject as e:
            out.append(("full", e.depth, e.capacity, str(e)))
    out.append(("depth", q.depth(), q.high_water, q.admitted))
    batch = q.next_batch(lambda r: keys[r.scene], max_n=3, linger_s=0.0, timeout_s=0.1)
    out.append(("batch", [r.id for r in batch]))
    head = q.next(timeout_s=0.1)
    out.append(("next", head.id))
    out.append(("requeue", q.requeue(head)))
    batch = q.next_batch(lambda r: keys[r.scene], max_n=3, linger_s=0.0, timeout_s=0.1)
    out.append(("batch", [r.id for r in batch]))
    q.submit(_req(pmod, "a", 10))
    q.submit(_req(pmod, "b", 11))
    out.append(("drain", [r.id for r in q.drain()]))
    out.append(("empty", q.next(timeout_s=0.01), q.depth()))
    return out


def test_admission_orders_and_rejects_equal():
    a = _admission_trace(jax_admission, jax_protocol)
    b = _admission_trace(admission, protocol)
    assert a == b
    assert ("full", 4, 4, "admission queue full (4/4)") in b


def _linger_trace(amod, pmod):
    q = amod.AdmissionQueue(4, metered=False)
    q.submit(_req(pmod, "a", 0))

    def late():
        time.sleep(0.1)
        q.submit(_req(pmod, "a", 1))
        q.submit(_req(pmod, "b", 2))

    t = threading.Thread(target=late)
    t.start()
    # the batch closes when its second member arrives, long before the linger
    batch = q.next_batch(lambda r: (r.scene,), max_n=2, linger_s=10.0, timeout_s=0.2)
    t.join()
    rest = q.next_batch(lambda r: (r.scene,), max_n=3, linger_s=0.0, timeout_s=0.2)
    # a member's deadline clips the linger window
    q.submit(_req(pmod, "a", 3, deadline_s=0.15))
    t0 = time.monotonic()
    clipped = q.next_batch(lambda r: (r.scene,), max_n=3, linger_s=30.0, timeout_s=0.2)
    return ([r.id for r in batch], [r.id for r in rest], [r.id for r in clipped],
            time.monotonic() - t0 < 5.0)


def test_admission_next_batch_linger_equal():
    a = _linger_trace(jax_admission, jax_protocol)
    b = _linger_trace(admission, protocol)
    assert a == b == (["r-000000", "r-000001"], ["r-000002"], ["r-000003"], True)


def test_admission_metered_counters():
    from maskclustering_tpu_torch.obs import metrics

    metrics.registry().reset()
    q = admission.AdmissionQueue(1)
    q.submit(_req(protocol, "a", 0))
    with pytest.raises(admission.QueueFullReject):
        q.submit(_req(protocol, "a", 1))
    counters = metrics.registry().snapshot()["counters"]
    assert counters["serve.admission.admitted"] == 1
    assert counters["serve.admission.rejects.queue_full"] == 1
    metrics.registry().reset()


# ---------------------------------------------------------------------------
# units: router
# ---------------------------------------------------------------------------


def test_router_classifies_and_warms_equal(tmp_path):
    baseline = os.path.join(REPO, "compile_surface_baseline.json")
    ja = jax_router.Router(jax_load_config("scannet", **CFG_KW), baseline_path=baseline)
    ra = router.Router(load_config("scannet", **CFG_KW), baseline_path=baseline)
    assert ja.vocabulary == ra.vocabulary and ra.vocabulary
    assert ja.vocabulary_buckets() == ra.vocabulary_buckets()
    for shape in ((8, 5000, 40), (10, 8193, 64), (33, 100000, 300)):
        assert ja.classify(*shape) == ra.classify(*shape)
    t = to_scene_tensors(make_scene(**dict(SPEC_P, image_hw=(32, 48))))
    b = ra.classify_tensors(t)
    assert b == ja.classify_tensors(t) == (63, 8, 8192)
    for r in (ja, ra):
        assert r.bucket_for("p") is None
        r.remember("p", b)
        assert r.note_served(b) and not r.note_served(b) and r.is_warm(b)
        r.remember_pad_tensors(b, t)
    assert ja.bucket_for("p") == ra.bucket_for("p") and ra.pad_tensors_for(b) is t
    assert ja.warm_buckets() == ra.warm_buckets()
    fitted = router.fit_tensors_to_bucket(t, 8, 9000, 120)
    jfit = jax_router.fit_tensors_to_bucket(t, 8, 9000, 120)
    assert np.array_equal(fitted.scene_points, jfit.scene_points)
    assert np.array_equal(fitted.segmentations, jfit.segmentations)
    assert ra.classify_tensors(fitted) == ja.classify_tensors(jfit)
    assert router.Router(load_config("scannet"), baseline_path=str(tmp_path / "no.json")
                         ).vocabulary == []


# ---------------------------------------------------------------------------
# units: the admission WAL across the packages
# ---------------------------------------------------------------------------


def _write_wal(wmod, pmod, path):
    w = wmod.AdmissionWal(path)
    r1 = _req(pmod, "a", 1, idem="k1")
    w.admit("r-000001", {"op": "scene", "scene": "a", "idem": "k1"}, idem="k1")
    w.dispatch("r-000001")
    w.terminal("r-000001", pmod.result(r1, "ok", seconds=1.0, num_objects=2), idem="k1")
    w.admit("r-000002", {"op": "scene", "scene": "b"})
    w.admit("r-000005", {"op": "stream_chunk", "scene": "c", "chunk": 4}, idem="k5")
    w.dispatch("r-000005")
    w.close()
    with open(path, "a") as f:
        f.write('{"v": 1, "kind": "wal", "torn')


def _state(st):
    return (st.max_id, st.answered, [(rid, doc, idem) for rid, doc, idem in st.pending],
            st.stats.torn, st.stats.unknown_version)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_recovered_by_the_other_package(tmp_path, writer):
    path = str(tmp_path / wal.WAL_FILENAME)
    if writer == "jax":
        _write_wal(jax_wal, jax_protocol, path)
    else:
        _write_wal(wal, protocol, path)
    a, b = jax_wal.read_wal(path), wal.read_wal(path)
    assert _state(a) == _state(b)
    assert b.max_id == 5 and [p[0] for p in b.pending] == ["r-000002", "r-000005"]
    assert set(b.answered) == {"k1"}
    # compaction by either package reads back the same
    wal.compact(path, b)
    assert _state(jax_wal.read_wal(path))[:3] == _state(b)[:3]


def test_wal_prune_dir_equal(tmp_path):
    for name in ("a", "b"):
        d = tmp_path / name
        d.mkdir()
        for i in range(6):
            p = d / f"r-{i:06d}.jsonl"
            p.write_text("{}\n")
            os.utime(p, (1000 + i, 1000 + i))
        (d / wal.WAL_FILENAME).write_text("{}\n")
    na = jax_wal.prune_dir(str(tmp_path / "a"), keep=2, max_age_s=0.0, suffixes=(".jsonl",))
    nb = wal.prune_dir(str(tmp_path / "b"), keep=2, max_age_s=0.0, suffixes=(".jsonl",))
    assert na == nb
    assert sorted(os.listdir(tmp_path / "a")) == sorted(os.listdir(tmp_path / "b"))


# ---------------------------------------------------------------------------
# worker tier: the same requests through both packages' workers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_workers")
    jcfg, pcfg = _cfgs(tmp / "jax", tmp / "port", serve_batch_max=3,
                       serve_batch_linger_s=0.02)
    jw = JaxServeWorker(jcfg, jax_admission.AdmissionQueue(8, metered=False),
                        jax_router.Router(jcfg), journal_dir=str(tmp / "jax_journals"))
    pw = ServeWorker(pcfg, admission.AdmissionQueue(8, metered=False), router.Router(pcfg),
                     journal_dir=str(tmp / "port_journals"), device="cpu")
    return {"jax": jw, "port": pw, "tmp": tmp}


def _capture(fn, reqs):
    sinks = []
    for r in reqs:
        events = []
        r.send = events.append
        sinks.append(events)
    fn(reqs)
    return sinks


def _both(workers, make, run):
    """Run the same requests through both workers: (jax events, port events)."""
    out = []
    for name, pmod in (("jax", jax_protocol), ("port", protocol)):
        out.append(_capture(lambda reqs: run(workers[name], reqs), make(pmod)))
    return out


def _shape(events):
    """An event list without wall times: kinds, states and fields."""
    out = []
    for ev in events:
        ev = {k: v for k, v in ev.items() if k not in WALL}
        out.append(ev)
    return out


def _terminal(events):
    (t,) = [e for e in events if e.get("kind") in ("result", "reject")]
    return t


def test_worker_scene_op_equal(workers):
    got = []
    for i, (scene, spec) in enumerate([("bt-p", SPEC_P), ("bt-q", SPEC_Q), ("bt-p", SPEC_P)]):
        sj, sp = _both(workers, lambda pm: [_req(pm, scene, 10 + i, synthetic=spec)],
                       lambda w, reqs: w._serve_one(reqs[0]))
        assert _shape(sj[0]) == _shape(sp[0])
        got.append(_terminal(sp[0]))
    first, second, repeat = got
    assert [e["kind"] for e in sp[0]] == ["status", "result"]
    assert first["status"] == "ok" and first["num_objects"] > 0 and first["digest"]["artifact"]
    assert first["digest"]["artifact"] != second["digest"]["artifact"]
    assert repeat["digest"] == first["digest"] and repeat["buckets_new"] == 0
    stats = workers["port"].stats()
    assert stats["counts"]["ok"] >= 3 and stats["warm_buckets"]


def test_worker_packed_batch_equal_to_sequential(workers):
    seq = {}
    for i, (scene, spec) in enumerate([("bt-p", SPEC_P), ("bt-q", SPEC_Q)]):
        ev = _capture(lambda reqs: workers["port"]._serve_one(reqs[0]),
                      [_req(protocol, scene, 20 + i, synthetic=spec)])[0]
        seq[scene] = _terminal(ev)
    sj, sp = _both(workers, lambda pm: [_req(pm, "bt-p", 30, synthetic=SPEC_P),
                                        _req(pm, "bt-q", 31, synthetic=SPEC_Q)],
                   lambda w, reqs: w._serve_batch(reqs))
    for ej, ep, scene in zip(sj, sp, ("bt-p", "bt-q")):
        assert _shape(ej) == _shape(ep)
        term = _terminal(ep)
        assert term["status"] == "ok" and term["batch"] == 2
        assert term["digest"]["artifact"] == seq[scene]["digest"]["artifact"]
        assert term["digest_coord"].startswith("fused|")
    assert workers["port"].batch_stats() == workers["jax"].batch_stats()


def test_worker_stream_ops_equal(workers):
    # streams are a single-device mode: workers of an unpacked config
    tmp = workers["tmp"]
    jcfg, pcfg = _cfgs(tmp / "jax", tmp / "port")
    stream_workers = {
        "jax": JaxServeWorker(jcfg, jax_admission.AdmissionQueue(8, metered=False),
                              jax_router.Router(jcfg)),
        "port": ServeWorker(pcfg, admission.AdmissionQueue(8, metered=False),
                            router.Router(pcfg), device="cpu")}

    def run(w, reqs):
        for r in reqs:
            w._serve_one(r)

    def make(pm):
        reqs = [_req(pm, "st-p", 40 + i, synthetic=SPEC_P, op="stream_chunk",
                     **({"chunk": 4} if i == 0 else {})) for i in range(2)]
        reqs.append(pm.build_request({"op": "stream_end", "scene": "st-p"}, "r-000042"))
        # a stream_end with no live stream fails typed
        reqs.append(pm.build_request({"op": "stream_end", "scene": "st-none"}, "r-000043"))
        return reqs

    sj, sp = _both(stream_workers, make, run)
    for ej, ep in zip(sj, sp):
        assert _shape(ej) == _shape(ep)
    chunk0, chunk1, end, orphan = (_terminal(e) for e in sp)
    assert [e.get("state") for e in sp[0][:-1]] == ["running", "chunk_done"]
    assert chunk1["done"] and chunk1["frames_done"] == 8
    assert end["status"] == "ok" and end["chunks"] == 2 and end["num_objects"] > 0
    assert orphan["status"] == "failed" and "no live stream" in orphan["error"]


def test_worker_deadline_reject_and_stall_result_equal(workers):
    # dequeued after its deadline: a typed deadline reject, no device work
    def make_late(pm):
        r = _req(pm, "bt-p", 50, synthetic=SPEC_P, deadline_s=0.05)
        r.admitted_at -= 1.0
        r.deadline_at -= 1.0
        return [r]

    sj, sp = _both(workers, make_late, lambda w, reqs: w._serve_one(reqs[0]))
    term = _terminal(sp[0])
    assert term["kind"] == "reject" and term["reason"] == "deadline"
    assert _terminal(sj[0])["reason"] == "deadline"
    assert term["detail"].startswith("deadline_s=0.05 expired after")

    # a device stall past the request's deadline: the watchdog budget is
    # the remaining deadline, the ladder may not retry past it, and the
    # request answers a typed deadline result of the device class
    out = {}
    for name, pm, fm in (("jax", jax_protocol, jax_faults), ("port", protocol, faults)):
        fm.set_plan(fm.FaultPlan.from_spec("stall:bt-q.device:1", stall_s=2.5))
        try:
            ev = _capture(lambda reqs: workers[name]._serve_one(reqs[0]),
                          [_req(pm, "bt-q", 51, synthetic=SPEC_Q, deadline_s=1.0)])[0]
        finally:
            fm.set_plan(None)
        # the abandoned attempt wakes after the stall and finishes on its
        # daemon thread: wait for it, so no work outlives the test
        for th in threading.enumerate():
            if th.name.startswith("watchdog-device-bt-q"):
                th.join(60.0)
        out[name] = ev
    for name in out:
        t = _terminal(out[name])
        assert (t["status"], t["error_class"], t["attempts"]) == ("deadline", "device", 1), t
        assert "DeviceStallError: device phase of scene 'bt-q' did not finish within" \
            in t["error"]
    # the message names each package's module and the budget left
    assert [{k: v for k, v in e.items() if k != "error"} for e in _shape(out["jax"])] == \
        [{k: v for k, v in e.items() if k != "error"} for e in _shape(out["port"])]


def test_worker_batch_key_gates_equal(workers):
    pw, jw = workers["port"], workers["jax"]
    for w, pm, fm in ((jw, jax_protocol, jax_faults), (pw, protocol, faults)):
        w.router.remember("known", (7, 8, 4096))
    rows = []
    for w, pm, fm in ((jw, jax_protocol, jax_faults), (pw, protocol, faults)):
        crashed = _req(pm, "known", 3)
        crashed.crashes = 1
        keys = [w._batch_key(_req(pm, "known", 0)), w._batch_key(_req(pm, "novel", 1)),
                w._batch_key(_req(pm, "known", 2, resume=True)), w._batch_key(crashed)]
        fm.set_plan(fm.FaultPlan.from_spec("flaky:known:1"))
        keys.append(w._batch_key(_req(pm, "known", 4)))
        fm.set_plan(None)
        rows.append(keys)
    assert rows[0] == rows[1] == [(7, 8, 4096), None, None, None, None]


def test_worker_canary_names_its_item(workers):
    """The canary round is ported (ROADMAP A9b): a worker with no thread
    runs it inline, and with no warm-up scene retained it probes nothing,
    as the JAX worker does (``tests/test_torch_canary.py`` probes)."""
    assert workers["port"].run_canary() == workers["jax"].run_canary() == []


def test_worker_canary_round_equal(workers):
    """A canary round over a retained warm-up scene gives the JAX worker's
    probe (scene, coordinate, digest dict) and books no request."""
    from maskclustering_tpu_torch.utils import synthetic as port_synthetic

    pw, jw = workers["port"], workers["jax"]
    spec = dict(SPEC_P, image_hw=tuple(SPEC_P["image_hw"]))
    assert jw.warm_tensors("canary-p", to_scene_tensors(make_scene(**spec)))
    assert pw.warm_tensors("canary-p", port_synthetic.to_scene_tensors(
        port_synthetic.make_scene(**spec)))
    before = pw.stats()["counts"]["requests"]
    try:
        rows = [[(p["scene"], p["coord"], p["digest"]) for p in w.run_canary()]
                for w in (pw, jw)]
    finally:
        for w in (pw, jw):
            w._warm_cache.clear()
    assert rows[0] == rows[1] and len(rows[0]) == 1 and rows[0][0][2]["artifact"]
    assert pw.stats()["counts"]["requests"] == before


# ---------------------------------------------------------------------------
# daemon tier: the port's daemon on a Unix socket
# ---------------------------------------------------------------------------


def _short_socket():
    """AF_UNIX paths hold 107 bytes: a fresh directory in the temporary
    directory, or in /tmp when that one's path is too long."""
    base = tempfile.gettempdir()
    return os.path.join(tempfile.mkdtemp(prefix="mct", dir=base if len(base) <= 64 else "/tmp"),
                        "s.sock")


@pytest.fixture
def sockets():
    """A factory of short socket paths whose directories go at teardown."""
    made = []

    def make():
        made.append(_short_socket())
        return made[-1]

    yield make
    for sock in made:
        shutil.rmtree(os.path.dirname(sock), ignore_errors=True)


def _wait(pred, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError("condition not reached")


def _request_thread(sock, scene, spec, out, i, **kw):
    def run():
        with ServeClient(sock, timeout_s=300.0) as c:
            out[i] = c.run_scene(scene, synthetic=spec, tag=f"t{i}", **kw)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


@pytest.fixture(scope="module")
def daemon(tmp_path_factory, workers):
    root = tmp_path_factory.mktemp("serve_daemon")
    _, cfg = _cfgs(root, root)
    sock = _short_socket()
    d = ServeDaemon(cfg, socket_path=sock, capacity=1, journal_dir=str(root / "journals"),
                    device="cpu", telemetry_window_s=0.5)
    d.start()
    try:
        yield {"daemon": d, "sock": sock, "root": root, "cfg": cfg}
    finally:
        d.request_stop()
        d.shutdown()
        shutil.rmtree(os.path.dirname(sock), ignore_errors=True)


def test_daemon_answers_run_scene_with_the_jax_digests(daemon, workers):
    ref = {}
    for i, (scene, spec) in enumerate([("bt-p", SPEC_P), ("bt-q", SPEC_Q)]):
        ev = _capture(lambda reqs: workers["jax"]._serve_one(reqs[0]),
                      [_req(jax_protocol, scene, 60 + i, synthetic=spec)])[0]
        ref[scene] = _terminal(ev)
    with ServeClient(daemon["sock"], timeout_s=120.0) as c:
        for scene, spec in (("bt-p", SPEC_P), ("bt-q", SPEC_Q), ("bt-p", SPEC_P)):
            term, statuses, _ = c.run_scene(scene, synthetic=spec, tag="x")
            assert term["status"] == "ok", term
            assert [s["state"] for s in statuses] == ["running"]
            assert term["digest"] == ref[scene]["digest"]
            assert term["num_objects"] == ref[scene]["num_objects"]
            assert term["tag"] == "x" and term["bucket"] == [63, 8, 8192]
        stats = c.stats(detail="slo")
    assert term["buckets_new"] == 0 and statuses[0]["warm"] is True
    assert stats["counts"]["ok"] >= 3 and stats["retrace"] == {} and stats["canary"] is None
    assert stats["latency"]["p50_s"] is not None
    assert "telemetry" in stats and stats["slo"]["spec"] == "serve-default"
    # the per-request journal replays the outcome
    rid = term["id"]
    replay = faults.replay_journal(
        os.path.join(str(daemon["root"]), "journals", f"{rid}.jsonl"), request=rid)
    assert replay["bt-p"]["status"] == "ok"


def test_daemon_queue_full_and_queue_deadline(daemon):
    sock, d = daemon["sock"], daemon["daemon"]
    plan = faults.FaultPlan.from_spec("stall:edge-block.device:1", stall_s=1.5)
    faults.set_plan(plan)
    out = {}
    try:
        t1 = _request_thread(sock, "edge-block", SPEC_P, out, 1)
        _wait(lambda: plan.entries[0].remaining == 0)  # r1 mid-device-phase
        t2 = _request_thread(sock, "edge-q", SPEC_P, out, 2, deadline_s=0.3)
        _wait(lambda: d.queue.depth() == 1)  # r2 queued behind r1
        with ServeClient(sock, timeout_s=30.0) as c:
            rej = c.request_scene("edge-q2", synthetic=SPEC_P)
        assert rej["kind"] == "reject" and rej["reason"] == "queue_full"
        assert rej["detail"] == "1/1 queued; retry with backoff"
        t1.join(60.0)
        t2.join(60.0)
    finally:
        faults.set_plan(None)
    assert out[1][0]["status"] == "ok" and out[1][0]["attempts"] == 1
    # queued past its 0.3 s deadline behind the stall: rejected at dequeue
    assert out[2][0]["kind"] == "reject" and out[2][0]["reason"] == "deadline"
    with ServeClient(sock, timeout_s=30.0) as c:
        bad = c.request_scene("a/b")
        assert bad["kind"] == "reject" and bad["reason"] == "bad_request"
        c.send({"op": "status", "detail": "sentinel"})
        assert c.recv_event()["sentinel"] == {"armed": False}
        c.send({"op": "recarve", "workers": 2})
        assert "worker pool" in c.recv_event()["detail"]


def test_daemon_drain_and_wal_replay(daemon, tmp_path, sockets):
    """One request in flight and two queued, then stop: the in-flight one
    answers ok and the queued ones get draining rejects. A second daemon
    on the same journal_dir replays the journaled-but-unanswered admits of
    a dead predecessor and dedupes the answered keys."""
    _, cfg = _cfgs(daemon["root"], daemon["root"])
    jdir = str(tmp_path / "journals")
    sock = sockets()
    d = ServeDaemon(cfg, socket_path=sock, capacity=4, journal_dir=jdir, device="cpu")
    d.start()
    plan = faults.FaultPlan.from_spec("stall:drain-s.device:1", stall_s=1.5)
    faults.set_plan(plan)
    out = {}
    try:
        t1 = _request_thread(sock, "drain-s", SPEC_P, out, 1, idem="k-drain")
        _wait(lambda: plan.entries[0].remaining == 0)
        t2 = _request_thread(sock, "drain-q", SPEC_P, out, 2, idem="k-q2")
        t3 = _request_thread(sock, "drain-q", SPEC_P, out, 3)
        _wait(lambda: d.queue.depth() == 2)
        d.request_stop()
        d.shutdown(timeout_s=120.0)
        for t in (t1, t2, t3):
            t.join(60.0)
    finally:
        faults.set_plan(None)
    assert out[1][0]["kind"] == "result" and out[1][0]["status"] == "ok"
    assert out[2][0]["reason"] == "draining" and out[3][0]["reason"] == "draining"
    assert not os.path.exists(sock)
    assert d.stats()["draining"]

    # a predecessor that died after journaling an admit: its WAL row replays
    w = wal.AdmissionWal(os.path.join(jdir, wal.WAL_FILENAME))
    w.admit("r-000100", {"op": "scene", "scene": "bt-p", "synthetic": SPEC_P, "idem": "k-dead"},
            idem="k-dead")
    w.close()
    sock2 = sockets()
    d2 = ServeDaemon(cfg, socket_path=sock2, capacity=4, journal_dir=jdir, device="cpu")
    d2.start()
    try:
        _wait(lambda: d2.stats()["counts"]["ok"] >= 1)
        with ServeClient(sock2, timeout_s=60.0) as c:
            # the answered keys replay their cached terminals
            term, _, _ = c.run_scene("drain-s", synthetic=SPEC_P, idem="k-drain")
            assert term["deduped"] and term["status"] == "ok" and term["id"] == out[1][0]["id"]
            term, _, _ = c.run_scene("bt-p", synthetic=SPEC_P, idem="k-dead")
            assert term["deduped"] and term["status"] == "ok" and term["id"] == "r-000100"
            nxt = c.request_scene("bt-q", synthetic=SPEC_Q)
            # the id counter resumes past the WAL's (each line, a deduped
            # resubmit too, draws an id, as in JAX)
            assert nxt["kind"] == "ack" and nxt["id"] == "r-000103"
            c.wait_result()
        durable = d2.stats()["durable"]
        assert durable["wal_replayed"] == 1 and durable["wal_deduped"] == 2
    finally:
        d2.request_stop()
        d2.shutdown()
    # the JAX package recovers the port's WAL to the same state
    path = os.path.join(jdir, wal.WAL_FILENAME)
    assert _state(jax_wal.read_wal(path)) == _state(wal.read_wal(path))


def test_daemon_unported_options_name_their_items(daemon):
    cfg = daemon["cfg"]
    with pytest.raises(NotImplementedError, match="ROADMAP A9c"):
        ServeDaemon(cfg, socket_path="/tmp/x.sock", isolate_worker=True, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A9c"):
        ServeDaemon(cfg.replace(serve_workers=2), socket_path="/tmp/x.sock", device="cpu")
    # the canary sentinel is ported: the option arms it at start()
    armed = ServeDaemon(cfg, socket_path="/tmp/x.sock", canary_interval_s=5.0, device="cpu")
    assert armed.canary_interval_s == 5.0 and armed.sentinel is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeDaemon(cfg, socket_path="/tmp/x.sock")


@pytest.mark.parametrize("flags,item", [
    (["--isolate-worker"], "A9c"), (["--workers", "2"], "A9c"), (["--carve", "2x1"], "A9c"),
    (["--tenants", "a:1"], "A9c"), (["--workers", "4"], "A9c"),
    (["--retrace-sanitizer"], "A10"), (["--aot-cache"], "A10"), (["--no-freeze"], "A10"),
])
def test_cli_refuses_unported_flags(flags, item):
    from maskclustering_tpu_torch.serve.__main__ import main

    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        main(["--config", "scannet", "--socket", "/tmp/never.sock", "--device", "cpu",
              *flags])


def test_cli_serves_and_prints_the_digest_line(tmp_path, sockets):
    sock = sockets()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "maskclustering_tpu_torch.serve", "--config", "scannet",
         "--socket", sock, "--device", "cpu", "--data_root", str(tmp_path), "--set", "step=1",
         "--obs_events", str(tmp_path / "events.jsonl")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _wait(lambda: os.path.exists(sock) or proc.poll() is not None, 120.0)
        with ServeClient(sock, timeout_s=30.0) as c:
            assert c.stats()["counts"]["requests"] == 0
            assert c.shutdown()["kind"] == "ack"
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-2000:]
    last = json.loads(out.strip().splitlines()[-1])
    assert last["kind"] == "digest" and last["config"] == "scannet" and last["draining"]
    assert os.path.exists(tmp_path / "events.jsonl")
