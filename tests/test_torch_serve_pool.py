"""The port's worker pool (``maskclustering_tpu_torch/serve/pool.py``) and
the cross-process telemetry relay (``obs/telemetry.py`` ``RelaySink``,
``ChildRelay``, ``fold_telem``; ``obs/metrics.py`` ``snapshot_delta``,
``merge_snapshot_delta``; ``obs.configure_sink``) against the JAX
package's, on the CPU.

Each case of ``tests/test_serve_pool.py`` has a twin here: the grammar and
carve checks give the same values and messages in both packages, and the
stub cases (``tests/worker_stub.py``) run the same scripted stub through
the JAX ``WorkerPool`` and the port's, with the same request events,
counts, scheduler and tenant tables, and the same weighted-fair dispatch
order, exactly. The relay's deltas, sinks and folds give equal registries,
spans and window rows in both packages; the port's report renders a pool
events file written by either package to the JAX report's text, and
``render_top`` gives the JAX frame on either package's pool stats. A real
two-slice CPU pool serves every digest of the one-shot runs.
"""

import os
import sys
import time

import pytest
import torch

from maskclustering_tpu import obs as jax_obs
from maskclustering_tpu.config import parse_carve_spec as jax_parse_carve_spec
from maskclustering_tpu.config import parse_tenant_spec as jax_parse_tenant_spec
from maskclustering_tpu.obs import metrics as jax_metrics
from maskclustering_tpu.obs import report as jax_report
from maskclustering_tpu.obs import telemetry as jax_telemetry
from maskclustering_tpu.obs import top as jax_top
from maskclustering_tpu.serve import pool as jax_pool
from maskclustering_tpu.serve import supervisor as jax_supervisor
from maskclustering_tpu.utils.synthetic import make_scene, write_scannet_layout
from maskclustering_tpu_torch import obs
from maskclustering_tpu_torch.config import load_config, parse_carve_spec, parse_tenant_spec
from maskclustering_tpu_torch.obs import events, metrics, report, telemetry, top
from maskclustering_tpu_torch.run import run_pipeline
from maskclustering_tpu_torch.serve import pool, protocol
from maskclustering_tpu_torch.serve import supervisor
from maskclustering_tpu_torch.serve.admission import AdmissionQueue
from maskclustering_tpu_torch.serve.router import Router
from test_torch_serve_supervisor import PKGS, STUB, Client, cfg_for, mask, submit, twin

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

for _name, _mods in (("jax", (jax_pool, jax_supervisor)), ("torch", (pool, supervisor))):
    PKGS[_name].pool = _mods[0]
    PKGS[_name].supervisor = _mods[1]


def admit(pkg, the_pool, scene, i, *, op="scene", tenant="", **kw):
    client = Client()
    doc = {"op": op, "scene": scene, **kw}
    if tenant:
        doc["tenant"] = tenant
    req = pkg.protocol.build_request(doc, f"p-{i:06d}")
    req.send = client.send
    the_pool.admit(req)
    return client


def make_pool(pkg, tmp, mp, **cfg_kw):
    mp.setenv("STUB_DIR", str(tmp))
    cfg = cfg_for(pkg, tmp, config_name="pool", **cfg_kw)
    queue = pkg.AdmissionQueue(32)
    the_pool = pkg.WorkerPool(cfg, queue, pkg.Router(cfg),
                              journal_dir=str(tmp / "journals"),
                              child_argv=[sys.executable, STUB],
                              start_timeout_s=15.0, poll_s=0.05, **pkg.device)
    return the_pool, queue


def sched(the_pool):
    """The scheduler table and tenant table of a pool's stats."""
    st = the_pool.stats()
    return {"scheduler": st["pool"]["scheduler"], "tenants": st["pool"]["tenants"],
            "counts": st["counts"], "carve": st["pool"]["carve"]}


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


# ---------------------------------------------------------------------------
# carve / tenant grammar + typed config validation
# ---------------------------------------------------------------------------

CARVES = ["4x2", "1x8", "", "x", "4x", "x2", "4x2x1", "ax2", "4xb", "0x2", "4x0", "-1x2"]
TENANTS = ["heavy:3,light:1:4", "a:0.5", "a", "a:1:2:3", ":1", "a:x", "a:0", "a:-1",
           "a:1:0", "a:1:1.5", "a:1,a:2", "a/b:1"]


def test_parse_carve_spec_grammar():
    got = [_outcome(parse_carve_spec, c) for c in CARVES]
    assert got == [_outcome(jax_parse_carve_spec, c) for c in CARVES]
    assert got[:2] == [("ok", (4, 2)), ("ok", (1, 8))]
    assert all(kind == "ValueError" for kind, _ in got[2:])


def test_parse_tenant_spec_grammar():
    got = [_outcome(parse_tenant_spec, t) for t in TENANTS]
    assert got == [_outcome(jax_parse_tenant_spec, t) for t in TENANTS]
    assert got[0] == ("ok", {"heavy": (3.0, None), "light": (1.0, 4)})
    assert got[1] == ("ok", {"a": (0.5, None)})
    assert all(kind == "ValueError" for kind, _ in got[2:])


@pytest.mark.parametrize("kw", [dict(serve_workers=0),
                                dict(serve_workers=2, serve_carve="3x2"),
                                dict(serve_tenants="a:1:2:3"),
                                dict(serve_workers=2, serve_carve="2x4",
                                     serve_tenants="heavy:3,light:1:4")])
def test_config_validates_pool_knobs(tmp_path, kw):
    got = {name: _outcome(lambda pkg: cfg_for(pkg, tmp_path, **kw), PKGS[name])
           for name in PKGS}
    if got["jax"][0] == "ok":
        assert got["torch"][0] == "ok" and got["torch"][1].serve_workers == 2
    else:
        assert got["torch"] == got["jax"]


CHECKS = [(2, 4, 8), (2, 2, 8), (2, 0, 8), (2, 4, None), (2, 8, 8), (3, 2, 8), (2, 1, 1)]


def test_check_carve_divides_device_product():
    got = [_outcome(pool.check_carve, *c) for c in CHECKS]
    assert got == [_outcome(jax_pool.check_carve, *c) for c in CHECKS]
    assert [kind for kind, _ in got] == ["ok"] * 4 + ["ValueError"] * 3
    # one H100 and a 2x1 carve: 2 chips needed, the backend has 1
    assert "needs 2 chips but the backend has 1" in got[-1][1]


# ---------------------------------------------------------------------------
# the scheduler plane, on the stub pool
# ---------------------------------------------------------------------------


def _serves_on_both(pkg, tmp, mp):
    the_pool, _ = make_pool(pkg, tmp, mp, serve_workers=2)
    the_pool.start()
    try:
        clients = [admit(pkg, the_pool, "stub-ok", i) for i in range(6)]
        for c in clients:
            assert c.done.wait(15.0) and c.terminal["status"] == "ok"
        assert the_pool.wait_idle(10.0)
        st = the_pool.stats()
        assert st["counts"]["ok"] == 6 and st["pool"]["scheduler"]["dispatched"] == 6
        assert st["worker"]["pool"] == 2 and st["worker"]["alive"] == 2
        assert sum(w["dispatched"] for w in st["pool"]["workers"]) == 6
    finally:
        the_pool.stop(timeout_s=15.0)
    return {"events": [mask(c.events) for c in clients], **sched(the_pool),
            "worker": mask(st["worker"])}


def test_pool_serves_on_both_workers(tmp_path, monkeypatch):
    twin(tmp_path, monkeypatch, _serves_on_both)


def _weighted_fair(pkg, tmp, mp):
    the_pool, _ = make_pool(pkg, tmp, mp, serve_workers=2,
                            serve_tenants="heavy:3,light:1")
    order = []
    book = the_pool._book_dispatch
    the_pool._book_dispatch = lambda req, wid: (order.append(req.tenant),
                                                book(req, wid))[1]
    the_pool._pause.set()  # hold dispatch until the whole burst is queued
    the_pool.start()
    try:
        clients = [admit(pkg, the_pool, "stub-ok", i, tenant="heavy") for i in range(12)]
        clients += [admit(pkg, the_pool, "stub-ok", i, tenant="light")
                    for i in range(12, 24)]
        the_pool._pause.clear()
        for c in clients:
            assert c.done.wait(30.0) and c.terminal["status"] == "ok"
        assert order[:4].count("heavy") == 3 and order[:12].count("heavy") == 9
        assert the_pool.wait_idle(10.0)
    finally:
        the_pool.stop(timeout_s=15.0)
    return {"order": order, **sched(the_pool)}


def test_weighted_fair_three_to_one_dispatch_order(tmp_path, monkeypatch):
    rec = twin(tmp_path, monkeypatch, _weighted_fair)
    assert rec["tenants"]["heavy"] == {"dispatched": 12, "weight": 3.0, "queued": 0}


def _quota(pkg, tmp, mp):
    the_pool, _ = make_pool(pkg, tmp, mp, serve_workers=2, serve_tenants="capped:1:2")
    the_pool._pause.set()
    the_pool.start()
    try:
        c1 = admit(pkg, the_pool, "stub-ok", 1, tenant="capped")
        c2 = admit(pkg, the_pool, "stub-ok", 2, tenant="capped")
        with pytest.raises(pkg.pool.QuotaReject) as ei:
            admit(pkg, the_pool, "stub-ok", 3, tenant="capped")
        reject = (ei.value.tenant, ei.value.limit, ei.value.queued, str(ei.value))
        c4 = admit(pkg, the_pool, "stub-ok", 4, tenant="other")
        the_pool._pause.clear()
        for c in (c1, c2, c4):
            assert c.done.wait(15.0) and c.terminal["status"] == "ok"
        assert the_pool.wait_idle(10.0)
        c5 = admit(pkg, the_pool, "stub-ok", 5, tenant="capped")
        assert c5.done.wait(15.0) and c5.terminal["status"] == "ok"
        assert the_pool.wait_idle(10.0)
    finally:
        the_pool.stop(timeout_s=15.0)
    return {"reject": reject, "events": [mask(c.events) for c in (c1, c2, c4, c5)],
            **sched(the_pool)}


def test_quota_exhaustion_rejects_typed(tmp_path, monkeypatch):
    rec = twin(tmp_path, monkeypatch, _quota)
    assert rec["reject"][:3] == ("capped", 2, 2)


def _affinity(pkg, tmp, mp):
    the_pool, _ = make_pool(pkg, tmp, mp, serve_workers=2)
    the_pool.start()
    try:
        assert the_pool.wait_idle(10.0)
        bucket = (63, 32, 16384)
        the_pool.router.remember("warm-scene", bucket)
        the_pool._warm[1].add(bucket)
        req = pkg.protocol.build_request({"op": "scene", "scene": "warm-scene"}, "r-route-1")
        warm = the_pool._route(req)
        the_pool.router.remember("cold-scene", (7, 8, 1024))
        cold_req = pkg.protocol.build_request({"op": "scene", "scene": "cold-scene"},
                                              "r-route-2")
        cold = the_pool._route(cold_req)
        c = admit(pkg, the_pool, "cold-scene", 990)
        assert c.done.wait(15.0)
        assert the_pool.wait_idle(10.0)
        warmed = [(7, 8, 1024) in w for w in the_pool._warm]
    finally:
        the_pool.stop(timeout_s=15.0)
    return {"warm": warm, "cold": cold, "warmed": warmed, **sched(the_pool)}


def test_affinity_warm_bucket_routes_to_warm_slice(tmp_path, monkeypatch):
    rec = twin(tmp_path, monkeypatch, _affinity)
    assert rec["warm"] == ("dispatch", 1) and rec["cold"] == ("dispatch", 0)
    assert any(rec["warmed"]) and rec["scheduler"]["affinity_misses"] >= 1


def _streams_pin(pkg, tmp, mp):
    the_pool, _ = make_pool(pkg, tmp, mp, serve_workers=2)
    the_pool.start()
    try:
        c1 = admit(pkg, the_pool, "stream-a", 1, op="stream_chunk")
        assert c1.done.wait(15.0) and c1.terminal["status"] == "ok"
        owner = the_pool._stream_owner["stream-a"]
        req = pkg.protocol.build_request({"op": "stream_chunk", "scene": "stream-a"},
                                         "r-pin-2")
        assert the_pool._route(req) == ("dispatch", owner)
        c2 = admit(pkg, the_pool, "stream-a", 2, op="stream_end")
        assert c2.done.wait(15.0) and c2.terminal["done"] is True
    finally:
        the_pool.stop(timeout_s=15.0)
    return {"owner": owner, "events": [mask(c.events) for c in (c1, c2)]}


def test_pool_streams_pin_to_owner_slice(tmp_path, monkeypatch):
    twin(tmp_path, monkeypatch, _streams_pin)


def _retired_owner(pkg, tmp, mp):
    the_pool, _ = make_pool(pkg, tmp, mp, serve_workers=2)
    the_pool.start()
    try:
        c1 = admit(pkg, the_pool, "stream-b", 1, op="stream_chunk")
        assert c1.done.wait(15.0) and c1.terminal["status"] == "ok"
        owner = the_pool._stream_owner["stream-b"]
        with the_pool._lock:
            the_pool._dead.add(owner)  # simulate a retired slice
        c2 = admit(pkg, the_pool, "stream-b", 2, op="stream_chunk")
        assert c2.done.wait(15.0)
        assert "stream_lost" in c2.states() and c2.terminal["error_class"] == "stream_lost"
        assert "stream-b" not in the_pool._stream_owner
        c3 = admit(pkg, the_pool, "stream-b", 3, op="stream_chunk")
        assert c3.done.wait(15.0) and c3.terminal["status"] == "ok"
        moved = the_pool._stream_owner["stream-b"] != owner
        with the_pool._lock:
            the_pool._dead.discard(owner)
    finally:
        the_pool.stop(timeout_s=15.0)
    return {"moved": moved, "events": [mask(c.events) for c in (c1, c2, c3)]}


def test_pool_stream_on_retired_owner_answers_stream_lost(tmp_path, monkeypatch):
    assert twin(tmp_path, monkeypatch, _retired_owner)["moved"]


def _crash_reroute(pkg, tmp, mp):
    the_pool, _ = make_pool(pkg, tmp, mp, serve_workers=2)
    the_pool.start()
    try:
        assert the_pool.wait_idle(10.0)
        crash = admit(pkg, the_pool, "stub-crash", 1)
        neighbor = admit(pkg, the_pool, "stub-ok", 2)
        assert crash.done.wait(30.0) and neighbor.done.wait(30.0)
        assert "worker_crash" in crash.states()
        assert crash.terminal["status"] == neighbor.terminal["status"] == "ok"
        st = the_pool.stats()
        assert st["worker"]["crashes"] == 1
        assert st["pool"]["scheduler"]["crash_reroutes"] >= 1 or st["counts"]["ok"] == 2
    finally:
        the_pool.stop(timeout_s=15.0)
    return {"crash": mask(crash.events), "neighbor": mask(neighbor.events),
            "crashes": st["worker"]["crashes"]}


def test_crash_reroutes_victim_to_neighbor(tmp_path, monkeypatch):
    """The JAX case is slow-marked for its stub lifecycles; the twin runs
    in seconds and stays in tier-1."""
    twin(tmp_path, monkeypatch, _crash_reroute)


def _recarve(pkg, tmp, mp):
    the_pool, _ = make_pool(pkg, tmp, mp, serve_workers=2)
    the_pool.start()
    try:
        slow = admit(pkg, the_pool, "stub-slow", 1)
        time.sleep(0.3)  # let it dispatch
        out = the_pool.recarve(workers=1, timeout_s=30.0)
        assert slow.done.wait(5.0) and slow.terminal["status"] == "ok"
        assert out["ok"] is True and the_pool.workers == 1 and len(the_pool._sups) == 1
        c = admit(pkg, the_pool, "stub-ok", 2)
        assert c.done.wait(15.0) and c.terminal["status"] == "ok"
        deadline = time.monotonic() + 5.0
        while the_pool.stats()["counts"]["ok"] < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        errors = [_outcome(the_pool.recarve, *a) for a in ((2, "3x1"), ())]
    finally:
        the_pool.stop(timeout_s=15.0)
    return {"out": {k: v for k, v in out.items() if k != "seconds"},
            "events": [mask(x.events) for x in (slow, c)], "errors": errors,
            **sched(the_pool)}


def test_recarve_with_inflight_drains_cleanly(tmp_path, monkeypatch):
    rec = twin(tmp_path, monkeypatch, _recarve)
    assert rec["scheduler"]["recarves"] == 1 and rec["counts"]["ok"] >= 2
    assert "contradicts" in rec["errors"][0][1] and "recarve needs" in rec["errors"][1][1]


def _retrace_and_canary(pkg, tmp, mp):
    the_pool, _ = make_pool(pkg, tmp, mp, serve_workers=2)
    the_pool.start()
    try:
        c = admit(pkg, the_pool, "stub-ok", 1)
        assert c.done.wait(15.0)
        digest = the_pool.child_retrace()
        probes = the_pool.run_canary(timeout_s=10.0)
    finally:
        the_pool.stop(timeout_s=15.0)
    return {"digest": digest, "probes": probes}


def test_pool_merged_retrace_and_canary(tmp_path, monkeypatch):
    rec = twin(tmp_path, monkeypatch, _retrace_and_canary)
    assert rec["digest"]["compiles"] == 0 and set(rec["digest"]["workers"]) == {"0", "1"}
    assert rec["probes"][0]["digest"]["plane"] == "aaaaaaaa"


# ---------------------------------------------------------------------------
# stream loss across a worker crash (supervisor-level, stub)
# ---------------------------------------------------------------------------


def _stub_sup(pkg, tmp, mp):
    mp.setenv("STUB_DIR", str(tmp))
    cfg = cfg_for(pkg, tmp)
    queue = pkg.AdmissionQueue(8)
    sup = pkg.WorkerSupervisor(cfg, queue, pkg.Router(cfg),
                               journal_dir=str(tmp / "journals"),
                               child_argv=[sys.executable, STUB],
                               start_timeout_s=15.0, poll_s=0.05, **pkg.device)
    sup.start()
    return sup, queue


def _stream_lost_on_crash(pkg, tmp, mp):
    sup, queue = _stub_sup(pkg, tmp, mp)
    try:
        opened = submit(pkg, queue, "stream-x", "s-000001", op="stream_chunk")
        assert opened.done.wait(15.0) and opened.terminal["status"] == "ok"
        open_n = sup.stats()["worker"]["open_streams"]
        crash = submit(pkg, queue, "stub-crash", "s-000002")
        assert crash.done.wait(30.0) and crash.terminal["status"] == "ok"
        lost_n = sup.stats()["worker"]["lost_streams"]
        lost = submit(pkg, queue, "stream-x", "s-000003", op="stream_chunk")
        assert lost.done.wait(15.0) and "stream_lost" in lost.states()
        fresh = submit(pkg, queue, "stream-x", "s-000004", op="stream_chunk")
        assert fresh.done.wait(15.0) and fresh.terminal["status"] == "ok"
        after = sup.stats()["worker"]["lost_streams"]
    finally:
        sup.stop(timeout_s=10.0)
    return {"n": (open_n, lost_n, after),
            "events": [mask(c.events) for c in (opened, crash, lost, fresh)]}


def test_supervisor_stream_lost_on_crash(tmp_path, monkeypatch):
    assert twin(tmp_path, monkeypatch, _stream_lost_on_crash)["n"] == (1, 1, 0)


def _stream_crash_mid_op(pkg, tmp, mp):
    sup, queue = _stub_sup(pkg, tmp, mp)
    try:
        c = submit(pkg, queue, "stub-crash", "s-000001", op="stream_chunk")
        assert c.done.wait(30.0)
        assert "stream_lost" in c.states() and c.terminal["error_class"] == "stream_lost"
        ok = submit(pkg, queue, "stub-ok", "s-000002")
        assert ok.done.wait(20.0) and ok.terminal["status"] == "ok"
    finally:
        sup.stop(timeout_s=10.0)
    return {"events": [mask(x.events) for x in (c, ok)]}


def test_stream_crash_mid_op_answers_stream_lost(tmp_path, monkeypatch):
    """The JAX case is slow-marked; the twin runs in seconds, in tier-1."""
    twin(tmp_path, monkeypatch, _stream_crash_mid_op)


# ---------------------------------------------------------------------------
# observability plumbing: the relay, window rows, report and top
# ---------------------------------------------------------------------------


def test_telemetry_window_rows_carry_worker_map():
    rows = []
    for tel in (jax_telemetry, telemetry):
        agg = tel.WindowAggregator(window_s=60.0)
        agg.record_request((63, 32, 16384), 0.05, tenant="a", worker=0)
        agg.record_request((63, 32, 16384), 0.06, tenant="a", worker=1)
        agg.record_request((63, 32, 16384), 0.07, tenant="b", worker=1)
        row = agg.roll()
        agg.record_request((63, 32, 16384), 0.05)
        rows.append((row["workers"], "workers" in agg.roll()))
    assert rows[0] == rows[1] == ({"0": 1, "1": 2}, False)


SPAN_DOC = {"kind": "telem", "v": 1, "seq": 1,
            "metrics": {"counters": {"serve.requests": 1.0, "d2h.bytes": 4096.0},
                        "gauges": {"hbm.high_water_bytes": 10.0, "serve.queue_depth": 2.0}},
            "spans_dropped": 2,
            "spans": [{"name": "serve.request", "dur_s": 0.05, "sync_s": 0.0, "depth": 0,
                       "ts": 1000.5, "attrs": {"request": "r1"}},
                      {"name": "associate", "dur_s": 0.01, "sync_s": 0.001, "depth": 1,
                       "parent": "serve.request", "ts": 1000.4}]}


def _fold(obs_mod, tel, met, path, doc, **kw):
    obs_mod.disable()
    obs_mod.configure(path, truncate=True, fence=False, sample_memory=False)
    before = met.registry().snapshot(include_histograms=False)
    tel.fold_telem(doc, **kw)
    delta = met.snapshot_delta(before, met.registry().snapshot(include_histograms=False))
    obs_mod.disable()
    spans = [(r["name"], r.get("parent"), r.get("depth"), r.get("dur_s"),
              r.get("attrs")) for r in events.read_events(path, kinds=[events.KIND_SPAN])]
    return delta, spans


@pytest.mark.parametrize("kw", [dict(child_pid=4242, worker_id=3), dict(),
                                dict(child_pid=7)])
def test_fold_telem_equal_and_tags_spans(tmp_path, kw):
    jx = _fold(jax_obs, jax_telemetry, jax_metrics, str(tmp_path / "jx.jsonl"), SPAN_DOC, **kw)
    pt = _fold(obs, telemetry, metrics, str(tmp_path / "pt.jsonl"), SPAN_DOC, **kw)
    assert pt == jx
    delta, spans = pt
    assert delta["counters"]["worker.telem_messages"] == 1.0
    assert delta["counters"]["worker.telem_spans_dropped"] == 2.0
    assert spans[0][4]["end_ts"] == 1000.5
    if "worker_id" in kw:
        assert spans[0][4]["worker_id"] == 3 and spans[0][4]["worker_pid"] == 4242
    # an unknown wire version folds nothing but its own counter
    for tel, met in ((jax_telemetry, jax_metrics), (telemetry, metrics)):
        before = met.registry().snapshot(include_histograms=False)
        tel.fold_telem({**SPAN_DOC, "v": 99})
        after = met.registry().snapshot(include_histograms=False)
        assert met.snapshot_delta(before, after)["counters"] == {
            "worker.telem_unknown_version": 1.0}


def test_snapshot_delta_and_merge_equal():
    prev = {"counters": {"a": 1.0, "b": 2.0}, "gauges": {"g": 1.0, "hbm.high_water_bytes": 9.0}}
    cur = {"counters": {"a": 1.0, "b": 5.0, "c": 1.0},
           "gauges": {"g": 2.0, "hbm.high_water_bytes": 4.0, "h": 3.0}}
    delta = metrics.snapshot_delta(prev, cur)
    assert delta == jax_metrics.snapshot_delta(prev, cur)
    assert delta == {"counters": {"b": 3.0, "c": 1.0},
                     "gauges": {"g": 2.0, "hbm.high_water_bytes": 4.0, "h": 3.0}}
    regs = []
    for met in (jax_metrics, metrics):
        reg = met.Registry()
        reg.gauge_max("hbm.high_water_bytes", 7.0)
        met.merge_snapshot_delta(delta, reg)
        # a stale high-water line cannot lower the mark
        met.merge_snapshot_delta({"counters": {"b": "x"}, "gauges": {"g": None}}, reg)
        regs.append(reg.snapshot(include_histograms=False))
    assert regs[0] == regs[1]
    assert regs[1]["gauges"]["hbm.high_water_bytes"] == 7.0


def _relay_docs(obs_mod, tel, met):
    obs_mod.disable()
    relay = tel.ChildRelay()
    obs_mod.configure_sink(relay.sink)
    try:
        relay.collect()  # baseline: whatever this process booked earlier
        first = relay.collect()
        with obs_mod.span("serve.request", request="r1"):
            with obs_mod.span("associate"):
                obs_mod.count("serve.requests")
        obs_mod.count("d2h.bytes", 4096.0)
        obs_mod.gauge("serve.queue_depth", 2.0)
        doc = relay.collect()
        idle = relay.collect()
    finally:
        obs_mod.disable()
    for row in doc.get("spans", ()):
        row.pop("ts")
        row["dur_s"] = row["sync_s"] = 0.0
    return first, doc, idle


def test_relay_sink_and_child_relay_equal():
    jx, pt = _relay_docs(jax_obs, jax_telemetry, jax_metrics), \
        _relay_docs(obs, telemetry, metrics)
    assert pt == jx
    first, doc, idle = pt
    assert first is None and idle is None
    assert doc["kind"] == "telem" and doc["v"] == 1
    assert doc["metrics"]["counters"] == {"serve.requests": 1.0, "d2h.bytes": 4096.0}
    assert [s["name"] for s in doc["spans"]] == ["associate", "serve.request"]
    # a burst costs counted drops, never unbounded memory
    sink = telemetry.RelaySink(cap=2)
    for i in range(5):
        sink.emit(events.KIND_SPAN, {"name": f"s{i}", "dur_s": 0.0})
    sink.emit("metrics", {"counters": {}})
    spans, dropped = sink.drain()
    assert [s["name"] for s in spans] == ["s3", "s4"] and dropped == 3


def _pool_events(pkg, tmp, mp, obs_mod, tel):
    """A stub pool run with obs armed: the file the report renders."""
    path = str(tmp / "events.jsonl")
    obs_mod.disable()
    obs_mod.configure(path, truncate=True, meta={"tool": "serve", "config": "pool"})
    agg = tel.WindowAggregator(window_s=60.0)
    tel.install(agg)
    try:
        the_pool, _ = make_pool(pkg, tmp, mp, serve_workers=2,
                                serve_tenants="heavy:3,light:1")
        the_pool._pause.set()
        the_pool.start()
        try:
            clients = [admit(pkg, the_pool, "stub-ok", i,
                             tenant="heavy" if i % 4 else "light") for i in range(8)]
            the_pool._pause.clear()
            for c in clients:
                assert c.done.wait(15.0) and c.terminal["status"] == "ok"
            assert the_pool.wait_idle(10.0)
            stats = the_pool.stats()
        finally:
            the_pool.stop(timeout_s=15.0)
        obs_mod.emit_event(events.KIND_TELEMETRY, agg.roll())
        obs_mod.flush_metrics()
    finally:
        tel.install(None)
        obs_mod.disable()
    return path, stats


def test_report_and_top_render_either_packages_pool(tmp_path, monkeypatch):
    docs = {}
    for name, obs_mod, tel in (("jax", jax_obs, jax_telemetry), ("torch", obs, telemetry)):
        tmp = tmp_path / name
        tmp.mkdir()
        with monkeypatch.context() as mp:
            docs[name] = _pool_events(PKGS[name], tmp, mp, obs_mod, tel)
    for name, (path, stats) in docs.items():
        mine, theirs = report.RunData(path), jax_report.RunData(path)
        text = report.render_report(mine)
        assert text == jax_report.render_report(theirs), name
        assert report.render_pool(mine) == jax_report.render_pool(theirs)
        assert "worker 0: completions" in text and "worker 1: completions" in text
        assert "heavy 6 (75%)" in text and "light 2 (25%)" in text
        frame = {"config": "pool", "uptime_s": 12.0, "queue": {"depth": 0, "capacity": 8},
                 "worker": stats["worker"], "pool": stats["pool"]}
        assert top.render_top(frame, now=1040.0) == jax_top.render_top(frame, now=1040.0)
        assert "pool: carve 2 | alive 2/2" in top.render_top(frame, now=1040.0)


def test_report_renders_pool_lines():
    class _Run:
        _counters = {"serve.pool.dispatched": 10, "serve.pool.affinity_hits": 9,
                     "serve.pool.affinity_misses": 1, "serve.pool.crash_reroutes": 1}
        telemetry_rows = [{"workers": {"0": 4, "1": 6},
                           "tenants": {"heavy": {"requests": 7}, "light": {"requests": 3}}}]

    class _Empty:
        _counters = {}
        telemetry_rows = []

    lines = report.render_pool(_Run())
    assert lines == jax_report.render_pool(_Run())
    assert "affinity 9/10 warm (90%)" in "\n".join(lines)
    assert report.render_pool(_Empty()) == jax_report.render_pool(_Empty()) == []


def test_top_renders_pool_panel():
    stats = {
        "config": "pool", "uptime_s": 12.0, "queue": {"depth": 0, "capacity": 8},
        "worker": {"isolated": True, "pool": 2, "alive": 2, "spawns": 2, "respawns": 0,
                   "crashes": 0, "inflight_width": 0},
        "pool": {
            "carve": "2x4",
            "workers": [
                {"worker_id": 0, "pid": 11, "hb_age_s": 0.1, "retired": False,
                 "feed_depth": 0, "dispatched": 4, "warm_buckets": 3,
                 "consecutive_respawns": 0, "open_streams": 1, "lost_streams": 0},
                {"worker_id": 1, "pid": 12, "hb_age_s": 0.2, "retired": True,
                 "feed_depth": 0, "dispatched": 6, "warm_buckets": 3,
                 "consecutive_respawns": 2, "open_streams": 0, "lost_streams": 1}],
            "scheduler": {"dispatched": 10, "affinity_hits": 9, "affinity_misses": 1,
                          "crash_reroutes": 1, "recarves": 0},
            "tenants": {"heavy": {"dispatched": 7, "weight": 3.0},
                        "light": {"dispatched": 3, "weight": 1.0, "quota": 4,
                                  "queued": 0}}},
    }
    out = top.render_top(stats, now=50.0)
    assert out == jax_top.render_top(stats, now=50.0)
    assert "worker 1: RETIRED" in out
    assert "dequeue share: heavy 7 (w=3.0) | light 3 (w=1.0, quota 4)" in out
    solo = {k: v for k, v in stats.items() if k != "pool"}
    assert top.render_top(solo, now=50.0) == jax_top.render_top(solo, now=50.0)


@pytest.mark.parametrize("line", ['{"op": "recarve", "workers": 2, "carve": "2x4"}',
                                  '{"op": "recarve", "workers": "two"}',
                                  '{"op": "recarve", "carve": 4}'])
def test_protocol_recarve_grammar(line):
    def parse(proto):
        try:
            return ("ok", proto.parse_line(line))
        except proto.ProtocolError as e:
            return ("ProtocolError", str(e))

    got = parse(protocol)
    assert got == parse(PKGS["jax"].protocol)
    assert got[0] == ("ok" if '"2x4"' in line else "ProtocolError")


# ---------------------------------------------------------------------------
# a real two-slice pool, on the CPU
# ---------------------------------------------------------------------------


def test_real_two_worker_pool_serves_the_one_shot_digests(tmp_path, monkeypatch):
    """Two real CPU slices serve a weighted-tenant burst over two scenes:
    both slices dispatch, every answer carries the one-shot run's digest."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    root = str(tmp_path / "data")
    scenes = {"pl-a": dict(num_boxes=3, num_frames=6, image_hw=(48, 64), spacing=0.08,
                           seed=11),
              "pl-b": dict(num_boxes=4, num_frames=6, image_hw=(48, 64), spacing=0.07,
                           seed=12)}
    for name, spec in scenes.items():
        write_scannet_layout(make_scene(**spec), root, name)
    kw = dict(step=1, distance_threshold=0.05, mask_pad_multiple=32)
    ref = run_pipeline(load_config("scannet", data_root=root, config_name="ref", **kw),
                       sorted(scenes), steps=("cluster",), resume=False, journal=False,
                       ledger=False, device="cpu")
    want = {s.seq_name: s.digest["artifact"] for s in ref.scenes}
    cfg = load_config("scannet", data_root=root, config_name="pl", serve_workers=2,
                      serve_tenants="heavy:3,light:1", worker_heartbeat_s=30.0,
                      retry_backoff_s=0.1, **kw)
    the_pool = pool.WorkerPool(cfg, AdmissionQueue(32), Router(cfg),
                               journal_dir=str(tmp_path / "journals"),
                               warm_scenes=tuple(scenes), start_timeout_s=120.0,
                               poll_s=0.1, device="cpu")
    try:
        the_pool.start()
        names = sorted(scenes)
        clients = [admit(PKGS["torch"], the_pool, names[i % 2], i,
                         tenant="heavy" if i % 4 else "light") for i in range(8)]
        for c in clients:
            assert c.done.wait(120.0), "request never answered"
            assert c.terminal["status"] == "ok", c.terminal
        for i, c in enumerate(clients):
            assert c.terminal["digest"]["artifact"] == want[names[i % 2]]
        assert the_pool.wait_idle(10.0)
        stats = the_pool.stats()
        workers = stats["pool"]["workers"]
        assert len(workers) == 2 and all(w["alive"] for w in workers)
        assert all(w["dispatched"] for w in workers), "a slice never dispatched"
        assert stats["pool"]["scheduler"]["dispatched"] == 8
        assert stats["pool"]["tenants"]["heavy"]["dispatched"] == 6
        assert the_pool.child_retrace() == {}
    finally:
        the_pool.stop(timeout_s=60.0)
    for w in the_pool.stats()["pool"]["workers"]:
        assert w["cuda"] == {"build_s": {}, "launches": {}, "max_memory_allocated": None}
