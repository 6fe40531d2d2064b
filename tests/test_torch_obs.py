"""The port's obs core (``maskclustering_tpu_torch/obs``) against the JAX
package's ``maskclustering_tpu/obs``, on the CPU.

The same sequence of calls goes through both packages and what comes out
is compared, wall-clock fields (``ts``, ``pid``, ``t0``, durations) aside:

- the metrics registry: counters, gauges, high-water gauges, histograms and
  transfer accounting give equal snapshots, and ``snapshot_delta``
  agrees;
- spans and metrics flushes through ``configure`` give equal event rows,
  and a JSONL file written by either package is read by the other, torn and
  unknown-version lines counted alike;
- the flight recorder's ring and dump format;
- the shape-bucket bookkeeping of ``utils/compile_cache``;
- the telemetry plane: ``WindowAggregator.roll()`` and ``snapshot()`` under
  the same recorded requests with the clock monkeypatched;
- ``slo.validate_spec`` errors and ``evaluate`` results on a table of
  specs and snapshots;
- the port's own rules: no device sync when obs is off, no device-memory
  gauge on the CPU, and ``xprof_dir`` refused with its ROADMAP item.
"""

import copy
import json
import os
import time

import pytest
import torch

from maskclustering_tpu import obs as jax_obs
from maskclustering_tpu.obs import events as jax_events
from maskclustering_tpu.obs import flight as jax_flight
from maskclustering_tpu.obs import metrics as jax_metrics
from maskclustering_tpu.obs import slo as jax_slo
from maskclustering_tpu.obs import telemetry as jax_telemetry
from maskclustering_tpu.utils import compile_cache as jax_compile_cache
from maskclustering_tpu_torch import obs
from maskclustering_tpu_torch.obs import events, flight, metrics, slo, telemetry
from maskclustering_tpu_torch.utils import compile_cache

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

# per-row fields that depend on the wall clock or the process
VOLATILE = ("ts", "pid", "t0", "dur_s", "sync_s", "mem", "t")


def _strip(row):
    return {k: v for k, v in row.items() if k not in VOLATILE}


@pytest.fixture
def fresh(tmp_path):
    """Both packages' process-global obs state reset around a test."""
    for pkg, reg in ((jax_obs, jax_metrics), (obs, metrics)):
        pkg.disable()
        reg.registry().reset()
    yield
    for pkg, reg in ((jax_obs, jax_metrics), (obs, metrics)):
        pkg.disable()
        reg.registry().reset()


def _drive_metrics(m):
    m.count("serve.requests")
    m.count("serve.requests", 2.0)
    m.count_transfer("d2h", 4096, "post.drain")
    m.count_transfer("h2d", 1 << 20, "feed")
    m.gauge("serve.queue_depth", 3)
    m.gauge("serve.queue_depth", 1)
    m.gauge_max("hbm.high_water_bytes", 10.0)
    m.gauge_max("hbm.high_water_bytes", 7.0)
    for i in range(5000):  # past the 4096 reservoir cap: stride decimation
        m.observe("span.serve.request.s", (i * 37 % 101) / 10.0)
    m.observe("span.graph.s", 0.25)


def test_registry_snapshots_equal(fresh):
    _drive_metrics(jax_metrics)
    _drive_metrics(metrics)
    a = jax_metrics.registry().snapshot()
    b = metrics.registry().snapshot()
    assert a == b
    assert a["counters"]["d2h.bytes"] == 4096.0
    assert b["gauges"]["hbm.high_water_bytes"] == 10.0
    assert metrics.registry().snapshot(include_histograms=False) == \
        jax_metrics.registry().snapshot(include_histograms=False)
    h_a = jax_metrics.registry().histogram("span.serve.request.s")
    h_b = metrics.registry().histogram("span.serve.request.s")
    assert h_a.values == h_b.values and h_a.percentile(90) == h_b.percentile(90)


def test_snapshot_delta_equal(fresh):
    prev = {"counters": {"a": 1.0, "b": 2.0}, "gauges": {"g": 1.0, "x.high_water": 5.0}}
    cur = {"counters": {"a": 4.0, "b": 2.0, "c": 1.0},
           "gauges": {"g": 2.0, "x.high_water": 3.0}}
    d = metrics.snapshot_delta(prev, cur)
    assert d == jax_metrics.snapshot_delta(prev, cur)
    assert d == {"counters": {"a": 3.0, "c": 1.0},
                 "gauges": {"g": 2.0, "x.high_water": 3.0}}


@pytest.mark.parametrize("q", [0, 1, 50, 95, 99.9, 100])
def test_percentile_is_the_report_rule(q):
    from maskclustering_tpu.obs.report import percentile as jax_percentile

    vals = sorted([0.5, 0.1, 3.0, 2.0, 2.0, 7.5, 0.0])
    assert metrics.percentile(vals, q) == jax_percentile(vals, q)
    assert metrics.percentile([], q) == jax_percentile([], q) == 0.0


def _drive_spans(pkg, path):
    pkg.configure(str(path), truncate=True, meta={"tool": "test"})
    with pkg.span("outer", scene="s0", n=3) as sp:
        sp.set(f_pad=8)
        with pkg.span("inner", scene="s0"):
            pass
    pkg.record_span("post.claims", 0.125, parent="outer", scene="s0")

    @pkg.traced("decorated", kind="fn")
    def fn(x):
        return x + 1

    assert fn(1) == 2
    with pytest.raises(ValueError):
        with pkg.span("failing"):
            raise ValueError("boom")
    pkg.count("serve.requests_ok")
    pkg.gauge("serve.queue_depth", 2.0)
    pkg.emit_event("telemetry", {"window": 0, "requests": 1})
    pkg.flush_metrics()
    pkg.disable()


def _comparable(rows):
    out = []
    for r in rows:
        r = _strip(r)
        if r.get("kind") == "metrics":
            snap = copy.deepcopy(r["metrics"])
            # the span histograms hold wall durations: keep their counts
            snap["histograms"] = {k: v["count"] for k, v in snap["histograms"].items()}
            r["metrics"] = snap
        out.append(r)
    return out


def test_span_events_equal_and_cross_read(fresh, tmp_path):
    pa, pb = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    _drive_spans(jax_obs, pa)
    _drive_spans(obs, pb)
    rows_a = list(jax_events.read_events(str(pa)))
    rows_b = list(events.read_events(str(pb)))
    # the explicit flush, then disable()'s final one
    assert [r["kind"] for r in rows_b] == ["meta", "span", "span", "span", "span", "span",
                                           "telemetry", "metrics", "metrics"]
    assert _comparable(rows_a) == _comparable(rows_b)
    # each package reads the other's file, row for row
    assert list(jax_events.read_events(str(pb))) == rows_b
    assert list(events.read_events(str(pa))) == rows_a
    assert list(events.read_events(str(pa), kinds=["span"])) == \
        list(jax_events.read_events(str(pa), kinds=["span"]))


def test_torn_and_unknown_version_lines_counted_alike(fresh, tmp_path):
    path = tmp_path / "mixed.jsonl"
    sink = events.EventSink(str(path))
    sink.emit("span", {"name": "a", "dur_s": 0.1})
    sink.close()
    with open(path, "a") as f:
        f.write(json.dumps({"v": 99, "kind": "span"}) + "\n")
        f.write("[1, 2]\n")
        f.write('{"v": 1, "kind": "span", "name": "torn"')
    sa, sb = jax_events.ReadStats(), events.ReadStats()
    ra = list(jax_events.read_events(str(path), stats=sa))
    rb = list(events.read_events(str(path), stats=sb))
    assert ra == rb and len(rb) == 1
    assert (sa.torn, sa.unknown_version, sa.total) == (sb.torn, sb.unknown_version, sb.total) \
        == (1, 2, 4)
    assert sa.describe() == sb.describe()


def test_flight_ring_and_dump_format_equal(fresh, tmp_path):
    dumps = {}
    for name, fl in (("jax", jax_flight), ("port", flight)):
        rec = fl.FlightRecorder(capacity=8)
        rec.record(fl.KIND_ADMIT, event="admit", request="r-000001", scene="s")
        rec.record_span("serve.request", 0.5, 0.25, {"request": "r-000001"})
        for i in range(8):  # the ring keeps the last 8
            rec.record(fl.KIND_FAULT, what="injected", seam="device", i=i)
        rec.arm(str(tmp_path / name))
        dumps[name] = rec.dump("watchdog", extra_rows=[{"kind": fl.KIND_CHILD_TELEM, "n": 1}])
        assert os.path.basename(dumps[name]) == f"flight-{os.getpid()}-01-watchdog.jsonl"
    meta_a, rows_a = jax_flight.read_dump(dumps["port"])
    meta_b, rows_b = flight.read_dump(dumps["jax"])
    assert _strip(meta_a) == _strip(meta_b) and meta_a["events"] == 9
    assert [_strip(r) for r in rows_a] == [_strip(r) for r in rows_b]
    assert [r["i"] for r in rows_b[:8]] == list(range(8))
    assert jax_flight.render_dump(meta_a, rows_a)[0] == flight.render_dump(meta_a, rows_a)[0]
    # unarmed, a dump is a counted no-op in both
    assert flight.FlightRecorder().dump("capacity") is None


def test_shape_bucket_bookkeeping_equal(fresh):
    jax_compile_cache.reset_shape_buckets()
    compile_cache.reset_shape_buckets()
    try:
        seq = [("scene", 63, 8, 8192), ("masks", 32), ("scene", 63, 8, 8192),
               ("post.nodestats", 64, 32, 8, 8192, 65), ("scene", 127, 16, 8192),
               ("stream", 64, 32, 8192)]
        got = [(jax_compile_cache.record_shape_bucket(*k),
                compile_cache.record_shape_bucket(*k)) for k in seq]
        assert all(a == b for a, b in got) and [b for _, b in got] == \
            [True, True, False, True, True, True]
        assert compile_cache.seen_shape_buckets() == jax_compile_cache.seen_shape_buckets()
        assert compile_cache.seen_scene_buckets() == jax_compile_cache.seen_scene_buckets() \
            == {(63, 8, 8192), (127, 16, 8192)}
        keys = ("compile_cache.bucket_hit", "compile_cache.bucket_new")
        ca = jax_metrics.registry().snapshot()["counters"]
        cb = metrics.registry().snapshot()["counters"]
        assert {k: ca[k] for k in keys} == {k: cb[k] for k in keys}
    finally:
        jax_compile_cache.reset_shape_buckets()
        compile_cache.reset_shape_buckets()


@pytest.mark.parametrize("cfg_kw,shape", [
    ({}, (10, 5000, 40)),
    ({"frame_pad_multiple": 8}, (8, 8192, 63)),
    ({"frame_pad_multiple": 8}, (9, 8193, 64)),
    ({"point_chunk": 2048}, (33, 100000, 300)),
])
def test_scene_bucket_equal(cfg_kw, shape):
    from maskclustering_tpu.config import load_config as jax_load_config
    from maskclustering_tpu_torch.config import load_config

    a = jax_compile_cache.scene_bucket(jax_load_config("scannet", **cfg_kw), *shape)
    b = compile_cache.scene_bucket(load_config("scannet", **cfg_kw), *shape)
    assert a == b


def _drive_aggregator(tel, m, clock):
    agg = tel.WindowAggregator(window_s=2.0, ring=3)
    agg.rebase()
    rows = []
    for w in range(4):
        for i in range(3):
            tel.WindowAggregator.record_request(
                agg, (63, 8, 8192) if i else (127, 16, 8192), 0.5 + w + 0.1 * i,
                tenant="t1" if i % 2 else "", status=("ok", "failed", "deadline")[i])
            agg.record_queue_wait(0.01 * (i + 1), tenant="t1" if i % 2 else "")
        agg.record_reject("t2")
        m.count("serve.requests", 3)
        m.count("serve.admission.rejects.queue_full")
        m.count("device.seconds", 0.5)
        clock[0] += 2.0
        rows.append(agg.roll())
    return rows, agg.snapshot()


def test_window_aggregator_roll_and_snapshot_equal(fresh, monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    rows_a, snap_a = _drive_aggregator(jax_telemetry, jax_metrics, clock)
    clock[0] = 1000.0
    rows_b, snap_b = _drive_aggregator(telemetry, metrics, clock)
    assert rows_a == rows_b
    assert snap_a == snap_b
    assert snap_b["windows"] and len(snap_b["windows"]) == 3  # the ring bound


def test_record_helpers_route_to_installed_aggregator(fresh, monkeypatch):
    clock = [50.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    out = []
    for tel in (jax_telemetry, telemetry):
        clock[0] = 50.0
        agg = tel.WindowAggregator(window_s=1.0)
        tel.install(agg)
        try:
            assert tel.installed() is agg
            tel.record_request((63, 8, 8192), 1.5, tenant="a", status="ok")
            tel.record_reject("a")
            tel.record_crash("a")
            clock[0] += 1.0
            out.append((agg.roll(), agg.snapshot()))
        finally:
            tel.install(None)
        assert tel.installed() is None
    assert out[0] == out[1]


SPECS = [
    None,  # the canned default
    {"objectives": [{"name": "lat", "kind": "latency_p95", "threshold": 1.0}]},
    {"windows": {"short": 2, "long": 4},
     "objectives": [{"name": "err", "kind": "error_rate", "threshold": 0.1, "tenant": "t1"},
                    {"name": "lat", "kind": "latency_p50", "threshold": 0.5,
                     "bucket": "63x8x8192"},
                    {"name": "wait", "kind": "queue_wait_p95", "threshold": 0.02},
                    {"name": "crash", "kind": "crash_count", "threshold": 0}]},
    # invalid ones: each error message must match
    [],
    {"v": 2, "objectives": []},
    {"windows": {"short": 3, "long": 2}, "objectives": [{}]},
    {"objectives": []},
    {"objectives": ["x"]},
    {"objectives": [{"kind": "error_rate", "threshold": 0}]},
    {"objectives": [{"name": "a", "kind": "error_rate", "threshold": 0},
                    {"name": "a", "kind": "error_rate", "threshold": 0}]},
    {"objectives": [{"name": "a", "kind": "p99", "threshold": 0}]},
    {"objectives": [{"name": "a", "kind": "error_rate", "threshold": -1}]},
    {"objectives": [{"name": "a", "kind": "error_rate", "threshold": 0, "tenant": ""}]},
]


def _snapshot(n_windows: int, bad: int):
    wins = []
    for w in range(n_windows):
        wins.append({"window": w, "requests": 4, "errors": bad if w % 2 else 0,
                     "latency": {"all": {"count": 4, "p50_s": 0.3 + w, "p95_s": 0.9 + w,
                                         "max_s": 1.0 + w},
                                 "63x8x8192": {"count": 2, "p50_s": 0.4, "p95_s": 0.6,
                                               "max_s": 0.7}},
                     "queue_wait": {"count": 4, "p50_s": 0.01, "p95_s": 0.03, "max_s": 0.04},
                     "status": {"ok": 4 - bad, "failed": bad},
                     "crashes": w % 3 == 2, "post_warm_compiles": 0, "drift": 0,
                     "tenants": {"t1": {"requests": 2, "errors": bad, "status": {"failed": bad}}}})
    return {"windows": wins}


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_slo_validate_and_evaluate_equal(i):
    spec = SPECS[i]
    if spec is None:
        norm_a, norm_b = jax_slo.load_spec(None), slo.load_spec(None)
    else:
        try:
            norm_a = jax_slo.validate_spec(copy.deepcopy(spec))
        except ValueError as e:
            with pytest.raises(ValueError) as info:
                slo.validate_spec(copy.deepcopy(spec))
            assert str(info.value) == str(e)
            return
        norm_b = slo.validate_spec(copy.deepcopy(spec))
    assert norm_a == norm_b
    for snap in ({}, {"windows": []}, _snapshot(1, 0), _snapshot(6, 1), _snapshot(6, 3)):
        ra, rb = jax_slo.evaluate(norm_a, snap), slo.evaluate(norm_b, snap)
        assert ra == rb
        assert jax_slo.violated(ra) == slo.violated(rb)
        assert jax_slo.render_result(ra) == slo.render_result(rb)


def test_slo_cli_over_an_events_file(fresh, tmp_path):
    path = tmp_path / "ev.jsonl"
    sink = events.EventSink(str(path))
    for row in _snapshot(3, 2)["windows"]:
        sink.emit(events.KIND_TELEMETRY, row)
    sink.close()
    assert slo.snapshot_from_events(str(path)) == jax_slo.snapshot_from_events(str(path))
    assert slo.main(["--events", str(path), "--check"]) == \
        jax_slo.main(["--events", str(path), "--check"])


def test_disabled_obs_never_syncs_the_device(fresh, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("a device sync with obs off")

    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    assert not obs.enabled()
    t = torch.ones(3)
    with obs.span("graph", scene="s") as sp:
        assert sp.sync(t) is t
    # a timing-only tracer (no sink) never fences either
    assert obs.Tracer(sink=None).span("x").sync(t) is t


def test_fenced_span_charges_sync_time(fresh, tmp_path):
    obs.configure(str(tmp_path / "e.jsonl"), truncate=True)
    with obs.span("stage") as sp:
        out = sp.sync({"a": torch.ones(2), "b": [torch.zeros(1)]})
    assert set(out) == {"a", "b"} and sp.sync_s > 0
    obs.disable()
    counters = metrics.registry().snapshot()["counters"]
    assert counters["device.seconds"] > 0


def test_device_memory_gauge_is_none_on_the_cpu(fresh):
    metrics.set_device("cpu")
    try:
        assert metrics.sample_hbm() is None
    finally:
        metrics.set_device(None)
    if not torch.cuda.is_available():
        assert metrics.sample_hbm() is None
    assert "hbm.bytes_in_use" not in metrics.registry().snapshot()["gauges"]


def test_xprof_capture_names_its_item(fresh, tmp_path):
    """``configure(xprof_dir=...)`` is ported: it arms the span-triggered
    capture (``obs/xprof.py``), whose first ``graph`` span writes a trace."""
    obs.configure(str(tmp_path / "e.jsonl"), xprof_dir=str(tmp_path / "x"),
                  xprof_spans=("graph",))
    assert obs.enabled() and obs.get_tracer().xprof is not None
    with obs.span("graph"):
        pass
    obs.disable()
    assert os.listdir(str(tmp_path / "x")) == ["graph-0"]
