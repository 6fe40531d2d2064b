"""The port's run report, perf ledger, request trace and live top
(``maskclustering_tpu_torch/obs/{report,ledger,trace,top}.py``) against the
JAX package's, on the CPU.

- One small scan written to disk goes once through each package's
  ``run_pipeline`` with ``obs_events`` and a report: each package's
  ``RunData`` reads either events file to an equal ``summary()`` and an
  equal ``render_report`` text; the two files book the same stage names,
  in the same order, with the same nesting; the port's report embeds the
  digest and appends one ledger row, to the path it was given.
- Ledger rows that the port wrote are read by the JAX ``read_ledger``, and
  the ``--regress`` gate gives the same verdict and lines in both packages
  over one table of rows and baselines, the fenced dimensions included.
  The port's default ledger file is not ``PERF_LEDGER.jsonl``.
- ``assemble_trace`` gives equal documents in both packages over one
  events file, journal and flight dump; ``render_top`` gives an equal frame
  over one stats document with ``now`` fixed.
- With obs disarmed, ``run_scene`` books no events and its ``timings`` keep
  their keys; armed, ``pipeline.host_sync`` equals ``timings["pulls"]``.
"""

import json
import os

import pytest
import torch

from maskclustering_tpu import obs as jax_obs
from maskclustering_tpu.config import load_config as jax_load_config
from maskclustering_tpu.obs import ledger as jax_ledger
from maskclustering_tpu.obs import report as jax_report
from maskclustering_tpu.obs import top as jax_top
from maskclustering_tpu.obs import trace as jax_trace
from maskclustering_tpu.run import run_pipeline as jax_run_pipeline
from maskclustering_tpu.utils.synthetic import make_scene, write_scannet_layout
from maskclustering_tpu_torch import obs
from maskclustering_tpu_torch.config import load_config
from maskclustering_tpu_torch.obs import events, flight, ledger, metrics, report, top, trace
from maskclustering_tpu_torch.run import run_pipeline
from maskclustering_tpu_torch.utils import faults

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

SCAN = "scene0000_00"
KW = dict(step=1, distance_threshold=0.05, mask_pad_multiple=32)
STAGES = ("associate", "graph", "cluster", "postprocess")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("obs_runs"))
    write_scannet_layout(make_scene(num_boxes=3, num_frames=10, image_hw=(60, 80), seed=60,
                                    spacing=0.05), root, SCAN)
    out = {"root": root}
    for pkg in (jax_obs, obs):
        pkg.disable()
    jax_cfg = jax_load_config("scannet").replace(data_root=root, config_name="jx", **KW)
    out["jx_report"] = jax_run_pipeline(
        jax_cfg, [SCAN], steps=("cluster", "eval_ca"), resume=False, journal=False,
        obs_events=os.path.join(root, "jx_events.jsonl"),
        report_path=os.path.join(root, "jx.json"),
        ledger_path=os.path.join(root, "jx_ledger.jsonl"))
    out["pt_report"] = run_pipeline(
        load_config("scannet", data_root=root, config_name="pt", **KW), [SCAN],
        steps=("cluster", "eval_ca"), resume=False, journal=False,
        obs_events=os.path.join(root, "pt_events.jsonl"),
        report_path=os.path.join(root, "pt.json"),
        ledger_path=os.path.join(root, "pt_ledger.jsonl"), device="cpu")
    assert not obs.enabled() and not jax_obs.enabled()
    return out


def _no_path(summary):
    return {k: v for k, v in summary.items() if k != "events"}


@pytest.mark.parametrize("writer", ["jx", "pt"])
def test_each_package_reads_the_others_events(runs, writer):
    path = os.path.join(runs["root"], f"{writer}_events.jsonl")
    mine, theirs = report.RunData(path), jax_report.RunData(path)
    assert _no_path(mine.summary()) == _no_path(theirs.summary())
    assert report.render_report(mine) == jax_report.render_report(theirs)
    assert report.render_diff(mine, mine) == jax_report.render_diff(theirs, theirs)


def test_stage_names_order_and_nesting_equal(runs):
    def skeleton(path):
        rows = events.read_events(path, kinds=[events.KIND_SPAN])
        return [(r["name"], r.get("parent"), r.get("depth")) for r in rows]

    jx = skeleton(os.path.join(runs["root"], "jx_events.jsonl"))
    pt = skeleton(os.path.join(runs["root"], "pt_events.jsonl"))
    assert pt == jx
    names = [n for n, _, _ in pt]
    assert [n for n in names if n in STAGES] == list(STAGES)
    parents = {n: p for n, p, _ in pt}
    assert parents["cluster.solve"] == "cluster" and parents["post.claims"] == "postprocess"
    assert parents["post.claims.kernel"] == "postprocess"


def test_run_report_digest_and_ledger_row(runs):
    rep = runs["pt_report"]
    assert set(STAGES) <= set(rep.obs["stages"])
    assert all(rep.obs["stages"][s]["count"] == 1 for s in STAGES)
    # the port's own pulls (19 on the device rung), where JAX books one
    assert rep.obs["counters"]["pipeline.host_sync"] == 19
    assert runs["jx_report"].obs["counters"]["pipeline.host_sync"] == 1
    with open(os.path.join(runs["root"], "pt.json")) as fh:
        assert json.load(fh)["obs"] == rep.obs
    rows = {p: jax_ledger.read_ledger(os.path.join(runs["root"], f"{p}_ledger.jsonl"))
            for p in ("jx", "pt")}
    assert len(rows["pt"]) == len(rows["jx"]) == 1
    pt, jx = rows["pt"][0], rows["jx"][0]
    assert pt["tool"] == "run" and set(pt) == set(jx)
    for key in ("digest", "digest_coord", "count_dtype", "plane_dtype", "point_shards",
                "streaming_chunk", "postprocess_path", "scenes_ok", "metric", "unit"):
        assert pt[key] == jx[key], key
    assert list(pt["stages"]) == list(jx["stages"])


def test_default_ledger_path_is_not_the_drivers(monkeypatch, tmp_path):
    monkeypatch.delenv("MCT_PERF_LEDGER", raising=False)
    assert ledger.default_ledger_path() == "PERF_LEDGER_TORCH.jsonl"
    assert jax_ledger.default_ledger_path() == "PERF_LEDGER.jsonl"
    monkeypatch.setenv("MCT_PERF_LEDGER", str(tmp_path / "l.jsonl"))
    assert ledger.default_ledger_path() == str(tmp_path / "l.jsonl")


def _base_run_row(value, **kw):
    row = {"tool": "run", "metric": "run s/scene (median of ok scenes)", "value": value,
           "unit": "s/scene", "stages": {"associate": value / 4, "postprocess": value / 2}}
    row.update(kw)
    return row


# (ledger rows, baseline doc): every fence both ways, knob and stage
# attribution, the tool fence and the metric-less fallback
GATES = [
    ([_base_run_row(1.0)], _base_run_row(1.0)),
    ([_base_run_row(1.0), _base_run_row(1.3)], _base_run_row(1.0)),
    ([_base_run_row(1.1, count_dtype="int8", digest="aa", digest_coord="c1")],
     _base_run_row(1.0, digest="bb", digest_coord="c1")),
    ([_base_run_row(2.0, retries=2, degradations=1)], _base_run_row(1.0)),
    ([_base_run_row(1.0), _base_run_row(5.0, canary_drift=3)], _base_run_row(1.0)),
    ([_base_run_row(5.0, canary_drift=1)], _base_run_row(1.0, canary_drift=2)),
    ([{"tool": "serve", "metric": "serve s/request (p50)", "value": 0.5,
       "tenants": {"a": {}}}], {"tool": "serve", "metric": "serve s/request (p50)",
                                "value": 0.4}),
    ([{"tool": "serve", "metric": "serve s/request (p50)", "value": 0.5,
       "batch_occupancy": 2.0}, {"tool": "serve", "metric": "serve s/request (p50)",
                                 "value": 0.45, "batch_occupancy": 2.5}],
     {"tool": "serve", "metric": "serve s/request (p50)", "value": 0.4,
      "batch_occupancy": 1.5}),
    ([{"tool": "serve", "metric": "serve s/request (p50)", "value": 0.9,
       "streams_resumed": 1}], {"tool": "serve", "metric": "serve s/request (p50)",
                                "value": 0.4}),
    ([_base_run_row(1.0), {"tool": "tier1", "metric": "tier1 wall s (not-slow suite)",
                           "value": 500.0}], {"value": 0.9}),
    ([_base_run_row(1.0, retrace_compiles=3, retrace_repeats=1)],
     _base_run_row(0.95, retrace_compiles=1)),
]


@pytest.mark.parametrize("i", range(len(GATES)))
def test_regress_gate_equal_over_port_written_rows(i, tmp_path):
    rows, base = GATES[i]
    path = str(tmp_path / "ledger.jsonl")
    for row in rows:
        assert ledger.append_row(path, dict(row, git="abc1234"))
    base_path = str(tmp_path / "base.json")
    with open(base_path, "w") as fh:
        json.dump(base, fh)
    read = jax_ledger.read_ledger(path)
    assert [{k: v for k, v in r.items() if k not in ("ts", "pid")} for r in read] == \
        [dict(r, v=1, git="abc1234") for r in rows]
    mine = report._regress_eval(path, base_path, 0.15)
    theirs = jax_report._regress_eval(path, base_path, 0.15)
    assert mine[:2] == theirs[:2]
    assert mine[2]["ok"] == theirs[2]["ok"]
    assert ledger.check_regression(read[-1], base) == \
        jax_ledger.check_regression(read[-1], base)
    for dim in ("tenant_dimension", "sentinel_dimension", "batch_dimension",
                "durability_dimension"):
        assert [getattr(ledger, dim)(r) for r in read + [base]] == \
            [getattr(jax_ledger, dim)(r) for r in read + [base]]


def test_report_cli_history_regress_and_cost(runs, tmp_path, capsys):
    led = os.path.join(runs["root"], "pt_ledger.jsonl")
    ev = os.path.join(runs["root"], "pt_events.jsonl")
    assert report.main([ev]) == 0
    assert "postprocess" in capsys.readouterr().out
    assert report.main(["--history", "--ledger", led]) == 0
    assert "(1 rows)" in capsys.readouterr().out
    row = jax_ledger.read_ledger(led)[0]
    for scale, rc in ((1.0, 0), (0.5, 2)):
        base = str(tmp_path / f"base{scale}.json")
        with open(base, "w") as fh:
            json.dump(dict(row, value=row["value"] * scale), fh)
        assert report.main(["--ledger", led, "--regress", base]) == rc
        assert jax_report.main(["--ledger", led, "--regress", base]) == rc
    # --cost (ported: the cost observatory's census, live here)
    capsys.readouterr()
    assert report.main(["--cost", "--cost-mesh", "1x1", "--device", "cpu"]) == 0
    assert "== cost observatory: mesh scene=1 x frame=1" in capsys.readouterr().out
    assert report.render_cost([]) == jax_report.render_cost([])


def _write_trace_inputs(tmp_path):
    """An events file, a journal and a flight dump that mention one served
    request: queue wait, execution with stage spans inside it, a neighbour
    request's spans outside it, a drift mark and black-box rows."""
    path = str(tmp_path / "events.jsonl")
    sink = events.EventSink(path, truncate=True)
    t = 1_700_000_000.0

    def span(name, end, dur, **attrs):
        sink.emit(events.KIND_SPAN, {"name": name, "t0": 0.0, "dur_s": dur, "sync_s": 0.01,
                                     "depth": 0, "attrs": dict(attrs, end_ts=end)})

    span("serve.queue_wait", t + 1.0, 1.0, request="r-000001", scene="a")
    for i, name in enumerate(("associate", "graph", "cluster", "postprocess")):
        span(name, t + 1.2 + 0.2 * i, 0.15)
    span("exec.device", t + 1.9, 0.8)
    span("serve.request", t + 2.0, 1.0, request="r-000001", scene="a")
    span("associate", t + 5.0, 0.2)
    span("serve.request", t + 5.5, 0.6, request="r-000002", scene="b")
    sink.emit(events.KIND_DRIFT, {"coord": "k63:f32:n16384|bf16|single|r0|c0",
                                  "fields": ["artifact"]})
    sink.close()
    jdir = tmp_path / "journals"
    j = faults.RunJournal(str(jdir / "r-000001.jsonl"), "served", request_id="r-000001")
    j.attempt("a", 1, 0)
    j.outcome("a", "ok", attempt=1)
    j.close()
    rec = flight.FlightRecorder()
    rec.record(flight.KIND_ADMIT, event="admit", request="r-000001", scene="a")
    rec.record(flight.KIND_REQUEST, event="done", request="r-000001")
    rec.record(flight.KIND_ADMIT, event="admit", request="r-000002", scene="b")
    rec.record_span("post.dbscan", 0.05, 0.0, {"end_ts": t + 1.75})
    dump = rec.dump("test", path=str(tmp_path / "flight.jsonl"))
    return path, str(jdir), dump


def test_assemble_trace_equal(tmp_path):
    path, jdir, dump = _write_trace_inputs(tmp_path)
    for kw in ({}, {"journal_dir": jdir}, {"journal_dir": jdir, "blackbox": dump}):
        mine = trace.assemble_trace("r-000001", path, **kw)
        theirs = jax_trace.assemble_trace("r-000001", path, **kw)
        assert mine == theirs
        assert trace.render_trace(mine) == jax_trace.render_trace(theirs)
    labels = [s["label"] for s in mine["segments"]]
    assert labels[:2] == ["queue wait", "execution"] and "outcome ok" in labels
    kids = [c["label"] for c in mine["segments"][1]["children"]]
    assert kids[:4] == ["associate", "graph", "cluster", "postprocess"]
    assert trace.assemble_trace("r-404", path) == jax_trace.assemble_trace("r-404", path)


# the stats document of a sentinel-armed daemon (the JAX package's own
# top test's document, ``tests/test_telemetry.py:333``, plus the canary
# summary, the sentinel matrix and an SLO verdict)
STATS = {
    "config": "served", "uptime_s": 12.5, "draining": False,
    "counts": {"requests": 5, "ok": 4, "failed": 1},
    "queue": {"depth": 1, "capacity": 8, "high_water": 3, "admitted": 5},
    "warm_buckets": [[16, 16, 8192]],
    "worker": {"pid": 777, "hb_age_s": 0.4, "spawns": 2, "consecutive_respawns": 1,
               "inflight_crashes": 1},
    "canary": {"rounds": 4, "drift_total": 1},
    "sentinel": {"rounds": 4, "drift_total": 1, "skipped_busy": 2,
                 "last_verified_age_s": {"k63:f32:n16384|bf16|single|r0|c0": 3.0},
                 "drift_coords": {"k127:f64:n65536|bf16|single|r0|c0": 1}},
    "telemetry": {
        "window_s": 5.0,
        "windows": [
            {"dur_s": 5.0, "requests": 2, "queue_depth": 2, "rejects": {"queue_full": 1},
             "crashes": 1, "respawns": 1, "requeued": 1, "post_warm_compiles": 1,
             "drift": 1, "canary_probes": 2,
             "latency": {"16x16x8192": {"count": 2, "p50_s": 1.0, "p95_s": 2.0,
                                        "max_s": 2.0}},
             "queue_wait": {"count": 2, "p50_s": 0.1, "p95_s": 0.2, "max_s": 0.2}},
            {"dur_s": 5.0, "requests": 3, "queue_depth": 0, "rejects": {}, "crashes": 0,
             "respawns": 0, "drift": 0, "latency": {}},
        ],
        "cumulative": {
            "counters": {"aot_cache.hits": 4, "canary.probes": 8, "canary.drift": 1},
            "gauges": {},
            "latency": {"16x16x8192": {"count": 5, "p50": 1.1, "p95": 2.2, "max": 2.2,
                                       "total": 6.0}}}},
}


def test_render_top_equal():
    from maskclustering_tpu_torch.obs import slo

    stats = dict(STATS, slo=slo.evaluate(slo.load_spec(None), STATS["telemetry"]))
    frame = top.render_top(stats, now=1040.0)
    assert frame == jax_top.render_top(stats, now=1040.0)
    assert "DRIFT" in frame and "correctness" in frame
    bare = {"queue": {}, "counts": {}}
    assert top.render_top(bare, now=5.0) == jax_top.render_top(bare, now=5.0)
    vals = [0, 1, 5, 2.5, 0, 9]
    assert top.sparkline(vals, width=4) == jax_top.sparkline(vals, width=4)


def test_disarmed_spans_book_nothing_and_keep_timings(tmp_path, monkeypatch):
    """Disarmed: no events, no device synchronize from a span, and the
    ``timings`` keys of a device-rung scene. Armed: the same digest and
    timings keys, and ``pipeline.host_sync`` equal to ``timings["pulls"]``."""
    from maskclustering_tpu_torch.models.pipeline import run_scene
    from maskclustering_tpu_torch.obs import tracer
    from maskclustering_tpu_torch.utils.synthetic import make_scene as port_make_scene
    from maskclustering_tpu_torch.utils.synthetic import to_scene_tensors

    obs.disable()
    metrics.registry().reset()
    cfg = load_config("scannet", **KW)
    tensors = to_scene_tensors(port_make_scene(num_boxes=3, num_frames=8, image_hw=(60, 80),
                                               seed=61, spacing=0.05))

    def no_sync(*a, **k):
        raise AssertionError("a disarmed span synchronized the device")

    with monkeypatch.context() as m:
        m.setattr(tracer.torch.cuda, "synchronize", no_sync)
        off = run_scene(tensors, cfg, seq_name="s", device="cpu")
    assert obs.events_path() is None
    assert sorted(off.timings) == ["associate", "cluster", "graph", "post.claims",
                                   "post.dbscan", "post.emit", "post.mask_assign",
                                   "post.merge", "postprocess", "pulls"]
    path = str(tmp_path / "ev.jsonl")
    obs.configure(path, truncate=True)
    try:
        on = run_scene(tensors, cfg, seq_name="s", device="cpu")
        obs.flush_metrics()
    finally:
        obs.disable()
    assert sorted(on.timings) == sorted(off.timings) and on.digest == off.digest
    assert on.timings["pulls"] == off.timings["pulls"]
    summary = report.RunData(path).summary()
    assert summary["counters"]["pipeline.host_sync"] == on.timings["pulls"]
    attrs = {r["name"]: (r.get("attrs") or {})
             for r in events.read_events(path, kinds=[events.KIND_SPAN])}
    assert attrs["graph"]["host_pull"] == "mask_valid"
    assert attrs["post.assignment.pull"]["host_pull"] == "assignment"
    metrics.registry().reset()


def test_percentile_lives_in_the_report():
    assert metrics.percentile is report.percentile
    vals = sorted([3.0, 1.0, 2.0, 9.0])
    for q in (0, 50, 95, 100):
        assert report.percentile(vals, q) == jax_report.percentile(vals, q)
