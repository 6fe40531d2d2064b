"""The port's load generator (``maskclustering_tpu_torch/tools/load_gen.py``)
against the JAX package's ``scripts/load_gen.py`` (loaded by ``importlib``,
as ``tests/test_serve.py`` does), on the CPU.

- The pure functions (``parse_tenant_mix``, ``worst_window_p95``,
  ``check_tenant_accounting``, ``check_healthy_slo``, ``_artifact_crcs``,
  ``_pool_span_overlap``) give exactly the JAX tool's outputs on seeded
  inputs.
- ``run_load`` over a scripted client (a fixed table of terminals, statuses
  and latencies, a fixed clock) gives the JAX ``run_load``'s verdict, field
  for field, closed and open loop; ``load_verdict`` is that assembly; the
  ledger rows agree.
- One burst through both tools against one port daemon (``device="cpu"``):
  the same verdict keys, 8 ok each, and every request's artifact digest
  equal across the tools, bucket by bucket.
- ``--smoke`` at ``scripts/ci.sh``'s size, as a subprocess on the CPU,
  exits 0 with a parseable verdict line.
- A mode asked for the card on a host without one raises before it spawns
  anything; the daemon's missing-goldens warning names the port's tool.
"""

import copy
import importlib.util
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from maskclustering_tpu_torch.config import load_config
from maskclustering_tpu_torch.obs import metrics
from maskclustering_tpu_torch.serve.client import ServeClient
from maskclustering_tpu_torch.serve.daemon import ServeDaemon
from maskclustering_tpu_torch.tools import load_gen
from maskclustering_tpu_torch.utils import faults

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_load_gen", os.path.join(REPO, "scripts", "load_gen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_lg = _jax_tool()


def _short_socket():
    """AF_UNIX paths hold 107 bytes: a short directory under /tmp."""
    return os.path.join(tempfile.mkdtemp(prefix="mct", dir="/tmp"), "s.sock")


@pytest.fixture(autouse=True)
def _clean_state():
    faults.set_plan(None)
    faults.clear_stop()
    yield
    faults.set_plan(None)
    faults.clear_stop()


# ---------------------------------------------------------------------------
# pure functions against the JAX tool
# ---------------------------------------------------------------------------


def _outcome(fn, *args):
    """(result, None) or (None, (exception type name, message))."""
    try:
        return fn(*args), None
    except Exception as e:  # noqa: BLE001 — compared across the tools
        return None, (type(e).__name__, str(e))


def test_parse_tenant_mix_equal():
    rng = np.random.default_rng(1900)
    specs = [None, "", "A:3,B:1", " A : 2 , , B", "solo", "A:0", ":3", "A:x", "A:1,A:2"]
    for _ in range(40):
        parts = []
        for _ in range(int(rng.integers(1, 5))):
            name = "".join(rng.choice(list("abcXY_ "), size=int(rng.integers(0, 4))))
            weight = str(int(rng.integers(-1, 4))) if rng.random() < 0.8 else ""
            parts.append(f"{name}:{weight}" if rng.random() < 0.9 else name)
        specs.append(",".join(parts))
    for spec in specs:
        assert _outcome(load_gen.parse_tenant_mix, spec) == \
            _outcome(jax_lg.parse_tenant_mix, spec), spec


def _windows(rng, n):
    out = []
    for _ in range(n):
        lat = {}
        for b in range(int(rng.integers(0, 3))):
            lat[f"k63:f{8 * (b + 1)}:n4096"] = (
                {"p95_s": round(float(rng.random() * 3), 4), "count": int(rng.integers(1, 9))}
                if rng.random() < 0.7 else {"count": 0})
        row = {"latency": lat} if rng.random() < 0.9 else {}
        if rng.random() < 0.5:
            row["tenants"] = {"A": {"requests": int(rng.integers(0, 4))}}
        out.append(row)
    return out


def test_worst_window_p95_equal():
    rng = np.random.default_rng(1901)
    cases = [None, [], [{}], [{"latency": None}], [{"latency": {"b": None}}]]
    cases += [_windows(rng, int(rng.integers(0, 6))) for _ in range(30)]
    for windows in cases:
        assert load_gen.worst_window_p95(windows) == jax_lg.worst_window_p95(windows)


def _telemetry(rng):
    tenants = {t: {"requests": int(rng.integers(0, 5))} for t in ("A", "B", "C")
               if rng.random() < 0.7}
    total = sum(t["requests"] for t in tenants.values())
    counters = {"serve.requests": total + (int(rng.integers(-1, 2)) if rng.random() < 0.3 else 0)}
    tel = {"cumulative": {"tenants": tenants, "counters": counters},
           "windows": _windows(rng, int(rng.integers(0, 4)))}
    sent = {t: int(rng.integers(1, 4)) for t in ("A", "B", "D") if rng.random() < 0.6}
    return tel, sent


def test_check_tenant_accounting_equal():
    rng = np.random.default_rng(1902)
    cases = [({}, {}), (None, {"A": 1}), ({"cumulative": {}}, {})]
    cases += [_telemetry(rng) for _ in range(40)]
    for tel, sent in cases:
        mine, theirs = [], []
        assert load_gen.check_tenant_accounting(copy.deepcopy(tel), sent, mine) == \
            jax_lg.check_tenant_accounting(copy.deepcopy(tel), sent, theirs)
        assert mine == theirs


def test_artifact_crcs_equal(tmp_path):
    rng = np.random.default_rng(1903)
    root = tmp_path / "prediction"
    for d in range(3):
        sub = root / f"cfg{d}_class_agnostic"
        sub.mkdir(parents=True)
        for k in range(2):
            np.savez(sub / f"scene{k}.npz",
                     pred_masks=rng.random((int(rng.integers(1, 50)), 3)) > 0.5,
                     pred_score=rng.random(3).astype(np.float32),
                     pred_classes=rng.integers(0, 200, size=3).astype(np.int64))
        (sub / "note.txt").write_bytes(rng.bytes(int(rng.integers(0, 300))))
    mine = load_gen._artifact_crcs(str(root))
    assert mine == jax_lg._artifact_crcs(str(root)) and len(mine) == 21
    assert load_gen._artifact_crcs(str(tmp_path / "none")) == {} == \
        jax_lg._artifact_crcs(str(tmp_path / "none"))


def test_pool_span_overlap_equal(tmp_path):
    rng = np.random.default_rng(1904)
    for case in range(12):
        path = tmp_path / f"events{case}.jsonl"
        lines = []
        for _ in range(int(rng.integers(0, 14))):
            end = 100.0 + float(rng.random() * 10)
            attrs = {}
            if rng.random() < 0.8:
                attrs["worker_id"] = int(rng.integers(0, 3))
            if rng.random() < 0.8:
                attrs["end_ts"] = end
            lines.append(json.dumps({
                "v": 1, "kind": "span" if rng.random() < 0.9 else "metrics",
                "ts": end + 0.01,
                "name": "serve.request" if rng.random() < 0.85 else "serve.queue_wait",
                "dur_s": float(rng.random() * 3), "attrs": attrs}))
        if rng.random() < 0.3:
            lines.append('{"v": 1, "kind": "span", "torn')
        path.write_text("\n".join(lines) + "\n")
        assert load_gen._pool_span_overlap(str(path)) == jax_lg._pool_span_overlap(str(path))
    missing = str(tmp_path / "missing.jsonl")
    assert load_gen._pool_span_overlap(missing) == jax_lg._pool_span_overlap(missing) == (0, 0)


# ---------------------------------------------------------------------------
# run_load's verdict over a scripted client
# ---------------------------------------------------------------------------


class _FixedClock:
    """``time`` for a tool module: the burst starts at 100.0 and every later
    reading is 104.5; sleeps return at once."""

    def __init__(self):
        self.calls = 0

    def monotonic(self):
        self.calls += 1
        return 100.0 if self.calls == 1 else 104.5

    def sleep(self, _s):
        return None


def _script(seed: int, n: int):
    """{tag: [(terminal, statuses, latency), ...]} for requests 0..n-1: ok
    results (some packed, retried or degraded), failed, skipped, typed
    rejects, queue_full twice before an ok, worker_crash statuses."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        tag = f"lg-{i:04d}"
        kind = rng.choice(["ok", "ok", "ok", "failed", "skipped", "quota", "full"])
        term = {"kind": "result", "status": "ok", "id": f"r-{i:06d}",
                "attempts": int(rng.integers(1, 3)), "rung": int(rng.integers(0, 2)),
                "digest": {"artifact": f"{int(rng.integers(0, 2**32)):08x}"}}
        if rng.random() < 0.4:
            term["batch"] = int(rng.integers(2, 4))
        statuses = [{"kind": "status", "state": "running"}]
        if rng.random() < 0.2:
            statuses += [{"kind": "status", "state": "worker_crash"},
                         {"kind": "status", "state": "running"}]
        lat = round(float(rng.random() * 4), 6)
        if kind in ("failed", "skipped"):
            term["status"] = str(kind)
        if kind == "quota":
            out[tag] = [({"kind": "reject", "reason": "quota", "detail": "q"}, [], lat)]
        elif kind == "full":
            full = ({"kind": "reject", "reason": "queue_full"}, [], 0.01)
            out[tag] = [full, full, (term, statuses, lat)]
        else:
            out[tag] = [(term, statuses, lat)]
    return out


def _stub_client(script):
    script = copy.deepcopy(script)

    class Stub:
        def __init__(self, address, timeout_s=0.0):
            self.address = address

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

        def run_scene(self, scene, *, synthetic=None, deadline_s=0.0, resume=False,
                      tag="", tenant=""):
            term, statuses, lat = script[tag].pop(0)
            return copy.deepcopy(term), copy.deepcopy(statuses), lat

    return Stub


@pytest.mark.parametrize("seed,rate,conc", [(1910, 0.0, 1), (1911, 0.0, 3), (1912, 50.0, 2)])
def test_run_load_verdict_equal_over_a_scripted_client(monkeypatch, tmp_path, seed, rate,
                                                       conc):
    import maskclustering_tpu.serve.client as jax_client

    script = _script(seed, 14)
    mix = ["A", "A", "A", "B"]
    verdicts, rows = [], []
    for tool, patch in ((load_gen, lambda s: monkeypatch.setattr(load_gen, "ServeClient", s)),
                        (jax_lg, lambda s: monkeypatch.setattr(jax_client, "ServeClient", s))):
        patch(_stub_client(script))
        monkeypatch.setattr(tool, "time", _FixedClock())
        collect = []
        verdicts.append(tool.run_load("sock", requests=14, concurrency=conc, buckets=2,
                                      deadline_s=0.0, resume=False, tenant_mix=mix,
                                      rate=rate, collect=collect))
        rows.append(sorted(json.dumps(r, sort_keys=True) for r in collect))
    mine, theirs = verdicts
    assert mine == theirs and rows[0] == rows[1]
    assert mine["wall_s"] == 4.5 and mine["requests"] == 14
    n_full = sum(len(t) == 3 for t in script.values())
    assert (mine["rejects"] or {}).get("queue_full", 0) == 2 * n_full and n_full
    # the assembly on its own: the same fields from the same terminals
    results = [json.loads(r) for r in rows[0]]
    oks = sorted(t[-1][2] for tag, t in script.items()
                 if t[-1][0].get("kind") == "result" and t[-1][0]["status"] == "ok")
    crash = sum(s.get("state") == "worker_crash" for t in script.values() for s in t[-1][1])
    assert load_gen.load_verdict(
        requests=14, concurrency=conc, buckets=2, results=results, latencies=oks,
        rejects=mine["rejects"], crash_events=crash, sent_tenants=mine["tenant_mix_sent"],
        wall=4.5, rate=rate) == mine
    # the ledger rows agree but for the time, process and revision fields
    monkeypatch.setattr(load_gen, "time", __import__("time"))
    monkeypatch.setattr(jax_lg, "time", __import__("time"))
    load_gen.append_ledger_row(mine, str(tmp_path / "port.jsonl"))
    jax_lg.append_ledger_row(theirs, str(tmp_path / "jax.jsonl"))

    def row(path):
        (line,) = open(path).read().splitlines()
        return {k: v for k, v in json.loads(line).items() if k not in ("ts", "pid", "git")}

    assert row(tmp_path / "port.jsonl") == row(tmp_path / "jax.jsonl")
    assert row(tmp_path / "port.jsonl")["tool"] == "serve"


# ---------------------------------------------------------------------------
# one burst through both tools against one port daemon
# ---------------------------------------------------------------------------


def test_one_burst_through_both_tools(tmp_path):
    metrics.registry().reset()
    data = str(tmp_path / "data")
    names = load_gen._materialize_buckets(data)
    cfg = load_config("scannet").replace(data_root=data, config_name="lg", step=1,
                                         distance_threshold=0.05, mask_pad_multiple=32,
                                         backend="cpu")
    sock = _short_socket()
    daemon = ServeDaemon(cfg, socket_path=sock, capacity=8, warm_scenes=tuple(names),
                         journal_dir=str(tmp_path / "journals"), device="cpu",
                         telemetry_window_s=0.5)
    daemon.start()
    try:
        verdicts, rows = [], []
        for tool in (load_gen, jax_lg):
            collect = []
            verdicts.append(tool.run_load(sock, requests=8, concurrency=4, buckets=2,
                                          deadline_s=0.0, resume=False,
                                          tenant_mix=tool.parse_tenant_mix("A:3,B:1"),
                                          collect=collect))
            rows.append(collect)
        with ServeClient(sock, timeout_s=60.0) as c:
            tel = c.telemetry()["telemetry"]
    finally:
        daemon.request_stop()
        daemon.shutdown()
        shutil.rmtree(os.path.dirname(sock), ignore_errors=True)
        metrics.registry().reset()
    mine, theirs = verdicts
    assert set(mine) == set(theirs)
    for v in verdicts:
        assert v["ok"] == 8 and v["failed"] == 0 and v["rejects"] is None
        assert v["tenant_mix_sent"] == {"A": 6, "B": 2} and v["buckets"] == 2
    digests = {}
    for collect in rows:
        assert len(collect) == 8
        for r in collect:
            digests.setdefault(r["scene"], set()).add(r["digest"]["artifact"])
    assert sorted(digests) == ["lg-a", "lg-b"]
    assert all(len(d) == 1 for d in digests.values()), digests
    # the post-burst snapshot through both tools' checks
    sent = {"A": 12, "B": 4}
    a, b = [], []
    assert load_gen.check_tenant_accounting(tel, sent, a) == \
        jax_lg.check_tenant_accounting(tel, sent, b)
    assert a == b == []
    va, vb, fa, fb = {}, {}, [], []
    load_gen.check_healthy_slo(tel, va, fa)
    jax_lg.check_healthy_slo(tel, vb, fb)
    assert (va, fa) == (vb, fb) and va["slo_ok"] is True
    assert load_gen.worst_window_p95(tel["windows"]) == jax_lg.worst_window_p95(tel["windows"])


# ---------------------------------------------------------------------------
# the smoke, the device rule and the goldens message
# ---------------------------------------------------------------------------


def test_smoke_at_the_ci_size_on_the_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "maskclustering_tpu_torch.tools.load_gen",
                        "--smoke", "--requests", "6", "--concurrency", "3", "--no-ledger",
                        "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    verdict = json.loads(r.stdout.strip().splitlines()[-1])
    assert verdict["smoke"] is True and verdict["ok"] == 6 and verdict["failed"] == 0
    assert verdict["retrace_post_freeze"] == 0 and verdict["retrace_repeats"] == 0
    assert verdict["device"] == "cpu" and verdict["slo_ok"] is True
    assert "error" not in verdict and "smoke: PASS" in r.stderr


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a host with no CUDA card")
def test_a_mode_asked_for_the_card_raises_without_one():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_gen.daemon_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_gen.main(["--smoke", "--no-ledger"])
    assert load_gen.daemon_device("cpu") == "cpu"


def test_missing_goldens_warning_names_the_port_tool(tmp_path, caplog):
    from maskclustering_tpu_torch.obs import canary

    sock = _short_socket()
    cfg = canary.goldens_config().replace(data_root=str(tmp_path / "data"))
    d = ServeDaemon(cfg, socket_path=sock, canary_interval_s=0.2,
                    canary_goldens=str(tmp_path / "missing.json"), device="cpu")
    with caplog.at_level(logging.WARNING, logger="maskclustering_tpu_torch"):
        d.start()
    try:
        assert d.sentinel is None
    finally:
        d.request_stop()
        d.shutdown()
        shutil.rmtree(os.path.dirname(sock), ignore_errors=True)
    text = " ".join(r.getMessage() for r in caplog.records)
    assert "python -m maskclustering_tpu_torch.tools.load_gen --write-goldens" in text
    assert "scripts/load_gen.py" not in text
