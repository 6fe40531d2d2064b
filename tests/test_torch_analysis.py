"""The port's static checks (``maskclustering_tpu_torch/analysis/``)
against the JAX package's analyzer, on the CPU.

Every family-2 (AST lint) and family-4 (concurrency) fixture of
``tests/test_analysis.py`` is written twice, once under the JAX package's
name and once under the port's: both analyzers must give the same finding
ids once the package prefix is swapped. Torch-only fixtures pin the host
syncs (``.item()``, ``.cpu()``, ``.tolist()``, ``torch.cuda.synchronize``)
and a ``torch.compile`` root. The port's tree is clean modulo its own
baseline; the lock sanitizer's observed graph of the port's four-scan fault
drill embeds in the static graph.
"""

import ast
import json
import os
import re
import textwrap
import threading
import time

import pytest
import torch

from maskclustering_tpu.analysis.ast_checks import analyze_ast as jax_analyze_ast
from maskclustering_tpu.analysis.concurrency import analyze_concurrency as jax_analyze_conc
from maskclustering_tpu_torch.analysis import lock_sanitizer as ls
from maskclustering_tpu_torch.analysis.__main__ import main
from maskclustering_tpu_torch.analysis.ast_checks import (
    DEVICE_PATH_MODULES,
    analyze_ast,
    check_host_syncs,
    check_jit_purity,
)
from maskclustering_tpu_torch.analysis.concurrency import (
    _find_cycles,
    analyze_concurrency,
    build_lock_order_graph,
    thread_markers,
)
from maskclustering_tpu_torch.analysis.findings import (
    DEFAULT_BASELINE,
    load_baseline,
    partition_findings,
    stale_in_scope,
)

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "maskclustering_tpu", "maskclustering_tpu_torch"

# the fixtures of tests/test_analysis.py: (family, path under the package, source)
FIXTURES = {
    "hostsync_unsanctioned": ("ast", "models/pipeline.py", """
        def device_phase(x):
            a = np.asarray(x)          # unsanctioned
            b = x.item()               # unsanctioned
            c = float(compute(x))      # unsanctioned
            return a, b, c
    """),
    "hostsync_sanctioned": ("ast", "models/pipeline.py", """
        def device_phase(x, sp):
            with sanctioned_pull("mask_valid"):
                a = np.asarray(x)                  # family-3 seam
            with tracer.span("post.claims_pull", scene=s):
                b = np.asarray(x)                  # pull-named span
            c = np.asarray(x)  # mct-ok: AST.HOSTSYNC
            return a, b, c
    """),
    "hostsync_body_markers": ("ast", "models/pipeline.py", """
        def device_phase(x, sp):
            with tracer.span("graph", scene=s) as sp2:
                b = np.asarray(x)
                obs.count("pipeline.host_sync")
            return b
    """),
    "jitpurity": ("ast", "models/pipeline.py", """
        import jax, time

        def helper():
            return time.perf_counter()   # reachable from the jitted root

        @jax.jit
        def step(x):
            return x + helper()

        def host_only():
            return time.time()           # NOT reachable from any trace
    """),
    "threads_unlocked": ("ast", "models/thr.py", """
        registry = {}
        _lock = threading.Lock()

        def worker(k):
            registry[k] = 1        # unlocked mutation on a thread target

        def locked_worker(k):
            with _lock:
                registry[k] = 1    # guarded: fine

        t = threading.Thread(target=worker)
        u = threading.Thread(target=locked_worker)
    """),
    "thread_targets_pool": ("ast", "models/thr.py", """
        shared = []

        def load_crops(c):
            shared.append(c)

        def drain():
            shared.append(0)

        def transform(r):
            shared.append(r)

        crops = pool.map(load_crops, chunk)
        fut = ex.submit(drain)
        other = mymap.map(transform, rows)
    """),
    "bare_except": ("ast", "models/pipeline.py", """
        try:
            risky()
        except:
            pass
        try:
            risky()
        except Exception:
            pass
    """),
    "ast_driver_bad_tree": ("ast", "models/pipeline.py", """
        def run_scene_device(x):
            try:
                return np.asarray(x)
            except:
                pass
    """),
    "cli_ast_bad_tree": ("ast", "models/pipeline.py",
                         "def run_scene_device(x):\n    return np.asarray(x)\n"),
    "lockorder_cycle": ("concurrency", "models/conc_fix.py", """
        a = mct_lock("fix.A")
        b = mct_lock("fix.B")

        def fwd():
            with a:
                with b:
                    pass

        def rev():
            with b:
                with a:
                    pass
    """),
    "lockorder_one_order": ("concurrency", "models/conc_fix.py", """
        a = mct_lock("fix.A")
        b = mct_lock("fix.B")

        def fwd():
            with a:
                with b:  # mct-ok: CONC.BLOCKING
                    pass
    """),
    "shared_unguarded_dict": ("concurrency", "models/conc_fix.py", """
        import threading
        from collections import deque

        registry = {}
        CACHE = {}  # mct-thread: immutable
        q = deque()
        _lock = threading.Lock()

        def worker_a():
            registry["k"] = 1
            CACHE["warm"] = 1
            q.append(1)

        def worker_b():
            registry.update(k=2)

        def locked_worker():
            with _lock:
                registry["k"] = 3

        ta = threading.Thread(target=worker_a)
        tb = threading.Thread(target=worker_b)
        tc = threading.Thread(target=locked_worker)
        ta.join(1.0)
        tb.join(1.0)
        tc.join(1.0)
    """),
    "blocking_under_lock": ("concurrency", "models/conc_fix.py", """
        import threading
        import time

        _lock = threading.Lock()

        def writer(f, data):
            with _lock:
                f.write(data)

        def sleeper():
            with _lock:
                time.sleep(0.1)

        def fine(f, data):
            f.write(data)
            with _lock:
                pass

        def _helper(f, data):
            f.write(data)

        def indirect(f, data):
            with _lock:
                _helper(f, data)  # IO moved into a helper stays caught
    """),
    "signal_handler_allocates": ("concurrency", "models/conc_fix.py", """
        import json
        import signal
        import threading

        _STOP = threading.Event()

        def _bad_handler(signum, frame):
            data = {"sig": signum}
            json.dump(data, open("/tmp/x", "w"))

        def _good_handler(signum, frame):
            _STOP.set()

        signal.signal(signal.SIGTERM, _bad_handler)
        signal.signal(signal.SIGINT, _good_handler)
    """),
    "join_contract": ("concurrency", "models/conc_fix.py", """
        import threading

        def unjoined(fn):
            t = threading.Thread(target=fn)
            t.start()

        def unbounded(fn):
            t = threading.Thread(target=fn)
            t.start()
            t.join()

        def bounded(fn):
            t = threading.Thread(target=fn)
            t.start()
            t.join(2.0)

        def abandoned(fn):
            threading.Thread(  # mct-thread: abandon(fixture: the watchdog outwaits the call)
                target=fn, daemon=True).start()

        def empty_abandon(fn):
            threading.Thread(  # mct-thread: abandon()
                target=fn, daemon=True).start()
    """),
    "result_without_timeout": ("concurrency", "models/conc_fix.py", """
        def wait_all(futs):
            return [f.result() for f in futs]

        def bounded_wait(fut):
            return fut.result(timeout=5.0)

        def opted_out(fut):
            return fut.result()  # mct-ok: CONC.RESULT
    """),
}


def _tree(root, pkg, rel, src):
    p = root / pkg / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return str(root)


def _ids(findings, pkg):
    return sorted((f.id.replace(pkg + "/", "<pkg>/"), f.line) for f in findings)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_finding_ids_equal_to_jax(tmp_path, name):
    family, rel, src = FIXTURES[name]
    jax_root = _tree(tmp_path / "j", JAX_PKG, rel, src)
    port_root = _tree(tmp_path / "p", PORT_PKG, rel, src)
    if family == "ast":
        want, got = jax_analyze_ast(jax_root), analyze_ast(port_root)
    else:
        want, got = jax_analyze_conc(jax_root), analyze_concurrency(port_root)
    assert _ids(got, PORT_PKG) == _ids(want, JAX_PKG)
    # every fixture but the clean ones fires
    assert bool(got) == (name not in ("hostsync_sanctioned", "lockorder_one_order"))


def test_thread_marker_grammar():
    m = thread_markers(["def loader():  # mct-thread: root",
                        "X = {}  # mct-thread: immutable",
                        "threading.Thread(target=f)  # mct-thread: abandon(watchdog outwaits)",
                        "plain line"])
    assert m == {1: ("root", ""), 2: ("immutable", ""), 3: ("abandon", "watchdog outwaits")}


def _lint(src, check_fn):
    src = textwrap.dedent(src)
    return check_fn(ast.parse(src), "maskclustering_tpu_torch/models/pipeline.py",
                    src.splitlines())


def test_hostsync_takes_torch_syncs():
    out = _lint("""
        def device_phase(x):
            a = x.item()
            b = x.cpu()
            c = x.tolist()
            d = x.numpy()
            torch.cuda.synchronize()
            e = bool(x.any())
            with obs.span("post.prep.pull", host_pull="live_count"):
                f = x.cpu().numpy()                # the port's pull spans
            g = x.tolist()  # mct-ok: AST.HOSTSYNC
            return a, b, c, d, e, f, g
    """, check_host_syncs)
    assert [f.id for f in out] == [
        f"AST.HOSTSYNC:maskclustering_tpu_torch/models/pipeline.py:device_phase:{t}:1"
        for t in (".item", ".cpu", ".tolist", ".numpy", "torch.cuda.synchronize",
                  "bool(<call>)")]


def test_hostsync_scoped_to_the_device_path_modules(tmp_path):
    src = "def f(x):\n    return x.item()\n"
    _tree(tmp_path, PORT_PKG, "models/pipeline.py", src)
    _tree(tmp_path, PORT_PKG, "io/png.py", src)  # host plumbing: not a device module
    assert [f.file for f in analyze_ast(str(tmp_path))] == [
        "maskclustering_tpu_torch/models/pipeline.py"]
    assert "maskclustering_tpu_torch/models/pipeline.py" in DEVICE_PATH_MODULES


def test_jitpurity_takes_torch_roots():
    out = _lint("""
        import time, torch

        def helper():
            return time.perf_counter()

        @torch.compile
        def step(x):
            return x + helper()

        def traced(x):
            return x * random.random()

        scripted = torch.jit.script(traced)

        def vmapped(x):
            return np.random.rand() + x

        batched = torch.func.vmap(vmapped)

        def host(x):
            return time.time() + re.compile("a")
    """, check_jit_purity)
    assert sorted(f.id.split(":", 2)[2] for f in out) == [
        "helper:time.perf_counter:1", "traced:random.random:1", "vmapped:np.random.rand:1"]


def test_port_tree_clean_modulo_its_baseline():
    baseline = load_baseline(os.path.join(REPO, DEFAULT_BASELINE))
    findings = analyze_ast(REPO) + analyze_concurrency(REPO)
    unsuppressed, suppressed, stale = partition_findings(findings, baseline)
    # the baseline also audits the ir family's sites; these two families
    # judge only their own entries stale (as the CLI's scoping does)
    stale = stale_in_scope(stale, ["ast", "concurrency"])
    assert [f.id for f in unsuppressed] == [] and stale == []
    assert suppressed and all(len(why) > 10 for why in baseline.values())
    # no real race is baselined: shared state and lock order are fixed, not accepted
    assert not [f for f in baseline if f.startswith(("CONC.SHARED", "CONC.LOCKORDER",
                                                     "AST.THREADS"))]
    assert DEFAULT_BASELINE.startswith("maskclustering_tpu_torch/")


def test_cli_exits_0_on_the_port_and_2_on_a_bad_tree(tmp_path, capsys):
    assert main(["--root", REPO]) == 0
    assert "mct-check: clean" in capsys.readouterr().out
    _tree(tmp_path, PORT_PKG, "models/conc_fix.py", FIXTURES["lockorder_cycle"][2])
    argv = ["--root", str(tmp_path), "--format", "json"]
    assert main(argv) == 2
    doc = json.loads(capsys.readouterr().out)
    assert "CONC.LOCKORDER:fix.A+fix.B" in {f["id"] for f in doc["findings"]}
    # the ratchet round trip: written with TODOs (refused), justified, green
    bl = tmp_path / "bl.json"
    main(argv + ["--write-baseline", str(bl)])
    with pytest.raises(ValueError):
        load_baseline(str(bl))
    doc = json.loads(bl.read_text())
    for e in doc["suppressions"]:
        e["justification"] = "fixture: accepted for the round-trip test"
    bl.write_text(json.dumps(doc))
    capsys.readouterr()
    events = tmp_path / "ev.jsonl"
    assert main(argv + ["--baseline", str(bl), "--events", str(events)]) == 0
    rows = [json.loads(line) for line in events.read_text().splitlines()]
    assert rows[-1]["kind"] == "analysis" and rows[-1]["summary"] and rows[-1]["clean"]
    # the ir and retrace families run (the retrace half here: ir is
    # test_torch_ir_checks.py's), unknown families are refused
    capsys.readouterr()
    assert main(["--families", "retrace", "--root", REPO]) == 0
    assert "mct-check: clean" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["--families", "xla", "--root", REPO])


def test_the_jax_baseline_is_never_read(tmp_path, monkeypatch):
    """A tree whose root holds only the JAX package's baseline file: the
    port's CLI reads its own path and finds no suppression there."""
    _tree(tmp_path, PORT_PKG, "models/pipeline.py", FIXTURES["cli_ast_bad_tree"][2])
    jax_bl = {"version": 1, "suppressions": [
        {"id": f.id, "justification": "would suppress everything"}
        for f in analyze_ast(str(tmp_path))]}
    (tmp_path / "analysis_baseline.json").write_text(json.dumps(jax_bl))
    assert main(["--families", "ast", "--root", str(tmp_path)]) == 2


def test_static_lock_graph_speaks_the_jax_vocabulary_and_is_acyclic():
    nodes, edges = build_lock_order_graph(REPO)
    for name in ("faults._PLAN_LOCK", "faults.Heartbeat._lock", "faults._FaultEntry.lock",
                 "obs.metrics.Registry._lock", "obs.events.EventSink._lock",
                 "serve.WorkerPool._lock", "serve.ServeDaemon._lock",
                 "serve.WorkerSupervisor._lock", "obs.telemetry._agg_lock",
                 "streaming.StreamAccumulator._bind_lock", "ops.cuda._LOAD_LOCK",
                 "ops.cuda.LaunchLog._lock", "compile_cache._SEEN_LOCK",
                 "faults.RunJournal._lock"):
        assert name in nodes, name
    assert _find_cycles(edges) == []
    # no bare threading.Lock() is left in the port: every lock is named
    for d, _, files in os.walk(os.path.join(REPO, PORT_PKG)):
        for f in files:
            if f.endswith(".py") and "analysis" not in d:
                with open(os.path.join(d, f)) as fh:
                    assert "threading.Lock()" not in fh.read(), f


def test_mct_lock_arming_and_instrumented_type(monkeypatch):
    monkeypatch.delenv(ls.ENV_FLAG, raising=False)
    ls.arm(None)
    try:
        assert isinstance(ls.mct_lock("x"), type(threading.Lock()))
        monkeypatch.setenv(ls.ENV_FLAG, "1")
        lk = ls.mct_lock("x")
        assert isinstance(lk, ls.InstrumentedLock) and lk.name == "x"
        ls.arm(False)
        assert not ls.enabled()
    finally:
        ls.arm(None)


def test_sanitizer_records_orders_holds_and_cross_checks(monkeypatch):
    monkeypatch.setenv("MCT_LOCK_HOLD_WARN_S", "0.01")
    ls.reset()
    try:
        a, b = ls.InstrumentedLock("A"), ls.InstrumentedLock("B")
        with a:
            with b:
                pass
        with b:
            time.sleep(0.02)
        rep = ls.report()
        assert rep["acquisitions"] == {"A": 1, "B": 2}
        assert ls.observed_edges() == {("A", "B")}
        assert any(h["name"] == "B" for h in rep["long_holds"])
        assert ls.check_embeds({("A", "B")}, {("A", "B")}, {"A", "B"}) == []
        assert len(ls.check_embeds({("A", "B")}, set(), {"A", "B"})) == 1
        assert ls.check_embeds({("A", "Z")}, set(), {"A", "B"}) == []
    finally:
        ls.reset()


SCENES = [f"scene{i:04d}_00" for i in range(4)]


def test_fault_drill_under_the_sanitizer_embeds_in_the_static_graph(tmp_path):
    """The port's four-scan fault drill (the plan of tests/test_faults.py)
    under ``MCT_LOCK_SANITIZER=1`` with obs armed: plan, entry, heartbeat,
    registry and sink locks all taken, the observed order edges all in the
    static graph, and the report's counters carry ``locks.*``."""
    from maskclustering_tpu_torch import obs
    from maskclustering_tpu_torch.config import load_config
    from maskclustering_tpu_torch.run import run_pipeline
    from maskclustering_tpu_torch.utils import faults
    from maskclustering_tpu_torch.utils.synthetic import make_scene, write_scannet_layout

    root = str(tmp_path)
    for i, seq in enumerate(SCENES):
        write_scannet_layout(make_scene(num_boxes=2, num_frames=6, image_hw=(40, 56),
                                        spacing=0.05, seed=70 + i), root, seq)
    cfg = load_config("scannet", data_root=root, config_name="flt", step=1,
                      distance_threshold=0.05, mask_pad_multiple=32, frame_pad_multiple=4,
                      point_chunk=2048, retry_backoff_s=0.01, watchdog_device_s=5.0)
    os.environ[ls.ENV_FLAG] = "1"
    ls.arm(True)
    ls.reset()
    undo = ls.instrument_known_locks()
    # made after arming: its entries' locks are instrumented at creation
    faults.set_plan(faults.FaultPlan.from_spec(
        f"load:{SCENES[0]}, stall:{SCENES[1]}.device, flaky:{SCENES[2]}:2, "
        f"fail:{SCENES[3]}.post", stall_s=3600.0))
    try:
        rep = run_pipeline(cfg, SCENES, steps=("cluster",), resume=False,
                           report_path=os.path.join(root, "r.json"),
                           obs_events=os.path.join(root, "ev.jsonl"), ledger=False,
                           device="cpu")
        edges, report = ls.observed_edges(), ls.report()
    finally:
        undo()
        faults.set_plan(None)
        faults.clear_stop()
        ls.arm(None)
        os.environ.pop(ls.ENV_FLAG, None)
        ls.reset()
        obs.disable()
    assert [s.status for s in rep.scenes][2:] == ["ok", "ok"]
    for name in ("faults._PLAN_LOCK", "obs.metrics.Registry._lock",
                 "obs.events.EventSink._lock", "faults._FaultEntry.lock"):
        assert report["acquisitions"].get(name), (name, report["acquisitions"])
    nodes, static_edges = build_lock_order_graph(REPO)
    assert ls.check_embeds(edges, static_edges, nodes) == []
    # the run booked the locks.* counters before its flush: the report renders them
    from maskclustering_tpu_torch.obs.report import RunData, render_report

    text = render_report(RunData(os.path.join(root, "ev.jsonl")))
    got = re.search(r"lock sanitizer: (\d+) acquisition\(s\) \| (\d+) order edge", text)
    # booked before the flush: the acquisitions after it are not in the count
    assert got and 0 < int(got.group(1)) <= sum(report["acquisitions"].values()), text
    assert int(got.group(2)) == len(edges)
