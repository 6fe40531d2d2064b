"""Load generator for the port's serving daemon, and the CI drills over it
(the port's counterpart of the JAX package's ``scripts/load_gen.py``).

Drives N concurrent synthetic scene requests (mixed shape buckets by
default, so the daemon's routing and warmth are exercised, not one
bucket) against a running daemon, and prints ONE machine-readable JSON
verdict line on stdout (progress goes to stderr)::

    {"metric": "serve s/request (p50 of N synthetic requests)",
     "value": <p50 s>, "p95_s": <p95 s>, "throughput_rps": <ok / wall>,
     "requests": N, "concurrency": C, "rejects": {"queue_full": ...}, ...}

and appends a ``serve`` row to the port's perf ledger (``obs/ledger.serve_row``;
``PERF_LEDGER_TORCH.jsonl`` or ``$MCT_PERF_LEDGER``; ``--no-ledger`` skips it).

Modes::

    # against a running daemon (python -m maskclustering_tpu_torch.serve ...):
    python -m maskclustering_tpu_torch.tools.load_gen --socket /tmp/mct.sock \\
        --requests 16 --concurrency 8

    # the CI smoke: materialises two tiny warm scenes, spawns a daemon with
    # the build/launch-surface sanitizer armed and the kernel build cache on,
    # serves a small mixed-bucket burst, SIGTERMs it, and asserts a clean
    # drain with ZERO post-freeze builds and new launch keys (exit 0 / 1):
    python -m maskclustering_tpu_torch.tools.load_gen --smoke [--device cpu] \\
        [--isolate-worker | --crash-drill] [--fault-plan "flaky:lg-b:1"]

    # the drills: --pack-drill, --pool-drill, --chaos-drill, --canary-drill;
    # --write-goldens [PATH] regenerates the canary goldens on the CPU

Every daemon a mode spawns (``python -m maskclustering_tpu_torch.serve``)
runs on ``--device``: the CUDA card by default, which must exist, or the
CPU when ``--device cpu`` is given. The port never traces, so where the JAX
tool counts compiles this one counts ``nvcc`` builds and new (kernel,
launch shape) keys (``analysis/retrace_sanitizer.py``): the digest's
``compiles`` are builds, its ``post_freeze`` the builds and new launch
keys after warm-up.

Requests repeat over the bucket scene set with ``resume=false`` so every
request executes. ``--tenant-mix A:3,B:1`` stamps a weighted tenant on
every request; the smoke asserts the per-tenant accounting sums back to
the global window, arms the flight recorder (the crash drill asserts the
black box reconstructs the victim request through crash, requeue and
respawn) and holds the healthy soak to the default SLO spec
(``obs/slo.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

from maskclustering_tpu_torch.analysis.lock_sanitizer import mct_lock
from maskclustering_tpu_torch.serve.client import ServeClient

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the JAX tool's two tiny shape buckets: bucket A and the denser B land on
# distinct (k_max, f_pad, n_pad) keys under the smoke config below
BUCKET_SPECS: Tuple[Tuple[str, Dict], ...] = (
    ("lg-a", {"num_boxes": 3, "num_frames": 10, "image_hw": [60, 80],
              "spacing": 0.06, "seed": 40}),
    ("lg-b", {"num_boxes": 4, "num_frames": 10, "image_hw": [60, 80],
              "spacing": 0.05, "seed": 50}),
)
SMOKE_CONFIG_SETS = ("step=1", "distance_threshold=0.05",
                     "mask_pad_multiple=32", "backend=cpu")
# the smoke daemon's telemetry window (seconds)
SMOKE_TELEMETRY_WINDOW_S = 1.0


def log(msg: str) -> None:
    print(f"load_gen: {msg}", file=sys.stderr, flush=True)


def parse_tenant_mix(spec: Optional[str]) -> List[str]:
    """``"A:3,B:1"`` -> a weighted assignment cycle ``[A,A,A,B]``; request
    i gets ``cycle[i % len]``, so any request count splits 3:1. Empty/None
    means untenanted (the pre-tenant wire shape, byte-for-byte)."""
    if not spec:
        return []
    cycle: List[str] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, weight = part.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"tenant mix entry {part!r} has no tenant name")
        n = int(weight) if weight.strip() else 1
        if n < 1:
            raise ValueError(f"tenant mix weight for {name!r} must be >= 1")
        cycle.extend([name] * n)
    return cycle


def _address(args) -> object:
    if args.socket:
        return args.socket
    return (args.host, args.port)


def daemon_device(device: Optional[str]) -> str:
    """The ``--device`` the spawned daemons get: the one named, else the
    CUDA card, which must exist (``device.resolve_device`` raises; a tool
    asked for the card never goes on on the CPU)."""
    from maskclustering_tpu_torch.device import resolve_device

    return str(resolve_device(device))


def load_verdict(*, requests: int, concurrency: int, buckets: int,
                 results: List[Dict], latencies: List[float],
                 rejects: Dict[str, int], crash_events: int,
                 sent_tenants: Dict[str, int], wall: float,
                 rate: float = 0.0) -> Dict:
    """The verdict fields of one burst from its terminal results, the ok
    requests' latencies and the rejects (``run_load``'s assembly)."""
    from maskclustering_tpu_torch.obs.report import percentile

    ok = [r for r in results if r.get("status") == "ok"]
    failed = [r for r in results if r.get("status") not in ("ok", "skipped")]
    vals = sorted(latencies)

    def pct(q: float) -> Optional[float]:
        return round(percentile(vals, q), 4) if vals else None

    verdict = {
        "metric": f"serve s/request (p50 of {requests} synthetic requests)",
        "value": pct(50),
        "unit": "s/request",
        "p95_s": pct(95),
        "throughput_rps": round(len(ok) / wall, 3) if wall > 0 else None,
        "wall_s": round(wall, 2),
        "requests": requests,
        "concurrency": concurrency,
        "buckets": buckets,
        "ok": len(ok),
        "failed": len(failed),
        "rejects": rejects or None,
        "max_attempts": max((r.get("attempts", 1) for r in results), default=0),
        "max_rung": max((r.get("rung", 0) for r in results), default=0),
        "worker_crash_events": crash_events,
        "tenant_mix_sent": sent_tenants or None,
    }
    if rate > 0:
        verdict["arrival_rate_rps"] = rate
        verdict["arrival"] = "open-loop"
    # batch-occupancy histogram: every packed member's terminal carries
    # batch=k, so each width-k fused dispatch contributes exactly k
    # results; solo dispatches (width 1) have no batch field. Stamped
    # only when packing was observed (obs.ledger.batch_dimension fence)
    hist: Dict[int, int] = {}
    for r in results:
        w = int(r.get("batch", 1) or 1)
        hist[w] = hist.get(w, 0) + 1
    if any(w > 1 for w in hist):
        dispatches = hist.get(1, 0) + sum(
            max(1, int(round(n / w))) for w, n in hist.items() if w > 1)
        verdict["batch_hist"] = {str(w): hist[w] for w in sorted(hist)}
        verdict["batch_dispatches"] = dispatches
        verdict["batch_occupancy"] = round(len(results) / dispatches, 3)
    return verdict


def run_load(address, *, requests: int, concurrency: int, buckets: int,
             deadline_s: float, resume: bool,
             tenant_mix: Optional[List[str]] = None,
             rate: float = 0.0,
             collect: Optional[List[Dict]] = None) -> Dict:
    """Fire the burst; returns the aggregate verdict fields.

    ``rate > 0`` switches from the closed loop (``concurrency`` clients,
    each firing its next request the moment the previous returns) to an
    OPEN loop: request i is released at ``t0 + i/rate`` regardless of how
    many are still in flight. A ``queue_full`` reject is backpressure, not
    a failure: it is counted, backed off and resubmitted (at most 10
    times). ``collect`` (when given) receives every terminal result.
    """
    specs = list(BUCKET_SPECS[:max(1, min(buckets, len(BUCKET_SPECS)))])
    cycle = list(tenant_mix or [])
    sent_tenants: Dict[str, int] = {}
    plan: List[Tuple[int, str, Dict, str]] = []
    for i in range(requests):
        name, params = specs[i % len(specs)]
        tenant = cycle[i % len(cycle)] if cycle else ""
        if tenant:
            sent_tenants[tenant] = sent_tenants.get(tenant, 0) + 1
        plan.append((i, name, params, tenant))
    results: List[Dict] = []
    latencies: List[float] = []
    rejects: Dict[str, int] = {}
    crash_events = [0]  # worker_crash status events seen (crash drills)
    lock = mct_lock("load_gen.run_load.lock")

    def one_request(client, i: int, name: str, params: Dict, tenant: str) -> None:
        attempts = 0
        while True:
            terminal, statuses, latency = client.run_scene(
                name, synthetic=params, deadline_s=deadline_s,
                resume=resume, tag=f"lg-{i:04d}", tenant=tenant)
            ncrash = sum(1 for s in statuses if s.get("state") == "worker_crash")
            if ncrash:
                with lock:
                    crash_events[0] += ncrash
            if terminal.get("kind") == "reject" \
                    and terminal.get("reason") == "queue_full" and attempts < 10:
                attempts += 1
                with lock:
                    rejects["queue_full"] = rejects.get("queue_full", 0) + 1
                time.sleep(0.2 * attempts)
                continue
            break
        with lock:
            if terminal.get("kind") == "reject":
                reason = terminal.get("reason", "?")
                rejects[reason] = rejects.get(reason, 0) + 1
            else:
                terminal.setdefault("scene", name)
                results.append(terminal)
                if terminal.get("status") == "ok":
                    latencies.append(latency)

    work: "queue.Queue[Tuple[int, str, Dict, str]]" = queue.Queue()
    for item in plan:
        work.put(item)

    def client_loop() -> None:
        with ServeClient(address, timeout_s=600.0) as client:
            while True:
                try:
                    i, name, params, tenant = work.get_nowait()
                except queue.Empty:
                    return
                one_request(client, i, name, params, tenant)

    def open_loop_one(item: Tuple[int, str, Dict, str]) -> None:
        with ServeClient(address, timeout_s=600.0) as client:
            one_request(client, *item)

    t0 = time.monotonic()
    threads = []
    if rate > 0:
        # open loop: each request gets its own thread and connection,
        # started on the arrival clock; completions never gate arrivals
        for item in plan:
            delay = t0 + item[0] / rate - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            t = threading.Thread(target=open_loop_one, args=(item,),
                                 daemon=True, name=f"load-gen-{item[0]}")
            t.start()
            threads.append(t)
    else:
        for i in range(max(1, concurrency)):
            t = threading.Thread(target=client_loop, daemon=True, name=f"load-gen-{i}")
            t.start()
            threads.append(t)
    for t in threads:
        t.join(900.0)
    wall = time.monotonic() - t0
    if collect is not None:
        collect.extend(results)
    return load_verdict(requests=requests, concurrency=concurrency, buckets=len(specs),
                        results=results, latencies=latencies, rejects=rejects,
                        crash_events=crash_events[0], sent_tenants=sent_tenants,
                        wall=wall, rate=rate)


def append_ledger_row(verdict: Dict, path: Optional[str]) -> None:
    """One ``serve`` row on the port's ledger (``--ledger``, else
    ``PERF_LEDGER_TORCH.jsonl`` or ``$MCT_PERF_LEDGER``)."""
    from maskclustering_tpu_torch.obs import ledger as led

    led.append_row(path or led.default_ledger_path(), led.serve_row(verdict))


def check_tenant_accounting(tel: Dict, sent: Dict[str, int],
                            failures: List[str]) -> Optional[Dict]:
    """Per-tenant accounting must sum back to the global window: every
    completion books globally AND under exactly one tenant. Returns the
    cumulative tenant rows (for the verdict) when present.

    The cumulative equality is asserted exactly (the caller runs this on
    a quiesced post-burst snapshot); closed-window rows only need to SHOW
    attribution (a completion racing the roll tick may book its counter
    and its tenant slot across a window boundary).
    """
    cum = (tel or {}).get("cumulative") or {}
    cum_tenants = cum.get("tenants") or {}
    counters = cum.get("counters") or {}
    total = sum(int((t or {}).get("requests", 0)) for t in cum_tenants.values())
    global_reqs = int(counters.get("serve.requests", 0))
    if total != global_reqs:
        failures.append(
            f"tenant accounting: per-tenant requests sum to {total} but "
            f"the global serve.requests counter says {global_reqs}")
    missing = sorted(t for t in sent if t not in cum_tenants)
    if missing:
        failures.append(f"tenant accounting: tenant(s) {missing} sent "
                        f"requests but never appeared in the snapshot")
    windows = (tel or {}).get("windows") or []
    tenanted = [w for w in windows if w.get("tenants")]
    if windows and global_reqs and not tenanted:
        failures.append("tenant accounting: no closed window carries a "
                        "tenants sub-row — window attribution is dark")
    return cum_tenants or None


def check_healthy_slo(tel: Dict, verdict: Dict, failures: List[str]) -> None:
    """The healthy-soak SLO gate: the canned default spec (``obs/slo.py``)
    over the burst's closed windows must pass."""
    from maskclustering_tpu_torch.obs import slo as _slo

    result = _slo.evaluate(_slo.load_spec(None), tel or {})
    verdict["slo_ok"] = bool(result.get("ok"))
    violated = [o.get("name") for o in result.get("objectives") or ()
                if o.get("state") == "violated"]
    if violated:
        failures.append(f"healthy soak violated the default SLO spec: "
                        f"{', '.join(map(str, violated))}")


def check_blackbox(flight_dir: str, events: str, journal_dir: str,
                   verdict: Dict, failures: List[str]) -> None:
    """The crash-drill postmortem, end to end: the supervisor dumped a
    black box at SIGKILL time, the dump names the victim request and holds
    the child-side rows the relay shipped before the crash, ``obs.flight``
    renders it, and ``obs.trace --blackbox`` folds it into a timeline that
    reaches crash -> requeue -> respawn (a post-crash attempt)."""
    from maskclustering_tpu_torch.obs import flight as _flight
    from maskclustering_tpu_torch.obs import trace as _trace

    dumps = sorted(os.listdir(flight_dir)) if os.path.isdir(flight_dir) else []
    crash_dumps = [n for n in dumps if "worker_crash" in n]
    verdict["blackbox_dumps"] = len(dumps)
    if not crash_dumps:
        failures.append(f"crash drill: no worker_crash flight dump under "
                        f"{flight_dir} (found: {dumps or 'nothing'})")
        return
    path = os.path.join(flight_dir, crash_dumps[-1])
    meta, rows = _flight.read_dump(path)
    crash_rows = [r for r in rows if r.get("kind") == _flight.KIND_CRASH]
    victim = next((r.get("request") for r in crash_rows if r.get("request")), None)
    if not crash_rows:
        failures.append(f"crash drill: {path} holds no {_flight.KIND_CRASH} row")
    if victim is None:
        failures.append("crash drill: the crash row names no victim request")
        return
    child_rows = [r for r in rows if r.get("kind") == _flight.KIND_REQUEST
                  and r.get("request") == victim]
    if not child_rows:
        failures.append(f"crash drill: the dump holds no child-side "
                        f"lifecycle row for {victim} — the flight-delta "
                        f"relay never delivered the victim's ring")
    rendered = _flight.render_dump(meta, rows, request=victim)
    for needle in (victim, "worker_crash"):
        if needle not in rendered:
            failures.append(f"crash drill: obs.flight rendering of {path} "
                            f"never mentions {needle!r}")
    trace = _trace.assemble_trace(victim, events, journal_dir=journal_dir,
                                  blackbox=flight_dir)
    segs = trace.get("segments") or []
    crash_at = next((s["t0"] for s in segs if s.get("kind") == "crash"), None)
    attempts_after = [s for s in segs if s.get("kind") == "attempt"
                      and crash_at is not None and s["t1"] > crash_at]
    verdict["blackbox_trace_segments"] = len(segs)
    if crash_at is None:
        failures.append(f"crash drill: obs.trace --blackbox timeline for "
                        f"{victim} shows no crash segment")
    elif not attempts_after:
        failures.append(f"crash drill: obs.trace --blackbox timeline for "
                        f"{victim} never reaches a post-crash execution "
                        f"attempt (requeue/respawn invisible)")
    if not [s for s in segs if s.get("kind") == "blackbox"]:
        failures.append(f"crash drill: the merged timeline for {victim} "
                        f"carries no black-box marks — the dump "
                        f"contributed nothing the live events lacked")


def worst_window_p95(windows) -> Optional[float]:
    """Max per-bucket p95 across telemetry window rows (None when none)."""
    p95s = [h.get("p95_s")
            for w in windows or ()
            for h in (w.get("latency") or {}).values()
            if (h or {}).get("p95_s") is not None]
    return max(p95s) if p95s else None


class TelemetryPoller:
    """Polls the daemon's telemetry op WHILE the burst runs: every poll
    must answer a well-formed snapshot (windows ring + cumulative digest);
    an unreachable op or a torn document is a gate failure. Tracks the
    worst per-bucket window p95 seen, which the verdict stamps."""

    def __init__(self, address, interval_s: float = 0.5):
        self.address = address
        self.interval_s = interval_s
        self.polls = 0
        self.torn = 0
        self.errors = 0
        self.window_p95: Optional[float] = None
        self.last: Optional[Dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _ingest(self, stats: Dict) -> None:
        tel = stats.get("telemetry")
        if not isinstance(tel, dict) or "windows" not in tel or "cumulative" not in tel:
            self.torn += 1
            return
        self.last = stats
        p95 = worst_window_p95(tel["windows"])
        if p95 is not None and (self.window_p95 is None or p95 > self.window_p95):
            self.window_p95 = p95

    def poll_once(self) -> None:
        self.polls += 1
        try:
            with ServeClient(self.address, timeout_s=30.0) as client:
                self._ingest(client.telemetry())
        except Exception:  # noqa: BLE001 — counted; the gate decides
            self.errors += 1

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.poll_once()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,  # mct-thread: abandon(bounded-joined in stop(); the spawn/join pair spans methods, which the scope-local check cannot see)
                                        name="telemetry-poller")
        self._thread.start()

    def stop(self, settle_s: float = 0.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(5.0)
        self.poll_once()  # one final full snapshot after the burst
        # a burst shorter than one telemetry window (six tiny requests on a
        # card) closes its window only after it ends: poll up to settle_s
        # for that roll
        deadline = time.monotonic() + settle_s
        while not ((self.last or {}).get("telemetry") or {}).get("windows") \
                and time.monotonic() < deadline:
            time.sleep(self.interval_s)
            self.poll_once()


# ---------------------------------------------------------------------------
# daemon subprocesses
# ---------------------------------------------------------------------------


def _wait_for_socket(path: str, proc: subprocess.Popen, timeout_s: float) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            return False
        if os.path.exists(path):
            try:
                with ServeClient(path, timeout_s=5.0) as c:
                    c.stats()
                return True
            except OSError:
                pass
        time.sleep(0.25)
    return False


def _materialize_buckets(tmp: str) -> List[str]:
    """Write every BUCKET_SPECS scene under ``tmp`` (the daemons warm them)."""
    from maskclustering_tpu_torch.utils.synthetic import make_scene, write_scannet_layout

    names = []
    for name, params in BUCKET_SPECS:
        kw = dict(params)
        kw["image_hw"] = tuple(kw["image_hw"])
        write_scannet_layout(make_scene(**kw), tmp, name)
        names.append(name)
    return names


def _serve_cmd(sock: str, data_root: str, device: str, *args: str) -> List[str]:
    """``python -m maskclustering_tpu_torch.serve`` on ``device`` with the
    scannet config over ``data_root``."""
    return [sys.executable, "-m", "maskclustering_tpu_torch.serve", "--config", "scannet",
            "--socket", sock, "--data_root", data_root, "--device", device, *args]


def _spawn(cmd: List[str], label: str) -> subprocess.Popen:
    log(f"{label}: starting daemon: {' '.join(cmd)}")
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, cwd=REPO_ROOT,
                            env=dict(os.environ), text=True)


def _digest_line(out: str) -> Optional[Dict]:
    """The daemon's final ``digest`` line from its stdout."""
    digest = None
    for line in (out or "").splitlines():
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if isinstance(doc, dict) and doc.get("kind") == "digest":
            digest = doc
    return digest


def _drain_daemon(proc, failures: List[str], phase: str):
    """SIGTERM -> communicate; returns the parsed final digest line."""
    proc.send_signal(signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=120.0)
    except subprocess.TimeoutExpired:
        proc.kill()
        failures.append(f"{phase}: daemon did not drain within 120s of SIGTERM")
        return None
    if proc.returncode != 143:
        failures.append(f"{phase}: daemon exit code {proc.returncode} "
                        f"(expected 143 — SIGTERM-clean drain)")
    digest = _digest_line(out)
    if digest is None:
        failures.append(f"{phase}: daemon printed no final digest line")
    return digest


# ---------------------------------------------------------------------------
# the CI smoke gate: daemon subprocess + a bounded mixed-bucket burst
# ---------------------------------------------------------------------------


def run_smoke(args) -> int:
    device = daemon_device(args.device)
    tmp = tempfile.mkdtemp(prefix="mct_serve_smoke_")
    sock = os.path.join(tmp, "mct.sock")
    events = os.path.join(tmp, "serve_events.jsonl")
    flight_dir = os.path.join(tmp, "flight")
    journal_dir = os.path.join(tmp, "journals")
    warm_names = _materialize_buckets(tmp)
    log(f"smoke: materialized warm scenes {warm_names} under {tmp}")

    cmd = _serve_cmd(sock, tmp, device, "--capacity", "4", "--retrace-sanitizer",
                     # the kernel build cache rides every smoke: built on the
                     # cold path, restored on respawns (the crash drill
                     # asserts the cross-process half)
                     "--aot-cache", os.path.join(tmp, "aot"),
                     "--obs_events", events, "--warm", "+".join(warm_names),
                     "--telemetry-window", str(SMOKE_TELEMETRY_WINDOW_S),
                     "--flight-dir", flight_dir, "--journal-dir", journal_dir)
    for kv in SMOKE_CONFIG_SETS:
        cmd += ["--set", kv]
    fault_plan = args.fault_plan
    if args.crash_drill and not fault_plan:
        # one SIGKILL of the device worker under the first B-bucket
        # request: the supervisor must respawn, requeue and finish warm
        fault_plan = "crash:lg-b.device:1"
    if args.isolate_worker or args.crash_drill:
        cmd += ["--isolate-worker", "--set", "worker_heartbeat_s=30"]
    if fault_plan:
        cmd += ["--fault-plan", fault_plan]
    proc = _spawn(cmd, "smoke")
    tenant_mix: List[str] = []
    try:
        if not _wait_for_socket(sock, proc, timeout_s=args.smoke_startup_s):
            log("smoke: FAIL — daemon never became reachable")
            proc.kill()
            return 1
        # the telemetry op is polled WHILE the burst runs
        poller = TelemetryPoller(sock)
        poller.start()
        # the smoke always drives a weighted tenant mix (unless the caller
        # names one): the accounting-sums-to-global check rides every run
        tenant_mix = parse_tenant_mix(args.tenant_mix or "A:3,B:1")
        try:
            verdict = run_load(sock, requests=args.requests,
                               concurrency=args.concurrency, buckets=2,
                               deadline_s=args.deadline, resume=False,
                               tenant_mix=tenant_mix)
        finally:
            poller.stop(settle_s=2 * SMOKE_TELEMETRY_WINDOW_S)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=90.0)
    except subprocess.TimeoutExpired:
        log("smoke: FAIL — daemon did not drain within 90s of SIGTERM")
        proc.kill()
        return 1
    finally:
        if proc.poll() is None:
            proc.kill()

    digest = _digest_line(out)
    failures = []
    if proc.returncode != 143:
        failures.append(f"daemon exit code {proc.returncode} (expected 143 "
                        f"— SIGTERM-clean drain)")
    if digest is None:
        failures.append("daemon printed no final digest line")
    else:
        verdict["warmup_s"] = digest.get("warmup_s")
        if digest.get("point_shards") is not None:
            verdict["point_shards"] = int(digest["point_shards"])
        if digest.get("streaming_chunk") is not None:
            verdict["streaming_chunk"] = int(digest["streaming_chunk"])
        retrace = digest.get("retrace") or {}
        verdict["retrace_compiles"] = retrace.get("compiles")
        verdict["retrace_repeats"] = retrace.get("repeats")
        verdict["retrace_post_freeze"] = retrace.get("post_freeze")
        verdict["retrace_cache_hits"] = retrace.get("cache_hits")
        verdict["retrace_launch_keys"] = retrace.get("launch_keys")
        if retrace.get("post_freeze"):
            failures.append(f"{retrace['post_freeze']} post-freeze build(s) or new "
                            f"launch key(s) — the serve-many contract broke")
        if retrace.get("repeats"):
            failures.append(f"{retrace['repeats']} repeat build(s) — the daemon "
                            f"lost its loaded kernels")
        if not retrace.get("frozen"):
            failures.append("retrace sanitizer never froze after warm-up")
        worker = digest.get("worker") or {}
        if worker:
            verdict["worker_crashes"] = worker.get("crashes")
            verdict["worker_respawns"] = worker.get("respawns")
            # the latest child's warm-up and kernel build cache adoption
            # (after a crash drill: the respawned child's)
            verdict["worker_warmup_s"] = worker.get("warmup_s")
            verdict["worker_aot"] = worker.get("aot")
        if args.crash_drill:
            # the crash-containment contract, end to end: a real SIGKILL
            # under a request, a respawn, a typed status on the wire, and a
            # respawned worker that reached first dispatch with no build
            if not worker.get("crashes"):
                failures.append("crash drill: no worker crash was recorded")
            if not worker.get("respawns"):
                failures.append("crash drill: worker never respawned")
            if verdict.get("worker_crash_events", 0) < 1:
                failures.append("crash drill: no client saw a typed "
                                "worker_crash status event")
            if retrace.get("compiles", 0) != 0:
                failures.append(
                    f"respawned worker booked {retrace.get('compiles')} nvcc "
                    f"build(s) — the kernel build cache did not deliver a "
                    f"build-free respawn")
    # the live telemetry plane (the mid-burst poller): well-formed snapshots
    # under load, closed windows, and under the isolated worker the relay's
    # delivery of the child's counters to the parent
    isolated = bool(args.isolate_worker or args.crash_drill)
    tel = ((poller.last or {}).get("telemetry") or {})
    windows = tel.get("windows") or []
    tel_counters = (tel.get("cumulative") or {}).get("counters") or {}
    verdict["telemetry_polls"] = poller.polls
    verdict["telemetry_windows"] = len(windows)
    verdict["window_p95"] = poller.window_p95
    if poller.last is None:
        failures.append("telemetry op never answered a well-formed snapshot mid-burst")
    if poller.torn:
        failures.append(f"{poller.torn} torn/empty telemetry snapshot(s) mid-burst")
    if poller.errors:
        failures.append(f"{poller.errors} telemetry poll(s) could not reach the "
                        f"daemon mid-burst")
    if poller.last is not None:
        if not windows:
            failures.append("no telemetry window ever closed during the burst")
        if tel_counters.get("serve.requests", 0) < args.requests:
            failures.append(
                f"telemetry cumulative counters saw "
                f"{tel_counters.get('serve.requests', 0)} request(s) of "
                f"{args.requests} — the snapshot is stale or torn")
        if isolated:
            missing = [k for k in ("worker.telem_messages", "serve.requests_ok",
                                   "pipeline.host_sync")
                       if not tel_counters.get(k)]
            if missing:
                failures.append(
                    f"isolated worker relayed no {missing} counter(s) — "
                    f"the cross-process telemetry relay is dark")
    if tenant_mix:
        tenants = check_tenant_accounting(tel, verdict.get("tenant_mix_sent") or {},
                                          failures)
        if tenants:
            verdict["tenants"] = tenants
    if args.crash_drill:
        check_blackbox(flight_dir, events, journal_dir, verdict, failures)
    elif not fault_plan:
        # healthy soak: the canned default SLO spec must hold
        check_healthy_slo(tel, verdict, failures)
    if verdict["ok"] != args.requests:
        failures.append(f"only {verdict['ok']}/{args.requests} requests answered ok")
    if args.fault_plan and "flaky" in args.fault_plan and verdict["max_attempts"] < 2:
        # the daemon suspends the plan during warm-up so the drill lands on
        # the serving path; a flaky nobody retried never fired there
        failures.append("fault plan never exercised a serving-path retry")
    verdict["smoke"] = True
    verdict["device"] = device
    if failures:
        verdict["error"] = "; ".join(failures)
    print(json.dumps(verdict, sort_keys=True), flush=True)
    if not args.no_ledger:
        append_ledger_row(verdict, args.ledger)
    if failures:
        for f in failures:
            log(f"smoke: FAIL — {f}")
        return 1
    log(f"smoke: PASS — {verdict['ok']} requests, p50 {verdict['value']}s, p95 "
        f"{verdict['p95_s']}s, zero post-freeze builds and launch keys, "
        f"SIGTERM-clean drain")
    return 0


# ---------------------------------------------------------------------------
# the pack drill: packed scheduler vs sequential path, byte for byte
# ---------------------------------------------------------------------------


def _artifact_crcs(root: str) -> Dict[str, str]:
    """CRC32 every artifact under ``root`` keyed by relative path.

    ``.npz`` members are hashed per array (bytes + dtype + shape): the zip
    container embeds write timestamps, so raw file bytes differ between
    two runs that produced identical arrays."""
    import zlib

    import numpy as np

    out: Dict[str, str] = {}
    if not os.path.isdir(root):
        return out
    for dirpath, _dirs, files in os.walk(root):
        for fn in sorted(files):
            p = os.path.join(dirpath, fn)
            rel = os.path.relpath(p, root)
            if fn.endswith(".npz"):
                with np.load(p, allow_pickle=True) as z:
                    for key in sorted(z.files):
                        arr = np.asarray(z[key])
                        crc = zlib.crc32(arr.tobytes())
                        crc = zlib.crc32(str(arr.dtype).encode(), crc)
                        crc = zlib.crc32(str(arr.shape).encode(), crc)
                        out[f"{rel}:{key}"] = f"{crc & 0xffffffff:08x}"
            else:
                with open(p, "rb") as fh:
                    out[rel] = f"{zlib.crc32(fh.read()) & 0xffffffff:08x}"
    return out


def _pack_phase(tag: str, *, requests: int, extra_sets: Tuple[str, ...],
                rate: float, concurrency: int, startup_s: float,
                collect: List[Dict], device: str):
    """One drill phase: a fresh daemon over its own data_root (the synthetic
    scenes are seed-deterministic, so artifacts compare across phases), a
    bounded burst, a SIGTERM drain.

    Returns ``(verdict, final_digest, artifact_crcs, failures)``."""
    tmp = tempfile.mkdtemp(prefix=f"mct_pack_{tag}_")
    sock = os.path.join(tmp, "mct.sock")
    warm_names = _materialize_buckets(tmp)
    cmd = _serve_cmd(sock, tmp, device, "--capacity", str(max(8, requests)),
                     "--retrace-sanitizer", "--aot-cache", os.path.join(tmp, "aot"),
                     "--obs_events", os.path.join(tmp, "serve_events.jsonl"),
                     "--warm", "+".join(warm_names), "--telemetry-window", "1.0")
    for kv in SMOKE_CONFIG_SETS + tuple(extra_sets):
        cmd += ["--set", kv]
    proc = _spawn(cmd, f"pack-drill[{tag}]")
    failures: List[str] = []
    verdict: Dict = {}
    out = ""
    try:
        if not _wait_for_socket(sock, proc, timeout_s=startup_s):
            proc.kill()
            return verdict, None, {}, [f"{tag}: daemon never became reachable"]
        verdict = run_load(sock, requests=requests, concurrency=concurrency,
                           buckets=2, deadline_s=0.0, resume=False,
                           rate=rate, collect=collect)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=90.0)
    except subprocess.TimeoutExpired:
        proc.kill()
        return verdict, None, {}, [f"{tag}: daemon did not drain within 90s of SIGTERM"]
    finally:
        if proc.poll() is None:
            proc.kill()
    digest = _digest_line(out)
    if proc.returncode != 143:
        failures.append(f"{tag}: daemon exit code {proc.returncode} "
                        f"(expected 143 — SIGTERM-clean drain)")
    if digest is None:
        failures.append(f"{tag}: daemon printed no final digest line")
    else:
        retrace = digest.get("retrace") or {}
        if retrace.get("post_freeze"):
            failures.append(f"{tag}: {retrace['post_freeze']} post-freeze build(s) or "
                            f"new launch key(s) — the serve-many contract broke")
        if not retrace.get("frozen"):
            failures.append(f"{tag}: retrace sanitizer never froze")
    if verdict.get("ok") != requests:
        failures.append(f"{tag}: only {verdict.get('ok')}/{requests} requests answered ok")
    return verdict, digest, _artifact_crcs(os.path.join(tmp, "prediction")), failures


def _device_count(device: str) -> int:
    """The cards a width-S fused dispatch can spread over (1 on the CPU)."""
    if not device.startswith("cuda"):
        return 1
    import torch

    return torch.cuda.device_count()


def run_pack_drill(args) -> int:
    """The continuous-batching gate: the same mixed-bucket burst runs once
    through the sequential path and once (open loop) through the packing
    scheduler; the packed run must be byte-identical (per-scene artifact
    digests AND exported artifact CRCs), with zero post-freeze builds and
    launch keys and occupancy > 1; its p50 must stay under batch_max x the
    sequential p50 where the card count reaches the batch width."""
    device = daemon_device(args.device)
    S = max(2, int(args.pack_batch_max))
    rate = args.rate if args.rate > 0 else 12.0
    seq_results: List[Dict] = []
    pack_results: List[Dict] = []
    v_seq, _d_seq, crc_seq, failures = _pack_phase(
        "seq", requests=args.requests, extra_sets=(), rate=0.0,
        concurrency=args.concurrency, startup_s=args.smoke_startup_s,
        collect=seq_results, device=device)
    v_pack, _d_pack, crc_pack, fail_pack = _pack_phase(
        "packed", requests=args.requests,
        extra_sets=(f"serve_batch_max={S}", f"serve_batch_linger_s={args.pack_linger}"),
        rate=rate, concurrency=args.concurrency, startup_s=args.smoke_startup_s,
        collect=pack_results, device=device)
    failures += fail_pack

    def by_scene(rows: List[Dict]) -> Dict[str, set]:
        m: Dict[str, set] = {}
        for r in rows:
            if r.get("status") == "ok":
                m.setdefault(str(r.get("scene")), set()).add(
                    (r.get("digest") or {}).get("artifact"))
        return m

    # the `artifact` fingerprint is the one digest field both paths compute
    # (the fused path materialises no DeviceHandoff: `plane` is sequential-only)
    seq_dg, pack_dg = by_scene(seq_results), by_scene(pack_results)
    for scene in sorted(set(seq_dg) | set(pack_dg)):
        sa = seq_dg.get(scene, set())
        sb = pack_dg.get(scene, set())
        for label, s in (("sequential", sa), ("packed", sb)):
            if len(s) != 1 or None in s:
                failures.append(f"{label} artifact digests for {scene} not "
                                f"unanimous: {sorted(map(str, s))}")
        if sa and sb and sa != sb:
            failures.append(f"artifact digest DIVERGED for {scene}: sequential "
                            f"{sorted(map(str, sa))} vs packed {sorted(map(str, sb))}")
    if crc_seq != crc_pack:
        diff = sorted(k for k in set(crc_seq) | set(crc_pack)
                      if crc_seq.get(k) != crc_pack.get(k))
        failures.append(f"artifact CRCs diverged between the paths: "
                        f"{diff[:8]}{'...' if len(diff) > 8 else ''}")
    elif not crc_seq:
        failures.append("no artifacts found to compare — both prediction trees are empty")
    occ = v_pack.get("batch_occupancy")
    if not occ or occ <= 1.0:
        failures.append(f"batch occupancy {occ} — the packing scheduler never fused "
                        f"a batch (hist {v_pack.get('batch_hist')})")
    # the S-x latency bound is a scene-axis-parallel claim: with >= S cards
    # each lane runs on its own hardware; on fewer the fused dispatch
    # serialises its lanes, and the comparison is advisory
    n_dev = _device_count(device)
    latency_gated = n_dev >= S
    p50_seq, p50_pack = v_seq.get("value"), v_pack.get("value")
    if p50_seq and p50_pack is not None and p50_pack >= S * p50_seq:
        msg = (f"packed p50 {p50_pack}s >= {S}x sequential p50 {p50_seq}s "
               f"— batching lost to the sequential path outright")
        if latency_gated:
            failures.append(msg)
        else:
            log(f"pack-drill: ADVISORY ({n_dev} device(s) < width {S}) — {msg}")
    verdict = dict(v_pack)
    verdict["latency_gate"] = "enforced" if latency_gated else "advisory"
    verdict["pack_drill"] = True
    verdict["batch_max"] = S
    verdict["arrival_rate_rps"] = rate
    verdict["sequential_p50_s"] = p50_seq
    verdict["sequential_wall_s"] = v_seq.get("wall_s")
    verdict["crc_entries"] = len(crc_pack)
    verdict["device"] = device
    if failures:
        verdict["error"] = "; ".join(failures)
    print(json.dumps(verdict, sort_keys=True), flush=True)
    if not args.no_ledger:
        append_ledger_row(verdict, args.ledger)
    if failures:
        for f in failures:
            log(f"pack-drill: FAIL — {f}")
        return 1
    log(f"pack-drill: PASS — occupancy {occ} (hist {verdict.get('batch_hist')}), "
        f"{len(crc_pack)} artifact CRCs + per-scene digests byte-identical to "
        f"sequential, zero post-freeze builds and launch keys, p50 {p50_pack}s vs "
        f"sequential {p50_seq}s")
    return 0


# ---------------------------------------------------------------------------
# the pool drill: multi-worker serving — affinity, QoS, crash containment
# ---------------------------------------------------------------------------


def _pool_span_overlap(events: str) -> Tuple[int, int]:
    """Concurrency evidence on one device: relayed ``serve.request`` spans
    stamped with DIFFERENT ``worker_id`` whose wall windows overlap prove
    two slices executed at the same time. Returns
    ``(overlapping_pairs, worker_tagged_spans)``."""
    from maskclustering_tpu_torch.obs.events import KIND_SPAN, read_events

    spans: List[Tuple[float, float, int]] = []
    try:
        for ev in read_events(events, kinds=[KIND_SPAN]):
            if ev.get("name") != "serve.request":
                continue
            attrs = ev.get("attrs") or {}
            wid = attrs.get("worker_id")
            if wid is None:
                continue
            end = attrs.get("end_ts")
            if not isinstance(end, (int, float)):
                end = ev.get("ts", 0.0)
            dur = float(ev.get("dur_s", 0.0))
            spans.append((float(end) - dur, float(end), int(wid)))
    except OSError:
        return 0, 0
    overlaps = 0
    for i, (a0, a1, wa) in enumerate(spans):
        for b0, b1, wb in spans[i + 1:]:
            if wa != wb and min(a1, b1) - max(a0, b0) > 0.0:
                overlaps += 1
    return overlaps, len(spans)


def _pool_sched(sock: str) -> Tuple[Dict, Dict]:
    """One stats poll: (pool plane, scheduler counters), both empty when the
    daemon is not pooled (itself a drill failure downstream)."""
    with ServeClient(sock, timeout_s=30.0) as client:
        pool = client.stats().get("pool") or {}
    return pool, dict(pool.get("scheduler") or {})


def run_pool_drill(args) -> int:
    """The multi-worker serving gate (``serve/pool.py``), end to end on a
    2x1 carve (``--carve`` on the CPU, where every slice repeats the CPU;
    on one card both slices share it, without ``--carve``):

    1. warm burst — mixed buckets x weighted tenants over both slices:
       every request ok, both workers alive and dispatching.
    2. affinity — a second burst must route >= 90% bucket-warm.
    3. QoS — an open-loop saturated burst under ``heavy:3`` vs ``light:1``:
       the stride scheduler front-loads heavy's completions 3:1.
    4. quota — a burst over ``capped``'s quota answers typed ``quota``
       rejects while admitted work still lands.
    5. crash — SIGKILL worker 0's child mid-request: the victim requeues
       and finishes ok, the black box records the hop, and the respawned
       slice reaches first dispatch with no ``nvcc`` build (shared cache).

    Plus, over the whole run: per-scene artifact digests unanimous across
    slices, zero post-freeze builds and launch keys on EVERY worker, and
    overlap between worker-tagged spans.
    """
    device = daemon_device(args.device)
    tmp = tempfile.mkdtemp(prefix="mct_pool_drill_")
    sock = os.path.join(tmp, "mct.sock")
    events = os.path.join(tmp, "serve_events.jsonl")
    flight_dir = os.path.join(tmp, "flight")
    journal_dir = os.path.join(tmp, "journals")
    warm_names = _materialize_buckets(tmp)
    # a carve of K cards each needs K cards: on the CPU the JAX drill's
    # 2x1 carve holds; on a card every slice shares the visible ones
    carve = ["--carve", f"{args.pool_workers}x1"] if not device.startswith("cuda") \
        or _device_count(device) >= args.pool_workers else []
    cmd = _serve_cmd(sock, tmp, device, "--capacity", "64", "--retrace-sanitizer",
                     # the shared build cache is the drill's warm-respawn lever
                     "--aot-cache", os.path.join(tmp, "aot"),
                     "--obs_events", events, "--warm", "+".join(warm_names),
                     "--telemetry-window", "1.0",
                     "--flight-dir", flight_dir, "--journal-dir", journal_dir,
                     "--isolate-worker", "--workers", str(args.pool_workers), *carve,
                     "--tenants", "heavy:3,light:1,capped:1:2",
                     "--set", "worker_heartbeat_s=30")
    for kv in SMOKE_CONFIG_SETS:
        cmd += ["--set", kv]
    proc = _spawn(cmd, "pool-drill")
    failures: List[str] = []
    all_results: List[Dict] = []
    verdict: Dict = {"metric": "serve s/request (pool drill p50)",
                     "value": None, "unit": "s/request",
                     "pool_drill": True, "pool_workers": args.pool_workers,
                     "device": device}
    killed = False
    digest = None
    try:
        if not _wait_for_socket(sock, proc, timeout_s=args.smoke_startup_s):
            log("pool-drill: FAIL — daemon never became reachable")
            proc.kill()
            return 1

        # -- phase 1: warm burst over both slices ---------------------------
        v_warm = run_load(sock, requests=8, concurrency=4, buckets=2,
                          deadline_s=0.0, resume=False,
                          tenant_mix=parse_tenant_mix("heavy:3,light:1"),
                          collect=all_results)
        verdict["value"] = v_warm.get("value")
        if v_warm["ok"] != 8:
            failures.append(f"warm burst: {v_warm['ok']}/8 ok")
        pool, sched_warm = _pool_sched(sock)
        workers = pool.get("workers") or []
        if len(workers) != args.pool_workers:
            failures.append(f"pool reports {len(workers)} worker(s), "
                            f"expected {args.pool_workers}")
        alive = sum(1 for w in workers if w.get("alive"))
        if alive != args.pool_workers:
            failures.append(f"only {alive}/{args.pool_workers} slices alive after "
                            f"the warm burst")
        idle_workers = [w["worker_id"] for w in workers if not w.get("dispatched")]
        if idle_workers:
            failures.append(f"slice(s) {idle_workers} never dispatched — the "
                            f"scheduler is not spreading load")

        # -- phase 2: post-warm affinity ------------------------------------
        v_aff = run_load(sock, requests=8, concurrency=4, buckets=2,
                         deadline_s=0.0, resume=False,
                         tenant_mix=parse_tenant_mix("heavy:3,light:1"),
                         collect=all_results)
        if v_aff["ok"] != 8:
            failures.append(f"affinity burst: {v_aff['ok']}/8 ok")
        _pool2, sched_aff = _pool_sched(sock)
        d_hits = sched_aff.get("affinity_hits", 0) - sched_warm.get("affinity_hits", 0)
        d_miss = sched_aff.get("affinity_misses", 0) - sched_warm.get("affinity_misses", 0)
        # optimistic warmth bounds TOTAL misses at buckets x workers: a
        # (slice, bucket) pair phase 1 never exercised pays one first-sight
        # miss whenever it first dispatches; everything else routes warm
        total_miss = sched_aff.get("affinity_misses", 0)
        bound = 2 * args.pool_workers
        if total_miss > bound:
            failures.append(f"{total_miss} affinity misses ever > the "
                            f"optimistic-warmth bound {bound} (buckets x "
                            f"workers) — warmth is not sticking")
        allowed_cold = max(0, bound - sched_warm.get("affinity_misses", 0))
        adj_miss = max(0, d_miss - allowed_cold)
        routed = d_hits + adj_miss
        hit_rate = (d_hits / routed) if routed else 0.0
        verdict["affinity_hit_rate"] = round(hit_rate, 3)
        if routed and hit_rate < 0.9:
            failures.append(f"post-warm affinity hit rate {hit_rate:.0%} "
                            f"({d_hits}/{routed} beyond first-sight) < 90% "
                            f"— bucket-warm routing is not sticking")
        if not routed:
            failures.append("affinity burst dispatched nothing through the pool scheduler")

        # -- phase 3: weighted-fair QoS under saturation --------------------
        # open loop, arrivals ~instant: a backlog forms, so dequeue order IS
        # the stride scheduler's; heavy (w=3) front-loads its completions
        qos_results: List[Dict] = []
        v_qos = run_load(sock, requests=32, concurrency=4, buckets=2,
                         deadline_s=0.0, resume=False,
                         tenant_mix=parse_tenant_mix("heavy:1,light:1"),
                         rate=200.0, collect=qos_results)
        all_results.extend(qos_results)
        if v_qos["ok"] != 32:
            failures.append(f"QoS burst: {v_qos['ok']}/32 ok")
        # completion order: tag lg-%04d maps back to the arrival index, the
        # [heavy, light] cycle maps index -> tenant
        heavy_first_half = 0
        order = [r for r in qos_results if r.get("status") == "ok"]
        for r in order[:16]:
            tag = str(r.get("tag") or "")
            try:
                idx = int(tag.rsplit("-", 1)[1])
            except (IndexError, ValueError):
                continue
            if idx % 2 == 0:
                heavy_first_half += 1
        verdict["qos_heavy_first_half"] = heavy_first_half
        # 3:1 target = 12 of 16; -25% floor = 9 (unweighted gives ~8/16)
        if heavy_first_half < 9:
            failures.append(
                f"QoS: only {heavy_first_half}/16 of the first-half "
                f"completions were heavy's (3:1 weight demands >= 9) — "
                f"weighted-fair dequeue is not honoring weights")

        # -- phase 4: admission quota ---------------------------------------
        # 12 simultaneous requests for capped (quota 2): the slices' feeds
        # and in-flight slots absorb the first few, the next two queue, the
        # rest MUST answer the typed quota reject
        quota_terms: List[Dict] = []
        qlock = mct_lock("load_gen.run_pool_drill.qlock")

        def _capped(i: int) -> None:
            kw = dict(BUCKET_SPECS[i % 2][1])
            with ServeClient(sock, timeout_s=600.0) as client:
                term, _st, _lat = client.run_scene(
                    BUCKET_SPECS[i % 2][0], synthetic=kw, tag=f"cap-{i:02d}",
                    tenant="capped")
            with qlock:
                quota_terms.append(term)

        qthreads = []
        for i in range(12):
            t = threading.Thread(target=_capped, args=(i,), daemon=True)
            qthreads.append(t)
            t.start()
        for t in qthreads:
            t.join(600.0)
        q_rejects = [t for t in quota_terms if t.get("kind") == "reject"
                     and t.get("reason") == "quota"]
        q_ok = [t for t in quota_terms if t.get("status") == "ok"]
        verdict["quota_rejects"] = len(q_rejects)
        if not q_rejects:
            failures.append("quota: 12 simultaneous requests over a 2-slot "
                            "admission quota produced no typed 'quota' reject")
        elif not (q_rejects[0].get("detail") or ""):
            failures.append("quota: the reject carries no detail naming the limit")
        if not q_ok:
            failures.append("quota: no capped request was admitted at all — the "
                            "quota gate is rejecting below the limit")

        # -- phase 5: SIGKILL worker 0 mid-request --------------------------
        pool3, _ = _pool_sched(sock)
        pids = {w["worker_id"]: w.get("pid") for w in pool3.get("workers") or []}
        victim_pid = pids.get(0)
        crash_results: List[Dict] = []
        crash_box: Dict[str, Dict] = {}

        def _crash_burst() -> None:
            crash_box["verdict"] = run_load(
                sock, requests=6, concurrency=3, buckets=2, deadline_s=0.0,
                resume=False, tenant_mix=parse_tenant_mix("heavy:3,light:1"),
                collect=crash_results)

        burst_t = threading.Thread(target=_crash_burst, daemon=True)
        burst_t.start()
        # kill only once worker 0 is under a request whose receive-time
        # flight delta reached the parent (`inflight_logged`), so the black
        # box holds the victim's child-side rows
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and victim_pid:
            try:
                pool_now, _ = _pool_sched(sock)
                w0 = next((w for w in pool_now.get("workers") or []
                           if w.get("worker_id") == 0), {})
                if w0.get("inflight") and w0.get("inflight_logged"):
                    os.kill(int(victim_pid), signal.SIGKILL)
                    killed = True
                    log(f"pool-drill: SIGKILLed worker 0 child (pid {victim_pid}) "
                        f"mid-request")
                    break
            except (OSError, ProcessLookupError):
                break
            time.sleep(0.05)
        burst_t.join(600.0)
        v_crash = crash_box.get("verdict") or {}
        if not killed:
            failures.append("crash: worker 0 never held an in-flight request to "
                            "kill (or its pid was missing from stats)")
        if v_crash.get("ok") != 6:
            failures.append(f"crash burst: {v_crash.get('ok')}/6 ok — a "
                            f"neighbor's request was NOT unaffected, or the "
                            f"victim never finished")
        if killed and v_crash.get("worker_crash_events", 0) < 1:
            failures.append("crash: no client saw a typed worker_crash status event")
        verdict["worker_crash_events"] = v_crash.get("worker_crash_events")
        all_results.extend(crash_results)

        # -- drain + final digest -------------------------------------------
        digest = _drain_daemon(proc, failures, "pool drill")
    finally:
        if proc.poll() is None:
            proc.kill()

    if digest is None:
        failures.append("no final digest to assert the pool plane on")
    else:
        retrace = digest.get("retrace") or {}
        verdict["retrace_post_freeze"] = retrace.get("post_freeze")
        if retrace.get("post_freeze"):
            failures.append(f"{retrace['post_freeze']} post-freeze build(s) or new "
                            f"launch key(s) across the pool — the serve-many "
                            f"contract broke under multi-worker")
        if not retrace.get("frozen"):
            failures.append("retrace sanitizer never froze on some slice")
        per_worker = retrace.get("workers") or {}
        if len(per_worker) != args.pool_workers:
            failures.append(f"final digest carries retrace for {sorted(per_worker)} "
                            f"— expected all {args.pool_workers} slices")
        for wid, dg in sorted(per_worker.items()):
            if dg.get("post_freeze"):
                failures.append(f"worker {wid}: {dg['post_freeze']} post-freeze "
                                f"build(s) or new launch key(s)")
        # the respawned slice warm-started: its fresh child built nothing,
        # its kernels restored from the shared build cache
        if killed and (per_worker.get("0") or {}).get("compiles", 0) != 0:
            failures.append(
                f"respawned worker 0 booked "
                f"{(per_worker.get('0') or {}).get('compiles')} nvcc build(s) — "
                f"the build-cache warm respawn did not deliver")
        worker = digest.get("worker") or {}
        verdict["worker_crashes"] = worker.get("crashes")
        verdict["worker_respawns"] = worker.get("respawns")
        if killed and not worker.get("crashes"):
            failures.append("crash: the pool digest recorded no crash")
        if killed and not worker.get("respawns"):
            failures.append("crash: worker 0 never respawned")
        dpool = digest.get("pool") or {}
        verdict["pool_dispatched"] = (dpool.get("scheduler") or {}).get("dispatched")
        tenants = dpool.get("tenants") or {}
        for t in ("heavy", "light", "capped"):
            if t not in tenants:
                failures.append(f"pool digest carries no QoS row for tenant {t!r}")

    # cross-slice byte identity: every scene's artifact digest unanimous no
    # matter which worker (or respawn generation) served it
    by_scene: Dict[str, set] = {}
    for r in all_results:
        if r.get("status") == "ok":
            by_scene.setdefault(str(r.get("scene")), set()).add(
                (r.get("digest") or {}).get("artifact"))
    for scene in sorted(by_scene):
        if len(by_scene[scene]) != 1 or None in by_scene[scene]:
            failures.append(f"artifact digests for {scene} not unanimous across "
                            f"slices: {sorted(map(str, by_scene[scene]))}")
    if not by_scene:
        failures.append("no ok results carried artifact digests")

    overlaps, tagged = _pool_span_overlap(events)
    verdict["span_overlaps"] = overlaps
    verdict["worker_tagged_spans"] = tagged
    if not tagged:
        failures.append("no serve.request span carries a worker_id tag — "
                        "per-worker attribution is dark")
    elif not overlaps:
        failures.append("no two spans from different workers ever overlapped — "
                        "the pool never actually served concurrently")
    if killed:
        check_blackbox(flight_dir, events, journal_dir, verdict, failures)

    if failures:
        verdict["error"] = "; ".join(failures)
    print(json.dumps(verdict, sort_keys=True), flush=True)
    if not args.no_ledger:
        append_ledger_row(verdict, args.ledger)
    if failures:
        for f in failures:
            log(f"pool-drill: FAIL — {f}")
        return 1
    log(f"pool-drill: PASS — {args.pool_workers} slices, affinity "
        f"{verdict['affinity_hit_rate']:.0%}, heavy front-loaded "
        f"{verdict['qos_heavy_first_half']}/16, {verdict['quota_rejects']} typed "
        f"quota reject(s), crash contained ({verdict['worker_crashes']} crash / "
        f"{verdict['worker_respawns']} respawn), {overlaps} cross-worker span "
        f"overlap(s), zero post-freeze builds and launch keys on every slice")
    return 0


# ---------------------------------------------------------------------------
# the chaos drill: a killed worker mid-stream, a killed daemon mid-queue, and
# a byte-identical warm recovery through the WAL
# ---------------------------------------------------------------------------

# the streamed scene rides bucket A's shapes with its own content seed: its
# artifacts land under their own scene directory, so CRCs compare
# stream-to-stream and classic-to-classic across daemon generations
CHAOS_STREAM_SPEC: Tuple[str, Dict] = (
    "lg-s", {"num_boxes": 3, "num_frames": 10, "image_hw": [60, 80],
             "spacing": 0.06, "seed": 41})
CHAOS_IDEM_KEYS = 6


def _chaos_daemon(tmp: str, sock: str, *, events: str, retrace: bool,
                  fault_plan: Optional[str], workers: int,
                  warm_names: List[str], device: str):
    """One chaos-drill daemon generation over the SHARED tmp state
    (data_root, build cache, journal dir + WAL, stream_state): only the
    socket and events file are per generation. ``retrace=False`` is the
    cold pass (the kernels are built once, into the shared cache); armed
    generations must book zero builds."""
    carve = ["--carve", f"{workers}x1"] if not device.startswith("cuda") \
        or _device_count(device) >= workers else []
    cmd = _serve_cmd(sock, tmp, device, "--capacity", "64",
                     "--aot-cache", os.path.join(tmp, "aot"),
                     "--obs_events", events, "--warm", "+".join(warm_names),
                     "--telemetry-window", "1.0",
                     "--flight-dir", os.path.join(tmp, "flight"),
                     "--journal-dir", os.path.join(tmp, "journals"),
                     "--stream-state", os.path.join(tmp, "stream_state"),
                     "--isolate-worker", "--workers", str(workers), *carve,
                     "--set", "worker_heartbeat_s=30")
    if retrace:
        cmd.insert(cmd.index("--capacity"), "--retrace-sanitizer")
    if fault_plan:
        cmd += ["--fault-plan", fault_plan]
    for kv in SMOKE_CONFIG_SETS:
        cmd += ["--set", kv]
    return _spawn(cmd, "chaos-drill")


def _chaos_counter(sock: str, name: str, want: int, timeout_s: float = 30.0) -> int:
    """Poll the cumulative telemetry counter ``name`` until >= want (the
    child books it; the relay delivers it on its own cadence)."""
    seen = 0
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with ServeClient(sock, timeout_s=30.0) as client:
                tel = client.telemetry().get("telemetry") or {}
            counters = (tel.get("cumulative") or {}).get("counters") or {}
            seen = int(counters.get(name, 0))
        except OSError:
            pass
        if seen >= want:
            return seen
        time.sleep(0.25)
    return seen


def run_chaos_drill(args) -> int:
    """The durability gate (exit 0 pass / 1 fail), three phases over ONE
    shared data_root + build cache + admission WAL + stream_state:

    1. cold pass + worker death mid-stream: a 2x1 pool serves a classic
       burst, then a live-scan stream; the stream owner's child is
       SIGKILLed with the session open. The session must RE-OPEN from its
       per-chunk snapshot (``serve.streams_resumed``) and finish ok.
    2. daemon death mid-queue: a fresh daemon under ``die:*.admission``:
       idempotency-keyed requests are submitted until the FaultPlan
       SIGKILLs the whole daemon between the WAL admit row and the queue.
    3. warm recovery: a restarted daemon over the same journal dir replays
       every journaled-but-unanswered request from the WAL; resubmits of
       ALL keys answer ok (deduped, re-attached or fresh), the stream
       re-runs end to end, the final digest books ZERO builds (shared
       cache), and every artifact CRC equals the pre-death baseline.
    """
    device = daemon_device(args.device)
    from maskclustering_tpu_torch.utils.synthetic import make_scene, write_scannet_layout

    tmp = tempfile.mkdtemp(prefix="mct_chaos_drill_")
    warm_names = _materialize_buckets(tmp)
    sname, sparams = CHAOS_STREAM_SPEC
    skw = dict(sparams)
    skw["image_hw"] = tuple(skw["image_hw"])
    write_scannet_layout(make_scene(**skw), tmp, sname)
    # the wire form of the stream's synthetic params (JSON lists)
    swire = dict(sparams)

    failures: List[str] = []
    verdict: Dict = {"metric": "serve s/request (chaos drill p50)",
                     "value": None, "unit": "s/request", "chaos_drill": True,
                     "device": device}
    klock = mct_lock("load_gen.run_chaos_drill.klock")

    def keyed_round(sockpath: str, suffix: str, outcomes: List) -> None:
        """CHAOS_IDEM_KEYS concurrent keyed submissions; daemon death
        mid-round is the script, so transport errors record as dropped."""

        def one(i: int) -> None:
            # keys 0-2 ride lg-b, keys 3-5 lg-a: submitted in index order
            # under the phase-2 die:lg-a plan, the lg-b keys are already
            # WAL-journaled when key 3's admission SIGKILLs the daemon; the
            # mapping stays FIXED across rounds (a resubmit is the same item)
            name, params = BUCKET_SPECS[1 if i < 3 else 0]
            try:
                with ServeClient(sockpath, timeout_s=600.0) as client:
                    term, _st, lat = client.run_scene(
                        name, synthetic=dict(params), tag=f"chaos-{i:02d}{suffix}",
                        idem=f"chaos-{i:02d}")
            except Exception as e:  # noqa: BLE001 — the daemon dying IS the drill
                term, lat = {"kind": "dropped", "error": str(e)[:160]}, None
            with klock:
                outcomes.append((i, term, lat))

        threads = []
        for i in range(CHAOS_IDEM_KEYS):
            t = threading.Thread(target=one, args=(i,), daemon=True,
                                 name=f"chaos-key-{i}{suffix}")
            threads.append(t)
            t.start()
            time.sleep(0.2)  # admission-order stagger, not a correctness gate
        for t in threads:
            t.join(600.0)

    # -- phase 1: cold pass + SIGKILL the stream owner mid-stream -----------
    sock1 = os.path.join(tmp, "mct1.sock")
    events1 = os.path.join(tmp, "serve_events_1.jsonl")
    proc = _chaos_daemon(tmp, sock1, events=events1, retrace=False, fault_plan=None,
                         workers=args.pool_workers, warm_names=warm_names, device=device)
    streams_resumed = 0
    digest1 = None
    try:
        if not _wait_for_socket(sock1, proc, timeout_s=args.smoke_startup_s):
            log("chaos-drill: FAIL — phase-1 daemon never became reachable")
            proc.kill()
            return 1
        v_base = run_load(sock1, requests=6, concurrency=3, buckets=2,
                          deadline_s=0.0, resume=False)
        verdict["value"] = v_base.get("value")
        verdict["p95_s"] = v_base.get("p95_s")
        verdict["requests"] = v_base.get("requests")
        verdict["concurrency"] = v_base.get("concurrency")
        if v_base.get("ok") != 6:
            failures.append(f"baseline burst: {v_base.get('ok')}/6 ok")
        with ServeClient(sock1, timeout_s=600.0) as sc:
            ev1, _st = sc.stream_chunk(sname, chunk=5, synthetic=dict(swire))
            if ev1.get("status") != "ok" or ev1.get("done"):
                failures.append(f"stream chunk 1 answered {ev1.get('kind')}/"
                                f"{ev1.get('status')} done={ev1.get('done')} "
                                f"(want ok, not done)")
            owner_pid = None
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline and owner_pid is None:
                pool_now, _sched = _pool_sched(sock1)
                for w in pool_now.get("workers") or []:
                    if w.get("open_streams") and w.get("pid"):
                        owner_pid = int(w["pid"])
                        break
                if owner_pid is None:
                    time.sleep(0.1)
            if owner_pid is None:
                failures.append("stream owner slice never showed an open session "
                                "in stats — nothing to kill")
            else:
                os.kill(owner_pid, signal.SIGKILL)
                log(f"chaos-drill: SIGKILLed stream owner child (pid {owner_pid}) "
                    f"with the session open")
            # the continuation op: the snapshot must re-open the session on
            # a warm slice (a stream_lost reject is the pre-WAL behaviour)
            ev2, _st2 = sc.stream_chunk(sname, chunk=5, synthetic=dict(swire))
            if ev2.get("status") != "ok" or not ev2.get("done"):
                failures.append(
                    f"post-kill stream chunk answered "
                    f"{ev2.get('kind')}/{ev2.get('status') or ev2.get('reason')}"
                    f" — the session did not fail over from its snapshot")
            fin, _stf = sc.stream_end(sname)
            if fin.get("status") != "ok":
                failures.append(f"stream_end after failover answered "
                                f"{fin.get('kind')}/{fin.get('status')}")
        streams_resumed = _chaos_counter(sock1, "serve.streams_resumed", 1)
        if streams_resumed < 1:
            failures.append("serve.streams_resumed never booked — the session was "
                            "rebuilt from scratch (or lost), not resumed from its "
                            "snapshot")
        digest1 = _drain_daemon(proc, failures, "chaos phase 1")
    finally:
        if proc.poll() is None:
            proc.kill()
    if digest1 is not None:
        worker1 = digest1.get("worker") or {}
        if not worker1.get("crashes"):
            failures.append("phase 1: the pool digest recorded no worker crash for "
                            "the SIGKILLed stream owner")
        if not worker1.get("respawns"):
            failures.append("phase 1: the killed slice never respawned")
    crc_base = _artifact_crcs(os.path.join(tmp, "prediction"))
    if not crc_base:
        failures.append("phase 1 exported no artifacts to baseline")

    # -- phase 2: a scripted daemon SIGKILL mid-queue -----------------------
    sock2 = os.path.join(tmp, "mct2.sock")
    events2 = os.path.join(tmp, "serve_events_2.jsonl")
    # the die fires at the FIRST lg-a admission: the staggered lg-b keys
    # before it are WAL-journaled but unanswered, the lg-a key itself is
    # journaled (admit flushes BEFORE the seam), later keys never reach
    # admission — every torn state the restart must reconcile
    proc = _chaos_daemon(tmp, sock2, events=events2, retrace=True,
                         fault_plan="die:lg-a.admission:1", workers=args.pool_workers,
                         warm_names=warm_names, device=device)
    outcomes2: List[Tuple[int, Dict, Optional[float]]] = []
    child_pids: List[int] = []
    try:
        if not _wait_for_socket(sock2, proc, timeout_s=args.smoke_startup_s):
            log("chaos-drill: FAIL — phase-2 daemon never became reachable")
            proc.kill()
            return 1
        pool2, _sched2 = _pool_sched(sock2)
        child_pids = [int(w["pid"]) for w in pool2.get("workers") or [] if w.get("pid")]
        keyed_round(sock2, "", outcomes2)
        try:
            proc.wait(timeout=60.0)
        except subprocess.TimeoutExpired:
            failures.append("phase 2: the die FaultPlan never killed the daemon "
                            "(still alive after the keyed burst)")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30.0)
    if proc.returncode != -signal.SIGKILL:
        failures.append(f"phase 2: daemon exit {proc.returncode} (expected "
                        f"-{int(signal.SIGKILL)} — the scripted admission-seam SIGKILL)")
    for pid in child_pids:
        # the daemon died uncleanly by design; its orphaned slice children
        # exit on pipe EOF, but must not race phase 3's artifact writes
        try:
            os.kill(pid, signal.SIGKILL)
        except (OSError, ProcessLookupError):
            pass
    dropped = sum(1 for _i, t, _l in outcomes2 if t.get("kind") == "dropped")
    verdict["chaos_dropped"] = dropped
    if not dropped:
        failures.append("phase 2: every keyed request answered before the daemon "
                        "died — nothing was left mid-queue for the WAL to prove")

    # -- phase 3: warm restart, WAL replay, keyed resubmit, byte identity ---
    sock3 = os.path.join(tmp, "mct3.sock")
    events3 = os.path.join(tmp, "serve_events_3.jsonl")
    proc = _chaos_daemon(tmp, sock3, events=events3, retrace=True, fault_plan=None,
                         workers=args.pool_workers, warm_names=warm_names, device=device)
    outcomes3: List[Tuple[int, Dict, Optional[float]]] = []
    digest3 = None
    try:
        if not _wait_for_socket(sock3, proc, timeout_s=args.smoke_startup_s):
            log("chaos-drill: FAIL — restarted daemon never became reachable")
            proc.kill()
            return 1
        with ServeClient(sock3, timeout_s=30.0) as client:
            durable = client.stats().get("durable") or {}
        if not durable.get("wal_replayed"):
            failures.append(f"restart replayed nothing from the WAL (durable "
                            f"panel: {durable}) — the journaled mid-queue "
                            f"requests were lost")
        keyed_round(sock3, "-r2", outcomes3)
        ok3 = sum(1 for _i, t, _l in outcomes3 if t.get("status") == "ok")
        deduped3 = sum(1 for _i, t, _l in outcomes3 if t.get("deduped"))
        verdict["chaos_resubmit_ok"] = ok3
        verdict["chaos_deduped_terminals"] = deduped3
        if ok3 != CHAOS_IDEM_KEYS:
            bad = [(i, t.get("kind"), t.get("status") or t.get("reason") or t.get("error"))
                   for i, t, _l in sorted(outcomes3, key=lambda o: o[0])
                   if t.get("status") != "ok"]
            failures.append(f"resubmit round: {ok3}/{CHAOS_IDEM_KEYS} keys answered "
                            f"ok ({bad}) — eventual completion across the daemon "
                            f"death does not hold")
        # the stream re-runs end to end on the restarted daemon (a fresh
        # session: phase 1's stream_end deleted its settled snapshot)
        with ServeClient(sock3, timeout_s=600.0) as sc:
            final, chunk_events = sc.stream_scene(sname, chunk=5, synthetic=dict(swire))
        if final.get("status") != "ok" or any(e.get("status") != "ok"
                                              for e in chunk_events):
            failures.append(f"restarted-daemon stream answered {final.get('kind')}/"
                            f"{final.get('status')} — the warm restart does not "
                            f"serve streams")
        digest3 = _drain_daemon(proc, failures, "chaos phase 3")
    finally:
        if proc.poll() is None:
            proc.kill()

    if digest3 is None:
        failures.append("no phase-3 digest to assert durability on")
    else:
        durable3 = digest3.get("durable") or {}
        verdict["wal_replayed"] = durable3.get("wal_replayed")
        verdict["wal_deduped"] = durable3.get("wal_deduped")
        verdict["journals_pruned"] = durable3.get("journals_pruned")
        if not durable3.get("wal_replayed"):
            failures.append("phase 3 digest books wal_replayed=0")
        if not (durable3.get("wal_deduped", 0) or durable3.get("wal_reattached", 0)):
            failures.append("no resubmitted key deduped or re-attached — the "
                            "idempotency contract never engaged")
        retrace3 = digest3.get("retrace") or {}
        verdict["retrace_compiles"] = retrace3.get("compiles")
        if retrace3.get("compiles", 0) != 0:
            failures.append(
                f"restarted daemon booked {retrace3.get('compiles')} nvcc build(s) "
                f"— the shared build cache did not deliver a build-free recovery")
        if retrace3.get("post_freeze"):
            failures.append(f"{retrace3['post_freeze']} post-freeze build(s) or new "
                            f"launch key(s) on the restarted daemon")
    verdict["streams_resumed"] = max(
        streams_resumed,
        int(((digest1 or {}).get("worker") or {}).get("streams_resumed") or 0))

    crc_final = _artifact_crcs(os.path.join(tmp, "prediction"))
    if crc_base and crc_final != crc_base:
        diff = sorted(k for k in set(crc_base) | set(crc_final)
                      if crc_base.get(k) != crc_final.get(k))
        failures.append(f"artifact CRCs diverged across the daemon death: "
                        f"{diff[:8]}{'...' if len(diff) > 8 else ''}")
    verdict["crc_entries"] = len(crc_final)

    if failures:
        verdict["error"] = "; ".join(failures)
    print(json.dumps(verdict, sort_keys=True), flush=True)
    if not args.no_ledger:
        append_ledger_row(verdict, args.ledger)
    if failures:
        for f in failures:
            log(f"chaos-drill: FAIL — {f}")
        return 1
    log(f"chaos-drill: PASS — stream failed over ({verdict['streams_resumed']} "
        f"resume(s)), daemon death replayed {verdict['wal_replayed']} request(s) "
        f"from the WAL ({verdict['chaos_deduped_terminals']} deduped terminal(s)), "
        f"{verdict['crc_entries']} artifact CRCs byte-identical, zero builds on the "
        f"restarted daemon")
    return 0


# ---------------------------------------------------------------------------
# the canary: the audited goldens regeneration + the canary drill
# ---------------------------------------------------------------------------

DEFAULT_GOLDENS = os.path.join(REPO_ROOT, "canary_goldens.json")
SURFACE_BASELINE = os.path.join(REPO_ROOT, "compile_surface_baseline.json")


def run_write_goldens(args) -> int:
    """Regenerate the canary goldens: ONE in-process canary round on the
    CPU (the goldens are CPU-generated, as the JAX tool's are) under the
    census cfg (``obs/canary.goldens_config``) over the committed surface
    baseline's workload. The resulting git diff IS the audit artifact:
    inspect it before committing."""
    from maskclustering_tpu_torch.obs import canary as _canary

    cfg = _canary.goldens_config()
    path = args.write_goldens
    log(f"write-goldens: census cfg ({cfg.count_dtype}, fpad {cfg.frame_pad_multiple}, "
        f"mpad {cfg.mask_pad_multiple}), workload from {SURFACE_BASELINE}")
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="mct_goldens_") as data_root:
        try:
            goldens = _canary.generate_goldens(cfg.replace(data_root=data_root),
                                               baseline_path=SURFACE_BASELINE,
                                               device="cpu")
        except (RuntimeError, ValueError) as e:
            log(f"write-goldens: FAIL — {e}")
            return 1
    doc = _canary.write_goldens(path, goldens, config={
        "count_dtype": cfg.count_dtype,
        "distance_threshold": cfg.distance_threshold,
        "frame_pad_multiple": cfg.frame_pad_multiple,
        "mask_pad_multiple": cfg.mask_pad_multiple,
        "point_chunk": cfg.point_chunk,
        "backend": "cpu",
    })
    print(json.dumps({"kind": "goldens", "path": path, "coords": sorted(doc["goldens"]),
                      "seconds": round(time.monotonic() - t0, 1)}, sort_keys=True),
          flush=True)
    log(f"write-goldens: wrote {len(doc['goldens'])} coordinate(s) to {path} — "
        f"audit the diff before committing")
    return 0


def _spawn_sentinel_daemon(tmp: str, *, goldens: str, interval_s: float,
                           device: str, fault_plan: Optional[str] = None):
    """A warm-baseline daemon with the sentinel armed (the census knobs are
    the scannet config's own: the drill probes under EXACTLY the goldens'
    cfg, so no --set overrides here)."""
    sock = os.path.join(tmp, "mct.sock")
    events = os.path.join(tmp, "serve_events.jsonl")
    flight_dir = os.path.join(tmp, "flight")
    cmd = _serve_cmd(sock, tmp, device, "--retrace-sanitizer",
                     "--aot-cache", os.path.join(tmp, "aot"),
                     "--obs_events", events, "--warm-baseline", SURFACE_BASELINE,
                     "--telemetry-window", "1.0", "--flight-dir", flight_dir,
                     "--journal-dir", os.path.join(tmp, "journals"),
                     "--canary-interval", str(interval_s), "--canary-goldens", goldens)
    if fault_plan:
        cmd += ["--fault-plan", fault_plan]
    return _spawn(cmd, "canary-drill"), sock, events, flight_dir


def _poll_sentinel(sock: str, done, timeout_s: float) -> Optional[Dict]:
    """Poll ``status detail=sentinel`` until ``done(snapshot)`` or timeout;
    returns the last sentinel snapshot (None when never reachable)."""
    deadline = time.monotonic() + timeout_s
    snap = None
    while time.monotonic() < deadline:
        try:
            with ServeClient(sock, timeout_s=30.0) as client:
                snap = client.sentinel().get("sentinel") or snap
        except OSError:
            pass
        if snap is not None and done(snap):
            return snap
        time.sleep(0.2)
    return snap


def _slo_check(events: str) -> Tuple[int, str]:
    """Offline SLO verdict over the daemon's events file
    (``python -m maskclustering_tpu_torch.obs.slo --events ... --check``)."""
    r = subprocess.run(
        [sys.executable, "-m", "maskclustering_tpu_torch.obs.slo", "--events", events,
         "--check"], capture_output=True, text=True, cwd=REPO_ROOT,
        env=dict(os.environ), timeout=120.0)
    return r.returncode, (r.stdout or "") + (r.stderr or "")


def run_canary_drill(args) -> int:
    """The end-to-end sentinel gate, two phases against the COMMITTED goldens:

    1. clean soak: a sentinel-armed warm-baseline daemon idles through >= 2
       canary rounds: zero drift, every goldens coordinate verified, zero
       post-freeze builds and launch keys (probes replay warm kernels), and
       the offline SLO check passes.
    2. corrupt drill: the same daemon under ``corrupt:A.host`` (a silent
       bit-flip of scene A's pulled assignment, which the retry ladder
       cannot heal): drift on the FIRST canary round, the typed
       ``canary.drift`` event and the ``canary_drift`` flight dump naming
       the coordinate, and ``obs.slo --check`` exiting 2 on the
       zero-tolerance ``correctness`` objective.
    """
    device = daemon_device(args.device)
    from maskclustering_tpu_torch.analysis.retrace import expected_goldens_coords
    from maskclustering_tpu_torch.obs import flight as _flight

    goldens = args.canary_goldens or DEFAULT_GOLDENS
    if not os.path.exists(goldens):
        log(f"canary-drill: FAIL — no goldens at {goldens}; generate with "
            f"--write-goldens and commit")
        return 1
    expected = expected_goldens_coords()
    failures: List[str] = []
    verdict: Dict = {"metric": "serve canary time-to-detection (s)",
                     "value": None, "unit": "s", "canary_drill": True, "device": device}

    # -- phase 1: clean soak ------------------------------------------------
    tmp = tempfile.mkdtemp(prefix="mct_canary_clean_")
    proc, sock, events, _fd = _spawn_sentinel_daemon(
        tmp, goldens=goldens, interval_s=args.canary_interval, device=device)
    digest = None
    try:
        if not _wait_for_socket(sock, proc, timeout_s=args.smoke_startup_s):
            log("canary-drill: FAIL — clean-soak daemon never became reachable")
            proc.kill()
            return 1
        snap = _poll_sentinel(sock, lambda s: int(s.get("rounds", 0)) >= 2,
                              timeout_s=180.0)
        digest = _drain_daemon(proc, failures, "clean soak")
    finally:
        if proc.poll() is None:
            proc.kill()
    if snap is None or int(snap.get("rounds", 0)) < 2:
        failures.append(f"clean soak: sentinel completed "
                        f"{int((snap or {}).get('rounds', 0))} round(s) in 180s "
                        f"(need >= 2)")
    if snap:
        if int(snap.get("drift_total", 0)):
            failures.append(f"clean soak: {snap['drift_total']} drift event(s) "
                            f"against committed goldens — outputs changed or "
                            f"goldens are stale")
        seen = set(snap.get("coords") or ())
        if seen != expected:
            failures.append(f"clean soak: verified coordinates {sorted(seen)} != "
                            f"goldens coordinates {sorted(expected)}")
        verdict["canary_probes"] = int(snap.get("rounds", 0)) * len(expected)
        verdict["digest_coord"] = ",".join(sorted(seen))
    if digest:
        retrace = digest.get("retrace") or {}
        if retrace.get("post_freeze"):
            failures.append(f"clean soak: {retrace['post_freeze']} post-freeze "
                            f"build(s) or new launch key(s) — canary probes must "
                            f"replay warm kernels")
        if not (digest.get("canary") or {}).get("rounds"):
            failures.append("clean soak: the final digest carries no canary round "
                            "count — the sentinel summary is dark")
    rc, out = _slo_check(events)
    if rc != 0:
        failures.append(f"clean soak: offline SLO check exited {rc} (want 0): "
                        f"{out.strip()[:200]}")

    # -- phase 2: the corrupt drill -----------------------------------------
    tmp2 = tempfile.mkdtemp(prefix="mct_canary_corrupt_")
    proc, sock, events2, flight_dir = _spawn_sentinel_daemon(
        tmp2, goldens=goldens, interval_s=args.canary_interval, device=device,
        fault_plan="corrupt:A.host")
    t_start = time.monotonic()
    snap2 = None
    detect_s = None
    try:
        if not _wait_for_socket(sock, proc, timeout_s=args.smoke_startup_s):
            log("canary-drill: FAIL — corrupt-drill daemon never became reachable")
            proc.kill()
            return 1
        # >= 2 drift events: the burn-rate rule pages on repeats, never on
        # a single blip (obs/slo.py)
        snap2 = _poll_sentinel(sock, lambda s: int(s.get("drift_total", 0)) >= 2,
                               timeout_s=180.0)
        detect_s = time.monotonic() - t_start
        _drain_daemon(proc, failures, "corrupt drill")
    finally:
        if proc.poll() is None:
            proc.kill()
    if snap2 is None:
        failures.append("corrupt drill: sentinel op never answered")
    else:
        rounds2 = int(snap2.get("rounds", 0))
        drift2 = int(snap2.get("drift_total", 0))
        verdict["canary_drift"] = drift2
        verdict["value"] = round(detect_s, 1)
        if drift2 < 2:
            failures.append(f"corrupt drill: only {drift2} drift event(s) after "
                            f"{rounds2} round(s) — the bit-flip went undetected")
        elif rounds2 and drift2 < rounds2:
            # every round probes the corrupted scene: fewer drifts than
            # rounds means some probe of A silently passed
            failures.append(f"corrupt drill: {drift2} drift(s) over {rounds2} "
                            f"round(s) — detection missed round(s)")
        if not snap2.get("drift_coords"):
            failures.append("corrupt drill: no drift coordinate recorded")
    from maskclustering_tpu_torch.obs.events import KIND_DRIFT, read_events

    drift_events = list(read_events(events2, kinds=[KIND_DRIFT])) \
        if os.path.exists(events2) else []
    if not drift_events:
        failures.append(f"corrupt drill: no typed canary.drift event in {events2}")
    elif not (drift_events[0].get("coord") and drift_events[0].get("fields")):
        failures.append("corrupt drill: the canary.drift event names no "
                        "coordinate/fields — drift is unattributable")
    dumps = sorted(os.listdir(flight_dir)) if os.path.isdir(flight_dir) else []
    drift_dumps = [n for n in dumps if "canary_drift" in n]
    if not drift_dumps:
        failures.append(f"corrupt drill: no canary_drift flight dump under "
                        f"{flight_dir} (found: {dumps or 'nothing'})")
    else:
        _meta, rows = _flight.read_dump(os.path.join(flight_dir, drift_dumps[-1]))
        if not any(r.get("kind") == "canary.drift" and r.get("coord") for r in rows):
            failures.append("corrupt drill: the flight dump carries no canary.drift "
                            "row naming the coordinate")
    # the SLO plane must page, naming the zero-tolerance objective
    rc2, out2 = _slo_check(events2)
    if rc2 != 2:
        failures.append(f"corrupt drill: offline SLO check exited {rc2} (want 2 — "
                        f"the correctness objective must page)")
    elif "correctness" not in out2:
        failures.append(f"corrupt drill: SLO violation names no 'correctness' "
                        f"objective: {out2.strip()[:200]}")

    if failures:
        verdict["error"] = "; ".join(failures)
    print(json.dumps(verdict, sort_keys=True), flush=True)
    if not args.no_ledger:
        append_ledger_row(verdict, args.ledger)
    if failures:
        for f in failures:
            log(f"canary-drill: FAIL — {f}")
        return 1
    log(f"canary-drill: PASS — clean soak held goldens, corruption detected in "
        f"{verdict['value']}s ({verdict.get('canary_drift')} drift event(s)), SLO "
        f"paged on correctness")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m maskclustering_tpu_torch.tools.load_gen",
        description="mct-serve load generator (+ --smoke CI gate) for the port")
    parser.add_argument("--socket", default=None, help="daemon AF_UNIX socket path")
    parser.add_argument("--host", default=None, help="daemon TCP host")
    parser.add_argument("--port", type=int, default=0, help="daemon TCP port")
    parser.add_argument("--requests", type=int, default=8,
                        help="total requests to fire (default 8)")
    parser.add_argument("--concurrency", type=int, default=4,
                        help="concurrent client connections (default 4)")
    parser.add_argument("--buckets", type=int, default=2,
                        help="how many synthetic shape buckets to mix (1..2, default 2)")
    parser.add_argument("--deadline", type=float, default=0.0,
                        help="per-request deadline_s (0 = none)")
    parser.add_argument("--tenant-mix", default=None, metavar="A:3,B:1",
                        help="weighted tenant identities stamped on the burst "
                             "(name:weight, comma-joined); arms the per-tenant "
                             "accounting assertions (smoke default: A:3,B:1)")
    parser.add_argument("--rate", type=float, default=0.0,
                        help="open-loop arrival rate in requests/s: request i is "
                             "released at t0 + i/rate regardless of in-flight count "
                             "(0 = closed loop driven by --concurrency)")
    parser.add_argument("--resume", action="store_true",
                        help="send resume=true (repeats become artifact skips — "
                             "throughput numbers then measure admission, not execution)")
    parser.add_argument("--ledger", default=None,
                        help="perf ledger path (default: PERF_LEDGER_TORCH.jsonl / "
                             "$MCT_PERF_LEDGER)")
    parser.add_argument("--no-ledger", action="store_true",
                        help="do not append a serve ledger row")
    parser.add_argument("--shutdown", action="store_true",
                        help="send a shutdown op after the burst")
    parser.add_argument("--device", default=None,
                        help="torch device of every daemon a mode spawns (default: "
                             "the CUDA card, which must exist; 'cpu' serves the plain "
                             "torch path on the CPU)")
    parser.add_argument("--smoke", action="store_true",
                        help="self-contained CI smoke: spawn a daemon subprocess, "
                             "assert clean drain + zero post-freeze builds and "
                             "launch keys")
    parser.add_argument("--isolate-worker", action="store_true",
                        help="smoke: run the daemon with the process-isolated "
                             "worker (serve/supervisor.py)")
    parser.add_argument("--crash-drill", action="store_true",
                        help="smoke: SIGKILL the isolated worker under a request "
                             "(crash:lg-b.device:1 unless --fault-plan overrides) "
                             "and assert respawn, requeue, all-ok, and a respawned "
                             "worker that builds no kernel (implies --isolate-worker)")
    parser.add_argument("--smoke-startup-s", type=float, default=180.0,
                        help="smoke: max seconds for daemon warm-up before first request")
    parser.add_argument("--fault-plan", default=None,
                        help="smoke only: FaultPlan spec passed to the daemon "
                             "(e.g. 'flaky:lg-b:1')")
    parser.add_argument("--pack-drill", action="store_true",
                        help="the continuous-batching gate: one sequential daemon + "
                             "one packing daemon over the same mixed-bucket burst; "
                             "artifact CRCs and per-scene digests must match byte for "
                             "byte, zero post-freeze builds and launch keys, "
                             "occupancy > 1")
    parser.add_argument("--pack-batch-max", type=int, default=3,
                        help="pack drill: serve_batch_max for the packing daemon "
                             "(default 3)")
    parser.add_argument("--pack-linger", type=float, default=0.3,
                        help="pack drill: serve_batch_linger_s for the packing "
                             "daemon (default 0.3)")
    parser.add_argument("--pool-drill", action="store_true",
                        help="the multi-worker serving gate: a 2-slice pool must "
                             "route >= 90%% bucket-warm, honor 3:1 weighted-fair "
                             "dequeue and admission quotas, contain a mid-request "
                             "SIGKILL of worker 0, serve byte-identical artifacts on "
                             "every slice, and overlap requests across workers — with "
                             "zero post-freeze builds and launch keys")
    parser.add_argument("--pool-workers", type=int, default=2,
                        help="pool drill: slice count (default 2)")
    parser.add_argument("--chaos-drill", action="store_true",
                        help="the durability gate, three daemon generations over one "
                             "shared WAL + build cache + stream_state: SIGKILL a pool "
                             "child mid-stream, SIGKILL the whole daemon mid-queue via "
                             "a die:*.admission FaultPlan, then restart — WAL replay + "
                             "idempotent resubmit must answer EVERY key ok with "
                             "byte-identical artifacts and no build")
    parser.add_argument("--write-goldens", nargs="?", const=DEFAULT_GOLDENS,
                        default=None, metavar="PATH",
                        help="regenerate canary_goldens.json on the CPU (flag alone: "
                             "the repo-root file) via one in-process canary round "
                             "under the census cfg — audit the git diff before "
                             "committing")
    parser.add_argument("--canary-drill", action="store_true",
                        help="the sentinel gate: clean soak (zero drift, zero "
                             "post-freeze builds and launch keys) then a scripted "
                             "corrupt:A.host bit-flip that must be detected within "
                             "one canary round, dump a postmortem and page the SLO "
                             "correctness objective")
    parser.add_argument("--canary-goldens", default=None, metavar="PATH",
                        help="committed goldens for --canary-drill (default: the "
                             "repo-root canary_goldens.json)")
    parser.add_argument("--canary-interval", type=float, default=1.0,
                        help="--canary-drill scheduler period seconds (default 1.0)")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.write_goldens:
        return run_write_goldens(args)
    if args.canary_drill:
        return run_canary_drill(args)
    if args.chaos_drill:
        return run_chaos_drill(args)
    if args.pool_drill:
        return run_pool_drill(args)
    if args.pack_drill:
        return run_pack_drill(args)
    if args.smoke:
        return run_smoke(args)
    if not args.socket and not args.host:
        parser.error("need --socket or --host/--port (or --smoke)")
    tenant_mix = parse_tenant_mix(args.tenant_mix)
    verdict = run_load(_address(args), requests=args.requests,
                       concurrency=args.concurrency, buckets=args.buckets,
                       deadline_s=args.deadline, resume=args.resume,
                       tenant_mix=tenant_mix, rate=args.rate)
    tenant_failures: List[str] = []
    with ServeClient(_address(args), timeout_s=30.0) as client:
        stats = client.telemetry()
        tel = stats.get("telemetry") or {}
        if tel:
            verdict["telemetry_windows"] = len(tel.get("windows") or [])
            verdict["window_p95"] = worst_window_p95(tel.get("windows"))
            if tenant_mix:
                tenants = check_tenant_accounting(
                    tel, verdict.get("tenant_mix_sent") or {}, tenant_failures)
                if tenants:
                    verdict["tenants"] = tenants
        retrace = stats.get("retrace") or {}
        if retrace:
            verdict["retrace_compiles"] = retrace.get("compiles")
            verdict["retrace_repeats"] = retrace.get("repeats")
            verdict["retrace_post_freeze"] = retrace.get("post_freeze")
        if args.shutdown:
            client.shutdown()
    for f in tenant_failures:
        # against a long-lived daemon earlier (possibly untenanted) traffic
        # skews the cumulative sums: warn, don't gate (the smoke runs the
        # same check against a fresh daemon and gates)
        log(f"WARNING — {f}")
    print(json.dumps(verdict, sort_keys=True), flush=True)
    if not args.no_ledger:
        append_ledger_row(verdict, args.ledger)
    if verdict["failed"] or verdict["ok"] < args.requests:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
