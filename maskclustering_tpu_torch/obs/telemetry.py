"""Live serving telemetry plane: windowed snapshots (the port's copy of
``maskclustering_tpu/obs/telemetry.py``).

The port has no retrace sanitizer (the XLA compile surface, ROADMAP A10):
its reads answer as the JAX package's do with the sanitizer off, its
default — no ``retrace.live.*`` gauges and 0 post-warm violations.

- **cross-process relay** — the worker subprocess (serve/worker_main.py)
  periodically, and at request boundaries, ships a ``telem`` line over its
  stdio JSONL pipe: counter/gauge DELTAS of its metrics registry
  (``metrics.snapshot_delta``) plus the spans completed since the last
  flush. The supervisor folds counters into the parent registry under the
  SAME flat names and REPLAYS the spans through ``obs.record_span`` — so
  the Serving report, the span tables and the windowed aggregator read
  alike in-process and isolated, modulo the ``worker.*`` relay bookkeeping
  counters and a ``worker_pid`` span attr (the process tag). The wire
  document is the JAX package's: either package folds the other's lines.

- **windowed aggregation** — a rolling bounded ring of per-window rows
  (request latency by shape bucket, queue depth/wait, rejects by reason,
  worker crashes/respawns, AOT hits, post-warm compile violations),
  closed by a ticker thread at a fixed cadence and appended as
  schema-versioned ``telemetry`` rows to the events JSONL when obs is
  armed. The daemon's ``status`` op serves the ring over the wire
  (``detail: "telemetry"``), and a crash leaves every closed window on
  disk.

Thread shape: the module-global aggregator handle is guarded by its own
lock; the aggregator never calls into another
locked subsystem while holding its lock (registry snapshots are taken
BEFORE the window lock, event emission happens AFTER release), and the
ticker thread is bounded-joined at stop.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from maskclustering_tpu_torch.analysis.lock_sanitizer import mct_lock
from maskclustering_tpu_torch.obs import metrics as _metrics
from maskclustering_tpu_torch.obs.events import KIND_SPAN, KIND_TELEMETRY
from maskclustering_tpu_torch.obs.metrics import Histogram

TELEM_SCHEMA = 1          # the pipe message's own version stamp
KIND_TELEM = "telem"      # the stdio-pipe message kind (worker -> parent)

# bounded relay buffers: a burst must cost dropped SPANS (counted), never
# unbounded child memory or a pipe line the parent cannot parse
RELAY_SPAN_CAP = 1024
# counter families worth shipping verbatim in a window's cumulative view
CUMULATIVE_PREFIXES = ("serve.", "retrace.", "aot_cache.", "worker.",
                      "pipeline.", "run.", "compile_cache.", "canary.")


def _bucket_key(bucket) -> str:
    """One stable string key per shape bucket ('all' when unknown)."""
    if not bucket:
        return "all"
    try:
        return "x".join(str(int(b)) for b in bucket)
    except (TypeError, ValueError):
        return str(bucket)


# ---------------------------------------------------------------------------
# child half: relay sink + delta collector (serve/worker_main.py)
# ---------------------------------------------------------------------------


class RelaySink:
    """An in-memory span buffer with the EventSink emit surface.

    The worker subprocess arms its tracer with this instead of a file:
    completed spans queue here (bounded; overflow counted, never blocking)
    until the next ``telem`` flush ships them up the pipe. Metrics-flush
    events are ignored — the relay ships registry DELTAS itself.
    """

    path = "<telemetry-relay>"

    def __init__(self, cap: int = RELAY_SPAN_CAP):
        self._lock = mct_lock("obs.telemetry.RelaySink._lock")
        self._spans: Deque[Dict] = deque(maxlen=cap)
        self._dropped = 0

    def emit(self, kind: str, payload: Dict) -> None:
        if kind != KIND_SPAN:
            return
        row = {"name": payload.get("name"),
               "dur_s": payload.get("dur_s", 0.0),
               "sync_s": payload.get("sync_s", 0.0),
               "depth": payload.get("depth", 0),
               "ts": time.time()}  # close time on the CHILD's epoch clock
        if payload.get("parent"):
            row["parent"] = payload["parent"]
        if payload.get("attrs"):
            row["attrs"] = payload["attrs"]
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
            self._spans.append(row)

    def close(self) -> None:
        return None

    def drain(self) -> tuple:
        """(spans, dropped-since-last-drain) — one flush's payload."""
        with self._lock:
            spans = list(self._spans)
            self._spans.clear()
            dropped, self._dropped = self._dropped, 0
        return spans, dropped


class ChildRelay:
    """The worker subprocess's telemetry source: one ``collect()`` per
    flush returns the ``telem`` pipe document (or None when nothing
    changed — idle heartbeat windows cost zero pipe traffic).

    ``collect()`` is serialized by its own lock: worker_main flushes from
    TWO threads (the heartbeat ticker and the card-owning worker thread at
    request boundaries), and an unserialized read-modify-write of the
    delta baseline would diff two snapshots against the SAME ``_prev``
    and double-ship the increments. No ``retrace.live.*`` gauges ride the
    delta: the port has no retrace sanitizer (ROADMAP A10).
    """

    def __init__(self, sink: Optional[RelaySink] = None):
        self.sink = sink or RelaySink()
        self._lock = mct_lock("obs.telemetry.ChildRelay._lock")
        self._seq = 0
        self._prev: Dict = {}

    def collect(self) -> Optional[Dict]:
        with self._lock:
            cur = _metrics.registry().snapshot(include_histograms=False)
            delta = _metrics.snapshot_delta(self._prev, cur)
            self._prev = cur
            spans, dropped = self.sink.drain()
            if not (delta["counters"] or delta["gauges"] or spans or dropped):
                return None
            self._seq += 1
            seq = self._seq
        doc: Dict = {"kind": KIND_TELEM, "v": TELEM_SCHEMA, "seq": seq,
                     "metrics": delta}
        if spans:
            doc["spans"] = spans
        if dropped:
            doc["spans_dropped"] = dropped
        return doc


# ---------------------------------------------------------------------------
# parent half: folding relayed telemetry into this process (supervisor)
# ---------------------------------------------------------------------------


def fold_telem(doc: Dict, *, child_pid: Optional[int] = None,
               worker_id: Optional[int] = None) -> None:
    """Fold one relayed ``telem`` line into THIS process's obs state.

    Counters land under their own flat names (the Serving report cannot
    tell a relayed ``d2h.bytes.post.drain`` from a locally-booked one);
    spans replay through ``obs.record_span`` so the events file and the
    span histograms carry real samples. The relay's own bookkeeping is the
    ``worker.*`` process tag. ``worker_id`` (the pool slice that relayed
    this doc) stamps every replayed span so the obs plane can attribute
    device phases per worker.
    """
    from maskclustering_tpu_torch import obs

    if doc.get("v") != TELEM_SCHEMA:
        obs.count("worker.telem_unknown_version")
        return
    _metrics.merge_snapshot_delta(doc.get("metrics") or {})
    obs.count("worker.telem_messages")
    if doc.get("spans_dropped"):
        obs.count("worker.telem_spans_dropped", float(doc["spans_dropped"]))
    spans = doc.get("spans") or ()
    if spans:
        obs.count("worker.telem_spans", float(len(spans)))
    for row in spans:
        name = row.get("name")
        dur = row.get("dur_s")
        if not isinstance(name, str) or not isinstance(dur, (int, float)):
            continue
        attrs = dict(row.get("attrs") or {})
        if child_pid is not None:
            attrs["worker_pid"] = child_pid
        if worker_id is not None:
            attrs["worker_id"] = worker_id
        if row.get("ts") is not None:
            # the CHILD's close time: obs/trace.py anchors relayed spans on
            # this, not on the (later) parent re-emit timestamp
            attrs["end_ts"] = row["ts"]
        obs.record_span(name, float(dur), parent=row.get("parent"),
                        sync_s=float(row.get("sync_s") or 0.0), **attrs)


# ---------------------------------------------------------------------------
# windowed aggregation (the daemon's rolling view)
# ---------------------------------------------------------------------------

# counter names a window reads as deltas between consecutive ticks
_WINDOW_STATUSES = ("ok", "failed", "deadline", "skipped", "interrupted")
_SAMPLE_CAP = 512  # per-window raw latency/wait samples before drop-count

# tenant accounting bounds: identities are client-supplied (validated,
# length-capped by the protocol), so the aggregator additionally caps how
# many DISTINCT tenants it tracks per process — overflow lumps into one
# bucket instead of growing every window row without bound
_TENANT_CAP = 32
_TENANT_OVERFLOW = "(other)"
_TENANT_SAMPLE_CAP = 256  # per-tenant per-window raw samples


def _attrib_counters() -> Dict[str, float]:
    """The two attribution totals (fenced device seconds, d2h bytes) —
    read OUTSIDE the window lock (registry has its own lock). Both are
    plain counters, so the cross-process relay's delta fold keeps them
    topology-invariant: a child-booked d2h byte reads like a local one."""
    c = _metrics.registry().snapshot(include_histograms=False).get(
        "counters") or {}
    return {"device_s": float(c.get("device.seconds", 0.0)),
            "d2h_bytes": float(c.get("d2h.bytes", 0.0))}


def _new_tenant_slot() -> Dict:
    return {"requests": 0, "by_status": {}, "rejects": 0, "crashes": 0,
            "device_s": 0.0, "d2h_bytes": 0.0, "latency": {},
            "queue_wait": []}


def _tenant_rows(store: Dict[str, Dict]) -> Dict[str, Dict]:
    """JSON-able per-tenant sub-rows (samples summarized, zeros elided)."""
    out: Dict[str, Dict] = {}
    for t, s in sorted(store.items()):
        row: Dict[str, Any] = {"requests": int(s["requests"])}
        if s["by_status"]:
            row["by_status"] = dict(s["by_status"])
        if s["rejects"]:
            row["rejects"] = int(s["rejects"])
        if s["crashes"]:
            row["crashes"] = int(s["crashes"])
        if s["device_s"]:
            row["device_s"] = round(s["device_s"], 4)
        if s["d2h_bytes"]:
            row["d2h_bytes"] = int(s["d2h_bytes"])
        lat = {k: _hist_summary(v) for k, v in sorted(s["latency"].items())}
        lat = {k: v for k, v in lat.items() if v}
        if lat:
            row["latency"] = lat
        qw = _hist_summary(s["queue_wait"])
        if qw:
            row["queue_wait"] = qw
        out[t] = row
    return out


def _hist_summary(vals: List[float]) -> Optional[Dict]:
    if not vals:
        return None
    from maskclustering_tpu_torch.obs.metrics import percentile

    s = sorted(vals)
    return {"count": len(s), "p50_s": round(percentile(s, 50), 4),
            "p95_s": round(percentile(s, 95), 4), "max_s": round(s[-1], 4)}


class WindowAggregator:
    """Rolling ring of per-window serving digests.

    ``record_request``/``record_queue_wait`` feed the current window from
    the worker/supervisor threads (bounded per-window sample lists; the
    overflow is counted, never grown); ``roll()`` — the ticker's tick —
    closes the window against a registry snapshot taken OUTSIDE the
    window lock and appends it to the bounded ring. Cumulative per-bucket
    latency rides ``metrics.Histogram`` (stride-decimated, capped), so a
    daemon serving for days keeps O(ring + cap) memory.
    """

    def __init__(self, window_s: float = 5.0, ring: int = 120):
        self.window_s = max(float(window_s), 0.05)
        self._lock = mct_lock("obs.telemetry.WindowAggregator._lock")
        self._windows: Deque[Dict] = deque(maxlen=max(int(ring), 2))
        self._t0 = time.time()
        self._latency: Dict[str, List[float]] = {}
        self._waits: List[float] = []
        self._dropped = 0
        self._prev_counters: Dict[str, float] = {}
        self._prev_post_freeze = 0.0
        self._cum_hist: Dict[str, Histogram] = {}
        # tenant accounting: current-window slots, monotone cumulative
        # slots, and one capped histogram per tenant (all bounded by
        # _TENANT_CAP; overflow lumps into _TENANT_OVERFLOW)
        self._tenants: Dict[str, Dict] = {}
        self._cum_tenants: Dict[str, Dict] = {}
        self._cum_tenant_hist: Dict[str, Histogram] = {}
        # per-pool-slice completion counts for the current window (keyed
        # by str(worker_id); single-worker daemons never populate it)
        self._workers: Dict[str, int] = {}
        # the device-seconds / d2h attribution baseline: the counter
        # totals at the PREVIOUS request completion — one worker
        # serializes requests, so the delta between consecutive
        # completions is the finishing request's consumption (under the
        # isolated worker the relay's flush-before-result ordering folds
        # the child's counters before the result books here)
        self._prev_attrib = _attrib_counters()
        self.started_at = time.time()

    def rebase(self) -> None:
        """Re-anchor the delta baseline and window clock to NOW.

        Called when the daemon starts ticking (AFTER warm-up): without
        it, window 0 would charge the whole warm-up wall and its counter
        deltas (AOT restores, prewarm dispatches) to itself — serving
        rates diluted by startup that served nothing.
        """
        snap = _metrics.registry().snapshot(include_histograms=False)
        post_freeze = self._post_freeze_cum(snap.get("gauges") or {})
        attrib = _attrib_counters()
        with self._lock:  # like roll(): no other lock acquired inside
            self._prev_counters = dict(snap.get("counters") or {})
            self._prev_post_freeze = post_freeze
            self._prev_attrib = attrib  # warm-up device time charges no one
            self._t0 = time.time()
            self._latency = {}
            self._waits = []
            self._tenants = {}
            self._workers = {}

    # -- recorders (worker / supervisor threads) ----------------------------

    def _tenant_slot(self, store: Dict[str, Dict], tenant: str) -> Dict:
        """The tenant's accumulation slot (capped; overflow shared). Caller
        holds the window lock."""
        key = tenant if (tenant in store or len(store) < _TENANT_CAP) \
            else _TENANT_OVERFLOW
        slot = store.get(key)
        if slot is None:
            slot = store[key] = _new_tenant_slot()
        return slot

    def record_request(self, bucket, latency_s: float, *,
                       tenant: str = "", status: str = "ok",
                       worker: Optional[int] = None) -> None:
        """Book one finished request's latency under its shape bucket.

        The cumulative stride-decimated histogram observes EVERY sample
        (it exists precisely to absorb unbounded load); only the current
        window's raw list is capped, and independently of the queue-wait
        list — a wait burst must not starve the latency view.

        ``tenant`` attributes the request (count, status, latency sample,
        and the device-seconds / d2h-bytes consumed since the previous
        completion) to its accounting identity; "" books globally only.
        ``worker`` attributes the completion to a pool slice (the window
        row's ``workers`` map; None under a single-worker daemon).
        """
        key = _bucket_key(bucket)
        attrib = _attrib_counters()  # registry lock BEFORE the window lock
        with self._lock:
            if worker is not None:
                wk = str(int(worker))
                self._workers[wk] = self._workers.get(wk, 0) + 1
            dev_delta = max(attrib["device_s"]
                            - self._prev_attrib["device_s"], 0.0)
            d2h_delta = max(attrib["d2h_bytes"]
                            - self._prev_attrib["d2h_bytes"], 0.0)
            # every completion advances the baseline — an untenanted
            # request's consumption is attributed to no one, not to the
            # NEXT tenanted request
            self._prev_attrib = attrib
            if tenant:
                for store in (self._tenants, self._cum_tenants):
                    slot = self._tenant_slot(store, tenant)
                    slot["requests"] += 1
                    slot["by_status"][status] = \
                        slot["by_status"].get(status, 0) + 1
                    slot["device_s"] += dev_delta
                    slot["d2h_bytes"] += d2h_delta
                wslot = self._tenant_slot(self._tenants, tenant)
                samples = wslot["latency"].setdefault(key, [])
                if len(samples) < _TENANT_SAMPLE_CAP:
                    samples.append(float(latency_s))
                th = self._cum_tenant_hist.get(tenant)
                if th is None and len(self._cum_tenant_hist) < _TENANT_CAP:
                    th = self._cum_tenant_hist.setdefault(tenant, Histogram())
                if th is not None:
                    th.observe(float(latency_s))
            h = self._cum_hist.get(key)
            if h is None:
                h = self._cum_hist.setdefault(key, Histogram())
            h.observe(float(latency_s))
            if sum(len(v) for v in self._latency.values()) >= _SAMPLE_CAP:
                self._dropped += 1
                return
            self._latency.setdefault(key, []).append(float(latency_s))

    def record_queue_wait(self, wait_s: float, *, tenant: str = "") -> None:
        with self._lock:
            if tenant:
                samples = self._tenant_slot(self._tenants,
                                            tenant)["queue_wait"]
                if len(samples) < _TENANT_SAMPLE_CAP:
                    samples.append(float(wait_s))
            if len(self._waits) >= _SAMPLE_CAP:
                self._dropped += 1
                return
            self._waits.append(float(wait_s))

    def record_reject(self, tenant: str) -> None:
        """Attribute one admission/deadline reject to its tenant (global
        reject counts stay counter-delta driven at roll time)."""
        if not tenant:
            return
        with self._lock:
            for store in (self._tenants, self._cum_tenants):
                self._tenant_slot(store, tenant)["rejects"] += 1

    def record_crash(self, tenant: str) -> None:
        """Attribute one worker crash to the tenant whose request it was
        executing (supervisor._on_crash)."""
        if not tenant:
            return
        with self._lock:
            for store in (self._tenants, self._cum_tenants):
                self._tenant_slot(store, tenant)["crashes"] += 1

    # -- the tick -----------------------------------------------------------

    def _counter_deltas(self, counters: Dict[str, float]) -> Dict[str, float]:
        out = _metrics.snapshot_delta({"counters": self._prev_counters},
                                      {"counters": counters})["counters"]
        self._prev_counters = dict(counters)
        return out

    def _post_freeze_cum(self, gauges: Dict[str, float]) -> float:
        """Cumulative post-warm violations, live: the relayed gauge when a
        worker subprocess ships one, else 0 (no sanitizer in the port)."""
        v = gauges.get("retrace.live.post_freeze")
        return 0.0 if v is None else float(v)

    def roll(self) -> Dict:
        """Close the current window; returns the (JSON-able) window row."""
        # registry lock NOT nested; histogram summaries skipped — the
        # window derives nothing from them and each costs a reservoir sort
        snap = _metrics.registry().snapshot(include_histograms=False)
        counters = snap.get("counters") or {}
        gauges = snap.get("gauges") or {}
        now = time.time()
        post_freeze_cum = self._post_freeze_cum(gauges)
        with self._lock:
            deltas = self._counter_deltas(counters)
            latency = {k: _hist_summary(v)
                       for k, v in sorted(self._latency.items())}
            waits = _hist_summary(self._waits)
            dropped = self._dropped
            self._latency = {}
            self._waits = []
            self._dropped = 0
            pf_delta = post_freeze_cum - self._prev_post_freeze
            self._prev_post_freeze = post_freeze_cum
            row: Dict[str, Any] = {
                "t0": round(self._t0, 3),
                "dur_s": round(now - self._t0, 3),
                "requests": int(deltas.get("serve.requests", 0)),
                "by_status": {s: int(deltas[f"serve.requests_{s}"])
                              for s in _WINDOW_STATUSES
                              if deltas.get(f"serve.requests_{s}")},
                "rejects": self._reject_deltas(deltas),
                "crashes": int(deltas.get("serve.worker_crashes", 0)),
                "respawns": int(deltas.get("serve.worker_respawns", 0)),
                "requeued": int(deltas.get("serve.requests_requeued", 0)),
                "aot_hits": int(deltas.get("aot_cache.hits", 0)),
                "post_warm_compiles": int(max(pf_delta, 0)),
                # mct-sentinel: canary drift occurrences this window (the
                # SLO ``correctness`` objective reads this field; probes
                # ride along for the panel's coverage view)
                "drift": int(deltas.get("canary.drift", 0)),
                "canary_probes": int(deltas.get("canary.probes", 0)),
                "queue_depth": int(gauges.get("serve.queue_depth", 0)),
                "latency": {k: v for k, v in latency.items() if v},
            }
            if waits:
                row["queue_wait"] = waits
            if dropped:
                row["samples_dropped"] = dropped
            # continuous batching (serve.batch.* counters; relayed fold
            # included, so the isolated child's packing shows up here
            # too): this window's dispatch count + mean occupancy
            dispatches = int(deltas.get("serve.batch.dispatches", 0))
            if dispatches:
                packed = int(deltas.get("serve.batch.packed_requests", 0))
                row["batch"] = {
                    "dispatches": dispatches,
                    "packed_requests": packed,
                    "occupancy": round(packed / dispatches, 3),
                    "pad_lanes": int(deltas.get("serve.batch.pad_lanes", 0)),
                }
            if self._tenants:
                row["tenants"] = _tenant_rows(self._tenants)
                self._tenants = {}
            if self._workers:
                row["workers"] = dict(sorted(self._workers.items()))
                self._workers = {}
            self._windows.append(row)
            self._t0 = now
        return row

    @staticmethod
    def _reject_deltas(deltas: Dict[str, float]) -> Dict[str, int]:
        out: Dict[str, int] = {}
        prefix = "serve.admission.rejects."
        for k, v in deltas.items():
            if k.startswith(prefix):
                out[k[len(prefix):]] = out.get(k[len(prefix):], 0) + int(v)
        if deltas.get("serve.rejects.deadline"):
            out["deadline"] = (out.get("deadline", 0)
                               + int(deltas["serve.rejects.deadline"]))
        return out

    # -- reads --------------------------------------------------------------

    def snapshot(self) -> Dict:
        """Wire/CLI shape: ring + in-progress window + cumulative digest.

        The registry snapshot happens before the window lock (no nested
        lock acquisition); the returned structure is plain JSON-able data.
        """
        snap = _metrics.registry().snapshot(include_histograms=False)
        counters = {k: v for k, v in (snap.get("counters") or {}).items()
                    if k.startswith(CUMULATIVE_PREFIXES)}
        gauges = {k: v for k, v in (snap.get("gauges") or {}).items()
                  if k.startswith(("serve.", "retrace.", "hbm.", "worker."))}
        now = time.time()
        with self._lock:
            windows = list(self._windows)
            current = {
                "t0": round(self._t0, 3),
                "dur_s": round(now - self._t0, 3),
                "latency": {k: _hist_summary(v)
                            for k, v in sorted(self._latency.items()) if v},
                "queue_wait": _hist_summary(self._waits),
            }
            if self._tenants:
                current["tenants"] = _tenant_rows(self._tenants)
            cum_latency = {k: h.summary()
                           for k, h in sorted(self._cum_hist.items())}
            cum_tenants = _tenant_rows(self._cum_tenants)
            for t, h in sorted(self._cum_tenant_hist.items()):
                if t in cum_tenants:
                    cum_tenants[t]["latency"] = {"all": h.summary()}
        cumulative: Dict[str, Any] = {"counters": counters, "gauges": gauges,
                                      "latency": cum_latency}
        if cum_tenants:
            cumulative["tenants"] = cum_tenants
        return {"v": TELEM_SCHEMA, "window_s": self.window_s,
                "started_at": self.started_at,
                "windows": windows, "current": current,
                "cumulative": cumulative}


class TelemetryTicker:
    """The daemon's sampling thread: one ``roll()`` per window, each
    closed row appended to the obs events file (when armed) as a
    crash-safe ``telemetry`` line. Bounded-joined at stop."""

    def __init__(self, aggregator: WindowAggregator):
        self.aggregator = aggregator
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(  # mct-thread: abandon(daemon-lifetime ticker, bounded-joined in stop(); the spawn/join pair spans methods, which the scope-local check cannot see)
            target=self._run, daemon=True, name="telemetry-ticker")
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout_s)
            self._thread = None
        # one final roll so the shutdown tail (last requests, the drain's
        # rejects) is a window on disk, not lost in-progress state
        self._emit(self.aggregator.roll())

    def _emit(self, row: Dict) -> None:
        from maskclustering_tpu_torch import obs

        try:
            obs.emit_event(KIND_TELEMETRY, row)
        except Exception:  # noqa: BLE001 — telemetry never faults serving
            pass

    def _run(self) -> None:
        while not self._stop.wait(self.aggregator.window_s):
            self._emit(self.aggregator.roll())


# ---------------------------------------------------------------------------
# module-global plumbing: the serving code records against whatever
# aggregator the daemon installed; a process without one (the one-shot
# CLI, the worker subprocess) records into a no-op
# ---------------------------------------------------------------------------

_AGG_LOCK = mct_lock("obs.telemetry._agg_lock")
_AGGREGATOR: Optional[WindowAggregator] = None


def install(aggregator: Optional[WindowAggregator]) -> None:
    global _AGGREGATOR
    with _AGG_LOCK:
        _AGGREGATOR = aggregator


def installed() -> Optional[WindowAggregator]:
    with _AGG_LOCK:
        return _AGGREGATOR


def record_request(bucket, latency_s: float, *, tenant: str = "",
                   status: str = "ok",
                   worker: Optional[int] = None) -> None:
    """Book one finished request into the current window (no-op without an
    installed aggregator — i.e. outside a daemon parent process). Window
    status attribution comes from the serve.requests_* counter deltas at
    roll time, not from this call; the per-TENANT sub-windows, which
    cannot be split out of relayed counters, come from ``tenant``/
    ``status`` here — both call sites (worker._finish_request in-process,
    supervisor._book_result/_serve_one isolated) are parent-side, which
    is what keeps tenant windows topology-invariant."""
    agg = installed()
    if agg is not None:
        agg.record_request(bucket, latency_s, tenant=tenant, status=status,
                           worker=worker)


def record_queue_wait(req, wait_s: float) -> None:
    """Book one request's ack->dequeue wait: the window's queue_wait
    histogram plus a zero-width ``serve.queue_wait`` span (obs/trace.py's
    queue-wait segment). No-op outside a daemon parent process."""
    agg = installed()
    if agg is None:
        return
    agg.record_queue_wait(wait_s, tenant=getattr(req, "tenant", ""))
    from maskclustering_tpu_torch import obs

    obs.observe("serve.queue_wait_s", float(wait_s))
    obs.record_span("serve.queue_wait", float(wait_s), request=req.id,
                    scene=req.scene, end_ts=time.time())


def record_reject(tenant: str) -> None:
    """Attribute one reject to its tenant (no-op untenanted / undaemoned)."""
    agg = installed()
    if agg is not None:
        agg.record_reject(tenant)


def record_crash(tenant: str) -> None:
    """Attribute one worker crash to its tenant (supervisor._on_crash)."""
    agg = installed()
    if agg is not None:
        agg.record_crash(tenant)
