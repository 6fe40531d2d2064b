"""Run-report CLI over obs JSONL event files + ledger sections (the port's
copy of ``maskclustering_tpu/obs/report.py``).

    python -m maskclustering_tpu_torch.obs.report events.jsonl
    python -m maskclustering_tpu_torch.obs.report new.jsonl --diff old.jsonl
    python -m maskclustering_tpu_torch.obs.report --history    # the perf ledger
    python -m maskclustering_tpu_torch.obs.report --regress BASELINE  # CI gate

Renders per-stage span tables — count, p50/p95 wall, device (fenced sync)
vs host split, per-stage host<->device bytes, device-memory high-water —
and diffs two runs stage by stage. ``--history``/``--regress`` read the
perf regression ledger (obs/ledger.py): the trajectory as data, with a
non-zero exit when the newest headline p50 regresses past the threshold.

The events files are the JAX package's format, and this module renders
either package's files, every section included (pool, tenant and
analysis rows come from JAX daemons and tools the port has not ported).
The JAX report's compile-time cost observatory (``--cost`` and the
count_dtype comparison) lowers XLA programs; it raises
``NotImplementedError`` naming ``COST_ITEM``.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Dict, List, Optional

from maskclustering_tpu_torch.obs.events import (KIND_ANALYSIS, KIND_COST,
                                           KIND_DRIFT, KIND_METRICS,
                                           KIND_SPAN, KIND_TELEMETRY,
                                           ReadStats, read_events)

log = logging.getLogger("maskclustering_tpu_torch")

# the XLA cost observatory behind --cost and the dtype comparison
COST_ITEM = "ROADMAP A10"


# the disjoint per-stage spans whose total duration is the overlap-ratio
# numerator: the IO loads (daemon threads), the device-phase stages (main
# thread) and the host-tail post-process (worker thread). Parent container
# spans (exec.device / exec.host_tail) and nested post.* children are
# deliberately excluded — they would double-count their contents.
OVERLAP_STAGE_SPANS = ("exec.load", "associate", "graph", "cluster",
                       "postprocess")


class RunData:
    """Parsed event file: ordered span series + final metrics snapshot."""

    def __init__(self, path: str):
        self.path = path
        self.meta: Dict = {}
        self.spans: Dict[str, List[Dict]] = {}  # name -> span events, in order
        self.order: List[str] = []
        self.cost_rows: List[Dict] = []  # cost-observatory events, in order
        self.analysis_rows: List[Dict] = []  # mct-check findings/summaries
        self.telemetry_rows: List[Dict] = []  # windowed serving snapshots
        self.drift_rows: List[Dict] = []  # mct-sentinel canary drift events
        self.hbm_high_water: Optional[float] = None
        self.read_stats = ReadStats()  # torn/unknown lines: counted, warned
        metrics_by_pid: Dict = {}  # counters are monotonic PER PROCESS:
        # keep each pid's last flush, then sum counters across pids (one
        # file can hold several worker attempts plus the supervisor)
        for ev in read_events(path, stats=self.read_stats):
            kind = ev.get("kind")
            if kind == "meta" and not self.meta:
                self.meta = {k: v for k, v in ev.items()
                             if k not in ("v", "kind", "ts", "pid")}
            elif kind == KIND_SPAN:
                name = ev.get("name")
                if not isinstance(name, str):
                    continue
                if name not in self.spans:
                    self.spans[name] = []
                    self.order.append(name)
                self.spans[name].append(ev)
                mem = ev.get("mem") or {}
                in_use = mem.get("bytes_in_use")
                if in_use is not None and (self.hbm_high_water is None
                                           or in_use > self.hbm_high_water):
                    self.hbm_high_water = float(in_use)
            elif kind == KIND_COST:
                self.cost_rows.append(ev)
            elif kind == KIND_ANALYSIS:
                self.analysis_rows.append(ev)
            elif kind == KIND_TELEMETRY:
                self.telemetry_rows.append(ev)
            elif kind == KIND_DRIFT:
                self.drift_rows.append(ev)
            elif kind == KIND_METRICS:
                metrics_by_pid[ev.get("pid")] = ev.get("metrics") or {}
        if self.read_stats.skipped:
            log.warning("obs report: skipped %s in %s",
                        self.read_stats.describe(), path)
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, Dict] = {}
        for m in metrics_by_pid.values():
            for k, v in (m.get("counters") or {}).items():
                counters[k] = counters.get(k, 0.0) + v
            for k, v in (m.get("gauges") or {}).items():
                # max across processes: correct for the high-water/bucket
                # gauges this subsystem emits (all are "largest seen" style)
                if k not in gauges or v > gauges[k]:
                    gauges[k] = v
            for k, h in (m.get("histograms") or {}).items():
                # bounded summaries only (count/total/p50/p95/max): counts
                # and totals sum exactly across processes; percentiles
                # cannot merge, so the largest-count process's stand for
                # the merged view (one process dominates in practice)
                if not isinstance(h, dict):
                    continue
                cur = hists.get(k)
                if cur is None:
                    hists[k] = dict(h)
                    continue
                bigger = h if (h.get("count") or 0) > (cur.get("count") or 0) \
                    else cur
                merged = dict(bigger)
                merged["count"] = (cur.get("count") or 0) + (h.get("count") or 0)
                merged["total"] = (cur.get("total") or 0.0) \
                    + (h.get("total") or 0.0)
                maxes = [x.get("max") for x in (cur, h)
                         if isinstance(x.get("max"), (int, float))]
                merged["max"] = max(maxes) if maxes else bigger.get("max")
                hists[k] = merged
        hw = gauges.get("hbm.high_water_bytes")
        if hw is not None and (self.hbm_high_water is None
                               or hw > self.hbm_high_water):
            self.hbm_high_water = float(hw)
        self._counters = counters
        self._gauges = gauges
        self._histograms = hists

    def stage_rows(self) -> List[Dict]:
        """One aggregate row per span name, in first-appearance order."""
        rows = []
        for name in self.order:
            evs = self.spans[name]
            durs = sorted(float(e.get("dur_s", 0.0)) for e in evs)
            syncs = sorted(float(e.get("sync_s", 0.0)) for e in evs)
            rows.append({
                "stage": name,
                "count": len(evs),
                "total_s": sum(durs),
                "p50_s": _pct(durs, 50),
                "p95_s": _pct(durs, 95),
                "device_p50_s": _pct(syncs, 50),
                "host_p50_s": max(_pct(durs, 50) - _pct(syncs, 50), 0.0),
                "h2d_bytes": self._counters.get(f"h2d.bytes.{name}"),
                "d2h_bytes": self._counters.get(f"d2h.bytes.{name}"),
            })
        return rows

    def overlap(self) -> Optional[Dict]:
        """Scene-loop overlap accounting, or None without an executor span.

        ``ratio`` = sum of per-stage span time / scene-loop wall time. A
        fully serialized loop sits at <= 1.0 (stages plus orchestration
        overhead fill the wall exactly once); every point above 1.0 is
        stage work that ran CONCURRENTLY — loads under device dispatch,
        host tails under the next scene's device phase. The denominator is
        the ``exec.scene_loop`` span the executor wraps around the whole
        queue (summed, for multi-step runs)."""
        loops = self.spans.get("exec.scene_loop")
        if not loops:
            return None
        wall = sum(float(e.get("dur_s", 0.0)) for e in loops)
        stages: Dict[str, float] = {}
        busy = 0.0
        for name in OVERLAP_STAGE_SPANS:
            tot = sum(float(e.get("dur_s", 0.0))
                      for e in self.spans.get(name, ()))
            if tot:
                stages[name] = round(tot, 4)
            busy += tot
        return {
            "mode": (loops[-1].get("attrs") or {}).get("mode"),
            "scene_loop_s": round(wall, 4),
            "busy_s": round(busy, 4),
            "ratio": round(busy / wall, 4) if wall > 0 else None,
            "stages": stages,
        }

    def summary(self) -> Dict:
        """JSON-able digest for embedding (run_report.json / bench line)."""
        out = {
            "events": self.path,
            "stages": {r["stage"]: {"count": r["count"],
                                    "p50_s": round(r["p50_s"], 4),
                                    "p95_s": round(r["p95_s"], 4),
                                    "device_p50_s": round(r["device_p50_s"], 4)}
                       for r in self.stage_rows()},
            "hbm_high_water_bytes": self.hbm_high_water,
            "h2d_bytes": self._counters.get("h2d.bytes"),
            "d2h_bytes": self._counters.get("d2h.bytes"),
            "counters": {k: v for k, v in sorted(self._counters.items())
                         if k.startswith(("run.", "bench.", "compile_cache.",
                                          "pipeline.", "faults.",
                                          "retrace.", "serve.", "stream.",
                                          "aot_cache.", "worker."))},
            # the registry's bounded histogram summaries (metrics.py
            # snapshot contract): span.* series are already covered by the
            # stage table above, so only the non-span histograms (queue
            # waits, future explicit observe() series) ride the digest
            "histograms": {
                k: {f: (round(x, 6) if isinstance(x, float) else x)
                    for f, x in v.items()}
                for k, v in sorted(self._histograms.items())
                if not k.startswith("span.")},
        }
        ov = self.overlap()
        if ov is not None:
            out["overlap"] = ov
        return out


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an ascending list — THE one quantile
    rule every surface shares (stage tables here, the serve worker's
    latency digest, load_gen's verdict), so p50/p95 cannot silently
    disagree between the report, the daemon and the ledger row."""
    if not sorted_vals:
        return 0.0
    idx = min(int(q / 100.0 * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


_pct = percentile  # internal alias (stage tables predate the public name)


def _fmt_s(v: Optional[float]) -> str:
    return "-" if v is None else f"{v:.3f}"


def _fmt_bytes(v: Optional[float]) -> str:
    if v is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(v) < 1024 or unit == "TB":
            return f"{v:.0f}{unit}" if unit == "B" else f"{v:.1f}{unit}"
        v /= 1024.0
    return "-"  # unreachable


def _render(headers: List[str], rows: List[List[str]]) -> str:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    fmt_row = lambda cells: "  ".join(c.ljust(w) if i == 0 else c.rjust(w)  # noqa: E731
                                      for i, (c, w) in enumerate(zip(cells, widths)))
    lines = [fmt_row(headers), fmt_row(["-" * w for w in widths])]
    lines += [fmt_row(r) for r in rows]
    return "\n".join(lines)


def render_faults(counters: Dict[str, float]) -> Optional[str]:
    """The Faults section: retry/stall/degradation/injection accounting.

    Rendered only when the run recorded any fault activity — a clean run's
    report stays exactly as it was. Sources are the supervisor counters
    (run.scene_retries / run.device_stalls / run.journal_skips), the
    degradation ladder (run.degradations.<rung>) and the deterministic
    fault-injection harness (faults.injected.<seam>).
    """
    retries = int(counters.get("run.scene_retries", 0))
    stalls = int(counters.get("run.device_stalls", 0))
    skips = int(counters.get("run.journal_skips", 0))
    failed = int(counters.get("run.scenes_failed", 0))
    abandoned = int(counters.get("run.abandoned_results", 0))
    degr = {k[len("run.degradations."):]: int(v)
            for k, v in sorted(counters.items())
            if k.startswith("run.degradations.")}
    inj = {k[len("faults.injected."):]: int(v)
           for k, v in sorted(counters.items())
           if k.startswith("faults.injected.")}
    # the lock sanitizer's digest (lock_sanitizer.emit_counters, armed
    # runs only): acquisition volume, distinct nesting edges, long holds
    lock_acq = int(counters.get("locks.acquisitions", 0))
    if not (retries or stalls or skips or failed or abandoned or degr
            or inj or lock_acq):
        # `failed` matters alone: a terminal-class error is never retried,
        # so it can be the ONLY fault signal of the run
        return None
    lines = ["== faults ==",
             f"scene retries {retries} | device stalls {stalls} | "
             f"journal skips {skips} | scenes failed {failed}"
             + (f" | abandoned results {abandoned}" if abandoned else "")]
    if degr:
        lines.append("degradations: " + ", ".join(
            f"{name} x{n}" for name, n in degr.items()))
    if inj:
        lines.append("injected (fault plan): " + ", ".join(
            f"{seam} x{n}" for seam, n in inj.items()))
    if lock_acq:
        lines.append(
            f"lock sanitizer: {lock_acq} acquisition(s) | "
            f"{int(counters.get('locks.order_edges', 0))} order edge(s) | "
            f"{int(counters.get('locks.long_holds', 0))} long hold(s)")
    return "\n".join(lines)


def latest_analysis_run(rows: List[Dict]) -> tuple:
    """(finding rows, summary row|None) of the newest mct-check run.

    The analysis CLI appends one event per finding then one summary row
    per invocation; a shared events file holds several runs, and only the
    newest one describes the current tree. Findings are keyed to their
    summary by PID: a run killed before its summary (the 90 s CI
    timeout) leaves orphan rows that must not be attributed to the NEXT
    invocation — a clean summary rendered above a dead run's findings
    would contradict itself. Trailing rows after the last summary are a
    newer in-flight/crashed run and render summary-less.
    """
    runs: List[tuple] = []
    pending: Dict = {}  # pid -> finding rows not yet closed by a summary
    tail: List[Dict] = []  # rows appended after the newest summary
    for ev in rows:
        if ev.get("summary"):
            runs.append((pending.pop(ev.get("pid"), []), ev))
            tail = []
        else:
            pending.setdefault(ev.get("pid"), []).append(ev)
            tail.append(ev)
    if tail or not runs:
        return tail, None
    return runs[-1]


def render_analysis(rows: List[Dict]) -> Optional[str]:
    """The Analysis section: the newest mct-check run's findings.

    Rendered only when the events file carries ``analysis`` events (the
    mct-check CLI with ``--events``); a plain run report is unchanged.
    """
    findings, summary = latest_analysis_run(rows)
    if not findings and summary is None:
        return None
    out = ["== analysis (mct-check) =="]
    if summary is not None:
        state = "clean" if summary.get("clean") else "FINDINGS"
        out.append(
            f"{state}: {summary.get('findings', 0)} unsuppressed | "
            f"{summary.get('suppressed', 0)} suppressed | "
            f"{summary.get('stale', 0)} stale suppression(s) "
            f"({summary.get('elapsed_s', '?')}s, "
            f"families {'+'.join(summary.get('families') or [])})")
    table = []
    for ev in findings:
        if ev.get("suppressed"):
            continue  # the gate cares about unsuppressed ones
        loc = ev.get("file") or "<ir>"
        if ev.get("line"):
            loc = f"{loc}:{ev['line']}"
        table.append([str(ev.get("check", "?")), loc,
                      str(ev.get("message", ""))[:72]])
    if table:
        out.append(_render(["check", "location", "finding"], table))
    elif summary is not None and summary.get("suppressed"):
        out.append("(all findings baseline-suppressed)")
    return "\n".join(out)


def render_serving(run: "RunData") -> Optional[str]:
    """The Serving section: the daemon's admission/latency/warmth digest.

    Rendered only when the events file carries ``serve.*`` metrics (a
    daemon run with ``--obs_events``); batch run reports are unchanged.
    Sources: the admission counters (``serve.admission.*``,
    ``serve.requests*``), the queue/latency gauges the daemon books at
    shutdown (``emit_serve_counters``), the ``serve.request`` span series
    (per-request p50/p95 — preferred over the gauges when present), and
    the retrace sanitizer's post-freeze count as "compiles post-warm-up"
    (the serve-many contract's headline number: a warm daemon reads 0).
    """
    c, g = run._counters, run._gauges
    if not any(k.startswith("serve.") for k in list(c) + list(g)):
        return None
    requests = int(c.get("serve.requests", 0))
    by_status = {s: int(c.get(f"serve.requests_{s}", 0))
                 for s in ("ok", "failed", "deadline", "skipped",
                           "interrupted")}
    rejects = {k[len("serve.admission.rejects."):]: int(v)
               for k, v in sorted(c.items())
               if k.startswith("serve.admission.rejects.")}
    if c.get("serve.rejects.deadline"):
        rejects["deadline"] = (rejects.get("deadline", 0)
                               + int(c["serve.rejects.deadline"]))
    lines = ["== serving (mct-serve) =="]
    lines.append(
        f"requests {requests} | "
        + " | ".join(f"{s} {n}" for s, n in by_status.items() if n)
        + (f" | warm-up scenes {int(c['serve.warmup_scenes'])}"
           if c.get("serve.warmup_scenes") else ""))
    depth_hw = g.get("serve.queue_depth_high_water")
    admitted = c.get("serve.admission.admitted")
    lines.append(
        f"admission: {int(admitted or 0)} admitted | queue high-water "
        f"{int(depth_hw or 0)}"
        + (" | rejects: " + ", ".join(f"{r} x{n}"
                                      for r, n in rejects.items())
           if rejects else " | rejects: none"))
    # per-request latency: the span series is exact; the shutdown gauges
    # are the fallback when a digest-only file has no spans
    p50 = p95 = None
    for r in run.stage_rows():
        if r["stage"] == "serve.request":
            p50, p95 = r["p50_s"], r["p95_s"]
            break
    if p50 is None:
        p50, p95 = g.get("serve.request_p50_s"), g.get("serve.request_p95_s")
    if p50 is not None:
        lines.append(f"request latency: p50 {_fmt_s(p50)} | p95 {_fmt_s(p95)}")
    # crash containment (serve/supervisor.py): worker subprocess deaths,
    # respawns and requeues — zero lines on an in-thread (or untroubled)
    # daemon, loud attribution on a supervised one
    crashes = int(c.get("serve.worker_crashes", 0))
    respawns = int(c.get("serve.worker_respawns", 0))
    requeued = int(c.get("serve.requests_requeued", 0))
    if crashes or respawns:
        line = (f"worker crashes {crashes} | respawns {respawns} | "
                f"requests requeued {requeued}")
        if c.get("serve.worker_fatal"):
            line += " | FATAL: respawn budget exhausted"
        lines.append(line)
    # persistent AOT cache (utils/aot_cache.py): warm-start economics —
    # how much of this process's warmth was paid from disk
    aot = {k: int(c.get(f"aot_cache.{k}", 0))
           for k in ("restored", "hits", "misses", "stores", "invalidated")}
    if any(aot.values()):
        line = (f"aot cache: {aot['restored']} restored | "
                f"{aot['hits']} hit(s) | {aot['misses']} miss(es) | "
                f"{aot['stores']} captured")
        if aot["invalidated"]:
            line += (f" | {aot['invalidated']} invalidated "
                     f"[version-stamp mismatch — prune or recapture]")
        lines.append(line)
    post_warm = c.get("retrace.post_freeze_compiles")
    cold = int(c.get("serve.buckets_cold", 0))
    warm_n = g.get("serve.warm_buckets")
    tail = []
    if warm_n is not None:
        tail.append(f"warm buckets {int(warm_n)}")
    if cold:
        tail.append(f"cold bucket dispatches {cold}")
    if c.get("retrace.cache_hits"):
        tail.append(f"compile-cache hits {int(c['retrace.cache_hits'])}")
    tail.append(f"compiles post-warm-up: "
                f"{int(post_warm) if post_warm is not None else 0}"
                + (" [VIOLATION — the serve-many contract broke]"
                   if post_warm else ""))
    lines.append(" | ".join(tail))
    tele = render_telemetry_windows(run.telemetry_rows)
    if tele:
        lines.append(tele)
    tenants = render_tenants(run.telemetry_rows)
    if tenants:
        lines.extend(tenants)
    pool = render_pool(run)
    if pool:
        lines.extend(pool)
    return "\n".join(lines)


def render_pool(run: "RunData") -> List[str]:
    """Worker-pool digest: scheduler counters (``serve.pool.*``) plus
    per-worker completion shares summed from the telemetry windows'
    ``workers`` maps and per-tenant dequeue shares from their tenant
    sub-rows. Empty list when the run never carved a pool (no pool
    counters AND no window carried a workers map) — single-worker
    reports are unchanged."""
    c = run._counters
    by_worker: Dict[str, int] = {}
    for r in run.telemetry_rows or ():
        for wid, n in (r.get("workers") or {}).items():
            by_worker[wid] = by_worker.get(wid, 0) + int(n or 0)
    pool_counters = any(k.startswith("serve.pool.") for k in c)
    if not pool_counters and not by_worker:
        return []
    out: List[str] = []
    hits = int(c.get("serve.pool.affinity_hits", 0))
    misses = int(c.get("serve.pool.affinity_misses", 0))
    routed = hits + misses
    line = (f"pool: dispatched {int(c.get('serve.pool.dispatched', 0))} | "
            f"affinity {hits}/{routed} warm")
    if routed:
        line += f" ({hits / routed:.0%})"
    if c.get("serve.pool.crash_reroutes"):
        line += f" | crash reroutes {int(c['serve.pool.crash_reroutes'])}"
    if c.get("serve.pool.workers_retired"):
        line += f" | workers retired {int(c['serve.pool.workers_retired'])}"
    if c.get("serve.pool.recarves"):
        line += f" | recarves {int(c['serve.pool.recarves'])}"
    out.append(line)
    total = sum(by_worker.values())
    for wid in sorted(by_worker, key=lambda w: (len(w), w)):
        n = by_worker[wid]
        share = f" ({n / total:.0%})" if total else ""
        out.append(f"  worker {wid}: completions {n}{share}")
    # dequeue share by tenant: what the weighted-fair scheduler actually
    # granted, from the same windows (requests completed per tenant)
    by_tenant: Dict[str, int] = {}
    for r in run.telemetry_rows or ():
        for name, t in (r.get("tenants") or {}).items():
            by_tenant[name] = (by_tenant.get(name, 0)
                               + int(t.get("requests", 0) or 0))
    t_total = sum(by_tenant.values())
    if by_tenant and t_total:
        out.append("  dequeue share: " + " | ".join(
            f"{name} {n} ({n / t_total:.0%})"
            for name, n in sorted(by_tenant.items())))
    return out


def render_tenants(rows: List[Dict]) -> List[str]:
    """Per-tenant accounting digest summed over the telemetry windows
    (empty list when no window carried the tenant dimension)."""
    agg: Dict[str, Dict] = {}
    for r in rows or ():
        for name, t in (r.get("tenants") or {}).items():
            a = agg.setdefault(name, {"requests": 0, "rejects": 0,
                                      "crashes": 0, "device_s": 0.0,
                                      "d2h_bytes": 0})
            a["requests"] += int(t.get("requests", 0) or 0)
            a["rejects"] += int(t.get("rejects", 0) or 0)
            a["crashes"] += int(t.get("crashes", 0) or 0)
            a["device_s"] += float(t.get("device_s", 0.0) or 0.0)
            a["d2h_bytes"] += int(t.get("d2h_bytes", 0) or 0)
    if not agg:
        return []
    out = ["tenants:"]
    for name in sorted(agg):
        a = agg[name]
        out.append(f"  {name:<16} requests {a['requests']} | "
                   f"rejects {a['rejects']} | crashes {a['crashes']} | "
                   f"device {a['device_s']:.3f}s | d2h {a['d2h_bytes']}B")
    return out


def render_slo(run: "RunData", spec_path: Optional[str] = None) \
        -> Optional[str]:
    """The SLO section: the spec's burn-rate verdict over the telemetry
    window rows the events file carries (None without any serve/telemetry
    evidence — batch reports are unchanged)."""
    if not run.telemetry_rows:
        return None
    from maskclustering_tpu_torch.obs import slo as slo_mod

    spec = slo_mod.load_spec(spec_path)
    result = slo_mod.evaluate(spec, {"windows": run.telemetry_rows})
    return "\n".join(["== SLO =="] + slo_mod.render_result(result))


def render_correctness(run: "RunData") -> Optional[str]:
    """The Correctness section (mct-sentinel): canary probe volume, the
    drift matrix per coordinate, and last-verified recency per bucket.

    Rendered only when the events carry canary evidence (``canary.*``
    counters or ``canary.drift`` rows) — batch reports are unchanged. A
    clean section is one line; a drifted one names every coordinate whose
    outputs stopped matching the committed goldens, which fields moved,
    and when the coordinate was last verified clean.
    """
    c = run._counters
    probes = int(c.get("canary.probes", 0))
    drift = int(c.get("canary.drift", 0))
    if not probes and not drift and not run.drift_rows:
        return None
    lines = ["== correctness (mct-sentinel) =="]
    head = f"canary probes {probes} | drift {drift}"
    skipped = int(c.get("canary.skipped_busy", 0))
    if skipped:
        head += f" | ticks skipped busy {skipped}"
    head += (" [DRIFT — outputs diverged from committed goldens]"
             if drift or run.drift_rows
             else " | every probe byte-identical to goldens")
    lines.append(head)
    # the drift matrix: coordinate -> occurrence count + moved fields +
    # when this run last saw the coordinate clean (ok windows carry no
    # event, so recency comes from the telemetry ring's clean windows)
    by_coord: Dict[str, Dict] = {}
    for ev in run.drift_rows:
        coord = str(ev.get("coord") or "?")
        row = by_coord.setdefault(coord, {"n": 0, "fields": set(),
                                          "scene": ev.get("scene"),
                                          "first_ts": ev.get("ts")})
        row["n"] += 1
        for f in ev.get("fields") or ():
            row["fields"].add(str(f))
    last_clean_ts = None
    for r in run.telemetry_rows:
        if int(r.get("canary_probes", 0) or 0) \
                and not int(r.get("drift", 0) or 0):
            ts = r.get("ts")
            if ts is not None and (last_clean_ts is None
                                   or ts > last_clean_ts):
                last_clean_ts = ts
    for coord in sorted(by_coord):
        row = by_coord[coord]
        line = (f"  DRIFT {coord} (scene {row['scene']}): x{row['n']} | "
                f"fields {','.join(sorted(row['fields'])) or '?'}")
        if last_clean_ts is not None and row["first_ts"] is not None:
            line += (f" | last verified clean "
                     f"{max(row['first_ts'] - last_clean_ts, 0.0):.1f}s "
                     f"before first drift")
        lines.append(line)
    return "\n".join(lines)


def render_telemetry_windows(rows: List[Dict]) -> Optional[str]:
    """One-line digest of the windowed telemetry ring (obs/telemetry.py
    rows the daemon's ticker appended): window count, request volume,
    peak queue depth across windows, and the busiest window's worst
    per-bucket p95 — the live-view numbers, durable on disk."""
    if not rows:
        return None
    requests = sum(int(r.get("requests", 0) or 0) for r in rows)
    peak_depth = max((int(r.get("queue_depth", 0) or 0) for r in rows),
                     default=0)
    crashes = sum(int(r.get("crashes", 0) or 0) for r in rows)
    post_warm = sum(int(r.get("post_warm_compiles", 0) or 0) for r in rows)
    p95 = None
    for r in rows:
        for h in (r.get("latency") or {}).values():
            v = (h or {}).get("p95_s")
            if v is not None and (p95 is None or v > p95):
                p95 = v
    line = (f"telemetry: {len(rows)} window(s) | {requests} request(s) | "
            f"peak queue depth {peak_depth}")
    if p95 is not None:
        line += f" | worst window p95 {_fmt_s(p95)}"
    if crashes:
        line += f" | crashes {crashes}"
    if post_warm:
        line += f" | post-warm compiles {post_warm} [VIOLATION]"
    return line


def render_retrace(counters: Dict[str, float]) -> Optional[str]:
    """The retrace-sanitizer digest line (armed runs only): compile events
    vs new shape buckets, with violations called out. Lives in the
    Analysis section — the sanitizer is the retrace family's dynamic
    half, so its verdict renders next to mct-check's."""
    compiles = counters.get("retrace.compiles")
    if compiles is None:
        return None
    line = (f"retrace sanitizer: {int(compiles)} compile(s) | "
            f"{int(counters.get('retrace.distinct_programs', 0))} "
            f"program(s) | "
            f"{int(counters.get('retrace.buckets_new', 0))} new bucket(s)")
    hits = int(counters.get("retrace.cache_hits", 0))
    restores = int(counters.get("retrace.aot_restores", 0))
    if hits or restores:
        # warm-start economics: events the persistent caches served are
        # not compiles (compiles above already excludes them)
        line += f" | {hits} cache hit(s), {restores} aot restore(s)"
    repeats = int(counters.get("retrace.repeat_compiles", 0))
    frozen = int(counters.get("retrace.post_freeze_compiles", 0))
    if repeats or frozen:
        line += (f" | VIOLATIONS: {repeats} repeat, {frozen} post-warm — "
                 f"the serve-many contract broke")
    return line


def render_streaming(run: "RunData") -> Optional[str]:
    """The Streaming section: latency-per-chunk + residency digest.

    Rendered only when the events carry ``stream.*`` metrics (a
    ``--streaming-chunk`` run or a daemon serving ``stream_chunk`` ops);
    batch reports are unchanged. Chunk p50/p95 come from the
    ``stream.chunk`` span series; frames/s sustained is total streamed
    frames over total chunk wall — the live-scan SLO number — and the
    two high-water gauges pin the headline residency claim: only one
    chunk's claim planes (``stream.max_plane_bytes``) plus the O(M^2)
    accumulator (``stream.state_bytes``) are ever resident.
    """
    c, g = run._counters, run._gauges
    chunks = int(c.get("stream.chunks", 0))
    if not chunks:
        return None
    lines = ["== streaming (chunked accumulation) =="]
    frames = int(c.get("stream.frames", 0))
    p50 = p95 = total = None
    for r in run.stage_rows():
        if r["stage"] == "stream.chunk":
            p50, p95, total = r["p50_s"], r["p95_s"], r["total_s"]
            break
    line = (f"chunks {chunks} | frames {frames} | "
            f"re-clusters {int(c.get('stream.reclusters', 0))}")
    if c.get("stream.chunk_retries"):
        line += f" | chunk retries {int(c['stream.chunk_retries'])}"
    if c.get("stream.state_resumes"):
        line += f" | journal resumes {int(c['stream.state_resumes'])}"
    if c.get("stream.mask_capacity_growths"):
        line += (f" | mask-capacity growths "
                 f"{int(c['stream.mask_capacity_growths'])}")
    lines.append(line)
    if p50 is not None:
        sustained = frames / total if total else None
        lines.append(
            f"chunk latency: p50 {_fmt_s(p50)} | p95 {_fmt_s(p95)}"
            + (f" | {sustained:.1f} frames/s sustained"
               if sustained else ""))
    plane = g.get("stream.max_plane_bytes")
    state = g.get("stream.state_bytes")
    if plane is not None or state is not None:
        lines.append(
            f"residency high-water: chunk planes {_fmt_bytes(plane)} | "
            f"accumulator state {_fmt_bytes(state)}")
    partials = g.get("stream.partial_instances")
    if partials is not None:
        lines.append(f"partial instances (last chunk): {int(partials)}")
    return "\n".join(lines)


def render_report(run: RunData, slo_spec: Optional[str] = None) -> str:
    rows = [[r["stage"], str(r["count"]), _fmt_s(r["p50_s"]), _fmt_s(r["p95_s"]),
             _fmt_s(r["device_p50_s"]), _fmt_s(r["host_p50_s"]),
             _fmt_s(r["total_s"]), _fmt_bytes(r["h2d_bytes"]),
             _fmt_bytes(r["d2h_bytes"])]
            for r in run.stage_rows()]
    out = [f"== obs report: {run.path} =="]
    if run.read_stats.skipped:
        out.append(f"WARNING: skipped {run.read_stats.describe()}")
    if run.meta:
        out.append("meta: " + json.dumps(run.meta, sort_keys=True))
    out.append(_render(
        ["stage", "n", "p50[s]", "p95[s]", "dev.p50[s]", "host.p50[s]",
         "total[s]", "h2d", "d2h"], rows))
    ov = run.overlap()
    if ov is not None and ov.get("ratio") is not None:
        parts = " | ".join(f"{k} {v:.2f}s" for k, v in ov["stages"].items())
        out.append(f"scene overlap [{ov.get('mode') or '?'}]: "
                   f"ratio {ov['ratio']:.2f}x = stage time {ov['busy_s']:.2f}s"
                   f" / loop wall {ov['scene_loop_s']:.2f}s  ({parts})")
    tail = []
    if run.hbm_high_water is not None:
        tail.append(f"HBM high-water: {_fmt_bytes(run.hbm_high_water)}")
    for d in ("h2d", "d2h"):
        total = run._counters.get(f"{d}.bytes")
        if total is not None:
            tail.append(f"{d} total: {_fmt_bytes(total)}")
    hits = {k: v for k, v in run._counters.items()
            if k.startswith("compile_cache.")}
    if hits:
        tail.append("compile cache: " + ", ".join(
            f"{k.split('.', 1)[1]}={int(v)}" for k, v in sorted(hits.items())))
    if tail:
        out.append(" | ".join(tail))
    faults_sec = render_faults(run._counters)
    if faults_sec:
        out.append(faults_sec)
    serving_sec = render_serving(run)
    if serving_sec:
        out.append(serving_sec)
    slo_sec = render_slo(run, slo_spec)
    if slo_sec:
        out.append(slo_sec)
    correctness_sec = render_correctness(run)
    if correctness_sec:
        out.append(correctness_sec)
    streaming_sec = render_streaming(run)
    if streaming_sec:
        out.append(streaming_sec)
    analysis_sec = render_analysis(run.analysis_rows)
    retrace_line = render_retrace(run._counters)
    if analysis_sec:
        out.append(analysis_sec + ("\n" + retrace_line if retrace_line
                                   else ""))
    elif retrace_line:
        out.append("== analysis (retrace sanitizer) ==\n" + retrace_line)
    return "\n".join(out)


def render_diff(run_a: RunData, run_b: RunData) -> str:
    """Stage-by-stage p50 diff: A (the file argument) vs B (--diff)."""
    rows_a = {r["stage"]: r for r in run_a.stage_rows()}
    rows_b = {r["stage"]: r for r in run_b.stage_rows()}
    names = list(run_a.order) + [n for n in run_b.order if n not in rows_a]
    rows = []
    for name in names:
        a, b = rows_a.get(name), rows_b.get(name)
        pa = a["p50_s"] if a else None
        pb = b["p50_s"] if b else None
        if pa is not None and pb is not None and pb > 0:
            delta = f"{100.0 * (pa - pb) / pb:+.1f}%"
        else:
            delta = "-"
        rows.append([name, _fmt_s(pa), _fmt_s(pb), delta])
    head = [f"== obs diff: A={run_a.path}  B={run_b.path} =="]
    return "\n".join(head + [_render(["stage", "A p50[s]", "B p50[s]", "A vs B"],
                                     rows)])


# ---------------------------------------------------------------------------
# cost observatory section (--cost): XLA tooling, not ported
# ---------------------------------------------------------------------------


def _cost_unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} reads the compile-time cost observatory, which lowers XLA "
        f"programs and is not ported yet ({COST_ITEM})")


def render_cost(rows: List[Dict]) -> str:
    """The JAX report's per-mesh cost tables: not ported."""
    raise _cost_unported("the cost observatory section (--cost)")


def render_dtype_compare(diffs: List[Dict],
                         planes: Optional[Dict] = None) -> str:
    """The JAX report's count_dtype comparison: not ported."""
    raise _cost_unported("the count_dtype comparison")


# ---------------------------------------------------------------------------
# perf regression ledger sections (--history / --regress)
# ---------------------------------------------------------------------------


def render_history(rows: List[Dict], stats: Optional[ReadStats] = None,
                   path: str = "") -> str:
    """The bench trajectory, oldest first, nulls included (a null verdict
    IS trajectory — it records the chip window that never delivered)."""
    out = [f"== perf ledger: {path} ({len(rows)} rows) =="]
    if stats is not None and stats.skipped:
        out.append(f"WARNING: skipped {stats.describe()}")
    table = []
    import time as _time

    for r in rows:
        ts = r.get("ts")
        when = (_time.strftime("%Y-%m-%d %H:%M", _time.gmtime(ts))
                if isinstance(ts, (int, float)) else "-")
        val = r.get("value")
        stages = r.get("stages") or {}
        top = sorted(((v, k) for k, v in stages.items()
                      if isinstance(v, (int, float))), reverse=True)[:3]
        table.append([
            when, str(r.get("tool", "-")), str(r.get("git", "-")),
            "-" if val is None else f"{val:.3f}",
            str(r.get("unit", "-")),
            "-" if r.get("vs_baseline") is None else f"{r['vs_baseline']:.1f}x",
            (str(r.get("error", ""))[:40] or
             " ".join(f"{k}={v:.2f}" for v, k in top)),
        ])
    out.append(_render(["when (UTC)", "tool", "git", "value", "unit",
                        "vs_ref", "stages / error"], table))
    return "\n".join(out)


def _regress_eval(ledger_path: str, baseline_path: str,
                  threshold: float) -> tuple:
    """(exit_code, message lines, JSON-able gate record) for --regress."""
    from maskclustering_tpu_torch.obs import ledger as led

    lines: List[str] = []
    stats = ReadStats()
    try:
        rows = led.read_ledger(ledger_path, stats=stats)
    except OSError as e:
        msg = f"--regress: cannot read ledger {ledger_path}: {e}"
        return 2, [msg], {"ok": False, "error": msg}
    if stats.skipped:
        lines.append(f"WARNING: ledger skipped {stats.describe()}")
    baseline = led.load_baseline(baseline_path)
    # tenant-dimension fence, both ways (same shape as the tool fence
    # below): a serve row carrying per-tenant sub-rows measured a
    # multi-tenant mix — its latency is the mix's, so it only gates
    # against a baseline that carried the dimension too, and an
    # untenanted baseline never gates a tenant-dimension row
    tenancy = led.tenant_dimension(baseline or {})
    rows = [r for r in rows if led.tenant_dimension(r) == tenancy]
    # sentinel fence, both ways (mct-sentinel): a row that recorded canary
    # digest drift measured a run whose OUTPUTS were wrong — its latency
    # is a drill's (or an incident's), never a perf baseline, and a clean
    # row must not gate against a drifted baseline either
    drifted = led.sentinel_dimension(baseline or {})
    rows = [r for r in rows if led.sentinel_dimension(r) == drifted]
    # batch-dimension fence, both ways (continuous batching): a row
    # measured under the packing scheduler carries its mean occupancy —
    # its per-request latency amortizes dispatch overhead across
    # batchmates, so it only gates against a baseline measured under
    # packing too (occupancy SHIFTS between two packed rows become
    # advisory attribution lines inside check_regression)
    packed = led.batch_dimension(baseline or {})
    rows = [r for r in rows if led.batch_dimension(r) == packed]
    # durability fence, both ways (mct-durable): a row measured under
    # failover/replay (streams resumed from snapshots, WAL replay after a
    # daemon kill) pays re-run chunks and restart walls that are the
    # chaos drill's, not code drift's — it only gates against a baseline
    # measured under failover too, and never fences a clean row
    failover = led.durability_dimension(baseline or {})
    rows = [r for r in rows if led.durability_dimension(r) == failover]
    # gate comparable rows: a run-row median must not be compared against a
    # bench baseline just because it is the newest numeric row
    current = None
    base_metric = baseline.get("metric") if baseline else None
    # fenced trajectories measure different experiments (serve: s/request
    # under concurrency; tier1: suite wall seconds) — a baseline from one
    # of them only gates its own rows, and a bench/run baseline never
    # gates them just because their row is the newest
    base_fence = None
    for tool in led.FENCED_TOOLS:
        if (baseline or {}).get("tool") == tool or (
                isinstance(base_metric, str)
                and base_metric.startswith(tool + " ")):
            base_fence = tool
    if base_metric:
        current = led.latest_value_row(rows, metric=base_metric)
    if current is None:
        pool = ([r for r in rows if r.get("tool") == base_fence]
                if base_fence else rows)
        current = led.latest_value_row(
            pool, exclude_tools=() if base_fence else led.FENCED_TOOLS)
        if current is not None and base_metric \
                and current.get("metric") != base_metric:
            lines.append(f"WARNING: no ledger row matches baseline metric "
                         f"{base_metric!r}; gating the newest numeric row "
                         f"({current.get('metric')!r}) — interpret with care")
    ok, verdict_lines = led.check_regression(current, baseline,
                                             threshold=threshold)
    lines.append(f"== perf regress gate: {ledger_path} vs {baseline_path} ==")
    lines.extend(verdict_lines)
    record = {"ok": ok, "threshold": threshold,
              "current": current, "baseline": baseline,
              "detail": verdict_lines}
    return (0 if ok else 2), lines, record


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m maskclustering_tpu_torch.obs.report",
        description="render / diff obs JSONL event captures; "
                    "perf-ledger sections")
    p.add_argument("events", nargs="?", default=None,
                   help="events.jsonl written by an obs-armed run (optional "
                        "with --history/--regress)")
    p.add_argument("--diff", default=None,
                   help="second events.jsonl to diff against (B side)")
    p.add_argument("--json", action="store_true",
                   help="emit the machine-readable summary instead of tables")
    p.add_argument("--cost", action="store_true",
                   help="the JAX report's compile-time cost observatory "
                        f"(not ported: {COST_ITEM})")
    p.add_argument("--cost-mesh", default="1x8,8x1",
                   help=f"mesh configs for --cost (not ported: {COST_ITEM})")
    p.add_argument("--ledger", default=None,
                   help="perf ledger path (default: PERF_LEDGER_TORCH.jsonl "
                        "or $MCT_PERF_LEDGER)")
    p.add_argument("--history", action="store_true",
                   help="render the perf ledger trajectory")
    p.add_argument("--regress", default=None, metavar="BASELINE",
                   help="gate the ledger's newest value against BASELINE (a "
                        "ledger JSONL or a JSON doc with a 'value'); exits 2 "
                        "on a regression past the threshold")
    p.add_argument("--regress-threshold", type=float, default=None,
                   help="relative p50 slowdown that fails the gate "
                        "(default 0.15)")
    p.add_argument("--slo-spec", default=None, metavar="SPEC",
                   help="SLO spec JSON for the report's SLO section "
                        "(default: the canned serve-default; the section "
                        "renders only when the events file carries "
                        "telemetry windows)")
    args = p.parse_args(argv)
    if args.cost:
        raise _cost_unported("--cost")

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    rc = 0
    did_something = False
    # --json must keep stdout one machine-readable document: every
    # requested section lands in this dict, printed exactly once at the end
    json_doc: Dict = {}
    sections: List[str] = []

    if args.events:
        did_something = True
        run = RunData(args.events)
        if args.json:
            json_doc["summary"] = run.summary()
        else:
            sections.append(render_report(run, slo_spec=args.slo_spec))
            if args.diff:
                sections.append(render_diff(run, RunData(args.diff)))

    if args.history or args.regress:
        from maskclustering_tpu_torch.obs import ledger as led

        ledger_path = args.ledger or led.default_ledger_path()
        if args.history:
            did_something = True
            stats = ReadStats()
            try:
                rows = led.read_ledger(ledger_path, stats=stats)
            except OSError as e:
                print(f"--history: cannot read ledger {ledger_path}: {e}",
                      file=sys.stderr)
                return 2
            if args.json:
                json_doc["history"] = rows
            else:
                sections.append(render_history(rows, stats, ledger_path))
        if args.regress:
            did_something = True
            threshold = (args.regress_threshold
                         if args.regress_threshold is not None
                         else led.DEFAULT_REGRESS_THRESHOLD)
            gate_rc, lines, record = _regress_eval(ledger_path, args.regress,
                                                   threshold)
            rc = max(rc, gate_rc)
            if args.json:
                json_doc["regress"] = record
            else:
                sections.append("\n".join(lines))

    if not did_something:
        p.error("nothing to do: give an events file or one of "
                "--history/--regress")
    if args.json:
        # one-section --json keeps the historical flat shape (the summary
        # document test_run and run.py's digest embed); multi-section gets
        # the keyed document
        if list(json_doc) == ["summary"]:
            print(json.dumps(json_doc["summary"], indent=2))
        else:
            print(json.dumps(json_doc, indent=2))
    else:
        print("\n\n".join(sections))
    return rc


if __name__ == "__main__":
    sys.exit(main())
