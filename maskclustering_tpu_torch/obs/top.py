"""Live terminal dashboard over a serving daemon's telemetry op (the port's
copy of ``maskclustering_tpu/obs/top.py``; it watches either package's
daemon).

    python -m maskclustering_tpu_torch.obs.top --socket /tmp/mct.sock
    python -m maskclustering_tpu_torch.obs.top --host 127.0.0.1 --port 7777
    python -m maskclustering_tpu_torch.obs.top --socket ... --once   # one frame

Polls ``{"op": "status", "detail": "telemetry"}`` at a fixed interval and
renders a refreshing view: request latency p50/p95 by shape bucket
(window + cumulative), a queue-depth sparkline over the window ring,
reject/crash/respawn rates, worker liveness (heartbeat age, consecutive
respawns, in-flight crash count — the wedge-is-coming signals), AOT-cache
hits and post-warm compile violations (the serve-many contract, live),
per-tenant accounting rows and the armed SLO spec's burn-rate panel
(the poll asks for ``detail=slo``, which is telemetry + the verdict).

Rendering is a pure function over the stats document (``render_top``) so
the dashboard is testable without a TTY; the CLI loop only clears the
screen and reconnects per poll (a daemon restart costs one missed frame,
not a dead dashboard).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: List[float], width: int = 32) -> str:
    """Unicode sparkline of the last ``width`` values (empty-safe)."""
    vals = [float(v) for v in values][-width:]
    if not vals:
        return ""
    hi = max(vals)
    if hi <= 0:
        return _SPARK[0] * len(vals)
    return "".join(_SPARK[min(int(v / hi * (len(_SPARK) - 1) + 0.5),
                              len(_SPARK) - 1)] for v in vals)


def _fmt(v: Optional[float], suffix: str = "s") -> str:
    return "-" if v is None else f"{v:.3f}{suffix}"


def _rate(windows: List[Dict], key: str) -> float:
    """Per-second rate of a window counter over the ring."""
    total = sum(w.get(key, 0) or 0 for w in windows)
    dur = sum(w.get("dur_s", 0.0) or 0.0 for w in windows)
    return total / dur if dur > 0 else 0.0


def render_top(stats: Dict, *, now: Optional[float] = None) -> str:
    """One dashboard frame from a ``status detail=telemetry`` answer."""
    now = time.time() if now is None else now
    tel = stats.get("telemetry") or {}
    windows: List[Dict] = tel.get("windows") or []
    cum = tel.get("cumulative") or {}
    counters = cum.get("counters") or {}
    gauges = cum.get("gauges") or {}
    current = tel.get("current") or {}
    queue = stats.get("queue") or {}
    worker = stats.get("worker") or {}
    lines: List[str] = []

    lines.append(
        f"mct-serve top — config {stats.get('config', '?')} | "
        f"uptime {stats.get('uptime_s', 0):.0f}s | "
        f"window {tel.get('window_s', '?')}s x {len(windows)} | "
        f"{'DRAINING' if stats.get('draining') else 'serving'}")

    counts = stats.get("counts") or {}
    lines.append(
        "requests: " + " | ".join(
            f"{k} {counts.get(k, 0)}"
            for k in ("requests", "ok", "failed", "deadline", "interrupted")
            if counts.get(k)) if any(counts.values())
        else "requests: none yet")

    # queue: live depth + the ring's depth history as a sparkline
    depths = [w.get("queue_depth", 0) for w in windows]
    lines.append(
        f"queue: depth {queue.get('depth', 0)}/{queue.get('capacity', '?')} "
        f"| high-water {queue.get('high_water', 0)} "
        f"| admitted {queue.get('admitted', 0)}"
        + (f"  [{sparkline(depths)}]" if depths else ""))

    # latency by bucket: each bucket's newest window WITH data (an idle
    # last window must not blank the view) next to cumulative
    cum_lat = cum.get("latency") or {}
    buckets = sorted(set(list(cum_lat))
                     | {b for w in windows for b in (w.get("latency") or {})})
    for b in buckets:
        w = next((wd["latency"][b] for wd in reversed(windows)
                  if (wd.get("latency") or {}).get(b)), {})
        c = cum_lat.get(b) or {}
        lines.append(
            f"  bucket {b:<18} window p50 {_fmt(w.get('p50_s'))} "
            f"p95 {_fmt(w.get('p95_s'))} (n={w.get('count', 0)}) | "
            f"cum p50 {_fmt(c.get('p50'))} p95 {_fmt(c.get('p95'))} "
            f"(n={c.get('count', 0)})")
    wait = next((wd["queue_wait"] for wd in reversed(windows)
                 if wd.get("queue_wait")),
                current.get("queue_wait") or {})
    if wait:
        lines.append(f"  queue wait: p50 {_fmt(wait.get('p50_s'))} "
                     f"p95 {_fmt(wait.get('p95_s'))} "
                     f"max {_fmt(wait.get('max_s'))}")

    # fault surface: rejects / crashes / respawns as ring rates
    rejects: Dict[str, int] = {}
    for w in windows:
        for r, n in (w.get("rejects") or {}).items():
            rejects[r] = rejects.get(r, 0) + int(n)
    crash_rate = _rate(windows, "crashes")
    lines.append(
        "faults: "
        + (("rejects " + ", ".join(f"{r} x{n}"
                                   for r, n in sorted(rejects.items())) + " | ")
           if rejects else "rejects none | ")
        + f"crashes {int(sum(w.get('crashes', 0) for w in windows))} "
        f"({crash_rate:.3f}/s) | "
        f"respawns {int(sum(w.get('respawns', 0) for w in windows))} | "
        f"requeued {int(sum(w.get('requeued', 0) for w in windows))}")

    # worker liveness: pool panel (one row per slice) when the daemon
    # carves a pool, else the single isolated-worker wedge-is-coming line
    pool = stats.get("pool") or {}
    if pool:
        sched = pool.get("scheduler") or {}
        hits = int(sched.get("affinity_hits", 0))
        misses = int(sched.get("affinity_misses", 0))
        routed = hits + misses
        lines.append(
            f"pool: carve {pool.get('carve', '?')} | "
            f"alive {worker.get('alive', '?')}/{worker.get('pool', '?')} | "
            f"dispatched {int(sched.get('dispatched', 0))} | "
            f"affinity {hits}/{routed} warm"
            + (f" ({hits / routed:.0%})" if routed else "")
            + f" | crash reroutes {int(sched.get('crash_reroutes', 0))} | "
            f"recarves {int(sched.get('recarves', 0))}")
        for w in pool.get("workers") or []:
            hb = w.get("hb_age_s")
            state = "RETIRED" if w.get("retired") else "up"
            lines.append(
                f"  worker {w.get('worker_id', '?')}: {state:<7} "
                f"pid {w.get('pid', '?')} | "
                f"hb age {_fmt(hb) if hb is not None else '-'} | "
                f"feed {int(w.get('feed_depth', 0))} | "
                f"dispatched {int(w.get('dispatched', 0))} | "
                f"warm {int(w.get('warm_buckets', 0))} | "
                f"respawns {w.get('consecutive_respawns', 0)} | "
                f"streams open {int(w.get('open_streams', 0))}"
                + (f" lost {int(w.get('lost_streams', 0))}"
                   if w.get("lost_streams") else ""))
        tenants = pool.get("tenants") or {}
        if tenants:
            lines.append("  dequeue share: " + " | ".join(
                f"{t} {int(v.get('dispatched', 0))} (w={v.get('weight', 1)}"
                + (f", quota {v.get('quota')}" if v.get("quota") else "")
                + ")" for t, v in sorted(tenants.items())))
    elif worker:
        hb = worker.get("hb_age_s")
        lines.append(
            f"worker: pid {worker.get('pid', '?')} | "
            f"hb age {_fmt(hb) if hb is not None else '-'} | "
            f"spawns {worker.get('spawns', 0)} | "
            f"consecutive respawns {worker.get('consecutive_respawns', 0)} | "
            f"in-flight crashes {worker.get('inflight_crashes', 0)}")

    # the serve-many contract, live
    post_warm = int(sum(w.get("post_warm_compiles", 0) for w in windows))
    pf_gauge = gauges.get("retrace.live.post_freeze")
    if pf_gauge is not None:
        post_warm = max(post_warm, int(pf_gauge))
    aot_hits = int(counters.get("aot_cache.hits", 0))
    lines.append(
        f"compiles: post-warm {post_warm}"
        + (" [VIOLATION]" if post_warm else "")
        + f" | aot-cache hits {aot_hits} | warm buckets "
        f"{len(stats.get('warm_buckets') or [])}")
    relayed = int(counters.get("worker.telem_messages", 0))
    if relayed:
        lines.append(
            f"relay: {relayed} telem line(s) | "
            f"{int(counters.get('worker.telem_spans', 0))} span(s)"
            + (f" | {int(counters.get('worker.telem_spans_dropped', 0))} "
               f"dropped" if counters.get("worker.telem_spans_dropped")
               else ""))

    # per-tenant accounting (cumulative since rebase; windows carry the
    # same sub-rows): who is spending the device
    cum_tenants = cum.get("tenants") or {}
    if cum_tenants:
        lines.append("tenants:")
        for name in sorted(cum_tenants):
            t = cum_tenants[name] or {}
            lat = (t.get("latency") or {}).get("all") or {}
            lines.append(
                f"  {name:<16} req {int(t.get('requests', 0))} "
                f"| rejects {int(t.get('rejects', 0))} "
                f"| crashes {int(t.get('crashes', 0))} "
                f"| p95 {_fmt(lat.get('p95'))} "
                f"| device {float(t.get('device_s', 0.0)):.3f}s "
                f"| d2h {int(t.get('d2h_bytes', 0))}B")

    # the mct-sentinel panel: canary probe volume + drift, live. The
    # summary rides every status answer of a sentinel-armed daemon; the
    # per-coordinate matrix only a ``detail=sentinel`` poll.
    canary = stats.get("canary")
    sentinel = stats.get("sentinel") or {}
    if canary or sentinel.get("rounds") is not None:
        rounds = int((canary or {}).get("rounds",
                                        sentinel.get("rounds", 0)) or 0)
        drift_total = int((canary or {}).get(
            "drift_total", sentinel.get("drift_total", 0)) or 0)
        ring_drift = int(sum(w.get("drift", 0) or 0 for w in windows))
        line = (f"sentinel: canary rounds {rounds} | drift {drift_total}"
                + (" [DRIFT — outputs diverged from goldens]"
                   if drift_total or ring_drift else " | goldens hold"))
        skipped = int(sentinel.get("skipped_busy", 0) or 0)
        if skipped:
            line += f" | ticks skipped busy {skipped}"
        lines.append(line)
        ages = sentinel.get("last_verified_age_s") or {}
        drift_coords = sentinel.get("drift_coords") or {}
        for coord in sorted(set(ages) | set(drift_coords)):
            mark = (f"DRIFT x{drift_coords[coord]}"
                    if coord in drift_coords else "ok")
            age = (f"verified {ages[coord]:.0f}s ago"
                   if coord in ages else "never verified")
            lines.append(f"  {coord:<44} {mark:<10} {age}")

    # the SLO burn-rate panel (status detail=slo answers only)
    slo = stats.get("slo")
    if slo is not None:
        from maskclustering_tpu_torch.obs.slo import render_result

        lines.extend(render_result(slo))
    return "\n".join(lines)


def _poll(address, timeout_s: float) -> Dict:
    from maskclustering_tpu_torch.serve.client import ServeClient

    with ServeClient(address, timeout_s=timeout_s) as client:
        # detail=slo is telemetry plus the armed spec's burn-rate verdict
        stats = client.slo()
        if stats.get("canary") is not None:
            # sentinel-armed daemon: add the per-coordinate drift matrix
            stats["sentinel"] = client.sentinel().get("sentinel")
        return stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m maskclustering_tpu_torch.obs.top",
        description="live terminal dashboard over a serving daemon's "
                    "telemetry op")
    p.add_argument("--socket", default=None, help="daemon AF_UNIX socket")
    p.add_argument("--host", default=None, help="daemon TCP host")
    p.add_argument("--port", type=int, default=0, help="daemon TCP port")
    p.add_argument("--interval", type=float, default=2.0,
                   help="poll/refresh seconds (default 2)")
    p.add_argument("--once", action="store_true",
                   help="render one frame and exit (scripts/CI)")
    p.add_argument("--json", action="store_true",
                   help="print the raw stats document instead of the view")
    args = p.parse_args(argv)
    if not args.socket and not args.host:
        p.error("need --socket PATH or --host HOST --port N")
    address = args.socket if args.socket else (args.host, args.port)

    while True:
        try:
            stats = _poll(address, timeout_s=max(args.interval * 4, 10.0))
        except Exception as e:  # noqa: BLE001 — daemon gone/restarting
            if args.once:
                print(f"obs.top: cannot reach daemon at {address}: {e}",
                      file=sys.stderr)
                return 1
            print(f"obs.top: daemon unreachable ({e}); retrying",
                  file=sys.stderr)
            time.sleep(args.interval)
            continue
        if args.json:
            print(json.dumps(stats, sort_keys=True))
        else:
            if not args.once:
                sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
            print(render_top(stats))
            sys.stdout.flush()
        if args.once:
            return 0
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
