"""Serving SLOs: burn-rate objectives over the telemetry window ring (the
port's copy of ``maskclustering_tpu/obs/slo.py``).

A spec is a small JSON document naming objectives over the windowed
telemetry ring (obs/telemetry.py snapshots — live over the wire, or the
``telemetry`` rows an armed daemon appended to its events file):

    {"v": 1, "name": "serve-default",
     "windows": {"short": 1, "long": 5},
     "objectives": [
       {"name": "latency-p95", "kind": "latency_p95", "threshold": 60.0},
       {"name": "errors", "kind": "error_rate", "threshold": 0.05},
       {"name": "queue-wait-p95", "kind": "queue_wait_p95",
        "threshold": 60.0},
       {"name": "no-post-warm-compiles", "kind": "post_warm_compiles",
        "threshold": 0}]}

Objective kinds: ``latency_p95`` / ``latency_p50`` (worst bucket in the
window, or one bucket via ``"bucket"``), ``error_rate`` (non-ok
terminal statuses + crashes over requests), ``queue_wait_p95``,
``post_warm_compiles``, ``crash_count`` and ``drift_count`` (absolute
counts; threshold is the allowed total — ``drift_count`` reads the
canary digest-mismatch field the telemetry window folds in, the
mct-sentinel correctness signal). An objective may scope to one tenant with
``"tenant"`` — it then reads the per-tenant sub-windows the aggregator
maintains.

Evaluation is the classic two-window burn rate: each objective is
measured over the SHORT window (the newest ``windows.short`` ring rows)
and the LONG window (the newest ``windows.long`` rows); ``burn`` =
observed / threshold, and the objective is **violated only when both
windows burn past 1.0** — a single bad window does not page, a
sustained one does. Zero-threshold counts burn at the observed count
itself, so a lone occurrence (burn exactly 1.0) stays on the right
side of the strict ``>`` rule — EXCEPT ``drift_count``, which is
zero-tolerance: any occurrence in the long window violates, because a
canary digest mismatch is silent corruption, not a budgetable
degradation. Windows with no traffic produce no
verdict (``no_data``) rather than a fake pass/fail number — the
empty-window render path must never divide by zero or take a
percentile of nothing.

Percentiles cannot be merged across windows, so a multi-window latency
observation is the WORST window p95 in range — the same worst-window
rule the report's telemetry digest uses.

``--check`` mode exits non-zero naming the violated objective(s) — the
CI gate shape. The daemon serves the evaluation as the ``slo`` wire
detail; ``obs.top`` renders it live and ``obs.report`` as an "SLO"
section.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Dict, List, Optional

log = logging.getLogger("maskclustering_tpu_torch")

SLO_SCHEMA_VERSION = 1

KINDS = ("latency_p95", "latency_p50", "error_rate", "queue_wait_p95",
         "post_warm_compiles", "crash_count", "drift_count")

# statuses that count against the error budget (the non-ok terminal
# classes the aggregator tracks; "skipped" is an artifact no-op, not an
# error)
ERROR_STATUSES = ("failed", "deadline", "interrupted")

DEFAULT_SPEC: Dict = {
    "v": SLO_SCHEMA_VERSION,
    "name": "serve-default",
    "windows": {"short": 1, "long": 5},
    "objectives": [
        {"name": "latency-p95", "kind": "latency_p95", "threshold": 120.0},
        {"name": "errors", "kind": "error_rate", "threshold": 0.05},
        {"name": "queue-wait-p95", "kind": "queue_wait_p95",
         "threshold": 120.0},
        {"name": "no-post-warm-compiles", "kind": "post_warm_compiles",
         "threshold": 0},
        # zero tolerance: any canary digest drift is silent corruption,
        # not a budgetable degradation (mct-sentinel correctness plane)
        {"name": "correctness", "kind": "drift_count", "threshold": 0},
    ],
}


def validate_spec(spec: Dict) -> Dict:
    """Normalize + validate; raises ValueError naming the bad field."""
    if not isinstance(spec, dict):
        raise ValueError("SLO spec must be a JSON object")
    if spec.get("v", SLO_SCHEMA_VERSION) != SLO_SCHEMA_VERSION:
        raise ValueError(f"unknown SLO spec version {spec.get('v')!r}")
    wins = spec.get("windows") or {}
    short = int(wins.get("short", 1))
    long_ = int(wins.get("long", 5))
    if short < 1 or long_ < short:
        raise ValueError(f"windows must satisfy 1 <= short <= long "
                         f"(got short={short} long={long_})")
    objs = spec.get("objectives")
    if not isinstance(objs, list) or not objs:
        raise ValueError("SLO spec needs a non-empty 'objectives' list")
    seen = set()
    out_objs = []
    for i, o in enumerate(objs):
        if not isinstance(o, dict):
            raise ValueError(f"objective #{i} is not an object")
        name = o.get("name")
        if not isinstance(name, str) or not name:
            raise ValueError(f"objective #{i} needs a name")
        if name in seen:
            raise ValueError(f"duplicate objective name {name!r}")
        seen.add(name)
        kind = o.get("kind")
        if kind not in KINDS:
            raise ValueError(f"objective {name!r}: unknown kind {kind!r} "
                             f"(one of {KINDS})")
        thr = o.get("threshold")
        if not isinstance(thr, (int, float)) or thr < 0:
            raise ValueError(f"objective {name!r}: threshold must be a "
                             f"non-negative number")
        norm = {"name": name, "kind": kind, "threshold": float(thr)}
        for opt in ("bucket", "tenant"):
            v = o.get(opt)
            if v is not None:
                if not isinstance(v, str) or not v:
                    raise ValueError(f"objective {name!r}: {opt} must be a "
                                     f"non-empty string")
                norm[opt] = v
        out_objs.append(norm)
    return {"v": SLO_SCHEMA_VERSION,
            "name": str(spec.get("name") or "unnamed"),
            "windows": {"short": short, "long": long_},
            "objectives": out_objs}


def load_spec(path: Optional[str]) -> Dict:
    """The spec file, validated; None loads the canned default."""
    if not path:
        return validate_spec(json.loads(json.dumps(DEFAULT_SPEC)))
    with open(path, "r", encoding="utf-8") as f:
        return validate_spec(json.load(f))


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def _scope(row: Dict, tenant: Optional[str]) -> Optional[Dict]:
    """The window row, or its per-tenant sub-row (None when the tenant
    never appeared in that window)."""
    if tenant is None:
        return row
    return (row.get("tenants") or {}).get(tenant)


def _observe(obj: Dict, rows: List[Dict]) -> Optional[float]:
    """The objective's observed value over ``rows``, or None with no
    data. Rates divide by request volume; percentiles take the worst
    window (percentiles cannot merge); counts sum."""
    kind = obj["kind"]
    scoped = [s for s in (_scope(r, obj.get("tenant")) for r in rows)
              if s is not None]
    if not scoped:
        return None
    if kind in ("latency_p95", "latency_p50"):
        key = "p95_s" if kind == "latency_p95" else "p50_s"
        worst = None
        for s in scoped:
            lat = s.get("latency") or {}
            hists = ([lat.get(obj["bucket"])] if obj.get("bucket")
                     else list(lat.values()))
            for h in hists:
                v = (h or {}).get(key)
                if v is not None and (worst is None or v > worst):
                    worst = float(v)
        return worst
    if kind == "queue_wait_p95":
        worst = None
        for s in scoped:
            v = (s.get("queue_wait") or {}).get("p95_s")
            if v is not None and (worst is None or v > worst):
                worst = float(v)
        return worst
    if kind == "error_rate":
        requests = sum(int(s.get("requests", 0) or 0) for s in scoped)
        if requests <= 0:
            return None
        errors = 0
        for s in scoped:
            by = s.get("by_status") or {}
            errors += sum(int(by.get(k, 0) or 0) for k in ERROR_STATUSES)
            errors += int(s.get("crashes", 0) or 0)
        return errors / requests
    if kind == "post_warm_compiles":
        return float(sum(int(s.get("post_warm_compiles", 0) or 0)
                         for s in scoped))
    if kind == "crash_count":
        return float(sum(int(s.get("crashes", 0) or 0) for s in scoped))
    if kind == "drift_count":
        # canary digest mismatches folded into the window by the
        # aggregator (obs/telemetry.py "drift") — correctness, not speed
        return float(sum(int(s.get("drift", 0) or 0) for s in scoped))
    return None


def _burn(observed: Optional[float], threshold: float) -> Optional[float]:
    """observed/threshold; a zero threshold burns at the observed count
    itself (any occurrence is over budget)."""
    if observed is None:
        return None
    if threshold <= 0:
        return float(observed)
    return observed / threshold


def evaluate(spec: Dict, snapshot: Dict) -> Dict:
    """The verdict document over one telemetry snapshot.

    ``snapshot`` is the aggregator shape ({"windows": [...], ...});
    closed window rows only — the in-flight ``current`` window is
    deliberately ignored (its duration is still running, so its rates
    are not comparable).
    """
    rows = [r for r in (snapshot or {}).get("windows") or []
            if isinstance(r, dict)]
    short_n = spec["windows"]["short"]
    long_n = spec["windows"]["long"]
    short_rows = rows[-short_n:]
    long_rows = rows[-long_n:]
    objectives = []
    ok = True
    for obj in spec["objectives"]:
        obs_short = _observe(obj, short_rows)
        obs_long = _observe(obj, long_rows)
        b_short = _burn(obs_short, obj["threshold"])
        b_long = _burn(obs_long, obj["threshold"])
        # drift_count at threshold 0 is zero-tolerance: one canary
        # digest mismatch anywhere in the long window pages — silent
        # corruption has no burn budget to amortize against
        zero_tol = obj["kind"] == "drift_count" and obj["threshold"] <= 0
        if b_short is None and b_long is None:
            state = "no_data"
        elif zero_tol and obs_long is not None and obs_long > 0:
            state = "violated"
            ok = False
        elif (not zero_tol
              and b_short is not None and b_short > 1.0
              and b_long is not None and b_long > 1.0):
            # the two-window rule: both the fast signal and the
            # sustained one must burn past budget before this pages
            state = "violated"
            ok = False
        else:
            state = "ok"
        row = {"name": obj["name"], "kind": obj["kind"],
               "threshold": obj["threshold"], "state": state,
               "observed_short": obs_short, "observed_long": obs_long,
               "burn_short": (round(b_short, 4)
                              if b_short is not None else None),
               "burn_long": (round(b_long, 4)
                             if b_long is not None else None)}
        for opt in ("bucket", "tenant"):
            if obj.get(opt):
                row[opt] = obj[opt]
        objectives.append(row)
    return {"v": SLO_SCHEMA_VERSION, "spec": spec["name"], "ok": ok,
            "windows_seen": len(rows),
            "windows": {"short": len(short_rows), "long": len(long_rows)},
            "objectives": objectives}


def violated(result: Dict) -> List[str]:
    return [o["name"] for o in (result or {}).get("objectives") or []
            if o.get("state") == "violated"]


# ---------------------------------------------------------------------------
# rendering (shared by obs.top's panel and obs.report's SLO section)
# ---------------------------------------------------------------------------


def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "-"
    return f"{v:.3f}" if isinstance(v, float) else str(v)


def render_result(result: Optional[Dict]) -> List[str]:
    """Human lines, one per objective — safe on empty/no-data input."""
    if not result:
        return ["slo: no evaluation (no spec armed)"]
    head = (f"slo [{result.get('spec', '?')}]: "
            + ("OK" if result.get("ok") else "VIOLATED")
            + f" over {result.get('windows_seen', 0)} window(s)")
    lines = [head]
    for o in result.get("objectives") or []:
        scope = "".join(f" {k}={o[k]}" for k in ("bucket", "tenant")
                        if o.get(k))
        mark = {"ok": " ok ", "violated": "FAIL", "no_data": " -- "}.get(
            o.get("state"), " ?  ")
        lines.append(
            f"  [{mark}] {o.get('name')}{scope}: "
            f"short {_fmt(o.get('observed_short'))} / "
            f"long {_fmt(o.get('observed_long'))} vs "
            f"{_fmt(o.get('threshold'))} "
            f"(burn {_fmt(o.get('burn_short'))}/{_fmt(o.get('burn_long'))})")
    return lines


# ---------------------------------------------------------------------------
# CLI: evaluate a live daemon or an events file;  --check gates
# ---------------------------------------------------------------------------


def snapshot_from_events(path: str) -> Dict:
    """A pseudo-snapshot from the ``telemetry`` rows an armed daemon
    appended to its events file (the durable half of the live ring)."""
    from maskclustering_tpu_torch.obs.events import KIND_TELEMETRY, read_events

    rows = [ev for ev in read_events(path)
            if ev.get("kind") == KIND_TELEMETRY]
    return {"windows": rows}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m maskclustering_tpu_torch.obs.slo",
        description="evaluate serving SLO burn rates over the telemetry "
                    "window ring")
    p.add_argument("--spec", default=None,
                   help="SLO spec JSON (default: the canned serve-default)")
    p.add_argument("--socket", default=None, help="live daemon AF_UNIX path")
    p.add_argument("--host", default=None, help="live daemon TCP host")
    p.add_argument("--port", type=int, default=0, help="live daemon TCP port")
    p.add_argument("--events", default=None,
                   help="events.jsonl with telemetry rows (offline mode)")
    p.add_argument("--check", action="store_true",
                   help="exit 2 naming each violated objective (CI gate)")
    p.add_argument("--json", action="store_true",
                   help="emit the verdict document")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    try:
        spec = load_spec(args.spec)
    except (OSError, ValueError) as e:
        print(f"slo: bad spec: {e}", file=sys.stderr)
        return 2
    if args.events:
        snap = snapshot_from_events(args.events)
    elif args.socket or args.host:
        from maskclustering_tpu_torch.serve.client import ServeClient

        address = args.socket if args.socket else (args.host, args.port)
        with ServeClient(address, timeout_s=30.0) as client:
            snap = (client.telemetry().get("telemetry") or {})
    else:
        p.error("need --socket, --host/--port or --events")
        return 2  # unreachable — argparse exits

    result = evaluate(spec, snap)
    if args.json:
        print(json.dumps(result, indent=2))
    else:
        print("\n".join(render_result(result)))
    if args.check and not result["ok"]:
        for name in violated(result):
            print(f"slo: VIOLATED objective: {name}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
