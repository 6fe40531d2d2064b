"""Perf regression ledger: run and bench verdicts as an append-only JSONL
(the port's copy of ``maskclustering_tpu/obs/ledger.py``).

Every bench verdict and run-report digest gets a durable,
schema-versioned row:

- **append-only + crash-safe** like the event sink (one flush per row; a
  torn final line is skipped-with-a-count by the reader, never fatal);
- **never the failure source**: an append error logs once and returns
  False — the run's exit code must not depend on ledger disk health;
- **machine-checkable**: ``python -m maskclustering_tpu_torch.obs.report
  --history`` renders the trajectory, ``--regress BASELINE`` exits
  non-zero when the newest headline p50 regresses >15%.

Rows carry ``v`` (ledger schema version), ``ts``, ``tool`` (bench | run |
serve | tier1), the headline ``value``/``unit``, per-stage medians when
known, and the git revision when resolvable. The schema, the dimension
fences and the regression verdict are the JAX package's, so each package
reads the other's rows and reaches the same verdict.

The one difference is the default file: ``PERF_LEDGER_TORCH.jsonl`` in
the working directory (or ``$MCT_PERF_LEDGER``), never the JAX package's
``PERF_LEDGER.jsonl``, which in this repository is a record kept by
other tooling and must not gain rows from the port.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import time
from typing import Dict, List, Optional, Tuple

from maskclustering_tpu_torch.obs.events import ReadStats

log = logging.getLogger("maskclustering_tpu_torch")

LEDGER_SCHEMA_VERSION = 1
DEFAULT_REGRESS_THRESHOLD = 0.15  # >15% p50 slowdown fails --regress

# trajectories measuring a different experiment than bench/run s/scene:
# --regress only compares them against their own kind (obs/report.py's
# gate fences them out of the metric-less fallback pick BOTH ways)
FENCED_TOOLS = ("serve", "tier1")


DEFAULT_LEDGER_FILE = "PERF_LEDGER_TORCH.jsonl"


def default_ledger_path() -> str:
    """``PERF_LEDGER_TORCH.jsonl`` in the cwd; overridable via
    MCT_PERF_LEDGER (tests point it at a tmp dir so default-on appends
    stay hermetic)."""
    return os.environ.get("MCT_PERF_LEDGER", DEFAULT_LEDGER_FILE)


def _git_rev() -> Optional[str]:
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, timeout=10)
        rev = out.stdout.decode("utf-8", "replace").strip()
        return rev if out.returncode == 0 and rev else None
    except Exception:  # noqa: BLE001 — no git is a fine place to run a bench
        return None


def append_row(path: str, row: Dict) -> bool:
    """Append one schema-versioned row; one flush, never raises."""
    line = {"v": LEDGER_SCHEMA_VERSION, "ts": time.time(), "pid": os.getpid()}
    line.update(row)
    if "git" not in line:
        rev = _git_rev()
        if rev:
            line["git"] = rev
    from maskclustering_tpu_torch.obs import metrics as _metrics

    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(line) + "\n")
        _metrics.count("ledger.rows_appended")
        return True
    except Exception:  # noqa: BLE001 — the ledger must never sink the run
        log.exception("perf ledger append failed; row dropped (%s)", path)
        _metrics.count("ledger.rows_dropped")
        return False


def bench_row(verdict: Dict, **extra) -> Dict:
    """Ledger row from a bench JSON verdict line (bench.py's stdout line)."""
    row = {"tool": "bench",
           "metric": verdict.get("metric"),
           "value": verdict.get("value"),
           "unit": verdict.get("unit", "s/scene")}
    for k in ("vs_baseline", "spread_pct", "stages", "attempts",
              "frame_batch", "count_dtype", "plane_dtype",
              "postprocess_path", "point_shards", "retrace_compiles",
              "retrace_repeats", "retrace_post_freeze", "error"):
        if verdict.get(k) is not None:
            row[k] = verdict[k]
    row.update(extra)
    return row


def run_row(report: Dict, **extra) -> Dict:
    """Ledger row from a run-report dict (run.py's run_report.json shape).

    Headline value: median ok-scene seconds (the serving-facing number);
    stages come from the embedded obs digest when the run was armed.
    """
    scenes = report.get("scenes") or []
    ok = sorted(s.get("seconds", 0.0) for s in scenes
                if s.get("status") == "ok")
    value = ok[len(ok) // 2] if ok else None
    row = {"tool": "run",
           "metric": "run s/scene (median of ok scenes)",
           "value": round(value, 3) if value is not None else None,
           "unit": "s/scene",
           "scenes_ok": len(ok),
           "scenes_failed": sum(1 for s in scenes
                                if s.get("status") == "failed"),
           "config": report.get("config_name")}
    digest = report.get("obs") or {}
    stages = digest.get("stages")
    if stages:
        row["stages"] = {k: v.get("p50_s") for k, v in stages.items()}
    # compile-surface attribution (retrace-sanitizer-armed runs only): the
    # summary's counters carry the compile events; stamping them on the
    # row lets --regress attribute a warm-up/compile delta before anyone
    # blames code drift (same move as the dtype knobs)
    counters = digest.get("counters") or {}
    for src, dst in (("retrace.compiles", "retrace_compiles"),
                     ("retrace.repeat_compiles", "retrace_repeats"),
                     ("retrace.post_freeze_compiles", "retrace_post_freeze"),
                     ("compile_cache.bucket_new", "buckets_new")):
        if src in counters:
            # presence, not truthiness: a fully-warm armed run books
            # retrace.compiles=0, and THAT zero is the baseline row the
            # 0 -> N regression attribution anchors on
            row[dst] = int(counters[src])
    for src, dst in (("retrace.cache_hits", "retrace_cache_hits"),
                     ("aot_cache.restored", "aot_restored"),
                     ("aot_cache.invalidated", "aot_invalidated")):
        # warm-start attribution (nonzero only — clean rows stay compact):
        # a fast cold start next to restored/hit counts is the AOT cache's
        # story, not code drift
        if counters.get(src):
            row[dst] = int(counters[src])
    faults = report.get("faults") or {}
    # fault attribution: a degraded/retried run's headline is the fault's
    # story, not code drift — stamp it so --regress can say so (keys only
    # appear when nonzero, keeping clean rows compact)
    for src, dst in (("scene_retries", "retries"),
                     ("device_stalls", "device_stalls"),
                     ("final_rung", "final_rung")):
        if faults.get(src):
            row[dst] = faults[src]
    if faults.get("degradations"):
        row["degradations"] = sum(faults["degradations"].values())
    if faults.get("interrupted"):
        row["interrupted"] = True
    # mct-sentinel stamp: the census coordinates the run's digests were
    # observed at plus one combined artifact fingerprint over all ok
    # scenes — --regress attributes a digest change to a coordinate/knob
    # flip before anyone reads it as code drift (and vice versa)
    coords = sorted({s.get("digest_coord") for s in scenes
                     if s.get("status") == "ok" and s.get("digest_coord")})
    if coords:
        row["digest_coord"] = ",".join(coords)
        import zlib

        seed = 0
        for s in sorted(scenes, key=lambda s: s.get("seq_name") or ""):
            art = ((s.get("digest") or {}).get("artifact") or "")
            seed = zlib.crc32(
                f"{s.get('seq_name')}:{art}".encode(), seed) & 0xFFFFFFFF
        row["digest"] = f"{seed:08x}"
    row.update(extra)
    return row


def serve_row(verdict: Dict, **extra) -> Dict:
    """Ledger row from a load generator serve verdict (``tools/load_gen.py``).

    The metric is serve-specific ("serve s/request ..."), so --regress
    never gates a serve row against a bench/run baseline (or vice versa):
    ``latest_value_row``'s metric filter plus the tool fence below keep
    the trajectories separate while sharing one ledger file.
    """
    row = {"tool": "serve",
           "metric": verdict.get("metric", "serve s/request (p50)"),
           "value": verdict.get("value"),
           "unit": verdict.get("unit", "s/request")}
    for k in ("p95_s", "throughput_rps", "requests", "concurrency",
              "scenes", "buckets", "rejects", "failed", "warmup_s",
              "count_dtype", "plane_dtype", "point_shards",
              "streaming_chunk",
              "retrace_compiles", "retrace_repeats", "retrace_post_freeze",
              "retrace_cache_hits", "aot_restored", "worker_crashes",
              "worker_respawns", "telemetry_windows", "window_p95",
              "tenants", "error",
              # mct-sentinel: canary probe accounting (fenced from the
              # latency headline — canaries never enter the latency
              # window) and the coordinates the probes verified
              "canary_probes", "canary_drift", "digest_coord",
              # continuous batching: the packing scheduler's occupancy
              # coordinate — a packed row's latency/throughput belongs to
              # its occupancy, so --regress fences/attributes on these
              # (batch_dimension below, occupancy advisory in
              # check_regression)
              "batch_occupancy", "batch_dispatches", "batch_max",
              "batch_hist",
              # mct-durable: failover/replay evidence from the chaos
              # drill — a row measured under injected worker/daemon death
              # is its own dimension (durability_dimension below)
              "streams_resumed", "wal_replayed", "wal_deduped",
              "journals_pruned"):
        if verdict.get(k) is not None:
            row[k] = verdict[k]
    row.update(extra)
    return row


def tenant_dimension(row: Optional[Dict]) -> bool:
    """True when a ledger row (or baseline) carries per-tenant sub-rows.

    A serve row with a ``tenants`` dict measured a multi-tenant mix, so
    its latency belongs to that mix: --regress fences the dimension BOTH
    ways (obs/report.py), exactly like the tool fence above — a tenant
    row never gates against an untenanted baseline, and vice versa.
    """
    return bool((row or {}).get("tenants"))


def sentinel_dimension(row: Optional[Dict]) -> bool:
    """True when a ledger row recorded canary digest drift (mct-sentinel).

    A row measured while the correctness plane was tripping (a corruption
    drill, a real SDC event) is not a perf datapoint: --regress fences the
    dimension BOTH ways, like ``tenant_dimension`` — a drifted row never
    gates against a clean baseline, and a clean row never gates against a
    drifted one.
    """
    return bool((row or {}).get("canary_drift"))


def batch_dimension(row: Optional[Dict]) -> bool:
    """True when a ledger row was measured under the packing scheduler
    (continuous scene batching, ``serve_batch_max > 1``).

    A packed row's per-request latency and throughput belong to its batch
    occupancy — dispatch overhead amortizes across batchmates — so
    --regress fences the dimension BOTH ways (obs/report.py), like
    ``tenant_dimension``: a packed row never gates against a sequential
    baseline, and vice versa. Occupancy SHIFTS between two packed rows are
    attributed as advisory lines in ``check_regression`` instead.
    """
    return (row or {}).get("batch_occupancy") is not None


def durability_dimension(row: Optional[Dict]) -> bool:
    """True when a ledger row was measured under failover/replay — a
    stream resumed from a snapshot or a WAL replay answered requests
    (the chaos drill's rows).

    Re-run chunks and daemon restarts inflate per-request latency for
    reasons that are the DRILL's, not code drift's, so --regress fences
    the dimension BOTH ways (obs/report.py), like ``batch_dimension``: a
    failover row never gates against a clean baseline, and vice versa.
    """
    row = row or {}
    return bool(row.get("streams_resumed")) or bool(row.get("wal_replayed"))


def tier1_row(wall_s: float, passed: int, **extra) -> Dict:
    """Ledger row for one tier-1 suite run (scripts/ci.sh appends it).

    Tracks the 870 s budget trajectory with the same --regress machinery
    as perf: the metric is tier1-specific ("tier1 ..."), so the tool fence
    (FENCED_TOOLS) keeps it out of bench/run gating, and a tier1 baseline
    gates only tier1 rows. ``passed`` rides along so a wall drop that
    coincides with a pass-count drop reads as a trim, not a speedup.
    """
    row = {"tool": "tier1",
           "metric": "tier1 wall s (not-slow suite)",
           "value": round(float(wall_s), 1),
           "unit": "s",
           "passed": int(passed)}
    row.update(extra)
    return row


def read_ledger(path: str, *, stats: Optional[ReadStats] = None) -> List[Dict]:
    """All known-version rows, oldest first; torn/unknown lines are counted
    into ``stats`` and skipped (one shared policy: events.iter_jsonl_rows)."""
    from maskclustering_tpu_torch.obs.events import iter_jsonl_rows

    return list(iter_jsonl_rows(path, version=LEDGER_SCHEMA_VERSION,
                                stats=stats))


def latest_value_row(rows: List[Dict], *,
                     metric: Optional[str] = None,
                     exclude_tools: Tuple[str, ...] = ()) -> Optional[Dict]:
    """Newest row with a numeric headline value (null verdicts are history,
    not baselines). ``metric`` restricts the pick to comparable rows — the
    --regress gate must not compare a run-row median against a bench
    baseline just because it is newer. ``exclude_tools`` fences whole
    trajectories out of the METRIC-LESS fallback pick: a ``serve`` p50
    (s/request under concurrency) must never gate against a bench
    baseline (s/scene) just because a load_gen row is the newest."""
    for row in reversed(rows):
        if not isinstance(row.get("value"), (int, float)):
            continue
        if metric is not None and row.get("metric") != metric:
            continue
        if metric is None and row.get("tool") in exclude_tools:
            continue
        return row
    return None


def load_baseline(path: str) -> Optional[Dict]:
    """A baseline for --regress: a ledger JSONL (newest valid row) or a
    single JSON document with a ``value`` field (a bench verdict / BENCH_*
    record)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            head = f.read()
    except OSError:
        return None
    try:
        doc = json.loads(head)
        if isinstance(doc, dict) and isinstance(doc.get("value"), (int, float)):
            return doc
    except ValueError:
        pass
    try:
        return latest_value_row(read_ledger(path))
    except Exception:  # noqa: BLE001
        return None


def check_regression(current: Optional[Dict], baseline: Optional[Dict], *,
                     threshold: float = DEFAULT_REGRESS_THRESHOLD
                     ) -> Tuple[bool, List[str]]:
    """Headline p50 gate: ok unless current is >threshold slower.

    Lower is better (s/scene). Stage-level drifts are reported as advisory
    lines but only the headline value gates — stage noise on shared CPUs
    would otherwise make the gate cry wolf.
    """
    lines: List[str] = []
    if current is None:
        return False, ["no current row with a numeric value — cannot gate "
                       "(an empty/null trajectory is itself a failure)"]
    if baseline is None:
        return False, ["no usable baseline value"]
    cur, base = float(current["value"]), float(baseline["value"])
    if base <= 0:
        return False, [f"baseline value {base} is not positive"]
    rel = (cur - base) / base
    verdict = "REGRESSION" if rel > threshold else "ok"
    lines.append(f"headline: {cur:.3f} vs baseline {base:.3f} "
                 f"({rel:+.1%}, threshold +{threshold:.0%}) -> {verdict}")
    # knob attribution: a headline delta that coincides with a dtype or
    # postprocess-path flip is a knob effect, not code drift — say so next
    # to the verdict (rows predating a knob have no key and read as the
    # historical defaults; postprocess_path predates as "device": rows
    # before the knob ran the default device path)
    knob_flips = []
    # point_shards defaults to 1: rows predating the knob ran unsharded,
    # so a sharded row against an old baseline reads as a knob flip (the
    # resharded program has its own compile surface and ICI profile).
    # streaming_chunk defaults to 0 (offline batch): a chunked row's
    # latency profile belongs to the chunk size, not code drift
    for knob, default in (("count_dtype", "bf16"), ("plane_dtype", "int32"),
                          ("postprocess_path", "device"),
                          ("point_shards", 1), ("streaming_chunk", 0)):
        c, b = current.get(knob, default), baseline.get(knob, default)
        if c != b:
            knob_flips.append(knob)
            lines.append(f"  {knob}: {b} -> {c} [knob flip — attribute "
                         f"the delta before blaming code]")
    # compile-surface attribution (retrace sanitizer): a compile
    # count or warm-up wall that regressed next to the headline is either
    # a knob flip's new variant or genuine surface growth — the advisory
    # names which BEFORE anyone reads the delta as code drift
    cur_rc = current.get("retrace_compiles")
    base_rc = baseline.get("retrace_compiles")
    if cur_rc is not None and base_rc is not None \
            and int(cur_rc) > int(base_rc):
        cause = ("the flipped knob's variant compiling its own programs"
                 if knob_flips else
                 "compile-surface growth or a cold process — check the "
                 "retrace digest and compile_surface_baseline.json")
        lines.append(f"  retrace: sanitizer recorded {base_rc} -> {cur_rc} "
                     f"compile(s) [{cause}]")
    for key, label in (("retrace_repeats", "repeat compile(s)"),
                       ("retrace_post_freeze", "post-warm compile(s)")):
        if current.get(key):
            lines.append(f"  retrace VIOLATION: current run booked "
                         f"{current[key]} {label} — the warm path "
                         f"retraced; fix that before reading the headline "
                         f"as code drift")
    # fault attribution: run rows stamp retries/degradations (run.py) — a
    # degraded run is slower BY DESIGN, so the gate says so before anyone
    # blames code drift for the fault's wall-clock cost
    for label, r in (("current", current), ("baseline", baseline)):
        retries = int(r.get("retries") or 0)
        degr = int(r.get("degradations") or 0)
        if retries or degr:
            lines.append(
                f"  {label} run recorded {retries} scene retr"
                f"{'y' if retries == 1 else 'ies'} and {degr} "
                f"degradation(s) [fault attribution — the delta may be "
                f"the fault's, not code drift]")
    # sentinel attribution: a digest change at an UNCHANGED coordinate is
    # code drift in the outputs themselves — say so louder than any perf
    # delta; a coordinate change explains a digest change before anyone
    # blames code (the knob-flip move, applied to correctness)
    cur_dc, base_dc = current.get("digest_coord"), baseline.get("digest_coord")
    cur_dg, base_dg = current.get("digest"), baseline.get("digest")
    if cur_dc and base_dc and cur_dc != base_dc:
        lines.append(f"  digest_coord: {base_dc} -> {cur_dc} [coordinate "
                     f"change — digests are per-coordinate; not comparable]")
    elif cur_dg and base_dg and cur_dg != base_dg:
        cause = ("the flipped knob changed the observed coordinate set"
                 if knob_flips else
                 "OUTPUTS CHANGED at an unchanged coordinate — code drift "
                 "in the answers; audit before regenerating canary goldens")
        lines.append(f"  sentinel: run digest {base_dg} -> {cur_dg} "
                     f"[{cause}]")
    for label, r in (("current", current), ("baseline", baseline)):
        if r.get("canary_drift"):
            lines.append(
                f"  {label} row recorded {int(r['canary_drift'])} canary "
                f"drift event(s) [sentinel fence — correctness was "
                f"violated while measuring; not a perf datapoint]")
    # occupancy attribution (continuous batching): two packed rows with
    # different mean occupancy measured different amortization — the
    # throughput/latency delta is the packing's before it is code drift
    # (the digest-coord move, applied to the batching dimension; rows on
    # OPPOSITE sides of the dimension never reach this gate — obs/report
    # fences batch_dimension both ways)
    cur_occ = current.get("batch_occupancy")
    base_occ = baseline.get("batch_occupancy")
    if cur_occ is not None and base_occ is not None:
        try:
            co, bo = float(cur_occ), float(base_occ)
        except (TypeError, ValueError):
            co = bo = 0.0
        if abs(co - bo) >= 0.25:
            lines.append(
                f"  batch_occupancy: {bo:g} -> {co:g} [occupancy shift — "
                f"packed dispatches amortize over their members; attribute "
                f"the per-request delta to the packing mix before blaming "
                f"code]")
    cur_stages = current.get("stages") or {}
    base_stages = baseline.get("stages") or {}
    for k in sorted(set(cur_stages) & set(base_stages)):
        try:
            c, b = float(cur_stages[k]), float(base_stages[k])
        except (TypeError, ValueError):
            continue
        if b > 0 and (c - b) / b > threshold:
            lines.append(f"  stage {k}: {c:.3f} vs {b:.3f} "
                         f"({(c - b) / b:+.1%}) [advisory]")
    return rel <= threshold, lines
