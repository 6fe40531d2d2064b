"""Per-request trace assembly: one serving request as a causal timeline
(the port's copy of ``maskclustering_tpu/obs/trace.py``; it reads either
package's events, journals and flight dumps).

    python -m maskclustering_tpu_torch.obs.trace r-000003 --events X.jsonl
    python -m maskclustering_tpu_torch.obs.trace r-000003 --events X.jsonl \
        --journal /path/serve_journals

Stitches everything the serving stack recorded about REQUEST_ID into one
ordered timeline with per-segment durations:

- ``serve.queue_wait`` spans (booked at dequeue; duration = ack->dequeue,
  so the segment STARTS at admission) — one per dispatch, so a requeued
  request shows its second wait too;
- ``serve.request`` execution windows (in-process: booked directly;
  isolated: relayed from the worker subprocess and replayed into the
  events file with a ``worker_pid`` tag), with the pipeline stage spans
  that ran inside each window nested under it by time containment;
- ``serve.worker_crash`` markers (the supervisor books one per in-flight
  crash) — a crash->requeue->respawn request reads as
  wait -> attempt -> CRASH -> wait -> attempt -> result;
- per-request RunJournal rows (``--journal DIR`` -> ``DIR/<id>.jsonl``):
  attempt starts, ``interrupted`` crash stamps, and the final outcome;
- ``canary.drift`` event marks (mct-sentinel, obs/canary.py): drift
  detected around this request's window renders as a zero-width
  ``CANARY DRIFT`` mark — correctness context next to the latency story;
- ``--blackbox DUMP`` merges a flight-recorder postmortem
  (obs/flight.py): span rows dedup against the live events, everything
  else becomes zero-width black-box marks — the child-side spans a
  SIGKILL'd worker never relayed appear in their true place.

Relayed spans anchor on the worker's own close timestamp (the ``end_ts``
attr the relay preserves), not the parent's re-emit time, so child and
parent segments order correctly on one wall clock.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

from maskclustering_tpu_torch.obs.events import (KIND_DRIFT, KIND_SPAN,
                                                 ReadStats, read_events)

# spans that ARE the request skeleton (matched by attrs.request == id)
_SKELETON = ("serve.queue_wait", "serve.request", "serve.worker_crash")
# container spans excluded from nesting (they would double-count stages)
_CONTAINERS = ("exec.device", "exec.host_tail", "exec.scene_loop")


def _span_window(ev: Dict) -> tuple:
    """(start_epoch, end_epoch) of one span event: the relay-preserved
    close time when present, else the envelope emit time."""
    attrs = ev.get("attrs") or {}
    end = attrs.get("end_ts")
    if not isinstance(end, (int, float)):
        end = ev.get("ts", 0.0)
    dur = float(ev.get("dur_s", 0.0))
    return float(end) - dur, float(end)


def assemble_trace(request_id: str, events_path: str,
                   journal_dir: Optional[str] = None,
                   blackbox: Optional[str] = None) -> Dict:
    """All known segments of one request, time-ordered.

    Returns ``{"request": id, "segments": [...], "warnings": [...]}``;
    each segment: ``{"t0", "t1", "dur_s", "kind", "label", "detail",
    "children": [...]}`` (children only on execution windows).

    ``blackbox`` (a flight-recorder dump, or a directory of them —
    obs/flight.py) merges the postmortem ring into the same timeline:
    the victim's final child-side spans the live relay never shipped,
    plus admission/crash marks, so a crash->requeue->respawn request
    reads end to end even when the worker died mid-flight.
    """
    stats = ReadStats()
    skeleton: List[Dict] = []
    others: List[Dict] = []
    drift_rows: List[Dict] = []
    for ev in read_events(events_path, kinds=[KIND_SPAN, KIND_DRIFT],
                          stats=stats):
        if ev.get("kind") == KIND_DRIFT:
            drift_rows.append(ev)
            continue
        name = ev.get("name")
        attrs = ev.get("attrs") or {}
        if name in _SKELETON and attrs.get("request") == request_id:
            skeleton.append(ev)
        elif isinstance(name, str) and name not in _SKELETON:
            others.append(ev)

    warnings: List[str] = []
    if stats.skipped:
        warnings.append(f"events reader skipped {stats.describe()}")

    marks: List[Dict] = []
    if blackbox:
        _merge_blackbox(blackbox, request_id, skeleton, others, marks,
                        warnings)

    segments: List[Dict] = []
    for ev in skeleton:
        t0, t1 = _span_window(ev)
        attrs = ev.get("attrs") or {}
        name = ev["name"]
        if name == "serve.queue_wait":
            seg = {"kind": "queue_wait", "label": "queue wait",
                   "detail": f"scene {attrs.get('scene', '?')}"}
        elif name == "serve.worker_crash":
            seg = {"kind": "crash", "label": "WORKER CRASH",
                   "detail": str(attrs.get("detail", ""))[:120]}
        else:
            where = (f"worker pid {attrs['worker_pid']}"
                     if attrs.get("worker_pid") else "in-process")
            seg = {"kind": "attempt", "label": "execution",
                   "detail": f"scene {attrs.get('scene', '?')} ({where})",
                   "children": _children(others, t0, t1)}
        seg.update(t0=t0, t1=t1, dur_s=round(t1 - t0, 4))
        segments.append(seg)

    for row in _journal_rows(request_id, journal_dir, warnings):
        segments.append(row)
    segments.extend(marks)

    # mct-sentinel drift marks: canary drift is daemon-wide (probes carry
    # no request id), so mark any drift detected around this request's
    # window — an answer computed next to detected corruption deserves
    # the flag in its own timeline
    if drift_rows and segments:
        lo = min(s["t0"] for s in segments)
        hi = max(s["t1"] for s in segments)
        for ev in drift_rows:
            ts = float(ev.get("ts", 0.0))
            if lo - 1.0 <= ts <= hi + 1.0:
                fields = ",".join(ev.get("fields") or []) or "?"
                segments.append({
                    "t0": ts, "t1": ts, "dur_s": 0.0, "kind": "drift",
                    "label": "CANARY DRIFT",
                    "detail": (f"coord {ev.get('coord', '?')} fields "
                               f"{fields} (daemon-wide)")[:140]})

    segments.sort(key=lambda s: (s["t0"], s["t1"]))
    if not segments:
        warnings.append(f"no spans or journal rows mention request "
                        f"{request_id!r} — wrong events file, or the run "
                        f"was not obs-armed")
    return {"request": request_id, "segments": segments,
            "warnings": warnings}


def _merge_blackbox(blackbox: str, request_id: str, skeleton: List[Dict],
                    others: List[Dict], marks: List[Dict],
                    warnings: List[str]) -> None:
    """Fold a flight dump's rows into the live pools (span rows, deduped
    against anything the events file already holds) plus zero-width
    black-box marks (admission decisions, request lifecycle, crash and
    fault bookkeeping that mention this request)."""
    from maskclustering_tpu_torch.obs import flight as _flight

    path = _flight.resolve_dump(blackbox)
    if path is None:
        warnings.append(f"no flight dump at {blackbox}")
        return
    _meta, rows = _flight.read_dump(path)
    seen = set()
    for ev in skeleton + others:
        s0, s1 = _span_window(ev)
        seen.add((ev.get("name"), round(s1, 3),
                  round(float(ev.get("dur_s", 0.0)), 5)))
    merged = 0
    for ev in rows:
        kind = ev.get("kind")
        if kind == "span":
            name = ev.get("name")
            if not isinstance(name, str):
                continue
            s0, s1 = _span_window(ev)
            key = (name, round(s1, 3),
                   round(float(ev.get("dur_s", 0.0)), 5))
            if key in seen:
                continue
            seen.add(key)
            attrs = ev.get("attrs") or {}
            if name in _SKELETON:
                if attrs.get("request") == request_id:
                    skeleton.append(ev)
                    merged += 1
            else:
                others.append(ev)
                merged += 1
            continue
        if ev.get("request") != request_id:
            continue
        ts = float(ev.get("ts", 0.0))
        detail = " ".join(
            f"{k}={v}" for k, v in ev.items()
            if k not in ("kind", "ts", "seq", "v", "pid", "request"))
        label = {
            _flight.KIND_ADMIT: f"blackbox {ev.get('event', 'admission')}",
            _flight.KIND_REQUEST: f"blackbox {ev.get('event', 'request')}"
                                  f" (pid {ev.get('pid', '?')})",
            _flight.KIND_CRASH: "blackbox WORKER CRASH",
            _flight.KIND_FAULT: "blackbox fault",
        }.get(kind)
        if label is None:
            continue
        marks.append({"t0": ts, "t1": ts, "dur_s": 0.0, "kind": "blackbox",
                      "label": label, "detail": detail[:140]})
        merged += 1
    if not merged:
        warnings.append(f"flight dump {path} held no new events for "
                        f"{request_id!r}")


def _children(others: List[Dict], t0: float, t1: float,
              eps: float = 0.01) -> List[Dict]:
    """Stage spans whose window sits inside [t0, t1] (time containment:
    request ids do not propagate into the pipeline's own spans).

    eps is tight and the span must START inside the window: on a warm
    daemon back-to-back requests sit milliseconds apart, and a loose
    tolerance would attribute a neighbor request's boundary spans here.
    """
    out = []
    for ev in others:
        name = ev.get("name")
        if name in _CONTAINERS or name == "serve.materialize":
            continue
        s0, s1 = _span_window(ev)
        if s0 >= t0 - eps and s1 <= t1 + eps and s0 < t1:
            out.append({"t0": s0, "t1": s1,
                        "dur_s": round(s1 - s0, 4),
                        "kind": "stage", "label": name,
                        "sync_s": float(ev.get("sync_s", 0.0))})
    out.sort(key=lambda s: (s["t0"], s["t1"]))
    return out


def _journal_rows(request_id: str, journal_dir: Optional[str],
                  warnings: List[str]) -> List[Dict]:
    if not journal_dir:
        return []
    path = os.path.join(journal_dir, f"{request_id}.jsonl")
    if not os.path.exists(path):
        warnings.append(f"no journal at {path}")
        return []
    from maskclustering_tpu_torch.utils import faults

    out = []
    for row in faults.read_journal(path, request=request_id):
        ts = float(row.get("ts", 0.0))
        event = row.get("event")
        if event == "attempt":
            out.append({"t0": ts, "t1": ts, "dur_s": 0.0,
                        "kind": "journal",
                        "label": f"attempt {row.get('attempt')}",
                        "detail": f"rung {row.get('rung', 0)} (journal)"})
        elif event == "outcome":
            status = row.get("status", "?")
            detail = f"attempt {row.get('attempt')} (journal)"
            if row.get("error"):
                detail += f" — {row['error'][:100]}"
            label = ("INTERRUPTED (worker died)" if status == "interrupted"
                     else f"outcome {status}")
            out.append({"t0": ts, "t1": ts, "dur_s": 0.0,
                        "kind": "journal", "label": label, "detail": detail})
    return out


def render_trace(trace: Dict) -> str:
    segments = trace["segments"]
    out = [f"== request trace: {trace['request']} =="]
    for w in trace.get("warnings", ()):
        out.append(f"WARNING: {w}")
    if not segments:
        return "\n".join(out)
    origin = segments[0]["t0"]
    total = max(s["t1"] for s in segments) - origin
    out.append(f"origin t0={origin:.3f} | end-to-end "
               f"{total:.3f}s | {len(segments)} segment(s)")
    for seg in segments:
        rel = seg["t0"] - origin
        line = (f"  +{rel:8.3f}s  {seg['dur_s']:8.3f}s  "
                f"{seg['label']:<26} {seg.get('detail', '')}")
        out.append(line.rstrip())
        for ch in seg.get("children", ()):
            rel_c = ch["t0"] - origin
            sync = f" (device {ch['sync_s']:.3f}s)" if ch.get("sync_s") else ""
            out.append(f"      +{rel_c:8.3f}s  {ch['dur_s']:8.3f}s  "
                       f"· {ch['label']}{sync}")
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m maskclustering_tpu_torch.obs.trace",
        description="assemble one serving request's causal timeline from "
                    "obs events + per-request journals")
    p.add_argument("request_id", help="daemon-assigned id (r-000001)")
    p.add_argument("--events", required=True,
                   help="obs events JSONL the daemon wrote (--obs_events)")
    p.add_argument("--journal", default=None, metavar="DIR",
                   help="per-request journal directory (the daemon's "
                        "--journal-dir)")
    p.add_argument("--blackbox", default=None, metavar="DUMP",
                   help="flight-recorder dump (file or directory; "
                        "obs/flight.py) to merge into the timeline — "
                        "crash postmortems included")
    p.add_argument("--json", action="store_true",
                   help="emit the machine-readable trace document")
    args = p.parse_args(argv)
    try:
        trace = assemble_trace(args.request_id, args.events,
                               journal_dir=args.journal,
                               blackbox=args.blackbox)
    except OSError as e:
        print(f"obs.trace: cannot read {args.events}: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(trace, sort_keys=True))
    else:
        print(render_trace(trace))
    return 0 if trace["segments"] else 1


if __name__ == "__main__":
    sys.exit(main())
