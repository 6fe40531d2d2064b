"""Always-on in-process flight recorder: the serving plane's black box.

Every process that executes scenes keeps a small bounded ring of the
last ~N observability events — finished spans, compile/retrace events,
fault-seam firings, admission decisions, heartbeat ages, queue
transitions, crash bookkeeping — in memory, always, whether or not an
events file is armed. The ring costs one deque append under a named
lock per event; nothing is written anywhere until something goes wrong.

When something DOES go wrong the ring is dumped crash-safely (atomic
tmp+rename, schema-versioned JSONL readable by the shared torn-line
reader) so the postmortem survives the process that caused it:

- **watchdog fire**: ``utils/faults.py`` dumps at the
  ``DeviceStallError`` raise sites (``call_with_deadline`` /
  ``Heartbeat.check``) — the wedge evidence is on disk before anyone
  decides what to do about the wedge;
- **capacity error**: the daemon dumps on the first ``QueueFullReject``
  per process — what the admission plane looked like when backpressure
  began;
- **SIGTERM**: dumped on the cooperative drain path (the handler itself
  is flag-only async-signal-safe and must not do IO — CONC.SIGNAL);
- **heartbeat-silence SIGKILL** — the hard case: the child that wedged
  cannot dump anything, so the worker supervisor dumps its OWN ring plus
  the child's last relayed flight delta (shipped on the heartbeat
  cadence, not the result-driven telemetry relay) — the victim
  request's child-side spans the live relay never shipped survive.

Dumps land in ``$MCT_FLIGHT_DIR`` (or an explicitly armed directory);
with neither set, ``dump()`` is a counted no-op — the recorder is never
the failure source. ``python -m maskclustering_tpu_torch.obs.flight DUMP``
renders the postmortem; ``obs.trace REQUEST_ID --blackbox DUMP`` merges
ring events into the causal timeline.

Span ring records use the event sink's span shape (``kind`` "span",
``name``/``dur_s``/``sync_s``/``attrs``) so the trace merger treats
them exactly like live events; everything else uses ``flight.*`` kinds
that can never collide with the sink vocabulary.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from collections import deque
import threading
from typing import Dict, List, Optional, Tuple

from maskclustering_tpu_torch.analysis.lock_sanitizer import mct_lock

log = logging.getLogger("maskclustering_tpu_torch")

FLIGHT_SCHEMA_VERSION = 1
DEFAULT_CAPACITY = 256
ENV_DIR = "MCT_FLIGHT_DIR"

# ring/dump event kinds (plus "span", shared with the event sink)
KIND_META = "flight_meta"          # dump header line
KIND_ADMIT = "flight.admission"    # admit / reject / dequeue / requeue / drain
KIND_FAULT = "flight.fault"        # fault-seam firing / watchdog expiry
KIND_CRASH = "flight.crash"        # worker death bookkeeping (parent side)
KIND_HB = "flight.heartbeat"       # heartbeat age observations
KIND_COMPILE = "flight.compile"    # compile/retrace events
KIND_REQUEST = "flight.request"    # request lifecycle marks (child side)
KIND_SIGNAL = "flight.signal"      # stop/drain transitions
KIND_CHILD_TELEM = "flight.child_telem"  # last relayed child metrics delta
# supervisor<->worker pipe line carrying a child ring delta (NOT a ring
# event kind): {"kind": KIND_DELTA, "rows": [...], "pid": ...} shipped by
# worker_main's heartbeat thread, retained parent-side for the SIGKILL dump
KIND_DELTA = "flight_delta"


class FlightRecorder:
    """Bounded ring + crash-safe dumper; one instance per process.

    ``record()`` is the hot path: build the event dict, append under the
    named lock, nothing else — no IO, no allocation beyond the dict, no
    calls into other locked subsystems while holding the lock. ``dump()``
    snapshots the ring under the lock and writes OUTSIDE it.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = mct_lock("obs.FlightRecorder._lock")
        self._ring: deque = deque(maxlen=max(int(capacity), 8))
        self._seq = 0          # total events ever recorded (ring evicts)
        self._dumps = 0
        self._dir: Optional[str] = None
        self._dump_failed = False  # log the first write failure only

    # -- arming ------------------------------------------------------------

    def arm(self, dir_path: Optional[str]) -> None:
        with self._lock:
            self._dir = dir_path

    def armed_dir(self) -> Optional[str]:
        """The dump directory: explicit arm wins, else $MCT_FLIGHT_DIR."""
        with self._lock:
            if self._dir:
                return self._dir
        return os.environ.get(ENV_DIR) or None

    # -- recording ---------------------------------------------------------

    def record(self, kind: str, **fields) -> None:
        ev: Dict = {"kind": kind, "ts": time.time()}
        ev.update(fields)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)

    def record_span(self, name: str, dur_s: float, sync_s: float,
                    attrs: Optional[Dict]) -> None:
        """A finished span, in the event sink's span shape (obs/events.py)
        so dump rows merge into ``obs.trace`` untranslated."""
        ev: Dict = {"kind": "span", "ts": time.time(),
                    "name": name, "dur_s": round(float(dur_s), 6),
                    "sync_s": round(float(sync_s), 6)}
        if attrs:
            ev["attrs"] = dict(attrs)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)

    # -- reading -----------------------------------------------------------

    def snapshot(self, since_seq: int = 0) -> Tuple[List[Dict], int]:
        """(events newer than ``since_seq``, newest seq) — the delta shape
        the child heartbeat ships to the supervisor."""
        with self._lock:
            evs = [dict(e) for e in self._ring if e.get("seq", 0) > since_seq]
            return evs, self._seq

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- dumping -----------------------------------------------------------

    def dump(self, reason: str, *, path: Optional[str] = None,
             extra_rows: Optional[List[Dict]] = None) -> Optional[str]:
        """Write the ring (plus ``extra_rows``) crash-safely; returns the
        dump path, or None when unarmed or on write failure — the
        recorder must never become the failure source of the failure it
        is recording."""
        events, _seq = self.snapshot()
        target = path
        if target is None:
            d = self.armed_dir()
            if not d:
                return None
            with self._lock:
                self._dumps += 1
                n = self._dumps
            target = os.path.join(
                d, f"flight-{os.getpid()}-{n:02d}-{reason}.jsonl")
        pid = os.getpid()
        header = {"v": FLIGHT_SCHEMA_VERSION, "kind": KIND_META,
                  "ts": time.time(), "pid": pid, "reason": reason,
                  "events": len(events) + len(extra_rows or ())}
        tmp = target + ".tmp"
        try:
            d = os.path.dirname(target)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(json.dumps(header) + "\n")
                for ev in events:
                    row = {"v": FLIGHT_SCHEMA_VERSION, "pid": pid}
                    row.update(ev)
                    f.write(json.dumps(row) + "\n")
                for ev in extra_rows or ():
                    row = {"v": FLIGHT_SCHEMA_VERSION}
                    row.update(ev)
                    f.write(json.dumps(row) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, target)  # atomic: readers see all or nothing
        except Exception:  # noqa: BLE001 — postmortems must not cascade
            if not self._dump_failed:
                self._dump_failed = True
                log.exception("flight dump failed; postmortem dropped (%s)",
                              target)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        log.warning("flight recorder dumped %d event(s) [%s] -> %s",
                    header["events"], reason, target)
        return target


_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    return _RECORDER


def record(kind: str, **fields) -> None:
    _RECORDER.record(kind, **fields)


def record_span(name: str, dur_s: float, sync_s: float,
                attrs: Optional[Dict]) -> None:
    _RECORDER.record_span(name, dur_s, sync_s, attrs)


def arm(dir_path: Optional[str]) -> None:
    _RECORDER.arm(dir_path)


def armed_dir() -> Optional[str]:
    return _RECORDER.armed_dir()


def dump(reason: str, *, path: Optional[str] = None,
         extra_rows: Optional[List[Dict]] = None) -> Optional[str]:
    return _RECORDER.dump(reason, path=path, extra_rows=extra_rows)


# ---------------------------------------------------------------------------
# reading + rendering (the postmortem CLI)
# ---------------------------------------------------------------------------


def resolve_dump(path: str) -> Optional[str]:
    """A dump file, or — given a directory — its newest flight-*.jsonl."""
    if os.path.isdir(path):
        cands = sorted(
            (os.path.join(path, n) for n in os.listdir(path)
             if n.startswith("flight-") and n.endswith(".jsonl")),
            key=lambda p: os.path.getmtime(p))
        return cands[-1] if cands else None
    return path if os.path.exists(path) else None


def read_dump(path: str) -> Tuple[Dict, List[Dict]]:
    """(header meta, event rows) — shared torn-line read policy."""
    from maskclustering_tpu_torch.obs.events import iter_jsonl_rows

    meta: Dict = {}
    rows: List[Dict] = []
    for row in iter_jsonl_rows(path, version=FLIGHT_SCHEMA_VERSION):
        if row.get("kind") == KIND_META and not meta:
            meta = row
        else:
            rows.append(row)
    return meta, rows


def _age(ts, ref) -> str:
    try:
        return f"{max(ref - float(ts), 0.0):8.3f}s"
    except (TypeError, ValueError):
        return "       ?"


def render_dump(meta: Dict, rows: List[Dict],
                request: Optional[str] = None) -> str:
    """The human postmortem: header, then the ring oldest-first with ages
    relative to the dump instant; ``request`` filters to one request's
    rows (span attrs / lifecycle marks / crash bookkeeping)."""
    ref = float(meta.get("ts") or (rows[-1].get("ts") if rows else 0.0) or 0.0)
    when = time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime(ref)) if ref else "?"
    out = [f"== flight postmortem: reason={meta.get('reason', '?')} "
           f"pid={meta.get('pid', '?')} at {when} UTC "
           f"({len(rows)} event(s)) =="]
    shown = 0
    for ev in rows:
        kind = ev.get("kind", "?")
        rid = None
        if kind == "span":
            attrs = ev.get("attrs") or {}
            rid = attrs.get("request")
            body = (f"span {ev.get('name')} dur {ev.get('dur_s')}s"
                    + (f" sync {ev['sync_s']}s" if ev.get("sync_s") else "")
                    + (f" [{' '.join(f'{k}={v}' for k, v in attrs.items())}]"
                       if attrs else ""))
        elif kind == KIND_CHILD_TELEM:
            body = (f"child telem delta (pid {ev.get('pid', '?')}): "
                    f"{len((ev.get('doc') or {}).get('counters') or {})} "
                    f"counter(s), "
                    f"{len((ev.get('doc') or {}).get('spans') or [])} span(s)")
        else:
            rid = ev.get("request")
            body = kind.replace("flight.", "") + " " + " ".join(
                f"{k}={v}" for k, v in ev.items()
                if k not in ("kind", "ts", "seq", "v", "pid"))
        if request is not None and rid != request:
            continue
        shown += 1
        src = f"pid {ev.get('pid', '?')}"
        out.append(f"-{_age(ev.get('ts'), ref)}  [{src}] {body.rstrip()}")
    if request is not None:
        out.append(f"({shown} event(s) for request {request})")
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m maskclustering_tpu_torch.obs.flight",
        description="render a flight-recorder postmortem dump")
    p.add_argument("dump", help="dump file, or a directory holding "
                                "flight-*.jsonl (newest wins)")
    p.add_argument("--request", default=None,
                   help="filter to one request id's events")
    p.add_argument("--json", action="store_true",
                   help="emit {meta, events} instead of the rendering")
    args = p.parse_args(argv)
    path = resolve_dump(args.dump)
    if path is None:
        print(f"flight: no dump at {args.dump}", file=sys.stderr)
        return 1
    meta, rows = read_dump(path)
    if args.json:
        print(json.dumps({"meta": meta, "events": rows}, indent=2))
    else:
        print(render_dump(meta, rows, request=args.request))
    return 0 if rows else 1


if __name__ == "__main__":
    sys.exit(main())
