"""JSONL event sink: one line per span / metrics flush, append-only (the
port's copy of ``maskclustering_tpu/obs/events.py``: the same envelope, so
each package reads the other's files).

The sink is the durable half of the obs subsystem: every span close and
every metrics flush becomes one self-describing JSON line, so a run that
dies mid-scene (the chip-outage mode that ate two rounds of captures)
still leaves every completed span on disk. Rules:

- **schema-versioned**: every line carries ``"v": SCHEMA_VERSION``; the
  reader skips lines from versions it does not know instead of crashing
  a report on a mixed-version file.
- **append-only + crash-safe**: the file is opened in append mode and
  flushed per line; a SIGKILL can truncate at most the line in flight,
  and ``read_events`` tolerates a torn final line.
- **never the failure source**: a sink write error disables the sink and
  logs once — observability must not sink the run it observes.
"""

from __future__ import annotations

import io
import json
import logging
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

log = logging.getLogger("maskclustering_tpu_torch")

SCHEMA_VERSION = 1

# event kinds the schema defines (readers skip unknown kinds, same policy
# as unknown versions, so the schema can grow without breaking old reports)
KIND_META = "meta"
KIND_SPAN = "span"
KIND_METRICS = "metrics"
KIND_COST = "cost"  # compile-time cost observatory rows (obs/cost.py)
KIND_ANALYSIS = "analysis"  # the JAX package's static-analysis findings
KIND_TELEMETRY = "telemetry"  # windowed serving snapshots (obs/telemetry.py)
KIND_DRIFT = "canary.drift"  # mct-sentinel golden-probe drift (obs/canary.py)


class ReadStats:
    """Skip accounting for tolerant JSONL readers.

    A crash can tear the final line and a newer writer can emit versions
    this reader does not know; both are skipped — but silently losing lines
    makes a report lie by omission, so readers count what they drop and the
    CLIs surface the counts as a warning.
    """

    __slots__ = ("torn", "unknown_version", "total")

    def __init__(self):
        self.torn = 0
        self.unknown_version = 0
        self.total = 0

    @property
    def skipped(self) -> int:
        return self.torn + self.unknown_version

    def describe(self) -> str:
        return (f"{self.torn} torn/corrupt line(s), "
                f"{self.unknown_version} unknown-schema line(s)")


class EventSink:
    """Append-only JSONL writer, one flush per line, thread-safe.

    ``truncate=True`` starts the file fresh (single-owner paths that are
    re-derived per run); the sink itself never truncates mid-run.
    """

    def __init__(self, path: str, *, truncate: bool = False):
        self.path = path
        self._lock = threading.Lock()
        self._dead = False
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f: Optional[io.TextIOBase] = open(
            path, "w" if truncate else "a", encoding="utf-8")

    def emit(self, kind: str, payload: Dict) -> None:
        """Write one event line; payload keys merge into the envelope."""
        if self._dead or self._f is None:
            return
        # pid in the envelope: one file can hold several processes' events
        # (bench worker attempts + supervisor; spawn-pool workers), and the
        # reader must aggregate monotonic counters per process, not across
        line = {"v": SCHEMA_VERSION, "kind": kind, "ts": time.time(),
                "pid": os.getpid()}
        line.update(payload)
        try:
            with self._lock:
                self._f.write(json.dumps(line, default=_json_default) + "\n")
                self._f.flush()
        except Exception:  # noqa: BLE001 — the sink must never sink the run
            self._dead = True
            log.exception("obs event sink failed; disabling (%s)", self.path)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except Exception:  # noqa: BLE001
                    pass
                self._f = None


def _json_default(obj):
    """Last-resort JSON coercion for numpy scalars and odd attr values."""
    for attr in ("item",):  # numpy scalars / 0-d arrays
        if hasattr(obj, attr):
            try:
                return obj.item()
            except Exception:  # noqa: BLE001
                break
    return repr(obj)


def iter_jsonl_rows(path: str, *, version: int,
                    stats: Optional[ReadStats] = None) -> Iterator[Dict]:
    """Tolerant schema-versioned JSONL reader (events AND the perf ledger).

    One copy of the crash-tolerance policy: torn/corrupt lines (a crash can
    truncate the final line) and unknown ``v`` values are skipped — counted
    into ``stats`` when given, so CLIs can warn instead of losing lines
    silently.
    """
    with open(path, "r", encoding="utf-8") as f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            if stats is not None:
                stats.total += 1
            try:
                row = json.loads(raw)
            except ValueError:
                if stats is not None:
                    stats.torn += 1
                continue  # torn line (crash mid-write)
            if not isinstance(row, dict) or row.get("v") != version:
                if stats is not None:
                    stats.unknown_version += 1
                continue
            yield row


def read_events(path: str, *, kinds: Optional[List[str]] = None,
                stats: Optional[ReadStats] = None) -> Iterator[Dict]:
    """Yield parsed events from a JSONL file.

    Skips: torn/corrupt lines, unknown schema versions (see
    ``iter_jsonl_rows``), and — when ``kinds`` is given — other kinds.
    """
    for ev in iter_jsonl_rows(path, version=SCHEMA_VERSION, stats=stats):
        if kinds is not None and ev.get("kind") not in kinds:
            continue
        yield ev
