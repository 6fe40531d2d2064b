"""Admission write-ahead log: the daemon's crash-safe request ledger (the port's
copy of ``maskclustering_tpu/serve/wal.py``).

A SIGKILL'd daemon loses its admission queue — every acked-but-unanswered
request simply vanishes, and the client's only recourse is to resubmit
blind (risking a double run of work that was already in flight). This
module makes admission durable with the same torn-line-tolerant JSONL
machinery as the run journal and the perf ledger (obs/events.py): one
append-only WAL per daemon, one flushed line per state transition.

Row kinds (all ride the events envelope, ``v``/``ts``/``pid``):

- ``wal.admit``    — a request passed admission; carries the validated
  client doc verbatim so a restarted daemon can rebuild the work item.
- ``wal.dispatch`` — the request reached a worker (first ``running``
  status observed). Advisory: replay treats dispatched-but-unanswered
  exactly like queued (the worker died with the daemon).
- ``wal.terminal`` — the one terminal event (result or typed reject)
  left the daemon. A request with a terminal row is settled; when the
  admit carried an idempotency key, the terminal event is retained so a
  reconnect-and-resubmit can be answered from cache without re-running.

Recovery (``read_wal``) folds the rows into: the ordered list of
journaled-but-unanswered requests to replay into the queue, the
idempotency-key -> cached-terminal map, and the highest daemon-assigned
request id (so the restarted daemon's id counter never collides with
journal files left by its predecessor). ``compact`` rewrites the WAL to
exactly that recovered state at startup, bounding growth across restarts
without ever truncating mid-run.

Same discipline as every durable plane here: append-only, one flush per
line, never the failure source (EventSink disables itself on write
errors), torn final lines skipped-with-a-count by the reader.
"""

from __future__ import annotations

import logging
import os
import re
import time
from typing import Dict, List, Optional, Tuple

from maskclustering_tpu_torch.obs.events import (EventSink, ReadStats,
                                                 SCHEMA_VERSION, iter_jsonl_rows)

log = logging.getLogger("maskclustering_tpu_torch")

KIND_ADMIT = "wal.admit"
KIND_DISPATCH = "wal.dispatch"
KIND_TERMINAL = "wal.terminal"

# the one WAL file a daemon owns, living beside the per-request journals
# (journal pruning skips it by name — see prune_journal_dir)
WAL_FILENAME = "admission.wal.jsonl"

_ID_RE = re.compile(r"^r-(\d+)$")


class AdmissionWal:
    """Append-only admission WAL writer (thread-safe via EventSink)."""

    def __init__(self, path: str):
        self.path = path
        self._sink = EventSink(path)

    def admit(self, request_id: str, doc: Dict, *, idem: str = "") -> None:
        """Journal one admitted request: the validated client doc rides
        verbatim so replay can rebuild the exact work item."""
        row = {"request": request_id, "doc": doc}
        if idem:
            row["idem"] = idem
        self._sink.emit(KIND_ADMIT, row)

    def dispatch(self, request_id: str) -> None:
        self._sink.emit(KIND_DISPATCH, {"request": request_id})

    def terminal(self, request_id: str, event: Dict, *,
                 idem: str = "") -> None:
        """Journal the request's one terminal event (result or typed
        reject). With an idempotency key the event is retained for the
        dedupe cache; without one only the settlement matters."""
        row = {"request": request_id, "event": event}
        if idem:
            row["idem"] = idem
        self._sink.emit(KIND_TERMINAL, row)

    def close(self) -> None:
        self._sink.close()


class WalState:
    """What recovery extracted from a predecessor daemon's WAL."""

    __slots__ = ("pending", "answered", "max_id", "rows", "stats")

    def __init__(self):
        # journaled-but-unanswered, admission order: (request_id, doc, idem)
        self.pending: List[Tuple[str, Dict, str]] = []
        # idempotency key -> the cached terminal event (keyed admits only)
        self.answered: Dict[str, Dict] = {}
        self.max_id = 0  # highest daemon-assigned numeric request id seen
        self.rows = 0
        self.stats = ReadStats()


def read_wal(path: str) -> WalState:
    """Fold a WAL file into replayable state (missing file = empty state).

    Torn/unknown lines are skipped-with-a-count (``state.stats``), the
    shared tolerant-reader policy — a crash can tear at most the final
    line, and recovery must never be the thing that refuses to recover.
    """
    state = WalState()
    if not path or not os.path.exists(path):
        return state
    open_admits: Dict[str, Tuple[Dict, str]] = {}
    order: List[str] = []
    for row in iter_jsonl_rows(path, version=SCHEMA_VERSION,
                               stats=state.stats):
        state.rows += 1
        kind = row.get("kind")
        rid = row.get("request")
        if not isinstance(rid, str):
            continue
        m = _ID_RE.match(rid)
        if m:
            state.max_id = max(state.max_id, int(m.group(1)))
        if kind == KIND_ADMIT:
            doc = row.get("doc")
            if isinstance(doc, dict) and rid not in open_admits:
                open_admits[rid] = (doc, str(row.get("idem") or ""))
                order.append(rid)
        elif kind == KIND_TERMINAL:
            adm = open_admits.pop(rid, None)
            idem = str(row.get("idem") or (adm[1] if adm else ""))
            event = row.get("event")
            if idem and isinstance(event, dict):
                state.answered[idem] = event
        # wal.dispatch is advisory: a dispatched-but-unanswered request
        # replays exactly like a queued one (its worker died too)
    state.pending = [(rid,) + open_admits[rid] for rid in order
                     if rid in open_admits]
    return state


def compact(path: str, state: WalState) -> None:
    """Rewrite the WAL to exactly the recovered state (startup only).

    Atomic via tmp + rename so a crash mid-compaction leaves the old WAL
    intact; failure is logged and ignored — compaction is an optimization,
    never a correctness step (replay already happened from the old file).
    """
    # one writer: the daemon that owns the journal directory compacts its
    # WAL once, at its start, before its acceptor admits anything
    tmp = path + ".tmp"
    try:
        sink = EventSink(tmp, truncate=True)
        for rid, doc, idem in state.pending:
            row = {"request": rid, "doc": doc}
            if idem:
                row["idem"] = idem
            sink.emit(KIND_ADMIT, row)
        for idem, event in sorted(state.answered.items()):
            sink.emit(KIND_TERMINAL,
                      {"request": str(event.get("id") or ""),
                       "event": event, "idem": idem})
        sink.close()
        os.replace(tmp, path)
    except Exception:  # noqa: BLE001 — compaction must never sink recovery
        log.exception("WAL compaction failed; keeping the old file (%s)",
                      path)
        try:
            os.remove(tmp)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# retention: journal_dir/ and stream_state/ grow one file per request /
# per live stream — prune the settled tail so a long-lived daemon's disk
# footprint is bounded (config-validated knobs, counted as
# serve.journals_pruned)
# ---------------------------------------------------------------------------

# files younger than this are never pruned regardless of the keep-N
# policy: an in-flight request's journal and a live stream's snapshot are
# both "recent" by construction, and retention must never eat live state
MIN_PRUNE_AGE_S = 60.0


def prune_dir(dirpath: str, *, keep: int, max_age_s: float,
              suffixes: Tuple[str, ...],
              skip: Tuple[str, ...] = (WAL_FILENAME,),
              now: Optional[float] = None) -> int:
    """Delete the oldest matching files beyond ``keep`` and anything older
    than ``max_age_s`` (0 disables either policy). Returns files removed.

    Never raises: a scan or unlink error logs once and the pruner moves
    on — retention is housekeeping, not a failure source.
    """
    if not dirpath or not os.path.isdir(dirpath) \
            or (keep <= 0 and max_age_s <= 0):
        return 0
    now = time.time() if now is None else now
    entries: List[Tuple[float, str]] = []
    try:
        for name in os.listdir(dirpath):
            if name in skip or not name.endswith(suffixes):
                continue
            full = os.path.join(dirpath, name)
            try:
                mtime = os.path.getmtime(full)
            except OSError:
                continue
            if now - mtime < MIN_PRUNE_AGE_S:
                continue  # never prune live-looking state
            entries.append((mtime, full))
    except OSError:
        log.exception("journal retention scan failed (%s)", dirpath)
        return 0
    entries.sort()  # oldest first
    doomed = []
    if max_age_s > 0:
        doomed.extend(p for m, p in entries if now - m > max_age_s)
    if keep > 0 and len(entries) > keep:
        doomed.extend(p for _, p in entries[:len(entries) - keep])
    removed = 0
    for path in dict.fromkeys(doomed):  # de-dup, preserve oldest-first order
        try:
            os.remove(path)
            removed += 1
        except OSError:
            pass  # raced with a concurrent unlink / still open elsewhere
    return removed
