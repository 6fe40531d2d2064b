"""Concurrency family, dynamic half: the opt-in instrumented lock shim.

Counterpart of ``maskclustering_tpu/analysis/lock_sanitizer.py``. The
static analyzer (``analysis/concurrency.py``) proves the lock-order graph
it can SEE is acyclic; it cannot see orders taken through first-class
callables or config-dependent paths. This shim records what actually
happens: every acquisition of a named lock is logged against the acquiring
thread's currently-held named locks, producing the OBSERVED order graph,
plus hold-time accounting (a hold longer than ``MCT_LOCK_HOLD_WARN_S`` is
recorded as a long hold). The cross-check ``check_embeds`` — every
observed edge must embed in the static graph — closes the loop.

Creation seam: every lock of the port is created through
``mct_lock(name)``, under the JAX package's name where a counterpart
exists (``faults._PLAN_LOCK``, ``obs.metrics.Registry._lock``,
``serve.WorkerPool._lock``, ...) and a name of the same form where none
does (``ops.cuda._LOAD_LOCK``, ``serve.worker_main.out_lock``), so both
packages' graphs speak one vocabulary. Off (the default), ``mct_lock``
returns a RAW ``threading.Lock`` — zero overhead on the metrics hot path.
Armed (``MCT_LOCK_SANITIZER=1`` before import, or ``arm(True)`` +
``instrument_known_locks()`` for the process-global locks that already
exist), acquire/release cost a few dict operations each — a drill knob,
never a production default.

Stdlib-only at module scope (``utils/faults.py`` and ``obs/metrics.py``
import this; obs counters are emitted lazily).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

ENV_FLAG = "MCT_LOCK_SANITIZER"

# a hold crossing this many seconds is recorded as a "long hold" — the
# dynamic analogue of the static blocking-call-under-lock check (a lock
# held across device work or file IO shows up here even when the blocking
# call was invisible to the AST)
DEFAULT_LONG_HOLD_S = 0.05

_armed: Optional[bool] = None  # None -> the environment decides


def arm(on: Optional[bool]) -> None:
    """Explicitly enable/disable the sanitizer (``None`` defers to env).

    Arming affects locks created AFTER this call; for the process-global
    locks created at import time, follow with ``instrument_known_locks``.
    """
    global _armed
    _armed = on


def enabled() -> bool:
    if _armed is not None:
        return _armed
    return os.environ.get(ENV_FLAG, "").strip().lower() in ("1", "true",
                                                            "on", "yes")


def long_hold_threshold_s() -> float:
    try:
        return float(os.environ.get("MCT_LOCK_HOLD_WARN_S",
                                    str(DEFAULT_LONG_HOLD_S)))
    except ValueError:
        return DEFAULT_LONG_HOLD_S


# ---------------------------------------------------------------------------
# observed state (process-global, guarded by a PLAIN lock — the sanitizer
# must never instrument itself)
# ---------------------------------------------------------------------------


class _State:
    """Acquisition orders + hold times observed since the last reset."""

    def __init__(self):
        self.lock = threading.Lock()  # plain on purpose
        # read once per reset(), not per release — an environ lookup +
        # float parse on every lock release would tax the armed hot path
        self.long_hold_s = long_hold_threshold_s()
        self.acquisitions: Dict[str, int] = {}
        self.edges: Dict[Tuple[str, str], int] = {}  # (held, acquired) -> n
        self.max_hold_s: Dict[str, float] = {}
        self.long_holds: List[Dict] = []  # {"name", "seconds", "thread"}
        self._tls = threading.local()  # per-thread held stack

    def _held(self) -> List[Tuple[str, float]]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def on_acquire(self, name: str) -> None:
        held = self._held()
        with self.lock:
            self.acquisitions[name] = self.acquisitions.get(name, 0) + 1
            for outer, _ in held:
                if outer != name:
                    edge = (outer, name)
                    self.edges[edge] = self.edges.get(edge, 0) + 1
        held.append((name, time.monotonic()))

    def on_release(self, name: str) -> None:
        held = self._held()
        t0 = None
        for i in range(len(held) - 1, -1, -1):  # tolerate non-LIFO release
            if held[i][0] == name:
                t0 = held.pop(i)[1]
                break
        if t0 is None:
            return
        dt = time.monotonic() - t0
        with self.lock:
            if dt > self.max_hold_s.get(name, 0.0):
                self.max_hold_s[name] = dt
            if dt >= self.long_hold_s:
                self.long_holds.append({
                    "name": name, "seconds": round(dt, 4),
                    "thread": threading.current_thread().name})


_STATE = _State()


def reset() -> None:
    """Drop everything observed so far (test isolation)."""
    global _STATE
    _STATE = _State()


def observed_edges() -> Set[Tuple[str, str]]:
    """(held, then-acquired) name pairs seen since the last reset."""
    with _STATE.lock:
        return set(_STATE.edges)


def report() -> Dict:
    """JSON-able digest of everything observed since the last reset."""
    with _STATE.lock:
        return {
            "acquisitions": dict(_STATE.acquisitions),
            "order_edges": {f"{a} -> {b}": n
                            for (a, b), n in sorted(_STATE.edges.items())},
            "max_hold_s": {k: round(v, 4)
                           for k, v in sorted(_STATE.max_hold_s.items())},
            "long_holds": list(_STATE.long_holds),
        }


def emit_counters() -> None:
    """Book the digest on the obs metrics registry (lazy import): the run
    report's Faults section then renders the sanitizer line for free."""
    try:
        from maskclustering_tpu_torch.obs import metrics
    except Exception:  # noqa: BLE001 — accounting never faults the shim
        return
    with _STATE.lock:
        acq = sum(_STATE.acquisitions.values())
        edges = len(_STATE.edges)
        holds = len(_STATE.long_holds)
    metrics.count("locks.acquisitions", float(acq))
    metrics.count("locks.order_edges", float(edges))
    metrics.count("locks.long_holds", float(holds))


# ---------------------------------------------------------------------------
# the lock shim
# ---------------------------------------------------------------------------


class InstrumentedLock:
    """``threading.Lock`` wrapper that records order + hold time by name."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str, lock: Optional[threading.Lock] = None):
        self.name = name
        self._lock = lock if lock is not None else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _STATE.on_acquire(self.name)
        return ok

    def release(self) -> None:
        _STATE.on_release(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


def mct_lock(name: str):
    """The named-lock creation seam: raw ``threading.Lock`` when the
    sanitizer is off (zero overhead), ``InstrumentedLock`` when armed.

    ``name`` is the lock's identity in BOTH graphs: the static analyzer
    reads this literal out of the call site, the shim stamps it on every
    observation — the embed cross-check compares one vocabulary.
    """
    if enabled():
        return InstrumentedLock(name)
    return threading.Lock()


def instrument_known_locks():
    """Swap the import-time process-global locks for instrumented ones.

    ``mct_lock`` instruments at CREATION time; the plan lock and the
    metrics registry's lock already exist by the time a test (or
    ``run.py --lock-sanitizer``) arms the sanitizer mid-process, so they
    are re-wrapped in place here. Per-instance locks (EventSink, Heartbeat,
    fault entries) are created after arming and need no swap. The other
    import-time locks (telemetry's aggregate lock, the kernel build lock,
    the launch log's and the bucket census's) stay raw: no nested
    acquisition takes them. Returns an
    undo callable that restores the original lock objects.

    Swapping while another thread HOLDS one of these locks would lose the
    release pairing — callers arm at a quiescent point (process start, a
    test fixture's setup) by contract.
    """
    from maskclustering_tpu_torch.obs import metrics
    from maskclustering_tpu_torch.utils import faults

    originals = [
        (faults, "_PLAN_LOCK", faults._PLAN_LOCK),
        (metrics.registry(), "_lock", metrics.registry()._lock),
    ]
    # wrap the LIVE lock objects (the `lock=` seam): a straggler thread
    # still holding or blocked on the original keeps synchronizing on the
    # same primitive as post-swap acquirers — exclusion survives the swap
    faults._PLAN_LOCK = InstrumentedLock(
        "faults._PLAN_LOCK", faults._PLAN_LOCK)
    metrics.registry()._lock = InstrumentedLock(
        "obs.metrics.Registry._lock", metrics.registry()._lock)

    def undo():
        for obj, attr, lock in originals:
            setattr(obj, attr, lock)

    return undo


# ---------------------------------------------------------------------------
# the cross-check
# ---------------------------------------------------------------------------


def check_embeds(observed: Set[Tuple[str, str]],
                 static_edges: Set[Tuple[str, str]],
                 static_nodes: Set[str]) -> List[str]:
    """Violations of "the observed order graph embeds in the static one".

    An observed edge between two statically-known locks that the static
    graph does not carry is exactly the case the sanitizer exists for: an
    acquisition order taken through a path the AST could not follow. Edges
    touching locks the static side never saw (ad-hoc test locks) are out
    of scope — the embed check compares the shared vocabulary only.
    """
    out: List[str] = []
    for a, b in sorted(observed):
        if a not in static_nodes or b not in static_nodes:
            continue
        if (a, b) not in static_edges:
            out.append(
                f"observed lock order {a} -> {b} is absent from the static "
                f"lock-order graph — an order path the AST cannot see; "
                f"model it (or refactor the nesting away)")
    return out
