"""Fault-tolerance primitives of the batch driver (the part of
``maskclustering_tpu/utils/faults.py`` it uses: ``:115-246, 308-424,
705-917``).

The scene is the fault boundary: a transient device fault should cost one
scene retry, not the run.

- **watchdog** (``call_with_deadline``): a bounded wait around a scene's
  load, device phase or host tail; on expiry a typed ``DeviceStallError``
  is raised in the caller and the wedged work is abandoned on its daemon
  thread (a hung native call can only be outwaited, not cancelled);
- **error classes** (``classify_error``): ``retryable``, ``device`` (also
  drives the degradation ladder) or ``terminal`` (a retry cannot help);
- **retry and degradation** (``RetryPolicy``, ``DegradationLadder``);
- **cooperative stop** on SIGTERM at scene boundaries;
- **crash-safe run journal** (``RunJournal``, ``read_journal``,
  ``replay_journal``, ``resume_done``): an append-only JSONL of scene
  attempt and outcome rows in the JAX package's envelope and format, so a
  rerun skips exactly the scenes that finished.

The port's ladder keeps only the rungs that change what the port does:
``sequential-executor`` and ``host-postprocess``. The JAX rungs
``single-chip`` (the port runs no mesh yet, ROADMAP A7) and
``donation-off`` (torch has no buffer donation) have no torch meaning. So
the rung numbers differ between the packages on the same scan: at the
default config a post-process capacity overflow heals on the port's rung
2 at attempt 3, on JAX's rung 3 at attempt 4, with equal artifacts and
digests. ``SceneStatus.degradation_rung``, the journal's ``rung`` rows and
the ``r`` field of ``digest_coord`` follow each package's own ladder.
Not here yet: ``FaultPlan`` and its drills (a ROADMAP item of their own),
and the metrics counters and flight-recorder marks (ROADMAP A9), which the
JAX module books at these sites.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Set

import torch

log = logging.getLogger("maskclustering_tpu_torch")


class DeviceStallError(RuntimeError):
    """A watchdog deadline expired: the guarded call never returned.

    Raised in the calling thread; the stalled work is abandoned on its
    daemon thread. Carries the seam, scene and budget for attribution.
    """

    def __init__(self, seam: str, scene: Optional[str], budget_s: float):
        self.seam = seam
        self.scene = scene
        self.budget_s = budget_s
        super().__init__(
            f"{seam} phase of scene {scene!r} did not finish within "
            f"{budget_s:.3g}s (device stalled or wedged)")


# a scene overflowing a device post-process capacity bucket
# (models/postprocess_device.py) heals on the ladder's host-postprocess
# rung, so it routes through the device class; matched by name so this
# module needs nothing of the models
_DEVICE_ERROR_NAMES = frozenset({"PostprocessCapacityError"})
_DEVICE_ERROR_TYPES = tuple(t for t in (getattr(torch.cuda, "OutOfMemoryError", None),
                                        getattr(torch, "AcceleratorError", None)) if t)
# a RuntimeError from the CUDA runtime names it ("CUDA error: ...",
# "CUDA out of memory", "cuBLAS", a failed kernel launch of ops/cuda)
_DEVICE_MESSAGES = ("CUDA error", "CUDA out of memory", "CUBLAS_STATUS", "cuDNN error",
                    "kernel launch failed")
# a retry cannot fix a programming/config error; fail fast and keep the
# retry budget for faults that can actually heal
_TERMINAL_TYPES = (ValueError, TypeError, KeyError, IndexError,
                   AttributeError, AssertionError, NotImplementedError,
                   ImportError)


def classify_error(exc: BaseException) -> str:
    """The error class stamped on SceneStatus and journal rows:
    ``retryable`` (transient by default: IO, unknown runtime errors),
    ``device`` (retryable and drives the degradation ladder: stalls, CUDA
    errors and out-of-memory, capacity overflows) or ``terminal`` (a retry
    cannot help: programming and configuration errors)."""
    if isinstance(exc, DeviceStallError) or isinstance(exc, _DEVICE_ERROR_TYPES):
        return "device"
    if isinstance(exc, MemoryError) or type(exc).__name__ in _DEVICE_ERROR_NAMES:
        return "device"
    if isinstance(exc, _TERMINAL_TYPES):
        return "terminal"
    if isinstance(exc, RuntimeError) and any(m in str(exc) for m in _DEVICE_MESSAGES):
        return "device"
    return "retryable"  # OSError and unknown runtime errors: worth one more try


def call_with_deadline(fn: Callable, budget_s: float, *, seam: str = "device",
                       scene: Optional[str] = None):
    """Run ``fn`` under a watchdog; ``DeviceStallError`` after ``budget_s``.

    ``budget_s <= 0`` (the default) calls inline. Armed, ``fn`` runs on a
    daemon thread and this thread waits at most ``budget_s``; the abandoned
    thread drops its late result. ``fn``'s own exception re-raises here.
    """
    if not budget_s or budget_s <= 0:
        return fn()
    box: Dict[str, object] = {}
    done = threading.Event()
    abandoned = threading.Event()

    def work():
        try:
            value = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            if not abandoned.is_set():
                box["error"] = e
        else:
            if not abandoned.is_set():
                box["value"] = value
        finally:
            done.set()

    threading.Thread(target=work, daemon=True, name=f"watchdog-{seam}-{scene}").start()
    if not done.wait(budget_s):
        abandoned.set()
        raise DeviceStallError(seam, scene, budget_s)
    if "error" in box:
        raise box["error"]  # type: ignore[misc]
    return box["value"]


class RetryPolicy:
    """Exponential backoff of the scene retry rounds (``faults.py:308-348``,
    its ``exp`` style): ``base_s * 2**(attempt - 1)`` capped at ``cap_s``.
    The JAX class's linear style and delay-scaling env var serve bench.py's
    supervisor, which the port does not have."""

    def __init__(self, base_s: float = 0.25, cap_s: float = 30.0):
        self.base_s = max(float(base_s), 0.0)
        self.cap_s = max(float(cap_s), 0.0)

    def backoff(self, attempt: int) -> float:
        """Delay after the ``attempt``-th failure (1-based)."""
        return min(self.base_s * (2.0 ** (max(int(attempt), 1) - 1)), self.cap_s)


# (rung name, config overrides, applicability predicate), most performant
# first; each device-class failure round drops ONE rung and the overrides
# accumulate. Rungs the config already satisfies are skipped.
_LADDER_RUNGS = (
    ("sequential-executor", {"scene_overlap": False},
     lambda cfg: bool(cfg.scene_overlap)),
    ("host-postprocess", {"device_postprocess": False},
     lambda cfg: bool(cfg.device_postprocess)),
)


class DegradationLadder:
    """Run-level graceful degradation on repeated device-class failures.

    Each ``degrade()`` drops one rung (logged); ``apply(cfg)`` returns the
    config with every dropped rung's overrides merged.
    """

    def __init__(self, cfg):
        self._rungs = [(name, overrides) for name, overrides, pred
                       in _LADDER_RUNGS if pred(cfg)]
        self._applied = 0

    @property
    def rung(self) -> int:
        """Rungs dropped so far (0 = full configuration)."""
        return self._applied

    @property
    def applied_names(self) -> List[str]:
        return [name for name, _ in self._rungs[:self._applied]]

    @property
    def exhausted(self) -> bool:
        return self._applied >= len(self._rungs)

    def degrade(self, reason: str = "") -> Optional[str]:
        """Drop one rung; returns its name, or None when exhausted."""
        if self.exhausted:
            return None
        name, _ = self._rungs[self._applied]
        self._applied += 1
        log.warning("degrading to rung %d (%s)%s", self._applied, name,
                    f": {reason}" if reason else "")
        return name

    def apply(self, cfg):
        """The config at the current rung (overrides of every dropped rung)."""
        overrides: Dict[str, object] = {}
        for _, o in self._rungs[:self._applied]:
            overrides.update(o)
        return cfg.replace(**overrides) if overrides else cfg


# ---------------------------------------------------------------------------
# cooperative stop (SIGTERM-safe shutdown)
# ---------------------------------------------------------------------------

_STOP = threading.Event()
_STOP_REASON = ""
_STOP_ANNOUNCED = threading.Event()


def _set_stop(reason: str) -> None:
    """Flag-only stop, the whole surface the signal handler may touch: it
    must not log (the interrupted thread may hold the logging lock)."""
    global _STOP_REASON
    if not _STOP.is_set():
        _STOP_REASON = reason
    _STOP.set()


def _announce_stop() -> None:
    """One-shot stop warning, from a normal thread only."""
    if not _STOP_ANNOUNCED.is_set():
        _STOP_ANNOUNCED.set()
        log.warning("stop requested%s: finishing in-flight scenes, "
                    "journaling the rest",
                    f" ({_STOP_REASON})" if _STOP_REASON else "")


def request_stop(reason: str = "") -> None:
    _set_stop(reason)
    _announce_stop()


def stop_requested() -> bool:
    if _STOP.is_set():
        _announce_stop()
    return _STOP.is_set()


def clear_stop() -> None:
    global _STOP_REASON
    _STOP.clear()
    _STOP_ANNOUNCED.clear()
    _STOP_REASON = ""


def install_sigterm_handler() -> Callable:
    """SIGTERM -> cooperative stop; a second SIGTERM force-exits (143).
    Returns the previous handler."""
    def _handler(signum, frame):  # noqa: ARG001 — signal API shape
        if _STOP.is_set():
            os._exit(143)  # second signal: the polite path already ran
        _set_stop(f"signal {signum}")

    return signal.signal(signal.SIGTERM, _handler)


# ---------------------------------------------------------------------------
# crash-safe run journal
# ---------------------------------------------------------------------------

# the JAX package's event envelope (obs/events.py): v / kind / ts / pid
JOURNAL_VERSION = 1
KIND_RUN = "run"
KIND_SCENE = "scene"


class RunJournal:
    """Append-only scene attempt/outcome journal for one config's runs
    (``faults.py:787-851``).

    One line per scene attempt start and per outcome, flushed per line, so
    a crash leaves exact attribution on disk: ``done`` scenes are skipped
    on resume, an ``attempt`` with no outcome was in flight and re-runs.
    Rows carry the config name, so one file can serve several configs.
    Thread-safe; a failing write disables the journal instead of the run.
    """

    def __init__(self, path: str, config_name: str):
        self.path = path
        self.config_name = config_name
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    def _emit(self, kind: str, payload: Dict) -> None:
        line = {"v": JOURNAL_VERSION, "kind": kind, "ts": time.time(), "pid": os.getpid(),
                **payload}
        with self._lock:
            if self._f is None:
                return
            try:
                self._f.write(json.dumps(line) + "\n")
                self._f.flush()
            except Exception:  # noqa: BLE001 — the journal must never sink the run
                log.exception("run journal write failed; disabling (%s)", self.path)
                self._f = None

    def begin_run(self) -> None:
        self._emit(KIND_RUN, {"event": "begin", "config": self.config_name})

    def end_run(self, *, interrupted: bool = False) -> None:
        self._emit(KIND_RUN, {"event": "end", "config": self.config_name,
                              "interrupted": bool(interrupted)})

    def attempt(self, seq: str, attempt: int, rung: int) -> None:
        self._emit(KIND_SCENE, {"event": "attempt", "seq": seq, "attempt": attempt,
                                "rung": rung, "config": self.config_name})

    def outcome(self, seq: str, status: str, *, attempt: int = 0,
                rung: int = 0, error_class: str = "", error: str = "",
                seconds: float = 0.0, num_objects: int = -1) -> None:
        payload = {"event": "outcome", "seq": seq, "status": status,
                   "attempt": attempt, "rung": rung,
                   "error_class": error_class,
                   "num_objects": num_objects,
                   "seconds": round(float(seconds), 4),
                   "config": self.config_name}
        if error:
            # the final line only: the journal is attribution, not a stack dump
            payload["error"] = str(error).strip().splitlines()[-1][:200]
        self._emit(KIND_SCENE, payload)

    def resume_done(self) -> Set[str]:
        return resume_done(self.path, config=self.config_name)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def read_journal(path: str, *, config: Optional[str] = None) -> List[Dict]:
    """All journal rows, oldest first; torn lines (a crash mid-write) and
    unknown versions are skipped. ``config`` filters to one config's rows."""
    rows = []
    with open(path, encoding="utf-8") as f:
        for raw in f:
            try:
                row = json.loads(raw)
            except ValueError:
                continue
            if (not isinstance(row, dict) or row.get("v") != JOURNAL_VERSION
                    or row.get("kind") not in (KIND_RUN, KIND_SCENE)):
                continue
            if config is not None and row.get("config") != config:
                continue
            rows.append(row)
    return rows


def replay_journal(path: str, *, config: Optional[str] = None) -> Dict[str, Dict]:
    """Final per-scene state from the journal alone: ``{seq: {status,
    attempts, degradation_rung, error_class, num_objects}}``; a trailing
    ``attempt`` with no outcome replays as ``"in-flight"``."""
    out: Dict[str, Dict] = {}
    for row in read_journal(path, config=config):
        seq = row.get("seq")
        if row.get("kind") != KIND_SCENE or not isinstance(seq, str):
            continue
        cur = out.setdefault(seq, {"status": "in-flight", "attempts": 0,
                                   "degradation_rung": 0, "error_class": "",
                                   "num_objects": -1})
        cur["attempts"] = max(cur["attempts"], int(row.get("attempt", 0)))
        if row.get("event") == "attempt":
            cur["status"] = "in-flight"
        elif row.get("event") == "outcome":
            cur["status"] = row.get("status", "in-flight")
            cur["degradation_rung"] = int(row.get("rung", 0))
            cur["error_class"] = row.get("error_class", "")
            cur["num_objects"] = int(row.get("num_objects", -1))
    return out


def resume_done(path: str, *, config: Optional[str] = None) -> Set[str]:
    """Scenes whose journal says they need no re-run: final status ``ok``
    or ``skipped``. Failed, interrupted and in-flight scenes re-run."""
    if not os.path.exists(path):
        return set()
    return {seq for seq, st in replay_journal(path, config=config).items()
            if st["status"] in ("ok", "skipped")}
