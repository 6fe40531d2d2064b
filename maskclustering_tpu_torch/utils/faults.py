"""Fault-tolerance primitives of the batch driver and the streaming
accumulator (the port's copy of ``maskclustering_tpu/utils/faults.py``).

The scene is the fault boundary: a transient device fault should cost one
scene retry, not the run; inside a streamed scene, one chunk retry.

- **watchdogs** (``call_with_deadline``, ``Heartbeat``): a bounded wait
  around a scene's load, device phase, host tail or streaming chunk; on
  expiry a typed ``DeviceStallError`` is raised in the caller and the
  wedged work is abandoned on its daemon thread (a hung native call can
  only be outwaited, not cancelled);
- **error classes** (``classify_error``): ``retryable``, ``device`` (also
  drives the degradation ladder) or ``terminal`` (a retry cannot help);
- **retry and degradation** (``RetryPolicy``, ``DegradationLadder``);
- **deterministic fault injection** (``FaultPlan``, ``inject``,
  ``take_corruption``): seam-scripted drills (``--fault-plan`` or
  ``$MCT_FAULT_PLAN``, e.g. ``"load:scene2, stall:scene4.device,
  flaky:scene5:2"``) that drive every watchdog, retry, ladder rung and
  journal path on a healthy card. Same grammar, kinds, defaults and error
  messages as the JAX module;
- **cooperative stop** on SIGTERM at scene and chunk boundaries;
- **crash-safe run journal** (``RunJournal``, ``read_journal``,
  ``replay_journal``, ``resume_done``): an append-only JSONL of scene
  attempt and outcome rows in the JAX package's envelope and format, so a
  rerun skips exactly the scenes that finished.

The port's ladder keeps the rungs that change what the port does:
``sequential-executor``, ``single-chip`` (applied only when the config has
a ``mesh_shape``: the fused mesh path gives way to the single-device one,
point axis included) and ``host-postprocess``. The JAX rung
``donation-off`` has no torch meaning (the port's only donation, the fused
step's early release of its frame stacks, changes no byte and no failure).
``sequential-executor`` and ``single-chip`` come before it, so they carry
the same rung numbers in both packages; the port's ``host-postprocess``
is one rung lower than JAX's. So at the default config a post-process
capacity overflow heals on the port's rung 2 at attempt 3 without a mesh
(JAX's rung 3, attempt 4), and a device fault of a mesh batch that outlasts
``sequential-executor`` (which leaves the mesh in place) heals on
``single-chip``, rung 2 in both packages (rung 1 when the run is already
sequential). Artifacts and digests are equal at every rung.
``SceneStatus.degradation_rung``, the journal's ``rung`` rows and the ``r``
field of ``digest_coord`` follow each package's own ladder.

The metrics counters (``run.device_stalls``, ``run.abandoned_results``,
``run.degradations.<rung>``, ``faults.injected.<seam>``) and the
flight-recorder marks and dumps (watchdog and heartbeat expiry, injected
faults, the stop transition) are booked at the JAX module's sites. The
serving daemon fires the ``admission`` seam (``serve/daemon.py``).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Set

import torch

from maskclustering_tpu_torch.analysis.lock_sanitizer import mct_lock

log = logging.getLogger("maskclustering_tpu_torch")


def _count(name: str, delta: float = 1.0) -> None:
    """obs counter bump; accounting never faults the fault layer."""
    try:
        from maskclustering_tpu_torch.obs import metrics

        metrics.count(name, delta)
    except Exception:  # noqa: BLE001
        pass


def _flight_record(kind: str, **fields) -> None:
    """Flight-ring mark (obs/flight.py); never the failure source."""
    try:
        from maskclustering_tpu_torch.obs import flight

        flight.record(kind, **fields)
    except Exception:  # noqa: BLE001
        pass


def _flight_dump(reason: str) -> None:
    """Crash-safe black-box dump (a no-op unless a flight directory is
    armed). Called on the watchdog and cooperative-drain paths, never from
    a signal handler."""
    try:
        from maskclustering_tpu_torch.obs import flight

        flight.dump(reason)
    except Exception:  # noqa: BLE001
        pass


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


class WorkerCrashError(RuntimeError):
    """The card-owning worker subprocess died under a request.

    Raised (synthesized) by the serving worker supervisor
    (serve/supervisor.py) when a child is SIGKILLed on a missed heartbeat
    or dies outright (a CUDA fault, segfault, OOM kill, a ``crash`` fault
    drill). Classified ``device`` — the card/runtime, not the scene, is the
    story — so the requeue/ladder machinery composes with it like any other
    device-class failure.
    """

    def __init__(self, scene: Optional[str], detail: str):
        self.scene = scene
        self.detail = detail
        super().__init__(
            f"device worker crashed under scene {scene!r}: {detail}")


class InjectedFault(RuntimeError):
    """A FaultPlan-scripted failure; ``retryable`` steers classification."""

    def __init__(self, msg: str, *, retryable: bool = True):
        self.retryable = retryable
        super().__init__(msg)


# the seams a FaultPlan can target, where run.py, models/pipeline.py,
# models/postprocess_device.py and models/streaming.py call inject(): "post"
# heads the device post-process chain (the seam that drives the ladder's
# host-postprocess rung), "chunk" heads every streaming chunk (its faults
# retry the chunk, the accumulator intact), "admission" is the serving
# daemon's (serve/daemon.py, after the WAL admit row)
SEAMS = ("load", "device", "host", "export", "pull", "post", "chunk", "admission")

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
    if isinstance(exc, (DeviceStallError, WorkerCrashError)) \
            or isinstance(exc, _DEVICE_ERROR_TYPES):
        return "device"
    if isinstance(exc, InjectedFault):
        return "retryable" if exc.retryable else "terminal"
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
            if abandoned.is_set():
                _count("run.abandoned_results")
            else:
                box["error"] = e
        else:
            if abandoned.is_set():
                _count("run.abandoned_results")
            else:
                box["value"] = value
        finally:
            done.set()

    threading.Thread(  # mct-thread: abandon(a wedged native call can only be outwaited, never cancelled; the daemon flag keeps it off the shutdown path and the `abandoned` event drops its late result)
        target=work, daemon=True, name=f"watchdog-{seam}-{scene}").start()
    if not done.wait(budget_s):
        abandoned.set()
        _count("run.device_stalls")
        # the wedge evidence goes to disk before the error unwinds
        _flight_record("flight.fault", what="watchdog_expired", seam=seam,
                       scene=scene, budget_s=budget_s)
        _flight_dump("watchdog")
        raise DeviceStallError(seam, scene, budget_s)
    if "error" in box:
        raise box["error"]  # type: ignore[misc]
    return box["value"]


class Heartbeat:
    """A deadline that re-arms on progress (long multi-step loops).

    ``beat()`` marks liveness; ``check()`` raises ``DeviceStallError`` when
    no beat landed within ``budget_s``: a loop that is merely slow keeps
    beating and lives, one whose next step never arrives dies within the
    budget. Thread-safe (the beating worker and the checking supervisor are
    usually different threads). The subprocess worker's supervisor
    (serve/supervisor.py) beats it on every line its child writes.
    """

    def __init__(self, budget_s: float, *, seam: str = "device",
                 scene: Optional[str] = None):
        self.budget_s = budget_s
        self.seam = seam
        self.scene = scene
        self._lock = mct_lock("faults.Heartbeat._lock")
        self._last = time.monotonic()

    def beat(self) -> None:
        with self._lock:
            self._last = time.monotonic()

    def remaining(self) -> float:
        with self._lock:
            return self.budget_s - (time.monotonic() - self._last)

    def age_s(self) -> float:
        """Seconds since the last beat."""
        with self._lock:
            return time.monotonic() - self._last

    def expired(self) -> bool:
        return self.budget_s > 0 and self.remaining() <= 0

    def check(self) -> None:
        if self.expired():
            _count("run.device_stalls")
            _flight_record("flight.fault", what="heartbeat_expired", seam=self.seam,
                           scene=self.scene, budget_s=self.budget_s)
            _flight_dump("watchdog")
            raise DeviceStallError(self.seam, self.scene, self.budget_s)


class RetryPolicy:
    """Backoff schedule of the retry loops (``faults.py:308-348``).

    ``style="exp"``: ``base_s * 2**(attempt - 1)`` capped at ``cap_s``, the
    scene and chunk retry shape. ``style="linear"``: ``base_s * attempt``
    capped, the JAX bench supervisor's shape. ``attempts`` is the caller's
    budget (the streaming chunk loop's). ``scale_env`` names an environment
    variable multiplying every delay; a malformed value counts as 1.0 and a
    negative one as 0.
    """

    def __init__(self, attempts: int = 3, base_s: float = 0.25, cap_s: float = 30.0,
                 style: str = "exp", scale_env: Optional[str] = None):
        if style not in ("exp", "linear"):
            raise ValueError(f"unknown backoff style {style!r}")
        self.attempts = max(int(attempts), 1)
        self.base_s = max(float(base_s), 0.0)
        self.cap_s = max(float(cap_s), 0.0)
        self.style = style
        self.scale_env = scale_env

    def scale(self) -> float:
        if not self.scale_env:
            return 1.0
        try:
            return max(float(os.environ.get(self.scale_env, "1.0")), 0.0)
        except ValueError:
            return 1.0

    def backoff(self, attempt: int) -> float:
        """Delay after the ``attempt``-th failure (1-based)."""
        attempt = max(int(attempt), 1)
        if self.style == "linear":
            delay = self.base_s * attempt
        else:
            delay = self.base_s * (2.0 ** (attempt - 1))
        return min(delay, self.cap_s) * self.scale()


# (rung name, config overrides, applicability predicate), most performant
# first; each device-class failure round drops ONE rung and the overrides
# accumulate. Rungs the config already satisfies are skipped.
_LADDER_RUNGS = (
    ("sequential-executor", {"scene_overlap": False},
     lambda cfg: bool(cfg.scene_overlap)),
    # the single-device path retires the whole mesh, point axis included
    ("single-chip", {"mesh_shape": (), "point_shards": 1},
     lambda cfg: bool(cfg.mesh_shape)),
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
        _count(f"run.degradations.{name}")
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
# deterministic fault injection
# ---------------------------------------------------------------------------


class _FaultEntry:
    __slots__ = ("kind", "seam", "scene", "remaining", "lock")

    def __init__(self, kind: str, seam: str, scene: str, count: Optional[int]):
        self.kind = kind
        self.seam = seam
        self.scene = scene
        self.remaining = count  # None = every attempt
        self.lock = mct_lock("faults._FaultEntry.lock")

    def take(self) -> bool:
        """Consume one firing; False once the count is exhausted."""
        with self.lock:
            if self.remaining is None:
                return True
            if self.remaining <= 0:
                return False
            self.remaining -= 1
            return True


# kind -> (default seam, default count; None = unlimited). "crash" and
# "die" SIGKILL the process at the seam ("die" defaults to the serving
# daemon's admission seam); "wedge" silences a heartbeat (set_wedge_hook)
# and blocks without bound; "corrupt" flips a bit of a pulled value at a
# data site instead of raising, so only a digest can see it
_KIND_DEFAULTS = {
    "fail": ("device", None),
    "load": ("load", None),
    "flaky": ("device", 1),
    "stall": ("device", 1),
    "terminal": ("device", None),
    "sigterm": ("load", 1),
    "crash": ("device", 1),
    "wedge": ("device", 1),
    "die": ("admission", 1),
    "corrupt": ("host", None),
}


class FaultPlan:
    """A deterministic, seam-scripted fault schedule.

    Spec grammar (comma-separated entries)::

        KIND:SCENE[.SEAM][:COUNT]

        load:scene2           # scene2's load raises, every attempt
        stall:scene4.device   # scene4's first device phase hangs (sleep)
        flaky:scene5:2        # scene5's device phase fails twice, then ok
        fail:scene3.export:1  # one export failure
        terminal:scene6       # a non-retryable failure (classification)
        sigterm:scene1.load   # one real SIGTERM to this process at the seam
        crash:scene7.device   # one real SIGKILL to the executing process
        wedge:scene8.device   # heartbeat-silent unbounded hang
        corrupt:scene9.host   # silent bit-flip of a pulled value (digest drift)
        die:sceneA.admission  # one real SIGKILL at the daemon's admission

    ``stall`` sleeps ``stall_s`` (``$MCT_FAULT_STALL_S``, default 5 s) at
    the seam: under an armed watchdog the caller sees ``DeviceStallError``
    within its budget. Counts are firings remaining, decremented per firing,
    so retries see the scripted sequence deterministically. Thread-safe:
    seams fire from prefetch threads, the dispatch thread, the host-tail
    worker and the watchdog threads.
    """

    def __init__(self, entries: Iterable[_FaultEntry], *, stall_s: float = 5.0,
                 spec: str = ""):
        self.entries = list(entries)
        self.stall_s = float(stall_s)
        self.spec = spec

    @classmethod
    def from_spec(cls, spec: str, *, stall_s: Optional[float] = None) -> "FaultPlan":
        if stall_s is None:
            try:
                stall_s = float(os.environ.get("MCT_FAULT_STALL_S", "5.0"))
            except ValueError:
                stall_s = 5.0
        entries = []
        for raw in spec.split(","):
            raw = raw.strip()
            if not raw:
                continue
            parts = raw.split(":")
            if len(parts) not in (2, 3):
                raise ValueError(f"bad fault entry {raw!r} (KIND:SCENE[.SEAM][:COUNT])")
            kind, target = parts[0].strip(), parts[1].strip()
            if kind not in _KIND_DEFAULTS:
                raise ValueError(f"unknown fault kind {kind!r} in {raw!r} "
                                 f"(one of {sorted(_KIND_DEFAULTS)})")
            seam, count = _KIND_DEFAULTS[kind]
            if "." in target:
                scene, _, maybe_seam = target.rpartition(".")
                if maybe_seam not in SEAMS:
                    raise ValueError(f"unknown seam {maybe_seam!r} in {raw!r} "
                                     f"(one of {SEAMS})")
                target, seam = scene, maybe_seam
            if len(parts) == 3:
                count = int(parts[2])
                if count < 1:
                    raise ValueError(f"count must be >= 1 in {raw!r}")
            if not target:
                raise ValueError(f"empty scene name in {raw!r}")
            entries.append(_FaultEntry(kind, seam, target, count))
        return cls(entries, stall_s=stall_s, spec=spec)

    def fire(self, seam: str, scene: Optional[str]) -> None:
        """Perform every scripted action matching (seam, scene): raising
        kinds raise, ``stall`` sleeps, ``sigterm`` signals this process,
        ``crash``/``die`` SIGKILL it, ``wedge`` calls the wedge hook and
        blocks. ``corrupt`` entries never fire here (``take_corruption``)."""
        if scene is None:
            return
        for e in self.entries:
            if e.kind == "corrupt":
                continue
            if e.seam != seam or e.scene != scene or not e.take():
                continue
            _count(f"faults.injected.{seam}")
            _flight_record("flight.fault", what="injected", fault_kind=e.kind, seam=seam,
                           scene=scene)
            log.warning("fault injection: %s at %s seam of scene %s", e.kind, seam, scene)
            if e.kind == "stall":
                time.sleep(self.stall_s)
            elif e.kind == "sigterm":
                os.kill(os.getpid(), signal.SIGTERM)
            elif e.kind in ("crash", "die"):
                os.kill(os.getpid(), signal.SIGKILL)
            elif e.kind == "wedge":
                hook = wedge_hook()
                if hook is not None:
                    hook()
                while True:  # unbounded: only an external SIGKILL ends it
                    time.sleep(60.0)
            elif e.kind == "terminal":
                raise InjectedFault(f"injected terminal fault at {seam} seam of {scene}",
                                    retryable=False)
            elif seam == "post":
                # the post seam's one real failure is a capacity overflow:
                # the production error type drives the production (device)
                # classification, hence the ladder's host-postprocess rung
                from maskclustering_tpu_torch.models.postprocess_device import (
                    PostprocessCapacityError,
                )

                raise PostprocessCapacityError(
                    f"injected ({e.kind} fault at scene {scene})", -1, 0, "post_group_cap")
            else:  # fail / load / flaky
                raise InjectedFault(f"injected {e.kind} fault at {seam} seam of {scene}")

    def take_corruption(self, seam: str, scene: Optional[str]) -> bool:
        """Consume one scripted ``corrupt`` firing for (seam, scene); the
        data site flips a bit when this returns True. Nothing raises, so
        the retry policy and the ladder never see it."""
        if scene is None:
            return False
        for e in self.entries:
            if e.kind != "corrupt" or e.seam != seam or e.scene != scene or not e.take():
                continue
            _count(f"faults.injected.{seam}")
            _flight_record("flight.fault", what="injected", fault_kind="corrupt", seam=seam,
                           scene=scene)
            log.warning("fault injection: corrupt at %s seam of scene %s", seam, scene)
            return True
        return False


_PLAN: Optional[FaultPlan] = None
_PLAN_LOADED = False
_PLAN_LOCK = mct_lock("faults._PLAN_LOCK")
_WEDGE_HOOK: Optional[Callable] = None


def set_wedge_hook(fn: Optional[Callable]) -> None:
    """Register what a ``wedge`` fault does before it hangs (a serving
    worker silences its heartbeat emitter here)."""
    global _WEDGE_HOOK
    with _PLAN_LOCK:
        _WEDGE_HOOK = fn


def wedge_hook() -> Optional[Callable]:
    with _PLAN_LOCK:
        return _WEDGE_HOOK


def active_plan() -> Optional[FaultPlan]:
    """The process-wide plan: ``set_plan`` wins, else ``$MCT_FAULT_PLAN``
    (parsed once)."""
    global _PLAN, _PLAN_LOADED
    with _PLAN_LOCK:
        if not _PLAN_LOADED:
            spec = os.environ.get("MCT_FAULT_PLAN", "").strip()
            _PLAN = FaultPlan.from_spec(spec) if spec else None
            _PLAN_LOADED = True
        return _PLAN


def set_plan(plan: Optional[FaultPlan]) -> None:
    """Install (or clear with None) the process-wide plan; overrides the env."""
    global _PLAN, _PLAN_LOADED
    with _PLAN_LOCK:
        _PLAN = plan
        _PLAN_LOADED = True


def inject(seam: str, scene: Optional[str]) -> None:
    """The seam hook: a no-op without an active plan, else fires the plan's
    matching entries."""
    plan = active_plan()
    if plan is not None:
        plan.fire(seam, scene)


def take_corruption(seam: str, scene: Optional[str]) -> bool:
    """The corruption hook: True when the active plan scripts a ``corrupt``
    firing at (seam, scene); the data site then flips one bit."""
    plan = active_plan()
    return plan.take_corruption(seam, scene) if plan is not None else False


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
        # the ring mark for the stop transition happens here, never in the
        # (flag-only) handler
        _flight_record("flight.signal", what="stop_requested", reason=_STOP_REASON)
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


def stop_reason() -> str:
    return _STOP_REASON


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
    ``request_id`` (the serving daemon's per-request attribution) stamps
    every row when given; ``read_journal``/``replay_journal``/``resume_done``
    filter on it. Thread-safe; a failing write disables the journal instead
    of the run.
    """

    def __init__(self, path: str, config_name: str, request_id: Optional[str] = None):
        self.path = path
        self.config_name = config_name
        self.request_id = request_id
        self._lock = mct_lock("faults.RunJournal._lock")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    def _emit(self, kind: str, payload: Dict) -> None:
        line = {"v": JOURNAL_VERSION, "kind": kind, "ts": time.time(), "pid": os.getpid(),
                **payload}
        if self.request_id is not None:
            line["request"] = self.request_id
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
        return resume_done(self.path, config=self.config_name, request=self.request_id)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def read_journal(path: str, *, config: Optional[str] = None,
                 request: Optional[str] = None) -> List[Dict]:
    """All journal rows, oldest first; torn lines (a crash mid-write) and
    unknown versions are skipped. ``config`` filters to one config's rows,
    ``request`` to one serving request's."""
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
            if request is not None and row.get("request") != request:
                continue
            rows.append(row)
    return rows


def replay_journal(path: str, *, config: Optional[str] = None,
                   request: Optional[str] = None) -> Dict[str, Dict]:
    """Final per-scene state from the journal alone: ``{seq: {status,
    attempts, degradation_rung, error_class, num_objects}}``; a trailing
    ``attempt`` with no outcome replays as ``"in-flight"``."""
    out: Dict[str, Dict] = {}
    for row in read_journal(path, config=config, request=request):
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


def resume_done(path: str, *, config: Optional[str] = None,
                request: Optional[str] = None) -> Set[str]:
    """Scenes whose journal says they need no re-run: final status ``ok``
    or ``skipped``. Failed, interrupted and in-flight scenes re-run."""
    if not os.path.exists(path):
        return set()
    return {seq for seq, st in replay_journal(path, config=config, request=request).items()
            if st["status"] in ("ok", "skipped")}
