"""Crash-contained serving: the card-owning worker as a supervised
subprocess (the port's copy of ``maskclustering_tpu/serve/supervisor.py``).

The in-thread worker (serve/worker.py) owns the card from a thread of the
daemon's process: a hard CUDA fault (an illegal address or an ECC error
poisons the process's context, and only a new process recovers from it),
a segfault or an OOM kill takes the whole daemon down, and a wedged
driver call leaks the card behind an abandoned ``DeviceStallError``
thread. This module moves the card owner into a SUBPROCESS
(serve/worker_main.py) speaking the JSONL protocol over stdio pipes,
supervised from the daemon with the watchdog vocabulary of
``utils/faults.py``:

- **heartbeats** — the child emits ``{"kind": "hb"}`` at a fixed cadence
  from a dedicated thread; the parent re-arms a ``faults.Heartbeat``
  (budget ``cfg.worker_heartbeat_s``) on every child line. A GIL-held
  native hang stops every Python thread in the child, so silence IS the
  wedge signal — and unlike the in-process watchdog, the parent can
  actually clear it: **SIGKILL**, not an abandoned thread.
- **bounded respawn with backoff** — ``cfg.worker_respawns`` consecutive
  failed spawns (shared ``faults.RetryPolicy`` backoff) before the
  supervisor declares the card unserveable and asks the daemon to stop;
  the counter resets every time a child reaches ``ready``. A child that
  cannot initialise its device is a failed spawn: nothing retries it on
  another device.
- **requeue, neighbors untouched** — the in-flight request gets a typed
  ``worker_crash`` status event, an ``interrupted`` outcome row in its
  per-request RunJournal, and goes back into the admission queue for the
  respawned worker — pre-degraded by its crash count (SceneSupervisor
  ``initial_rungs``). A request that crashes ``MAX_REQUEST_CRASHES``
  workers answers a typed ``failed`` result (``error_class: "device"``)
  instead of crash-looping the fleet. Queued neighbors never notice: they
  are the parent's, not the child's.
- **warm respawn** — the child's startup builds the kernel libraries (a
  no-op once built) and runs the ordinary warm-up before its ``ready``
  line; nothing compiles per shape on the card, so a respawn costs the
  process start, the context and the warm scenes.

**The parent stays device-free**: this module never initialises CUDA —
no tensor, no ``torch.cuda`` query that creates a context. ``device`` is
only handed to the child (``--device``).

The supervisor exposes ServeWorker's surface (start/stop/wait_idle/stats/
latency_quantiles/run_canary) so ``ServeDaemon`` swaps topologies with one
flag; the admission queue, router, protocol and report wiring are
unchanged.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

import torch

from maskclustering_tpu_torch import obs
from maskclustering_tpu_torch.analysis.lock_sanitizer import mct_lock
from maskclustering_tpu_torch.device import DeviceLike
from maskclustering_tpu_torch.obs import flight as _flight
from maskclustering_tpu_torch.obs import telemetry
from maskclustering_tpu_torch.serve import protocol
from maskclustering_tpu_torch.serve.admission import AdmissionQueue
from maskclustering_tpu_torch.serve.router import Router
from maskclustering_tpu_torch.serve.worker import _send
from maskclustering_tpu_torch.utils import faults

log = logging.getLogger("maskclustering_tpu_torch")

# the package's parent directory: the child imports the port from here
# whatever the daemon's working directory
_IMPORT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# how many device workers one request may take down before it answers a
# typed failure instead of burning the whole respawn budget on a
# poison-pill scene
MAX_REQUEST_CRASHES = 2


def _closed_safe(lines):
    """Iterate a child's stdout, treating a closed-under-us pipe as EOF
    (the kill path closes streams while the reader may still drain)."""
    while True:
        try:
            line = next(lines)
        except StopIteration:
            return
        except (OSError, ValueError):
            return
        yield line


def _count_key(terminal: Dict, counts: Dict[str, int]) -> str:
    """The stats digest's count a child terminal books under."""
    status = terminal.get("status") or terminal.get("reason") or "failed"
    if terminal.get("kind") == "reject":
        return "deadline" if status == "deadline" else "failed"
    return status if status in counts else "failed"


class WorkerSupervisor:
    """Parent-side supervision of one card-owning worker subprocess.

    The JAX supervisor's signature, plus ``device``: the child's torch
    device (None: the CUDA card), passed to it as ``--device`` and never
    touched here. ``freeze_after_warm`` goes to the child (``--no-freeze``
    when off), with ``--retrace-sanitizer`` when this process has the
    sanitizer armed.
    """

    def __init__(self, cfg, queue: AdmissionQueue, router: Router, *,
                 journal_dir: Optional[str] = None,
                 prediction_root: Optional[str] = None,
                 stream_state_dir: Optional[str] = None,
                 warm_scenes: Tuple[str, ...] = (),
                 warm_baseline: Optional[str] = None,
                 freeze_after_warm: bool = True,
                 fault_plan_spec: Optional[str] = None,
                 child_argv: Optional[list] = None,
                 start_timeout_s: float = 600.0,
                 poll_s: float = 0.25,
                 on_fatal=None,
                 worker_id: int = 0,
                 pooled: bool = False,
                 child_env: Optional[Dict[str, str]] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        # a name only: torch.device() of a string creates no context
        self.device = torch.device("cuda" if device is None else device)
        self.queue = queue
        self.router = router
        # pool identity: 0 is the classic single-worker topology; a
        # WorkerPool numbers its slices (pooled=True) and only THEN do
        # relayed spans / telemetry rows carry the id — a lone supervisor
        # must stay report-identical to the in-process topology
        self.worker_id = int(worker_id)
        self.pooled = bool(pooled)
        # per-child environment overlay (the pool's device carve: each
        # slice's child sees only its own chips)
        self.child_env = dict(child_env) if child_env else None
        self.journal_dir = journal_dir
        self.prediction_root = prediction_root
        # shared snapshot directory for stream failover: the child ships
        # per-chunk accumulator snapshots here (models/streaming
        # save_state, stream_journal_every cadence), and a crashed
        # stream requeues onto the next child instead of answering
        # stream_lost whenever a snapshot exists to resume from
        self.stream_state_dir = stream_state_dir
        self.warm_scenes = tuple(warm_scenes)
        self.warm_baseline = warm_baseline
        self.freeze_after_warm = bool(freeze_after_warm)
        self.fault_plan_spec = fault_plan_spec
        self.child_argv = child_argv
        self.start_timeout_s = float(start_timeout_s)
        self.poll_s = poll_s
        self.on_fatal = on_fatal
        self._stop = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._lock = mct_lock("serve.WorkerSupervisor._lock")
        self._thread: Optional[threading.Thread] = None
        self._child: Optional[subprocess.Popen] = None
        self._reader: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._heartbeat = faults.Heartbeat(
            max(getattr(cfg, "worker_heartbeat_s", 0.0), 0.0), seam="worker")
        # in-flight request state keyed by request id, written by the
        # pump, relayed to by the reader. One entry per member:
        # {"req": SceneRequest, "terminal": dict|None, "done": Event}.
        # The packing pump (serve_batch_max > 1) forwards same-bucket
        # batches as ONE pipe envelope, so several entries can ride a
        # single dispatch — a crash requeues exactly the members whose
        # terminal events never landed.
        self._inflight: Dict[str, Dict] = {}
        self._latencies: Deque[float] = deque(maxlen=4096)
        self._counts = {"requests": 0, "ok": 0, "failed": 0, "deadline": 0,
                        "skipped": 0, "interrupted": 0}
        self.respawns = 0
        # respawns since the last child reached ready — the pre-wedge
        # visibility counter (resets on every healthy ready, so a climbing
        # value in `status` means the respawn budget is being eaten NOW)
        self.consecutive_respawns = 0
        self.crashes = 0
        self.spawns = 0
        self.last_ready: Dict = {}
        self.last_bye: Dict = {}
        # the child's black-box delta: worker_main ships its flight-ring
        # events on the heartbeat cadence (kind "flight" pipe lines), so
        # when heartbeat silence forces a SIGKILL the parent still holds
        # the victim's final spans — the rows the result-driven telem
        # relay never got to ship. Bounded; _on_crash dumps them.
        self._child_flight: Deque[Dict] = deque(maxlen=1024)
        self._last_child_telem: Optional[Dict] = None
        # canary-sentinel pipe plumbing: the child's stdin keeps its
        # SINGLE-WRITER invariant — the sentinel never touches the pipe;
        # run_canary posts _canary_req and the pump thread ships the op
        # between requests (so no lock ever wraps pipe IO). _canary_busy
        # (under _lock) admits one round at a time; a second tick skips.
        self._canary_req = threading.Event()
        self._canary_done = threading.Event()
        self._canary_busy = False
        self._canary_probes: Optional[list] = None
        # stream sessions under crash containment: scenes whose
        # device-resident _StreamSession lives in the CURRENT child
        # (grown from stream_chunk results, shrunk on done/stream_end).
        # A crash moves them to _lost_streams — the accumulator died with
        # the child, and the wire `chunk` is frames-per-chunk (not a
        # cursor), so a respawned child would silently reopen at chunk 0.
        # Lost scenes answer a typed stream_lost (in-flight at crash, or
        # at dequeue for queued/later ops), then clear so the client can
        # restart the stream from its own source.
        self._open_streams: set = set()
        self._lost_streams: set = set()
        # failover bookkeeping: streams this supervisor requeued onto a
        # fresh child from a snapshot instead of answering stream_lost
        self._streams_resumed = 0
        self._cfg_path = self._write_cfg()

    # -- child plumbing ------------------------------------------------------

    def _write_cfg(self) -> str:
        d = self.journal_dir or tempfile.gettempdir()
        os.makedirs(d, exist_ok=True)
        fd, path = tempfile.mkstemp(prefix="worker_cfg_", suffix=".json",
                                    dir=d)
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(self.cfg.to_json())
        return path

    def _child_cmd(self, first_spawn: bool) -> list:
        if self.child_argv is not None:
            return list(self.child_argv)
        from maskclustering_tpu_torch.analysis import retrace_sanitizer

        cmd = [sys.executable, "-m", "maskclustering_tpu_torch.serve.worker_main",
               "--cfg-json", self._cfg_path, "--device", str(self.device)]
        if self.worker_id:
            cmd += ["--worker-id", str(self.worker_id)]
        if self.journal_dir:
            cmd += ["--journal-dir", self.journal_dir]
        if self.prediction_root:
            cmd += ["--prediction-root", self.prediction_root]
        if self.stream_state_dir:
            cmd += ["--stream-state", self.stream_state_dir]
        if self.warm_scenes:
            cmd += ["--warm", "+".join(self.warm_scenes)]
        if self.warm_baseline:
            cmd += ["--warm-baseline", self.warm_baseline]
        if not self.freeze_after_warm:
            cmd += ["--no-freeze"]
        if retrace_sanitizer.enabled():
            cmd += ["--retrace-sanitizer"]
        if first_spawn and self.fault_plan_spec:
            # drills target the FIRST worker; a respawn is the recovery
            # under test — re-arming the plan there would crash-loop it
            cmd += ["--fault-plan", self.fault_plan_spec]
        return cmd

    def _spawn(self, first_spawn: bool) -> bool:
        """One child spawn; blocks (bounded) until its ready line."""
        self._ready.clear()
        cmd = self._child_cmd(first_spawn)
        log.info("worker supervisor: spawning device worker%s",
                 "" if first_spawn else f" (respawn {self.respawns})")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_IMPORT_ROOT, env.get("PYTHONPATH")) if p)
        if self.child_env:
            env.update(self.child_env)
        try:
            child = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, text=True,
                                     bufsize=1, env=env)
        except OSError:
            log.exception("worker supervisor: spawn failed")
            return False
        self._child = child
        self.spawns += 1
        reader = threading.Thread(  # mct-thread: abandon(one reader per child, exits on the child's stdout EOF; the kill/respawn path closes the pipe, which IS the bounded join)
            target=self._read_child, args=(child,), daemon=True,
            name="worker-reader")
        reader.start()
        self._reader = reader
        deadline = time.monotonic() + self.start_timeout_s
        while time.monotonic() < deadline:
            if self._ready.wait(0.25):
                self._heartbeat.beat()
                self.consecutive_respawns = 0
                return True
            if child.poll() is not None:
                log.error("worker supervisor: child died during startup "
                          "(rc %s)", child.returncode)
                return False
            if self._stop.is_set():
                return False
        log.error("worker supervisor: child never answered ready within "
                  "%.0fs; killing", self.start_timeout_s)
        self._kill_child()
        return False

    def _read_child(self, child: subprocess.Popen) -> None:
        """Reader: heartbeats re-arm the watchdog, request events relay to
        the in-flight client, terminal events wake the pump."""
        stream = child.stdout
        if stream is None:
            return
        try:
            lines = iter(stream)
        except (OSError, ValueError):
            return
        for line in _closed_safe(lines):
            if not line.strip():
                continue
            self._heartbeat.beat()
            try:
                doc = json.loads(line)
            except ValueError:
                log.warning("worker supervisor: unreadable child line %r",
                            line[:200])
                continue
            kind = doc.get("kind")
            if kind == "hb":
                continue
            if kind == telemetry.KIND_TELEM:
                # the cross-process relay: the child's counter deltas fold
                # into THIS registry under their own names and its spans
                # replay here — the Serving report and the telemetry
                # windows read topology-invariant (obs/telemetry.py)
                try:
                    telemetry.fold_telem(
                        doc, child_pid=child.pid,
                        worker_id=self.worker_id if self.pooled else None)
                except Exception:  # noqa: BLE001 — telemetry never faults
                    log.exception("worker supervisor: telem fold failed")
                with self._lock:
                    self._last_child_telem = doc
                continue
            if kind == _flight.KIND_DELTA:
                # child flight-ring delta (heartbeat cadence): retain, so
                # a SIGKILL postmortem still shows the victim's last spans
                with self._lock:
                    for row in doc.get("rows") or ():
                        if isinstance(row, dict):
                            row.setdefault("pid", child.pid)
                            self._child_flight.append(row)
                continue
            if kind == "ready":
                with self._lock:
                    self.last_ready = doc
                self._ready.set()
                continue
            if kind == "bye":
                with self._lock:
                    self.last_bye = doc
                continue
            if kind == "canary":
                # the canary round's answer (worker_main's canary op)
                with self._lock:
                    self._canary_probes = doc.get("probes")
                self._canary_done.set()
                continue
            rid = doc.get("id")
            if rid is None:
                continue
            with self._lock:
                entry = self._inflight.get(rid)
            if entry is None or entry["done"].is_set():
                log.warning("worker supervisor: dropping stray child event "
                            "for %s", rid)
                continue
            if kind in ("result", "reject"):
                entry["terminal"] = doc
                self._track_stream(entry["req"], doc)
                # book the status before the client can see the terminal:
                # a stats() call right after it must count this request
                with self._lock:
                    key = _count_key(doc, self._counts)
                    self._counts[key] = self._counts.get(key, 0) + 1
                _send(entry["req"], doc)
                entry["done"].set()
            else:
                _send(entry["req"], doc)

    def _track_stream(self, req: protocol.SceneRequest, doc: Dict) -> None:
        """Mirror the child's live _StreamSession set from its terminal
        events: an ok stream_chunk that is not ``done`` opens (or keeps)
        the scene's session; a finished stream or an ok stream_end drops
        it. This parent-side shadow is what crash containment consults —
        the child's own session table dies with it."""
        if req.op not in ("stream_chunk", "stream_end"):
            return
        ok = doc.get("kind") == "result" and doc.get("status") == "ok"
        with self._lock:
            if req.op == "stream_chunk" and ok and not doc.get("done"):
                self._open_streams.add(req.scene)
            elif ok:  # finished stream (done=True) or successful end
                self._open_streams.discard(req.scene)

    def _kill_child(self) -> None:
        child = self._child
        if child is None:
            return
        if child.poll() is None:
            try:
                child.kill()
            except OSError:
                pass
        try:
            child.wait(10.0)
        except subprocess.TimeoutExpired:
            pass
        for stream in (child.stdin, child.stdout):
            try:
                if stream:
                    stream.close()
            except OSError:
                pass
        self._child = None  # the pump's respawn trigger

    # -- lifecycle (ServeWorker surface) ------------------------------------

    def start(self) -> None:
        """Spawn the first worker (blocking until warm) + the pump thread.

        Raises RuntimeError when the first spawn cannot reach ready within
        the respawn budget — a daemon that cannot own a device must fail
        its startup loudly, not accept requests it can never serve.
        """
        if self._thread is not None:
            return
        if not self._spawn(first_spawn=True) and not self._respawn():
            raise RuntimeError(
                "device worker failed to start within the respawn budget; "
                "see worker stderr above")
        self._thread = threading.Thread(  # mct-thread: abandon(daemon-lifetime pump, bounded-joined in stop(); the spawn/join pair spans methods, which the scope-local check cannot see)
            target=self._run, daemon=True, name="serve-supervisor")
        self._thread.start()

    def stop(self, timeout_s: float = 60.0) -> bool:
        """Drain: finish the in-flight request, stop the child, join."""
        self._stop.set()
        # the SIGTERM drain contract: the request in flight finishes in
        # the child and answers before the child is asked to exit
        idle = self._idle.wait(timeout_s)
        child = self._child
        drained = True
        if child is not None and child.poll() is None:
            try:
                if child.stdin:
                    child.stdin.write(json.dumps({"op": "shutdown"}) + "\n")
                    child.stdin.flush()
                    child.stdin.close()
            except OSError:
                pass
            try:
                child.wait(max(timeout_s, 5.0))
            except subprocess.TimeoutExpired:
                log.error("worker supervisor: child outlived the drain "
                          "budget; SIGKILL")
                drained = False
        # drain the reader BEFORE closing the pipes — whether the child
        # exited on request or on its own: the final `bye` digest (the
        # child's counts and kernel launches the daemon's digest line
        # reads) may still sit buffered in the pipe
        reader = self._reader
        if reader is not None:
            reader.join(5.0)
        self._kill_child()
        t = self._thread
        if t is not None:
            t.join(10.0)
        try:
            os.unlink(self._cfg_path)  # one cfg transport file per daemon
        except OSError:
            pass
        return idle and drained and (t is None or not t.is_alive())

    def wait_idle(self, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.queue.depth() == 0 and self._idle.is_set():
                return True
            time.sleep(0.01)
        return False

    def busy(self) -> bool:
        """A dispatch unit is in flight (the pool's load metric)."""
        return not self._idle.is_set()

    # -- the pump ------------------------------------------------------------

    def _child_dead(self) -> Optional[str]:
        """A crash signal, if any: process death or heartbeat silence.
        (``self._child is None`` means an already-handled crash awaiting
        respawn — not a NEW crash signal.)"""
        child = self._child
        if child is None:
            return None
        if child.poll() is not None:
            return f"worker process died (rc {child.returncode})"
        if self._heartbeat.expired():
            _flight.record(_flight.KIND_HB, what="heartbeat_silent",
                           age_s=round(self._heartbeat.age_s(), 3),
                           budget_s=self._heartbeat.budget_s)
            return (f"worker heartbeat silent past "
                    f"{self._heartbeat.budget_s:.3g}s (wedged); SIGKILL")
        return None

    def _respawn(self) -> bool:
        """Bounded respawn loop; False = budget exhausted (fatal)."""
        policy = faults.RetryPolicy(
            attempts=int(getattr(self.cfg, "worker_respawns", 2)) + 1,
            base_s=self.cfg.retry_backoff_s,
            cap_s=max(self.cfg.retry_backoff_s * 8.0, 0.0))
        for attempt in range(1, policy.attempts + 1):
            if self._stop.is_set():
                return False
            self.respawns += 1
            self.consecutive_respawns += 1
            obs.count("serve.worker_respawns")
            if self._spawn(first_spawn=False):
                return True
            if attempt < policy.attempts:
                delay = policy.backoff(attempt)
                log.warning("worker supervisor: respawn failed; retrying "
                            "in %.2fs (%d/%d)", delay, attempt + 1,
                            policy.attempts)
                time.sleep(delay)
        return False

    def _run(self) -> None:
        while not self._stop.is_set():
            detail = self._child_dead()
            if detail is not None:
                # idle crash/wedge (no request harmed): contain first
                self._on_crash(None, detail)
            if self._child is None:
                # a crash was handled (here or under a request): respawn
                if not self._respawn():
                    self._fatal()
                    break
                continue
            self._maybe_send_canary()
            batch = self._next_work()
            if batch is None:
                continue
            if self._stop.is_set():
                for req in batch:
                    if not self.queue.requeue(req):
                        obs.count("serve.admission.rejects.draining")
                        _send(req, protocol.reject(
                            "draining", req=req,
                            detail="daemon shutting down before dispatch"))
                break
            self._idle.clear()
            try:
                self._serve_batch(batch)
            except Exception:  # noqa: BLE001 — one batch, not the daemon
                log.exception("worker supervisor: batch %s crashed the "
                              "pump", [r.id for r in batch])
                for req in batch:
                    with self._lock:
                        entry = self._inflight.pop(req.id, None)
                    if entry is not None and entry["terminal"] is not None:
                        continue  # answered before the pump tripped
                    _send(req, protocol.result(
                        req, "failed", error="internal supervisor error",
                        error_class="terminal"))
            finally:
                self._idle.set()

    def _next_work(self) -> Optional[list]:
        """One dispatch unit off the admission queue: a single request,
        or — when continuous batching is on — up to ``serve_batch_max``
        same-bucket requests packed by the shared scheduler
        (AdmissionQueue.next_batch). The parent's key fn only needs the
        router's memory: the CHILD's own packing scheduler re-derives
        buckets (and peeks its fault plan) before fusing, so an over-eager
        parent key costs nothing but a wider pipe envelope."""
        batch_max = max(int(getattr(self.cfg, "serve_batch_max", 1)), 1)
        if batch_max <= 1:
            req = self.queue.next(timeout_s=self.poll_s)
            return None if req is None else [req]
        return self.queue.next_batch(
            self._batch_key, max_n=batch_max,
            linger_s=float(getattr(self.cfg, "serve_batch_linger_s", 0.0)),
            timeout_s=self.poll_s)

    def _batch_key(self, req: protocol.SceneRequest) -> Optional[tuple]:
        """Same-bucket grouping key for the pipe pump; None = solo (never
        batched): streams, resumes, crash-requeued requests, and scenes
        the router has not classified yet."""
        if req.op != "scene" or req.resume or req.crashes:
            return None
        return self.router.bucket_for(req.scene)

    def _book_arrival(self, req: protocol.SceneRequest) -> bool:
        """Parent-side dequeue bookkeeping; False = expired at dequeue
        (typed deadline reject — the child never sees the request)."""
        with self._lock:
            self._counts["requests"] += 1
        telemetry.record_queue_wait(
            req, max(time.monotonic() - req.admitted_at, 0.0))
        if req.expired():
            obs.count("serve.requests")
            obs.count("serve.rejects.deadline")
            telemetry.record_reject(req.tenant)
            with self._lock:
                self._counts["deadline"] += 1
            _send(req, protocol.reject(
                "deadline", req=req,
                detail=f"deadline_s={req.deadline_s:g} expired after "
                       f"{time.monotonic() - req.admitted_at:.2f}s in queue"))
            return False
        if req.op in ("stream_chunk", "stream_end"):
            with self._lock:
                lost = req.scene in self._lost_streams
                self._lost_streams.discard(req.scene)
            if lost and self._stream_resumable(req.scene):
                # the session died with a worker but the child shipped a
                # snapshot: forward normally — the respawned child's
                # _open_stream resumes the accumulator from it
                with self._lock:
                    self._streams_resumed += 1
                return True
            if lost:
                # the session this op was continuing died with a worker
                # and no snapshot exists to resume from; answer typed,
                # clear the mark so a restarted stream (fresh chunk 1)
                # serves normally. serve.requests books parent-side: the
                # child never sees this op
                obs.count("serve.requests")
                self._answer_stream_lost(
                    req, "stream session lost to a worker crash before "
                         "this op dispatched")
                return False
        return True

    def _stream_resumable(self, scene: str) -> bool:
        """A snapshot exists for this scene's stream: the crashed session
        can re-open on a fresh (or surviving pool) child from disk instead
        of answering the typed stream_lost fallback."""
        if not self.stream_state_dir:
            return False
        from maskclustering_tpu_torch.models.streaming import stream_state_path
        try:
            return os.path.exists(
                stream_state_path(self.stream_state_dir, scene))
        except OSError:
            return False

    def _answer_stream_lost(self, req: protocol.SceneRequest,
                            detail: str) -> None:
        """Typed stream-loss terminal: the scene's device-resident
        accumulator died with its worker and the stream CANNOT silently
        continue (frames-per-chunk wire field, not a cursor — a respawn
        would reopen at chunk 0). status stream_lost + failed result."""
        obs.count("serve.streams_lost")
        obs.count("serve.requests_failed")
        with self._lock:
            self._counts["failed"] += 1
        _send(req, protocol.status(req, "stream_lost", detail=detail))
        _send(req, protocol.result(
            req, "failed",
            error=f"stream session for {req.scene!r} lost: {detail}",
            error_class="stream_lost"))

    def _serve_batch(self, batch) -> None:
        # NB: serve.requests / serve.requests_<status> obs counters for
        # forwarded requests are booked by the CHILD and arrive via the
        # telem relay — booking them here too would double-count the fold.
        # Only the paths the child never sees (expired-at-dequeue, the
        # crash cap in _contain_crash) book parent-side.
        live = [req for req in batch if self._book_arrival(req)]
        if not live:
            return
        t0 = time.monotonic()
        entries = {req.id: {"req": req, "terminal": None,
                            "done": threading.Event()} for req in live}
        with self._lock:
            self._inflight.update(entries)
        child = self._child
        doc = (protocol.forward_request(live[0]) if len(live) == 1
               else protocol.forward_batch(live))
        try:
            child.stdin.write(json.dumps(doc, sort_keys=True) + "\n")
            child.stdin.flush()
        except (OSError, ValueError, AttributeError):
            self._crash_batch(entries, "pipe to worker broke on forward")
            return
        # the deadline backstop spans the batch (the child enforces each
        # member's own folded deadline; this only catches a child that
        # ignores them outright) and only arms when EVERY member carries
        # one — an unbounded member legitimately runs as long as it needs
        deadlines = [req.deadline_s for req in live if req.deadline_s > 0]
        backstop = (max(deadlines) + max(self.cfg.watchdog_device_s, 30.0)
                    + 5.0) if len(deadlines) == len(live) else None
        # wait for every member's terminal event, watching the child the
        # whole time: a crash mid-batch is the supervised case, not an
        # exception (a drain keeps waiting here — in-flight must answer)
        while True:
            pending = [e for e in entries.values()
                       if not e["done"].is_set()]
            if not pending:
                break
            pending[0]["done"].wait(0.25)
            detail = self._child_dead()
            if detail is not None:
                # the child may have ANSWERED (some or all members) and
                # then died: give the reader a bounded window to drain
                # buffered results before declaring members crashed — a
                # completed scene must never be re-executed (or worse,
                # converted into a typed failure at the crash cap)
                grace = time.monotonic() + 2.0
                for e in entries.values():
                    e["done"].wait(max(grace - time.monotonic(), 0.0))
                self._crash_batch(entries, detail)
                break
            if backstop is not None and time.monotonic() - t0 > backstop:
                self._crash_batch(entries,
                                  "worker ignored the request deadline")
                break
        for entry in entries.values():
            if entry["terminal"] is not None:
                with self._lock:
                    self._inflight.pop(entry["req"].id, None)
                self._book_result(entry["req"], entry["terminal"], t0)

    def _book_result(self, req: protocol.SceneRequest, terminal: Dict,
                     t0: float) -> None:
        # per-status obs counters arrive via the relay (the child booked
        # them) and the stats digest's count was booked by the reader
        # before the terminal went out; only the latency and the telemetry
        # window's latency-by-bucket are booked here
        key = _count_key(terminal, self._counts)
        latency = time.monotonic() - t0
        self._latencies.append(latency)
        bucket = terminal.get("bucket")
        if bucket is not None:
            b = tuple(bucket)
            self.router.remember(req.scene, b)
            self.router.note_served(b)
        # window-latency parity with the in-process worker: it records
        # only requests that reached the end of execution (its results
        # carry `seconds`) — not rejects, not early-exit materialization
        # failures — and bucket-less terminals (disk scenes) fall back to
        # the router's memory for the same per-bucket keys
        if terminal.get("kind") == "result" and "seconds" in terminal:
            telemetry.record_request(
                tuple(bucket) if bucket is not None
                else self.router.bucket_for(req.scene), latency,
                tenant=req.tenant, status=key,
                worker=self.worker_id if self.pooled else None)

    def _crash_batch(self, entries: Dict, detail: str) -> None:
        """The in-flight batch's worker died: contain ONCE (kill + dump),
        then requeue (or answer at the crash cap) exactly the members
        WITHOUT terminal events. A batchmate whose result landed before
        the death is booked normally by the caller — a completed scene is
        never re-executed, and never converted into a typed failure."""
        victims = []
        with self._lock:
            for entry in entries.values():
                if entry["done"].is_set():
                    continue  # terminal landed; the caller books it
                entry["done"].set()  # the reader must not relay stale events
                self._inflight.pop(entry["req"].id, None)
                victims.append(entry["req"])
        self._contain_crash(victims, detail)

    def _on_crash(self, req: Optional[protocol.SceneRequest],
                  detail: str) -> None:
        """Idle-crash shim: contain with zero (or one) harmed requests."""
        self._contain_crash([req] if req is not None else [], detail)

    def _contain_crash(self, reqs, detail: str) -> None:
        self.crashes += 1
        obs.count("serve.worker_crashes")
        log.error("worker supervisor: %s", detail)
        with self._lock:
            # every open session died with the child; in-flight stream
            # victims are answered below (and clear their own mark), the
            # rest answer stream_lost at their next op's dequeue
            self._lost_streams |= self._open_streams
            self._open_streams.clear()
        child = self._child
        child_pid = child.pid if child is not None else None
        self._kill_child()
        _flight.record(_flight.KIND_CRASH, detail=detail,
                       request=",".join(r.id for r in reqs) or None,
                       scene=",".join(r.scene for r in reqs) or None,
                       child_pid=child_pid, crashes=self.crashes)
        self._dump_blackbox(child_pid)
        for req in reqs:
            self._requeue_crashed(req, detail)

    def _requeue_crashed(self, req: protocol.SceneRequest,
                         detail: str) -> None:
        # zero-width trace marker: obs.trace renders the crash between the
        # dead attempt and the requeue's second queue-wait segment
        obs.record_span("serve.worker_crash", 0.0, request=req.id,
                        scene=req.scene, detail=detail, end_ts=time.time())
        telemetry.record_crash(req.tenant)
        req.crashes += 1
        err = faults.WorkerCrashError(req.scene, detail)
        if req.op in ("stream_chunk", "stream_end"):
            resumable = self._stream_resumable(req.scene)
            with self._lock:
                self._lost_streams.discard(req.scene)
            if resumable and req.crashes < MAX_REQUEST_CRASHES \
                    and not self._stop.is_set():
                # the session's device accumulator died with the child,
                # but the child shipped per-chunk snapshots: requeue the
                # op — the next child's _open_stream resumes from disk
                # (coordinate-checked load_state) and the already-pushed
                # replay chunk dedupes worker-side. Failover is stamped
                # on the journal (stream_resumed) and the worker_crash
                # status carries resuming=True for the obs.trace timeline.
                req.admitted_at = time.monotonic()
                if self.queue.requeue(req):
                    self._journal_crash(req, err,
                                        error_class="stream_resumed")
                    with self._lock:
                        self._streams_resumed += 1
                    obs.count("serve.requests_requeued")
                    _send(req, protocol.status(
                        req, "worker_crash", requeued=True, resuming=True,
                        crashes=req.crashes, detail=detail))
                    return
            # no snapshot (or retries exhausted / draining): typed loss —
            # frames-per-chunk wire semantics mean a respawned child
            # would silently reopen the stream at chunk 0
            self._journal_crash(req, err)
            self._answer_stream_lost(req, detail)
            return
        self._journal_crash(req, err)
        # re-admission stamp: the SECOND queue-wait segment measures from
        # the requeue, not the original ack (the first attempt's wall is
        # its own trace segment, not queue time); deadline_at is absolute
        # and unaffected
        req.admitted_at = time.monotonic()
        if req.crashes < MAX_REQUEST_CRASHES \
                and not self._stop.is_set() and self.queue.requeue(req):
            obs.count("serve.requests_requeued")
            _send(req, protocol.status(req, "worker_crash", requeued=True,
                                       crashes=req.crashes, detail=detail))
            return
        obs.count("serve.requests_failed")
        with self._lock:
            self._counts["failed"] += 1
        _send(req, protocol.result(req, "failed", error=str(err),
                                   error_class="device",
                                   worker_crashes=req.crashes))

    def _dump_blackbox(self, child_pid: Optional[int]) -> None:
        """The SIGKILL postmortem: the parent's own ring plus the child's
        last relayed flight delta and telemetry doc — the only record of
        what the dead worker was doing when the live relay went silent."""
        with self._lock:
            extra = [dict(row) for row in self._child_flight]
            telem = self._last_child_telem
        # racing child shippers (hb thread vs receive-time flush) may land
        # deltas out of ring order; the per-pid seq restores it
        extra.sort(key=lambda r: (r.get("pid") or 0, r.get("seq") or 0))
        if telem is not None:
            extra.append({"kind": _flight.KIND_CHILD_TELEM,
                          "pid": child_pid, "doc": telem})
        _flight.dump("worker_crash", extra_rows=extra)

    def _journal_crash(self, req: protocol.SceneRequest, err: Exception,
                       error_class: str = "device") -> None:
        """Crash-stamp the request's journal: an ``interrupted`` outcome
        row next to the child's orphaned attempt row, so replay shows
        exactly which attempt the worker died under. ``stream_resumed``
        stamps a stream failover (requeued onto a fresh child from a
        snapshot) instead of plain device loss."""
        if not self.journal_dir:
            return
        try:
            path = os.path.join(self.journal_dir, f"{req.id}.jsonl")
            j = faults.RunJournal(path, self.cfg.config_name,
                                  request_id=req.id)
            j.outcome(req.scene, "interrupted", attempt=req.crashes,
                      error_class=error_class, error=str(err))
            j.close()
        except Exception:  # noqa: BLE001 — attribution must not sink recovery
            log.exception("worker supervisor: crash journal row failed")

    def _fatal(self) -> None:
        log.error("worker supervisor: respawn budget exhausted — the "
                  "device is unserveable; requesting daemon stop")
        obs.count("serve.worker_fatal")
        if self.on_fatal is not None:
            try:
                self.on_fatal()
            except Exception:  # noqa: BLE001
                log.exception("worker supervisor: on_fatal callback failed")

    def _maybe_send_canary(self) -> None:
        """Ship a posted canary op — PUMP THREAD ONLY, preserving the
        child stdin's single-writer invariant (no lock ever wraps the
        pipe IO). A dead child or broken pipe releases the waiter with
        no probes — the sentinel books that tick as skipped."""
        if not self._canary_req.is_set():
            return
        self._canary_req.clear()
        child = self._child
        if child is None or child.stdin is None:
            self._canary_done.set()
            return
        try:
            child.stdin.write(json.dumps({"op": "canary"}) + "\n")
            child.stdin.flush()
        except (OSError, ValueError, AttributeError):
            self._canary_done.set()

    def run_canary(self, timeout_s: float = 120.0) -> Optional[list]:
        """One canary-sentinel probe round over the pipe (ServeWorker
        surface): post the canary op for the pump thread to ship, wait
        (bounded, lock-free) for the child's ``canary`` answer. None on
        a busy round / dead child / broken pipe / timeout — the sentinel
        books those ticks as skipped, never as drift."""
        child = self._child
        if child is None or child.poll() is not None or child.stdin is None:
            return None
        with self._lock:
            if self._canary_busy:
                return None  # one round at a time; this tick skips
            self._canary_busy = True
            self._canary_probes = None
        self._canary_done.clear()
        self._canary_req.set()
        try:
            if not self._canary_done.wait(timeout_s):
                self._canary_req.clear()  # never let a stale op fire later
                log.warning("worker supervisor: canary round timed out "
                            "after %.0fs", timeout_s)
                return None
            with self._lock:
                return self._canary_probes
        finally:
            with self._lock:
                self._canary_busy = False

    # -- introspection (ServeWorker surface) --------------------------------

    def latency_quantiles(self) -> Dict[str, Optional[float]]:
        from maskclustering_tpu_torch.obs.report import percentile

        vals = sorted(self._latencies)
        if not vals:
            return {"p50_s": None, "p95_s": None, "count": 0}
        return {"p50_s": round(percentile(vals, 50), 4),
                "p95_s": round(percentile(vals, 95), 4),
                "count": len(vals)}

    def child_retrace(self) -> Dict:
        """The worker's retrace digest (ready/bye lines), for the daemon's
        stats + the Serving report: ``{}`` when the child's sanitizer is
        off."""
        with self._lock:
            src = self.last_bye or self.last_ready
        return dict(src.get("retrace") or {})

    def stats(self) -> Dict:
        with self._lock:
            counts = dict(self._counts)
            ready = dict(self.last_ready)
            cuda = (self.last_bye or self.last_ready).get("cuda")
            inflight = list(self._inflight.values())
            inflight_id = inflight[0]["req"].id if inflight else None
            inflight_width = len(inflight)
            inflight_crashes = max((e["req"].crashes for e in inflight),
                                   default=0)
            # deterministic drill evidence: how many in-flight requests
            # the child has ACKNOWLEDGED via its relayed flight ring — a
            # kill drill waits for this instead of sleeping
            flight_ids = {row.get("request") for row in self._child_flight
                          if row.get("kind") == _flight.KIND_REQUEST}
            inflight_ids = [e["req"].id for e in inflight]
            streams_resumed = self._streams_resumed
        inflight_logged = sum(1 for r in inflight_ids if r in flight_ids)
        child = self._child
        alive = child is not None and child.poll() is None
        return {"counts": counts,
                "latency": self.latency_quantiles(),
                "warm_buckets": sorted(self.router.warm_buckets()),
                # the pre-wedge liveness panel: heartbeat age (vs budget),
                # consecutive respawns and the in-flight crash count make
                # a wedging worker visible in `status` BEFORE the SIGKILL
                "worker": {"isolated": True, "alive": alive,
                           "worker_id": self.worker_id,
                           "open_streams": len(self._open_streams),
                           "lost_streams": len(self._lost_streams),
                           "streams_resumed": streams_resumed,
                           "inflight_logged": inflight_logged,
                           "spawns": self.spawns,
                           "respawns": self.respawns,
                           "consecutive_respawns": self.consecutive_respawns,
                           "crashes": self.crashes,
                           "hb_age_s": round(self._heartbeat.age_s(), 3),
                           "hb_budget_s": self._heartbeat.budget_s,
                           "inflight": inflight_id,
                           "inflight_width": inflight_width,
                           "inflight_crashes": inflight_crashes,
                           "warmup_s": ready.get("warmup_s"),
                           "aot": ready.get("aot"),
                           "pid": ready.get("pid"),
                           # the child's builds, launches and peak memory
                           # (its last bye, else its ready line)
                           "cuda": cuda}}
