"""mct-serve daemon: the long-lived scene-serving process (the port's copy
of ``maskclustering_tpu/serve/daemon.py``, with one in-thread worker).

Lifecycle of one daemon::

    start()            bind the socket, pre-warm the serving vocabulary
                       (explicit warm scenes and/or the surface baseline's
                       workload: their cold dispatches happen before the
                       first request), then start the worker + acceptor
                       threads
    serve_forever()    poll the stop flags (own + faults.stop_requested(),
                       which the SIGTERM handler sets) at scene-safe
                       granularity
    shutdown()         stop admitting (new lines answer ``draining``),
                       finish the request in flight, typed-reject the
                       still-queued ones, join every thread bounded,
                       close the socket

Thread topology (all spawns bounded-joined at shutdown; the scope-local
CONC.JOIN check cannot see the cross-method join, hence the abandon
markers with that exact rationale):

- **acceptor** — ``accept()`` with a poll timeout; spawns one handler per
  connection;
- **handler** (per connection) — reads JSONL lines, validates, admits
  into the bounded queue, answers ``ack``/``reject`` inline; the
  request's ``send`` stays bound to this connection (one lock per
  connection serializes event lines);
- **worker** (``serve/worker.py``) — the single card-owning executor; the
  acceptor and connection threads never touch the card.

The daemon deliberately reuses the one-shot stack end to end — the same
executors, the same artifact exports — so a served scene's npz is
byte-identical to ``run.py``'s.

``canary_interval_s > 0`` arms the canary sentinel (obs/canary.py): every
interval, at an idle queue, the worker replays its warm-up scenes and the
digests are held against the committed goldens.

``isolate_worker=True`` moves the card owner into a supervised subprocess
(serve/supervisor.py, serve/worker_main.py) and ``serve_workers > 1`` runs
a pool of them (serve/pool.py): a crashed or wedged worker costs a
respawn, not the daemon, and the daemon's own process never touches the
card. The JAX daemon's tooling steps are here on the port's surfaces:
the kernel build cache's warm start (``utils/aot_cache.py``, armed by
``cfg.aot_cache_dir`` or ``$MCT_AOT_CACHE``) before warm-up, and the
build/launch-surface sanitizer's freeze after it (``freeze_after_warm``,
``analysis/retrace_sanitizer.py``): ``stats()["retrace"]`` is the
sanitizer's summary, ``{}`` with it off. The persistent compilation cache
has no counterpart (nothing traces).
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from maskclustering_tpu_torch import obs
from maskclustering_tpu_torch.analysis.lock_sanitizer import mct_lock
from maskclustering_tpu_torch.device import DeviceLike, resolve_device
from maskclustering_tpu_torch.obs import flight as _flight
from maskclustering_tpu_torch.obs import slo as _slo
from maskclustering_tpu_torch.obs import telemetry
from maskclustering_tpu_torch.serve import protocol
from maskclustering_tpu_torch.serve import wal as _wal
from maskclustering_tpu_torch.serve.admission import AdmissionQueue, QueueFullReject
from maskclustering_tpu_torch.serve.pool import QuotaReject, WorkerPool
from maskclustering_tpu_torch.serve.router import Router
from maskclustering_tpu_torch.serve.supervisor import WorkerSupervisor
from maskclustering_tpu_torch.serve.worker import ServeWorker
from maskclustering_tpu_torch.utils import faults

log = logging.getLogger("maskclustering_tpu_torch")

DEFAULT_CAPACITY = 8


def _make_sender(conn: socket.socket):
    """A thread-safe one-line-per-event sender bound to one connection.

    ``send.lock``/``send.raw`` exist for the admission handshake: the
    handler holds the lock across queue-submit + ack (written via
    ``raw``), so the worker — which can pick the request up the instant
    it lands in the queue — cannot interleave a ``running`` status (or
    even the result) BEFORE the ack the protocol promises first.
    """
    lock = mct_lock("serve.Connection._send_lock")

    def raw(event: Dict) -> None:
        conn.sendall(protocol.encode(event))

    def send(event: Dict) -> None:
        with lock:
            raw(event)

    send.lock = lock
    send.raw = raw
    return send


class _WalSend:
    """A WAL-tracked request's ``send``: records the dispatch row (first
    status event) and the terminal row in the admission WAL, then forwards
    to the currently attached client connection. ``client`` is the one
    mutable cell — a reconnect-and-resubmit with the same idempotency key
    swaps it live (re-attach), and a request replayed from the WAL starts
    detached (``client`` None: the work runs and journals, the terminal
    waits in the dedupe cache for the client's resubmit)."""

    def __init__(self, daemon: "ServeDaemon", rid: str, idem: str,
                 client=None):
        self._daemon = daemon
        self.rid = rid
        self.idem = idem
        self.client = client
        self._dispatched = False

    def __call__(self, event: Dict) -> None:
        kind = event.get("kind")
        if kind == "status" and not self._dispatched:
            # benign race on the flag: at worst a duplicate advisory
            # dispatch row, never a lost one
            self._dispatched = True
            self._daemon._wal_dispatch(self.rid)
        if kind in ("result", "reject"):
            self._daemon._wal_terminal(self.rid, self.idem, event)
        client = self.client
        if client is not None:
            client(event)


class ServeDaemon:
    """One serving process: admission + router + worker + socket front.

    The JAX daemon's signature, plus ``device`` (the worker's card; None =
    the current CUDA device, raising without one; ``"cpu"`` for the plain
    torch path). Under ``isolate_worker`` it is the child's device, and
    this process never touches it. ``freeze_after_warm`` freezes the
    build/launch-surface sanitizer after warm-up when it is armed (in the
    child under ``isolate_worker``), so a new launch key while serving is
    a violation. ``fault_plan_spec`` goes to the first worker subprocess only (pool
    slice 0); an in-thread drill's plan is the process's,
    ``faults.set_plan``.
    """

    def __init__(self, cfg, *,
                 socket_path: Optional[str] = None,
                 host: Optional[str] = None, port: int = 0,
                 capacity: int = DEFAULT_CAPACITY,
                 journal_dir: Optional[str] = None,
                 prediction_root: Optional[str] = None,
                 stream_state_dir: Optional[str] = None,
                 wal: bool = True,
                 warm_scenes: Tuple[str, ...] = (),
                 warm_baseline: Optional[str] = None,
                 default_deadline_s: float = 0.0,
                 isolate_worker: bool = False,
                 freeze_after_warm: bool = True,
                 fault_plan_spec: Optional[str] = None,
                 telemetry_window_s: float = 5.0,
                 slo_spec: Optional[str] = None,
                 flight_dir: Optional[str] = None,
                 canary_interval_s: float = 0.0,
                 canary_goldens: Optional[str] = None,
                 device: DeviceLike = None):
        if socket_path is None and host is None:
            raise ValueError("need a socket_path (AF_UNIX) or host/port (TCP)")
        self.cfg = cfg
        self.socket_path = socket_path
        self.host = host
        self.port = port
        self.default_deadline_s = float(default_deadline_s)
        self.warm_scenes = tuple(warm_scenes)
        self.isolate_worker = bool(isolate_worker)
        self.freeze_after_warm = bool(freeze_after_warm)
        self.journal_dir = journal_dir
        # shared per-chunk stream snapshots (models/streaming save_state):
        # the worker ships them here and a crashed stream's session
        # re-opens from the latest one instead of answering stream_lost
        self.stream_state_dir = stream_state_dir
        if stream_state_dir:
            os.makedirs(stream_state_dir, exist_ok=True)
        self.queue = AdmissionQueue(capacity)
        self.router = Router(cfg, baseline_path=warm_baseline)
        pool_size = max(int(cfg.serve_workers), 1)
        if pool_size > 1 and not isolate_worker:
            raise ValueError(
                f"serve_workers={pool_size} needs --isolate-worker: pool "
                "slices are supervised subprocesses (one device owner per "
                "slice), never threads")
        if isolate_worker:
            # the parent stays device-free: the child resolves and
            # initialises the device; here it is a name. A missing card
            # still fails here, as the in-thread worker's resolve does
            if device is None and not torch.cuda.is_available():
                resolve_device(None)  # raises the port's no-card error
            self.device = torch.device("cuda" if device is None else device)
            kw = dict(journal_dir=journal_dir,
                      prediction_root=prediction_root,
                      stream_state_dir=stream_state_dir,
                      warm_scenes=self.warm_scenes,
                      warm_baseline=warm_baseline,
                      freeze_after_warm=freeze_after_warm,
                      fault_plan_spec=fault_plan_spec,
                      on_fatal=self.request_stop, device=self.device)
            if pool_size > 1:
                # the worker pool (serve/pool.py): K supervised slices
                # behind one affinity-aware weighted-fair scheduler;
                # exposes the WorkerSupervisor surface
                self.worker = WorkerPool(cfg, self.queue, self.router, **kw)
            else:
                # crash containment (serve/supervisor.py): the card owner
                # is a supervised SUBPROCESS — a SIGKILL'd/wedged worker
                # costs a respawn, not the daemon; warm-up happens in the
                # child
                self.worker = WorkerSupervisor(cfg, self.queue, self.router,
                                               **kw)
        else:
            self.worker = ServeWorker(cfg, self.queue, self.router,
                                      journal_dir=journal_dir,
                                      prediction_root=prediction_root,
                                      stream_state_dir=stream_state_dir,
                                      device=device)
            self.device = self.worker.device
        self._lock = mct_lock("serve.ServeDaemon._lock")
        self._ids = 0
        # admission WAL (serve/wal.py): armed whenever journaling is on —
        # journal_dir holds the per-request journals AND the daemon's one
        # crash-safe admission ledger. The sink opens in start() (after
        # recovery compacts the predecessor's file)
        self._wal: Optional[_wal.AdmissionWal] = None
        self._wal_path = ""
        if wal and journal_dir:
            os.makedirs(journal_dir, exist_ok=True)
            self._wal_path = os.path.join(journal_dir, _wal.WAL_FILENAME)
        # idem dedupe planes: key -> cached terminal event (answered) and
        # key -> the live in-flight request (running; re-attach target)
        self._wal_answered: Dict[str, Dict] = {}
        self._wal_running: Dict[str, protocol.SceneRequest] = {}
        self._wal_replayed = 0
        self._wal_deduped = 0
        self._wal_reattached = 0
        self._journals_pruned = 0
        self._pruner: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._draining = threading.Event()
        # connections outlive the stop flag: in-flight results and the
        # queued requests' draining rejects must still reach their
        # clients, so handler threads only exit once the drain is done
        self._conns_stop = threading.Event()
        self._listener: Optional[socket.socket] = None
        self._acceptor: Optional[threading.Thread] = None
        self._handlers: List[threading.Thread] = []
        self._started_at = 0.0
        self._warmup_s = 0.0
        # the live telemetry plane (obs/telemetry.py): windowed rolling
        # aggregation over this process's registry
        self.aggregator = telemetry.WindowAggregator(
            window_s=telemetry_window_s)
        self._ticker = telemetry.TelemetryTicker(self.aggregator)
        # the SLO plane (obs/slo.py): a bad spec must fail daemon startup
        # loudly, not surface as a broken `status` answer hours later
        self.slo_spec = _slo.load_spec(slo_spec)
        # the correctness plane (obs/canary.py): goldens load at start()
        # so a warm worker exists before the first probe
        self.canary_interval_s = float(canary_interval_s)
        self.canary_goldens = canary_goldens
        self.sentinel = None
        if flight_dir:
            # arm this process AND (via env) any worker subprocess it
            # spawns — the child's flight ring needs somewhere to dump too
            _flight.arm(flight_dir)
            os.environ[_flight.ENV_DIR] = flight_dir
        self._capacity_dumped = threading.Event()

    # -- lifecycle ----------------------------------------------------------

    @property
    def address(self):
        """The bound address: the socket path, or (host, port) for TCP."""
        if self.socket_path is not None:
            return self.socket_path
        assert self._listener is not None, "start() first"
        return self._listener.getsockname()

    def start(self) -> None:
        self._started_at = time.monotonic()
        self._bind()
        if self.isolate_worker:
            # the child owns warm-up end to end; start() blocks until its
            # ready line, so the daemon accepts requests only against a
            # warm worker — same contract as the in-thread _prewarm. No
            # device-memory gauges here: reading them would touch the card
            t0 = time.monotonic()
            self.worker.start()
            self._warmup_s = time.monotonic() - t0
        else:
            # device-memory gauges at span ends read the worker's card
            obs.metrics.set_device(self.device)
            from maskclustering_tpu_torch.utils import aot_cache

            aot_stats = aot_cache.warm_start(self.cfg, device=self.device)
            if any(aot_stats.values()):
                log.info("mct-serve: aot cache %s", aot_stats)
            self._prewarm()
            self.worker.start()
        # durability plane: recover the predecessor's admission WAL (seed
        # the id counter, warm the dedupe cache, replay journaled-but-
        # unanswered requests into the queue), then the retention pass —
        # both BEFORE the acceptor so recovery races no live admission
        self._recover_wal()
        self._prune_retention()
        self._start_pruner()
        # install + tick AFTER warm-up, with the delta baseline re-anchored
        # to NOW: windows meter serving, and without the rebase window 0
        # would charge the whole warm-up wall + its counter deltas
        # (prewarm dispatches) to itself
        self.aggregator.rebase()
        telemetry.install(self.aggregator)
        self._ticker.start()
        self._start_sentinel()
        self._acceptor = threading.Thread(  # mct-thread: abandon(daemon-lifetime thread, bounded-joined in shutdown(); the spawn/join pair spans methods, which the scope-local check cannot see)
            target=self._accept_loop, daemon=True, name="serve-acceptor")
        self._acceptor.start()
        log.info("mct-serve: accepting on %s (capacity %d, %d warm "
                 "bucket(s), warm-up %.1fs)", self.address,
                 self.queue.capacity, len(self.router.warm_buckets()),
                 self._warmup_s)

    def _bind(self) -> None:
        if self.socket_path is not None:
            if os.path.exists(self.socket_path):
                os.unlink(self.socket_path)
            os.makedirs(os.path.dirname(self.socket_path) or ".",
                        exist_ok=True)
            self._listener = socket.socket(socket.AF_UNIX,
                                           socket.SOCK_STREAM)
            self._listener.bind(self.socket_path)
        else:
            self._listener = socket.socket(socket.AF_INET,
                                           socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
            self._listener.bind((self.host, self.port))
        self._listener.listen(16)
        self._listener.settimeout(0.25)  # the acceptor's stop-poll cadence

    def _start_sentinel(self) -> None:
        """Arm the canary sentinel (correctness plane) when requested.

        Missing/stale goldens disable the sentinel with a loud warning
        rather than failing startup: a daemon that serves real traffic
        but cannot self-verify beats no daemon, and the drill/CI gate is
        where an unverifiable daemon must fail.
        """
        if self.canary_interval_s <= 0:
            return
        from maskclustering_tpu_torch.obs import canary as _canary

        path = self.canary_goldens or _canary.DEFAULT_GOLDENS_PATH
        goldens = _canary.load_goldens(path)
        if goldens is None:
            log.warning("mct-serve: canary sentinel requested but no usable "
                        "goldens at %s — sentinel disabled; python -m "
                        "maskclustering_tpu_torch.tools.load_gen --write-goldens "
                        "regenerates them", path)
            return
        self.sentinel = _canary.CanarySentinel(
            run_round=self.worker.run_canary,
            goldens=goldens, interval_s=self.canary_interval_s,
            # idle = nothing queued; the worker may still be mid-request,
            # which run_canary's handshake waits out at the next idle poll
            is_idle=lambda: self.queue.depth() == 0)
        self.sentinel.start()
        log.info("mct-serve: canary sentinel armed (%d golden coordinate(s),"
                 " every %.1fs)", len(goldens.get("goldens") or {}),
                 self.canary_interval_s)

    def _prewarm(self) -> None:
        """Pay the serving vocabulary's cold dispatches before the first
        request (runs before the worker thread starts, so nothing else
        touches the card meanwhile).

        An active FaultPlan (a serving-path drill) is suspended for the
        duration: warm-up scenes often ARE the drill's target scenes, and
        a plan consumed during warm-up would leave the serving path —
        the thing the drill exists to exercise — fault-free.
        """
        t0 = time.monotonic()
        drill = faults.active_plan()
        faults.set_plan(None)
        try:
            for name, tensors in self.router.warmup_workload():
                self.worker.warm_tensors(name, tensors)
                # continuous batching: the width-S fused step has shapes
                # of its own — pay its cold dispatch here too
                self.worker.warm_batch_executable(name, tensors)
            if self.warm_scenes:
                from maskclustering_tpu_torch.run import cluster_scenes

                statuses = cluster_scenes(self.cfg, list(self.warm_scenes),
                                          resume=False, device=self.device,
                                          prediction_root=self.worker.prediction_root)
                for st in statuses:
                    log.info("mct-serve: warm scene %s -> %s", st.seq_name,
                             st.status)
                self._warm_batch_from_disk()
        finally:
            faults.set_plan(drill)
        self._warmup_s = time.monotonic() - t0
        from maskclustering_tpu_torch.analysis import retrace_sanitizer

        if self.freeze_after_warm and retrace_sanitizer.enabled():
            # the serve-many contract's runtime half: from here on, every
            # new build or launch key is a post-warm violation
            retrace_sanitizer.freeze()
            log.info("mct-serve: retrace sanitizer frozen after warm-up")

    def _warm_batch_from_disk(self) -> None:
        """Classify --warm disk scenes in the router and pay their width-S
        fused cold dispatches (no-op with batching off).

        cluster_scenes warms the single-device path but never touches the
        router, so without this the first live request for a warm scene
        dispatches solo-unclassified AND the first packed batch is cold."""
        if int(getattr(self.cfg, "serve_batch_max", 1) or 1) <= 1:
            return
        from maskclustering_tpu_torch.datasets import get_dataset

        for name in self.warm_scenes:
            try:
                ds = get_dataset(self.cfg.dataset, name,
                                 data_root=self.cfg.data_root)
                tensors = ds.load_scene_tensors(self.cfg.step)
            except Exception:
                log.exception("mct-serve: batch warm skipped for %s", name)
                continue
            self.router.remember(name, self.router.classify_tensors(tensors))
            self.worker.warm_batch_executable(name, tensors)

    def request_stop(self) -> None:
        self._stop.set()

    def stopping(self) -> bool:
        return self._stop.is_set() or faults.stop_requested()

    def serve_forever(self, poll_s: float = 0.2) -> None:
        """Block until a stop is requested (own flag or SIGTERM), then
        drain and shut down."""
        while not self.stopping():
            time.sleep(poll_s)
        self.shutdown()

    def shutdown(self, timeout_s: float = 60.0) -> None:
        """SIGTERM-shaped drain: finish the in-flight request, typed-reject
        the queued ones, join every thread bounded, close the socket."""
        if self._draining.is_set():
            return
        self._draining.set()
        self._stop.set()
        log.info("mct-serve: draining (in-flight request finishes, queued "
                 "requests get typed rejects)")
        if self.sentinel is not None:
            self.sentinel.stop()
        drained_clean = self.worker.stop(timeout_s=timeout_s)
        if not drained_clean:
            log.error("mct-serve: in-flight request outlived the %.0fs "
                      "drain budget; its journal has the in-flight attempt",
                      timeout_s)
        for req in self.queue.drain():
            obs.count("serve.admission.rejects.draining")
            try:
                if req.send is not None:
                    req.send(protocol.reject(
                        "draining", req=req,
                        detail="daemon shutting down before dispatch"))
            except Exception:  # noqa: BLE001 — client gone mid-shutdown
                pass
        # stop sampling AFTER the drain: its final roll puts the drain's
        # rejects on disk as the last telemetry window
        self._ticker.stop()
        if telemetry.installed() is self.aggregator:
            telemetry.install(None)
        self._conns_stop.set()
        if self._acceptor is not None:
            self._acceptor.join(5.0)
        if self._listener is not None:
            try:
                self._listener.close()
            finally:
                self._listener = None
        if self.socket_path and os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass
        with self._lock:
            handlers = list(self._handlers)
        for t in handlers:
            t.join(2.0)
        if self._pruner is not None:
            self._pruner.join(2.0)  # _stop is set: the wait returns now
        if self._wal is not None:
            # after the drain: every terminal (incl. the draining rejects
            # above, which route through the _WalSend wrappers) is on disk
            self._wal.close()
        # cooperative-drain black box (the SIGTERM handler itself is
        # flag-only — CONC.SIGNAL): armed runs keep the daemon's final
        # admission/span history next to any worker-crash dumps
        _flight.record(_flight.KIND_SIGNAL, what="daemon_drained",
                       clean=drained_clean)
        _flight.dump("sigterm" if faults.stop_requested() else "shutdown")
        log.info("mct-serve: shutdown complete (%s)", self.stats()["counts"])

    # -- durability (serve/wal.py) ------------------------------------------

    def _recover_wal(self) -> None:
        """Fold the predecessor daemon's WAL into this one: id-counter
        seed, idem dedupe cache, and the replay of every journaled-but-
        unanswered request back into the admission queue (detached — the
        client re-attaches by resubmitting its idempotency key)."""
        if not self._wal_path:
            return
        state = _wal.read_wal(self._wal_path)
        with self._lock:
            self._ids = max(self._ids, state.max_id)
            self._wal_answered.update(state.answered)
        if state.stats.torn or state.stats.unknown_version:
            log.warning("mct-serve: WAL recovery skipped %d torn / %d "
                        "unknown-version row(s)", state.stats.torn,
                        state.stats.unknown_version)
        if state.rows:
            _wal.compact(self._wal_path, state)
        self._wal = _wal.AdmissionWal(self._wal_path)
        replayed = 0
        submit = getattr(self.worker, "admit", self.queue.submit)
        for rid, doc, idem in state.pending:
            try:
                req = protocol.build_request(dict(doc), rid)
            except (protocol.ProtocolError, KeyError, TypeError,
                    ValueError) as e:
                # a poisoned row must settle, not resurrect every restart
                self._wal.terminal(rid, protocol.reject(
                    "bad_request", detail=f"unreplayable WAL row: {e}"),
                    idem=idem)
                continue
            req.send = _WalSend(self, rid, idem, client=None)
            if idem:
                with self._lock:
                    self._wal_running[idem] = req
            try:
                submit(req)
            except (QuotaReject, QueueFullReject) as e:
                reason = ("queue_full" if isinstance(e, QueueFullReject)
                          else "quota")
                self._wal_terminal(rid, idem, protocol.reject(
                    reason, detail=f"WAL replay re-admission failed: {e}"))
                continue
            replayed += 1
            obs.count("serve.wal.replayed")
        self._wal_replayed = replayed
        if replayed:
            log.warning("mct-serve: replayed %d journaled-but-unanswered "
                        "request(s) from the admission WAL", replayed)

    def _wal_dispatch(self, rid: str) -> None:
        wal = self._wal
        if wal is not None:
            wal.dispatch(rid)

    def _wal_terminal(self, rid: str, idem: str, event: Dict) -> None:
        wal = self._wal
        if wal is not None:
            wal.terminal(rid, event, idem=idem)
        if idem:
            with self._lock:
                self._wal_answered[idem] = dict(event)
                self._wal_running.pop(idem, None)

    def _wal_resubmit(self, req: protocol.SceneRequest, send) -> bool:
        """The idempotency contract: a resubmitted key that already
        answered replays the cached terminal (stamped ``deduped``); one
        still running re-attaches THIS connection to its event stream.
        False = a fresh key, admit normally."""
        with self._lock:
            cached = self._wal_answered.get(req.idem)
            running = self._wal_running.get(req.idem)
        if cached is not None:
            self._wal_deduped += 1
            obs.count("serve.wal.deduped")
            ev = dict(cached)
            ev["deduped"] = True
            if req.tag:
                ev["tag"] = req.tag
            with send.lock:
                send.raw(protocol.ack(req, queue_depth=self.queue.depth()))
                send.raw(ev)
            return True
        if running is not None:
            wrapper = running.send
            if isinstance(wrapper, _WalSend):
                wrapper.client = send
            self._wal_reattached += 1
            obs.count("serve.wal.reattached")
            # the running request may have answered between the lookup
            # and the re-attach: replay the terminal to this connection
            # (a racing duplicate line is harmless — the client stops at
            # its first terminal)
            with self._lock:
                cached = self._wal_answered.get(req.idem)
            with send.lock:
                send.raw(protocol.ack(running,
                                      queue_depth=self.queue.depth()))
                if cached is not None:
                    ev = dict(cached)
                    ev["deduped"] = True
                    send.raw(ev)
            return True
        return False

    def _wal_abort(self, req: Optional[protocol.SceneRequest],
                   event: Dict) -> None:
        """An admission that WAL-journaled but failed to enqueue (quota /
        queue_full raised at submit) settles with the reject as its
        terminal row — replay must not resurrect it."""
        if req is not None and isinstance(req.send, _WalSend):
            self._wal_terminal(req.id, req.idem, event)

    def _prune_retention(self) -> None:
        """Retention pass: settled per-request journals and finished
        streams' snapshots age out under the serve_journal_keep /
        serve_journal_max_age_s knobs (the WAL itself is skipped by
        name; prune_dir's freshness floor protects live state)."""
        keep = int(self.cfg.serve_journal_keep or 0)
        age = float(self.cfg.serve_journal_max_age_s or 0.0)
        removed = 0
        if self.journal_dir:
            removed += _wal.prune_dir(self.journal_dir, keep=keep,
                                      max_age_s=age, suffixes=(".jsonl",))
        if self.stream_state_dir:
            removed += _wal.prune_dir(self.stream_state_dir, keep=keep,
                                      max_age_s=age,
                                      suffixes=(".stream.npz",))
        if removed:
            with self._lock:
                self._journals_pruned += removed
            obs.count("serve.journals_pruned", removed)
            log.info("mct-serve: retention pruned %d journal/snapshot "
                     "file(s)", removed)

    def _start_pruner(self) -> None:
        interval = float(self.cfg.serve_prune_interval_s or 0.0)
        if interval <= 0 or not (self.journal_dir or self.stream_state_dir):
            return

        def _loop() -> None:
            while not self._stop.wait(interval):
                self._prune_retention()

        self._pruner = threading.Thread(  # mct-thread: abandon(daemon-lifetime retention timer, bounded-joined in shutdown(); the spawn/join pair spans methods, which the scope-local check cannot see)
            target=_loop, daemon=True, name="serve-pruner")
        self._pruner.start()

    # -- socket front -------------------------------------------------------

    def _accept_loop(self) -> None:
        # polls the DAEMON's stop flag, not the process-global SIGTERM
        # flag: only serve_forever()/shutdown() translate a SIGTERM into
        # a daemon stop, so an embedding process (tests, a future
        # multi-daemon host) can field signals without killing acceptors
        while not self._stop.is_set():
            listener = self._listener
            if listener is None:
                break
            try:
                conn, _addr = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # listener closed under us: shutdown in progress
            t = threading.Thread(  # mct-thread: abandon(per-connection reader, bounded-joined in shutdown(); clients may hold connections open for the daemon's lifetime)
                target=self._handle_conn, args=(conn,), daemon=True,
                name="serve-conn")
            with self._lock:
                self._handlers = [h for h in self._handlers
                                  if h.is_alive()] + [t]
            t.start()

    def _handle_conn(self, conn: socket.socket) -> None:
        send = _make_sender(conn)
        buf = b""
        conn.settimeout(0.5)
        try:
            while not self._conns_stop.is_set():
                try:
                    chunk = conn.recv(65536)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    try:
                        self._handle_line(send,
                                          line.decode("utf-8", "replace"))
                    except OSError:
                        # the client hung up before its answer (an aborted
                        # probe, a dead load-gen thread): admitted work
                        # still runs and journals; only this connection dies
                        return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _next_id(self) -> str:
        with self._lock:
            self._ids += 1
            return f"r-{self._ids:06d}"

    def _handle_line(self, send, line: str) -> None:
        if not line.strip():
            return
        tag = ""
        req: Optional[protocol.SceneRequest] = None
        try:
            doc = protocol.parse_line(line)
            tag = str(doc.get("tag", ""))
            op = doc["op"]
            if op == "status":
                doc_stats = self.stats()
                detail = doc.get("detail")
                if detail in ("telemetry", "slo"):
                    doc_stats["telemetry"] = self.aggregator.snapshot()
                if detail == "slo":
                    doc_stats["slo"] = _slo.evaluate(
                        self.slo_spec, doc_stats["telemetry"])
                if detail == "sentinel":
                    doc_stats["sentinel"] = (
                        self.sentinel.stats() if self.sentinel is not None
                        else {"armed": False})
                send({"v": protocol.PROTOCOL_VERSION, "kind": "stats",
                      **doc_stats})
                return
            if op == "shutdown":
                send({"v": protocol.PROTOCOL_VERSION, "kind": "ack",
                      "op": "shutdown"})
                self.request_stop()
                return
            if self._draining.is_set() or self._stop.is_set():
                obs.count("serve.admission.rejects.draining")
                send(protocol.reject("draining", tag=tag,
                                     detail="daemon is shutting down"))
                return
            if op == "recarve":
                # pool admin op: drain + respawn under a new carve while
                # admission keeps queueing. Blocks THIS connection's
                # handler (the carve wall is the answer's payload); other
                # connections keep admitting throughout
                if not hasattr(self.worker, "recarve"):
                    raise protocol.ProtocolError(
                        "recarve needs a worker pool (serve_workers > 1)")
                try:
                    out = self.worker.recarve(
                        workers=int(doc.get("workers", 0) or 0),
                        carve=str(doc.get("carve", "") or ""))
                except (ValueError, RuntimeError) as e:
                    send({"v": protocol.PROTOCOL_VERSION, "kind": "recarve",
                          "ok": False, "error": str(e), **({"tag": tag}
                                                           if tag else {})})
                    return
                send({"v": protocol.PROTOCOL_VERSION, "kind": "recarve",
                      **out, **({"tag": tag} if tag else {})})
                return
            if doc.get("synthetic") is not None \
                    and self.cfg.dataset != "scannet":
                raise protocol.ProtocolError(
                    "inline synthetic scenes need a scannet-layout config "
                    f"(daemon dataset is {self.cfg.dataset!r})")
            if doc.get("deadline_s", 0) == 0 and self.default_deadline_s > 0:
                doc["deadline_s"] = self.default_deadline_s
            req = protocol.build_request(doc, self._next_id())
            req.send = send
            if self._wal is not None:
                if req.idem and self._wal_resubmit(req, send):
                    return  # answered from cache, or re-attached live
                # crash-safe admission: the admit row hits disk BEFORE
                # the queue, so a daemon killed between them resurrects
                # (never loses) the request at the next start()
                req.send = _WalSend(self, req.id, req.idem, client=send)
                if req.idem:
                    with self._lock:
                        self._wal_running[req.idem] = req
                self._wal.admit(req.id, doc, idem=req.idem)
            # the chaos drill's daemon-death seam: a `die` FaultPlan entry
            # SIGKILLs THIS process here — after the WAL admit, before
            # the queue — the worst torn state recovery must survive
            faults.inject("admission", req.scene)
            # submit + ack under the connection's send lock: the worker's
            # first event for this request serializes AFTER the ack. A
            # pool worker gates admission through its tenant quotas
            # (pool.admit raises the typed QuotaReject below)
            submit = getattr(self.worker, "admit", self.queue.submit)
            with send.lock:
                depth = submit(req)
                send.raw(protocol.ack(req, queue_depth=depth))
        except protocol.ProtocolError as e:
            obs.count("serve.admission.rejects.bad_request")
            send(protocol.reject("bad_request", detail=str(e), tag=tag))
            return
        except QueueFullReject as e:
            telemetry.record_reject(str(doc.get("tenant", "")))
            if not self._capacity_dumped.is_set():
                # first capacity error per process: what the admission
                # plane looked like when backpressure began (later
                # queue_full rejects are ordinary backpressure, not news)
                self._capacity_dumped.set()
                _flight.dump("capacity")
            ev = protocol.reject(
                "queue_full", tag=tag,
                detail=f"{e.depth}/{e.capacity} queued; retry with backoff")
            self._wal_abort(req, ev)
            send(ev)
        except QuotaReject as e:
            telemetry.record_reject(str(doc.get("tenant", "")))
            ev = protocol.reject(
                "quota", tag=tag,
                detail=f"tenant {e.tenant!r} at its queued-request quota "
                       f"({e.queued}/{e.limit}); retry after completions")
            self._wal_abort(req, ev)
            send(ev)

    # -- introspection ------------------------------------------------------

    def stats(self) -> Dict:
        w = self.worker.stats()
        # builds and launches happen in the worker subprocess: its
        # ready/bye digest, not this process's
        from maskclustering_tpu_torch.analysis import retrace_sanitizer

        retrace: Dict = {}
        if self.isolate_worker:
            retrace = self.worker.child_retrace()
        elif retrace_sanitizer.enabled():
            retrace = retrace_sanitizer.summary()
        return {
            "config": self.cfg.config_name,
            # perf-attribution coordinate (ledger serve rows + --regress
            # knob-flip advisory): a resharded daemon's latency profile is
            # the knob's, not code drift's
            "point_shards": int(self.cfg.point_shards),
            "streaming_chunk": int(self.cfg.streaming_chunk),
            "uptime_s": round(time.monotonic() - self._started_at, 2)
            if self._started_at else 0.0,
            "warmup_s": round(self._warmup_s, 2),
            "queue": {"depth": self.queue.depth(),
                      "capacity": self.queue.capacity,
                      "high_water": self.queue.high_water,
                      "admitted": self.queue.admitted},
            "counts": w["counts"],
            "latency": w["latency"],
            "warm_buckets": [list(b) for b in w["warm_buckets"]],
            "retrace": retrace,
            # drift-plane summary for load_gen verdicts + serve ledger
            # stamping (full matrix behind the "sentinel" status detail)
            "canary": ({"rounds": self.sentinel.stats()["rounds"],
                        "drift_total": self.sentinel.stats()["drift_total"]}
                       if self.sentinel is not None else None),
            "draining": self._draining.is_set(),
            # the durability plane (serve/wal.py): WAL replay/dedupe and
            # retention evidence — the chaos drill's verdict reads these
            "durable": {"wal": self._wal is not None
                        or bool(self._wal_path),
                        "wal_replayed": self._wal_replayed,
                        "wal_deduped": self._wal_deduped,
                        "wal_reattached": self._wal_reattached,
                        "journals_pruned": self._journals_pruned},
            # the packing scheduler's occupancy digest (in-thread worker
            # only; under isolation the CHILD packs and its serve.batch.*
            # counters relay up via telemetry instead)
            **({"batch": w["batch"]} if "batch" in w else {}),
            **({"worker": w["worker"]} if "worker" in w else {}),
            # the pool plane (serve/pool.py): per-slice liveness/warmth,
            # scheduler affinity/share accounting, tenant QoS table
            **({"pool": w["pool"]} if "pool" in w else {}),
        }

    def emit_serve_counters(self) -> None:
        """Book the serving digest on the obs registry (the report's
        Serving section renders from these; call before flush/shutdown)."""
        lat = self.worker.latency_quantiles()
        if lat["p50_s"] is not None:
            obs.gauge("serve.request_p50_s", lat["p50_s"])
            obs.gauge("serve.request_p95_s", lat["p95_s"])
        obs.gauge("serve.queue_depth_high_water",
                  float(self.queue.high_water))
        obs.gauge("serve.warm_buckets", float(len(self.router.warm_buckets())))
        batch = getattr(self.worker, "batch_stats", lambda: None)()
        if batch and batch.get("dispatches"):
            obs.gauge("serve.batch_occupancy", float(batch["occupancy"]))
