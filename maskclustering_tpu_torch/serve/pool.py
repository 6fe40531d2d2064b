"""mct-pool: multi-worker serving — one daemon, every card (the port's
copy of ``maskclustering_tpu/serve/pool.py``).

The supervisor (serve/supervisor.py) runs exactly ONE card-owning
subprocess. ``WorkerPool`` carves the cards into K slices (``cfg.
serve_workers`` + the ``serve_carve`` "KxC" spec: K slices of C cards
each, every slice's child pinned to its cards through
``CUDA_VISIBLE_DEVICES``) and runs one FULL WorkerSupervisor per slice —
each with its own heartbeat-silence SIGKILL, bounded respawn and
crash-containment ladder. Without a carve every slice sees the whole
backend, so on one card the slices share it (each child holds its own
context and allocator there, and they contend for the card). On the CPU
no variable is set: a CPU child's mesh repeats ``cpu``. The single-
consumer dequeue becomes a scheduler thread with three planes:

- **bucket affinity** — requests route to a slice already warm for
  their (k_max, f_pad, n_pad) bucket; a cold bucket routes least-loaded
  (and marks that slice warm for its successors).
- **weighted-fair tenant QoS** — per-tenant sub-queues drained by
  virtual-time stride scheduling (``vt += 1/weight``): a 3:1 weight
  ratio yields ~3:1 dispatches under saturation, and every weight > 0
  tenant is starvation-bounded by construction. Optional per-tenant
  quotas bound QUEUED (admitted, pre-dispatch) requests — exceeding one
  answers a typed ``quota`` reject at admission. Spec grammar:
  ``config.parse_tenant_spec`` ("name:weight[:quota],...").
- **per-slice continuous batching** — each slice's supervisor drains
  its own feed queue with ``next_batch`` packing, so same-bucket company
  fuses per slice exactly as in the single-worker topology.

Crash containment composes rather than changes: a slice crash requeues
its victims through ``_FeedQueue.requeue`` back into the POOL, which
reroutes them to a bucket-warm NEIGHBOR (the respawn still happens, but
the victim does not wait for it). Stream sessions are slice-local, so
stream ops pin to their owner slice (``_stream_owner``) — but when a
shared ``stream_state_dir`` holds a per-chunk snapshot, a stream whose
owner died re-opens on a SURVIVING slice from the snapshot instead of
answering the typed ``stream_lost`` (which remains the fallback when no
snapshot exists). ``recarve`` drains every slice and respawns under a
new carve while admission keeps queueing.

The parent stays device-free: ``torch.cuda.device_count()`` counts the
cards for ``check_carve`` without creating a context.

The pool exposes the ServeWorker/WorkerSupervisor surface (start/stop/
wait_idle/stats/latency_quantiles/run_canary/child_retrace/busy) so
``ServeDaemon`` swaps topologies with one constructor choice.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Deque, Dict, List, Optional, Set, Tuple

import torch

from maskclustering_tpu_torch import obs
from maskclustering_tpu_torch.analysis.lock_sanitizer import mct_lock
from maskclustering_tpu_torch.config import parse_carve_spec, parse_tenant_spec
from maskclustering_tpu_torch.device import DeviceLike
from maskclustering_tpu_torch.serve import protocol
from maskclustering_tpu_torch.serve.admission import AdmissionQueue, QueueFullReject
from maskclustering_tpu_torch.serve.router import Router
from maskclustering_tpu_torch.serve.supervisor import WorkerSupervisor
from maskclustering_tpu_torch.serve.worker import _send

log = logging.getLogger("maskclustering_tpu_torch")

STREAM_OPS = ("stream_chunk", "stream_end")


class QuotaReject(Exception):
    """Typed admission reject: the tenant's queued-request quota is full."""

    def __init__(self, tenant: str, limit: int, queued: int):
        self.tenant = tenant
        self.limit = limit
        self.queued = queued
        super().__init__(
            f"tenant {tenant!r} quota full ({queued}/{limit} queued)")


def check_carve(workers: int, chips: int,
                device_product: Optional[int]) -> None:
    """Reject a carve that does not divide the device product (typed).

    ``chips == 0`` means "no carve — every slice sees the whole backend"
    and ``device_product is None`` means the backend is not inspectable
    from this process (CPU slices repeat the CPU as their devices); both
    skip the check.
    """
    if chips <= 0 or device_product is None:
        return
    total = workers * chips
    if total > device_product or device_product % total != 0:
        raise ValueError(
            f"serve_carve {workers}x{chips} needs {total} chips but the "
            f"backend has {device_product}; the carve product must divide "
            f"the device product")


class _FeedQueue(AdmissionQueue):
    """One slice's dispatch buffer: unmetered (the POOL's queue is the
    admission layer), sized to hold a full batch, and its ``requeue`` —
    the supervisor's crash path — hands the victim back to the pool so
    it reroutes to a warm NEIGHBOR instead of waiting out the respawn."""

    def __init__(self, pool: "WorkerPool", worker_id: int, capacity: int):
        super().__init__(capacity=capacity, metered=False)
        self._pool = pool
        self._worker_id = worker_id

    def requeue(self, req: protocol.SceneRequest) -> bool:
        return self._pool._requeue_from_worker(self._worker_id, req)

    def put_direct(self, req: protocol.SceneRequest) -> bool:
        """The base put-back (pool-internal: crash reroute INTO a feed)."""
        return AdmissionQueue.requeue(self, req)


class WorkerPool:
    """K supervised card slices behind one affinity/QoS scheduler.

    The JAX pool's signature, plus ``device``: every child's torch device
    (None: the CUDA card). ``freeze_after_warm`` goes to every slice.
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
                 device: DeviceLike = None):
        self.cfg = cfg
        # a name only: torch.device() of a string creates no context
        self.device = torch.device("cuda" if device is None else device)
        self.queue = queue
        self.router = router
        self.journal_dir = journal_dir
        self.prediction_root = prediction_root
        self.stream_state_dir = stream_state_dir
        self.warm_scenes = tuple(warm_scenes)
        self.warm_baseline = warm_baseline
        self.freeze_after_warm = bool(freeze_after_warm)
        self.fault_plan_spec = fault_plan_spec
        self.child_argv = child_argv
        self.start_timeout_s = float(start_timeout_s)
        self.poll_s = poll_s
        self.on_fatal = on_fatal
        self.workers = max(int(cfg.serve_workers), 1)
        carve = str(cfg.serve_carve or "")
        self.chips = parse_carve_spec(carve)[1] if carve else 0
        self._qos = parse_tenant_spec(str(cfg.serve_tenants or ""))
        self._lock = mct_lock("serve.WorkerPool._lock")
        self._stop = threading.Event()
        self._pause = threading.Event()  # recarve: dispatch suspended
        self._sched: Optional[threading.Thread] = None
        self._sups: List[WorkerSupervisor] = []
        self._feeds: List[_FeedQueue] = []
        self._dead: Set[int] = set()
        # per-slice warm-bucket shadow (the affinity plane): seeded from
        # the shared vocabulary every child warms at spawn, grown
        # optimistically at dispatch (the slice is warm for the bucket by
        # the time its successor routes)
        self._warm: List[Set[tuple]] = []
        # weighted-fair state: per-tenant FIFO sub-queues + virtual time
        self._subq: Dict[str, Deque[protocol.SceneRequest]] = {}
        self._vt: Dict[str, float] = {}
        self._gvt = 0.0
        # quota accounting: queued (admitted, pre-dispatch) per tenant;
        # _counted holds the request ids the admit() path incremented so
        # crash requeues (exempt) never double-decrement
        self._tenant_queued: Dict[str, int] = {}
        self._counted: Set[str] = set()
        # stream ops pin to the slice holding their device-resident
        # session; a retired (fatal) owner answers a typed stream_lost
        self._stream_owner: Dict[str, int] = {}
        # scheduler accounting (stats + the Serving report's share lines)
        self._dispatched = 0
        self._by_tenant: Dict[str, int] = {}
        self._by_worker: Dict[int, int] = {}
        self._affinity_hits = 0
        self._affinity_misses = 0
        self._crash_reroutes = 0
        self._recarves = 0
        # recarve retires whole slices: their request/crash history folds
        # into these baselines so the daemon's counts survive the carve
        self._retired_counts: Dict[str, int] = {}
        self._retired_worker = {"spawns": 0, "respawns": 0, "crashes": 0,
                                "streams_resumed": 0}
        self._retired_latencies: List[float] = []

    # -- carve plumbing ------------------------------------------------------

    def _device_product(self) -> Optional[int]:
        """The cards this process can see (``torch.cuda.device_count``,
        which creates no context); None on the CPU, whose slices repeat
        the CPU and need no carve check."""
        if self.device.type != "cuda":
            return None
        try:
            return torch.cuda.device_count()
        except Exception:  # noqa: BLE001 — no driver in this process
            return None

    def _child_env(self, worker_id: int) -> Optional[Dict[str, str]]:
        """The slice's card carve, as a child-process env overlay."""
        if self.chips <= 0 or self.device.type != "cuda":
            return None
        lo = worker_id * self.chips
        return {"CUDA_VISIBLE_DEVICES":
                ",".join(str(c) for c in range(lo, lo + self.chips))}

    def _feed_capacity(self) -> int:
        # a slice's buffer holds one full pack plus margin, mirroring the
        # child's own local queue (worker_main.py)
        return max(2, int(getattr(self.cfg, "serve_batch_max", 1)) + 1)

    def _build_slices(self) -> None:
        seed = self.router.warm_buckets() | self.router.vocabulary_buckets()
        self._feeds = [_FeedQueue(self, i, self._feed_capacity())
                       for i in range(self.workers)]
        self._sups = [
            WorkerSupervisor(
                self.cfg, self._feeds[i], self.router,
                journal_dir=self.journal_dir,
                prediction_root=self.prediction_root,
                stream_state_dir=self.stream_state_dir,
                warm_scenes=self.warm_scenes,
                warm_baseline=self.warm_baseline,
                freeze_after_warm=self.freeze_after_warm,
                # drills target slice 0 only: the drill is one fault, not
                # a fleet-wide crash storm
                fault_plan_spec=self.fault_plan_spec if i == 0 else None,
                child_argv=self.child_argv,
                start_timeout_s=self.start_timeout_s,
                poll_s=self.poll_s,
                on_fatal=(lambda wid=i: self._slice_fatal(wid)),
                worker_id=i, pooled=True,
                child_env=self._child_env(i),
                device=self.device)
            for i in range(self.workers)]
        self._dead = set()
        self._warm = [set(seed) for _ in range(self.workers)]

    def _start_slices(self) -> None:
        """Spawn every slice concurrently (K children warm in parallel —
        K serial warm walls would stack)."""
        errors: List[str] = []

        def _one(sup: WorkerSupervisor) -> None:
            try:
                sup.start()
            except Exception as e:  # noqa: BLE001 — collected, re-raised
                errors.append(f"worker {sup.worker_id}: {e}")

        threads = []
        for s in self._sups:
            t = threading.Thread(target=_one, args=(s,), daemon=True,
                                 name=f"pool-start-{s.worker_id}")
            threads.append(t)
            t.start()
        for t in threads:
            t.join(self.start_timeout_s + 30.0)
        if errors or any(t.is_alive() for t in threads):
            for s in self._sups:
                try:
                    s.stop(timeout_s=5.0)
                except Exception:  # noqa: BLE001
                    pass
            raise RuntimeError(
                "worker pool failed to start: " + "; ".join(errors or
                                                            ["spawn hung"]))

    # -- lifecycle (ServeWorker surface) ------------------------------------

    def start(self) -> None:
        if self._sched is not None:
            return
        check_carve(self.workers, self.chips, self._device_product())
        self._build_slices()
        self._start_slices()
        self._sched = threading.Thread(  # mct-thread: abandon(daemon-lifetime scheduler, bounded-joined in stop(); the spawn/join pair spans methods)
            target=self._schedule, daemon=True, name="pool-scheduler")
        self._sched.start()

    def stop(self, timeout_s: float = 60.0) -> bool:
        # drain what was admitted (scheduler still routing), THEN stop
        idle = self.wait_idle(timeout_s)
        self._stop.set()
        t = self._sched
        if t is not None:
            t.join(10.0)
        oks: List[bool] = []

        def _one(sup: WorkerSupervisor) -> None:
            oks.append(sup.stop(timeout_s=timeout_s))

        threads = []
        for s in self._sups:
            th = threading.Thread(target=_one, args=(s,), daemon=True,
                                  name=f"pool-stop-{s.worker_id}")
            threads.append(th)
            th.start()
        for th in threads:
            th.join(timeout_s + 15.0)
        # anything still undispatched answers the drain's typed reject
        leftovers: List[protocol.SceneRequest] = []
        with self._lock:
            for dq in self._subq.values():
                leftovers.extend(dq)
                dq.clear()
        for feed in self._feeds:
            leftovers.extend(feed.drain())
        for req in leftovers:
            obs.count("serve.admission.rejects.draining")
            _send(req, protocol.reject(
                "draining", req=req,
                detail="daemon shutting down before dispatch"))
        return idle and len(oks) == len(self._sups) and all(oks)

    def wait_idle(self, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                pending = sum(len(dq) for dq in self._subq.values())
            if self.queue.depth() == 0 and pending == 0 \
                    and all(f.depth() == 0 for f in self._feeds) \
                    and not any(s.busy() for s in self._sups):
                return True
            time.sleep(0.01)
        return False

    def busy(self) -> bool:
        return any(s.busy() for s in self._sups)

    # -- admission (the daemon's quota gate) --------------------------------

    def admit(self, req: protocol.SceneRequest) -> int:
        """Quota-gated admission: the daemon submits through the pool so
        a tenant at its queued-request bound answers a typed ``quota``
        reject BEFORE consuming a queue slot. Raises QuotaReject or the
        queue's own QueueFullReject; returns the post-admission depth."""
        tenant = req.tenant
        limit = self._qos.get(tenant, (1.0, None))[1]
        depth = 0
        with self._lock:
            queued = self._tenant_queued.get(tenant, 0)
            over = limit is not None and queued >= limit
            if not over:
                depth = self.queue.submit(req)  # may raise QueueFullReject
                self._tenant_queued[tenant] = queued + 1
                self._counted.add(req.id)
        if over:
            obs.count("serve.admission.rejects.quota")
            raise QuotaReject(tenant, limit, queued)
        return depth

    # -- the scheduler -------------------------------------------------------

    def _schedule(self) -> None:
        while not self._stop.is_set():
            if self._pause.is_set():
                time.sleep(0.02)
                continue
            self._drain_admission()
            tenant = self._pick_tenant()
            if tenant is None:
                continue
            with self._lock:
                dq = self._subq.get(tenant)
                req = dq[0] if dq else None
            if req is None:
                continue
            outcome = self._try_dispatch(req)
            if outcome == "no_room":
                # every routable feed is full: hold the head, let slices
                # drain (bounded spin; admission keeps queueing behind)
                time.sleep(0.005)
                continue
            with self._lock:
                dq = self._subq.get(tenant)
                if dq and dq[0] is req:
                    dq.popleft()
                w = self._qos.get(tenant, (1.0, None))[0]
                self._vt[tenant] = self._vt.get(tenant, self._gvt) + 1.0 / w
                self._gvt = self._vt[tenant]

    def _drain_admission(self) -> None:
        """Move admitted requests into their tenant sub-queues. Blocks
        one poll interval only when nothing is pending (the scheduler's
        stop-flag poll), else drains what is there and returns."""
        with self._lock:
            pending = any(self._subq.values())
        req = self.queue.next(timeout_s=0.0 if pending else self.poll_s)
        while req is not None:
            with self._lock:
                dq = self._subq.setdefault(req.tenant, collections.deque())
                if not dq:
                    # a tenant (re)entering the rotation starts at the
                    # pool's virtual time — an idle spell is not credit
                    self._vt[req.tenant] = max(
                        self._vt.get(req.tenant, 0.0), self._gvt)
                dq.append(req)
            req = self.queue.next(timeout_s=0.0)

    def _pick_tenant(self) -> Optional[str]:
        with self._lock:
            candidates = [(self._vt.get(t, self._gvt), t)
                          for t, dq in self._subq.items() if dq]
        if not candidates:
            return None
        return min(candidates)[1]

    def _alive(self, exclude: Optional[int] = None) -> List[int]:
        with self._lock:
            dead = set(self._dead)
        return [i for i in range(len(self._sups))
                if i not in dead and i != exclude]

    def _load(self, i: int) -> int:
        return self._feeds[i].depth() + (1 if self._sups[i].busy() else 0)

    def _route(self, req: protocol.SceneRequest,
               exclude: Optional[int] = None) -> Tuple[str, Optional[int]]:
        """One routing decision: ("dispatch"|"no_room"|"lost", slice).

        Streams pin to their owner slice (sessions are slice-local);
        scene ops route bucket-warm first, least-loaded on a cold bucket.
        """
        alive = self._alive(exclude)
        if not alive and exclude is not None:
            alive = self._alive()  # a 1-slice pool reroutes to itself
        if not alive:
            return ("no_room", None)
        if req.op in STREAM_OPS:
            owner = self._stream_owner.get(req.scene)
            if owner is not None:
                with self._lock:
                    owner_dead = owner in self._dead
                if (owner_dead or owner == exclude) \
                        and self._stream_resumable(req.scene):
                    # snapshot failover: the owner slice died (retired,
                    # or is the crashed slice this reroute excludes) but
                    # a per-chunk snapshot exists — re-open the session
                    # on a surviving warm slice; its child resumes the
                    # accumulator from disk (_book_dispatch re-pins)
                    room = [i for i in alive if self._has_room(i)]
                    if not room:
                        return ("no_room", None)
                    return ("dispatch", min(room, key=self._load))
                if owner_dead:
                    return ("lost", owner)
                if self._has_room(owner):
                    return ("dispatch", owner)
                return ("no_room", None)
            # a NEW stream: open it on the least-loaded slice
            room = [i for i in alive if self._has_room(i)]
            if not room:
                return ("no_room", None)
            return ("dispatch", min(room, key=self._load))
        room = [i for i in alive if self._has_room(i)]
        if not room:
            return ("no_room", None)
        bucket = self.router.bucket_for(req.scene)
        if bucket is not None:
            warm = [i for i in room if bucket in self._warm[i]]
            if warm:
                return ("dispatch", min(warm, key=self._load))
        return ("dispatch", min(room, key=self._load))

    def _has_room(self, i: int) -> bool:
        return self._feeds[i].depth() < self._feeds[i].capacity

    def _stream_resumable(self, scene: str) -> bool:
        """A per-chunk snapshot exists for this scene's stream: the
        session can re-open on another slice from disk."""
        if not self.stream_state_dir:
            return False
        from maskclustering_tpu_torch.models.streaming import stream_state_path
        try:
            return os.path.exists(
                stream_state_path(self.stream_state_dir, scene))
        except OSError:
            return False

    def _try_dispatch(self, req: protocol.SceneRequest) -> str:
        verdict, wid = self._route(req)
        if verdict == "no_room":
            return "no_room"
        if verdict == "lost":
            self._answer_retired_stream(req, wid)
            return "answered"
        try:
            self._feeds[wid].submit(req)
        except QueueFullReject:
            return "no_room"  # racing dispatch filled the slot; re-route
        self._book_dispatch(req, wid)
        return "dispatched"

    def _book_dispatch(self, req: protocol.SceneRequest, wid: int) -> None:
        bucket = self.router.bucket_for(req.scene)
        hit: Optional[bool] = None
        with self._lock:
            if req.id in self._counted:
                self._counted.discard(req.id)
                t = req.tenant
                self._tenant_queued[t] = max(
                    0, self._tenant_queued.get(t, 0) - 1)
            self._dispatched += 1
            self._by_tenant[req.tenant] = \
                self._by_tenant.get(req.tenant, 0) + 1
            self._by_worker[wid] = self._by_worker.get(wid, 0) + 1
            if req.op in STREAM_OPS:
                self._stream_owner[req.scene] = wid
            if bucket is not None:
                hit = bucket in self._warm[wid]
                if hit:
                    self._affinity_hits += 1
                else:
                    self._affinity_misses += 1
                    # optimistic warmth: the slice warms this bucket
                    # now; its successors are warm
                    self._warm[wid].add(bucket)
        if hit is not None:
            obs.count("serve.pool.affinity_hits" if hit
                      else "serve.pool.affinity_misses")
        obs.count("serve.pool.dispatched")

    def _answer_retired_stream(self, req: protocol.SceneRequest,
                               owner: int) -> None:
        """The slice holding this stream's session exhausted its respawn
        budget and retired — the session is unrecoverable. Typed loss,
        owner cleared so a restarted stream opens fresh elsewhere."""
        with self._lock:
            self._stream_owner.pop(req.scene, None)
        obs.count("serve.requests")
        obs.count("serve.streams_lost")
        obs.count("serve.requests_failed")
        _send(req, protocol.status(
            req, "stream_lost",
            detail=f"owner worker {owner} retired (respawn budget "
                   f"exhausted)"))
        _send(req, protocol.result(
            req, "failed",
            error=f"stream session for {req.scene!r} lost: owner worker "
                  f"{owner} retired",
            error_class="stream_lost"))

    # -- crash rerouting -----------------------------------------------------

    def _requeue_from_worker(self, worker_id: int,
                             req: protocol.SceneRequest) -> bool:
        """A slice's supervisor hands back a crash victim (or its stop
        path hands back undispatched work): reroute to a warm NEIGHBOR
        immediately — the victim must not wait out the respawn wall."""
        if self._stop.is_set():
            return False  # the supervisor answers its own draining reject
        verdict, wid = self._route(req, exclude=worker_id)
        if verdict == "dispatch" and wid is not None \
                and self._feeds[wid].put_direct(req):
            with self._lock:
                self._crash_reroutes += 1
                self._by_worker[wid] = self._by_worker.get(wid, 0) + 1
                if req.op in STREAM_OPS:
                    self._stream_owner[req.scene] = wid
            obs.count("serve.pool.crash_reroutes")
            log.info("worker pool: rerouted %s from worker %d to %d",
                     req.id, worker_id, wid)
            return True
        # no warm neighbor with room right now: back to the main queue,
        # the scheduler re-routes it on its next pass
        return self.queue.requeue(req)

    def _slice_fatal(self, worker_id: int) -> None:
        """One slice exhausted its respawn budget: retire it, reroute its
        queued work, and only when EVERY slice is dead declare the pool
        (and daemon) unserveable."""
        with self._lock:
            self._dead.add(worker_id)
            dead = len(self._dead)
        obs.count("serve.pool.workers_retired")
        log.error("worker pool: worker %d retired (respawn budget "
                  "exhausted); %d/%d slices remain", worker_id,
                  len(self._sups) - dead, len(self._sups))
        for req in self._feeds[worker_id].drain():
            if req.op in STREAM_OPS and not self._stream_resumable(req.scene):
                self._answer_retired_stream(req, worker_id)
            elif not self.queue.requeue(req):
                obs.count("serve.requests_failed")
                _send(req, protocol.result(
                    req, "failed",
                    error=f"worker {worker_id} retired and the queue is "
                          f"full", error_class="device"))
        if dead >= len(self._sups) and self.on_fatal is not None:
            try:
                self.on_fatal()
            except Exception:  # noqa: BLE001
                log.exception("worker pool: on_fatal callback failed")

    # -- recarve -------------------------------------------------------------

    def recarve(self, workers: int = 0, carve: str = "",
                timeout_s: float = 300.0) -> Dict:
        """Drain every slice and respawn under a new carve. Admission
        keeps queueing the whole time (dispatch pauses); the new slices
        warm up as the first ones did.
        """
        if not workers and not carve:
            raise ValueError("recarve needs 'workers' and/or 'carve'")
        chips = self.chips
        if carve:
            workers_spec, chips = parse_carve_spec(carve)
            if workers and workers != workers_spec:
                raise ValueError(
                    f"recarve workers={workers} contradicts carve "
                    f"{carve!r} (K={workers_spec})")
            workers = workers_spec
        check_carve(workers, chips, self._device_product())
        t0 = time.monotonic()
        self._pause.set()
        try:
            drained = self._wait_slices_idle(timeout_s)
            if not drained:
                raise RuntimeError(
                    "recarve: slices did not drain within "
                    f"{timeout_s:.0f}s; carve unchanged")
            for sup in self._sups:
                # stop FIRST: a drained slice may still be booking its
                # last result's counts — a stopped one is quiesced
                sup.stop(timeout_s=timeout_s)
                retired = sup.stats()
                for k, v in retired["counts"].items():
                    self._retired_counts[k] = \
                        self._retired_counts.get(k, 0) + v
                for k in self._retired_worker:
                    self._retired_worker[k] += retired["worker"][k]
                self._retired_latencies.extend(sup._latencies)
                del self._retired_latencies[:-512]  # bounded history
            self.workers = workers
            self.chips = chips
            new_carve = f"{workers}x{chips}" if chips else ""
            self.cfg = self.cfg.replace(serve_workers=workers,
                                        serve_carve=new_carve)
            self._build_slices()
            self._start_slices()
            with self._lock:
                self._recarves += 1
                # sessions died with the old slices; an owner-less stream
                # op routes as a new stream and the fresh child resumes
                # from its per-chunk snapshot when one exists
                self._stream_owner.clear()
        finally:
            self._pause.clear()
        obs.count("serve.pool.recarves")
        wall = time.monotonic() - t0
        log.info("worker pool: recarved to %dx%s in %.1fs", workers,
                 chips or "all", wall)
        return {"ok": True, "workers": workers,
                "carve": f"{workers}x{chips}" if chips else "",
                "seconds": round(wall, 2)}

    def _wait_slices_idle(self, timeout_s: float) -> bool:
        """In-flight + fed work finishes; the MAIN queue may keep filling
        (that is the point: recarve does not reject admissions)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(f.depth() == 0 for f in self._feeds) \
                    and not any(s.busy() for s in self._sups):
                return True
            time.sleep(0.02)
        return False

    # -- introspection (ServeWorker surface) --------------------------------

    def latency_quantiles(self) -> Dict[str, Optional[float]]:
        from maskclustering_tpu_torch.obs.report import percentile

        vals: List[float] = list(self._retired_latencies)
        for sup in self._sups:
            vals.extend(sup._latencies)  # package-internal raw deque
        vals.sort()
        if not vals:
            return {"p50_s": None, "p95_s": None, "count": 0}
        return {"p50_s": round(percentile(vals, 50), 4),
                "p95_s": round(percentile(vals, 95), 4),
                "count": len(vals)}

    def run_canary(self, timeout_s: float = 120.0) -> Optional[list]:
        for i in self._alive():
            probes = self._sups[i].run_canary(timeout_s=timeout_s)
            if probes is not None:
                return probes
        return None

    def child_retrace(self) -> Dict:
        """Merged retrace digest: numeric fields sum across slices (zero
        post-warm compiles must hold on EVERY worker — a sum of zeros is
        zero), plus the per-worker digests for the drill's per-slice
        assertion."""
        merged: Dict = {}
        per: Dict[str, Dict] = {}
        for sup in self._sups:
            digest = sup.child_retrace()
            if digest:
                per[str(sup.worker_id)] = digest
            for k, v in digest.items():
                if isinstance(v, bool):
                    merged[k] = merged.get(k, False) or v
                elif isinstance(v, (int, float)):
                    merged[k] = merged.get(k, 0) + v
                else:
                    merged.setdefault(k, v)
        if per:
            merged["workers"] = per
        return merged

    def stats(self) -> Dict:
        per = [sup.stats() for sup in self._sups]
        counts: Dict[str, int] = dict(self._retired_counts)
        for p in per:
            for k, v in p["counts"].items():
                counts[k] = counts.get(k, 0) + v
        with self._lock:
            dead = set(self._dead)
            by_tenant = dict(self._by_tenant)
            tenant_queued = dict(self._tenant_queued)
            dispatched = self._dispatched
            hits, misses = self._affinity_hits, self._affinity_misses
            reroutes, recarves = self._crash_reroutes, self._recarves
            by_worker = dict(self._by_worker)
            warm_sizes = [len(w) for w in self._warm]
        alive = sum(1 for p in per if p["worker"]["alive"])
        workers = []
        for i, p in enumerate(per):
            w = dict(p["worker"])
            w.update({
                "worker_id": i,
                "retired": i in dead,
                "feed_depth": self._feeds[i].depth(),
                "dispatched": by_worker.get(i, 0),
                "warm_buckets": warm_sizes[i] if i < len(warm_sizes) else 0,
            })
            workers.append(w)
        tenants = {}
        for t in set(by_tenant) | set(self._qos) | set(tenant_queued):
            weight, quota = self._qos.get(t, (1.0, None))
            row = {"dispatched": by_tenant.get(t, 0), "weight": weight,
                   "queued": tenant_queued.get(t, 0)}
            if quota is not None:
                row["quota"] = quota
            tenants[t] = row
        return {
            "counts": counts,
            "latency": self.latency_quantiles(),
            "warm_buckets": sorted(self.router.warm_buckets()),
            # aggregate worker digest (the single-worker panel's shape;
            # per-slice detail lives under "pool")
            "worker": {"isolated": True, "pool": len(self._sups),
                       "alive": alive,
                       "spawns": self._retired_worker["spawns"]
                       + sum(p["worker"]["spawns"] for p in per),
                       "respawns": self._retired_worker["respawns"]
                       + sum(p["worker"]["respawns"] for p in per),
                       "crashes": self._retired_worker["crashes"]
                       + sum(p["worker"]["crashes"] for p in per),
                       "streams_resumed":
                       self._retired_worker["streams_resumed"]
                       + sum(p["worker"]["streams_resumed"] for p in per),
                       "inflight_width": sum(p["worker"]["inflight_width"]
                                             for p in per)},
            "pool": {
                "carve": (f"{self.workers}x{self.chips}" if self.chips
                          else str(self.workers)),
                "workers": workers,
                "scheduler": {"dispatched": dispatched,
                              "affinity_hits": hits,
                              "affinity_misses": misses,
                              "crash_reroutes": reroutes,
                              "recarves": recarves},
                "tenants": tenants,
            },
        }
