"""mct-serve worker core: one card-owning thread serving the queue (the
port's copy of ``maskclustering_tpu/serve/worker.py``).

The card is a single resource, so ONE worker thread drains the admission
queue and drives the batch pipeline's own execution stack per request —
``run.SceneSupervisor`` (retry + degradation ladder) over the batch
driver's executors — with serving-specific wiring around it:

- **the worker's card**: ``device`` resolves as the port's entry points do
  (the card unless the caller asks for the CPU); the worker thread pins it
  with ``torch.cuda.set_device`` and passes it into every call, and it is
  the only thread that launches work on it;
- a **fresh supervisor per request**: the degradation ladder is
  per-request state, so a sick request degrades ITSELF to the rung that
  heals it while its neighbors keep the full configuration;
- **deadline enforcement**: a request whose deadline expired while queued
  is answered with a typed ``deadline`` reject before any device work;
  a live deadline becomes the phase watchdog budget (min'd with the
  config's own ``watchdog_*_s``), so a stalled device phase raises
  ``DeviceStallError`` within the remaining budget — the ladder degrades
  and, while budget remains, the request retries; once the budget is
  gone ``should_continue`` stops the retry loop and the request answers
  ``deadline`` with its best-so-far attribution;
- a **per-request RunJournal** (``journal_dir/<request id>.jsonl``,
  rows stamped with the request id) so a daemon crash leaves per-request
  attribution on disk, exactly like a one-shot run's journal;
- **serve.* metrics + spans**: every request runs under a
  ``serve.request`` span (the Serving report's p50/p95 source) and books
  ``serve.requests_*`` counters; scene shape buckets new to the process
  (a cold dispatch: ``utils/compile_cache.record_shape_bucket``) are
  reported on its result (``buckets_new`` — a warm daemon answers 0) and
  fed to the router's warmth set.

The canary sentinel's probes (``run_canary``) replay the warm-up scenes on
this thread, at an idle queue poll, and never enter the queue, the latency
window or the request counters.

Synthetic requests materialize on disk (ScanNet layout under the
daemon's data root) on first use and are ordinary disk scenes from then
on — journals, artifact resume and byte-for-byte parity with one-shot
``run.py`` all hold by construction.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import torch

from maskclustering_tpu_torch import obs
from maskclustering_tpu_torch.analysis.lock_sanitizer import mct_lock
from maskclustering_tpu_torch.device import DeviceLike, resolve_device
from maskclustering_tpu_torch.obs import telemetry
from maskclustering_tpu_torch.serve import protocol
from maskclustering_tpu_torch.serve.admission import AdmissionQueue
from maskclustering_tpu_torch.serve.router import Router
from maskclustering_tpu_torch.utils import faults

log = logging.getLogger("maskclustering_tpu_torch")


def _send(req: protocol.SceneRequest, event: Dict) -> None:
    """Deliver one event to the request's client; never the failure source
    (a disconnected client must not take the worker down)."""
    if req.send is None:
        return
    try:
        req.send(event)
    except Exception:  # noqa: BLE001 — client gone; the journal still has it
        log.warning("serve: could not deliver %s for request %s "
                    "(client gone?)", event.get("kind"), req.id)


def ensure_synthetic_scene(cfg, name: str, params: Dict) -> None:
    """Materialize an inline-synthetic scene on disk (idempotent)."""
    from maskclustering_tpu_torch.utils.synthetic import (make_scene,
                                                          write_scannet_layout)

    processed = os.path.join(cfg.data_root, "scannet", "processed", name)
    if os.path.isdir(os.path.join(processed, "color")):
        return
    kw = dict(params)
    if "image_hw" in kw:
        kw["image_hw"] = tuple(kw["image_hw"])
    with obs.span("serve.materialize", scene=name):
        write_scannet_layout(make_scene(**kw), cfg.data_root, name)


def _scene_buckets() -> set:
    """The compile-cache's scene-kind shape buckets seen so far."""
    from maskclustering_tpu_torch.utils.compile_cache import seen_scene_buckets

    return seen_scene_buckets()


class _StreamSession:
    """One live scan's worker-side state (worker-thread-only access).

    Holds the scene's host tensors (loaded once), the streaming
    accumulator and the frame cursor. Sessions are keyed by scene name in
    ``ServeWorker._streams`` — the scene name IS the stream identity
    (same contract as the scene-artifact paths: one producer per scene;
    two clients streaming the same scene interleave on one cursor) — and
    the single worker thread is the only reader/writer, so no lock is
    needed (the dict never escapes the worker thread).
    """

    def __init__(self, tensors, acc):
        self.tensors = tensors
        self.acc = acc
        self.last_used = time.monotonic()

    @property
    def done(self) -> bool:
        return self.acc.frames_done >= self.acc.total_frames


class ServeWorker:
    """The daemon's single execution thread (start/stop bounded)."""

    def __init__(self, cfg, queue: AdmissionQueue, router: Router, *,
                 journal_dir: Optional[str] = None,
                 prediction_root: Optional[str] = None,
                 stream_state_dir: Optional[str] = None,
                 poll_s: float = 0.25, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the thread pins its card by index (set_device): a bare "cuda"
            # (``--device cuda``) names the current card
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.queue = queue
        self.router = router
        self.journal_dir = journal_dir
        # shared per-chunk accumulator snapshot directory (stream-session
        # failover): every accumulated chunk lands an atomic snapshot here
        # on the stream_journal_every cadence, and _open_stream resumes
        # from it — so a stream survives its worker's death (a surviving
        # pool slice or the respawned worker re-opens mid-scan) instead
        # of answering the typed stream_lost. None = sessions are
        # process-lifetime only (the pre-durability contract)
        self.stream_state_dir = stream_state_dir
        self.prediction_root = (prediction_root
                                or os.path.join(cfg.data_root, "prediction"))
        self.poll_s = poll_s
        self._stop = threading.Event()
        self._idle = threading.Event()  # set whenever no request is running
        self._idle.set()
        self._lock = mct_lock("serve.ServeWorker._lock")
        self._thread: Optional[threading.Thread] = None
        # bounded window (worker-thread appends only): a daemon that
        # serves for days must not grow per-request state without bound,
        # and stats() re-sorts the window per call — O(window), not
        # O(requests ever)
        self._latencies: Deque[float] = deque(maxlen=4096)
        self._counts = {"requests": 0, "ok": 0, "failed": 0, "deadline": 0,
                        "skipped": 0, "interrupted": 0}
        # live-scan streams (stream_chunk/stream_end ops), keyed by scene
        # name; worker-thread-only (see _StreamSession). Bounded: a
        # session pins the scene's host tensors AND the O(M^2) device
        # accumulator, so abandoned streams (client gone, no stream_end)
        # must not accumulate for the daemon's lifetime — past the cap
        # the least-recently-used session evicts (typed counter + log;
        # the evicted client's next op reopens from chunk 0)
        self._streams: Dict[str, _StreamSession] = {}
        self.max_stream_sessions = 4
        # mct-sentinel canary state: warm-up fitted tensors are retained
        # so canary probes replay the warm scenes exactly (no host-side
        # scene regeneration); the pending/done pair hands a round to the
        # card-owning worker thread at an idle poll
        self._warm_cache: List[Tuple[str, object]] = []
        self._canary_pending = threading.Event()
        self._canary_done = threading.Event()
        self._canary_probes: Optional[List[Dict]] = None
        # continuous scene batching (cfg.serve_batch_max > 1): the fused
        # dispatch mesh (lazy — single-chip daemons build a (1, 1) mesh)
        # and the occupancy histogram {batch width -> dispatches}, both
        # worker-thread-only
        self._mesh = None
        self._batch_hist: Dict[int, int] = {}

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(  # mct-thread: abandon(daemon-lifetime thread, bounded-joined in stop(); the spawn/join pair spans methods, which the scope-local check cannot see)
            target=self._run, daemon=True, name="serve-worker")
        self._thread.start()

    def stop(self, timeout_s: float = 60.0) -> bool:
        """Request stop and wait (bounded) for the in-flight request.

        The worker finishes the request it is currently executing — the
        SIGTERM drain contract — and exits; requests still queued are the
        daemon's to answer with ``draining`` rejects. Returns False when
        the in-flight request outlived the timeout (the daemon then exits
        anyway; the thread is a daemon thread and the per-request journal
        has the in-flight attempt on disk).
        """
        self._stop.set()
        t = self._thread
        if t is None:
            return True
        t.join(timeout_s)
        return not t.is_alive()

    def wait_idle(self, timeout_s: float) -> bool:
        """Block (bounded) until no request is executing AND the queue is
        empty — the warm-up/test synchronization point."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.queue.depth() == 0 and self._idle.is_set():
                return True
            time.sleep(0.01)
        return False

    # -- the thread main ----------------------------------------------------

    def _run(self) -> None:
        if self.device.type == "cuda":
            # the current device is per thread: this one launches on the
            # worker's card (every call also names it explicitly)
            torch.cuda.set_device(self.device)
        batch_max = max(int(self.cfg.serve_batch_max), 1)
        while not self._stop.is_set():
            if batch_max > 1:
                batch = self.queue.next_batch(
                    self._batch_key, max_n=batch_max,
                    linger_s=self.cfg.serve_batch_linger_s,
                    timeout_s=self.poll_s)
            else:
                head = self.queue.next(timeout_s=self.poll_s)
                batch = None if head is None else [head]
            if batch is None:
                if self._canary_pending.is_set():
                    # idle poll: run the requested canary round HERE, on
                    # the card-owning thread — canaries never race a
                    # request for the card
                    self._canary_pending.clear()
                    self._idle.clear()
                    try:
                        self._canary_probes = self._canary_round()
                    except Exception:  # noqa: BLE001 — a canary must not kill serving
                        log.exception("serve: canary round failed")
                        self._canary_probes = None
                    finally:
                        self._idle.set()
                        self._canary_done.set()
                continue
            if self._stop.is_set():
                # stop landed while we were blocked in the pop: these
                # requests were promised a draining reject, not execution —
                # hand them back for the daemon's drain (or answer the
                # reject ourselves if a racing submit refilled the slot)
                for req in batch:
                    if not self.queue.requeue(req):
                        obs.count("serve.admission.rejects.draining")
                        _send(req, protocol.reject(
                            "draining", req=req,
                            detail="daemon shutting down before dispatch"))
                break
            self._idle.clear()
            try:
                if len(batch) == 1:
                    if batch_max > 1 and batch[0].op == "scene":
                        # solo scene dispatch under the packing scheduler:
                        # a width-1 histogram entry, so `occupancy` means
                        # requests-per-dispatch over ALL scene dispatches
                        # (not just the fused ones, which are >= 2 by
                        # construction)
                        obs.count("serve.batch.dispatches")
                        obs.count("serve.batch.packed_requests")
                        self._batch_hist[1] = self._batch_hist.get(1, 0) + 1
                    self._serve_one(batch[0])
                else:
                    self._serve_batch(batch)
            except Exception:  # noqa: BLE001 — one batch, not the daemon
                log.exception("serve: request(s) %s crashed the worker "
                              "loop", [r.id for r in batch])
                for req in batch:
                    _send(req, protocol.result(req, "failed",
                                               error="internal worker error",
                                               error_class="terminal"))
            finally:
                self._idle.set()

    # -- per-request execution ---------------------------------------------

    def _deadline_cfg(self, req: protocol.SceneRequest):
        """The request's config: deadline folded into the phase watchdogs."""
        if math.isinf(req.deadline_at):
            return self.cfg
        remaining = req.remaining_s()
        overrides = {}
        for field in ("watchdog_load_s", "watchdog_device_s",
                      "watchdog_host_s"):
            cur = getattr(self.cfg, field)
            overrides[field] = min(cur, remaining) if cur > 0 else remaining
        return self.cfg.replace(**overrides)

    def _journal(self, req: protocol.SceneRequest):
        if not self.journal_dir:
            return None
        os.makedirs(self.journal_dir, exist_ok=True)
        path = os.path.join(self.journal_dir, f"{req.id}.jsonl")
        return faults.RunJournal(path, self.cfg.config_name,
                                 request_id=req.id)

    def _finish_request(self, req: protocol.SceneRequest, status_: str,
                        latency: float, *, telemetry_bucket=None,
                        **fields) -> None:
        """The one request tail — latency window, ``serve.requests_*``
        counter, locked counts, telemetry row, terminal result emit —
        shared by the classic scene op and the stream ops so request
        accounting cannot drift between the two paths."""
        self._latencies.append(latency)
        obs.count(f"serve.requests_{status_}")
        with self._lock:
            self._counts[status_] = self._counts.get(status_, 0) + 1
        telemetry.record_request(
            telemetry_bucket if telemetry_bucket is not None
            else self.router.bucket_for(req.scene), latency,
            tenant=req.tenant, status=status_)
        _send(req, protocol.result(req, status_,
                                   seconds=round(latency, 4), **fields))

    def _book_arrival(self, req: protocol.SceneRequest) -> bool:
        """Per-request arrival bookkeeping (request count, queue wait,
        deadline cutoff) — shared by the solo and the packed paths so
        admission accounting cannot drift between them. False when the
        request was answered with a typed ``deadline`` reject."""
        obs.count("serve.requests")
        with self._lock:
            self._counts["requests"] += 1
        # ack->dequeue wait: the telemetry window's queue_wait histogram
        # and the trace CLI's queue-wait segment (no-op without a daemon
        # aggregator — e.g. inside the isolated worker subprocess, where
        # the PARENT supervisor measured the real wait already)
        telemetry.record_queue_wait(
            req, max(time.monotonic() - req.admitted_at, 0.0))
        if req.expired():
            # admitted in time, dequeued too late: a typed answer beats
            # burning device time on a result nobody is waiting for
            obs.count("serve.rejects.deadline")
            telemetry.record_reject(req.tenant)
            with self._lock:
                self._counts["deadline"] += 1
            _send(req, protocol.reject(
                "deadline", req=req,
                detail=f"deadline_s={req.deadline_s:g} expired after "
                       f"{time.monotonic() - req.admitted_at:.2f}s in queue"))
            return False
        return True

    def _serve_one(self, req: protocol.SceneRequest) -> None:
        if not self._book_arrival(req):
            return
        if req.op in ("stream_chunk", "stream_end"):
            self._serve_stream(req)
            return
        self._serve_scene(req)

    def _serve_scene(self, req: protocol.SceneRequest) -> None:
        from maskclustering_tpu_torch.run import SceneSupervisor

        t0 = time.monotonic()
        bucket = None
        if req.synthetic is not None:
            try:
                ensure_synthetic_scene(self.cfg, req.scene, req.synthetic)
                bucket = self.router.bucket_for(req.scene)
                if bucket is None:
                    # first sight of this scene: generate once to
                    # classify, then the router remembers — repeats must
                    # not pay a host-side scene regeneration per request
                    from maskclustering_tpu_torch.utils.synthetic import (
                        make_scene, to_scene_tensors)

                    kw = dict(req.synthetic)
                    if "image_hw" in kw:
                        kw["image_hw"] = tuple(kw["image_hw"])
                    bucket = self.router.classify_tensors(
                        to_scene_tensors(make_scene(**kw)))
                    self.router.remember(req.scene, bucket)
            except Exception as e:  # noqa: BLE001 — answer, don't crash
                log.exception("serve: synthetic materialization failed "
                              "for %s", req.id)
                obs.count("serve.requests_failed")
                with self._lock:
                    self._counts["failed"] += 1
                _send(req, protocol.result(
                    req, "failed", error=f"synthetic materialization: {e}",
                    error_class=faults.classify_error(e)))
                return
        _send(req, protocol.status(
            req, "running", scene=req.scene,
            **({"bucket": list(bucket),
                "warm": self.router.is_warm(bucket)}
               if bucket is not None else {})))

        def on_event(kind: str, **info) -> None:
            state = {"retry": "retrying", "degrade": "degraded"}.get(kind)
            if state:
                _send(req, protocol.status(req, state, **info))

        journal = self._journal(req)
        buckets_before = _scene_buckets()
        try:
            supervisor = SceneSupervisor(
                self._deadline_cfg(req), resume=req.resume, journal=journal,
                on_event=on_event,
                should_continue=lambda: not req.expired(),
                # a request that crashed its previous worker(s) re-runs
                # pre-degraded: the full configuration already proved
                # fatal once (the subprocess supervisor stamps req.crashes)
                initial_rungs=req.crashes,
                prediction_root=self.prediction_root, device=self.device)
            if journal is not None:
                journal.begin_run()
            with obs.span("serve.request", request=req.id, scene=req.scene):
                statuses = supervisor.run([req.scene])
        finally:
            if journal is not None:
                journal.end_run(interrupted=faults.stop_requested())
                journal.close()
        new_buckets = _scene_buckets() - buckets_before
        for b in new_buckets:
            self.router.note_served(b)
        if bucket is not None:
            self.router.note_served(bucket)
        latency = time.monotonic() - t0

        st = statuses[0] if statuses else None
        if st is None:
            status_ = "failed"
            fields: Dict = {"error": "supervisor returned no status",
                            "error_class": "terminal"}
        else:
            status_ = st.status
            if st.status == "failed" and req.expired():
                status_ = "deadline"
            fields = {"scene_seconds": round(st.seconds, 4),
                      "attempts": st.attempts, "rung": st.degradation_rung,
                      "num_objects": st.num_objects}
            if getattr(st, "digest", None):
                # per-request invariant digest: the pack-vs-sequential
                # identity gate compares this against the fused path's
                # per-lane digest (artifact fingerprint is universal)
                fields["digest"] = st.digest
                fields["digest_coord"] = getattr(st, "digest_coord", "")
            if st.error:
                fields["error"] = str(st.error).strip().splitlines()[-1][:200]
                fields["error_class"] = st.error_class
        if new_buckets:
            obs.count("serve.buckets_cold", len(new_buckets))
        self._finish_request(
            req, status_, latency, telemetry_bucket=bucket,
            buckets_new=len(new_buckets),
            **({"bucket": list(bucket)} if bucket is not None else {}),
            **fields)

    # -- continuous scene batching (cfg.serve_batch_max > 1) ----------------

    def _run_mesh(self):
        """The fused dispatch mesh: cfg.mesh_shape when set (over every
        visible card; on the CPU, the worker's device repeated), else a
        (1, 1) mesh of the worker's card (scene lanes still batch — they
        stack on the scene dim and shard 1-wide)."""
        if self._mesh is None:
            from maskclustering_tpu_torch.parallel.batch import make_run_mesh
            from maskclustering_tpu_torch.parallel.mesh import make_mesh

            if self.cfg.mesh_shape:
                size = math.prod(self.cfg.mesh_shape) * max(int(self.cfg.point_shards), 1)
                self._mesh = make_run_mesh(
                    self.cfg, None if self.device.type == "cuda" else [self.device] * size)
            else:
                self._mesh = make_mesh((1, 1), devices=[self.device])
        return self._mesh

    def _batch_key(self, req: protocol.SceneRequest) -> Optional[tuple]:
        """The packing scheduler's grouping key: the request's shape
        bucket, or None for requests that must dispatch solo.

        Solo (None): stream ops (one bucket per stream stays the rule),
        resume requests (artifact-exists short-circuit is a sequential-
        path contract), crash-requeued requests (they re-run pre-degraded
        on their own ladder), scenes the router has not classified yet
        (first sight classifies on the sequential path, repeats batch),
        and scenes with a pending FaultPlan entry — the sequential
        ladder owns fault handling, so a scripted fault fails or retries
        ONLY its own request while batchmates pack normally.
        """
        if req.op != "scene" or req.resume or req.crashes:
            return None
        bucket = self.router.bucket_for(req.scene)
        if bucket is None:
            return None
        plan = faults.active_plan()
        if plan is not None and any(
                e.scene == req.scene
                and (e.remaining is None or e.remaining > 0)
                for e in plan.entries):
            return None
        return bucket

    def _serve_batch(self, batch: List[protocol.SceneRequest]) -> None:
        """One fused scene-axis dispatch for up to S same-bucket requests.

        Members are padded to exactly ``cfg.serve_batch_max`` lanes with
        the router's warm pad tensors, so every occupancy >= 2 replays the
        one full-width warm executable (solo requests take the sequential
        path — the batch-width vocabulary is {1, S}). Results demux
        per-lane: each member gets its own export, artifact digest,
        journal rows and telemetry booking, byte-identical to sequential
        execution; pad lanes book nothing anywhere. Any dispatch-level
        failure falls the whole batch back to the sequential path, where
        each member's own retry/degradation ladder takes over.
        """
        from maskclustering_tpu_torch.datasets import get_dataset
        from maskclustering_tpu_torch.models.postprocess import export_artifacts
        from maskclustering_tpu_torch.obs import digest as sentinel
        from maskclustering_tpu_torch.parallel.batch import cluster_scene_batch
        from maskclustering_tpu_torch.parallel.mesh import mesh_label

        members = [r for r in batch if self._book_arrival(r)]
        if not members:
            return
        if len(members) == 1:
            self._serve_scene(members[0])
            return
        # pure classification, NOT _batch_key: the solo-routing policy
        # (fault plans, resume, crashes) belongs to the scheduler that
        # built this batch — by the time a batch reaches the dispatcher
        # its members pack, and scripted faults land per-lane below
        bucket = self.router.bucket_for(members[0].scene)
        if bucket is None:
            for req in members:
                self._serve_scene(req)
            return
        k_max, f_b, n_b = bucket
        t0 = time.monotonic()
        loaded: List[tuple] = []  # (req, dataset, tensors)
        for req in members:
            try:
                if req.synthetic is not None:
                    ensure_synthetic_scene(self.cfg, req.scene, req.synthetic)
                ds = get_dataset(self.cfg.dataset, req.scene,
                                 data_root=self.cfg.data_root)
                tensors = faults.call_with_deadline(
                    lambda ds=ds: ds.load_scene_tensors(self.cfg.step),
                    self.cfg.watchdog_load_s, seam="load", scene=req.scene)
                if self.router.classify_tensors(tensors) != bucket:
                    # the remembered bucket went stale (scene bytes
                    # changed on disk): serve it solo rather than force
                    # it into the wrong executable
                    self.router.remember(
                        req.scene, self.router.classify_tensors(tensors))
                    self._serve_scene(req)
                    continue
                loaded.append((req, ds, tensors))
            except Exception as e:  # noqa: BLE001 — one member, not the batch
                log.exception("serve: batch member %s failed to load",
                              req.id)
                self._finish_request(
                    req, "failed", time.monotonic() - t0,
                    telemetry_bucket=bucket,
                    error=f"scene load: {e}"[:200],
                    error_class=faults.classify_error(e))
        if not loaded:
            return
        if len(loaded) == 1:
            self._serve_scene(loaded[0][0])
            return

        width = max(int(self.cfg.serve_batch_max), len(loaded))
        pad_tensors = self.router.pad_tensors_for(bucket)
        if pad_tensors is None:
            # no warm pad retained yet (first batch of a bucket warmed
            # by real traffic): the first member's tensors pad — same
            # executable shape, pad lanes still discarded
            pad_tensors = loaded[0][2]
            self.router.remember_pad_tensors(bucket, pad_tensors)
        for req, _, _ in loaded:
            _send(req, protocol.status(
                req, "running", scene=req.scene, bucket=list(bucket),
                warm=self.router.is_warm(bucket), batch=len(loaded)))

        budget = self.cfg.watchdog_device_s
        rems = [r.remaining_s() for r, _, _ in loaded
                if not math.isinf(r.deadline_at)]
        if rems:
            tightest = max(min(rems), 0.01)
            budget = min(budget, tightest) if budget > 0 else tightest
        buckets_before = _scene_buckets()
        try:
            objects_list = faults.call_with_deadline(
                lambda: cluster_scene_batch(
                    self.cfg, self._run_mesh(),
                    [t for _, _, t in loaded], k_max=k_max,
                    seq_names=[r.scene for r, _, _ in loaded],
                    pads=(f_b, n_b), width=width, pad_tensors=pad_tensors),
                budget, seam="device",
                scene=",".join(r.scene for r, _, _ in loaded))
        except Exception:  # noqa: BLE001 — fall back, don't fail the batch
            log.exception(
                "serve: fused batch %s failed; falling back to the "
                "sequential path", [r.id for r, _, _ in loaded])
            obs.count("serve.batch.fallbacks")
            for req, _, _ in loaded:
                self._serve_scene(req)
            return
        wall = time.monotonic() - t0
        new_buckets = _scene_buckets() - buckets_before
        for b in new_buckets:
            self.router.note_served(b)
        self.router.note_served(bucket)
        k = len(loaded)
        per_scene = wall / k
        obs.count("serve.batch.dispatches")
        obs.count("serve.batch.packed_requests", k)
        if width > k:
            obs.count("serve.batch.pad_lanes", width - k)
        self._batch_hist[k] = self._batch_hist.get(k, 0) + 1

        mesh_lab = (mesh_label(self.cfg.mesh_shape) if self.cfg.mesh_shape
                    else "single")
        for (req, ds, _), objects in zip(loaded, objects_list):
            journal = self._journal(req)
            if journal is not None:
                journal.begin_run()
                journal.attempt(req.scene, 1, 0)
            try:
                faults.inject("export", req.scene)
                export_artifacts(
                    objects, req.scene, self.cfg.config_name,
                    ds.object_dict_dir, prediction_root=self.prediction_root,
                    top_k_repre=self.cfg.num_representative_masks)
                # per-LANE invariant digest (never per-dispatch): the
                # fused path materializes no DeviceHandoff, so the
                # universal artifact fingerprint carries the identity
                dg = sentinel.artifact_only_digest(
                    objects, bucket="fused",
                    count_dtype=self.cfg.count_dtype)
                coord = sentinel.digest_coord(dg, mesh=mesh_lab)
                if journal is not None:
                    journal.outcome(
                        req.scene, "ok", attempt=1, rung=0,
                        seconds=per_scene,
                        num_objects=len(objects.point_ids_list))
                obs.record_span("serve.request", wall, request=req.id,
                                scene=req.scene, batch=k)
                self._finish_request(
                    req, "ok", wall, telemetry_bucket=bucket,
                    bucket=list(bucket), batch=k,
                    scene_seconds=round(per_scene, 4), attempts=1, rung=0,
                    num_objects=len(objects.point_ids_list),
                    buckets_new=len(new_buckets),
                    digest=dg, digest_coord=coord)
            except Exception as e:  # noqa: BLE001 — one lane, not the batch
                log.exception("serve: batch member %s export failed",
                              req.id)
                if journal is not None:
                    journal.outcome(req.scene, "failed", attempt=1, rung=0,
                                    error_class=faults.classify_error(e),
                                    error=str(e)[:200], seconds=per_scene)
                self._finish_request(
                    req, "failed", wall, telemetry_bucket=bucket,
                    batch=k, error=str(e).strip().splitlines()[-1][:200],
                    error_class=faults.classify_error(e))
            finally:
                if journal is not None:
                    journal.end_run()
                    journal.close()

    # -- live-scan streaming (stream_chunk / stream_end ops) ----------------

    def _open_stream(self, req: protocol.SceneRequest) -> _StreamSession:
        """Create the scene's stream session: tensors loaded ONCE, the
        accumulator sized for the whole scan."""
        from maskclustering_tpu_torch.datasets import get_dataset
        from maskclustering_tpu_torch.models.streaming import StreamAccumulator
        from maskclustering_tpu_torch.utils.compile_cache import bucket_k_max, max_seg_id

        if req.synthetic is not None:
            ensure_synthetic_scene(self.cfg, req.scene, req.synthetic)
        ds = get_dataset(self.cfg.dataset, req.scene,
                         data_root=self.cfg.data_root)
        tensors = ds.load_scene_tensors(self.cfg.step)
        chunk = int(req.chunk) or self.cfg.streaming_chunk or 8
        cfg = (self.cfg if self.cfg.streaming_chunk == chunk
               else self.cfg.replace(streaming_chunk=chunk))
        acc = StreamAccumulator(
            cfg, total_frames=tensors.num_frames,
            num_points=tensors.num_points,
            k_max=bucket_k_max(max_seg_id(tensors.segmentations)),
            seq_name=req.scene, device=self.device)
        state_path = self._stream_state_path(req.scene)
        if state_path and acc.load_state(state_path):
            # a previous worker's snapshot exists and its coordinates
            # match: resume mid-scan instead of restarting at chunk 0 —
            # the failover contract (the cursor self-derives from the
            # restored chunks_done)
            obs.count("serve.streams_resumed")
            log.warning("serve: stream %r resumed from snapshot at chunk "
                        "%d (%d/%d frames)", req.scene, acc.chunks_done,
                        acc.frames_done, acc.total_frames)
        while len(self._streams) >= self.max_stream_sessions:
            victim = min(self._streams, key=lambda s:
                         self._streams[s].last_used)
            log.warning("serve: evicting idle stream session %r "
                        "(cap %d; its client must restart the scan)",
                        victim, self.max_stream_sessions)
            obs.count("serve.streams_evicted")
            del self._streams[victim]
        return _StreamSession(tensors, acc)

    def _stream_state_path(self, scene: str) -> Optional[str]:
        """The scene's shared snapshot path (None = failover disarmed)."""
        if not self.stream_state_dir:
            return None
        from maskclustering_tpu_torch.models.streaming import stream_state_path

        os.makedirs(self.stream_state_dir, exist_ok=True)
        return stream_state_path(self.stream_state_dir, scene)

    def _serve_stream(self, req: protocol.SceneRequest) -> None:
        """One stream op: accumulate the scene's next chunk, or finalize.

        Each op is one admitted request (ack -> status -> result), so
        streams interleave fairly with classic scene requests on the one
        device-owning thread. The result's ``partial_instances`` /
        ``done`` fields are the live-scan anytime contract; a failed
        chunk answers a typed ``failed`` result with the accumulator
        intact, so the client can simply resend the op.
        """
        from maskclustering_tpu_torch.models.streaming import slice_scene_frames

        t0 = time.monotonic()
        status_ = "ok"
        fields: Dict = {}
        try:
            if req.op == "stream_end":
                sess = self._streams.get(req.scene)
                if sess is None or sess.acc.chunks_done == 0:
                    raise ValueError(
                        f"no live stream for scene {req.scene!r} "
                        f"(send stream_chunk first)")
                sess.last_used = time.monotonic()
                _send(req, protocol.status(
                    req, "running", scene=req.scene, stream="end"))
                from maskclustering_tpu_torch.datasets import get_dataset

                ds = get_dataset(self.cfg.dataset, req.scene,
                                 data_root=self.cfg.data_root)
                with obs.span("serve.request", request=req.id,
                              scene=req.scene, stream="end"):
                    result = sess.acc.finalize(
                        export=True, object_dict_dir=ds.object_dict_dir,
                        prediction_root=self.prediction_root)
                # only a SUCCESSFUL finalize consumes the session: a
                # failed export/finalize keeps the accumulated stream so
                # the client can simply resend stream_end
                self._streams.pop(req.scene, None)
                state_path = self._stream_state_path(req.scene)
                if state_path and os.path.exists(state_path):
                    # the stream is settled — its snapshot must not
                    # resurrect a finished scan on the next open
                    try:
                        os.remove(state_path)
                    except OSError:
                        pass
                fields = {"num_objects": len(result.objects.point_ids_list),
                          "frames": sess.acc.frames_done,
                          "chunks": sess.acc.chunks_done}
                obs.count("serve.stream_ends")
            else:
                sess = self._streams.get(req.scene)
                if sess is None:
                    sess = self._open_stream(req)
                    self._streams[req.scene] = sess
                    obs.count("serve.streams_opened")
                sess.last_used = time.monotonic()
                acc = sess.acc
                if sess.done:
                    if req.crashes:
                        # crash-requeued chunk whose push was already
                        # absorbed before the worker died (the snapshot
                        # includes it): answer the anytime fields instead
                        # of double-pushing or failing the replay
                        obs.count("serve.stream_chunks_rerun")
                        fields = {"chunk": max(acc.chunks_done - 1, 0),
                                  "frames_done": acc.frames_done,
                                  "total_frames": acc.total_frames,
                                  "partial_instances": acc.partial_instances,
                                  "done": True}
                        self._finish_request(
                            req, "ok", time.monotonic() - t0,
                            op=req.op, **fields)
                        return
                    raise ValueError(
                        f"stream {req.scene!r} already consumed all "
                        f"{acc.total_frames} frames (send stream_end)")
                if req.crashes:
                    # the chunk in flight when the previous worker died,
                    # replayed against the resumed accumulator
                    obs.count("serve.stream_chunks_rerun")
                _send(req, protocol.status(
                    req, "running", scene=req.scene,
                    stream="chunk", chunk_index=acc.chunks_done))
                start = acc.chunks_done * acc.chunk_frames
                stop = min(start + acc.chunk_frames,
                           sess.tensors.num_frames)
                with obs.span("serve.request", request=req.id,
                              scene=req.scene, stream="chunk"):
                    # the request deadline folds into the chunk watchdog
                    # exactly like the classic scene op (min of the
                    # config budget and the remaining deadline)
                    digest = faults.call_with_deadline(
                        lambda: acc.push_chunk(
                            slice_scene_frames(sess.tensors, start, stop)),
                        self._deadline_cfg(req).watchdog_device_s,
                        seam="device", scene=req.scene)
                state_path = self._stream_state_path(req.scene)
                if state_path and self.cfg.stream_journal_every > 0 and (
                        digest["done"] or acc.chunks_done
                        % self.cfg.stream_journal_every == 0):
                    # ship the accumulator snapshot to the SHARED state
                    # dir (atomic tmp+rename in save_state): the failover
                    # plane a surviving slice resumes from. The final
                    # chunk always snapshots — stream_end is a separate
                    # request and the worker may die in between
                    acc.save_state(state_path)
                # the per-chunk anytime signal: partial-instance count on
                # a status event BEFORE the terminal result (live
                # dashboards and the client's streaming helper read it)
                _send(req, protocol.status(
                    req, "chunk_done", scene=req.scene,
                    chunk_index=digest["chunk"],
                    frames_done=digest["frames_done"],
                    total_frames=digest["total_frames"],
                    partial_instances=digest["partial_instances"]))
                fields = {k: digest[k]
                          for k in ("chunk", "frames_done", "total_frames",
                                    "partial_instances", "done")}
                obs.count("serve.stream_chunks")
        except Exception as e:  # noqa: BLE001 — one op, not the daemon
            log.exception("serve: stream op %s failed for %s",
                          req.op, req.id)
            status_ = "failed"
            msg = str(e).strip()
            fields = {"error": (msg.splitlines()[-1] if msg
                                else type(e).__name__)[:200],
                      "error_class": faults.classify_error(e)}
        if status_ == "failed" and req.expired():
            # same reclassification as the classic scene op: a failure
            # past the request's deadline answers as the deadline's
            status_ = "deadline"
        self._finish_request(req, status_, time.monotonic() - t0,
                             op=req.op, **fields)

    # -- warm-up ------------------------------------------------------------

    def warm_tensors(self, name: str, tensors) -> bool:
        """Run one warm-up scene through the serving path (no export).

        Best-effort: a failed warm-up logs and returns False — the daemon
        still serves, it just pays that bucket's cold dispatch on the
        first real request.
        """
        from maskclustering_tpu_torch.models.pipeline import (run_scene_device,
                                                              run_scene_host)

        bucket = self.router.classify_tensors(tensors)
        try:
            with obs.span("serve.warmup", scene=name):
                handoff = run_scene_device(tensors, self.cfg, seq_name=name,
                                           device=self.device)
                run_scene_host(handoff, self.cfg, export=False)
        except Exception:  # noqa: BLE001 — warm-up must not kill startup
            log.exception("serve: warm-up scene %s (bucket %s) failed",
                          name, bucket)
            return False
        self.router.note_served(bucket)
        obs.count("serve.warmup_scenes")
        # the packing scheduler's pad-lane source: partial batches pad to
        # full width with THIS bucket's warm synthetic tensors
        self.router.remember_pad_tensors(bucket, tensors)
        # sentinel: retain the fitted tensors — canary probes replay them
        # byte-for-byte (never regenerating scenes host-side)
        if all(n != name for n, _ in self._warm_cache):
            self._warm_cache.append((name, tensors))
        return True

    def warm_batch_executable(self, name: str, tensors) -> bool:
        """Warm the FULL-WIDTH fused executable for the scene's bucket.

        One width-S dispatch per warm bucket (real lane = the warm scene,
        pad lanes = the same tensors) so every packed batch — including
        partial ones, which pad to exactly S — replays warm shapes at any
        occupancy. No-op when batching is off; best-effort like
        ``warm_tensors``.
        """
        if int(self.cfg.serve_batch_max) <= 1:
            return False
        from maskclustering_tpu_torch.parallel.batch import cluster_scene_batch

        bucket = self.router.classify_tensors(tensors)
        width = int(self.cfg.serve_batch_max)
        try:
            with obs.span("serve.warmup_batch", scene=name, width=width):
                cluster_scene_batch(
                    self.cfg, self._run_mesh(), [tensors],
                    k_max=bucket[0], seq_names=[name],
                    pads=(bucket[1], bucket[2]), width=width,
                    pad_tensors=tensors)
        except Exception:  # noqa: BLE001 — warm-up must not kill startup
            log.exception("serve: fused-batch warm-up %s (bucket %s, "
                          "width %d) failed", name, bucket, width)
            return False
        self.router.remember_pad_tensors(bucket, tensors)
        obs.count("serve.warmup_batches")
        return True

    # -- mct-sentinel canary probes -----------------------------------------

    def run_canary(self, timeout_s: float = 120.0) -> Optional[List[Dict]]:
        """Execute one canary round; returns per-scene probe digests.

        On a running worker the round is handed to the card-owning thread
        (it picks it up at an idle queue poll, so a canary never races a
        request for the card); without a running thread (goldens
        generation, tests) it executes inline. Returns None on timeout.

        Canary traffic is fenced BY CONSTRUCTION: it never enters the
        admission queue, the latency window, ``serve.requests_*`` counts,
        tenant accounting or the request journal — it books only
        ``canary.*`` counters and spans.
        """
        if self._thread is None or not self._thread.is_alive():
            return self._canary_round()
        self._canary_done.clear()
        self._canary_probes = None
        self._canary_pending.set()
        if not self._canary_done.wait(timeout_s):
            self._canary_pending.clear()
            log.warning("serve: canary round timed out after %.1fs "
                        "(worker busy)", timeout_s)
            return None
        return self._canary_probes

    def _canary_round(self) -> List[Dict]:
        from maskclustering_tpu_torch.models.pipeline import (run_scene_device,
                                                              run_scene_host)
        from maskclustering_tpu_torch.obs import digest as sentinel

        probes: List[Dict] = []
        for name, tensors in list(self._warm_cache):
            t0 = time.monotonic()
            with obs.span("serve.canary", scene=name):
                handoff = run_scene_device(tensors, self.cfg, seq_name=name,
                                           device=self.device)
                result = run_scene_host(handoff, self.cfg, export=False)
            obs.count("canary.probes")
            probes.append({
                "scene": name,
                "coord": sentinel.digest_coord(result.digest),
                "digest": result.digest,
                "seconds": round(time.monotonic() - t0, 4),
            })
        return probes

    # -- introspection ------------------------------------------------------

    def latency_quantiles(self) -> Dict[str, Optional[float]]:
        from maskclustering_tpu_torch.obs.report import percentile

        vals = sorted(self._latencies)
        if not vals:
            return {"p50_s": None, "p95_s": None, "count": 0}
        return {"p50_s": round(percentile(vals, 50), 4),
                "p95_s": round(percentile(vals, 95), 4),
                "count": len(vals)}

    def batch_stats(self) -> Optional[Dict]:
        """Occupancy view of the packing scheduler (None when off):
        dispatches, packed requests, mean occupancy, width histogram."""
        if int(self.cfg.serve_batch_max) <= 1:
            return None
        hist = dict(self._batch_hist)
        dispatches = sum(hist.values())
        packed = sum(k * n for k, n in hist.items())
        return {"max": int(self.cfg.serve_batch_max),
                "linger_s": float(self.cfg.serve_batch_linger_s),
                "dispatches": dispatches,
                "packed_requests": packed,
                "occupancy": (round(packed / dispatches, 3)
                              if dispatches else None),
                "hist": {str(k): hist[k] for k in sorted(hist)}}

    def stats(self) -> Dict:
        with self._lock:
            counts = dict(self._counts)
        out = {"counts": counts,
               "latency": self.latency_quantiles(),
               "warm_buckets": sorted(self.router.warm_buckets())}
        batch = self.batch_stats()
        if batch is not None:
            out["batch"] = batch
        return out
