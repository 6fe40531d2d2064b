"""mct-serve admission layer: a bounded queue with typed rejects (the
port's copy of ``maskclustering_tpu/serve/admission.py``).

Admission is the daemon's backpressure contract: the queue holds at most
``capacity`` requests, a full queue rejects IMMEDIATELY with a typed
``queue_full`` (the client retries elsewhere/later instead of silently
waiting on an unbounded backlog), and every admitted request carries its
deadline so the worker can refuse to start work that can no longer
finish in budget (``deadline`` reject at dequeue).

Built on ``queue.Queue`` (internally locked; the handler threads submit,
the single worker thread consumes) plus one small lock
for the depth high-water bookkeeping — the ``serve.queue_depth`` gauge
and ``serve.admission.*`` counters are the Serving report's source of
truth.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Callable, List, Optional

from maskclustering_tpu_torch.analysis.lock_sanitizer import mct_lock
from maskclustering_tpu_torch.obs import flight as _flight
from maskclustering_tpu_torch.serve.protocol import SceneRequest


def _flight_admit(event: str, req: SceneRequest, **fields) -> None:
    """One queue-transition mark in the always-on flight ring — the
    postmortem's admission history (obs/flight.py; never raises, no IO)."""
    _flight.record(_flight.KIND_ADMIT, event=event, request=req.id,
                   scene=req.scene, **{k: v for k, v in fields.items()
                                       if v not in (None, "", 0)})


class QueueFullReject(Exception):
    """Typed admission reject: the bounded queue is at capacity."""

    def __init__(self, depth: int, capacity: int):
        self.depth = depth
        self.capacity = capacity
        super().__init__(f"admission queue full ({depth}/{capacity})")


def _count(name: str, delta: float = 1.0) -> None:
    from maskclustering_tpu_torch.obs import metrics

    metrics.count(name, delta)


def _gauge(name: str, value: float) -> None:
    from maskclustering_tpu_torch.obs import metrics

    metrics.gauge(name, value)


class AdmissionQueue:
    """Bounded FIFO of admitted ``SceneRequest``s.

    ``submit`` never blocks: a full queue raises ``QueueFullReject`` so
    the caller (a connection handler thread) answers the client within
    one lock acquisition. ``next`` is the worker's bounded-wait pop (the
    timeout doubles as the worker's stop-flag poll interval).
    """

    def __init__(self, capacity: int = 8, *, metered: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        # metered=False: no serve.admission.*/queue-depth bookings — for
        # INTERNAL queues (the isolated worker's two-slot stdin buffer)
        # whose plumbing must not relay up as admission accounting and
        # break topology invariance (the parent's queue is THE admission)
        self.metered = metered
        self._q: "queue.Queue[SceneRequest]" = queue.Queue(maxsize=capacity)
        self._lock = mct_lock("serve.AdmissionQueue._lock")
        self._high_water = 0
        self._admitted = 0
        # the batch scheduler's look-aside: requests popped while hunting
        # for same-bucket company but belonging to a DIFFERENT bucket wait
        # here, ahead of the queue (FIFO preserved at head granularity).
        # Touched only by the single consumer thread (the worker / the
        # supervisor pump — the same thread that calls next/next_batch),
        # so it needs no lock of its own; deque ops are atomic regardless.
        self._stash: "collections.deque[SceneRequest]" = collections.deque()

    def submit(self, req: SceneRequest) -> int:
        """Admit one request; returns the post-admission depth."""
        try:
            self._q.put_nowait(req)
        except queue.Full:
            if self.metered:
                _count("serve.admission.rejects.queue_full")
                _flight_admit("reject_queue_full", req,
                              depth=self._q.qsize(), tenant=req.tenant)
            raise QueueFullReject(self._q.qsize(), self.capacity) from None
        depth = self._q.qsize()
        if self.metered:
            _flight_admit("admit", req, depth=depth, tenant=req.tenant)
        with self._lock:
            self._admitted += 1
            if depth > self._high_water:
                self._high_water = depth
        if self.metered:
            _count("serve.admission.admitted")
            _gauge("serve.queue_depth", float(depth))
            _gauge("serve.queue_depth_high_water", float(self._high_water))
        return depth

    def next(self, timeout_s: float = 0.25) -> Optional[SceneRequest]:
        """The worker's pop: one request, or None after ``timeout_s``.

        Stashed requests (left behind by an earlier ``next_batch`` hunt)
        go first — they were admitted before anything still in the queue.
        """
        if self._stash:
            req = self._stash.popleft()
        else:
            try:
                req = self._q.get(timeout=timeout_s)
            except queue.Empty:
                return None
        if self.metered:
            _gauge("serve.queue_depth", float(self.depth()))
            _flight_admit("dequeue", req, depth=self.depth())
        return req

    def next_batch(self, key_fn: Callable[[SceneRequest], Optional[tuple]],
                   *, max_n: int, linger_s: float,
                   timeout_s: float = 0.25) -> Optional[List[SceneRequest]]:
        """The packing scheduler's pop: up to ``max_n`` same-key requests.

        Pops the FIFO head, then hunts the stash and the queue for
        requests whose ``key_fn`` matches the head's (a shape-bucket
        tuple; ``None`` marks an unbatchable request — streams, resumes,
        unknown buckets — which always dispatches solo). Non-matching
        requests return to the stash IN ORDER, ahead of the queue, so the
        hunt never reorders heads. The hunt is bounded by the linger
        window: ``linger_s``, clipped to half the smallest remaining
        deadline budget in the batch — a lone request never waits past
        its latency budget for company that may not come.

        Returns None after ``timeout_s`` with nothing queued; else a
        non-empty list whose first element is the FIFO head.
        """
        head = self.next(timeout_s=timeout_s)
        if head is None:
            return None
        if max_n <= 1:
            return [head]
        key = key_fn(head)
        if key is None:
            return [head]
        batch = [head]
        skipped: List[SceneRequest] = []

        def _window_end(now: float, end: float, req: SceneRequest) -> float:
            rem = req.remaining_s()
            return end if rem is None else min(end, now + 0.5 * max(rem, 0.0))

        now = time.monotonic()
        end = _window_end(now, now + max(linger_s, 0.0), head)
        # the stash first (older admissions), then the queue
        for _ in range(len(self._stash)):
            req = self._stash.popleft()
            if len(batch) < max_n and key_fn(req) == key:
                batch.append(req)
                end = _window_end(time.monotonic(), end, req)
            else:
                skipped.append(req)
        while len(batch) < max_n:
            now = time.monotonic()
            try:
                # drain without waiting first; linger only on an empty queue
                req = self._q.get_nowait()
            except queue.Empty:
                if now >= end:
                    break
                try:
                    req = self._q.get(timeout=min(end - now, 0.02))
                except queue.Empty:
                    continue
            if key_fn(req) == key:
                batch.append(req)
                end = _window_end(time.monotonic(), end, req)
            else:
                skipped.append(req)
        # skipped requests go back IN ORDER, ahead of the queue
        self._stash.extendleft(reversed(skipped))
        if self.metered:
            _gauge("serve.queue_depth", float(self.depth()))
            for req in batch[1:]:
                _flight_admit("dequeue_batch", req, depth=self.depth(),
                              batch=len(batch))
        return batch

    def requeue(self, req: SceneRequest) -> bool:
        """Hand a popped-but-unserved request back (the worker's stop path:
        it must not execute work the drain promised a typed reject for).
        False when a racing submit refilled the slot — the caller then
        answers the request itself."""
        try:
            self._q.put_nowait(req)
        except queue.Full:
            return False
        if self.metered:
            _gauge("serve.queue_depth", float(self._q.qsize()))
            _flight_admit("requeue", req, depth=self._q.qsize(),
                          crashes=req.crashes)
        return True

    def drain(self) -> List[SceneRequest]:
        """Everything still queued (shutdown: answer, don't run). Called
        after the consumer thread has stopped, so the stash is quiescent."""
        out: List[SceneRequest] = list(self._stash)
        self._stash.clear()
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                break
        if self.metered:
            _gauge("serve.queue_depth", 0.0)
            for req in out:
                _flight_admit("drain", req)
        return out

    def depth(self) -> int:
        return self._q.qsize() + len(self._stash)

    @property
    def high_water(self) -> int:
        with self._lock:
            return self._high_water

    @property
    def admitted(self) -> int:
        with self._lock:
            return self._admitted
