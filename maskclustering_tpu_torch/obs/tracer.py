"""Span tracer with device-sync-aware fencing (the port's copy of
``maskclustering_tpu/obs/tracer.py``).

Host-side ``perf_counter`` around asynchronous CUDA launches attributes a
device stage's cost to whichever LATER stage first forces a sync (a
``.cpu()``), not to the stage that ran it. Spans fix it with explicit
fencing:

- ``span.sync(value)`` synchronizes the card(s) of the tensors in
  ``value`` (any nesting of tuples, lists, dicts and NamedTuples) and
  accumulates the blocked wall time into the span's ``sync_s`` — so a
  span that closes after syncing its own outputs owns its device time,
  and ``duration - sync_s`` is its true host-side cost.
- fencing only happens on a **real, fence-enabled tracer**. The no-op
  singleton's ``sync`` returns its argument untouched: instrumented code
  paths add ZERO extra device syncs when observability is off, so
  honest-shape bench numbers are unaffected.

Nesting is thread-local (prefetch daemon threads get their own stacks);
each span carries key=value attrs (scene id, shape bucket, frame/point
counts) and can pass through ``torch.profiler.record_function`` so spans
line up with profiler traces.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Dict, Optional

import torch

from maskclustering_tpu_torch.obs import flight as _flight
from maskclustering_tpu_torch.obs import metrics as _metrics
from maskclustering_tpu_torch.obs.events import KIND_SPAN, EventSink


def _cuda_devices(value, out: set, depth: int = 0) -> None:
    """Collect the CUDA devices of the tensors in ``value`` (bounded walk)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif depth < 4 and isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out, depth + 1)
    elif depth < 4 and isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out, depth + 1)


class Span:
    """One timed region. Created by ``Tracer.span``; close via the ctx mgr."""

    __slots__ = ("name", "attrs", "t0", "duration", "sync_s", "parent",
                 "depth", "_tracer", "_annotation", "_owns_xprof")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any],
                 parent: Optional[str], depth: int):
        self.name = name
        self.attrs = attrs
        self.parent = parent
        self.depth = depth
        self.t0 = 0.0
        self.duration = 0.0
        self.sync_s = 0.0
        self._tracer = tracer
        self._annotation = None
        self._owns_xprof = False

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def sync(self, value=None):
        """Fence: block until ``value`` (a pytree of arrays) is ready.

        Charges the blocked wall time to THIS span so device work is
        attributed to the stage that dispatched it. Returns ``value`` for
        chaining (``out = sp.sync(kernel(x))``). No-ops (and costs no
        device sync) when the tracer has fencing off.
        """
        if value is not None and self._tracer.fence:
            t0 = time.perf_counter()
            devices = set()
            _cuda_devices(value, devices)
            for dev in sorted(devices, key=str):
                torch.cuda.synchronize(dev)
            self.sync_s += time.perf_counter() - t0
        return value

    def __enter__(self) -> "Span":
        tr = self._tracer
        stack = tr._stack()
        self.parent = stack[-1].name if stack else self.parent
        self.depth = len(stack)
        stack.append(self)
        if tr.xprof is not None:
            # span-triggered profiler capture (obs/xprof.py): the span that
            # starts the session owns it and stops it at close
            self._owns_xprof = tr.xprof.maybe_start(self.name)
        if tr.annotations:
            try:
                self._annotation = torch.profiler.record_function(self.name)
                self._annotation.__enter__()
            except Exception:  # noqa: BLE001 — annotations are best-effort
                self._annotation = None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.duration = time.perf_counter() - self.t0
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
        tr = self._tracer
        if self._owns_xprof and tr.xprof is not None:
            tr.xprof.stop(self.name)
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        tr._finish(self)
        return False


class _NullSpan:
    """Shared do-nothing span: the disabled-mode fast path."""

    __slots__ = ()
    name = "null"
    parent = None
    depth = 0
    duration = 0.0
    sync_s = 0.0
    attrs: Dict[str, Any] = {}

    def set(self, **attrs):
        return self

    def sync(self, value=None):
        return value  # NO synchronize: disabled mode adds no syncs

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """No-op tracer singleton: zero allocation, zero syncs, zero events."""

    fence = False
    annotations = False
    enabled = False
    xprof = None

    def span(self, name: str, **attrs):
        return _NULL_SPAN

    def record_span(self, name: str, seconds: float, *, parent=None, **attrs):
        return None

    def traced(self, name: str, **attrs):
        return lambda fn: fn

    def flush_metrics(self) -> None:
        return None


NULL_TRACER = NullTracer()


class Tracer:
    """Real tracer: times spans, optionally fences, emits, samples HBM.

    ``sink=None`` gives a timing-only tracer (what run_scene falls back to
    when obs is off, so its timings dict always exists) — it never emits,
    never fences, never samples memory.
    """

    enabled = True

    def __init__(self, sink: Optional[EventSink] = None, *, fence: bool = True,
                 annotations: bool = False, sample_memory: bool = True,
                 aggregate: bool = True, xprof=None):
        self.sink = sink
        self.xprof = xprof  # Optional[obs.xprof.XprofArm]
        self.fence = fence and sink is not None
        self.annotations = annotations
        self.sample_memory = sample_memory and sink is not None
        self.aggregate = aggregate and sink is not None
        self._local = threading.local()

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs, parent=None, depth=0)

    def record_span(self, name: str, seconds: float, *, parent: Optional[str] = None,
                    sync_s: float = 0.0, **attrs) -> None:
        """Register an externally-measured phase as a finished span.

        The retrofit path for code that already owns its timing (the
        post-process ``_PhaseTimer`` phases): same event schema, no
        double-timing.
        """
        sp = Span(self, name, attrs, parent=parent, depth=1 if parent else 0)
        sp.duration = float(seconds)
        sp.sync_s = float(sync_s)
        sp.t0 = time.perf_counter() - sp.duration
        self._finish(sp)

    def traced(self, name: str, **attrs):
        """Decorator form: the whole call body becomes one span."""

        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*a, **kw):
                with self.span(name, **attrs):
                    return fn(*a, **kw)

            return wrapper

        return deco

    def _finish(self, span: Span) -> None:
        # every finished span — real, timing-only or relay-armed — lands
        # in the in-process flight ring (obs/flight.py): the black box is
        # always on, costing one deque append, no IO
        _flight.record_span(span.name, span.duration, span.sync_s,
                            span.attrs)
        if self.aggregate:
            _metrics.observe(f"span.{span.name}.s", span.duration)
            if span.sync_s:
                _metrics.observe(f"span.{span.name}.sync_s", span.sync_s)
                # fenced device time as a COUNTER so the cross-process
                # relay's delta fold carries it: the per-tenant
                # device-seconds attribution reads this, topology-invariant
                _metrics.count("device.seconds", span.sync_s)
        if self.sink is None:
            return
        mem = _metrics.sample_hbm() if self.sample_memory else None
        payload: Dict[str, Any] = {
            "name": span.name,
            "t0": span.t0,
            "dur_s": round(span.duration, 6),
            "sync_s": round(span.sync_s, 6),
            "depth": span.depth,
        }
        if span.parent:
            payload["parent"] = span.parent
        if span.attrs:
            payload["attrs"] = span.attrs
        if mem:
            payload["mem"] = {k: mem[k] for k in ("bytes_in_use",) if k in mem}
        self.sink.emit(KIND_SPAN, payload)

    def flush_metrics(self) -> None:
        """Emit one metrics-snapshot event (counters/gauges/histograms)."""
        if self.sink is not None:
            self.sink.emit("metrics", {"metrics": _metrics.registry().snapshot()})
