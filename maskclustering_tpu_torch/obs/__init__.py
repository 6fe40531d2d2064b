"""Unified tracing + metrics for the port (spans, counters, JSONL): the
port's copy of ``maskclustering_tpu/obs/__init__.py``.

One import point for all instrumentation call sites::

    from maskclustering_tpu_torch import obs

    with obs.span("graph", scene=seq, m_pad=m_pad) as sp:
        stats = compute_graph_stats(...)
        sp.sync(stats)            # device time charged to THIS span

    obs.count_transfer("d2h", planes.nbytes, "post.claims")

Disabled (the default) everything routes to a no-op tracer singleton:
``span`` returns a shared null span whose ``sync`` does NOT touch the
device — instrumented code has zero extra syncs and no event I/O, so
honest-shape bench numbers are unaffected. ``configure(path)`` arms the
real tracer: spans fence at their boundaries, every span/metrics flush
appends one schema-versioned JSON line to ``path``, and live device
memory is sampled at span ends. The files are the JAX package's format,
and each package's report renders the other's. Render/diff captured files
with::

    python -m maskclustering_tpu_torch.obs.report events.jsonl [--diff other.jsonl]

Modules: tracer (spans + fencing), metrics (registry), events (JSONL
sink/reader), flight (the always-on black box), telemetry (serving
windows), slo (objectives over them), digest (scene digests), canary (the
sentinel over them), ledger (perf trajectory), report, trace and top
(CLIs).
"""

from __future__ import annotations

import atexit
from typing import Optional

from maskclustering_tpu_torch.obs.events import (SCHEMA_VERSION, EventSink,
                                                 ReadStats, read_events)
from maskclustering_tpu_torch.obs.metrics import (count, count_transfer, gauge,
                                                  gauge_max, observe, registry,
                                                  sample_hbm)
from maskclustering_tpu_torch.obs.tracer import NULL_TRACER, NullTracer, Span, Tracer

__all__ = [
    "configure", "disable", "enabled", "events_path",
    "emit_event", "get_tracer", "scene_tracer", "span", "record_span", "traced",
    "flush_metrics",
    "count", "count_transfer", "gauge", "gauge_max", "observe", "registry",
    "sample_hbm", "read_events", "EventSink", "Tracer", "NullTracer",
    "Span", "NULL_TRACER", "SCHEMA_VERSION", "ReadStats",
]

# the profiler capture the JAX package arms through configure(xprof_dir=...)
XPROF_ITEM = "ROADMAP A10"

_active = NULL_TRACER
_sink: Optional[EventSink] = None
# timing-only fallback: run_scene's per-stage timings dict must exist with
# or without obs, so scene_tracer() never returns the null tracer — but
# this one never fences, emits, or samples (sink=None disables all three)
_TIMING_TRACER = Tracer(sink=None)


def configure(path: str, *, fence: bool = True, annotations: bool = False,
              sample_memory: bool = True, meta: Optional[dict] = None,
              truncate: bool = False, xprof_dir: Optional[str] = None,
              xprof_spans: Optional[tuple] = None,
              xprof_limit: int = 1) -> Tracer:
    """Arm tracing: spans + metrics flushes append to the JSONL at ``path``.

    Idempotent per path; re-configuring to a new path closes the old sink.
    Writes one ``meta`` event up front (schema version + caller context) so
    a report can label the run without side-channel files.

    ``truncate``: start the file fresh. For callers that OWN the path and
    re-derive it per run (run.py's --report default) — mixing a rerun's
    spans into a stale capture would silently skew every percentile. Leave
    False when several processes share one file by design (bench worker
    attempts + supervisor).

    ``xprof_dir`` + ``xprof_spans``: the JAX package's span-triggered
    profiler capture; the port has no counterpart yet and raises
    ``NotImplementedError`` naming ``XPROF_ITEM``.
    """
    if xprof_dir or xprof_spans:
        raise NotImplementedError(
            f"span-triggered profiler capture (xprof_dir) is not ported yet "
            f"({XPROF_ITEM}: torch.profiler counterparts of the XLA tooling)")
    global _active, _sink
    if (_sink is not None and _sink.path == path
            and isinstance(_active, Tracer)
            and not truncate):
        # idempotent ONLY for a plain re-arm of the same path: a truncate
        # request must reconfigure, not be silently dropped
        return _active
    disable()
    if truncate:
        # a truncating owner starts a FRESH capture: stale process-local
        # counters from an earlier run in this process would otherwise pool
        # into the new digest (same skew the span truncate defends against)
        registry().reset()
    _sink = EventSink(path, truncate=truncate)
    # NO device probe here: configure() must stay safe in processes that
    # never touch the card. Callers that know the device pass it via ``meta``.
    payload = {"schema": SCHEMA_VERSION}
    if meta:
        payload.update(meta)
    _sink.emit("meta", payload)
    _active = Tracer(_sink, fence=fence, annotations=annotations,
                     sample_memory=sample_memory)
    return _active


def emit_event(kind: str, payload: dict) -> None:
    """Append one typed event line to the armed sink (no-op when off).

    The telemetry ticker's window rows ride this — any subsystem with its
    own event kind can append without holding a tracer.
    """
    if _sink is not None:
        _sink.emit(kind, payload)


def disable() -> None:
    """Back to the zero-cost singleton; flushes and closes any open sink."""
    global _active, _sink
    if _sink is not None:
        try:
            _active.flush_metrics()
        except Exception:  # noqa: BLE001
            pass
        _sink.close()
        _sink = None
    _active = NULL_TRACER


atexit.register(disable)  # final metrics flush on clean interpreter exit


def enabled() -> bool:
    return _active is not NULL_TRACER


def events_path() -> Optional[str]:
    return _sink.path if _sink is not None else None


def get_tracer():
    """The active tracer: a real ``Tracer`` when armed, else the no-op
    singleton. Library instrumentation goes through this (or the
    module-level ``span``/``traced`` shortcuts)."""
    return _active


def span(name: str, **attrs):
    return _active.span(name, **attrs)


def record_span(name: str, seconds: float, **kw) -> None:
    _active.record_span(name, seconds, **kw)


def traced(name: str, **attrs):
    """Decorator: trace every call of the wrapped function as one span.

    Late-binds the active tracer so functions decorated at import time
    still pick up a tracer configured afterwards.
    """
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with _active.span(name, **attrs):
                return fn(*a, **kw)

        return wrapper

    return deco


def flush_metrics() -> None:
    _active.flush_metrics()


def scene_tracer() -> Tracer:
    """The tracer ``run_scene`` times its stages with: the armed tracer
    when obs is on, else a shared timing-only tracer (no fence, no events)
    so ``SceneResult.timings`` exists either way."""
    return _active if isinstance(_active, Tracer) else _TIMING_TRACER
