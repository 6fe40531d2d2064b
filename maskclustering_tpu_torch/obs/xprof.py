"""Span-triggered ``torch.profiler`` trace capture (the port's
``maskclustering_tpu/obs/xprof.py``).

Whole-run profiler traces are huge and usually wasted: the question is
almost always "what does ONE clustering step / ONE association look like on
the device timeline". This module arms trace capture from the span tracer
instead: when a span whose name matches the armed set opens, a
``torch.profiler.profile`` session starts (CUDA activity on a card, CPU
activity always); when that same span closes, the session stops and its
Chrome trace goes to ``<dir>/<span-name>-<k>/trace.json``. Rules:

- **bounded**: at most ``limit`` captures per span name (default 1);
- **non-reentrant**: a capture owns the profiler until its span closes;
  nested/overlapping armed spans do not start a second session (torch, as
  jax, has one profiler session a process);
- **best-effort**: a profiler that fails to start or stop logs once and
  disarms the PROFILER, never the run it profiles.

The port's kernels launch through ``ctypes``, not aten; CUPTI still records
them as CUDA kernel events under their ``__global__`` names.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

log = logging.getLogger("maskclustering_tpu_torch")

TRACE_FILE = "trace.json"


def profiler_activities():
    """CPU activity, plus CUDA activity when a card is present."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class XprofArm:
    """Armed capture state; consulted by Span.__enter__/__exit__."""

    def __init__(self, trace_dir: str, spans: Sequence[str], *, limit: int = 1):
        self.trace_dir = trace_dir
        # "*" arms every span — useful for one-shot smoke captures
        self.spans = frozenset(spans)
        self.limit = max(int(limit), 1)
        self.captured: Dict[str, int] = {}
        self.active_span: Optional[str] = None
        self.dead = False
        self._prof = None
        self._out: Optional[str] = None

    def _matches(self, name: str) -> bool:
        return "*" in self.spans or name in self.spans

    def maybe_start(self, name: str) -> bool:
        """Start a capture for this span; True iff this span now owns it."""
        if self.dead or self.active_span is not None or not self._matches(name):
            return False
        k = self.captured.get(name, 0)
        if k >= self.limit:
            return False
        out = os.path.join(self.trace_dir, f"{name.replace('/', '_')}-{k}")
        try:
            import torch

            os.makedirs(out, exist_ok=True)
            prof = torch.profiler.profile(activities=profiler_activities())
            prof.__enter__()
        except Exception:  # noqa: BLE001 — never sink the run being profiled
            log.exception("xprof: profiler start failed; disarming (%s)", out)
            self.dead = True
            return False
        self._prof, self._out = prof, out
        self.active_span = name
        self.captured[name] = k + 1
        log.info("xprof: capturing span %r -> %s", name, out)
        return True

    def stop(self, name: str) -> None:
        """Stop the capture this span owns (no-op for non-owners)."""
        if self.active_span != name:
            return
        self.active_span = None
        prof, out, self._prof = self._prof, self._out, None
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(out, TRACE_FILE))
        except Exception:  # noqa: BLE001 — a flush failure must not mask
            # the span body's real exception
            log.exception("xprof: profiler stop failed; disarming")
            self.dead = True

    def close(self) -> None:
        """Disarm; stops a capture left open by a crashed span body."""
        if self.active_span is not None:
            self.stop(self.active_span)
        self.dead = True


def parse_spans(spec: str) -> Sequence[str]:
    """CLI form: comma-joined span names, e.g. ``cluster,associate``
    (``*`` = every span)."""
    return tuple(s for s in spec.split(",") if s)
