"""Process-local metrics registry: counters, gauges, histograms (the port's
copy of ``maskclustering_tpu/obs/metrics.py``, the same flat names).

Covers shape-bucket hits and misses (``utils/compile_cache.py``),
host<->device bytes per stage, scene and request retry and failure counts
(``run.py``, ``utils/faults.py``, ``serve/``), and live device-memory
gauges sampled at span ends (``obs/tracer.py``; ``torch.cuda.memory_stats``
of the card, None on the CPU).

Design constraints, in order:

1. **near-zero cost** — a counter bump is one uncontended lock + dict add.
   The lock became load-bearing with the overlapped scene executor
   (run.py): the host-tail worker, the prefetch daemons, and the main
   dispatch thread all bump SHARED aggregate keys (``d2h.bytes``, span
   histograms) concurrently, and an unlocked read-modify-write would
   silently drop increments from exactly the numbers the perf ledger
   regresses against. An uncontended CPython lock costs ~100 ns — noise
   against the device work these counters meter.
2. **flat names** — ``h2d.bytes.feed`` not nested objects, so a snapshot
   is one JSON-able dict and a diff is set arithmetic.
3. **bounded memory** — histograms keep a capped reservoir (deterministic
   stride-decimation, not random sampling: reproducible percentiles), and
   ``snapshot()`` carries them as bounded summaries (count/total/p50/p95/
   max) next to the counters and gauges — the report digest and run
   digests consume all three sections, not just the scalars.

Cross-process relay helpers (``snapshot_delta``/``merge_snapshot_delta``):
the serving worker subprocess ships counter increments + changed gauges
over its supervisor pipe and the parent folds them under the same flat
names (obs/telemetry.py) — flat names are what make that fold one
``count()`` per key. The delta schema is the JAX package's, so either
package folds the other's deltas.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch

# the one quantile rule every surface shares lives in the report module
from maskclustering_tpu_torch.obs.report import percentile  # noqa: F401

_HIST_CAP = 4096  # per-histogram value cap before stride decimation


class Histogram:
    """Value series with bounded memory and exact-until-capped percentiles."""

    __slots__ = ("values", "count", "total", "_stride", "_skip")

    def __init__(self):
        self.values: List[float] = []
        self.count = 0
        self.total = 0.0
        self._stride = 1
        self._skip = 0

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        self._skip += 1
        if self._skip >= self._stride:
            self._skip = 0
            self.values.append(value)
            if len(self.values) >= _HIST_CAP:
                # decimate deterministically: keep every other sample and
                # double the stride — percentiles stay representative while
                # memory stays O(cap) over arbitrarily long runs
                self.values = self.values[::2]
                self._stride *= 2

    def percentile(self, q: float) -> Optional[float]:
        if not self.values:
            return None
        vals = sorted(self.values)
        idx = min(int(q / 100.0 * len(vals)), len(vals) - 1)
        return vals[idx]

    def summary(self) -> Dict:
        # one sort serves all three order statistics; the quantile rule is
        # THE shared nearest-rank helper (``percentile`` below) so these
        # summaries cannot silently disagree with any other surface
        vals = sorted(self.values)
        return {
            "count": self.count,
            "total": self.total,
            "p50": percentile(vals, 50) if vals else None,
            "p95": percentile(vals, 95) if vals else None,
            "max": vals[-1] if vals else None,
        }


class Registry:
    """Flat-namespace counters/gauges/histograms with one snapshot call."""

    def __init__(self):
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    # -- write paths (hot) --------------------------------------------------
    def count(self, name: str, delta: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + delta

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def gauge_max(self, name: str, value: float) -> None:
        """High-water gauge: keeps the max ever seen (HBM high-water)."""
        with self._lock:
            cur = self._gauges.get(name)
            if cur is None or value > cur:
                self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists.setdefault(name, Histogram())
            h.observe(float(value))

    # -- read paths ---------------------------------------------------------
    def histogram(self, name: str) -> Optional[Histogram]:
        return self._hists.get(name)

    def snapshot(self, *, include_histograms: bool = True) -> Dict:
        """One JSON-able dict of everything; cheap enough to flush per scene.

        ``include_histograms=False`` skips the per-histogram summaries —
        each one sorts its (up to 4096-sample) reservoir under the
        registry lock, which the telemetry hot paths (relay deltas,
        window rolls, status polls) neither ship nor need.
        """
        with self._lock:  # a concurrent insert would break dict iteration
            out = {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
            }
            if include_histograms:
                out["histograms"] = {k: h.summary()
                                     for k, h in self._hists.items()}
            return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


def snapshot_delta(prev: Dict, cur: Dict) -> Dict:
    """Counter/gauge delta between two ``Registry.snapshot()`` dicts.

    The telemetry relay's wire shape (obs/telemetry.py): counters ship as
    INCREMENTS (cur - prev, changed keys only — a fold is one ``count()``
    per key), gauges ship as their current values (changed keys only —
    gauges are last-value semantics, so a fold is one ``gauge()``).
    Histograms do NOT ride the delta: the relay ships the completed spans
    themselves and the receiver replays them, so the merged histograms
    hold real samples.
    """
    prev_c = prev.get("counters") or {}
    cur_c = cur.get("counters") or {}
    counters = {}
    for k, v in cur_c.items():
        d = v - prev_c.get(k, 0.0)
        if d:
            counters[k] = d
    prev_g = prev.get("gauges") or {}
    gauges = {k: v for k, v in (cur.get("gauges") or {}).items()
              if prev_g.get(k) != v}
    return {"counters": counters, "gauges": gauges}


def merge_snapshot_delta(delta: Dict, reg: Optional["Registry"] = None) -> None:
    """Fold one ``snapshot_delta`` payload into a registry (the relay's
    receiving half): counter increments via ``count``, gauges via ``gauge``
    — except ``*high_water*`` names, which keep max-ever semantics so a
    late-arriving stale relay line cannot LOWER a high-water mark."""
    reg = reg or _REGISTRY
    for k, v in (delta.get("counters") or {}).items():
        if isinstance(v, (int, float)):
            reg.count(str(k), float(v))
    for k, v in (delta.get("gauges") or {}).items():
        if not isinstance(v, (int, float)):
            continue
        if "high_water" in str(k):
            reg.gauge_max(str(k), float(v))
        else:
            reg.gauge(str(k), float(v))


_REGISTRY = Registry()


def registry() -> Registry:
    return _REGISTRY


# module-level conveniences: the instrumentation call sites read better as
# obs.count("...") than obs.registry().count("...")
count = _REGISTRY.count
gauge = _REGISTRY.gauge
gauge_max = _REGISTRY.gauge_max
observe = _REGISTRY.observe


def count_transfer(direction: str, nbytes: int, stage: str) -> None:
    """Account one host<->device transfer: per-stage + total counters.

    direction: "h2d" or "d2h". Call sites pass nbytes from the host-side
    buffer (``arr.nbytes``); this measures payload, not link framing.
    """
    _REGISTRY.count(f"{direction}.bytes.{stage}", float(nbytes))
    _REGISTRY.count(f"{direction}.bytes", float(nbytes))


_DEVICE: Optional[torch.device] = None


def set_device(device) -> None:
    """The card whose memory ``sample_hbm`` reads (the serving worker's;
    None: the current CUDA device when there is one)."""
    global _DEVICE
    _DEVICE = None if device is None else torch.device(device)


def sample_hbm() -> Optional[Dict[str, float]]:
    """Live device-memory stats of the card, or None on the CPU.

    ``torch.cuda.memory_stats`` is a host-side read of the caching
    allocator (no device sync, safe at span ends). Its
    ``allocated_bytes.all.current/peak`` are reported under the JAX
    package's keys, ``bytes_in_use`` and ``peak_bytes_in_use``.
    """
    dev = _DEVICE
    if dev is not None and dev.type != "cuda":
        return None
    try:
        if dev is None:
            # is_initialized() reads a flag of this process; it asks the
            # driver nothing, so a process that never used the card (the
            # daemon of a subprocess worker) never loads it here
            if not torch.cuda.is_initialized():
                return None
            dev = torch.device("cuda", torch.cuda.current_device())
        stats = torch.cuda.memory_stats(dev)
    except Exception:  # noqa: BLE001 — no card / no allocator stats
        return None
    if not stats:
        return None
    out = {"bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
           "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0))}
    _REGISTRY.gauge("hbm.bytes_in_use", out["bytes_in_use"])
    _REGISTRY.gauge_max("hbm.high_water_bytes", out["bytes_in_use"])
    return out
