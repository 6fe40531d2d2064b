"""Retrace family, dynamic half: the opt-in build/launch-surface sanitizer
(the port's counterpart of ``maskclustering_tpu/analysis/retrace_sanitizer.py``).

Nothing in the port traces, so its compile surface is the ``nvcc`` builds
of ``ops/cuda/*.cu`` and its program surface the set of (kernel entry,
launch shape) pairs the wrappers launch (``ops.cuda.LAUNCHES.shapes``).
This shim records both, keyed with the degradation-ladder context, and
checks them against the serve-many contract:

- a **repeat build** (the same library built twice in one context: a
  process that dropped its loaded kernels or lost its build directory) is
  always a violation;
- after :func:`freeze` (a warm process: the serving daemon freezes after
  its warm-up) any NEW build or launch key is a violation: a warm
  same-bucket scene launches only the shapes warm-up launched and builds
  nothing;
- ladder rungs switch the **context** tag (the batch driver's supervisor
  calls :func:`set_context` when the ladder drops a rung), so a rung's
  first launches are new keys in a new context.

The bucket classifier is one vocabulary across both halves:
``utils/compile_cache.record_shape_bucket`` notifies :func:`note_bucket`
of every new shape bucket, so the digest reads "N builds against M new
buckets". The counters and digest keep the JAX names (``retrace.compiles``
counts builds, ``distinct_keys`` launch keys), so each package's report
reads the other's. ``cache_hits`` and ``aot_restores`` count the kernel
build cache's restores (``utils/aot_cache.py``).

Opt-in via ``run.py --retrace-sanitizer`` or ``MCT_RETRACE_SANITIZER=1``
and :func:`install`; off (the default) nothing is hooked. Results are
identical either way: the hooks only observe.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set, Tuple

ENV_FLAG = "MCT_RETRACE_SANITIZER"
DEFAULT_CONTEXT = "baseline"

_armed: Optional[bool] = None


def arm(on: Optional[bool]) -> None:
    """Explicitly enable/disable the sanitizer (``None`` defers to env);
    the hooks themselves need :func:`install` (run.py does both)."""
    global _armed
    _armed = on


def enabled() -> bool:
    if _armed is not None:
        return _armed
    return os.environ.get(ENV_FLAG, "").strip().lower() in ("1", "true", "on", "yes")


class _State:
    """Builds and launch keys observed since the last reset."""

    def __init__(self):
        self.lock = threading.Lock()
        self.builds: Dict[Tuple[str, str, str], int] = {}
        self.keys: Dict[Tuple[str, str, str], int] = {}
        self.violations: List[Dict] = []
        self.context = DEFAULT_CONTEXT
        self.frozen = False
        self.buckets_new = 0

    def on_build(self, name: str, path: str) -> None:
        with self.lock:
            key = (name, os.path.basename(path), self.context)
            n = self.builds.get(key, 0) + 1
            self.builds[key] = n
            if n > 1:
                self.violations.append({"kind": "repeat", "fn": f"nvcc:{name}",
                                        "sig": key[1], "context": self.context, "count": n})
            elif self.frozen:
                self.violations.append({"kind": "post_freeze", "fn": f"nvcc:{name}",
                                        "sig": key[1], "context": self.context})

    def on_launch(self, name: str, shape: Tuple[int, ...]) -> None:
        sig = "x".join(str(int(d)) for d in shape)
        key = (name, sig, self.context)
        with self.lock:
            n = self.keys.get(key, 0)
            self.keys[key] = n + 1
            if n == 0 and self.frozen:
                self.violations.append({"kind": "post_freeze", "fn": name, "sig": sig,
                                        "context": self.context})


_STATE = _State()
_installed = False
_INSTALL_LOCK = threading.Lock()


def reset() -> None:
    """Drop everything observed so far (test isolation)."""
    global _STATE
    _STATE = _State()


def set_context(tag: str) -> None:
    """Tag later builds and launches with a degradation-ladder context."""
    with _STATE.lock:
        _STATE.context = tag or DEFAULT_CONTEXT


def freeze() -> None:
    """Declare the process warm: every NEW build or launch key is a violation."""
    with _STATE.lock:
        _STATE.frozen = True


def note_bucket(new: bool) -> None:
    """Bucket-classifier seam (``utils/compile_cache.record_shape_bucket``)."""
    if not new or not enabled():
        return
    with _STATE.lock:
        _STATE.buckets_new += 1


def snapshot_keys() -> Set[Tuple[str, str, str]]:
    """The (entry, launch shape, context) keys observed since the last reset."""
    with _STATE.lock:
        return set(_STATE.keys)


def violations() -> List[Dict]:
    with _STATE.lock:
        return list(_STATE.violations)


def _restores() -> int:
    from maskclustering_tpu_torch.utils import aot_cache

    cache = aot_cache.active()
    return int(cache.stats["restored"]) if cache is not None else 0


def digest() -> Dict:
    """JSON-able digest of everything observed since the last reset, in the
    JAX digest's schema: ``compiles`` are ``nvcc`` builds, ``by_fn`` counts
    builds and launch keys by kernel, ``distinct_keys`` the launch keys."""
    restores = _restores()
    with _STATE.lock:
        by_fn: Dict[str, int] = {}
        for (name, _, _), n in _STATE.builds.items():
            by_fn[f"nvcc:{name}"] = by_fn.get(f"nvcc:{name}", 0) + n
        for (name, _, _) in _STATE.keys:
            by_fn[name] = by_fn.get(name, 0) + 1
        builds = sum(_STATE.builds.values())
        return {
            "compiles": builds,
            "raw_compiles": builds,
            "cache_hits": restores,
            "aot_restores": restores,
            "distinct_keys": len(_STATE.keys),
            "by_fn": dict(sorted(by_fn.items())),
            "violations": list(_STATE.violations),
            "buckets_new": _STATE.buckets_new,
            "backend_compiles": builds,
            "context": _STATE.context,
            "frozen": _STATE.frozen,
        }


def summary() -> Dict:
    """The compact serving-digest shape of the JAX package: one schema for
    the daemon's stats/digest line and the isolated worker's ready/bye
    lines, plus the port's ``launch_keys``."""
    d = digest()
    return {
        "compiles": d["compiles"],
        "cache_hits": d["cache_hits"],
        "aot_restores": d["aot_restores"],
        "post_freeze": sum(1 for v in d["violations"] if v["kind"] == "post_freeze"),
        "repeats": sum(1 for v in d["violations"] if v["kind"] == "repeat"),
        "frozen": d["frozen"],
        "launch_keys": d["distinct_keys"],
    }


def emit_counters() -> None:
    """Book the digest on the obs metrics registry (the report's Analysis
    section renders the retrace line from these)."""
    from maskclustering_tpu_torch.obs import metrics

    d = digest()
    metrics.count("retrace.compiles", float(d["compiles"]))
    metrics.count("retrace.distinct_programs", float(len(d["by_fn"])))
    metrics.count("retrace.buckets_new", float(d["buckets_new"]))
    if d["cache_hits"]:
        metrics.count("retrace.cache_hits", float(d["cache_hits"]))
    if d["aot_restores"]:
        metrics.count("retrace.aot_restores", float(d["aot_restores"]))
    repeats = sum(1 for v in d["violations"] if v["kind"] == "repeat")
    frozen = sum(1 for v in d["violations"] if v["kind"] == "post_freeze")
    if repeats:
        metrics.count("retrace.repeat_compiles", float(repeats))
    if frozen:
        metrics.count("retrace.post_freeze_compiles", float(frozen))


def live_gauges() -> Dict[str, float]:
    """The ``retrace.live.*`` gauges the telemetry windows carry."""
    s = summary()
    return {"retrace.live.post_freeze": float(s["post_freeze"]),
            "retrace.live.compiles": float(s["compiles"]),
            "retrace.live.repeats": float(s["repeats"])}


def _on_build(name: str, path: str) -> None:
    _STATE.on_build(name, path)


def _on_launch(name: str, shape) -> None:
    _STATE.on_launch(name, tuple(shape))


def install() -> None:
    """Hook the kernel builds and launches (idempotent)."""
    global _installed
    from maskclustering_tpu_torch.ops import cuda

    with _INSTALL_LOCK:
        if _installed:
            return
        cuda.BUILD_HOOKS.append(_on_build)
        cuda.LAUNCH_HOOKS.append(_on_launch)
        _installed = True


def uninstall() -> None:
    global _installed
    from maskclustering_tpu_torch.ops import cuda

    with _INSTALL_LOCK:
        if _on_build in cuda.BUILD_HOOKS:
            cuda.BUILD_HOOKS.remove(_on_build)
        if _on_launch in cuda.LAUNCH_HOOKS:
            cuda.LAUNCH_HOOKS.remove(_on_launch)
        _installed = False
