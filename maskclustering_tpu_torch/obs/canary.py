"""mct-sentinel canary plane: golden probes against committed digests (the
port's copy of ``maskclustering_tpu/obs/canary.py``).

The other half of obs/digest.py: a serving daemon periodically replays
its warm-up scenes (the router's ``--warm-baseline`` fitted tensors, so
canaries never regenerate scenes host-side) and compares the resulting
invariant digests BYTE-FOR-BYTE against a committed
``canary_goldens.json``. A clean probe proves the daemon still produces
the committed answers; a mismatch is **drift** — silent data corruption,
a numerics regression behind a knob flip, a device whose answers stopped
being the reference's — and trips the whole correctness plane:

- a typed ``canary.drift`` event on the armed obs sink,
- a FlightRecorder postmortem dump naming the offending coordinate,
- the ``canary.drift`` counter, which the telemetry window folds into a
  ``drift`` field and the SLO plane's zero-tolerance ``correctness``
  objective pages on.

The repository's goldens were computed by the JAX package on the CPU. A
port daemon on a card holds its answers to them, so a clean sentinel on
the card says the card reproduces the reference byte for byte.
``write_goldens`` writes only where its caller says: regenerating the
committed file is an audited step of the JAX package's tooling.

Canary traffic is fenced from tenant accounting, admission metering, the
latency window and serve ledger gating by construction: probes execute
through ``ServeWorker.run_canary`` (never the admission queue), book only
``canary.*`` counters, and the ledger stamps ``canary_drift`` so
--regress fences drifted rows both ways (obs/ledger.sentinel_dimension).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from maskclustering_tpu_torch import obs
from maskclustering_tpu_torch.analysis.lock_sanitizer import mct_lock
from maskclustering_tpu_torch.obs import digest as digest_mod
from maskclustering_tpu_torch.obs import flight

log = logging.getLogger("maskclustering_tpu_torch")

GOLDENS_VERSION = 1
DEFAULT_GOLDENS_PATH = "canary_goldens.json"


# ---------------------------------------------------------------------------
# goldens file (committed, versioned, ratcheted)
# ---------------------------------------------------------------------------


def load_goldens(path: str = DEFAULT_GOLDENS_PATH) -> Optional[Dict]:
    """The committed goldens doc, or None when absent/unreadable/stale.

    A version skew (file format OR digest schema) invalidates the whole
    file — serving with goldens that mean something else would turn every
    probe into a false drift, so a stale file reads as "no goldens" and
    the caller logs the regeneration instruction.
    """
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict):
        return None
    if doc.get("version") != GOLDENS_VERSION \
            or doc.get("digest_version") != digest_mod.DIGEST_VERSION:
        log.warning("canary goldens %s carry version %s/digest %s (want "
                    "%s/%s) — regenerate via --write-goldens", path,
                    doc.get("version"), doc.get("digest_version"),
                    GOLDENS_VERSION, digest_mod.DIGEST_VERSION)
        return None
    if not isinstance(doc.get("goldens"), dict):
        return None
    return doc


def write_goldens(path: str, goldens: Dict[str, Dict], *,
                  config: Optional[Dict] = None) -> Dict:
    """Write the versioned goldens doc (atomic tmp+rename, sorted keys —
    the diff a regeneration produces is the audit artifact)."""
    doc = {
        "version": GOLDENS_VERSION,
        "digest_version": digest_mod.DIGEST_VERSION,
        "config": config or {},
        "goldens": {k: goldens[k] for k in sorted(goldens)},
    }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return doc


def probes_to_goldens(probes: List[Dict]) -> Dict[str, Dict]:
    """Goldens mapping (coord -> golden row) from one canary round."""
    out: Dict[str, Dict] = {}
    for p in probes or []:
        if not p.get("coord") or not p.get("digest"):
            continue
        row = dict(p["digest"])
        row["scene"] = p.get("scene")
        out[p["coord"]] = row
    return out


def default_pipeline_cfg(point_chunk: int):
    """The JAX cost observatory's lowering config
    (``maskclustering_tpu/obs/cost.py:300``), which the goldens derive
    from; the port copies this one function of that module."""
    from maskclustering_tpu_torch.config import PipelineConfig

    return PipelineConfig(config_name="cost_observatory", dataset="demo",
                          distance_threshold=0.01, few_points_threshold=25,
                          point_chunk=point_chunk)


def goldens_config():
    """The ONE PipelineConfig goldens are generated (and probed) under:
    the JAX package's, so a port probe lands on the committed coordinates.
    """
    return default_pipeline_cfg(point_chunk=8192).replace(
        frame_pad_multiple=32, mask_pad_multiple=256)


def generate_goldens(cfg=None, *,
                     baseline_path: str = "compile_surface_baseline.json",
                     device=None) -> Dict[str, Dict]:
    """One in-process canary round over the warm vocabulary -> goldens.

    A Router seeded from the committed surface baseline's workload, a
    thread-less ServeWorker on ``device`` warmed per distinct bucket, then
    an inline ``run_canary`` — exactly the scenes a sentinel-armed daemon
    probes, without spawning one. Returns the mapping; writing it is
    ``write_goldens``'s, to a path the caller names.
    """
    from maskclustering_tpu_torch.serve.admission import AdmissionQueue
    from maskclustering_tpu_torch.serve.router import Router
    from maskclustering_tpu_torch.serve.worker import ServeWorker

    if cfg is None:
        cfg = goldens_config()
    router = Router(cfg, baseline_path=baseline_path)
    if not router.vocabulary:
        raise ValueError(f"no serving vocabulary in {baseline_path} — "
                         f"goldens need the surface baseline's workload")
    worker = ServeWorker(cfg, AdmissionQueue(capacity=1, metered=False),
                         router, device=device)
    for name, tensors in router.warmup_workload():
        if not worker.warm_tensors(name, tensors):
            raise RuntimeError(f"goldens warm-up failed for scene {name!r}")
    probes = worker.run_canary()
    goldens = probes_to_goldens(probes)
    if not goldens:
        raise RuntimeError("canary round produced no probes — goldens "
                           "would be empty")
    return goldens


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------


def compare_probe(probe: Dict, goldens_doc: Dict) -> Dict:
    """One probe vs the goldens: a verdict row for the drift plane.

    ``status``: "ok" (byte-equal), "drift" (mismatch — the page-worthy
    outcome) or "uncovered" (no golden at this coordinate — a vocabulary
    change that should have regenerated goldens; the ratchet catches the
    committed file, this catches the live daemon).
    """
    coord = probe.get("coord") or ""
    golden = (goldens_doc.get("goldens") or {}).get(coord)
    if golden is None:
        return {"coord": coord, "scene": probe.get("scene"),
                "status": "uncovered", "fields": ["missing"]}
    fields = digest_mod.diff_digests(probe.get("digest"), golden)
    return {"coord": coord, "scene": probe.get("scene"),
            "status": "drift" if fields else "ok", "fields": fields,
            "observed": probe.get("digest"), "golden": golden}


# ---------------------------------------------------------------------------
# the idle-aware scheduler
# ---------------------------------------------------------------------------


class CanarySentinel:
    """Periodic golden probes on a serving daemon, idle-aware.

    ``run_round`` executes one canary round and returns probe rows
    (``ServeWorker.run_canary`` or the supervisor's pipe equivalent);
    ``is_idle`` gates firing — a busy daemon skips the tick (typed
    ``canary.skipped_busy`` counter) so canaries never add latency to
    real traffic. On drift: typed event + flight dump + ``canary.drift``
    counter (-> telemetry ``drift`` window field -> SLO ``correctness``).
    """

    def __init__(self, *, run_round: Callable[[], Optional[List[Dict]]],
                 goldens: Dict, interval_s: float = 60.0,
                 is_idle: Optional[Callable[[], bool]] = None):
        self.run_round = run_round
        self.goldens = goldens
        self.interval_s = max(float(interval_s), 0.05)
        self.is_idle = is_idle or (lambda: True)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = mct_lock("obs.CanarySentinel._lock")
        # drift bookkeeping for the sentinel status panel / report section
        self._rounds = 0
        self._drift_total = 0
        self._skipped_busy = 0
        self._last_results: List[Dict] = []
        self._last_verified: Dict[str, float] = {}  # coord -> monotonic ts
        self._drift_coords: Dict[str, int] = {}

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(  # mct-thread: abandon(daemon-lifetime thread, bounded-joined in stop(); spawn/join spans methods)
            target=self._loop, daemon=True, name="canary-sentinel")
        self._thread.start()

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout_s)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the sentinel must not kill serving
                log.exception("canary sentinel tick failed")

    # -- one tick -----------------------------------------------------------

    def tick(self) -> Optional[List[Dict]]:
        """One scheduler tick: skip when busy, else probe + compare.

        Returns the verdict rows (None when skipped) — the unit tests and
        the drill drive this directly for determinism.
        """
        if not self.is_idle():
            obs.count("canary.skipped_busy")
            with self._lock:
                self._skipped_busy += 1
            return None
        probes = self.run_round()
        if probes is None:
            obs.count("canary.skipped_busy")
            with self._lock:
                self._skipped_busy += 1
            return None
        results = [compare_probe(p, self.goldens) for p in probes]
        now = time.monotonic()
        drifted = [r for r in results if r["status"] != "ok"]
        with self._lock:
            self._rounds += 1
            self._last_results = results
            for r in results:
                if r["status"] == "ok":
                    self._last_verified[r["coord"]] = now
                else:
                    self._drift_total += 1
                    self._drift_coords[r["coord"]] = (
                        self._drift_coords.get(r["coord"], 0) + 1)
        for r in drifted:
            self._on_drift(r)
        return results

    def _on_drift(self, result: Dict) -> None:
        obs.count("canary.drift")
        # the typed event: the machine-readable drift record on the armed
        # sink (events.jsonl / the child relay), next to the flight rows
        obs.emit_event("canary.drift", {
            "coord": result["coord"], "scene": result.get("scene"),
            "status": result["status"], "fields": result.get("fields"),
            "observed": result.get("observed"), "golden": result.get("golden"),
        })
        flight.record("flight.canary", what="drift", coord=result["coord"],
                      scene=str(result.get("scene")),
                      fields=",".join(result.get("fields") or []))
        # the postmortem: ring contents + the offending coordinate, dumped
        # the moment drift is detected (the state that produced it is
        # still warm in the ring)
        flight.dump("canary_drift", extra_rows=[{
            "kind": "canary.drift", "coord": result["coord"],
            "scene": result.get("scene"), "fields": result.get("fields"),
            "observed": result.get("observed"),
            "golden": result.get("golden"),
        }])
        log.error("canary DRIFT at %s (scene %s): fields %s — outputs no "
                  "longer match committed goldens", result["coord"],
                  result.get("scene"), result.get("fields"))

    # -- introspection ------------------------------------------------------

    def stats(self) -> Dict:
        """The sentinel panel's snapshot (protocol status detail
        "sentinel", obs.top, the drill's assertions)."""
        now = time.monotonic()
        with self._lock:
            return {
                "rounds": self._rounds,
                "drift_total": self._drift_total,
                "skipped_busy": self._skipped_busy,
                "interval_s": self.interval_s,
                "coords": sorted(self._last_verified),
                "last_verified_age_s": {
                    c: round(now - t, 1)
                    for c, t in sorted(self._last_verified.items())},
                "drift_coords": dict(self._drift_coords),
                "last_results": [
                    {k: r.get(k) for k in ("coord", "scene", "status",
                                           "fields")}
                    for r in self._last_results],
            }
