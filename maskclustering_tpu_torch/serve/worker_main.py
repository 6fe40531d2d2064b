"""The process-isolated serving worker: one subprocess, one card owner.

``python -m maskclustering_tpu_torch.serve.worker_main --cfg-json PATH`` is
the child half of the crash-containment story (serve/supervisor.py is the
parent), the port's copy of ``maskclustering_tpu/serve/worker_main.py``:
the card-owning execution lives outside the daemon's process, so a hard
CUDA fault (an illegal address or an ECC error poisons the process's
context; only a new process recovers), a segfault, an OOM kill or a
wedged driver call costs one SIGKILL + respawn instead of the whole
serving process, its admission queue and every connected client.

Wire contract (line-delimited JSON over the stdio pipes; the JAX
package's, key for key):

- stdin  <- ``{"op": "scene", "id": ..., ...}`` (protocol.forward_request
  shape: remaining deadline, crash count), ``{"op": "batch",
  "requests": [...]}`` (protocol.forward_batch: a same-bucket pack whose
  members land in the local queue together so the worker's own scheduler
  re-fuses them), ``{"op": "canary"}`` (one sentinel probe round; answers
  ``{"kind": "canary", "probes": ...}``) and ``{"op": "shutdown"}``; EOF
  == shutdown.
- stdout -> ``{"kind": "ready", ...}`` once warm (the warm-up wall),
  ``{"kind": "hb"}`` heartbeats at a fixed cadence, ``telem`` relay lines
  (obs/telemetry.py), the standard per-request ``status``/``result``
  events, and ``{"kind": "bye", ...}`` after a drain. ``ready`` and
  ``bye`` carry ``retrace`` (the build/launch-surface sanitizer's
  summary, ``{}`` with it off) and ``aot`` (``ready``: the kernel build
  cache's warm start, ``{}`` without a cache), as the JAX worker's do, and
  one port-only key, ``cuda``: the seconds of each ``nvcc`` build this process
  ran (``ops.cuda.build``; ``{}`` when the libraries were already built),
  the kernel launch counts (``ops.cuda.LAUNCHES``) and the card's
  ``torch.cuda.max_memory_allocated`` — the only way the parent, which
  never touches the card, sees what its child launched.

stdout is the protocol and nothing else: at start the process keeps a
private duplicate of its stdout for the wire and points file descriptor 1
(and ``sys.stdout``) at stderr, so a stray ``print``, a torch warning or
a C library's output can never corrupt a protocol line.

The card's first use runs under a watchdog (``--init_timeout``), and the
kernel libraries are built before ``ready`` (under the supervisor's start
budget, not its heartbeat budget). A child that cannot initialise its
device exits non-zero: the supervisor counts a failed spawn and never
retries on another device.

The heartbeat is emitted by a dedicated thread so a busy device phase
never silences it — only a process-level wedge does (a GIL-held native
hang stops every Python thread, which is exactly what the parent's
``faults.Heartbeat`` budget detects; the ``wedge`` fault kind simulates
it deterministically by silencing the emitter via ``faults.set_wedge_hook``
before hanging).

Execution semantics are ServeWorker's, verbatim — the same per-request
SceneSupervisor, deadline folding, per-request journal and bucket
accounting the in-thread daemon worker runs — fed by a local two-slot
admission queue this process's stdin reader fills. One copy of the
serving semantics, two process topologies.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading
import time

from maskclustering_tpu_torch.analysis.lock_sanitizer import mct_lock

log = logging.getLogger("maskclustering_tpu_torch")


def _wire_stdout():
    """A private text stream on the process's real stdout, with fd 1 and
    ``sys.stdout`` pointed at stderr from here on."""
    sys.stdout.flush()
    wire = os.fdopen(os.dup(1), "w", encoding="utf-8", buffering=1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    return wire


def _retrace_digest() -> dict:
    from maskclustering_tpu_torch.analysis import retrace_sanitizer

    return retrace_sanitizer.summary() if retrace_sanitizer.enabled() else {}


def _cuda_digest(device) -> dict:
    """The ``cuda`` key of ``ready`` and ``bye``: builds, launches, peak."""
    import torch

    from maskclustering_tpu_torch.ops import cuda as ops_cuda

    peak = None
    if device.type == "cuda":
        peak = int(torch.cuda.max_memory_allocated(device))
    return {"build_s": {k: round(v, 3) for k, v in ops_cuda.BUILT.items()},
            "launches": dict(sorted(ops_cuda.LAUNCHES.counts.items())),
            "max_memory_allocated": peak}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="maskclustering_tpu_torch.serve.worker_main",
        description="card-owning serving worker subprocess (JSONL over "
                    "stdio; spawned by serve/supervisor.py)")
    parser.add_argument("--cfg-json", required=True,
                        help="path to the daemon's serialized PipelineConfig "
                             "(config.to_json) — field-for-field fidelity, "
                             "no re-derivation drift")
    parser.add_argument("--journal-dir", default=None)
    parser.add_argument("--prediction-root", default=None)
    parser.add_argument("--stream-state", default=None,
                        help="SHARED per-chunk stream snapshot directory "
                             "(stream-session failover): a respawned or "
                             "neighbour worker resumes the stream from it "
                             "instead of stream_lost")
    parser.add_argument("--warm", default=None,
                        help="+-joined scene names to run end-to-end before "
                             "answering ready")
    parser.add_argument("--warm-baseline", default=None,
                        help="surface-baseline path for vocabulary warm-up")
    parser.add_argument("--fault-plan", default=None,
                        help="drill spec (the supervisor passes it to the "
                             "FIRST spawn only — a respawn is the recovery "
                             "under test, not the drill target)")
    parser.add_argument("--worker-id", type=int, default=0,
                        help="pool slice id (serve/pool.py); stamps logs "
                             "and the ready/bye digests")
    parser.add_argument("--device", default="cuda",
                        help="torch device of this worker (default: the CUDA "
                             "card; 'cpu' runs the plain torch path)")
    parser.add_argument("--hb-interval", type=float, default=1.0)
    parser.add_argument("--telem-interval", type=float, default=2.0,
                        help="seconds between periodic telemetry relay "
                             "flushes (request boundaries flush too; "
                             "0 disables the relay)")
    parser.add_argument("--init_timeout", type=float, default=120.0,
                        help="watchdog seconds for the device's first use")
    parser.add_argument("--no-freeze", action="store_true",
                        help="do not freeze the retrace sanitizer post-warm")
    parser.add_argument("--retrace-sanitizer", action="store_true")
    parser.add_argument("--debug", action="store_true")
    args = parser.parse_args(argv)

    wire = _wire_stdout()
    logging.basicConfig(
        stream=sys.stderr,
        level=logging.DEBUG if args.debug else logging.INFO,
        format=f"%(asctime)s worker{args.worker_id}[%(process)d] "
               "%(levelname)s %(message)s")

    from maskclustering_tpu_torch.config import config_from_json

    with open(args.cfg_json, "r", encoding="utf-8") as f:
        cfg = config_from_json(f.read())

    from maskclustering_tpu_torch.utils import faults

    if args.fault_plan:
        faults.set_plan(faults.FaultPlan.from_spec(args.fault_plan))
    faults.install_sigterm_handler()
    from maskclustering_tpu_torch.analysis import retrace_sanitizer

    if args.retrace_sanitizer:
        retrace_sanitizer.arm(True)
    if retrace_sanitizer.enabled():
        retrace_sanitizer.install()

    out_lock = mct_lock("serve.worker_main.out_lock")

    def emit_raw(doc: dict) -> None:
        with out_lock:
            wire.write(json.dumps(doc, sort_keys=True) + "\n")
            wire.flush()

    # the telemetry relay (obs/telemetry.py): spans + registry deltas ship
    # up the pipe so the parent's Serving report / windows / status op
    # read alike in both topologies — nothing stays stranded in this process
    from maskclustering_tpu_torch import obs
    from maskclustering_tpu_torch.obs import flight, telemetry

    relay = telemetry.ChildRelay() if args.telem_interval > 0 else None
    if relay is not None:
        obs.configure_sink(relay.sink)
    # one lock across collect+write: the hb thread and the worker thread
    # both flush, and a collect drained by one thread must hit the pipe
    # before the other thread's (later) result line — otherwise a telem
    # line can land AFTER the result it accounts for and the parent's
    # fold-before-result ordering breaks
    telem_lock = mct_lock("serve.worker_main.telem_lock")

    def flush_telem() -> None:
        if relay is None:
            return
        with telem_lock:
            try:
                doc = relay.collect()
            except Exception:  # noqa: BLE001 — telemetry never faults serving
                log.exception("worker: telemetry collect failed")
                return
            if doc is not None:
                emit_raw(doc)

    def emit(doc: dict) -> None:
        if doc.get("kind") in ("result", "reject"):
            # request boundary: ship this request's counters/spans BEFORE
            # its terminal line — the parent reader folds in pipe order
            flush_telem()
        emit_raw(doc)

    # the heartbeat emitter: alive while the PROCESS is alive (a busy
    # device phase keeps beating; only a process-wide wedge — or the
    # wedge drill's hook below — silences it). The telemetry relay rides
    # the same thread at its own (coarser) cadence.
    hb_stop = threading.Event()

    # the flight-ring delta relay: if this process wedges and eats a
    # SIGKILL, the parent's retained copy of these rows is the only black
    # box left. The hb thread ships on its cadence; the stdin loop also
    # ships right after marking a request received, so the victim's
    # identity reaches the parent BEFORE any crash that request can cause.
    # The lock covers only the snapshot cursor (never the pipe write); the
    # supervisor sorts retained rows on their ``seq`` at dump time.
    flight_lock = mct_lock("serve.worker_main.flight_lock")
    flight_seq = [0]

    def ship_flight() -> None:
        with flight_lock:
            rows, flight_seq[0] = flight.recorder().snapshot(flight_seq[0])
        if rows:
            emit_raw({"kind": flight.KIND_DELTA, "pid": os.getpid(),
                      "rows": rows})

    def hb_loop() -> None:
        last_telem = time.monotonic()
        while not hb_stop.wait(max(args.hb_interval, 0.05)):
            emit_raw({"kind": "hb"})
            ship_flight()
            if relay is not None and \
                    time.monotonic() - last_telem >= args.telem_interval:
                last_telem = time.monotonic()
                flush_telem()

    faults.set_wedge_hook(hb_stop.set)

    import torch

    from maskclustering_tpu_torch.device import resolve_device

    from maskclustering_tpu_torch.utils import aot_cache

    aot_stats: dict = {}
    t0 = time.monotonic()
    try:
        device = resolve_device(args.device)
        # the first use of the card creates its context: bounded, so a
        # wedged driver fails the spawn instead of hanging it
        faults.call_with_deadline(lambda: torch.zeros(1, device=device),
                                  args.init_timeout, seam="load",
                                  scene="device-init")
        # the kernel build cache (cfg.aot_cache_dir / $MCT_AOT_CACHE): on a
        # card, load its libraries and build the rest now
        aot_stats = aot_cache.warm_start(cfg, device=device)
        if device.type == "cuda":
            if device.index is None:
                # the worker thread pins its card by index (set_device)
                device = torch.device("cuda", torch.cuda.current_device())
            # build the kernel libraries now, under the supervisor's start
            # budget: a first request that built them would stay silent on
            # the wire for the whole nvcc wall
            from maskclustering_tpu_torch.ops import cuda as ops_cuda

            ops_cuda.build()
    except Exception:  # noqa: BLE001 — a failed spawn, reported by rc
        log.exception("worker: device %r failed to initialise", args.device)
        return 3

    from maskclustering_tpu_torch.serve import protocol
    from maskclustering_tpu_torch.serve.admission import AdmissionQueue
    from maskclustering_tpu_torch.serve.router import Router
    from maskclustering_tpu_torch.serve.worker import ServeWorker

    # device-memory gauges at span ends read this worker's card
    obs.metrics.set_device(device)
    router = Router(cfg, baseline_path=args.warm_baseline)
    # the supervisor serializes dispatch units; 2 = margin, and a batch
    # envelope lands all its members at once so the packing worker can
    # re-fuse them (capacity must hold a full batch plus margin).
    # metered=False: this queue is pipe plumbing — the PARENT's queue is
    # the admission layer, and this one's counters must not relay up as
    # doubled admission accounting
    queue = AdmissionQueue(
        capacity=max(2, int(getattr(cfg, "serve_batch_max", 1)) + 1),
        metered=False)
    worker = ServeWorker(cfg, queue, router,
                         journal_dir=args.journal_dir,
                         prediction_root=args.prediction_root,
                         stream_state_dir=args.stream_state,
                         device=device)
    # a booked arrival ships at once: if this request then kills the
    # process, the parent has its count, and the respawned child that
    # reruns it books none (``req.crashes``), so it counts once. Left to
    # the heartbeat's cadence, the count of a crashed attempt reached the
    # parent or not by timing, and the parent's request counter and its
    # per-tenant sums disagreed when it had
    worker.after_arrival = flush_telem

    # warm-up mirrors the daemon's _prewarm: drills are suspended so they
    # land on the serving path
    drill = faults.active_plan()
    faults.set_plan(None)
    try:
        for name, tensors in router.warmup_workload():
            worker.warm_tensors(name, tensors)
            worker.warm_batch_executable(name, tensors)
        warm = [s for s in (args.warm or "").split("+") if s]
        if warm:
            from maskclustering_tpu_torch.run import cluster_scenes

            for st in cluster_scenes(cfg, warm, resume=False, device=device,
                                     prediction_root=worker.prediction_root):
                log.info("worker: warm scene %s -> %s", st.seq_name,
                         st.status)
            if int(getattr(cfg, "serve_batch_max", 1) or 1) > 1:
                # classify warm scenes + pay their width-S fused cold
                # dispatch, mirroring daemon._warm_batch_from_disk
                from maskclustering_tpu_torch.datasets import get_dataset

                for name in warm:
                    try:
                        ds = get_dataset(cfg.dataset, name,
                                         data_root=cfg.data_root)
                        tensors = ds.load_scene_tensors(cfg.step)
                    except Exception:
                        log.exception("worker: batch warm skipped for %s",
                                      name)
                        continue
                    router.remember(name, router.classify_tensors(tensors))
                    worker.warm_batch_executable(name, tensors)
    finally:
        faults.set_plan(drill)
    warmup_s = time.monotonic() - t0
    if not args.no_freeze and retrace_sanitizer.enabled():
        retrace_sanitizer.freeze()

    worker.start()
    hb_thread = threading.Thread(target=hb_loop, daemon=True,
                                 name="worker-hb")
    hb_thread.start()
    emit_raw({"kind": "ready", "pid": os.getpid(),
              "worker_id": args.worker_id,
              "warmup_s": round(warmup_s, 2),
              "aot": aot_stats if aot_cache.active() is not None else {},
              "retrace": _retrace_digest(),
              "device": str(device), "cuda": _cuda_digest(device)})
    flush_telem()  # warm-up's counters relay at once
    log.info("worker: ready on %s (warm-up %.1fs)", device, warmup_s)

    # the stdin loop: one dispatch unit at a time from the supervisor; EOF
    # or a shutdown op drains (finish in flight, then bye)
    rc = 0
    for line in sys.stdin:
        if not line.strip():
            continue
        try:
            doc = json.loads(line)
        except ValueError:
            log.error("worker: unreadable pipe line %r", line[:200])
            continue
        op = doc.get("op")
        if op == "shutdown":
            break
        if op == "canary":
            # sentinel probe round (supervisor.run_canary): executes on the
            # worker thread at its next idle poll; queued lines buffer in
            # the pipe until the round answers
            probes = worker.run_canary(
                timeout_s=max(cfg.watchdog_device_s, 60.0))
            emit_raw({"kind": "canary", "id": doc.get("id"),
                      "probes": probes})
            continue
        if op == "batch":
            # the supervisor's packing envelope (protocol.forward_batch):
            # all members land in the local queue in one stdin line, so
            # the worker's own next_batch sees them together
            member_docs = [d for d in (doc.get("requests") or ())
                           if isinstance(d, dict)]
        else:
            if op not in protocol.SCENE_OPS:
                continue
            member_docs = [doc]
        for member in member_docs:
            req = protocol.build_request(member,
                                         str(member.get("id") or "r-local"))
            req.send = emit
            flight.record(flight.KIND_REQUEST, event="received",
                          request=req.id, scene=req.scene, op=req.op,
                          **({"tenant": req.tenant} if req.tenant else {}))
            ship_flight()  # victim identity must reach the parent pre-crash
            try:
                queue.submit(req)
            except Exception as e:  # noqa: BLE001 — answer, never die silently
                emit(protocol.result(req, "failed",
                                     error=f"worker admission: {e}",
                                     error_class="terminal"))
    drained = worker.stop(timeout_s=max(cfg.watchdog_device_s, 60.0) * 2)
    hb_stop.set()
    hb_thread.join(2.0)
    if not drained:
        log.error("worker: in-flight request outlived the drain budget")
        rc = 1
    flush_telem()
    ship_flight()  # final ring delta: the parent's copy ends complete
    emit_raw({"kind": "bye", "worker_id": args.worker_id, "retrace": _retrace_digest(),
              "aot": aot_cache.stats_snapshot(), "counts": worker.stats()["counts"],
              "cuda": _cuda_digest(device)})
    if faults.stop_requested():
        # cooperative drain path, not the signal handler: the black box of
        # a SIGTERM'd worker survives its own exit
        flight.dump("sigterm")
    elif rc:
        flight.dump("drain_timeout")
    return 143 if faults.stop_requested() else rc


if __name__ == "__main__":
    raise SystemExit(main())
