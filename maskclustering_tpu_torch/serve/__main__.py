"""CLI: ``python -m maskclustering_tpu_torch.serve`` — start the daemon.

The JAX CLI's flags (``maskclustering_tpu/serve/__main__.py``) plus
``--device``. Mirrors run.py's operational posture: the card initialised
under a watchdog, SIGTERM -> cooperative drain (exit 143), obs events
armed when a path is given, and ONE machine-readable JSON digest line on
stdout at shutdown (``daemon.stats()``); everything else goes to stderr
via logging. ``--isolate-worker`` runs the worker as a supervised
subprocess and ``--workers``/``--carve``/``--tenants`` a pool of them; the
daemon's own process then never touches the card (the children initialise
it under ``--init_timeout``). ``--retrace-sanitizer`` arms the
build/launch-surface sanitizer (frozen after warm-up unless
``--no-freeze``) and ``--aot-cache`` the kernel build cache, in the daemon
or in each supervised child and pool slice.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from maskclustering_tpu_torch.utils import faults

log = logging.getLogger("maskclustering_tpu_torch")

def _parse_overrides(pairs) -> dict:
    """``--set key=value`` pairs -> typed config overrides.

    Coercion follows the PipelineConfig field's current type (bools accept
    1/0/true/false); unknown keys fail loudly, same as load_config.
    """
    import dataclasses

    from maskclustering_tpu_torch.config import PipelineConfig

    fields = {f.name: f for f in dataclasses.fields(PipelineConfig)}
    out = {}
    for pair in pairs:
        key, sep, value = pair.partition("=")
        if not sep or key not in fields:
            raise SystemExit(f"--set {pair!r}: expected KEY=VALUE with a "
                             f"PipelineConfig field as KEY")
        default = getattr(PipelineConfig(), key)
        if isinstance(default, bool):
            out[key] = value.strip().lower() in ("1", "true", "on", "yes")
        elif isinstance(default, int):
            out[key] = int(value)
        elif isinstance(default, float):
            out[key] = float(value)
        else:
            out[key] = value
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="maskclustering_tpu_torch.serve",
        description="long-lived scene-serving daemon (JSONL over a local "
                    "socket)")
    parser.add_argument("--config", required=True,
                        help="config name under configs/, or the path of a JSON "
                             "config file (its file name without .json names the "
                             "config)")
    parser.add_argument("--socket", default=None,
                        help="AF_UNIX socket path to serve on")
    parser.add_argument("--host", default=None,
                        help="TCP host to serve on instead of --socket "
                             "(with --port; loopback serving only — there "
                             "is no auth layer)")
    parser.add_argument("--port", type=int, default=0,
                        help="TCP port for --host (0 = ephemeral, printed "
                             "on startup)")
    parser.add_argument("--capacity", type=int, default=8,
                        help="admission queue bound (typed queue_full "
                             "reject beyond it)")
    parser.add_argument("--deadline", type=float, default=0.0,
                        help="default per-request deadline seconds "
                             "(0 = none; requests may set their own)")
    parser.add_argument("--journal-dir", default=None,
                        help="per-request RunJournal directory "
                             "(<dir>/<request id>.jsonl; default: "
                             "<data_root>/serve_journals)")
    parser.add_argument("--no-journal", action="store_true",
                        help="disable per-request journals (also disables "
                             "the admission WAL, which lives beside them)")
    parser.add_argument("--no-wal", action="store_true",
                        help="disable the admission WAL (serve/wal.py): no "
                             "crash-replay of admitted requests, no "
                             "idempotency-key dedupe")
    parser.add_argument("--stream-state", default=None, metavar="DIR",
                        help="shared per-chunk stream snapshot directory "
                             "(models/streaming save_state): a crashed "
                             "stream's session re-opens from the latest "
                             "snapshot instead of answering stream_lost "
                             "(default: <data_root>/stream_state)")
    parser.add_argument("--no-stream-state", action="store_true",
                        help="disable stream snapshots/failover (crashed "
                             "streams answer the typed stream_lost)")
    parser.add_argument("--warm", default=None,
                        help="+-joined scene names to run end-to-end "
                             "(exports included) before accepting requests")
    parser.add_argument("--warm-baseline", default=None, nargs="?",
                        const="compile_surface_baseline.json",
                        help="pre-warm the serving vocabulary from this "
                             "surface baseline's workload (flag alone: "
                             "compile_surface_baseline.json)")
    parser.add_argument("--no-freeze", action="store_true",
                        help="do not freeze the retrace sanitizer after warm-up "
                             "(new launch keys while serving are then not violations)")
    parser.add_argument("--obs_events", default=None,
                        help="obs span/metrics JSONL path (the Serving "
                             "report section renders from it; telemetry "
                             "window rows append here too)")
    parser.add_argument("--flight-dir", default=None,
                        help="arm the flight recorder's dump directory "
                             "(obs/flight.py black box; also via "
                             "$MCT_FLIGHT_DIR — the worker subprocess "
                             "inherits it)")
    parser.add_argument("--slo-spec", default=None,
                        help="SLO spec JSON for the status op's detail=slo "
                             "answer (obs/slo.py; default: the canned "
                             "serve-default spec)")
    parser.add_argument("--canary-interval", type=float, default=0.0,
                        help="arm the mct-sentinel canary scheduler: every "
                             "N seconds an idle daemon replays its warm "
                             "scenes and byte-compares the invariant "
                             "digests against canary_goldens.json "
                             "(obs/canary.py; 0 = off)")
    parser.add_argument("--canary-goldens", default=None,
                        help="committed goldens path for --canary-interval "
                             "(default: canary_goldens.json)")
    parser.add_argument("--telemetry-window", type=float, default=5.0,
                        help="telemetry aggregation window seconds "
                             "(obs/telemetry.py ring; the status op's "
                             "detail=telemetry and obs.top read it)")
    parser.add_argument("--retrace-sanitizer", action="store_true",
                        help="arm the build/launch-surface sanitizer (default: "
                             "$MCT_RETRACE_SANITIZER); the daemon freezes it after "
                             "warm-up, so a new kernel build or launch key while "
                             "serving is a violation")
    parser.add_argument("--fault-plan", default=None,
                        help="deterministic fault injection spec "
                             "(testing/drill knob — never in production; "
                             "with --isolate-worker the plan is handed to "
                             "the FIRST worker subprocess, so crash/wedge "
                             "drills land on the supervised path)")
    parser.add_argument("--isolate-worker", action="store_true",
                        help="run the card-owning worker as a supervised "
                             "SUBPROCESS (serve/supervisor.py): heartbeat "
                             "watchdog, SIGKILL-on-wedge, bounded respawn "
                             "with requeue — a CUDA fault costs a respawn, "
                             "not the daemon")
    parser.add_argument("--workers", type=int, default=None,
                        help="run this many worker slices, one supervised "
                             "subprocess each (serve/pool.py; needs "
                             "--isolate-worker; shorthand for --set "
                             "serve_workers=K)")
    parser.add_argument("--carve", default=None, metavar="KxC",
                        help="explicit pool carve, K slices x C cards each "
                             "(shorthand for --set serve_carve=KxC; K must "
                             "equal --workers when both are given)")
    parser.add_argument("--tenants", default=None,
                        metavar="NAME:WEIGHT[:QUOTA],...",
                        help="weighted-fair tenant QoS spec (shorthand for "
                             "--set serve_tenants=...; unknown tenants get "
                             "weight 1, no quota)")
    parser.add_argument("--aot-cache", default=None, nargs="?", const="auto",
                        metavar="DIR",
                        help="arm the kernel build cache (utils/aot_cache.py) so a "
                             "(re)started daemon, child or pool slice loads its CUDA "
                             "libraries instead of building them (flag alone: "
                             "aot_cache/ next to the perf ledger)")
    parser.add_argument("--point-shards", type=int, default=None,
                        help="shard the scene-point axis over this many "
                             "chips (third mesh axis of the fused path; "
                             "needs the config's mesh_shape). Million-"
                             "point requests fit without widening any "
                             "per-chip HBM bucket; shorthand for "
                             "--set point_shards=N")
    parser.add_argument("--set", action="append", default=[],
                        metavar="KEY=VALUE", dest="overrides",
                        help="override a config field (repeatable; value "
                             "coerced to the field's type, e.g. "
                             "--set step=1 --set mask_pad_multiple=32)")
    parser.add_argument("--data_root", default=None,
                        help="override the config's data root")
    parser.add_argument("--prediction-root", default=None,
                        help="artifact root (default: <data_root>/prediction)")
    parser.add_argument("--device", default=None,
                        help="torch device of the worker (default: the CUDA card; "
                             "'cpu' serves the plain torch path on the CPU)")
    parser.add_argument("--init_timeout", type=float, default=120.0,
                        help="watchdog seconds for the device's first use")
    parser.add_argument("--debug", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(
        stream=sys.stderr,  # stdout carries exactly one digest line
        level=logging.DEBUG if args.debug else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.socket is None and args.host is None:
        parser.error("need --socket PATH or --host HOST [--port N]")

    from maskclustering_tpu_torch.config import load_config

    overrides = {"data_root": args.data_root} if args.data_root else {}
    overrides.update(_parse_overrides(args.overrides))
    if args.point_shards is not None:
        overrides["point_shards"] = args.point_shards
    if args.workers is not None:
        overrides["serve_workers"] = args.workers
    if args.carve is not None:
        overrides["serve_carve"] = args.carve
    if args.tenants is not None:
        overrides["serve_tenants"] = args.tenants
    if args.aot_cache is not None:
        overrides["aot_cache_dir"] = args.aot_cache
    if args.config.endswith(".json") and os.path.isfile(args.config):
        cfg = load_config(os.path.basename(args.config)[:-len(".json")],
                          config_dir=os.path.dirname(os.path.abspath(args.config)),
                          **overrides)
    else:
        cfg = load_config(args.config, **overrides)
    if args.fault_plan:
        faults.set_plan(faults.FaultPlan.from_spec(args.fault_plan))
    faults.install_sigterm_handler()
    from maskclustering_tpu_torch.analysis import retrace_sanitizer

    if args.retrace_sanitizer:
        retrace_sanitizer.arm(True)
    if retrace_sanitizer.enabled():
        retrace_sanitizer.install()

    if args.obs_events:
        from maskclustering_tpu_torch import obs

        obs.configure(args.obs_events, truncate=True,
                      meta={"tool": "serve", "config": cfg.config_name})

    device = args.device
    if not args.isolate_worker:
        import torch

        from maskclustering_tpu_torch.device import resolve_device

        device = resolve_device(args.device)
        # the first use of the card creates its context: bounded, so a
        # wedged driver fails the start instead of hanging it. Isolated
        # workers do this in the child: this process stays device-free
        faults.call_with_deadline(lambda: torch.zeros(1, device=device),
                                  args.init_timeout, seam="load",
                                  scene="device-init")

    journal_dir = None
    if not args.no_journal:
        journal_dir = args.journal_dir or os.path.join(cfg.data_root,
                                                       "serve_journals")
    stream_state_dir = None
    if not args.no_stream_state:
        stream_state_dir = args.stream_state or os.path.join(
            cfg.data_root, "stream_state")

    from maskclustering_tpu_torch.serve.daemon import ServeDaemon

    daemon = ServeDaemon(
        cfg,
        socket_path=args.socket,
        host=args.host, port=args.port,
        capacity=args.capacity,
        journal_dir=journal_dir,
        stream_state_dir=stream_state_dir,
        wal=not args.no_wal,
        prediction_root=args.prediction_root,
        warm_scenes=tuple(s for s in (args.warm or "").split("+") if s),
        warm_baseline=args.warm_baseline,
        default_deadline_s=args.deadline,
        isolate_worker=args.isolate_worker,
        freeze_after_warm=not args.no_freeze,
        fault_plan_spec=args.fault_plan,
        telemetry_window_s=args.telemetry_window,
        slo_spec=args.slo_spec,
        flight_dir=args.flight_dir,
        canary_interval_s=args.canary_interval,
        canary_goldens=args.canary_goldens,
        device=device,
    )
    daemon.start()
    if args.host is not None:
        # the ephemeral port is only knowable now; clients parse this line
        print(json.dumps({"kind": "listening",
                          "address": list(daemon.address)}), flush=True)
    try:
        daemon.serve_forever()
    finally:
        daemon.shutdown()
        from maskclustering_tpu_torch import obs

        if args.obs_events and obs.enabled():
            daemon.emit_serve_counters()
            if retrace_sanitizer.enabled() and not args.isolate_worker:
                retrace_sanitizer.emit_counters()
            obs.flush_metrics()
            obs.disable()
        # the one stdout line: the daemon's final digest
        print(json.dumps({"kind": "digest", **daemon.stats()},
                         sort_keys=True), flush=True)
    return 143 if faults.stop_requested() else 0


if __name__ == "__main__":
    raise SystemExit(main())
