"""CLI: ``python -m maskclustering_tpu_torch.serve`` — start the daemon.

The JAX CLI's flags (``maskclustering_tpu/serve/__main__.py``) plus
``--device``. Mirrors run.py's operational posture: the card initialised
under a watchdog, SIGTERM -> cooperative drain (exit 143), obs events
armed when a path is given, and ONE machine-readable JSON digest line on
stdout at shutdown (``daemon.stats()``); everything else goes to stderr
via logging. Flags whose subsystem is not ported raise
``NotImplementedError`` naming its item: ``--isolate-worker`` and
``--workers``/``--carve``/``--tenants`` beyond one worker (ROADMAP A9c),
``--retrace-sanitizer``, ``--no-freeze`` and ``--aot-cache`` (A10).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from maskclustering_tpu_torch.utils import faults

log = logging.getLogger("maskclustering_tpu_torch")

# the XLA tooling flags of the JAX CLI
XLA_TOOLING_ITEM = "ROADMAP A10"


def _refuse_unported(args) -> None:
    """Raise for a flag whose subsystem the port does not have yet."""
    from maskclustering_tpu_torch.serve.daemon import ISOLATION_ITEM

    if args.isolate_worker:
        raise NotImplementedError(
            f"--isolate-worker (the supervised subprocess worker) is not ported "
            f"yet ({ISOLATION_ITEM})")
    for flag, value in (("--workers", args.workers), ("--carve", args.carve),
                        ("--tenants", args.tenants)):
        if value is not None and not (flag == "--workers" and int(value) <= 1):
            raise NotImplementedError(
                f"{flag} (the multi-worker pool) is not ported yet ({ISOLATION_ITEM})")
    if args.retrace_sanitizer:
        raise NotImplementedError(
            f"--retrace-sanitizer (XLA's compile-event sanitizer) has no torch "
            f"counterpart yet ({XLA_TOOLING_ITEM})")
    if args.no_freeze:
        raise NotImplementedError(
            f"--no-freeze (the retrace sanitizer's post-warm-up freeze) has no "
            f"torch counterpart yet ({XLA_TOOLING_ITEM})")
    if args.aot_cache is not None:
        raise NotImplementedError(
            f"--aot-cache (XLA's persistent AOT executable cache) has no torch "
            f"counterpart yet ({XLA_TOOLING_ITEM})")


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
                        help="keep the retrace sanitizer unfrozen after warm-up "
                             "(no torch counterpart yet: ROADMAP A10)")
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
                        help="XLA's compile-event sanitizer (no torch counterpart "
                             "yet: ROADMAP A10)")
    parser.add_argument("--fault-plan", default=None,
                        help="deterministic fault injection spec "
                             "(testing/drill knob — never in production)")
    parser.add_argument("--isolate-worker", action="store_true",
                        help="run the worker as a supervised subprocess (not "
                             "ported: ROADMAP A9c)")
    parser.add_argument("--workers", type=int, default=None,
                        help="worker pool size (only 1 is ported; more: ROADMAP A9c)")
    parser.add_argument("--carve", default=None, metavar="KxC",
                        help="worker pool carve (not ported: ROADMAP A9c)")
    parser.add_argument("--tenants", default=None,
                        metavar="NAME:WEIGHT[:QUOTA],...",
                        help="weighted-fair tenant QoS of the worker pool (not "
                             "ported: ROADMAP A9c)")
    parser.add_argument("--aot-cache", default=None, nargs="?", const="auto",
                        metavar="DIR",
                        help="XLA's persistent AOT executable cache (no torch "
                             "counterpart yet: ROADMAP A10)")
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
    _refuse_unported(args)

    from maskclustering_tpu_torch.config import load_config

    overrides = {"data_root": args.data_root} if args.data_root else {}
    overrides.update(_parse_overrides(args.overrides))
    if args.point_shards is not None:
        overrides["point_shards"] = args.point_shards
    if args.config.endswith(".json") and os.path.isfile(args.config):
        cfg = load_config(os.path.basename(args.config)[:-len(".json")],
                          config_dir=os.path.dirname(os.path.abspath(args.config)),
                          **overrides)
    else:
        cfg = load_config(args.config, **overrides)
    if args.fault_plan:
        faults.set_plan(faults.FaultPlan.from_spec(args.fault_plan))
    faults.install_sigterm_handler()

    if args.obs_events:
        from maskclustering_tpu_torch import obs

        obs.configure(args.obs_events, truncate=True,
                      meta={"tool": "serve", "config": cfg.config_name})

    import torch

    from maskclustering_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    # the first use of the card creates its context: bounded, so a wedged
    # driver fails the start instead of hanging it
    faults.call_with_deadline(lambda: torch.zeros(1, device=device),
                              args.init_timeout, seam="load", scene="device-init")

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
            obs.flush_metrics()
            obs.disable()
        # the one stdout line: the daemon's final digest
        print(json.dumps({"kind": "digest", **daemon.stats()},
                         sort_keys=True), flush=True)
    return 143 if faults.stop_requested() else 0


if __name__ == "__main__":
    raise SystemExit(main())
