"""Fault-matrix smoke: three canned FaultPlans through a 2-scene run (the
port's counterpart of the JAX package's ``scripts/fault_smoke.py``).

The CI gate's drill of the fault-tolerance layer (``tools/ci.py``, budgeted
under 60 s): every path a wedged card would exercise runs deterministically
against a tiny synthetic layout, on ``--device`` (the CUDA card by default,
which must exist; ``--device cpu`` for the plain torch path). The plans:

1. ``flaky:<scene0>:1``          one failure, heals on retry
2. ``stall:<scene0>.device``     a device stall: DeviceStallError within
                                 the watchdog budget, one ladder rung
                                 dropped, heals on the degraded retry
3. ``load:<scene1>``             a persistent load failure: the scene ends
                                 failed after the retry budget, the other
                                 scene is untouched, and the run journal
                                 replays to the executor's exact verdict

    python -m maskclustering_tpu_torch.tools.fault_smoke [--device cpu]

Each plan's outcome rows (scene, status, attempts, rung, error class,
objects) go to stdout as one JSON line (``"kind": "fault_smoke"``). Exit 0 =
every expectation held; a failed one prints and exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Tuple

SCENES = ("scene0000_00", "scene0001_00")
# ~5-10x the warm tiny-scene device phase (a loaded host spikes phases
# several-fold; a healthy dispatch must never lose this race), while one
# stall detection still fits the gate's 60 s budget
WATCHDOG_S = 10.0
# (config name, plan spec, config overrides) of the three plans
PLANS: Tuple[Tuple[str, str, Dict], ...] = (
    ("smk1", f"flaky:{SCENES[0]}:1", {}),
    ("smk2", f"stall:{SCENES[0]}.device", {"watchdog_device_s": WATCHDOG_S}),
    ("smk3", f"load:{SCENES[1]}", {"scene_retries": 1}),
)


def _cfg(root, name, **kw):
    from maskclustering_tpu_torch.config import load_config

    return load_config("scannet").replace(
        data_root=root, config_name=name, step=1, distance_threshold=0.05,
        mask_pad_multiple=32, frame_pad_multiple=4, point_chunk=2048,
        retry_backoff_s=0.01, **kw)


def write_layout(root: str) -> None:
    """The two scenes of the smoke, in the ScanNet layout under ``root``."""
    from maskclustering_tpu_torch.utils.synthetic import make_scene, write_scannet_layout

    for i, seq in enumerate(SCENES):
        write_scannet_layout(make_scene(num_boxes=2, num_frames=6, image_hw=(40, 56),
                                        seed=70 + i), root, seq)


def _run(root, name, plan_spec, device, **cfg_kw):
    from maskclustering_tpu_torch.run import cluster_scenes
    from maskclustering_tpu_torch.utils import faults

    faults.set_plan(faults.FaultPlan.from_spec(plan_spec, stall_s=60.0)
                    if plan_spec else None)
    try:
        t0 = time.perf_counter()
        out = cluster_scenes(_cfg(root, name, **cfg_kw), list(SCENES), resume=False,
                             journal=faults.RunJournal(
                                 os.path.join(root, f"{name}_journal.jsonl"), name),
                             device=device)
        print(f"[fault_smoke] {name}: "
              f"{[(s.seq_name, s.status, s.attempts, s.degradation_rung) for s in out]} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        return out, time.perf_counter() - t0
    finally:
        faults.set_plan(None)


def outcome_rows(out) -> List[List]:
    """(scene, status, attempts, rung, error class, objects) of each scene."""
    return [[s.seq_name, s.status, s.attempts, s.degradation_rung, s.error_class,
             s.num_objects] for s in out]


def run_plans(root: str, device) -> Tuple[Dict[str, List[List]], List[str]]:
    """Run the three plans over the layout at ``root``: ({config name: outcome
    rows}, failed expectations)."""
    from maskclustering_tpu_torch.utils import faults

    failures: List[str] = []
    rows: Dict[str, List[List]] = {}

    def check(ok: bool, msg: str) -> None:
        if not ok:
            failures.append(msg)

    # plan 1: flaky-then-ok — one retry heals the scene
    name, spec, kw = PLANS[0]
    out, _ = _run(root, name, spec, device, **kw)
    rows[name] = outcome_rows(out)
    check([s.status for s in out] == ["ok", "ok"], f"{name}: statuses {rows[name]}")
    check(out[0].attempts == 2 and out[1].attempts == 1, f"{name}: attempts {rows[name]}")

    # plan 2: a device stall — the watchdog raises DeviceStallError within
    # its budget, the ladder drops one rung, and the degraded retry succeeds
    name, spec, kw = PLANS[1]
    out, stall_wall = _run(root, name, spec, device, **kw)
    rows[name] = outcome_rows(out)
    check([s.status for s in out] == ["ok", "ok"], f"{name}: statuses {rows[name]}")
    check(out[0].attempts == 2, f"{name}: attempts {rows[name]}")
    check(out[0].degradation_rung == 1, f"{name}: not retried one rung down {rows[name]}")
    check(stall_wall < 60.0, f"{name}: stall handling took {stall_wall:.1f}s")

    # plan 3: a persistent load failure — retries exhaust, exactly one scene
    # fails, and the journal replays the executor's verdict
    name, spec, kw = PLANS[2]
    out, _ = _run(root, name, spec, device, **kw)
    rows[name] = outcome_rows(out)
    by = {s.seq_name: s for s in out}
    check(by[SCENES[0]].status == "ok", f"{name}: {rows[name]}")
    check(by[SCENES[1]].status == "failed", f"{name}: {rows[name]}")
    check(by[SCENES[1]].error_class == "retryable", f"{name}: {rows[name]}")
    check(by[SCENES[1]].attempts == 2, f"{name}: {rows[name]}")
    replay = faults.replay_journal(os.path.join(root, f"{name}_journal.jsonl"), config=name)
    for s in out:
        r = replay.get(s.seq_name) or {}
        check((r.get("status"), r.get("attempts"), r.get("error_class"))
              == (s.status, s.attempts, s.error_class),
              f"{name}: journal replay {r} != the executor's {s.seq_name} verdict")
    return rows, failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m maskclustering_tpu_torch.tools.fault_smoke",
                                description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card, which must exist; 'cpu' "
                        "runs the plain torch path)")
    args = p.parse_args(argv)

    from maskclustering_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    t_start = time.time()
    with tempfile.TemporaryDirectory(prefix="fault_smoke_") as root:
        write_layout(root)
        print(f"[fault_smoke] layout ready ({time.time() - t_start:.1f}s)", flush=True)
        rows, failures = run_plans(root, device)
    for f in failures:
        print(f"[fault_smoke] FAIL {f}", flush=True)
    print(json.dumps({"kind": "fault_smoke", "ok": not failures, "device": str(device),
                      "plans": rows}), flush=True)
    if failures:
        return 1
    print(f"[fault_smoke] OK: 3 plans on {device}, {time.time() - t_start:.1f}s total",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
