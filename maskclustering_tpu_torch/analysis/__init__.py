"""mct-check over the port: static invariant analysis of its contracts.

Counterpart of ``maskclustering_tpu/analysis/``, its five families:

- **Family 1 — IR invariants** (``ir_checks``): the cost census of the
  fused step (``obs/cost.py``) over the mesh lattice: pinned counting
  products, no float64 outside the audited sites, int16 claim planes,
  the guarded scene's named host pulls, cross-device bytes in their
  envelopes.

- **Family 2 — AST lint** (``ast_checks``): walks
  ``maskclustering_tpu_torch/`` + ``chip_smoke.py`` for unsanctioned host
  syncs in the device-path modules (torch's: ``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize``), wall-clock or
  randomness reachable from compiled code, unlocked module-level state
  mutated on executor threads, and bare ``except:``.
- **Family 4 — concurrency** (``concurrency`` + ``lock_sanitizer``): the
  whole-program thread-topology model (roots = ``DaemonFuture`` /
  ``Thread`` / executor submits / signal handlers /
  ``faults.call_with_deadline`` targets / ``# mct-thread: root`` markers)
  checked for unguarded multi-root shared state, lock-order cycles,
  blocking calls under held locks, handler purity and join/abandon
  contracts, plus the opt-in instrumented lock shim
  (``MCT_LOCK_SANITIZER=1``, ``run.py --lock-sanitizer``) whose observed
  acquisition-order graph must embed in the static one.
- **Family 3 — runtime host-sync guard** (``transfer_guard``): opt-in
  (``run.py --transfer-guard``, ``MCT_TRANSFER_GUARD=1``) thread-local
  torch modes around every scene's device phase; only named
  ``sanctioned_pull`` windows may read the device.
- **Family 5 — retrace** (``retrace`` + ``retrace_sanitizer``): the
  compile-site scan and the launch-surface census against
  ``launch_surface_baseline.json``, the canary goldens' coordinates, and
  the opt-in sanitizer of kernel builds and launch keys.

Findings carry stable ids + ``file:line``; the port's own baseline,
``maskclustering_tpu_torch/analysis/baseline.json``, suppresses accepted
findings, each with a one-line justification. CLI::

    python -m maskclustering_tpu_torch.analysis [--families ast,concurrency,ir,retrace] \
        [--baseline PATH] [--format text|json] [--events out.jsonl]

exits 0 clean, 2 on unsuppressed findings. The default families
(``ast,concurrency``) are pure stdlib: no torch import.
"""

from maskclustering_tpu_torch.analysis.findings import (  # noqa: F401
    Finding,
    load_baseline,
    partition_findings,
)
