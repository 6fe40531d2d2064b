"""mct-check over the port: static invariant analysis of its contracts.

Counterpart of ``maskclustering_tpu/analysis/``, families 2 and 4 (the IR
and retrace families read XLA's lowerings and wait for ROADMAP A10):

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

Findings carry stable ids + ``file:line``; the port's own baseline,
``maskclustering_tpu_torch/analysis/baseline.json``, suppresses accepted
findings, each with a one-line justification. CLI::

    python -m maskclustering_tpu_torch.analysis [--families ast,concurrency] \
        [--baseline PATH] [--format text|json] [--events out.jsonl]

exits 0 clean, 2 on unsuppressed findings. Pure stdlib: no torch import.
"""

from maskclustering_tpu_torch.analysis.findings import (  # noqa: F401
    Finding,
    load_baseline,
    partition_findings,
)
