"""The port's CI gate, one command (the counterpart of the JAX package's
``scripts/ci.sh``: the same steps in the same order, the same exit codes,
``MCT_*`` switches and per-step time budgets).

    python -m maskclustering_tpu_torch.tools.ci [BASELINE] [LEDGER] [--device cuda|cpu]

Steps (each prints ``== ci: ... ==``; a step's switch set to 0 skips it):

1.  tier-1: ``pytest tests/test_torch_*.py -m 'not slow'`` (870 s; a
    NON-FATAL warning past ``MCT_TIER1_WALL_WARN``, default 800 s), then a
    ``tier1`` row (wall, passes) on the port's ledger. The tests hold the
    port against the JAX package, so a host without ``jax`` skips this
    step with one line saying so; ``MCT_TIER1=0`` skips it anywhere.
    Exit 1.
2.  the fault-matrix smoke (``tools/fault_smoke.py``, 60 s,
    ``MCT_FAULT_SMOKE``). Exit 3.
3.  mct-check ``--families ast,ir`` (90 s, ``MCT_CHECK``). Exit 4.
3b. the concurrency family (30 s). Exit 5.
3c. the retrace family: compile sites and the launch-surface census
    (240 s). Exit 6.
3d. the serve smoke: ``load_gen --smoke --requests 6 --concurrency 3``
    (300 s, ``MCT_SERVE_SMOKE``). Exit 7.
3e. the crash-respawn smoke: ``--smoke --crash-drill --requests 4
    --concurrency 2`` (420 s, ``MCT_SERVE_CRASH_SMOKE``). Exit 8.
3f. the streaming smoke (``tools/stream_smoke.py``, 240 s,
    ``MCT_STREAM_SMOKE``). Exit 9.
3g. the canary drill (600 s, ``MCT_CANARY_DRILL``). Exit 10.
3h. the pack drill, ``--requests 8`` (560 s, ``MCT_PACK_SMOKE``). Exit 11.
3i. the pool drill (600 s, ``MCT_POOL_DRILL``). Exit 12.
3j. the chaos drill (600 s, ``MCT_CHAOS_DRILL``). Exit 13.
4.  ruff, gating only at the version ``pyproject.toml`` pins (advisory at
    another, skipped with a notice when absent). Exit 4.
5.  the perf gate: ``python -m maskclustering_tpu_torch.obs.report --ledger
    LEDGER --regress BASELINE`` past ``MCT_REGRESS_THRESHOLD`` (0.15);
    skipped with a notice when there is no ledger, or no BASELINE (the
    port's bench records its first). Exit 2.

LEDGER defaults to ``$MCT_PERF_LEDGER``, else ``PERF_LEDGER_TORCH.jsonl``.
``--device`` goes to every daemon and run (default: the CUDA card, which
the steps require to exist). Every step still RUNS after a failure, but
the exit code is the FIRST failing step's. A step that outlives its budget
is stopped with its whole process group (SIGTERM, then SIGKILL 10 s
later), so no daemon it started outlives it. The last stdout line is one
JSON object: ``{"kind": "ci", "rc": ..., "steps": [{"name", "rc",
"seconds"}, ...]}``.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TOOLS = "maskclustering_tpu_torch.tools"


def _say(msg: str) -> None:
    print(msg, flush=True)


def _warn(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _on(switch: str) -> bool:
    return os.environ.get(switch, "1") != "0"


def run_step(cmd: List[str], budget_s: float, *, capture: bool = False) -> Tuple[int, str]:
    """Run ``cmd`` from the checkout's root in its own process group, for at
    most ``budget_s`` seconds (then SIGTERM to the group, SIGKILL 10 s
    later, rc 124). Returns (rc, its output when ``capture``)."""
    proc = subprocess.Popen(cmd, cwd=REPO_ROOT, start_new_session=True, text=True,
                            stdout=subprocess.PIPE if capture else None,
                            stderr=subprocess.STDOUT if capture else None)
    try:
        out, _ = proc.communicate(timeout=budget_s)
        return proc.returncode, out or ""
    except subprocess.TimeoutExpired:
        _warn(f"ci: {' '.join(cmd[:4])} ... exceeded its {budget_s:g} s budget")
        for sig, wait_s in ((signal.SIGTERM, 10.0), (signal.SIGKILL, 30.0)):
            try:
                os.killpg(proc.pid, sig)
            except ProcessLookupError:
                break
            try:
                out, _ = proc.communicate(timeout=wait_s)
                break
            except subprocess.TimeoutExpired:
                out = ""
        return 124, out or ""
    except BaseException:
        # the gate itself was ended (SIGTERM, ^C): the step's group, in a
        # session of its own, goes with it
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
        raise


def _py(*args: str) -> List[str]:
    return [sys.executable, *args]


def _tier1(ledger: str, steps: List[Dict]) -> Optional[int]:
    """Step 1; returns the exit code to record (None when skipped)."""
    if not _on("MCT_TIER1"):
        _say("== ci: tier-1 tests skipped (MCT_TIER1=0) ==")
        return None
    if importlib.util.find_spec("jax") is None:
        _say("== ci: tier-1 tests skipped: the port's tests hold it against the JAX "
             "package, and jax is not installed on this host ==")
        return None
    wall_warn = float(os.environ.get("MCT_TIER1_WALL_WARN", "800"))
    _say("== ci: tier-1 tests ==")
    files = sorted(glob.glob(os.path.join(REPO_ROOT, "tests", "test_torch_*.py")))
    env_cmd = ["env", "JAX_PLATFORMS=cpu", sys.executable, "-m", "pytest",
               *[os.path.relpath(f, REPO_ROOT) for f in files], "-q", "-m", "not slow",
               "--continue-on-collection-errors", "--durations=10",
               "-p", "no:cacheprovider", "-p", "no:xdist", "-p", "no:randomly"]
    t0 = time.monotonic()
    rc, out = run_step(env_cmd, 870, capture=True)
    wall = time.monotonic() - t0
    sys.stdout.write(out)
    passed = re.findall(r"(\d+) passed", out)
    n_passed = int(passed[-1]) if passed else 0
    _say(f"== ci: tier-1 wall {wall:.0f}s, {n_passed} passed (budget: warn "
         f">{wall_warn:g}s of the 870s timeout) ==")
    if wall > wall_warn:
        _warn(f"ci: WARNING tier-1 wall {wall:.0f}s exceeds the {wall_warn:g}s soft budget")
    try:
        from maskclustering_tpu_torch.obs import ledger as led

        led.append_row(ledger, led.tier1_row(wall, n_passed))
    except Exception as e:  # noqa: BLE001 — the ledger row is non-fatal
        _warn(f"ci: WARNING tier1 ledger row append failed (non-fatal): {e}")
    if rc != 0:
        _warn("ci: tier-1 tests FAILED")
    steps.append({"name": "tier1", "rc": rc, "seconds": round(wall, 1)})
    return rc


def _ruff() -> Optional[int]:
    """Step 4; the exit code to record, None when it does not gate."""
    ruff = shutil.which("ruff")
    if ruff is None:
        _say("== ci: ruff not installed; skipping the lint front-end "
             "(pip install -e '.[dev]' to enable) ==")
        return None
    try:
        with open(os.path.join(REPO_ROOT, "pyproject.toml")) as fh:
            pin = re.search(r"ruff==[0-9.]+", fh.read())
    except OSError:
        pin = None
    have = subprocess.run([ruff, "--version"], capture_output=True, text=True).stdout.split()
    have_pin = f"ruff=={have[1]}" if len(have) > 1 else "ruff==?"
    if pin is not None and have_pin == pin.group(0):
        _say(f"== ci: ruff ({have_pin}, config: pyproject.toml [tool.ruff]) ==")
        rc, _ = run_step([ruff, "check", "."], 300)
        if rc != 0:
            _warn("ci: ruff FAILED")
            return 4
        return 0
    _say(f"== ci: ruff {have_pin} != pinned {pin.group(0) if pin else '?'} — ADVISORY "
         f"only (pip install -e '.[dev]' for the gating version) ==")
    if run_step([ruff, "check", "."], 300)[0] != 0:
        _warn("ci: WARNING unpinned ruff found violations (non-fatal)")
    return None


def _perf_gate(ledger: str, baseline: Optional[str], threshold: str) -> Optional[int]:
    """Step 5; the exit code to record, None when skipped."""
    _say(f"== ci: perf regression gate ({ledger} vs {baseline}, >{threshold} p50) ==")
    if not os.path.isfile(ledger):
        _warn(f"ci: no ledger at {ledger}; skipping the perf gate")
        return None
    if not baseline:
        _warn("ci: no BASELINE given (the port's bench records its first); skipping "
              "the perf gate")
        return None
    rc, _ = run_step(_py("-m", "maskclustering_tpu_torch.obs.report", "--ledger", ledger,
                         "--regress", baseline, "--regress-threshold", threshold), 300)
    if rc != 0:
        _warn("ci: perf regression gate FAILED")
        return 2
    return 0


def gate_steps(device: str) -> List[Tuple[str, str, str, int, List[str], float, str]]:
    """Steps 2-3j in order: (name, switch, banner, exit code, command,
    budget s, failure hint)."""
    dev = ["--device", device]
    lg = ["-m", f"{TOOLS}.load_gen"]
    an = ["-m", "maskclustering_tpu_torch.analysis"]
    return [
        ("fault_smoke", "MCT_FAULT_SMOKE",
         "fault-matrix smoke (3 canned FaultPlans, 2-scene run, <60s)", 3,
         _py("-m", f"{TOOLS}.fault_smoke", *dev), 60, "fault-matrix smoke FAILED"),
        ("check", "MCT_CHECK", "mct-check static invariant gate (IR + AST, <90s)", 4,
         _py(*an, "--families", "ast,ir", *dev), 90,
         "mct-check FAILED (fix the finding at its file:line, or baseline it in "
         "maskclustering_tpu_torch/analysis/baseline.json with a justification)"),
        ("concurrency", "MCT_CHECK",
         "mct-check concurrency gate (thread topology + lock order, <30s)", 5,
         _py(*an, "--families", "concurrency"), 30,
         "mct-check concurrency FAILED (fix the thread-safety finding, annotate with "
         "# mct-thread:, or baseline it with a justification)"),
        ("retrace", "MCT_CHECK",
         "mct-check retrace gate (compile sites + launch-surface census, <240s)", 6,
         _py(*an, "--families", "retrace", *dev), 240,
         "mct-check retrace FAILED (a launch key joined or left the surface: fix the "
         "finding, or audit the census diff and regenerate the launch-surface "
         "baseline with --write-surface)"),
        ("serve_smoke", "MCT_SERVE_SMOKE",
         "serve daemon smoke (spawn daemon + load_gen burst, SIGTERM drain, <300s)", 7,
         _py(*lg, "--smoke", "--requests", "6", "--concurrency", "3", "--no-ledger", *dev),
         300, "serve daemon smoke FAILED (daemon wedged, a request failed, or the "
              "sanitizer booked post-freeze builds or launch keys)"),
        ("crash_smoke", "MCT_SERVE_CRASH_SMOKE",
         "crash-respawn smoke (isolated worker, SIGKILL drill + build-free respawn, "
         "<420s)", 8,
         _py(*lg, "--smoke", "--crash-drill", "--requests", "4", "--concurrency", "2",
             "--no-ledger", *dev), 420,
         "crash-respawn smoke FAILED (daemon died with its worker, the request was not "
         "requeued, or the respawned worker built kernels)"),
        ("stream_smoke", "MCT_STREAM_SMOKE",
         "streaming smoke (2-scene chunked run, convergence + warm chunks, <240s)", 9,
         _py("-m", f"{TOOLS}.stream_smoke", *dev), 240,
         "streaming smoke FAILED (streaming diverged from batch, a post-freeze chunk "
         "built or launched a new key, or the residency cap broke)"),
        ("canary_drill", "MCT_CANARY_DRILL",
         "canary sentinel drill (clean soak + scripted corruption, <600s)", 10,
         _py(*lg, "--canary-drill", "--no-ledger", *dev), 600,
         "canary sentinel drill FAILED (drift on a clean soak means outputs changed or "
         "goldens are stale; an undetected corruption means the sentinel plane is dark)"),
        ("pack_drill", "MCT_PACK_SMOKE",
         "continuous-batching pack drill (packed vs sequential byte identity, <560s)", 11,
         _py(*lg, "--pack-drill", "--requests", "8", "--no-ledger", *dev), 560,
         "pack drill FAILED (packed artifacts diverged from sequential, a partial batch "
         "launched a new key, or the scheduler never fused a batch)"),
        ("pool_drill", "MCT_POOL_DRILL",
         "multi-worker pool drill (2 slices: affinity + QoS + SIGKILL containment, <600s)",
         12, _py(*lg, "--pool-drill", "--no-ledger", *dev), 600,
         "pool drill FAILED (a slice went cold/unbalanced, QoS or quota broke, the crash "
         "leaked past its slice, or a worker built or launched post-freeze)"),
        ("chaos_drill", "MCT_CHAOS_DRILL",
         "durability chaos drill (killed worker mid-stream + killed daemon mid-queue, "
         "<600s)", 13, _py(*lg, "--chaos-drill", "--no-ledger", *dev), 600,
         "chaos drill FAILED (a killed worker lost its stream, a killed daemon lost "
         "journaled requests, a resubmit did not dedupe, artifacts diverged across the "
         "death, or the warm restart built kernels)"),
    ]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog=f"python -m {TOOLS}.ci",
                                description="the port's CI gate (tools/ci.py)")
    p.add_argument("baseline", nargs="?", default=None,
                   help="--regress baseline: a JSON verdict with a value, or a ledger")
    p.add_argument("ledger", nargs="?", default=None,
                   help="the port's ledger (default: $MCT_PERF_LEDGER, else "
                        "PERF_LEDGER_TORCH.jsonl)")
    p.add_argument("--device", default=None,
                   help="torch device of every daemon and run (default: the CUDA card)")
    args = p.parse_args(argv)

    from maskclustering_tpu_torch.device import resolve_device

    device = str(resolve_device(args.device))
    ledger = args.ledger or os.environ.get("MCT_PERF_LEDGER") or "PERF_LEDGER_TORCH.jsonl"
    threshold = os.environ.get("MCT_REGRESS_THRESHOLD", "0.15")
    rc = 0
    steps: List[Dict] = []

    def fail(code: int) -> None:
        nonlocal rc
        if rc == 0:
            rc = code  # the first failure wins the exit code

    t1 = _tier1(ledger, steps)
    if t1:
        fail(1)
    for name, switch, banner, code, cmd, budget, hint in gate_steps(device):
        if not _on(switch):
            continue
        _say(f"== ci: {banner} ==")
        t0 = time.monotonic()
        step_rc, _ = run_step(cmd, budget)
        secs = time.monotonic() - t0
        steps.append({"name": name, "rc": step_rc, "seconds": round(secs, 1)})
        _say(f"== ci: {name} rc={step_rc} in {secs:.1f}s ==")
        if step_rc != 0:
            _warn(f"ci: {hint}")
            fail(code)
    for name, gate in (("ruff", _ruff), ("perf_gate", lambda: _perf_gate(
            ledger, args.baseline, threshold))):
        t0 = time.monotonic()
        step_rc = gate()
        if step_rc is not None:
            steps.append({"name": name, "rc": step_rc,
                          "seconds": round(time.monotonic() - t0, 1)})
            if step_rc:
                fail(step_rc)
    _say(json.dumps({"kind": "ci", "rc": rc, "device": device, "steps": steps}))
    return rc


if __name__ == "__main__":
    # SIGTERM unwinds through run_step, which stops the running step's group
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    raise SystemExit(main())
