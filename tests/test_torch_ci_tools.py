"""The port's CI gate (``maskclustering_tpu_torch/tools/ci.py``), on the CPU.

- With every step switched off but the perf gate, the gate exits 0 over a
  temporary ledger, and 2 when the newest row regresses past
  ``MCT_REGRESS_THRESHOLD``; without a ledger or a baseline it skips the
  perf gate with a notice.
- The first failing step's code wins, and every step still runs.
- A step past its budget is stopped with its whole process group, and so is
  the running step when the gate itself is ended by SIGTERM.
- A host without ``jax`` skips tier-1 with one line saying why; a gate asked
  for the card on a host without one raises.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import pytest
import torch

from maskclustering_tpu_torch.tools import ci

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

SWITCHES = ("MCT_TIER1", "MCT_FAULT_SMOKE", "MCT_CHECK", "MCT_SERVE_SMOKE",
            "MCT_SERVE_CRASH_SMOKE", "MCT_STREAM_SMOKE", "MCT_CANARY_DRILL",
            "MCT_PACK_SMOKE", "MCT_POOL_DRILL", "MCT_CHAOS_DRILL")


@pytest.fixture
def all_off(monkeypatch):
    for s in SWITCHES:
        monkeypatch.setenv(s, "0")
    monkeypatch.delenv("MCT_REGRESS_THRESHOLD", raising=False)


def _ci_line(out: str):
    return json.loads(out.strip().splitlines()[-1])


def _ledger(tmp_path, value: float, baseline: float):
    led = tmp_path / "ledger.jsonl"
    led.write_text(json.dumps({"v": 1, "ts": 1.0, "tool": "bench", "metric": "s/scene",
                               "value": value}) + "\n")
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"metric": "s/scene", "value": baseline}))
    return str(base), str(led)


@pytest.mark.parametrize("value,threshold,rc", [(1.0, None, 0), (2.0, None, 2),
                                                (2.0, "1.5", 0)])
def test_gate_with_only_the_perf_gate_on(tmp_path, monkeypatch, capsys, all_off, value,
                                         threshold, rc):
    base, led = _ledger(tmp_path, value, 1.0)
    if threshold is not None:
        monkeypatch.setenv("MCT_REGRESS_THRESHOLD", threshold)
    assert ci.main([base, led, "--device", "cpu"]) == rc
    out = capsys.readouterr().out
    doc = _ci_line(out)
    assert doc == {"kind": "ci", "rc": rc, "device": "cpu",
                   "steps": [{"name": "perf_gate", "rc": rc,
                              "seconds": doc["steps"][0]["seconds"]}]}
    assert "== ci: tier-1 tests skipped (MCT_TIER1=0) ==" in out


def test_gate_skips_the_perf_gate_without_a_ledger_or_a_baseline(tmp_path, monkeypatch,
                                                                 capsys, all_off):
    missing = str(tmp_path / "none.jsonl")
    assert ci.main(["b.json", missing, "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert f"ci: no ledger at {missing}; skipping the perf gate" in captured.err
    _, led = _ledger(tmp_path, 1.0, 1.0)
    monkeypatch.setenv("MCT_PERF_LEDGER", led)
    assert ci.main(["--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert "no BASELINE given" in captured.err and _ci_line(captured.out)["steps"] == []


def test_first_failing_step_wins_and_every_step_runs(monkeypatch, capsys):
    py = sys.executable
    steps = [(f"s{code}", f"MCT_FAKE_{code}", f"fake {code}", code,
              [py, "-c", f"import sys; sys.exit({rc})"], 30, f"fake {code} FAILED")
             for code, rc in ((3, 0), (7, 1), (9, 5))]
    monkeypatch.setattr(ci, "gate_steps", lambda device: steps)
    monkeypatch.setattr(ci, "_tier1", lambda ledger, out: None)
    monkeypatch.setattr(ci, "_ruff", lambda: None)
    monkeypatch.setenv("MCT_FAKE_9", "1")
    assert ci.main(["--device", "cpu"]) == 7
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [(s["name"], s["rc"]) for s in doc["steps"]] == [("s3", 0), ("s7", 1), ("s9", 5)]
    monkeypatch.setenv("MCT_FAKE_7", "0")
    assert ci.main(["--device", "cpu"]) == 9


def test_a_step_past_its_budget_is_stopped_with_its_process_group(tmp_path):
    pidfile = tmp_path / "grandchild.pid"
    code = ("import subprocess, sys, time; "
            "p = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(120)']); "
            f"open({str(pidfile)!r}, 'w').write(str(p.pid)); time.sleep(120)")
    t0 = time.monotonic()
    rc, _ = ci.run_step([sys.executable, "-c", code], 3.0)
    assert rc == 124 and time.monotonic() - t0 < 30
    _wait_gone(int(pidfile.read_text()), "the step's grandchild")


def _wait_gone(pid: int, what: str) -> None:
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return
        # a killed child of an exited parent is reaped by init; until then
        # it may linger as a zombie, which /proc shows as state Z
        try:
            with open(f"/proc/{pid}/stat") as fh:
                if fh.read().split(")")[-1].split()[0] == "Z":
                    return
        except OSError:
            return
        time.sleep(0.1)
    raise AssertionError(f"{what} {pid} outlived it")


def _children(pid: int) -> list:
    found = []
    for entry in os.listdir("/proc"):
        try:
            with open(f"/proc/{entry}/stat") as fh:
                if entry.isdigit() and int(fh.read().split(")")[-1].split()[1]) == pid:
                    found.append(int(entry))
        except (OSError, ValueError):
            pass
    return found


def test_a_gate_ended_by_sigterm_stops_its_running_step(monkeypatch, all_off):
    # the step runs in a session of its own, so only the gate can stop it
    monkeypatch.setenv("MCT_FAULT_SMOKE", "1")
    proc = subprocess.Popen([sys.executable, "-m", "maskclustering_tpu_torch.tools.ci",
                             "--device", "cpu"], cwd=ci.REPO_ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 60
        while not _children(proc.pid) and time.monotonic() < deadline:
            time.sleep(0.05)
        steps = _children(proc.pid)
        assert steps, "the gate started no step"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    finally:
        proc.kill()
    assert proc.returncode == 143, out
    for pid in steps:
        _wait_gone(pid, "the gate's step")


def test_tier1_skips_with_one_line_without_jax(monkeypatch, capsys):
    real = importlib.util.find_spec
    monkeypatch.setattr(ci.importlib.util, "find_spec",
                        lambda name, *a: None if name == "jax" else real(name, *a))
    monkeypatch.delenv("MCT_TIER1", raising=False)
    steps = []
    assert ci._tier1(os.path.join(tempfile.gettempdir(), "unused.jsonl"), steps) is None
    out = capsys.readouterr().out.strip().splitlines()
    assert out == ["== ci: tier-1 tests skipped: the port's tests hold it against the JAX "
                   "package, and jax is not installed on this host =="] and steps == []


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a host with no CUDA card")
def test_gate_asked_for_the_card_raises_without_one():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ci.main([])




def test_chip_smoke_stops_the_orphans_of_its_children_too(tmp_path):
    # chip_smoke.py's end: a child in a session of its own starts a process
    # in another one and dies first; the script, a subreaper, still stops it
    pidfile = tmp_path / "orphan.pid"
    code = f"""
import os, subprocess, sys, time
sys.path.insert(0, {ci.REPO_ROOT!r})
import chip_smoke
chip_smoke._adopt_orphans()
inner = ("import subprocess, sys, time; p = subprocess.Popen([sys.executable, '-c', "
         "'import time; time.sleep(120)'], start_new_session=True); "
         "open({str(pidfile)!r}, 'w').write(str(p.pid)); time.sleep(120)")
child = subprocess.Popen([sys.executable, '-c', inner], start_new_session=True)
while not (os.path.exists({str(pidfile)!r}) and os.path.getsize({str(pidfile)!r})):
    time.sleep(0.05)
child.kill()
child.wait()
killed = chip_smoke._stop_descendants()
print(killed, chip_smoke._descendants())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    orphan = int(pidfile.read_text())
    assert out.stdout.strip() == f"[{orphan}] []"
    _wait_gone(orphan, "the orphaned grandchild")
