"""The port's load-generator drills (``maskclustering_tpu_torch/tools/
load_gen.py``) at the size ``scripts/ci.sh`` runs them, as subprocesses on
the CPU.

- ``--write-goldens PATH`` writes the committed ``canary_goldens.json``'s
  bytes, and leaves the committed file as it was.
- ``--smoke --crash-drill`` (crash, requeue, respawn, the black box) exits 0.
- ``--canary-drill``, ``--pack-drill``, ``--pool-drill`` and
  ``--chaos-drill`` exit 0 with their verdicts; each takes over 60 s alone
  on an 8-core CPU, so they are marked slow (``chip_smoke.py`` runs them
  all on the CPU in phase 24's ``tools/ci.py --device cpu`` child, and
  ``tools/ci.py --device cuda`` on the card).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "canary_goldens.json")


def _load_gen(*args: str, timeout: float = 600):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "maskclustering_tpu_torch.tools.load_gen",
                        *args], cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1]), r.stderr


def test_write_goldens_reproduces_the_committed_file(tmp_path):
    before = open(GOLDENS, "rb").read()
    out = str(tmp_path / "goldens.json")
    doc, _ = _load_gen("--write-goldens", out)
    assert doc["kind"] == "goldens" and doc["path"] == out
    assert doc["coords"] == sorted(json.loads(before)["goldens"])
    assert open(out, "rb").read() == before
    assert open(GOLDENS, "rb").read() == before


def test_crash_drill_at_the_ci_size():
    v, err = _load_gen("--smoke", "--crash-drill", "--requests", "4", "--concurrency", "2",
                       "--no-ledger", "--device", "cpu")
    assert v["ok"] == 4 and v["failed"] == 0 and v["worker_crashes"] >= 1
    assert v["worker_respawns"] >= 1 and v["worker_crash_events"] >= 1
    assert v["retrace_compiles"] == 0 and v["retrace_post_freeze"] == 0
    assert v["blackbox_dumps"] >= 1 and v["blackbox_trace_segments"] > 0
    assert "smoke: PASS" in err


@pytest.mark.slow
def test_canary_drill_at_the_ci_size():
    v, err = _load_gen("--canary-drill", "--no-ledger", "--device", "cpu")
    assert v["canary_drill"] is True and v["canary_drift"] >= 2 and v["value"] is not None
    assert "canary-drill: PASS" in err


@pytest.mark.slow
def test_pack_drill_at_the_ci_size():
    v, err = _load_gen("--pack-drill", "--requests", "8", "--no-ledger", "--device", "cpu")
    assert v["pack_drill"] is True and v["batch_occupancy"] > 1 and v["ok"] == 8
    assert "pack-drill: PASS" in err


@pytest.mark.slow
def test_pool_drill_at_the_ci_size():
    v, err = _load_gen("--pool-drill", "--no-ledger", "--device", "cpu")
    assert v["pool_drill"] is True and v["affinity_hit_rate"] >= 0.9
    assert v["qos_heavy_first_half"] >= 9 and v["quota_rejects"] >= 1
    assert v["worker_respawns"] >= 1 and v["span_overlaps"] > 0
    assert "pool-drill: PASS" in err


@pytest.mark.slow
def test_chaos_drill_at_the_ci_size():
    v, err = _load_gen("--chaos-drill", "--no-ledger", "--device", "cpu")
    assert v["chaos_drill"] is True and v["streams_resumed"] >= 1
    assert v["wal_replayed"] >= 1 and v["chaos_resubmit_ok"] == 6
    assert v["retrace_compiles"] == 0
    assert "chaos-drill: PASS" in err
