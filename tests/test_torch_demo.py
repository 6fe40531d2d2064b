"""The port's zero-download demo (``python -m maskclustering_tpu_torch.demo``)
against the JAX one (``scripts/demo.py``).

Both run once as subprocesses on the CPU at ``tests/test_demo_script.py``'s
size (12 frames, 3 objects, 120x160), each into a root of its own, with
the perf ledger pointed at a temporary file. Every file the two write is
compared: byte for byte, but for ``report.json`` and ``run_journal.jsonl``,
which are compared field for field with their time fields set aside
(:data:`TIME_FIELDS`). The printed ``[demo]`` lines are the JAX demo's,
its seconds and its root aside. Then the port's reuse run and its exit-2
refusal of a mismatched ``--out``, and its refusal to start without a
card when no ``--device`` is given.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from maskclustering_tpu_torch import demo

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = ["--frames", "12", "--objects", "3", "--image-h", "120", "--image-w", "160"]
# fields that hold a wall time or the writing process, never a result:
# the report's step seconds and each scene's seconds and stage walls
# (``timings``), the journal's stamp, pid and seconds
TIME_FIELDS = {"report.json": ("step_seconds", "seconds", "timings"),
               "run_journal.jsonl": ("ts", "pid", "seconds")}


def _env(tmp):
    env = dict(os.environ, MCT_PERF_LEDGER=str(tmp / "ledger.jsonl"), JAX_PLATFORMS="cpu")
    # the children keep to a thread or two, as the suite runs in parallel
    env.update(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    return env


def _port(args, env, timeout=420):
    return subprocess.run([sys.executable, "-m", "maskclustering_tpu_torch.demo"] + args,
                          capture_output=True, text=True, timeout=timeout, cwd=REPO_ROOT,
                          env=env)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("demo")
    env = _env(tmp)
    ledger = os.path.join(REPO_ROOT, "PERF_LEDGER.jsonl")
    before = open(ledger, "rb").read() if os.path.exists(ledger) else None
    roots = {"jax": tmp / "jax", "port": tmp / "port"}
    cmds = {"jax": [sys.executable, os.path.join(REPO_ROOT, "scripts", "demo.py"),
                    "--platform", "cpu", "--out", str(roots["jax"])] + SIZE,
            "port": [sys.executable, "-m", "maskclustering_tpu_torch.demo", "--device", "cpu",
                     "--out", str(roots["port"])] + SIZE}
    procs = {k: subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True, cwd=REPO_ROOT, env=env) for k, c in cmds.items()}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=420)
        out[k] = (p.returncode, stdout, stderr)
    after = open(ledger, "rb").read() if os.path.exists(ledger) else None
    return {"tmp": tmp, "roots": roots, "out": out, "ledger_kept": before == after}


def _tree(root):
    files = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            files[os.path.relpath(p, root)] = p
    return files


def _drop(obj, keys):
    if isinstance(obj, dict):
        return {k: _drop(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, list):
        return [_drop(v, keys) for v in obj]
    return obj


def _fields(path, keys):
    with open(path) as f:
        if path.endswith(".jsonl"):
            return [_drop(json.loads(line), keys) for line in f if line.strip()]
        return _drop(json.load(f), keys)


def test_demo_runs_as_the_jax_demo_does(runs):
    for k, (rc, stdout, stderr) in runs["out"].items():
        assert rc == 0, (k, stdout[-1500:], stderr[-1500:])
        assert "3 objects recovered (planted: 3)" in stdout, k
        assert "MISSING" not in stdout and "FAILED" not in stdout, k
    # one ledger row a run, both in the temporary ledger, none in the repo's
    ledger = runs["tmp"] / "ledger.jsonl"
    rows = [json.loads(line) for line in ledger.read_text().splitlines() if line.strip()]
    assert len(rows) == 2 and runs["ledger_kept"]


def test_demo_files_equal_to_jax_file_for_file(runs):
    jax, port = _tree(runs["roots"]["jax"]), _tree(runs["roots"]["port"])
    assert sorted(jax) == sorted(port)
    listed = {os.path.normpath(r) for r in demo.artifacts("demo0001_00")}
    assert {r for r in listed if not r.endswith("grid")} <= set(jax)
    pngs = [r for r in jax if r.endswith(".png")]
    assert any("top_images" in r for r in pngs) and any(r.startswith("vis") for r in pngs)
    assert {"evaluation/scannet/demo_class_agnostic.txt",
            "evaluation/scannet/demo.txt"} <= set(jax)
    for rel in sorted(jax):
        name = os.path.basename(rel)
        keys = TIME_FIELDS.get(name)
        if keys is not None:
            assert _fields(jax[rel], keys) == _fields(port[rel], keys), rel
            continue
        with open(jax[rel], "rb") as a, open(port[rel], "rb") as b:
            assert a.read() == b.read(), rel


def _demo_lines(stdout, root):
    lines = [ln.replace(str(root), "<out>") for ln in stdout.splitlines()
             if ln.startswith("[demo]")]
    return [re.sub(r"\d+\.\ds\b", "<s>", ln) for ln in lines]


def test_demo_prints_the_jax_lines(runs):
    jax = _demo_lines(runs["out"]["jax"][1], runs["roots"]["jax"])
    port = _demo_lines(runs["out"]["port"][1], runs["roots"]["port"])
    assert jax == port
    assert any("class-agnostic AP" in ln for ln in port)


def test_demo_reuses_its_scene_and_refuses_a_mismatched_out(runs, tmp_path):
    root = tmp_path / "again"
    shutil.copytree(runs["roots"]["port"], root)
    env = _env(tmp_path)
    out = ["--out", str(root), "--device", "cpu"]
    again = _port(out + SIZE, env)
    assert again.returncode == 0, again.stdout[-1500:] + again.stderr[-1500:]
    assert "reusing generated scene" in again.stdout
    other = _port(out + ["--frames", "12", "--objects", "5", "--image-h", "120",
                         "--image-w", "160"], env)
    assert other.returncode == 2
    assert "pick a different --out" in other.stderr


def test_demo_without_device_raises_on_a_host_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks a host without a card")
    proc = _port(["--out", str(tmp_path / "d")] + SIZE, _env(tmp_path), timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not (tmp_path / "d").exists()  # nothing generated before the refusal
