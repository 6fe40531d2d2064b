"""The port's fault-matrix and streaming smokes
(``maskclustering_tpu_torch/tools/fault_smoke.py``, ``stream_smoke.py``)
against the JAX package's ``scripts/fault_smoke.py`` and
``scripts/stream_smoke.py``, on the CPU.

- ``fault_smoke --device cpu`` exits 0, and each plan's statuses, attempts,
  rungs, error classes and object counts equal those the JAX script gives
  on the same 2-scene layout;
- ``stream_smoke --device cpu`` exits 0 with the JAX script's batch and
  stream statuses and object counts, no post-freeze key and the residency
  cap held.

The JAX side is pinned in ``tests/torch_tool_goldens.json``, written from
the JAX scripts' own functions by ``PYTHONPATH=. python
tests/test_torch_tool_smokes.py --write-goldens`` from the repository root.
"""

import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import torch

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "torch_tool_goldens.json")


def _goldens():
    with open(GOLDENS) as fh:
        return json.load(fh)


def _tool(module: str, *args: str):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def _json_line(stdout: str, kind: str):
    for line in reversed(stdout.splitlines()):
        if line.startswith("{") and f'"kind": "{kind}"' in line:
            return json.loads(line)
    raise AssertionError(f"no {kind} line in:\n{stdout[-3000:]}")


def test_fault_smoke_matches_the_jax_script():
    r = _tool("maskclustering_tpu_torch.tools.fault_smoke", "--device", "cpu")
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    doc = _json_line(r.stdout, "fault_smoke")
    assert doc["ok"] is True and doc["device"] == "cpu"
    assert doc["plans"] == _goldens()["fault_smoke"]
    assert "[fault_smoke] OK: 3 plans" in r.stdout


def test_stream_smoke_matches_the_jax_script():
    r = _tool("maskclustering_tpu_torch.tools.stream_smoke", "--device", "cpu")
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    doc = _json_line(r.stdout, "stream_smoke")
    want = _goldens()["stream_smoke"]
    assert doc["ok"] is True and doc["chunks"] == want["chunks"] == 3
    assert doc["batch"] == want["batch"] and doc["stream"] == want["stream"]
    assert doc["post_freeze"] == 0 and doc["repeats"] == 0
    assert doc["max_plane_bytes"] < doc["full_plane_set"]
    assert "stream_smoke: PASS" in r.stdout


# ---------------------------------------------------------------------------
# the JAX scripts' figures (run here, on the CPU, to rewrite the goldens)
# ---------------------------------------------------------------------------


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_figures() -> dict:
    """The JAX scripts' outcome rows on their own layouts, through their own
    functions: the three fault plans (``scripts/fault_smoke.py:_run``) and
    the streaming smoke's batch and chunk-8 runs over its ``_cfg``."""
    from maskclustering_tpu.run import cluster_scenes
    from maskclustering_tpu.utils.synthetic import make_scene, write_scannet_layout

    fs = _jax_script("fault_smoke")
    plans = (("smk1", f"flaky:{fs.SCENES[0]}:1", {}),
             ("smk2", f"stall:{fs.SCENES[0]}.device", {"watchdog_device_s": fs.WATCHDOG_S}),
             ("smk3", f"load:{fs.SCENES[1]}", {"scene_retries": 1}))
    fault = {}
    with tempfile.TemporaryDirectory() as root:
        for i, seq in enumerate(fs.SCENES):
            write_scannet_layout(make_scene(num_boxes=2, num_frames=6, image_hw=(40, 56),
                                            seed=70 + i), root, seq)
        for name, spec, kw in plans:
            out = fs._run(root, name, spec, **kw)
            fault[name] = [[s.seq_name, s.status, s.attempts, s.degradation_rung,
                            s.error_class, s.num_objects] for s in out]
    ss = _jax_script("stream_smoke")
    with tempfile.TemporaryDirectory() as root:
        write_scannet_layout(make_scene(num_boxes=3, num_frames=8, image_hw=(48, 64), seed=7,
                                        spacing=0.05), root, ss.SCENE_ONE)
        write_scannet_layout(make_scene(num_boxes=3, num_frames=24, image_hw=(48, 64),
                                        seed=11, spacing=0.05), root, ss.SCENE_MULTI)
        scenes = [ss.SCENE_ONE, ss.SCENE_MULTI]
        batch = cluster_scenes(ss._cfg(root, "smoke_batch"), scenes, resume=False)
        stream = cluster_scenes(ss._cfg(root, "smoke_stream", streaming_chunk=ss.CHUNK),
                                scenes, resume=False)
    return {"fault_smoke": fault,
            "stream_smoke": {"batch": [[s.seq_name, s.status, s.num_objects] for s in batch],
                             "stream": [[s.seq_name, s.status, s.num_objects]
                                        for s in stream],
                             "chunks": -(-24 // ss.CHUNK)}}


if __name__ == "__main__" and sys.argv[1:] == ["--write-goldens"]:
    with open(GOLDENS, "w") as fh:
        json.dump(jax_figures(), fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {GOLDENS}")
