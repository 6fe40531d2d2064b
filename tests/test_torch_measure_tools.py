"""The port's measurement tools (``maskclustering_tpu_torch/tools/``:
``profile_scene``, ``profile_postprocess``, ``claims_diag``,
``fb_identity``, ``northstar``, ``parity_ab``, ``mesh_bench``,
``hbm_analysis``, ``micro``) against the JAX package's ``scripts/``, on the
CPU at tiny sizes.

- ``parity_ab``: ``mask_sets_from_association`` and ``jaccard_stats`` equal
  to the JAX script's; a tiny operating point patched into both tables
  gives the same AP and Jaccard rows and exit code;
- ``northstar --quick``: the same (F_pad, N_pad) bucket and objects found
  per scene, and both sweeps pass;
- ``fb_identity``: the frame-batched association equals the JAX
  ``associate_scene``'s fields; both tools give OK and exit 0;
- ``claims_diag``: the same drain size and objects on the same scene;
- ``mesh_bench``: the same objects per scene; ``hbm_analysis``: both exit 0
  with positive headroom (the JAX scripts set ``XLA_FLAGS`` at import, so
  they run as subprocesses);
- ``profile_scene``, ``profile_postprocess``, ``micro``: exit 0 with their
  verdict lines and the stage names of the JAX pipeline's ``timings``.

Every JAX script gets an ``--out`` under ``tmp_path``: no test writes
``PARITY.md``, ``NORTHSTAR.md``, ``MESH_BENCH.md`` or a ``.partial.jsonl``
of the checkout.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from maskclustering_tpu_torch.tools import (
    claims_diag,
    fb_identity,
    hbm_analysis,
    mesh_bench,
    micro,
    northstar,
    parity_ab,
    profile_postprocess,
    profile_scene,
)

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_POINT = dict(scenes=1, frames=3, boxes=2, k_max=15)
TINY_PARITY = ["--points", "tiny", "--image-h", "96", "--image-w", "128", "--spacing", "0.03",
               "--floor-spacing", "0.06"]
CLAIMS_ARGS = ["--frames", "4", "--points", "8192", "--boxes", "3", "--k-max", "15"]
FB_ARGS = ["--frames", "6", "--points", "4096", "--boxes", "3", "--frame-batch", "4",
           "--k-max", "15"]
MESH_ARGS = ["--scenes", "2", "--points", "4096", "--frames", "8", "--boxes", "3",
             "--image-h", "40", "--image-w", "56", "--mesh", "2", "4"]
HBM_ARGS = ["--frames", "16", "--points", "4096", "--image-h", "32", "--image-w", "40",
            "--k-max", "15", "--mesh", "1", "8"]


def _jax_script(name: str):
    """A JAX script loaded as a module (it puts the repository root on
    sys.path itself)."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _start(args, tmp_path, tag):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    out = open(tmp_path / f"{tag}.log", "w")
    return subprocess.Popen([sys.executable, *args], cwd=REPO, env=env, stdout=out,
                            stderr=subprocess.STDOUT, text=True), tmp_path / f"{tag}.log"


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX scripts that run as subprocesses, started together."""
    tmp = tmp_path_factory.mktemp("jax_scripts")
    procs = {
        "northstar": _start(["scripts/northstar.py", "--quick", "--platform", "cpu",
                             "--out", str(tmp / "NORTHSTAR.md")], tmp, "northstar"),
        "mesh_bench": _start(["scripts/mesh_bench.py", *MESH_ARGS,
                              "--out", str(tmp / "MESH_BENCH.md")], tmp, "mesh_bench"),
        "hbm_analysis": _start(["scripts/hbm_analysis.py", *HBM_ARGS,
                                "--out", str(tmp / "HBM.md")], tmp, "hbm_analysis"),
        "claims_diag": _start(["scripts/claims_diag.py", "--platform", "cpu", *CLAIMS_ARGS],
                              tmp, "claims_diag"),
        "fb_identity": _start(["scripts/fb_identity.py", "--platform", "cpu", *FB_ARGS],
                              tmp, "fb_identity"),
    }
    out = {}
    for name, (proc, log) in procs.items():
        rc = proc.wait(timeout=600)
        out[name] = (rc, log.read_text())
    out["dir"] = tmp
    return out


def _partials(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def test_northstar_quick_matches_the_jax_sweep(jax_runs, tmp_path):
    rc_j, log = jax_runs["northstar"]
    assert rc_j == 0, log[-3000:]
    out = str(tmp_path / "NORTHSTAR.md")
    assert northstar.main(["--quick", "--device", "cpu", "--out", out]) == 0
    want = _partials(str(jax_runs["dir"] / "NORTHSTAR.md") + ".partial.jsonl")
    got = _partials(out + ".partial.jsonl")
    assert [(r["scene"], r["bucket"], r["found"]) for r in got] == \
        [(r["scene"], r["bucket"], r["found"]) for r in want]
    assert [r["scene"] for r in got] == list(range(len(northstar.QUICK_SPECS)))
    assert northstar.SCENE_SPECS == _jax_script("northstar").SCENE_SPECS
    assert northstar.QUICK_SPECS == _jax_script("northstar").QUICK_SPECS
    assert "311-scene projection on 8 H100 cards" in open(out).read()


def test_mesh_bench_matches_the_jax_script(jax_runs, tmp_path):
    rc_j, log = jax_runs["mesh_bench"]
    assert rc_j == 0, log[-3000:]
    out = str(tmp_path / "MESH_BENCH.md")
    assert mesh_bench.main([*MESH_ARGS, "--device", "cpu", "--out", out]) == 0

    def objects(path):
        return re.search(r"\| objects recovered \| (\[.*\]) \|", open(path).read()).group(1)

    assert objects(out) == objects(str(jax_runs["dir"] / "MESH_BENCH.md"))
    assert "8 mesh coordinates on the CPU" in open(out).read()
    assert mesh_bench.mesh_devices(torch.device("cpu"), 3) == [torch.device("cpu")] * 3


def test_hbm_analysis_exits_as_the_jax_script(jax_runs, capsys):
    rc_j, log = jax_runs["hbm_analysis"]
    assert rc_j == 0 and "planned total" in log, log[-3000:]
    assert hbm_analysis.main([*HBM_ARGS, "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "[hbm] OK: headroom" in text and "per coordinate:" in text
    assert hbm_analysis.device_memory_bytes(torch.device("cpu")) > 0


def _drain(text):
    m = re.search(r"emit-only drain: ([0-9.]+) MB/scene \((\d+) objects", text)
    return m.group(1), int(m.group(2))


def test_claims_diag_drains_what_the_jax_script_drains(jax_runs, capsys):
    rc_j, log = jax_runs["claims_diag"]
    assert rc_j == 0, log[-3000:]
    assert claims_diag.main([*CLAIMS_ARGS, "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "[claims_diag] OK" in text
    assert _drain(text) == _drain(log)


def test_fb_identity_matches_the_jax_script(jax_runs, capsys):
    rc_j, log = jax_runs["fb_identity"]
    assert rc_j == 0 and "[fb_identity] OK" in log, log[-3000:]
    assert fb_identity.main([*FB_ARGS, "--device", "cpu"]) == 0
    assert "[fb_identity] OK: frame_batch=4 byte-identical" in capsys.readouterr().out


def test_frame_batched_association_equals_jax():
    """The tool's frame-batched association has the fields of the JAX
    ``associate_scene`` on the same device-rendered scene."""
    import jax.numpy as jnp

    from maskclustering_tpu.models.backprojection import associate_scene as jax_associate
    from maskclustering_tpu.utils.synthetic import make_scene_device as jax_make
    from maskclustering_tpu_torch.config import PipelineConfig
    from maskclustering_tpu_torch.utils.synthetic import make_scene_device, resize_scene_points

    kw = dict(num_boxes=3, num_frames=5, image_hw=(96, 128), spacing=0.025, seed=3)
    tensors, _, _ = make_scene_device(**kw, device="cpu")
    tensors.scene_points = resize_scene_points(tensors.scene_points, 4096)
    cfg = PipelineConfig(config_name="fb", dataset="demo", distance_threshold=0.01,
                         few_points_threshold=25, coverage_threshold=0.3)
    got = fb_identity.associate_frame_batches(tensors, cfg, k_max=15, frame_batch=2,
                                              device="cpu")
    jt, _, _ = jax_make(**kw)
    want = jax_associate(jnp.asarray(resize_scene_points(jt.scene_points, 4096)), jt.depths,
                         jt.segmentations, jnp.asarray(jt.intrinsics),
                         jnp.asarray(jt.cam_to_world), jnp.asarray(jt.frame_valid), k_max=15,
                         window=1, distance_threshold=0.01, few_points_threshold=25,
                         coverage_threshold=0.3, frame_batch=1)
    for field in fb_identity.FIELDS:
        np.testing.assert_array_equal(got[field].numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert fb_identity.first_difference(got, got) is None
    bad = dict(got, boundary=~got["boundary"])
    assert fb_identity.first_difference(got, bad).startswith("boundary differs")


def test_parity_pure_functions_equal_the_jax_script():
    jp = _jax_script("parity_ab")
    assert parity_ab.OPERATING_POINTS == jp.OPERATING_POINTS
    rng = np.random.default_rng(0)
    sets_a = {(f, i): np.unique(rng.integers(0, 50, 12)) for f in range(3) for i in range(1, 5)}
    sets_b = {k: np.unique(np.concatenate([v[:-2], rng.integers(0, 50, 3)]))
              for k, v in list(sets_a.items())[2:]}
    sets_b[(9, 9)] = np.arange(3)
    assert parity_ab.jaccard_stats(sets_a, sets_b) == jp.jaccard_stats(sets_a, sets_b)

    class Assoc:  # claim planes: the port's are tensors, JAX's arrays
        def __init__(self, wrap):
            first = rng.integers(-1, 5, (3, 40)).astype(np.int16)
            last = np.where(rng.random((3, 40)) < 0.3, rng.integers(0, 5, (3, 40)), first)
            valid = rng.random((3, 6)) < 0.8
            self.first_id, self.last_id, self.mask_valid = (
                wrap(x) for x in (first, last.astype(np.int16), valid))

    rng = np.random.default_rng(1)
    a_port = Assoc(torch.from_numpy)
    rng = np.random.default_rng(1)
    a_jax = Assoc(np.asarray)
    got, want = (parity_ab.mask_sets_from_association(a_port, 4),
                 jp.mask_sets_from_association(a_jax, 4))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _parity_rows(text):
    return [line for line in text.splitlines()
            if line.startswith(("| dense", "| exact", "| **gap", "| 0 |", "| tiny |"))]


def test_parity_tiny_point_equals_the_jax_script(tmp_path, monkeypatch):
    import jax.numpy as jnp

    import maskclustering_tpu.models.exact_backprojection as jax_exact
    from maskclustering_tpu.ops.neighbor import ball_query as jax_ball_query

    def jnp_group(q, c, ql, cl, k, radius):  # the f32 contract, not the CPU's f64 KD-tree
        return np.asarray(jax_ball_query(jnp.asarray(q), jnp.asarray(c), jnp.asarray(ql),
                                         jnp.asarray(cl), k=k, radius=radius))

    jp = _jax_script("parity_ab")
    monkeypatch.setitem(jp.OPERATING_POINTS, "tiny", TINY_POINT)
    monkeypatch.setitem(parity_ab.OPERATING_POINTS, "tiny", TINY_POINT)
    monkeypatch.setattr(jax_exact, "_ball_query_group", jnp_group)
    jax_out = tmp_path / "PARITY_jax.md"
    monkeypatch.setattr(sys, "argv", ["parity_ab.py", *TINY_PARITY, "--out", str(jax_out)])
    with pytest.raises(SystemExit) as done:
        jp.main()
    port_out = tmp_path / "PARITY_port.md"
    rc = parity_ab.main([*TINY_PARITY, "--device", "cpu", "--out", str(port_out)])
    assert rc == done.value.code
    want, got = _parity_rows(jax_out.read_text()), _parity_rows(port_out.read_text())
    assert len(want) == 5 and got == want


def test_profile_tools_and_micro_run_with_their_verdicts(tmp_path, capsys):
    small = ["--frames", "4", "--points", "4096", "--boxes", "3", "--image-h", "40",
             "--image-w", "56"]
    trace_dir = tmp_path / "trace"
    assert profile_scene.main([*small, "--distance-threshold", "0.05", "--device", "cpu",
                               "--trace-dir", str(trace_dir)]) == 0
    assert (trace_dir / "trace.json").stat().st_size > 0
    assert profile_postprocess.main([*small, "--runs", "2", "--device", "cpu"]) == 0
    assert micro.main(["--frames", "3", "--points", "512", "--reps", "4", "--pixels", "300",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert "[profile_scene] OK: trace" in out.out and "not measured" in out.out
    assert "[profile_postprocess] OK: 2 runs on cpu" in out.out
    assert "[micro] OK: 9 primitives on cpu" in out.out
    timings = out.err.split("run 1: ")[1].splitlines()[0]
    for stage in ("associate", "graph", "cluster", "postprocess", "post.dbscan"):
        assert f"'{stage}'" in timings, timings
