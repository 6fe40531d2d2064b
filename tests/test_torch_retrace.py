"""The port's retrace family on the build and launch surfaces
(``maskclustering_tpu_torch/analysis/retrace_sanitizer.py`` and
``retrace.py``), against the JAX package's, on the CPU.

- The sanitizer: a repeated build in one context and a new launch key after
  the freeze are both violations; a ladder context makes a rung's first
  launches new keys, not repeats; the digest and summary keep the JAX
  schema; the plain versions on the CPU book the kernels' launch keys.
- A CPU daemon warmed on a scan and frozen serves that scan again with 0
  new keys, and a request in a new bucket after the freeze is a violation.
- The static half: the launch-surface census equals the port's committed
  baseline (growth and shrinkage fail), the canary goldens' coordinates
  match, and an unclassified ``torch.compile`` site is a finding.
"""

import json
import os
import shutil
import tempfile

import pytest
import torch

from maskclustering_tpu.analysis import retrace_sanitizer as jax_rs
from maskclustering_tpu_torch.analysis import retrace
from maskclustering_tpu_torch.analysis import retrace_sanitizer as rs
from maskclustering_tpu_torch.config import load_config
from maskclustering_tpu_torch.ops import cuda

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def sanitizer():
    rs.reset()
    rs.arm(True)
    rs.install()
    yield rs
    rs.uninstall()
    rs.arm(None)
    rs.reset()


def test_repeat_build_and_post_freeze_key_are_violations(sanitizer):
    for hook in cuda.BUILD_HOOKS:
        hook("associate", "/c/libmc_associate-1.so")
    cuda.note_plain("associate_claim", (8, 1024, 24, 32, 9))
    cuda.note_plain("associate_claim", (8, 1024, 24, 32, 9))  # a warm repeat: no violation
    assert rs.violations() == []
    for hook in cuda.BUILD_HOOKS:
        hook("associate", "/c/libmc_associate-1.so")  # the same library again
    assert [v["kind"] for v in rs.violations()] == ["repeat"]
    rs.freeze()
    cuda.note_plain("associate_claim", (8, 1024, 24, 32, 9))  # seen: fine
    cuda.note_plain("associate_claim", (16, 1024, 24, 32, 9))  # new after the freeze
    kinds = [v["kind"] for v in rs.violations()]
    assert kinds == ["repeat", "post_freeze"]
    rs.set_context("sequential-executor")
    cuda.note_plain("associate_claim", (8, 1024, 24, 32, 9))  # a rung's first launch
    assert rs.summary()["post_freeze"] == 2 and rs.summary()["repeats"] == 1
    d = rs.digest()
    assert set(d) == set(jax_rs.digest()) and set(rs.summary()) - {"launch_keys"} == set(
        jax_rs.summary())
    assert d["compiles"] == 2 and d["distinct_keys"] == 3 and d["context"] == "sequential-executor"
    assert rs.ENV_FLAG == jax_rs.ENV_FLAG


def test_a_cpu_scene_books_the_kernels_launch_keys(sanitizer):
    from maskclustering_tpu_torch.models import run_scene
    from maskclustering_tpu_torch.utils.synthetic import make_scene, to_scene_tensors

    cfg = load_config("scannet", distance_threshold=0.03, step=1, mask_pad_multiple=64,
                      point_chunk=2048, frame_pad_multiple=8)
    tensors = to_scene_tensors(make_scene(num_boxes=2, num_frames=4, seed=3, spacing=0.08))
    run_scene(tensors, cfg, k_max=15, device="cpu")
    keys = rs.snapshot_keys()
    assert {k[0] for k in keys} == {"associate_table", "associate_claim", "associate_assign"}
    run_scene(tensors, cfg, k_max=15, device="cpu")
    assert rs.snapshot_keys() == keys and rs.digest()["buckets_new"] >= 1
    assert cuda.LAUNCHES.counts.get("associate_claim", 0) == 0  # no kernel ran here


def _short_socket():
    base = tempfile.gettempdir()
    return os.path.join(tempfile.mkdtemp(prefix="mct", dir=base if len(base) <= 64 else "/tmp"),
                        "s.sock")


def test_a_warm_frozen_cpu_daemon_books_no_new_keys(sanitizer, tmp_path):
    from maskclustering_tpu_torch.serve import ServeClient
    from maskclustering_tpu_torch.serve.daemon import ServeDaemon
    from maskclustering_tpu_torch.utils.synthetic import make_scene, write_scannet_layout

    root = str(tmp_path / "data")
    write_scannet_layout(make_scene(num_boxes=2, num_frames=6, image_hw=(32, 48), seed=60,
                                    spacing=0.08), root, "scene0000_00")
    cfg = load_config("scannet", data_root=root, step=1, distance_threshold=0.05,
                      mask_pad_multiple=32, frame_pad_multiple=8)
    sock = _short_socket()
    d = ServeDaemon(cfg, socket_path=sock, capacity=2, journal_dir=None, device="cpu",
                    warm_scenes=("scene0000_00",))
    d.start()
    try:
        assert rs.digest()["frozen"] and rs.violations() == []
        warm_keys = rs.snapshot_keys()
        with ServeClient(sock, timeout_s=120.0) as c:
            term, _, _ = c.run_scene("scene0000_00")
            assert term["status"] == "ok", term
            assert rs.snapshot_keys() == warm_keys and rs.violations() == []
            assert c.stats()["retrace"]["post_freeze"] == 0
            # a bucket warm-up never saw: more frames, a new launch shape
            term, _, _ = c.run_scene("cold", synthetic={
                "num_boxes": 2, "num_frames": 12, "image_hw": [32, 48], "spacing": 0.08,
                "seed": 61})
            assert term["status"] == "ok", term
            stats = c.stats()["retrace"]
    finally:
        d.request_stop()
        d.shutdown()
        shutil.rmtree(os.path.dirname(sock), ignore_errors=True)
    assert stats["post_freeze"] >= 1 and stats["frozen"]
    assert {v["kind"] for v in rs.violations()} == {"post_freeze"}


def test_launch_surface_equals_the_committed_baseline(tmp_path):
    assert retrace.analyze_retrace(REPO) == []
    path = os.path.join(REPO, retrace.DEFAULT_SURFACE_BASELINE)
    doc = retrace.load_surface_baseline(path)
    assert doc["surface"] == retrace.launch_surface()["surface"]
    assert doc["fused"] == retrace.fused_surface_rows()
    # the ratchet: a dropped row is growth, an extra one shrinkage
    doc["surface"] = doc["surface"][1:] + ["associate_claim 1x1x1x1x9"]
    bad = str(tmp_path / "surface.json")
    with open(bad, "w") as fh:
        json.dump(doc, fh)
    ids = [f.id for f in retrace.analyze_retrace(REPO, surface_baseline=bad)]
    assert len(ids) == 2 and any(":grew:" in i for i in ids) and any(
        ":shrank:associate_claim 1x1x1x1x9" in i for i in ids)
    # the goldens' coordinates are the JAX workload's
    from maskclustering_tpu.analysis.retrace import expected_goldens_coords as jax_coords

    assert retrace.expected_goldens_coords() == jax_coords()


def test_an_unclassified_compile_site_is_a_finding(tmp_path):
    pkg = tmp_path / "maskclustering_tpu_torch"
    pkg.mkdir()
    (pkg / "fast.py").write_text(
        "import torch\n\n\n@torch.compile\ndef fused(x):\n    return x + 1\n\n\n"
        "def build():\n    return torch.utils.cpp_extension.load_inline('m', '')\n")
    ids = sorted(f.id for f in retrace.analyze_retrace(str(tmp_path)))
    assert ids == [
        "RETRACE.STATIC:maskclustering_tpu_torch/fast.py:build:torch.utils.cpp_extension.load_inline",
        "RETRACE.STATIC:maskclustering_tpu_torch/fast.py:fused:torch.compile"]
    # the port's own nvcc build is the one classified site
    assert list(retrace.COMPILE_SITES) == ["maskclustering_tpu_torch/ops/cuda/__init__.py:build"]
