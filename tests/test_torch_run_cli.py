"""The port's batch CLI (``maskclustering_tpu_torch/run.py`` ``build_parser``
and ``main``) against the JAX package's (ROADMAP C3).

- Every option string of the JAX ``run.py`` parser is known to the port's
  parser. The JAX parser is captured without editing it: its
  ``parse_args`` is patched to hand the parser over during
  ``maskclustering_tpu.run.main([])``.
- Every JAX tooling flag is ported: the A10 flags (profiler capture, the
  host-sync guard, the build/launch-surface sanitizer, the kernel build
  cache) each run a scan and change no digest; ``--lock-sanitizer`` (A18)
  arms the sanitizer, the report renders the ``locks.*`` counters and the
  observed graph goes beside the report.
- ``--mask_command`` fills the missing masks of a scan, and the artifacts
  equal the JAX CLI's run with the same command.
- ``--init_timeout`` bounds the device's first use.
"""

import argparse
import json
import os
import shutil

import numpy as np
import pytest
import torch

import maskclustering_tpu.config as jax_config
from maskclustering_tpu.run import main as jax_main
from maskclustering_tpu.utils import faults as jax_faults
from maskclustering_tpu.utils.synthetic import make_scene, write_scannet_layout
from maskclustering_tpu_torch import run as pt_run
from maskclustering_tpu_torch.utils import faults

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = "scene0000_00"


class _Captured(Exception):
    def __init__(self, parser):
        super().__init__("parser captured")
        self.parser = parser


@pytest.fixture(scope="module")
def jax_parser():
    saved = argparse.ArgumentParser.parse_args

    def capture(self, *a, **k):
        raise _Captured(self)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(_Captured) as ei:
            jax_main([])
    finally:
        argparse.ArgumentParser.parse_args = saved
    return ei.value.parser


def _options(parser):
    return {opt: action for action in parser._actions for opt in action.option_strings}


def test_every_jax_option_is_known_to_the_port(jax_parser):
    jax_opts, port_opts = _options(jax_parser), _options(pt_run.build_parser())
    missing = sorted(set(jax_opts) - set(port_opts))
    assert not missing, f"the port's parser lacks {missing}"
    # the extra flag is the device, the port's own
    assert set(port_opts) - set(jax_opts) == {"--device"}
    # each flag takes the same number of values, under the same dest
    for opt, action in jax_opts.items():
        mine = port_opts[opt]
        assert (mine.dest, mine.nargs, mine.const) == (action.dest, action.nargs, action.const), opt
        assert type(mine) is type(action), opt


@pytest.fixture(scope="module")
def tooling_scan(tmp_path_factory):
    """One small scan and the digest of a plain CLI run over it."""
    root = tmp_path_factory.mktemp("tooling")
    data = str(root / "data")
    write_scannet_layout(make_scene(num_boxes=2, num_frames=6, image_hw=(40, 56), seed=3,
                                    spacing=0.05), data, SCENE)
    rep = str(root / "plain.json")
    assert pt_run.main(["--config", "scannet", "--data_root", data, "--seq_name_list", SCENE,
                        "--steps", "cluster", "--device", "cpu", "--no-journal", "--no-resume",
                        "--no-ledger", "--report", rep]) == 0
    with open(rep) as fh:
        return data, json.load(fh)["scenes"][0]["digest"]


@pytest.mark.parametrize("flags,item", [
    (["--profile_dir", "{tmp}/p"], "A10"), (["--xprof", "cluster"], "A10"),
    (["--xprof_dir", "{tmp}/x"], "A10"), (["--transfer-guard"], "A10"),
    (["--retrace-sanitizer"], "A10"), (["--aot-cache"], "A10"),
    (["--aot-cache", "{tmp}/aot"], "A10"), (["--lock-sanitizer"], "A18"),
])
def test_unported_flags_raise_naming_their_item(flags, item, tooling_scan, tmp_path,
                                                restore_faults):
    """Every JAX tooling flag is ported: the A18 lock sanitizer (its run is
    in test_lock_sanitizer_flag_arms_and_writes_the_observed_graph) and
    each A10 flag, which passes the parser, runs a scan on the CPU and
    changes no digest."""
    args = pt_run.build_parser().parse_args(["--config", "scannet", *flags])
    if item == "A18":
        assert args.lock_sanitizer
        return
    from maskclustering_tpu_torch.analysis import retrace_sanitizer, transfer_guard
    from maskclustering_tpu_torch.utils import aot_cache

    data, digest = tooling_scan
    flags = [f.replace("{tmp}", str(tmp_path)) for f in flags]
    rep = str(tmp_path / "r.json")
    try:
        rc = pt_run.main(["--config", "scannet", "--data_root", data, "--seq_name_list", SCENE,
                          "--steps", "cluster", "--device", "cpu", "--no-journal",
                          "--no-resume", "--no-ledger", "--report", rep, *flags])
        armed = (transfer_guard.enabled(), retrace_sanitizer.enabled(), aot_cache.active())
    finally:
        transfer_guard.arm(None)
        retrace_sanitizer.arm(None)
        retrace_sanitizer.uninstall()
        retrace_sanitizer.reset()
        aot_cache.reset()
    assert rc == 0
    with open(rep) as fh:
        assert json.load(fh)["scenes"][0]["digest"] == digest
    if "--profile_dir" in flags:
        assert os.path.isfile(str(tmp_path / "p" / "trace.json"))
    if "--xprof" in flags:
        assert os.listdir(str(tmp_path / "r_events_xprof")) == ["cluster-0"]
    assert armed[0] == ("--transfer-guard" in flags)
    assert armed[1] == ("--retrace-sanitizer" in flags)
    assert (armed[2] is not None) == ("--aot-cache" in flags)
    if "{tmp}/aot" in " ".join(f.replace(str(tmp_path), "{tmp}") for f in flags):
        assert armed[2].root == str(tmp_path / "aot")


@pytest.fixture
def restore_faults():
    yield
    for f in (faults, jax_faults):
        f.set_plan(None)
        f.clear_stop()


def test_mask_command_fills_masks_equal_to_the_jax_cli(tmp_path, monkeypatch, restore_faults):
    """Each package's CLI over a scan whose masks are missing: the command
    copies them in, and both runs cluster to equal artifacts."""
    conf_dir = tmp_path / "configs"
    conf_dir.mkdir()
    with open(os.path.join(REPO, "configs", "scannet.json")) as fh:
        conf = json.load(fh)
    conf.update(step=1, distance_threshold=0.05, mask_pad_multiple=32)
    (conf_dir / "c3.json").write_text(json.dumps(conf))
    # the JAX CLI reads configs by name: point its directory at the copy
    monkeypatch.setattr(jax_config, "_CONFIG_DIR", str(conf_dir))
    runs = {}
    for name in ("jx", "pt"):
        root, bak = tmp_path / name, tmp_path / f"{name}_masks"
        write_scannet_layout(make_scene(num_boxes=3, num_frames=8, image_hw=(48, 64), seed=5,
                                        spacing=0.05), str(root), SCENE)
        seg = root / "scannet" / "processed" / SCENE / "output" / "mask"
        bak.mkdir()
        shutil.move(str(seg), str(bak / SCENE))
        cmd = f"cp -r {bak}/{{seq_name}} {root}/scannet/processed/{{seq_name}}/output/mask"
        args = ["--data_root", str(root), "--seq_name_list", SCENE, "--steps",
                "masks,cluster", "--no-resume", "--no-journal", "--mask_command", cmd]
        if name == "jx":
            rc = jax_main(["--config", "c3", "--no-ledger", "--no-obs", *args])
        else:
            rc = pt_run.main(["--config", str(conf_dir / "c3.json"), "--device", "cpu",
                              "--init_timeout", "60", *args])
        assert rc == 0, name
        assert sorted(os.listdir(seg)) == sorted(os.listdir(bak / SCENE)), name
        runs[name] = root
    npz = {n: np.load(r / "prediction" / "c3_class_agnostic" / f"{SCENE}.npz")
           for n, r in runs.items()}
    assert sorted(npz["pt"].files) == sorted(npz["jx"].files)
    for key in npz["jx"].files:
        assert npz["pt"][key].dtype == npz["jx"][key].dtype, key
        np.testing.assert_array_equal(npz["pt"][key], npz["jx"][key], err_msg=key)
    assert npz["pt"]["pred_masks"].shape[1] == 3
    ods = {n: np.load(r / "scannet" / "processed" / SCENE / "output" / "object" / "c3" /
                      "object_dict.npy", allow_pickle=True).item() for n, r in runs.items()}
    assert sorted(ods["pt"]) == sorted(ods["jx"])
    for k, obj in ods["jx"].items():
        np.testing.assert_array_equal(ods["pt"][k]["point_ids"], obj["point_ids"])
        assert ods["pt"][k]["mask_list"] == obj["mask_list"]


def test_init_timeout_bounds_the_devices_first_use(monkeypatch, restore_faults):
    """A first device use that hangs fails the run at ``--init_timeout``."""
    import time

    monkeypatch.setattr(pt_run.torch, "zeros", lambda *a, **k: time.sleep(30))
    with pytest.raises(faults.DeviceStallError, match="device-init"):
        pt_run.main(["--config", "scannet", "--device", "cpu", "--init_timeout", "0.2",
                     "--seq_name_list", SCENE, "--steps", "cluster"])


def test_lock_sanitizer_flag_arms_and_writes_the_observed_graph(tmp_path, restore_faults):
    """``--lock-sanitizer`` on a scan (``run.py:1521-1527`` in JAX): the
    known locks instrumented before the run, the ``locks.*`` counters booked
    before the obs flush (the report's Faults section renders them), and the
    observed order graph written beside the report."""
    from maskclustering_tpu_torch.analysis import lock_sanitizer as ls
    from maskclustering_tpu_torch.analysis.concurrency import build_lock_order_graph
    from maskclustering_tpu_torch.obs import metrics
    from maskclustering_tpu_torch.obs.report import RunData, render_report

    root = str(tmp_path / "data")
    write_scannet_layout(make_scene(num_boxes=2, num_frames=6, image_hw=(40, 56), seed=3,
                                    spacing=0.05), root, SCENE)
    report = str(tmp_path / "rep.json")
    ls.reset()
    try:
        rc = pt_run.main(["--config", "scannet", "--data_root", root, "--seq_name_list", SCENE,
                          "--steps", "cluster", "--device", "cpu", "--no-journal",
                          "--lock-sanitizer", "--report", report, "--no-ledger"])
        assert isinstance(faults._PLAN_LOCK, ls.InstrumentedLock)
    finally:
        # main arms the process for good: put the raw locks back
        ls.arm(None)
        for obj, attr in ((faults, "_PLAN_LOCK"), (metrics.registry(), "_lock")):
            lock = getattr(obj, attr)
            if isinstance(lock, ls.InstrumentedLock):
                setattr(obj, attr, lock._lock)
        ls.reset()
    assert rc == 0
    with open(str(tmp_path / "rep_locks.json")) as fh:
        doc = json.load(fh)
    assert doc["acquisitions"].get("obs.metrics.Registry._lock")
    assert doc["acquisitions"].get("faults._PLAN_LOCK")
    observed = {tuple(e.split(" -> ")) for e in doc["order_edges"]}
    nodes, edges = build_lock_order_graph(REPO)
    assert ls.check_embeds(observed, edges, nodes) == []
    text = render_report(RunData(str(tmp_path / "rep_events.jsonl")))
    assert "lock sanitizer: " in text and " acquisition(s)" in text, text
