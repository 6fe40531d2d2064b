"""The port's span-triggered profiler capture (``maskclustering_tpu_torch/obs/xprof.py``)
against the JAX package's (``tests/test_obs.py:356-400``), and
``run_pipeline(profile_dir=...)``, on the CPU.

- ``configure(xprof_dir, xprof_spans)``: the named span's first opening
  writes one Chrome trace to ``<dir>/<span>-0/trace.json``; later openings
  respect the limit; an unarmed span captures nothing.
- ``XprofArm`` is bounded and non-reentrant, with the JAX arm's sequence of
  starts and stops; a profiler that fails to start disarms the profiler,
  not the run.
- ``profile_dir`` writes one trace of the ``cluster`` step whose ranges
  include the stage spans, and ``--xprof`` gives way to it.
"""

import json
import os

import pytest
import torch

from maskclustering_tpu.obs.xprof import XprofArm as JaxArm
from maskclustering_tpu.obs.xprof import parse_spans as jax_parse_spans
from maskclustering_tpu_torch import obs
from maskclustering_tpu_torch.obs import xprof
from maskclustering_tpu_torch.obs.xprof import XprofArm, parse_spans

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)


@pytest.fixture
def fresh():
    obs.disable()
    yield
    obs.disable()


def test_span_triggered_capture_writes_one_trace_per_span_name(fresh, tmp_path):
    xdir = str(tmp_path / "xprof")
    obs.configure(str(tmp_path / "events.jsonl"), sample_memory=False, xprof_dir=xdir,
                  xprof_spans=("cluster", "graph"), xprof_limit=1)
    tracer = obs.get_tracer()
    with obs.span("associate"):
        torch.ones(4).sum()  # unarmed span: no capture
    for _ in range(2):
        with obs.span("cluster"):
            torch.ones(4).sum()
    with obs.span("graph"):
        torch.ones(4).sum()
    obs.disable()
    assert tracer.xprof.captured == {"cluster": 1, "graph": 1}
    assert sorted(os.listdir(xdir)) == ["cluster-0", "graph-0"]
    with open(os.path.join(xdir, "cluster-0", xprof.TRACE_FILE)) as fh:
        doc = json.load(fh)
    assert doc["traceEvents"], "an empty trace"


def test_arm_is_bounded_and_non_reentrant(tmp_path, monkeypatch):
    """The JAX arm's contract step for step, the profiler stubbed in both."""
    import jax.profiler

    assert parse_spans("cluster,post.claims.kernel") == jax_parse_spans(
        "cluster,post.claims.kernel")
    calls = {"jax": [], "torch": []}
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: calls["jax"].append("start"))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: calls["jax"].append("stop"))

    class Prof:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            calls["torch"].append("start")

        def __exit__(self, *exc):
            calls["torch"].append("stop")

        def export_chrome_trace(self, path):
            open(path, "w").write("{}")

    monkeypatch.setattr(torch.profiler, "profile", Prof)
    for name, cls in (("jax", JaxArm), ("torch", XprofArm)):
        arm = cls(str(tmp_path / name), ["a", "b"], limit=1)
        assert arm.maybe_start("a")
        assert not arm.maybe_start("b")  # non-reentrant: one session
        arm.stop("b")  # a non-owner's stop is a no-op
        assert arm.active_span == "a"
        arm.stop("a")
        assert arm.active_span is None
        assert not arm.maybe_start("a")  # limit reached
        assert arm.maybe_start("b")
        arm.close()  # stops the open capture and disarms
        assert arm.dead and arm.active_span is None
    assert calls["torch"] == calls["jax"] == ["start", "stop", "start", "stop"]


def test_a_failing_profiler_disarms_the_profiler_not_the_run(fresh, tmp_path, monkeypatch):
    def broken(**kw):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    obs.configure(str(tmp_path / "e.jsonl"), sample_memory=False,
                  xprof_dir=str(tmp_path / "x"), xprof_spans=("*",))
    with obs.span("cluster"):
        pass  # the span body runs
    assert obs.get_tracer().xprof.dead


def test_profile_dir_traces_the_cluster_step_with_stage_ranges(fresh, tmp_path, caplog):
    from maskclustering_tpu_torch.config import load_config
    from maskclustering_tpu_torch.run import run_pipeline
    from maskclustering_tpu_torch.utils.synthetic import make_scene, write_scannet_layout

    root = str(tmp_path / "data")
    write_scannet_layout(make_scene(num_boxes=2, num_frames=4, image_hw=(32, 40), seed=3,
                                    spacing=0.08), root, "scene0000_00")
    cfg = load_config("scannet", data_root=root, step=1, distance_threshold=0.05,
                      mask_pad_multiple=32)
    prof = str(tmp_path / "prof")
    rep = run_pipeline(cfg, ["scene0000_00"], steps=("cluster",), resume=False,
                       report_path=str(tmp_path / "r.json"),
                       obs_events=str(tmp_path / "r_events.jsonl"), ledger=False,
                       device="cpu", profile_dir=prof, xprof_spans=("graph",))
    assert rep.ok
    assert "--xprof ignored" in caplog.text  # one profiler session: profile_dir owns it
    assert not os.path.exists(str(tmp_path / "r_events_xprof"))
    with open(os.path.join(prof, "trace.json")) as fh:
        names = {ev.get("name") for ev in json.load(fh)["traceEvents"]}
    assert {"associate", "graph", "cluster"} <= names
