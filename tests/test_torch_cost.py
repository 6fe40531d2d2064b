"""The port's cost observatory (``maskclustering_tpu_torch/obs/cost.py``) and
its report section against the JAX package's (``obs/cost.py``,
``obs/report.py --cost``), on the CPU.

- The census of the five stages at the analyzer's canonical shape: JSON
  rows in the JAX schema, products of the counting class only, int16 claim
  planes, 0 cross-device bytes on a scene-DP mesh and copies counted by
  coordinate on meshes that repeat one device.
- ``obs.report --cost`` renders a JAX cost-event file to the JAX report's
  tables (the rate line gives the H100's rates where JAX gives v5e's), and
  the JAX report reads the port's cost events.
- A hand-written kernel's booked bytes and operations land in its row;
  ``compare_dtypes`` and ``claim_plane_bytes`` keep the JAX schema.
"""

import json

import pytest
import torch

from maskclustering_tpu.obs import cost as jax_cost
from maskclustering_tpu.obs import report as jax_report
from maskclustering_tpu.obs.events import EventSink as JaxSink
from maskclustering_tpu_torch.analysis.ir_checks import CANONICAL_SHAPE
from maskclustering_tpu_torch.obs import cost, report
from maskclustering_tpu_torch.obs.events import EventSink
from maskclustering_tpu_torch.ops import cuda

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

# cost rows as the JAX observatory writes them (keys and value kinds of
# maskclustering_tpu/obs/cost.py observe_costs)
JAX_ROWS = [
    {"stage": stage, "mesh": [1, 8], "devices": 8, "count_dtype": "bf16",
     "fingerprint": {"frames": 8, "points": 1024, "image_hw": [24, 32], "k_max": 7,
                     "backend": "cpu"},
     "lower_s": 0.4, "compile_s": 1.25, "flops": 1.5e6 * (i + 1),
     "hbm_bytes": 2.5e5 * (i + 1), "arg_bytes": 1e4, "out_bytes": 2e4, "temp_bytes": 3e4,
     "alias_bytes": 0.0, "peak_bytes": 6e4,
     "collectives": {"all-gather": {"count": 3 + i, "bytes": 4096.0 * (i + 1)},
                     "all-reduce": {"count": 2, "bytes": 8.0}},
     "ici_bytes": 4096.0 * (i + 1) + 8.0, "ops": {"fusion": 40 + i, "copy": 3, "transpose": 1},
     "dots": {"bf16xbf16->f32": {"count": 4, "operand_bytes": 1024.0}}}
    for i, stage in enumerate(cost.ALL_STAGES)] + [
    {"stage": "graph", "mesh": [8, 1], "error": "RuntimeError: boom",
     "fingerprint": {"frames": 8, "points": 1024, "k_max": 7, "backend": "cpu"}}]


def _tables(text):
    """The report's lines but the rate-context ones (v5e's in JAX, the
    H100's in the port)."""
    return [ln for ln in text.splitlines()
            if not ln.startswith(("ICI total", "cross-device total"))]


@pytest.fixture(scope="module")
def rows():
    return cost.observe_costs([(1, 1), (1, 2), (2, 1)], device="cpu", **CANONICAL_SHAPE)


def test_census_rows_of_the_five_stages(rows):
    by = {(r["stage"], tuple(r["mesh"])): r for r in rows}
    assert {s for s, _ in by} == set(cost.ALL_STAGES)
    assert not [r for r in rows if "error" in r]
    json.dumps(rows)  # JSON-able, as events
    for (stage, mesh), r in by.items():
        assert set(r["dots"]) <= {"f32xf32->f32"}, (stage, mesh)
        assert r["wide_products"] == 0 and r["census"] and r["hbm_bytes"] > 0
        assert r["peak_bytes"] >= r["arg_bytes"]
        if stage in ("backprojection", "fused"):
            assert r["claim_plane_dtypes"] == ["i16"]
        if mesh[1] == 1:
            assert r["ici_bytes"] == 0 and r["collectives"] == {}, (stage, mesh)
    frame = by[("fused", (1, 2))]
    assert frame["ici_bytes"] > 0 and frame["collectives"]["device-copy"]["count"] > 0
    assert by[("graph", (1, 1))]["counting_products"] > 0


def test_report_renders_a_jax_cost_file_as_the_jax_report(tmp_path, capsys):
    path = str(tmp_path / "jax_cost.jsonl")
    sink = JaxSink(path)
    for row in JAX_ROWS:
        sink.emit("cost", row)
    sink.close()
    mine = report.render_cost(report.RunData(path).cost_rows)
    theirs = jax_report.render_cost(jax_report.RunData(path).cost_rows)
    assert _tables(mine) == _tables(theirs)
    assert "v5e" not in mine and "H100" in mine
    assert report.main([path, "--cost"]) == 0
    assert _tables(mine)[0] in capsys.readouterr().out


def test_the_jax_report_reads_the_ports_cost_events(rows, tmp_path):
    path = str(tmp_path / "port_cost.jsonl")
    sink = EventSink(path)
    for row in rows:
        sink.emit("cost", row)
    sink.close()
    theirs = jax_report.render_cost(jax_report.RunData(path).cost_rows)
    mine = report.render_cost(report.RunData(path).cost_rows)
    # the same tables; only the headers differ ("cpu AOT" in JAX, which
    # knows no census)
    assert [ln for ln in _tables(theirs) if not ln.startswith("==")] == [
        ln for ln in _tables(mine) if not ln.startswith("==")]
    assert mine.count("cpu census") == theirs.count("cpu AOT") == 3


def test_a_kernels_booking_lands_in_its_row():
    with cost.observe() as census:
        cuda._launched("associate_claim", (2, 10, 4, 4, 9), 480, 1234)
        cuda._launched("associate_claim", (2, 10, 4, 4, 9), 480, 1234)
        torch.ones(3) + 1
    assert census.kernels == {"associate_claim": {"launches": 2, "flops": 960.0,
                                                  "bytes": 2468.0}}
    assert census.launches == 4  # the two kernels, the fill and the add
    # outside a census nothing is booked and the launch is still counted
    cuda.LAUNCHES.reset()
    cuda._launched("associate_claim", (1,), 1, 1)
    assert cuda.LAUNCHES.counts["associate_claim"] == 1
    cuda.LAUNCHES.reset()


def test_dtype_comparison_and_plane_bytes_keep_the_jax_schema():
    rows_by, diffs = cost.compare_dtypes([(1, 1)], stages=("graph",), device="cpu",
                                         **CANONICAL_SHAPE)
    assert set(rows_by) == {"bf16", "int8"} and len(diffs) == 1
    d = diffs[0]
    # the port's counting products are float32 under either encoding
    assert d["narrowed_bf16"] == d["narrowed_int8"] == {} and d["stable_dots"]
    assert "dtype census" in report.render_dtype_compare(diffs)
    assert cost.claim_plane_bytes(8, 1024) == jax_cost.claim_plane_bytes(8, 1024)
    assert cost.ALL_STAGES == jax_cost.ALL_STAGES
    assert cost.parse_mesh_specs(["1x8,2x4", "1x2x4"]) == jax_cost.parse_mesh_specs(
        ["1x8,2x4", "1x2x4"])


def test_stage_inputs_are_held_to_stage_arg_shapes(monkeypatch):
    from maskclustering_tpu_torch.parallel import sharded

    real = sharded.stage_arg_shapes

    def off_by_one(stage, **kw):
        return real(stage, **dict(kw, r_pad=kw["r_pad"] + 1))

    monkeypatch.setattr(sharded, "stage_arg_shapes", off_by_one)
    rows = cost.observe_costs([(1, 1)], stages=("graph", "postprocess"), device="cpu",
                              **CANONICAL_SHAPE)
    by = {r["stage"]: r for r in rows}
    assert "error" not in by["graph"]
    assert "stage_arg_shapes" in by["postprocess"]["error"]


def test_threaded_lanes_are_counted_once_each():
    # two copies of one scene: the fused step's two lane threads each count
    # what the scene counts alone
    import numpy as np

    from maskclustering_tpu_torch.parallel import sharded

    shape = CANONICAL_SHAPE
    one = sharded._seeded_batch(1, shape["frames"], shape["points"], shape["image_hw"], 0)
    two = tuple(np.concatenate([a, a]) for a in one)
    rows = cost.observe_costs([(1, 1), (2, 1)], stages=("fused",), device="cpu", batch=two,
                              **shape)
    alone, both = (r for r in rows)
    assert "error" not in alone and "error" not in both
    assert both["ops"] == {k: 2 * v for k, v in alone["ops"].items()}
    assert both["counting_products"] == 2 * alone["counting_products"] > 0
    assert both["flops"] == 2 * alone["flops"] and both["hbm_bytes"] == 2 * alone["hbm_bytes"]
    assert both["dots"] == {k: {f: 2 * v for f, v in d.items()}
                            for k, d in alone["dots"].items()}
