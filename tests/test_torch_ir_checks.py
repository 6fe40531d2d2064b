"""The port's IR family (``maskclustering_tpu_torch/analysis/ir_checks.py``)
on the cost census, on the CPU.

- The stages and the fused step on a mesh subset at the canonical shape
  are clean modulo the port's baseline (its one suppression: the audited
  ``sqrt_f32`` site), and each pinned constant keeps the JAX family's.
- Each fixture fails its check: a forced extra counting product, a float64
  op outside the audited site, and an unsanctioned pull in the guarded
  scene; a sharded run over its envelope and int32 claim planes too.
"""

import os

import pytest
import torch

from maskclustering_tpu.analysis import ir_checks as jax_ir
from maskclustering_tpu_torch.analysis import ir_checks
from maskclustering_tpu_torch.analysis.findings import (DEFAULT_BASELINE, load_baseline,
                                                        partition_findings)
from maskclustering_tpu_torch.obs import cost
from maskclustering_tpu_torch.ops import counting

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_the_lattice_subset_is_clean_modulo_the_baseline():
    findings, rows = ir_checks.analyze_ir([(1, 2), (2, 1), (1, 1, 2)], device="cpu")
    baseline = load_baseline(os.path.join(REPO, DEFAULT_BASELINE))
    unsuppressed, suppressed, _ = partition_findings(findings, baseline)
    assert [f.id for f in unsuppressed] == []
    assert [f.id for f in suppressed] == [
        "IR.F64:ops.geometry.sqrt_f32<-models.backprojection.estimate_spacing"]
    assert {r["stage"] for r in rows} == set(cost.ALL_STAGES)
    assert ir_checks.CANONICAL_SHAPE == jax_ir.CANONICAL_SHAPE
    assert ir_checks.FULL_LATTICE == jax_ir.FULL_LATTICE
    assert ir_checks.FRAME_SHARDED_BUDGET_BYTES == jax_ir.FRAME_SHARDED_ICI_BUDGET_BYTES
    assert ir_checks.POINT_SHARDED_BUDGET_BYTES == jax_ir.POINT_SHARDED_ICI_BUDGET_BYTES


def test_a_forced_extra_product_fails_the_count(monkeypatch):
    real = counting.count_dot

    def with_an_extra(a, b, **kw):
        real(a, b, **kw)  # one more {0, 1} product, thrown away
        return real(a, b, **kw)

    monkeypatch.setattr(counting, "count_dot", with_an_extra)
    rows = cost.observe_costs([(1, 1)], stages=("graph",), device="cpu",
                              **ir_checks.CANONICAL_SHAPE)
    ids = [f.id for f in ir_checks.check_counting_products(rows[0], "graph@1x1")]
    assert ids == ["IR.DTYPE.COUNT:graph@1x1"]


def test_a_float64_op_fails_and_names_its_site():
    with cost.observe() as census:
        x = torch.arange(4, dtype=torch.float32)
        (x.double() * 2).float()
    row = {"stage": "graph", "f64_ops": dict(census.f64)}
    findings = ir_checks.check_no_f64(row)
    assert findings and all(f.check == "IR.F64" for f in findings)
    baseline = load_baseline(os.path.join(REPO, DEFAULT_BASELINE))
    assert not [f for f in findings if f.id in baseline]  # not the audited site


def test_an_unsanctioned_pull_fails_the_host_sync_census(monkeypatch):
    from maskclustering_tpu_torch.models import pipeline

    real = pipeline.compute_graph_stats

    def reads(mask_of_point, *a, **kw):
        mask_of_point.sum().item()
        return real(mask_of_point, *a, **kw)

    monkeypatch.setattr(pipeline, "compute_graph_stats", reads)
    pulls, error = ir_checks.guarded_scene_pulls("cpu")
    assert pulls is None and "Tensor.item" in error
    assert [f.id for f in ir_checks.check_host_syncs(pulls, error)] == [
        "IR.HOSTSYNC:unsanctioned"]
    # one window too many is a finding too
    extra = dict(ir_checks.EXPECTED_HOST_SYNCS, **{"cluster.sweep": 23})
    assert [f.id for f in ir_checks.check_host_syncs(extra)] == ["IR.HOSTSYNC:cluster.sweep"]


@pytest.mark.parametrize("mesh,nbytes,check", [
    ((2, 1), 3.0, "IR.COLLECTIVE.SCENE_DP"), ((1, 8), 200e3, "IR.COLLECTIVE.FRAME"),
    ((1, 2, 4), 300e3, "IR.COLLECTIVE.POINT")])
def test_cross_device_bytes_over_the_envelope_fail(mesh, nbytes, check):
    row = {"stage": "fused", "ici_bytes": nbytes * mesh[0]}
    assert [f.check for f in ir_checks.check_cross_device(row, mesh, "x")] == [check]
    row["ici_bytes"] = 0.0
    assert ir_checks.check_cross_device(row, mesh, "x") == []
    bad_planes = {"stage": "fused", "claim_plane_dtypes": ["i32"]}
    assert [f.check for f in ir_checks.check_claim_planes(bad_planes, "x")] == [
        "IR.CLAIMPLANE"]
