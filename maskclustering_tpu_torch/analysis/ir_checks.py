"""Family 1: invariants of the fused step, read from the cost census
(counterpart of ``maskclustering_tpu/analysis/ir_checks.py``).

The JAX family reads the AOT-lowered fused step's StableHLO and HLO. The
port has no compiled module, so it reads the cost observatory's census of
one seeded run instead (``obs/cost.observe_costs``: every aten op, product
and cross-device copy the step makes), at the canonical shape, over the
mesh lattice, on meshes that repeat one device:

- **counting class** (``IR.DTYPE.COUNT``): the number of float32 products
  over {0, 1} operands (``ops/counting.py``'s dispatch) in each stage is
  pinned a scene (``EXPECTED_COUNTING_PRODUCTS``), so one extra product
  grows the count and fails, as ``EXPECTED_WIDE_DOTS`` does in JAX; a
  float32 product over other values (``IR.DTYPE.WIDE``, pinned at 0) or a
  product of another class (``IR.DTYPE.CLASS``) fails too;
- **no float64 on the device** (``IR.F64``): every float64 op is reported
  by its source site; the audited ``ops.geometry.sqrt_f32`` sites (the
  correctly rounded float32 root) are suppressed in the port's
  ``analysis/baseline.json``, each with its reason;
- **claim-plane type** (``IR.CLAIMPLANE``): the (F, N) first/last claim
  planes stay int16;
- **host-sync census** (``IR.HOSTSYNC``): a guarded canonical scene
  (``analysis/transfer_guard.py``) makes exactly the named pulls of
  ``EXPECTED_HOST_SYNCS``, each with its reason beside the JAX package's
  one; an unsanctioned read is a finding;
- **cross-device bytes** (``IR.COLLECTIVE.*``): a scene-DP mesh moves 0
  bytes between devices; frame- and point-sharded meshes stay within the
  JAX package's envelopes at the canonical shape.

The JAX family's donation check has no counterpart (torch has no
donation) and neither have its bf16/int8 counting classes: the port's
counting products are float32 under either ``count_dtype`` (ROADMAP §C).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from maskclustering_tpu_torch.analysis.findings import Finding, make_id

# the JAX family's canonical analyzer shape and mesh lattice
CANONICAL_SHAPE = dict(frames=8, points=1024, image_hw=(24, 32), k_max=7)
LATTICE: Tuple[Tuple[int, ...], ...] = ((1, 8), (2, 4), (4, 2), (8, 1))
POINT_LATTICE: Tuple[Tuple[int, ...], ...] = ((1, 2, 4),)
FULL_LATTICE: Tuple[Tuple[int, ...], ...] = LATTICE + POINT_LATTICE
STAGES = ("backprojection", "graph", "clustering", "postprocess")

# float32 {0, 1} products a scene at the canonical shape and seed: graph's
# co-occurrence product per 256-point chunk (4) and its two visibility
# products, the clustering's two segment-ORs of its one schedule step, the
# node-statistics denominator; the fused step is association + graph +
# clustering
EXPECTED_COUNTING_PRODUCTS: Dict[str, int] = {
    "backprojection": 0, "graph": 6, "clustering": 2, "postprocess": 1, "fused": 8}
EXPECTED_WIDE_PRODUCTS = 0
COUNTING_CLASS = "f32xf32->f32"

# the JAX package's run_scene_device makes ONE host sync, the mask table
# (maskclustering_tpu/analysis/ir_checks.py EXPECTED_HOST_SYNCS = 1)
JAX_HOST_SYNCS = 1
# the port's named windows a guarded canonical scene opens (the dense
# path), each with the reason it is there; the sweep count is the
# canonical scene's (data-dependent: one flag a propagation sweep)
EXPECTED_HOST_SYNCS: Dict[str, int] = {
    "scene.upload": 1,       # the explicit upload of the scene (JAX: device_put)
    "fence.associate": 1,    # the stage fence: timings are device time
    "mask_valid": 1,         # the one pull JAX has: M_pad is data-dependent
    "mask_table.upload": 1,  # the compact mask table back to the card
    "fence.graph": 1,
    "cluster.schedule": 1,   # the schedule's +inf read decides the loop length
    "cluster.sweep": 22,     # one flag a propagation sweep (JAX: lax.while_loop)
    "fence.cluster": 1,
}

# cross-device envelopes (JAX ir_checks.py:79-91): scene-DP moves nothing
SCENE_DP_BUDGET_BYTES = 2.0
FRAME_SHARDED_BUDGET_BYTES = 128.0 * 1024
POINT_SHARDED_BUDGET_BYTES = 256.0 * 1024


def _mesh_label(mesh_shape: Sequence[int]) -> str:
    return "x".join(str(int(m)) for m in mesh_shape)


def check_counting_products(row: Dict, label: str, scenes: int = 1) -> List[Finding]:
    """The stage's product census against its pinned counts."""
    findings: List[Finding] = []
    stage = row["stage"]
    want = EXPECTED_COUNTING_PRODUCTS.get(stage)
    got = int(row.get("counting_products", 0))
    if want is not None and got != want * scenes:
        findings.append(Finding(
            id=make_id("IR.DTYPE.COUNT", label), check="IR.DTYPE.COUNT", family="ir",
            message=f"{label}: {got} float32 {{0, 1}} product(s), pinned at {want} a scene "
                    f"x {scenes} — a counting product appeared or vanished; audit it and "
                    f"update EXPECTED_COUNTING_PRODUCTS"))
    wide = int(row.get("wide_products", 0))
    if wide != EXPECTED_WIDE_PRODUCTS * scenes:
        findings.append(Finding(
            id=make_id("IR.DTYPE.WIDE", label), check="IR.DTYPE.WIDE", family="ir",
            message=f"{label}: {wide} float32 product(s) over values other than 0 and 1 "
                    f"(pinned at {EXPECTED_WIDE_PRODUCTS})"))
    for cls in sorted(set(row.get("dots") or {}) - {COUNTING_CLASS}):
        findings.append(Finding(
            id=make_id("IR.DTYPE.CLASS", label, cls), check="IR.DTYPE.CLASS", family="ir",
            message=f"{label}: product class {cls} — the port's products are "
                    f"{COUNTING_CLASS} only"))
    return findings


def check_no_f64(row: Dict) -> List[Finding]:
    """One finding a float64 source site (mesh-independent ids, so one
    baseline entry audits a site)."""
    return [Finding(
        id=make_id("IR.F64", site), check="IR.F64", family="ir",
        message=f"float64 on the device at {site} ({n} op(s) in {row['stage']}): only the "
                f"audited ops.geometry.sqrt_f32 sites may widen")
        for site, n in sorted((row.get("f64_ops") or {}).items())]


def check_claim_planes(row: Dict, label: str) -> List[Finding]:
    dtypes = row.get("claim_plane_dtypes")
    if dtypes is None or list(dtypes) == ["i16"]:
        return []
    return [Finding(id=make_id("IR.CLAIMPLANE", label), check="IR.CLAIMPLANE", family="ir",
                    message=f"{label}: first/last claim planes are {dtypes}, not int16")]


def check_host_syncs(pulls: Optional[Dict[str, int]], error: Optional[str] = None
                     ) -> List[Finding]:
    """A guarded scene's named pulls against ``EXPECTED_HOST_SYNCS``; an
    ``error`` is an unsanctioned read the guard raised on."""
    if error is not None:
        return [Finding(id=make_id("IR.HOSTSYNC", "unsanctioned"), check="IR.HOSTSYNC",
                        family="ir", message=f"guarded canonical scene: {error}")]
    findings: List[Finding] = []
    for name in sorted(set(pulls or {}) | set(EXPECTED_HOST_SYNCS)):
        got, want = int((pulls or {}).get(name, 0)), EXPECTED_HOST_SYNCS.get(name, 0)
        if got != want:
            findings.append(Finding(
                id=make_id("IR.HOSTSYNC", name), check="IR.HOSTSYNC", family="ir",
                message=f"guarded canonical scene: {got} '{name}' window(s), pinned at "
                        f"{want} (JAX makes {JAX_HOST_SYNCS} host sync a scene)"))
    return findings


def check_cross_device(row: Dict, mesh_shape: Sequence[int], label: str,
                       canonical: bool = True) -> List[Finding]:
    """Bytes copied between mesh coordinates, a scene lane (the payload of
    an SPMD collective is one lane's), against the JAX envelopes."""
    nbytes = float(row.get("ici_bytes") or 0.0) / max(int(mesh_shape[0]), 1)
    p_ax = mesh_shape[2] if len(mesh_shape) == 3 else 1
    if mesh_shape[1] == 1 and p_ax == 1:
        budget, check = SCENE_DP_BUDGET_BYTES, "IR.COLLECTIVE.SCENE_DP"
    elif p_ax > 1:
        budget, check = POINT_SHARDED_BUDGET_BYTES, "IR.COLLECTIVE.POINT"
    else:
        budget, check = FRAME_SHARDED_BUDGET_BYTES, "IR.COLLECTIVE.FRAME"
    if check != "IR.COLLECTIVE.SCENE_DP" and not canonical:
        return []  # the sharded envelopes are pinned at the canonical shape only
    if nbytes <= budget:
        return []
    return [Finding(id=make_id(check, label), check=check, family="ir",
                    message=f"{label}: {nbytes:.0f} bytes between devices a scene, over the "
                            f"{budget:.0f}-byte envelope")]


def guarded_scene_pulls(device="cpu", cfg=None) -> Tuple[Optional[Dict[str, int]],
                                                         Optional[str]]:
    """The named pulls of one guarded canonical scene (the single-device
    dense path): ``(pulls, None)``, or ``(None, error)`` when the guard
    raised."""
    from maskclustering_tpu_torch.analysis import transfer_guard
    from maskclustering_tpu_torch.config import PipelineConfig
    from maskclustering_tpu_torch.models.pipeline import run_scene_device
    from maskclustering_tpu_torch.utils.synthetic import make_scene, to_scene_tensors

    if cfg is None:
        cfg = PipelineConfig(config_name="synthetic", dataset="demo", distance_threshold=0.03,
                             step=1, mask_pad_multiple=64, point_chunk=2048,
                             frame_pad_multiple=8)
    tensors = to_scene_tensors(make_scene(num_boxes=3, num_frames=6, seed=3, spacing=0.05))
    prev = transfer_guard._armed
    transfer_guard.arm(True)
    try:
        run_scene_device(tensors, cfg, k_max=15, device=device)
    except transfer_guard.HostSyncError as e:
        return None, str(e)
    finally:
        transfer_guard.arm(prev)
    return transfer_guard.scene_pulls(), None


def analyze_ir(meshes: Sequence[Tuple[int, ...]] = FULL_LATTICE, *,
               shape: Optional[Dict] = None, cfg=None, device="cpu",
               stages_mesh: Optional[Tuple[int, ...]] = (1, 1),
               rows: Optional[List[Dict]] = None) -> Tuple[List[Finding], List[Dict]]:
    """Run the family; returns (findings, the census rows).

    The four stages run alone on ``stages_mesh`` (None skips them) and the
    fused step on every mesh of ``meshes``, at ``shape`` (default: the
    canonical one), then the guarded scene. ``rows`` reuses census rows
    another caller already made (``obs.cost.observe_costs``)."""
    from maskclustering_tpu_torch.obs.cost import default_pipeline_cfg, observe_costs

    shape = dict(CANONICAL_SHAPE) if shape is None else dict(shape)
    canonical = shape == CANONICAL_SHAPE
    if cfg is None:
        cfg = default_pipeline_cfg(point_chunk=max(256, shape["points"] // 4))
    if rows is None:
        # every lane the same seeded scene, so a mesh's counts are its
        # scene count times one lane's
        from maskclustering_tpu_torch.parallel.sharded import _seeded_batch

        one = _seeded_batch(1, shape["frames"], shape["points"], shape["image_hw"], seed=0)
        s_max = max([m[0] for m in meshes] + [1])
        batch = tuple(np.repeat(a, s_max, axis=0) for a in one)
        rows = []
        if stages_mesh is not None:
            rows += observe_costs([stages_mesh], stages=STAGES, cfg=cfg, device=device,
                                  batch=batch, **shape)
        rows += observe_costs(meshes, stages=("fused",), cfg=cfg, device=device, batch=batch,
                              **shape)
    findings: List[Finding] = []
    f64: Dict[str, Finding] = {}
    analyzed = 0
    for row in rows:
        mesh = tuple(row.get("mesh") or ())
        label = f"{row['stage']}@{_mesh_label(mesh)}"
        if "error" in row:
            findings.append(Finding(id=make_id("IR.RUN", label), check="IR.RUN", family="ir",
                                    message=f"{label}: the census run failed: {row['error']}"))
            continue
        analyzed += row["stage"] == "fused"
        scenes = mesh[0] if row["stage"] != "postprocess" else 1
        if canonical:
            findings += check_counting_products(row, label, scenes)
        for fnd in check_no_f64(row):
            f64.setdefault(fnd.id, fnd)
        findings += check_claim_planes(row, label)
        if row["stage"] == "fused":
            findings += check_cross_device(row, mesh, label, canonical)
    findings += list(f64.values())
    if meshes and analyzed == 0:
        findings.append(Finding(
            id=make_id("IR.MESH", "none-analyzed"), check="IR.MESH", family="ir",
            message=f"no requested mesh {sorted(set(meshes))} ran the fused step — the IR "
                    f"invariants are unverified"))
    pulls, error = guarded_scene_pulls(device)
    findings += check_host_syncs(pulls, error)
    return findings, rows

