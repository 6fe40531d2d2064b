"""Family 5: the build/launch-surface analyzer (retrace, static half), the
port's counterpart of ``maskclustering_tpu/analysis/retrace.py``.

Nothing in the port traces. Its compile surface is the ``nvcc`` builds of
``ops/cuda/*.cu`` (one library a source, keyed by source and flags) and
its program surface the (kernel entry, launch shape) keys its wrappers
launch. Three checks, pure stdlib except the census:

- **RETRACE.STATIC**: every compile site in the package and
  ``chip_smoke.py`` is classified (``COMPILE_SITES``): the ``nvcc`` build
  in ``ops/cuda`` is; any ``torch.compile``, ``torch.jit.script`` /
  ``trace``, ``torch.utils.cpp_extension`` load or ``triton.jit`` (none
  today) is a finding until classified, and a classified site that no
  longer exists is stale;
- **RETRACE.SURFACE**: the census of launch keys the JAX package's
  canonical mixed-bucket workload needs, computed through the port's
  bucket classifier (``utils/compile_cache.scene_bucket``) at ScanNet's
  depth size, plus the fused step's keys on each mesh of the lattice
  (``parallel/sharded.fused_step_aot_key``), must equal the port's own
  baseline, ``maskclustering_tpu_torch/analysis/launch_surface_baseline.json``
  (never the JAX package's ``compile_surface_baseline.json``): growth and
  shrinkage both fail;
- **RETRACE.GOLDENS**: the committed ``canary_goldens.json`` (read only)
  must cover exactly the digest coordinates the canonical workload makes
  under the port's goldens config.

The JAX family's ``RETRACE.CAPTURE`` and ``RETRACE.BRANCH`` check traced
closures and trace-time shape branches; eager torch has neither (ROADMAP
§C). The dynamic half (``retrace_sanitizer``) records the builds and
launch keys at run time, in this vocabulary.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from maskclustering_tpu_torch.analysis.findings import Finding, make_id

DEFAULT_SURFACE_BASELINE = "maskclustering_tpu_torch/analysis/launch_surface_baseline.json"
SURFACE_VERSION = 1
SCAN_ROOTS = ("maskclustering_tpu_torch", "chip_smoke.py")

# every compile site, "<file>:<function>" -> why it is a closed surface
COMPILE_SITES: Dict[str, str] = {
    "maskclustering_tpu_torch/ops/cuda/__init__.py:build":
        "nvcc: one library a source, named by the SHA-256 of source and NVCC_FLAGS, built "
        "once into build/torch_kernels/ or the kernel build cache (utils/aot_cache.py)",
}
# call chains that compile code at run time
_COMPILE_CALLS = ("torch.compile", "torch.jit.script", "torch.jit.trace",
                  "cpp_extension.load", "cpp_extension.load_inline", "triton.jit",
                  "torch.utils.cpp_extension.load", "torch.utils.cpp_extension.load_inline")

# the JAX package's canonical mixed-bucket workload (two buckets and a
# repeat), at ScanNet's depth size: the port's launch keys carry the image
CANONICAL_WORKLOAD: Tuple[Dict, ...] = (
    {"scene": "A", "frames": 10, "points": 16000, "max_id": 14},
    {"scene": "B", "frames": 34, "points": 60000, "max_id": 100},
    {"scene": "A-repeat", "frames": 10, "points": 16000, "max_id": 14},
)
CANONICAL_IMAGE_HW = (480, 640)

# launch surface a degradation-ladder rung adds (none: the sequential
# executor, the single-chip rung and the host post-process launch the
# same association entries, or none)
RUNG_SURFACE: Dict[str, Tuple[str, ...]] = {
    "sequential-executor": (),
    "single-chip": (),
    "host-postprocess": (),
}


def _chain(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def compile_sites(tree: ast.Module, rel: str) -> List[Tuple[str, int, str]]:
    """(``<file>:<function>``, line, what) of every compile site in a file:
    a call (or decorator) of a runtime compiler, or a call that starts
    ``nvcc`` (a command built from ``nvcc_path()``)."""
    out: List[Tuple[str, int, str]] = []

    def visit(node: ast.AST, scope: str) -> None:
        for child in ast.iter_child_nodes(node):
            inner = scope
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner = child.name
                for dec in child.decorator_list:
                    target = dec.func if isinstance(dec, ast.Call) else dec
                    chain = _chain(target) or ""
                    if chain.endswith(_COMPILE_CALLS):
                        out.append((f"{rel}:{inner}", dec.lineno, chain))
            if isinstance(child, ast.Call):
                chain = _chain(child.func) or ""
                if chain.endswith(_COMPILE_CALLS):
                    out.append((f"{rel}:{scope}", child.lineno, chain))
                if chain.endswith("nvcc_path") and _starts_build(node):
                    out.append((f"{rel}:{scope}", child.lineno, "nvcc"))
            visit(child, inner)

    visit(tree, "<module>")
    return out


def _starts_build(parent: ast.AST) -> bool:
    """An ``nvcc_path()`` call inside a list that also names ``-o`` (a
    build command), not a ``--version`` probe."""
    return isinstance(parent, ast.List) and any(
        isinstance(e, ast.Constant) and e.value == "-o" for e in parent.elts)


def check_compile_sites(parsed: Sequence[Tuple[str, ast.Module]]) -> List[Finding]:
    findings: List[Finding] = []
    seen = set()
    for rel, tree in parsed:
        for site, line, what in compile_sites(tree, rel):
            seen.add(site)
            if site in COMPILE_SITES:
                continue
            findings.append(Finding(
                id=make_id("RETRACE.STATIC", site, what), check="RETRACE.STATIC",
                family="retrace", file=rel, line=line,
                message=f"unclassified compile site ({what}) in {site}: a runtime compiler "
                        f"is build surface the launch census cannot see; classify it in "
                        f"COMPILE_SITES with its cache key, or remove it"))
    for site in sorted(set(COMPILE_SITES) - seen):
        findings.append(Finding(
            id=make_id("RETRACE.STATIC", "stale", site), check="RETRACE.STATIC",
            family="retrace",
            message=f"classified compile site {site} no longer exists; drop it from "
                    f"COMPILE_SITES"))
    return findings


def launch_surface(cfg=None) -> Dict:
    """The census: launch keys the canonical workload needs, as a JSON-able
    doc, through the port's bucket classifier."""
    from maskclustering_tpu_torch.obs.cost import default_pipeline_cfg
    from maskclustering_tpu_torch.utils.compile_cache import scene_bucket

    if cfg is None:
        cfg = default_pipeline_cfg(point_chunk=8192).replace(
            frame_pad_multiple=32, mask_pad_multiple=256)
    h, w = CANONICAL_IMAGE_HW
    taps = (2 * int(cfg.association_window) + 1) ** 2
    rows = set()
    for scene in CANONICAL_WORKLOAD:
        _, f, n = scene_bucket(cfg, scene["frames"], scene["points"], scene["max_id"])
        rows |= {f"associate_table {f}x{h}x{w}", f"associate_claim {f}x{n}x{h}x{w}x{taps}",
                 f"associate_assign {f}x{n}x{h}x{w}x{taps}"}
    return {
        "version": SURFACE_VERSION,
        "workload": [dict(s, image_hw=list(CANONICAL_IMAGE_HW)) for s in CANONICAL_WORKLOAD],
        "config": {"frame_pad_multiple": cfg.frame_pad_multiple, "point_chunk": cfg.point_chunk,
                   "association_window": cfg.association_window},
        "surface": sorted(rows),
        "rungs": {k: sorted(v) for k, v in RUNG_SURFACE.items()},
    }


def fused_surface_rows(meshes: Optional[Sequence[Tuple[int, ...]]] = None) -> List[str]:
    """One row a launch key of the fused step on each lattice mesh, at the
    IR family's canonical shape."""
    from maskclustering_tpu_torch.analysis.ir_checks import CANONICAL_SHAPE, FULL_LATTICE
    from maskclustering_tpu_torch.obs.cost import default_pipeline_cfg
    from maskclustering_tpu_torch.parallel.sharded import fused_step_aot_key

    cfg = default_pipeline_cfg(point_chunk=max(256, CANONICAL_SHAPE["points"] // 4))
    rows: List[str] = []
    for mesh in meshes or FULL_LATTICE:
        label = "x".join(str(m) for m in mesh)
        rows += [f"mesh={label} {key}" for key in fused_step_aot_key(mesh, cfg, **CANONICAL_SHAPE)]
    return sorted(rows)


def load_surface_baseline(path: str) -> Optional[Dict]:
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("version") != SURFACE_VERSION:
        raise ValueError(f"{path}: expected a launch-surface baseline with "
                         f"version={SURFACE_VERSION}")
    return doc


def write_surface_baseline(path: str, census: Dict, fused_rows: List[str]) -> None:
    doc = dict(census, fused=sorted(fused_rows))
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")


def check_surface(census: Dict, baseline: Dict, fused_rows: List[str]) -> List[Finding]:
    """The ratchet: census == baseline exactly, growth AND shrinkage."""
    findings: List[Finding] = []

    def diff(kind: str, current: Iterable[str], committed: Iterable[str]) -> None:
        cur, com = set(current), set(committed)
        for row in sorted(cur - com):
            findings.append(Finding(
                id=make_id("RETRACE.SURFACE", kind, "grew", row), check="RETRACE.SURFACE",
                family="retrace",
                message=f"launch surface grew: {row} is needed by the canonical workload but "
                        f"absent from the baseline; audit it, then regenerate with "
                        f"--write-surface"))
        for row in sorted(com - cur):
            findings.append(Finding(
                id=make_id("RETRACE.SURFACE", kind, "shrank", row), check="RETRACE.SURFACE",
                family="retrace",
                message=f"launch surface shrank: baseline row '{row}' is no longer made; "
                        f"regenerate with --write-surface"))

    diff("serving", census["surface"], baseline.get("surface", []))
    for rung in sorted(set(census["rungs"]) | set(baseline.get("rungs", {}))):
        diff(f"rung:{rung}", census["rungs"].get(rung, []),
             (baseline.get("rungs") or {}).get(rung, []))
    diff("fused", fused_rows, baseline.get("fused", []))
    return findings


def expected_goldens_coords(cfg=None) -> set:
    """The digest coordinates ``canary_goldens.json`` must cover, derived
    through the port's classifier under its goldens config."""
    from maskclustering_tpu_torch.obs.canary import goldens_config
    from maskclustering_tpu_torch.utils.compile_cache import scene_bucket

    cfg = cfg or goldens_config()
    coords = set()
    for scene in CANONICAL_WORKLOAD:
        k, f, n = scene_bucket(cfg, scene["frames"], scene["points"], scene["max_id"])
        coords.add(f"k{k}:f{f}:n{n}|{cfg.count_dtype}|single|r0|c0")
    return coords


def check_goldens(repo_root: str, goldens_path: Optional[str] = None) -> List[Finding]:
    """The committed goldens against the canonical workload's coordinates,
    growth and shrinkage both (the file is read, never written)."""
    from maskclustering_tpu_torch.obs import digest as digest_mod
    from maskclustering_tpu_torch.obs.canary import DEFAULT_GOLDENS_PATH, GOLDENS_VERSION

    path = goldens_path or os.path.join(repo_root, DEFAULT_GOLDENS_PATH)
    if not os.path.exists(path):
        return [Finding(id=make_id("RETRACE.GOLDENS", "missing"), check="RETRACE.GOLDENS",
                        family="retrace",
                        message=f"no {DEFAULT_GOLDENS_PATH} at the repo root: the canary "
                                f"sentinel is un-gated")]
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or not isinstance(doc.get("goldens"), dict):
            raise ValueError("not a goldens doc (missing 'goldens' map)")
    except (OSError, ValueError) as e:
        return [Finding(id=make_id("RETRACE.GOLDENS", "unreadable"), check="RETRACE.GOLDENS",
                        family="retrace", message=f"canary goldens unreadable: {e}")]
    if (doc.get("version") != GOLDENS_VERSION
            or doc.get("digest_version") != digest_mod.DIGEST_VERSION):
        return [Finding(id=make_id("RETRACE.GOLDENS", "version"), check="RETRACE.GOLDENS",
                        family="retrace",
                        message=f"canary goldens carry version {doc.get('version')}/digest "
                                f"{doc.get('digest_version')}, the port wants "
                                f"{GOLDENS_VERSION}/{digest_mod.DIGEST_VERSION}")]
    expected, committed = expected_goldens_coords(), set(doc["goldens"])
    findings = [Finding(id=make_id("RETRACE.GOLDENS", "uncovered", c), check="RETRACE.GOLDENS",
                        family="retrace",
                        message=f"canonical-workload coordinate {c} has no committed golden")
                for c in sorted(expected - committed)]
    findings += [Finding(id=make_id("RETRACE.GOLDENS", "stale", c), check="RETRACE.GOLDENS",
                         family="retrace",
                         message=f"committed golden coordinate {c} is not made by the "
                                 f"canonical workload under the goldens config")
                 for c in sorted(committed - expected)]
    return findings


def _scan_files(repo_root: str) -> Iterable[str]:
    for root in SCAN_ROOTS:
        base = os.path.join(repo_root, root)
        if os.path.isfile(base):
            yield base
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def analyze_retrace(repo_root: str, *, surface_baseline: Optional[str] = None) -> List[Finding]:
    """The static half end to end. The census, goldens and staleness parts
    run against the real repo only (a fixture tree without the port's
    analyzer gets the compile-site check alone)."""
    parsed: List[Tuple[str, ast.Module]] = []
    findings: List[Finding] = []
    for path in _scan_files(repo_root):
        rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
        try:
            with open(path, "r", encoding="utf-8") as f:
                parsed.append((rel, ast.parse(f.read(), filename=path)))
        except (OSError, SyntaxError) as e:
            findings.append(Finding(id=make_id("RETRACE.PARSE", rel), check="RETRACE.PARSE",
                                    family="retrace", message=f"could not parse: {e}",
                                    file=rel))
    real = os.path.exists(os.path.join(repo_root, "maskclustering_tpu_torch", "analysis",
                                       "retrace.py"))
    site_findings = check_compile_sites(parsed)
    if not real:
        site_findings = [f for f in site_findings if ":stale:" not in f.id]
    findings += site_findings
    if not real:
        return findings
    findings += check_goldens(repo_root)
    path = surface_baseline or os.path.join(repo_root, DEFAULT_SURFACE_BASELINE)
    try:
        baseline = load_surface_baseline(path)
    except (ValueError, OSError) as e:
        return findings + [Finding(id=make_id("RETRACE.SURFACE", "baseline", "unreadable"),
                                   check="RETRACE.SURFACE", family="retrace",
                                   message=f"launch-surface baseline unreadable: {e}")]
    if baseline is None:
        return findings + [Finding(id=make_id("RETRACE.SURFACE", "baseline", "missing"),
                                   check="RETRACE.SURFACE", family="retrace",
                                   message=f"no {DEFAULT_SURFACE_BASELINE}: the launch-surface "
                                           f"ratchet is un-gated; write one with "
                                           f"--write-surface")]
    return findings + check_surface(launch_surface(), baseline, fused_surface_rows())
