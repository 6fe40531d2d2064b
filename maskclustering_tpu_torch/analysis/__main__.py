"""mct-check CLI over the port: run the static families, gate on findings.

::

    python -m maskclustering_tpu_torch.analysis \
        [--baseline maskclustering_tpu_torch/analysis/baseline.json] \
        [--format text|json] [--families ast,concurrency,ir,retrace] \
        [--mesh SxF[xP] ...] [--device cpu] [--events out.jsonl] \
        [--write-baseline PATH] [--write-surface PATH] [--root DIR]

Counterpart of ``python -m maskclustering_tpu.analysis``. Exit codes: 0
clean (every finding suppressed by the baseline), 2 on any unsuppressed
finding, 1 on an analyzer crash or a bad baseline. Stale baseline entries
are advisory (reported, never fatal). The default families are the two
that import no torch (``ast,concurrency``); ``ir`` runs the cost census of
the fused step on ``--device`` (default: the CUDA card) and ``retrace``
the launch-surface census and compile-site scan.

Triage: read the finding's ``file:line`` and fix it, or, for an accepted
trade, add its id to the baseline with a one-line justification.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Dict, List, Optional

from maskclustering_tpu_torch.analysis.findings import (
    DEFAULT_BASELINE,
    Finding,
    load_baseline,
    partition_findings,
    stale_in_scope,
    write_baseline,
)

log = logging.getLogger("maskclustering_tpu_torch")

FAMILIES = ("ast", "concurrency", "ir", "retrace")
DEFAULT_FAMILIES = ("ast", "concurrency")


def repo_root() -> str:
    """The checkout this package lives in."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _render_text(unsuppressed: List[Finding], suppressed: List[Finding],
                 stale: List[str], baseline_path: Optional[str],
                 elapsed_s: float) -> str:
    out = [f"== mct-check: {len(unsuppressed)} finding(s), "
           f"{len(suppressed)} suppressed, {len(stale)} stale "
           f"suppression(s) ({elapsed_s:.1f}s) =="]
    for f in unsuppressed:
        out.append(f"FAIL {f.id}")
        out.append(f"     {f.location}: {f.message}")
    if suppressed:
        out.append(f"-- suppressed by {baseline_path or 'baseline'} --")
        for f in suppressed:
            out.append(f"  ok {f.id}  ({f.location})")
    if stale:
        out.append("-- stale baseline entries (finding no longer fires; "
                   "delete them) --")
        for fid in stale:
            out.append(f"  stale {fid}")
    if not unsuppressed:
        out.append("mct-check: clean")
    return "\n".join(out)


def run_analysis(families: List[str], root: str, *, meshes=None,
                 device: Optional[str] = None) -> List[Finding]:
    """The findings of ``families`` over the tree at ``root``."""
    findings: List[Finding] = []
    if "ast" in families:
        from maskclustering_tpu_torch.analysis.ast_checks import analyze_ast

        findings += analyze_ast(root)
    if "concurrency" in families:
        from maskclustering_tpu_torch.analysis.concurrency import analyze_concurrency

        findings += analyze_concurrency(root)
    if "ir" in families:
        from maskclustering_tpu_torch.analysis.ir_checks import FULL_LATTICE, analyze_ir

        findings += analyze_ir(meshes or FULL_LATTICE, device=device)[0]
    if "retrace" in families:
        from maskclustering_tpu_torch.analysis.retrace import analyze_retrace

        findings += analyze_retrace(root)
    return findings


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m maskclustering_tpu_torch.analysis",
        description="mct-check over the port: AST lint (host syncs, compiled-code purity, "
                    "thread-shared state, bare except) and the concurrency family (thread "
                    "topology, lock order, blocking under locks, signal handlers, joins)")
    p.add_argument("--baseline", default=None,
                   help=f"suppression baseline (default: {DEFAULT_BASELINE} under the root "
                        f"when present)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--families", default=",".join(DEFAULT_FAMILIES),
                   help=f"comma-subset of {{{','.join(FAMILIES)}}} (default "
                        f"{','.join(DEFAULT_FAMILIES)})")
    p.add_argument("--mesh", action="append", default=None, metavar="SxF[xP]",
                   help="fused-step mesh for the ir family (repeatable; default: the "
                        "lattice 1x8, 2x4, 4x2, 8x1, 1x2x4)")
    p.add_argument("--device", default=None,
                   help="torch device of the ir family's census (default: the CUDA card; "
                        "'cpu' for the plain path)")
    p.add_argument("--write-surface", default=None, metavar="PATH",
                   help="write the launch-surface census (retrace family) to PATH and exit")
    p.add_argument("--events", default=None,
                   help="append findings as schema-versioned 'analysis' events to this "
                        "JSONL (render with python -m maskclustering_tpu_torch.obs.report)")
    p.add_argument("--write-baseline", default=None, metavar="PATH",
                   help="write a baseline suppressing every current finding (new entries "
                        "get TODO justifications that a human must replace)")
    p.add_argument("--root", default=None,
                   help="repo root to analyze (default: the checkout of this package)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    root = args.root or repo_root()
    families = [f for f in args.families.split(",") if f]
    unknown = set(families) - set(FAMILIES)
    if unknown:
        p.error(f"unknown families {sorted(unknown)}")
    if args.write_surface:
        from maskclustering_tpu_torch.analysis import retrace

        retrace.write_surface_baseline(args.write_surface, retrace.launch_surface(),
                                       retrace.fused_surface_rows())
        print(f"mct-check: wrote the launch-surface census to {args.write_surface} (audit the "
              f"diff before committing)")
        return 0
    meshes = None
    if args.mesh:
        from maskclustering_tpu_torch.obs.cost import parse_mesh_specs

        try:
            meshes = parse_mesh_specs(args.mesh)
        except ValueError as e:
            p.error(str(e))

    baseline_path = args.baseline
    if baseline_path is None:
        default = os.path.join(root, DEFAULT_BASELINE)
        baseline_path = default if os.path.exists(default) else None
    try:
        baseline = load_baseline(baseline_path)
    except (ValueError, OSError) as e:
        print(f"mct-check: bad baseline: {e}", file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    try:
        findings = run_analysis(families, root, meshes=meshes, device=args.device)
    except Exception:
        log.exception("mct-check: analyzer crashed")
        return 1
    elapsed = time.perf_counter() - t0

    if args.write_baseline:
        write_baseline(args.write_baseline, findings, baseline)
        print(f"mct-check: wrote {len(findings)} suppression(s) to "
              f"{args.write_baseline} (replace any TODO justifications)")

    unsuppressed, suppressed, stale = partition_findings(findings, baseline)
    # a family-filtered run never re-derives the out-of-scope findings
    stale = stale_in_scope(stale, families)

    if args.events:
        from maskclustering_tpu_torch.obs.events import KIND_ANALYSIS, EventSink

        sink = EventSink(args.events)
        for f in findings:
            payload: Dict = f.to_json()
            payload["suppressed"] = f.id in baseline
            if f.id in baseline:
                payload["justification"] = baseline[f.id]
            sink.emit(KIND_ANALYSIS, payload)
        sink.emit(KIND_ANALYSIS, {
            "summary": True, "families": families,
            "findings": len(unsuppressed), "suppressed": len(suppressed),
            "stale": len(stale), "elapsed_s": round(elapsed, 2),
            "clean": not unsuppressed})
        sink.close()

    if args.format == "json":
        print(json.dumps({
            "clean": not unsuppressed,
            "findings": [f.to_json() for f in unsuppressed],
            "suppressed": [f.to_json() for f in suppressed],
            "stale": stale,
            "elapsed_s": round(elapsed, 2),
        }, indent=2))
    else:
        print(_render_text(unsuppressed, suppressed, stale, baseline_path, elapsed))
    return 2 if unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
