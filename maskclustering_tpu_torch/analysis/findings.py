"""Finding records + the baseline/ratchet policy of the port's mct-check.

Counterpart of ``maskclustering_tpu/analysis/findings.py``.

A finding's ``id`` is STABLE: it is built from the check name plus
content-derived coordinates (file path, enclosing scope, offending token,
per-scope ordinal — never a raw line number), so an unrelated edit above
a finding does not churn the baseline. ``file:line`` is carried separately
for display only.

The baseline (``maskclustering_tpu_torch/analysis/baseline.json``, the
port's own; the JAX package's ``analysis_baseline.json`` is never read or
written here) is the ratchet: every entry
suppresses exactly one finding id and MUST carry a one-line justification
— an accepted trade, not a silenced alarm. A baseline entry whose finding
no longer fires is reported as stale (advisory), so the file only ever
shrinks or is consciously grown.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

BASELINE_VERSION = 1
DEFAULT_BASELINE = "maskclustering_tpu_torch/analysis/baseline.json"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation, stable-id'd and renderable."""

    id: str  # stable: <CHECK>:<content coordinates>, no line numbers
    check: str  # e.g. "IR.DTYPE.CLASS", "AST.HOSTSYNC"
    family: str  # "ast" | "concurrency"
    message: str  # one line, human-oriented
    file: str = ""  # repo-relative path ("" for whole-program IR findings)
    line: int = 0  # 1-based display anchor (0 = not line-anchored)

    @property
    def location(self) -> str:
        if not self.file:
            return "<ir>"
        return f"{self.file}:{self.line}" if self.line else self.file

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def make_id(check: str, *coords: object) -> str:
    """Stable finding id: check name + content coordinates, ':'-joined."""
    return ":".join([check] + [str(c) for c in coords])


def load_baseline(path: Optional[str]) -> Dict[str, str]:
    """id -> justification from a baseline file; {} when absent.

    Raises ValueError on a malformed file or an entry missing its
    justification — a silent bad baseline would un-gate CI.
    """
    if not path or not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"{path}: expected a baseline doc with version={BASELINE_VERSION}")
    out: Dict[str, str] = {}
    for entry in doc.get("suppressions", []):
        fid = entry.get("id")
        why = (entry.get("justification") or "").strip()
        if not fid or not why or why.startswith("TODO"):
            raise ValueError(
                f"{path}: every suppression needs an id AND a one-line "
                f"justification — write_baseline's TODO placeholders must "
                f"be replaced by a human (offending entry: {entry})")
        out[fid] = why
    return out


def write_baseline(path: str, findings: Sequence[Finding],
                   justifications: Optional[Dict[str, str]] = None) -> None:
    """Write a baseline covering ``findings``; keeps known justifications.

    New entries get a ``TODO`` justification that load_baseline REJECTS —
    a freshly written baseline cannot quietly become the gate; a human
    must replace every TODO with the actual accepted trade first.
    """
    justifications = justifications or {}
    doc = {
        "version": BASELINE_VERSION,
        "suppressions": [
            {"id": f.id,
             "justification": justifications.get(
                 f.id, "TODO: justify or fix"),
             "location": f.location,
             "message": f.message}
            for f in sorted(findings, key=lambda f: f.id)
        ],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2)
        fh.write("\n")


def partition_findings(
    findings: Sequence[Finding], baseline: Dict[str, str],
) -> Tuple[List[Finding], List[Finding], List[str]]:
    """(unsuppressed, suppressed, stale baseline ids).

    Unsuppressed findings gate (exit 2); suppressed ones render dimmed;
    stale ids are baseline entries whose finding no longer fires — the
    ratchet's "now delete the suppression" signal.
    """
    live = {f.id for f in findings}
    unsuppressed = [f for f in findings if f.id not in baseline]
    suppressed = [f for f in findings if f.id in baseline]
    stale = sorted(fid for fid in baseline if fid not in live)
    return unsuppressed, suppressed, stale


def stale_in_scope(stale: Sequence[str], families: Sequence[str]) -> List[str]:
    """Restrict stale baseline ids to the families this run covered: a
    family-filtered run (``--families ast``) never re-derives the other
    family's findings, and reporting their suppressions as stale would tell
    the user to delete still-valid entries."""
    out: List[str] = []
    for fid in stale:
        family = ("ast" if fid.startswith("AST.")
                  else "concurrency" if fid.startswith("CONC.") else None)
        if family is not None and family not in families:
            continue
        out.append(fid)
    return out
