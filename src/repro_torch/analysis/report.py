"""Reporting spine: findings, baselines, and the run-everything entry point.
The port of ``repro/analysis/report.py``.

A :class:`Finding` is one defect the analyzer can state statically. Its
``key`` -- ``pass:rule:obj`` -- is deliberately *point-free*: the resource pass
evaluates each launch over many geometry points, and all points that trip the
same rule on the same launch fold into one finding (the first point quoted in
the message). That keeps ``baseline.json`` small and stable as the evaluated
space grows.

The baseline is the committed allowlist: every accepted finding is explicit
(key + reason), anything new fails ``--check``. Stale baseline entries
(accepted findings the tree no longer produces) are reported too, so the
allowlist can only shrink deliberately. The port has its own baseline
(``repro_torch/analysis/baseline.json``) and the reference's four passes:
``resources`` (Hopper's limits), ``carry`` (the look-back and ticket contract of
cross-CTA carries), ``jitlint`` (host syncs on the hot paths) and ``style``.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

BASELINE_PATH = pathlib.Path(__file__).with_name("baseline.json")
PASSES = ("resources", "carry", "jitlint", "style")


@dataclasses.dataclass(frozen=True)
class Finding:
    pass_name: str          # resources | carry | jitlint | style
    rule: str               # e.g. smem-overflow, carry-without-ticket, host-sync
    obj: str                # launch site / file:qualname:kind the finding is on
    message: str            # human sentence, may quote the point
    severity: str = "error"  # error | warn
    location: str = ""      # file:line when known

    @property
    def key(self) -> str:
        return f"{self.pass_name}:{self.rule}:{self.obj}"


def merge_findings(findings: list[Finding]) -> list[Finding]:
    """Fold same-key findings into one (first message wins, count appended)."""
    by_key: dict[str, list[Finding]] = {}
    for f in findings:
        by_key.setdefault(f.key, []).append(f)
    out = []
    for key, group in sorted(by_key.items()):
        f = group[0]
        if len(group) > 1:
            f = dataclasses.replace(
                f, message=f"{f.message} [{len(group)} config points]")
        out.append(f)
    return out


def load_baseline(path: pathlib.Path | None = None) -> dict[str, str]:
    """key -> reason for every accepted finding."""
    p = path or BASELINE_PATH
    if not p.exists():
        return {}
    doc = json.loads(p.read_text())
    return {e["key"]: e.get("reason", "") for e in doc.get("accepted", [])}


def save_baseline(findings: list[Finding], path: pathlib.Path | None = None,
                  reasons: dict[str, str] | None = None) -> None:
    reasons = reasons or {}
    doc = {"accepted": [{"key": f.key,
                         "reason": reasons.get(f.key, f.message)}
                        for f in merge_findings(findings)]}
    (path or BASELINE_PATH).write_text(json.dumps(doc, indent=2) + "\n")


@dataclasses.dataclass
class Report:
    findings: list[Finding]
    new: list[Finding]          # not in baseline -> fail --check
    stale: list[str]            # baseline keys the tree no longer produces
    rows: list[dict] = dataclasses.field(default_factory=list)   # the resource table

    @property
    def clean(self) -> bool:
        return not self.new

    def to_json(self) -> dict:
        return {
            "clean": self.clean,
            "counts": {"total": len(self.findings), "new": len(self.new),
                       "baselined": len(self.findings) - len(self.new),
                       "stale_baseline": len(self.stale)},
            "findings": [dict(dataclasses.asdict(f), key=f.key,
                              baselined=f not in self.new)
                         for f in self.findings],
            "stale_baseline": self.stale,
            "resources": self.rows,
        }

    def render_text(self) -> str:
        lines = []
        for f in self.findings:
            mark = "NEW " if f in self.new else "ok  "
            loc = f" ({f.location})" if f.location else ""
            lines.append(f"{mark}[{f.pass_name}/{f.rule}] {f.obj}{loc}\n"
                         f"      {f.message}")
        for key in self.stale:
            lines.append(f"stale baseline entry (no longer produced): {key}")
        c = self.to_json()["counts"]
        lines.append(f"analysis: {c['total']} finding(s), {c['new']} new, "
                     f"{c['baselined']} baselined, "
                     f"{c['stale_baseline']} stale baseline entr(ies)")
        return "\n".join(lines)


def run_all(passes: tuple[str, ...] = PASSES, baseline_path: pathlib.Path | None = None,
            ptxas=None) -> Report:
    """Run the selected passes and diff against the committed baseline.
    ``ptxas``: the parsed ptxas figures (:func:`resources.ptxas_info`) or None,
    which reads the logs of the built libraries if there are any.

    Imports the passes lazily so the kernel wrappers (which import
    ``analysis.kernelspec``) never pull them in transitively. A baseline entry
    of a pass that did not run is not stale.
    """
    findings: list[Finding] = []
    rows: list[dict] = []
    if "resources" in passes or "carry" in passes:
        from . import space
        specs = space.build_specs()
        if "resources" in passes:
            from . import resources
            if ptxas is None:
                ptxas = resources.ptxas_info()
            findings += resources.analyze(specs, ptxas)
            rows = resources.table(specs, ptxas)
        if "carry" in passes:
            from . import carry
            findings += carry.analyze(specs)
    if "jitlint" in passes or "style" in passes:
        from . import jitlint
        findings += jitlint.analyze(style="style" in passes, discipline="jitlint" in passes)
    findings = merge_findings(findings)
    baseline = load_baseline(baseline_path)
    produced = {f.key for f in findings}
    new = [f for f in findings if f.key not in baseline]
    stale = sorted(k for k in baseline if k not in produced and k.split(":", 1)[0] in passes)
    return Report(findings=findings, new=new, stale=stale, rows=rows)
