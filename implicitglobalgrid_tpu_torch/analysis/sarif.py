"""SARIF 2.1.0 export of an analysis `Report` (``python -m
implicitglobalgrid_tpu_torch.analysis --sarif``; the JAX package's
``analysis/sarif.py``, the same mapping under the tool name `TOOL_NAME`).

SARIF is the interchange format CI systems (GitHub code scanning et al.)
consume to annotate PR diffs with findings.  The mapping is deliberately
small and deterministic (no timestamps, sorted rules, stable ordering), so
a golden-file test can pin the whole artifact:

* one ``run`` with ``tool.driver = igg-lint-torch``; one reporting rule per
  distinct ``analyzer/code`` pair seen in the report;
* one ``result`` per finding — active findings as-is, baselined findings
  with a SARIF ``suppressions`` entry carrying the justification;
* severities: CRITICAL/ERROR → ``error``, WARNING → ``warning``, INFO →
  ``note`` (CRITICAL keeps its name in ``properties.iggSeverity``);
* the repo's refactor-stable fingerprint rides in ``partialFingerprints``
  under ``iggLintFingerprint/v1`` — CI dedups findings across pushes with
  it, the same property the suppression baseline keys on.
"""

from __future__ import annotations

SARIF_VERSION = "2.1.0"
TOOL_NAME = "igg-lint-torch"
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)

_LEVELS = {"CRITICAL": "error", "ERROR": "error", "WARNING": "warning",
           "INFO": "note"}
#: Severity rank for the per-rule default level (a rule spanning
#: severities — e.g. grad-soundness/cotangent-dropper at CRITICAL and
#: WARNING — must advertise its WORST case, independent of finding order).
_SEV_RANK = {"CRITICAL": 3, "ERROR": 2, "WARNING": 1, "INFO": 0}


def _rule_id(finding) -> str:
    return f"{finding.analyzer}/{finding.code}"


def _result(finding, justification: str | None = None) -> dict:
    res = {
        "ruleId": _rule_id(finding),
        "level": _LEVELS[finding.severity],
        "message": {"text": finding.message},
        "partialFingerprints": {
            "iggLintFingerprint/v1": finding.fingerprint
        },
        "properties": {"iggSeverity": finding.severity},
    }
    if finding.path:
        loc = {"artifactLocation": {"uri": finding.path}}
        if finding.line:
            loc["region"] = {"startLine": finding.line}
        res["locations"] = [{"physicalLocation": loc}]
    if finding.symbol:
        res["properties"]["symbol"] = finding.symbol
    if finding.fix_hint:
        res["properties"]["fixHint"] = finding.fix_hint
    if justification is not None:
        res["suppressions"] = [
            {"kind": "external", "justification": justification}
        ]
    return res


def report_to_sarif(report) -> dict:
    """One SARIF 2.1.0 log for a `core.Report` (JSON-ready dict)."""
    pairs = [(f, None) for f in report.findings] + [
        (f, j) for f, j in report.suppressed
    ]
    worst = {}
    for f, _ in pairs:
        rid = _rule_id(f)
        if rid not in worst or _SEV_RANK[f.severity] > _SEV_RANK[
                worst[rid].severity]:
            worst[rid] = f
    rules = {
        rid: {
            "id": rid,
            "shortDescription": {"text": f"{f.analyzer}: {f.code}"},
            "defaultConfiguration": {"level": _LEVELS[f.severity]},
        }
        for rid, f in worst.items()
    }
    results = [_result(f, j) for f, j in pairs]
    results.sort(
        key=lambda r: (r["ruleId"],
                       r["partialFingerprints"]["iggLintFingerprint/v1"])
    )
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": TOOL_NAME,
                        # NOT informationUri: SARIF 2.1.0 requires that to
                        # be an absolute URI, and the doc lives in-repo
                        # (the suite's framework, fingerprints and baseline
                        # workflow, which the port shares)
                        "properties": {"docs": "docs/static-analysis.md"},
                        "rules": [rules[k] for k in sorted(rules)],
                    }
                },
                "results": results,
                "invocations": [
                    {
                        "executionSuccessful": not report.errors,
                        "properties": {
                            "ran": report.ran,
                            "skipped": report.skipped,
                        },
                    }
                ],
            }
        ],
    }
