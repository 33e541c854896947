"""Render a LintResult for humans (terminal) or machines (JSON/SARIF)."""

from __future__ import annotations

import json

from colearn_federated_learning_tpu_torch.analysis.engine import (
    DEAD_SUPPRESSION_RULE,
    PARSE_ERROR_RULE,
    UNREASONED_SUPPRESSION_RULE,
    LintResult,
    registered_rules,
)


def render_text(result: LintResult) -> str:
    lines = [f.render() for f in result.findings]
    counts = ", ".join(
        f"{rule}={n}" for rule, n in
        sorted(result.to_dict()["counts"].items()))
    tail = (f"{len(result.findings)} finding(s)"
            + (f" [{counts}]" if counts else "")
            + f" in {result.files} file(s)"
            + f"; {result.suppressed} suppressed"
            + f", {result.baselined} baselined")
    if not result.findings:
        return f"colearn lint: clean — {tail}"
    return "\n".join(lines) + f"\n\ncolearn lint: {tail}"


def render_json(result: LintResult) -> str:
    return json.dumps(result.to_dict(), indent=2, sort_keys=True)


# Engine-level pseudo-rules have no Rule class in the registry; SARIF
# still needs a rules-table entry for every result.ruleId it emits.
_PSEUDO_RULE_TITLES = {
    DEAD_SUPPRESSION_RULE: "dead suppression (noqa with nothing to silence)",
    UNREASONED_SUPPRESSION_RULE: "suppression without a reason string",
    PARSE_ERROR_RULE: "file does not parse",
}


def render_sarif(result: LintResult) -> str:
    """SARIF 2.1.0 — one run, one result per finding, a rules table
    covering every emitted ruleId (code-scanning UIs key on it)."""
    titles = {rid: cls.title for rid, cls in registered_rules().items()}
    titles.update(_PSEUDO_RULE_TITLES)
    used = sorted({f.rule for f in result.findings})
    rules = [{
        "id": rid,
        "shortDescription": {"text": titles.get(rid, rid)},
    } for rid in used]
    results = [{
        "ruleId": f.rule,
        "ruleIndex": used.index(f.rule),
        "level": "error",
        "message": {"text": (f.message + (f"  hint: {f.hint}"
                                          if f.hint else ""))},
        "partialFingerprints": {"colearnFingerprint/v1": f.fingerprint()},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.path,
                                     "uriBaseId": "SRCROOT"},
                "region": {"startLine": f.line,
                           "startColumn": f.col + 1,
                           "snippet": {"text": f.line_text}},
            },
        }],
    } for f in result.findings]
    doc = {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "colearn-lint",
                "informationUri":
                    "https://github.com/colearn-tpu/colearn-tpu",
                "rules": rules,
            }},
            "results": results,
            "properties": {
                "files": result.files,
                "suppressed": result.suppressed,
                "baselined": result.baselined,
            },
        }],
    }
    return json.dumps(doc, indent=2, sort_keys=True)
