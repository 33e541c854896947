"""AST lint engine: rule registry, suppressions, baseline, file walking.

The PyTorch port's copy of the JAX package's lint engine, with its
``[tool.colearn.lint]`` table, its ``lint_baseline.json`` and its
suppression grammar; only the registry differs (it imports this
package's ``rules``).  The engine is deliberately small and
rule-agnostic: a rule is a class with an ``id``, a ``hint`` and a
``check(ctx)`` generator; registering it (via :func:`register`) is all a
new checker needs (~30 lines including the rule body).  Everything cross-cutting lives here:

- per-line ``# colearn: noqa(RULE[,RULE]): reason`` suppressions (bare
  ``# colearn: noqa`` suppresses every rule on that line);
- a checked-in JSON baseline (fingerprints of accepted findings — see
  findings.Finding.fingerprint) subtracted from the report;
- dead-suppression detection (CL000): a noqa comment that suppressed
  nothing is itself a finding, so suppressions cannot rot in place;
- unreasoned-suppression detection (CL022): a live rule-listed noqa
  without a ``: reason`` suffix is itself a finding — every suppression
  must say why (concurrency suppressions should cite a witness-clean
  soak).  Blanket ``# colearn: noqa`` is exempt but CL000 still retires
  it when dead;
- ``[tool.colearn.lint]`` config from pyproject.toml (rule
  enable/disable lists, path excludes, baseline path).

The engine never imports torch or any heavyweight dependency — ``lint``
(``python -m colearn_federated_learning_tpu_torch.cli lint``) must stay a
fast, CPU-only pre-test gate.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import io
import json
import os
import re
import tokenize
from typing import Iterable, Iterator, Optional

from colearn_federated_learning_tpu_torch.analysis.findings import Finding

_NOQA_RE = re.compile(
    r"#\s*colearn:\s*noqa(?:\s*\(\s*(?P<rules>[A-Z]{2}\d{3}"
    r"(?:\s*,\s*[A-Z]{2}\d{3})*)\s*\))?"
    r"(?P<reason>\s*:\s*\S.*)?"
)
_HOT_RE = re.compile(r"#\s*colearn:\s*hot\b")

DEAD_SUPPRESSION_RULE = "CL000"
UNREASONED_SUPPRESSION_RULE = "CL022"
PARSE_ERROR_RULE = "CL999"


# ---------------------------------------------------------------- context --
class FileContext:
    """Everything a rule needs about one source file, parsed once."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # part tuple of the path, e.g. ("colearn_...", "comm", "broker.py")
        self.parts = tuple(self.relpath.split("/"))
        # {lineno: comment text} — real COMMENT tokens only, so a
        # docstring that merely mentions the noqa marker cannot suppress.
        self.comments: dict = {}
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(source).readline):
                if tok.type == tokenize.COMMENT:
                    self.comments[tok.start[0]] = tok.string
        except tokenize.TokenError:
            pass

    def in_dir(self, dirname: str) -> bool:
        """True when the file lives under a directory named ``dirname``
        anywhere on its repo-relative path (``comm``, ``faults``, ...)."""
        return dirname in self.parts[:-1]

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def hot_lines(self) -> set:
        """Line numbers carrying a ``# colearn: hot`` marker (CL006 scope
        extension for host-side per-round/per-step loops)."""
        return {ln for ln, text in self.comments.items()
                if _HOT_RE.search(text)}


# ----------------------------------------------------------------- rules --
class Rule:
    """Base class; subclasses set ``id``/``title``/``hint`` and implement
    ``check``."""

    id: str = ""
    title: str = ""
    hint: str = ""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: FileContext, node: ast.AST, message: str,
                hint: Optional[str] = None) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(rule=self.id, path=ctx.relpath, line=line, col=col,
                       message=message,
                       hint=self.hint if hint is None else hint,
                       line_text=ctx.line_text(line))


_REGISTRY: dict = {}


def register(cls):
    """Class decorator: add a Rule subclass to the global registry."""
    if not cls.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if cls.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {cls.id}")
    _REGISTRY[cls.id] = cls
    return cls


def registered_rules() -> dict:
    """``{rule_id: rule_class}`` — importing analysis.rules populates it."""
    from colearn_federated_learning_tpu_torch.analysis import rules as _rules  # noqa: F401

    return dict(_REGISTRY)


# ----------------------------------------------------------------- config --
@dataclasses.dataclass
class LintConfig:
    enable: Optional[list] = None        # None = every registered rule
    disable: tuple = ()
    exclude: tuple = ()                  # fnmatch patterns on relpath
    baseline: str = "lint_baseline.json"

    @classmethod
    def from_pyproject(cls, root: str) -> "LintConfig":
        """Read ``[tool.colearn.lint]``; silently default when the file or
        table is absent (the linter must run on a bare checkout)."""
        path = os.path.join(root, "pyproject.toml")
        if not os.path.exists(path):
            return cls()
        try:
            import tomllib  # py >= 3.11
        except ImportError:
            try:
                import tomli as tomllib
            except ImportError:
                return cls()
        with open(path, "rb") as f:
            doc = tomllib.load(f)
        table = doc.get("tool", {}).get("colearn", {}).get("lint", {})
        return cls(
            enable=table.get("enable"),
            disable=tuple(table.get("disable", ())),
            exclude=tuple(table.get("exclude", ())),
            baseline=table.get("baseline", "lint_baseline.json"),
        )

    def active_rules(self) -> list:
        rules = registered_rules()
        wanted = self.enable if self.enable is not None else sorted(rules)
        out = []
        for rid in wanted:
            if rid in self.disable:
                continue
            if rid not in rules:
                raise ValueError(
                    f"unknown lint rule {rid!r}; registered: {sorted(rules)}"
                )
            out.append(rules[rid]())
        return out

    def excluded(self, relpath: str) -> bool:
        rel = relpath.replace(os.sep, "/")
        return any(fnmatch.fnmatch(rel, pat) for pat in self.exclude)


# --------------------------------------------------------------- baseline --
def load_baseline(path: str) -> dict:
    """``{fingerprint: accepted count}``; a missing file is an empty
    baseline."""
    if not path or not os.path.exists(path):
        return {}
    with open(path) as f:
        doc = json.load(f)
    entries = doc.get("entries", {})
    return {str(k): int(v) for k, v in entries.items()}

def write_baseline(path: str, findings: Iterable[Finding]) -> dict:
    entries: dict = {}
    meta: dict = {}
    for f in findings:
        fp = f.fingerprint()
        entries[fp] = entries.get(fp, 0) + 1
        meta.setdefault(fp, f"{f.rule} {f.path}: {f.line_text[:60]}")
    doc = {
        "comment": "colearn lint baseline: accepted pre-existing findings; "
                   "regenerate with `colearn lint --write-baseline`",
        "entries": entries,
        "notes": meta,
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return entries


# ----------------------------------------------------------------- result --
@dataclasses.dataclass
class LintResult:
    findings: list                 # unsuppressed, un-baselined (reported)
    suppressed: int = 0            # silenced by an inline noqa marker
    baselined: int = 0             # silenced by the baseline file
    files: int = 0

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0

    def to_dict(self) -> dict:
        counts: dict = {}
        for f in self.findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return {
            "findings": [f.to_dict() for f in self.findings],
            "counts": counts,
            "files": self.files,
            "suppressed": self.suppressed,
            "baselined": self.baselined,
        }


# ----------------------------------------------------------------- engine --
def _iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames
                           if d != "__pycache__" and not d.startswith(".")]
            for name in sorted(filenames):
                if name.endswith(".py"):
                    yield os.path.join(dirpath, name)


class LintEngine:
    """Run the registered rules over files; apply suppressions + baseline."""

    def __init__(self, config: Optional[LintConfig] = None,
                 root: Optional[str] = None,
                 check_dead_suppressions: bool = True):
        self.root = os.path.abspath(root or os.getcwd())
        self.config = config or LintConfig.from_pyproject(self.root)
        self.rules = self.config.active_rules()
        self.check_dead_suppressions = (
            check_dead_suppressions
            and DEAD_SUPPRESSION_RULE not in self.config.disable
        )
        self.check_unreasoned_suppressions = (
            UNREASONED_SUPPRESSION_RULE not in self.config.disable
        )

    # ------------------------------------------------------------------
    def _relpath(self, path: str) -> str:
        ap = os.path.abspath(path)
        if ap.startswith(self.root + os.sep):
            return os.path.relpath(ap, self.root)
        return path

    def _suppressions(self, ctx: FileContext) -> dict:
        """``{lineno: (set(rule_ids) | None, has_reason)}`` — a None rule
        set is a blanket noqa."""
        out: dict = {}
        for lineno, text in ctx.comments.items():
            m = _NOQA_RE.search(text)
            if not m:
                continue
            rules = m.group("rules")
            out[lineno] = (
                None if rules is None else
                {r.strip() for r in rules.split(",")},
                m.group("reason") is not None,
            )
        return out

    def lint_file(self, path: str) -> tuple:
        """(kept findings, suppressed count) for one file."""
        relpath = self._relpath(path)
        with open(path, encoding="utf-8") as f:
            source = f.read()
        try:
            ctx = FileContext(path, relpath, source)
        except SyntaxError as e:
            return ([Finding(rule=PARSE_ERROR_RULE,
                             path=relpath.replace(os.sep, "/"),
                             line=e.lineno or 1, col=(e.offset or 1) - 1,
                             message=f"cannot parse: {e.msg}",
                             line_text=(e.text or "").strip())], 0)
        raw: list = []
        for rule in self.rules:
            raw.extend(rule.check(ctx))
        supp = self._suppressions(ctx)
        used_lines: set = set()
        kept: list = []
        suppressed = 0
        for f in raw:
            entry = supp.get(f.line)
            rules_at = "absent" if entry is None else entry[0]
            if rules_at is None or (rules_at != "absent"
                                    and f.rule in rules_at):
                suppressed += 1
                used_lines.add(f.line)
            else:
                kept.append(f)
        if self.check_dead_suppressions:
            for lineno in sorted(set(supp) - used_lines):
                kept.append(Finding(
                    rule=DEAD_SUPPRESSION_RULE, path=ctx.relpath,
                    line=lineno, col=0,
                    message="dead suppression: this `# colearn: noqa` "
                            "silences nothing",
                    hint="remove the comment (or fix the rule list in "
                         "parentheses)",
                    line_text=ctx.line_text(lineno),
                ))
        if self.check_unreasoned_suppressions:
            for lineno in sorted(used_lines):
                rules_at, has_reason = supp[lineno]
                if rules_at is None or has_reason:
                    continue
                kept.append(Finding(
                    rule=UNREASONED_SUPPRESSION_RULE, path=ctx.relpath,
                    line=lineno, col=0,
                    message="suppression without a reason: append "
                            "`: <why this is safe>` to the noqa",
                    hint="e.g. `# colearn: noqa(CL019): witness-clean "
                         "in chaos --tree-async --lock-witness`",
                    line_text=ctx.line_text(lineno),
                ))
        return kept, suppressed

    def run(self, paths: Iterable[str],
            baseline_path: Optional[str] = None) -> LintResult:
        if baseline_path is None:
            baseline_path = os.path.join(self.root, self.config.baseline)
        budget = dict(load_baseline(baseline_path))
        result = LintResult(findings=[])
        for path in _iter_py_files(paths):
            if self.config.excluded(self._relpath(path)):
                continue
            result.files += 1
            kept, suppressed = self.lint_file(path)
            result.suppressed += suppressed
            for f in kept:
                fp = f.fingerprint()
                if budget.get(fp, 0) > 0:
                    budget[fp] -= 1
                    result.baselined += 1
                else:
                    result.findings.append(f)
        result.findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return result
