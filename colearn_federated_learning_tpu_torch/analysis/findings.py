"""Finding model for the AST lint engine.

A finding is one rule violation at one source location.  Its baseline
fingerprint deliberately excludes the line NUMBER (hashing the rule id,
the repo-relative path and the stripped source text instead), so a
baselined finding survives unrelated edits above it — the same contract
ruff/flake8 baselines use.
"""

from __future__ import annotations

import dataclasses
import hashlib


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str                 # "CL001"
    path: str                 # repo-relative, forward slashes
    line: int                 # 1-based
    col: int                  # 0-based
    message: str
    hint: str = ""            # fix hint shown by the human reporter
    line_text: str = ""       # stripped source of the offending line

    def fingerprint(self) -> str:
        key = f"{self.rule}:{self.path}:{self.line_text}"
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "col": self.col, "message": self.message, "hint": self.hint,
            "fingerprint": self.fingerprint(),
        }

    def render(self) -> str:
        out = f"{self.path}:{self.line}:{self.col + 1}: {self.rule} {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out
