"""SLO/regression sentinel over committed benchmark + round JSONL.

``results/*.jsonl`` records what the benches measured; until now nothing
*enforced* it — a change could halve rounds/sec and CI would stay green.
The sentinel turns the bench trajectory into a gate: declarative SLO
rules live in ``[tool.colearn.slo]`` in pyproject.toml, each rule
selects rows from a JSONL file, aggregates one field, and bounds the
result.  ``colearn sentinel`` (and the CI step wrapping it) exits
non-zero on any violation and emits a machine-readable verdict.

Rule shape (``[[tool.colearn.slo.rules]]``)::

    id    = "fleet-1m-rounds-per-sec"      # unique, stable
    file  = "results/fleet_bench.jsonl"    # repo-root relative
    where = { bench = "fleet_round", devices = 1000000 }  # row filter
    field = "rounds_per_sec"               # numeric field to aggregate
    agg   = "min"                          # min|max|mean|sum|count
    min   = 0.01                           # floor (and/or ``max`` ceiling)
    allow_missing = false                  # missing file/rows = violation

Only order-independent aggregations are offered — verdicts MUST be
stable under reordered JSONL rows (appending re-runs or merging shards
must not flip a verdict), so there is deliberately no "last"/"first".

Rolling-window rules (``window = N`` in the table) extend the gate from
static bench rows to LIVE round history: the trailing ``window`` rows
are aggregated and compared against the ``baseline`` rows immediately
before them, as a ratio with a tolerance band — e.g. "p99 round time
over the last 5 rounds ≤ 1.5× the prior 20-round median".  Rows are
sorted by ``order_by`` (default ``round``) before windowing, so the
verdict stays reorder-stable like everything else here.

Window rule shape::

    id        = "live-round-time-tail"
    file      = "results/rounds.jsonl"
    field     = "round_time_s"
    window    = 5          # trailing rows under test
    baseline  = 20         # rows immediately before the window
    agg       = "p99"      # p50|p90|p99|median|mean|min|max over window
    baseline_agg = "median"   # same choices; default median
    max_ratio = 1.5        # window_agg / baseline_agg ceiling
    order_by  = "round"    # sort key; default "round"
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional

__all__ = [
    "SloRule",
    "WindowRule",
    "evaluate_slo",
    "load_rules",
    "load_jsonl_rows",
    "render_verdict",
    "rule_from_table",
]

_AGGS = ("min", "max", "mean", "sum", "count")
_WINDOW_AGGS = ("min", "max", "mean", "median", "p50", "p90", "p99")


def _window_agg(values: list, agg: str) -> float:
    if agg == "min":
        return min(values)
    if agg == "max":
        return max(values)
    if agg == "mean":
        return sum(values) / len(values)
    ordered = sorted(values)
    q = {"median": 0.50, "p50": 0.50, "p90": 0.90, "p99": 0.99}[agg]
    idx = min(len(ordered) - 1, int(q * len(ordered)))
    return ordered[max(0, idx)]


class SloRule:
    """One declarative bound on an aggregate of JSONL rows."""

    def __init__(self, id: str, file: str, field: str = "",
                 agg: str = "min", where: Optional[dict] = None,
                 min: Optional[float] = None, max: Optional[float] = None,
                 allow_missing: bool = False):
        if agg not in _AGGS:
            raise ValueError(
                f"slo rule {id!r}: agg {agg!r} not in {_AGGS} "
                "(only order-independent aggregations are allowed)")
        if min is None and max is None:
            raise ValueError(f"slo rule {id!r}: needs min and/or max")
        if agg != "count" and not field:
            raise ValueError(f"slo rule {id!r}: agg {agg!r} needs a field")
        self.id = id
        self.file = file
        self.field = field
        self.agg = agg
        self.where = dict(where or {})
        self.min = min
        self.max = max
        self.allow_missing = allow_missing

    @classmethod
    def from_table(cls, table: dict) -> "SloRule":
        unknown = set(table) - {"id", "file", "field", "agg", "where",
                                "min", "max", "allow_missing"}
        if unknown:
            raise ValueError(
                f"slo rule {table.get('id')!r}: unknown keys "
                f"{sorted(unknown)}")
        return cls(
            id=table["id"], file=table["file"],
            field=table.get("field", ""), agg=table.get("agg", "min"),
            where=table.get("where"), min=table.get("min"),
            max=table.get("max"),
            allow_missing=bool(table.get("allow_missing", False)),
        )

    def matches(self, row: dict) -> bool:
        return all(row.get(k) == v for k, v in self.where.items())

    # -------------------------------------------------------- evaluate --
    def evaluate(self, root: str) -> dict:
        """Verdict dict for this rule against files under ``root``.
        ``ok`` is the only field a gate needs; the rest is diagnosis."""
        out = {"id": self.id, "file": self.file, "agg": self.agg,
               "field": self.field, "min": self.min, "max": self.max,
               "ok": False, "value": None, "rows": 0, "reason": None}
        paths = sorted(glob.glob(os.path.join(root, self.file)))
        if not paths:
            if self.allow_missing:
                out.update(ok=True, reason="missing_allowed")
            else:
                out["reason"] = "file_missing"
            return out
        rows = []
        for path in paths:
            rows.extend(load_jsonl_rows(path))
        rows = [r for r in rows if self.matches(r)]
        out["rows"] = len(rows)
        if not rows:
            if self.allow_missing:
                out.update(ok=True, reason="no_rows_allowed")
            else:
                out["reason"] = "no_matching_rows"
            return out
        if self.agg == "count":
            value = float(len(rows))
        else:
            vals = [float(r[self.field]) for r in rows
                    if isinstance(r.get(self.field), (int, float))]
            if not vals:
                out["reason"] = f"field_missing:{self.field}"
                return out
            if self.agg == "min":
                value = min(vals)
            elif self.agg == "max":
                value = max(vals)
            elif self.agg == "sum":
                value = sum(vals)
            else:
                value = sum(vals) / len(vals)
        out["value"] = value
        if self.min is not None and value < self.min:
            out["reason"] = f"below_min:{value:.6g}<{self.min:.6g}"
            return out
        if self.max is not None and value > self.max:
            out["reason"] = f"above_max:{value:.6g}>{self.max:.6g}"
            return out
        out["ok"] = True
        return out


class WindowRule:
    """Rolling-window anomaly rule: aggregate of the trailing ``window``
    rows vs the ``baseline`` rows immediately before them, bounded as a
    ratio.  Rows sort by ``order_by`` before windowing, so appending
    rows out of order (merged shards, re-runs) cannot flip the verdict."""

    def __init__(self, id: str, file: str, field: str, window: int,
                 baseline: int, agg: str = "p99",
                 baseline_agg: str = "median",
                 max_ratio: Optional[float] = None,
                 min_ratio: Optional[float] = None,
                 order_by: str = "round", where: Optional[dict] = None,
                 allow_missing: bool = False):
        if agg not in _WINDOW_AGGS:
            raise ValueError(
                f"slo rule {id!r}: window agg {agg!r} not in "
                f"{_WINDOW_AGGS}")
        if baseline_agg not in _WINDOW_AGGS:
            raise ValueError(
                f"slo rule {id!r}: baseline_agg {baseline_agg!r} not in "
                f"{_WINDOW_AGGS}")
        if max_ratio is None and min_ratio is None:
            raise ValueError(
                f"slo rule {id!r}: needs max_ratio and/or min_ratio")
        if not field:
            raise ValueError(f"slo rule {id!r}: window rule needs a field")
        if int(window) < 1 or int(baseline) < 1:
            raise ValueError(
                f"slo rule {id!r}: window and baseline must be >= 1")
        self.id = id
        self.file = file
        self.field = field
        self.window = int(window)
        self.baseline = int(baseline)
        self.agg = agg
        self.baseline_agg = baseline_agg
        self.max_ratio = max_ratio
        self.min_ratio = min_ratio
        self.order_by = order_by
        self.where = dict(where or {})
        self.allow_missing = allow_missing

    @classmethod
    def from_table(cls, table: dict) -> "WindowRule":
        unknown = set(table) - {"id", "file", "field", "where", "window",
                                "baseline", "agg", "baseline_agg",
                                "max_ratio", "min_ratio", "order_by",
                                "allow_missing"}
        if unknown:
            raise ValueError(
                f"slo rule {table.get('id')!r}: unknown keys "
                f"{sorted(unknown)}")
        return cls(
            id=table["id"], file=table["file"],
            field=table.get("field", ""),
            window=table["window"],
            baseline=table.get("baseline", table["window"]),
            agg=table.get("agg", "p99"),
            baseline_agg=table.get("baseline_agg", "median"),
            max_ratio=table.get("max_ratio"),
            min_ratio=table.get("min_ratio"),
            order_by=table.get("order_by", "round"),
            where=table.get("where"),
            allow_missing=bool(table.get("allow_missing", False)),
        )

    def matches(self, row: dict) -> bool:
        return all(row.get(k) == v for k, v in self.where.items())

    # -------------------------------------------------------- evaluate --
    def evaluate(self, root: str) -> dict:
        """Verdict dict, same field contract as :meth:`SloRule.evaluate`
        (``min``/``max`` carry the ratio band) plus the window/baseline
        aggregates for diagnosis."""
        out = {"id": self.id, "file": self.file,
               "agg": f"{self.agg}[{self.window}]"
                      f"/{self.baseline_agg}[{self.baseline}]",
               "field": self.field, "min": self.min_ratio,
               "max": self.max_ratio, "ok": False, "value": None,
               "rows": 0, "reason": None,
               "window_value": None, "baseline_value": None}
        paths = sorted(glob.glob(os.path.join(root, self.file)))
        if not paths:
            if self.allow_missing:
                out.update(ok=True, reason="missing_allowed")
            else:
                out["reason"] = "file_missing"
            return out
        rows = []
        for path in paths:
            rows.extend(load_jsonl_rows(path))
        rows = [r for r in rows if self.matches(r)
                and isinstance(r.get(self.field), (int, float))
                and isinstance(r.get(self.order_by), (int, float))]
        out["rows"] = len(rows)
        need = self.window + self.baseline
        if len(rows) < need:
            # Too little history to judge — a short clean run must not
            # fail the gate unless the operator opted into strictness.
            if self.allow_missing:
                out.update(ok=True,
                           reason=f"insufficient_rows:{len(rows)}<{need}")
            else:
                out["reason"] = f"insufficient_rows:{len(rows)}<{need}"
            return out
        # Sort by the order key (ties broken by the field value, so even
        # duplicate keys can't make the verdict depend on file order).
        rows.sort(key=lambda r: (float(r[self.order_by]),
                                 float(r[self.field])))
        vals = [float(r[self.field]) for r in rows]
        trail = vals[-self.window:]
        base = vals[-(self.window + self.baseline):-self.window]
        window_value = _window_agg(trail, self.agg)
        baseline_value = _window_agg(base, self.baseline_agg)
        out["window_value"] = window_value
        out["baseline_value"] = baseline_value
        if baseline_value <= 0:
            # A non-positive baseline makes the ratio meaningless; treat
            # as unjudgeable rather than dividing through zero.
            out["reason"] = f"baseline_not_positive:{baseline_value:.6g}"
            if self.allow_missing:
                out["ok"] = True
            return out
        value = window_value / baseline_value
        out["value"] = value
        if self.max_ratio is not None and value > self.max_ratio:
            out["reason"] = (
                f"above_max_ratio:{value:.6g}>{self.max_ratio:.6g}")
            return out
        if self.min_ratio is not None and value < self.min_ratio:
            out["reason"] = (
                f"below_min_ratio:{value:.6g}<{self.min_ratio:.6g}")
            return out
        out["ok"] = True
        return out


def rule_from_table(table: dict):
    """Dispatch one ``[[tool.colearn.slo.rules]]`` table: the presence
    of ``window`` selects the rolling-window rule, everything else is a
    static :class:`SloRule` exactly as before."""
    if "window" in table:
        return WindowRule.from_table(table)
    return SloRule.from_table(table)


# ---------------------------------------------------------------- loading --
def load_jsonl_rows(path: str) -> list:
    """Decodable dict rows of a JSONL file.  A torn final line is
    tolerated (live round logs are appended by running processes); torn
    interior lines raise — that is corruption, not concurrency."""
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    rows = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            doc = json.loads(line)
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break
            raise ValueError(f"corrupt JSONL at {path}:{i + 1}")
        if isinstance(doc, dict):
            rows.append(doc)
    return rows


def load_rules(root: str) -> list:
    """``[[tool.colearn.slo.rules]]`` from pyproject.toml; ``[]`` when
    the file, parser, or table is absent (sentinel must no-op cleanly on
    a bare checkout)."""
    path = os.path.join(root, "pyproject.toml")
    if not os.path.exists(path):
        return []
    try:
        import tomllib  # py >= 3.11
    except ImportError:
        try:
            import tomli as tomllib
        except ImportError:
            return []
    with open(path, "rb") as f:
        doc = tomllib.load(f)
    tables = doc.get("tool", {}).get("colearn", {}).get(
        "slo", {}).get("rules", [])
    rules = [rule_from_table(t) for t in tables]
    seen = set()
    for r in rules:
        if r.id in seen:
            raise ValueError(f"duplicate slo rule id {r.id!r}")
        seen.add(r.id)
    return rules


# --------------------------------------------------------------- verdicts --
def evaluate_slo(root: str, rules: Optional[list] = None) -> dict:
    """Evaluate every rule; the machine-readable verdict the CI gate
    consumes.  ``ok`` iff every rule passed AND at least one rule exists
    (an empty rule set passing silently would be a fake green)."""
    if rules is None:
        rules = load_rules(root)
    results = [r.evaluate(root) for r in rules]
    violations = [r for r in results if not r["ok"]]
    return {
        "schema": "colearn-slo-verdict-v1",
        "root": os.path.abspath(root),
        "rules": len(results),
        "violations": len(violations),
        "ok": bool(results) and not violations,
        "results": results,
    }


def render_verdict(verdict: dict) -> str:
    lines = []
    for res in verdict.get("results", []):
        mark = "ok " if res["ok"] else "FAIL"
        bound = []
        if res.get("min") is not None:
            bound.append(f">= {res['min']:g}")
        if res.get("max") is not None:
            bound.append(f"<= {res['max']:g}")
        value = ("-" if res.get("value") is None
                 else f"{res['value']:.6g}")
        line = (f"[{mark}] {res['id']}: {res['agg']}"
                f"({res.get('field') or 'rows'}) = {value} "
                f"(want {' and '.join(bound)}, rows={res['rows']})")
        if res.get("reason") and not res["ok"]:
            line += f" — {res['reason']}"
        lines.append(line)
    if not verdict.get("results"):
        lines.append("no SLO rules configured ([[tool.colearn.slo.rules]])")
    lines.append("")
    lines.append("sentinel verdict: "
                 + ("OK" if verdict.get("ok") else "VIOLATION"))
    return "\n".join(lines)
