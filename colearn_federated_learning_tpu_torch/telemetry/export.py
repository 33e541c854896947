"""Trace export: Chrome-trace/Perfetto JSON + human-readable summary.

The on-disk format is the Chrome Trace Event JSON object form —
``{"traceEvents": [...]}`` with complete (``"ph": "X"``) events — which
both ``chrome://tracing`` and https://ui.perfetto.dev open directly.
Span identity (trace/span/parent ids) rides in each event's ``args`` so
a loaded trace round-trips back into span dicts, and a ``metrics`` key
carries the :class:`~..telemetry.registry.MetricsRegistry` snapshot.

The counterpart of the JAX package's ``telemetry/export.py``: the same
file format, clock and units, so a trace written by either package loads
and summarizes in the other.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from colearn_federated_learning_tpu_torch.telemetry.tracer import Span, Tracer

TRACE_VERSION = 1


def spans_to_chrome(spans: list[Span]) -> list[dict]:
    """Span records → Chrome complete events (+ process_name metadata).

    Each distinct span ``process`` label becomes a pid row so coordinator
    and worker timelines render as separate tracks of ONE stitched trace.
    """
    pids: dict[str, int] = {}
    events: list[dict] = []
    for sp in spans:
        label = sp.process or "main"
        if label not in pids:
            pids[label] = len(pids) + 1
            events.append({
                "name": "process_name", "ph": "M", "pid": pids[label],
                "tid": 0, "args": {"name": label},
            })
        events.append({
            "name": sp.name,
            "cat": "colearn",
            "ph": "X",
            "ts": sp.t_wall * 1e6,                 # micros on the wall clock
            "dur": sp.duration_s * 1e6,
            "pid": pids[label],
            "tid": 0,
            "args": {
                **sp.attrs,
                "trace_id": sp.trace_id,
                "span_id": sp.span_id,
                "parent_id": sp.parent_id,
            },
        })
    return events


def write_trace(path: str, spans: list[Span],
                metrics: Optional[dict] = None,
                dropped_spans: int = 0) -> str:
    """Write the Chrome-trace JSON file; returns ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    doc = {
        "traceEvents": spans_to_chrome(spans),
        "displayTimeUnit": "ms",
        "otherData": {
            "format_version": TRACE_VERSION,
            "num_spans": len(spans),
            "dropped_spans": dropped_spans,
        },
    }
    if metrics:
        doc["otherData"]["metrics"] = metrics
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)                  # readers never see a torn file
    return path


def load_trace(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if "traceEvents" not in doc:
        raise ValueError(f"{path}: not a Chrome-trace JSON (no traceEvents)")
    return doc


def trace_spans(doc: dict) -> list[Span]:
    """Reconstruct span records from a loaded trace (the JSON round-trip
    inverse of :func:`spans_to_chrome`)."""
    names = {
        ev["pid"]: ev["args"]["name"]
        for ev in doc["traceEvents"]
        if ev.get("ph") == "M" and ev.get("name") == "process_name"
    }
    spans = []
    for ev in doc["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args", {}))
        spans.append(Span.from_dict({
            "name": ev["name"],
            "trace_id": args.pop("trace_id", ""),
            "span_id": args.pop("span_id", ""),
            "parent_id": args.pop("parent_id", None),
            "process": names.get(ev["pid"], str(ev.get("pid", ""))),
            "t_wall": ev["ts"] / 1e6,
            "duration_s": ev.get("dur", 0.0) / 1e6,
            "attrs": args,
        }))
    return spans


def default_trace_path(trace_dir: str, name: str) -> str:
    return os.path.join(trace_dir, f"{name}_trace.json")


def write_tracer(trace_dir: str, name: str, tracer: Tracer,
                 metrics: Optional[dict] = None) -> str:
    return write_trace(default_trace_path(trace_dir, name),
                       tracer.snapshot(), metrics=metrics,
                       dropped_spans=tracer.dropped)


# ---------------------------------------------------------------- summary ----
def summarize_trace(doc: dict, root: str = "round") -> str:
    """Per-phase time breakdown of a trace, as printable text.

    Phases aggregate by span name; the denominator for the percentage
    column is the total time under ``root`` spans when any exist (so
    phase percentages read as "share of round wall time"), otherwise the
    overall traced extent.

    Fleetsim sweep traces are understood natively: with the default root
    and no ``round`` spans present, the root falls back to
    ``fleet_round``, and the per-chunk ``train_chunk`` children get a
    dispatch-rate line (chunks/s and clients/s at the chunk size carried
    in the ``train_chunks`` span attrs) instead of rendering as one
    opaque block.
    """
    spans = trace_spans(doc)
    if not spans:
        return "(empty trace)"
    by_name: dict[str, list[Span]] = {}
    for sp in spans:
        by_name.setdefault(sp.name, []).append(sp)
    if root == "round" and "round" not in by_name and (
            "fleet_round" in by_name):
        root = "fleet_round"
    if root == "round" and "round" not in by_name and (
            "async.aggregate" in by_name):
        # Buffered-async traces have no sync rounds; percentages read as
        # "share of aggregation wall time" instead.
        root = "async.aggregate"
    roots = by_name.get(root, [])
    if roots:
        denom = sum(sp.duration_s for sp in roots)
        denom_label = f"{len(roots)} {root} span(s)"
    else:
        t0 = min(sp.t_wall for sp in spans)
        t1 = max(sp.t_wall + sp.duration_s for sp in spans)
        denom = t1 - t0
        denom_label = "traced extent"
    denom = max(denom, 1e-12)
    procs = sorted({sp.process for sp in spans})
    lines = [
        f"trace: {len(spans)} spans over {len(procs)} process(es): "
        + ", ".join(procs),
        f"denominator: {denom:.6f} s ({denom_label})",
        "",
        f"{'phase':<28}{'count':>7}{'total_s':>12}{'mean_ms':>12}"
        f"{'max_ms':>12}{'pct':>8}",
    ]
    rows = []
    for phase, group in by_name.items():
        total = sum(sp.duration_s for sp in group)
        durs = [sp.duration_s for sp in group]
        rows.append((total, phase, len(group),
                     total / len(group) * 1e3, max(durs) * 1e3))
    for total, phase, n, mean_ms, max_ms in sorted(rows, reverse=True):
        lines.append(
            f"{phase:<28}{n:>7}{total:>12.4f}{mean_ms:>12.3f}"
            f"{max_ms:>12.3f}{100.0 * total / denom:>7.1f}%"
        )
    # Coverage: share of root-span time accounted for by their direct
    # children — the acceptance number for "spans cover the round".
    if roots:
        root_ids = {sp.span_id for sp in roots}
        child_t = sum(sp.duration_s for sp in spans
                      if sp.parent_id in root_ids)
        lines.append("")
        lines.append(
            f"phase coverage of {root} time: "
            f"{100.0 * min(1.0, child_t / denom):.1f}%"
        )
    # Fleetsim chunked-vmap sweep: dispatch-rate stats for the chunk loop.
    chunks = by_name.get("train_chunk", [])
    if chunks:
        chunk_t = max(sum(sp.duration_s for sp in chunks), 1e-12)
        # Total clients through the loop: the wrapper span carries the
        # per-round cohort in its attrs.
        cohort = sum(int(sp.attrs.get("cohort") or 0)
                     for sp in by_name.get("train_chunks", []))
        lines.append("")
        lines.append(
            f"fleetsim sweep: {len(chunks)} chunk dispatch(es), "
            f"{len(chunks) / chunk_t:.1f} chunks/s "
            f"(mean {chunk_t / len(chunks) * 1e3:.3f} ms/chunk)")
        if cohort:
            lines.append(
                f"fleetsim sweep: {cohort} client(s) at "
                f"{cohort / chunk_t:.0f} clients/s through the chunk loop")
    # Buffered-async runs: the observatory's version-lineage spans.  Each
    # fold_update is parented on its update's dispatch_train context, so
    # "stitched" counts how many folds joined a dispatch→train trace.
    aggs = by_name.get("async.aggregate", [])
    folds = by_name.get("fold_update", [])
    if aggs or folds:
        lines.append("")
        if aggs:
            agg_t = max(sum(sp.duration_s for sp in aggs), 1e-12)
            k_mean = (sum(int(sp.attrs.get("buffer_size") or 0)
                          for sp in aggs) / len(aggs))
            lines.append(
                f"async plane: {len(aggs)} aggregation(s) at "
                f"{len(aggs) / agg_t:.2f} folds/s (K mean {k_mean:.1f})")
        if folds:
            folded = [sp for sp in folds
                      if sp.attrs.get("outcome") == "folded"]
            stitched = sum(1 for sp in folds if sp.parent_id)
            lines.append(
                f"async lineage: {len(folded)} update(s) folded, "
                f"{len(folds) - len(folded)} discarded; "
                f"{stitched}/{len(folds)} stitched to dispatch spans")
            taus = sorted(float(sp.attrs.get("tau") or 0.0)
                          for sp in folded)
            if taus:
                def _q(p: float) -> float:
                    return taus[min(len(taus) - 1, int(p * len(taus)))]

                waits = [float(sp.attrs.get("buffer_wait_s") or 0.0)
                         for sp in folded]
                lines.append(
                    f"async staleness: p50 {_q(0.50):.0f}   "
                    f"p90 {_q(0.90):.0f}   p99 {_q(0.99):.0f}   "
                    f"mean buffer wait "
                    f"{sum(waits) / len(waits) * 1e3:.1f} ms")
    # Convergence observatory: aggregate/apply/server_update spans carry
    # conv_* attrs only when the run folded updates under --learn-observe.
    conv = [sp for spans in by_name.values() for sp in spans
            if sp.attrs.get("conv_update_norm") is not None]
    if conv:
        conv.sort(key=lambda sp: sp.t_wall)
        norms = [float(sp.attrs["conv_update_norm"]) for sp in conv]
        trends = [str(sp.attrs.get("conv_trend") or "") for sp in conv]
        census: dict[str, int] = {}
        for t in trends:
            if t:
                census[t] = census.get(t, 0) + 1
        census_s = " ".join(f"{k}={census[k]}" for k in sorted(census))
        lines.append("")
        lines.append(
            f"learning: {len(conv)} observed fold(s), update norm "
            f"{norms[0]:.3e} -> {norms[-1]:.3e} (max {max(norms):.3e})"
            + (f"; trend {census_s}" if census_s else ""))
    metrics = doc.get("otherData", {}).get("metrics")
    if metrics:
        lines.append("")
        lines.append("metrics:")
        for k in sorted(metrics):
            lines.append(f"  {k}: {json.dumps(metrics[k], sort_keys=True)}")
    return "\n".join(lines)
