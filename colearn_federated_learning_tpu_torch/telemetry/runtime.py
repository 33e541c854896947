"""Live metric export: the host-side half of the JAX package's
``telemetry/runtime.py``.

The span tracer answers *where a round spent its time*; this module
answers the production questions the spans cannot:

- **Is device memory creeping toward OOM?**  :func:`sample_device_memory`
  turns the CUDA caching allocator's counters into live gauges
  (``runtime.hbm_bytes_in_use`` / ``..._limit`` / ``..._peak``).
- **How do I watch it?**  :func:`prometheus_text` renders a registry
  snapshot in Prometheus text exposition format; :class:`MetricsExporter`
  serves it from a stdlib HTTP thread (``/metrics``, plus the raw JSON
  snapshot at ``/snapshot.json`` that the ``top`` command consumes); and
  :class:`EventLog` appends machine-readable JSONL events (round records,
  lifecycle marks) for the push-based half.  :func:`render_top` is the
  ``top`` command's dashboard body.

The renderers, the exporter and the event log are copies of JAX's: the
same registry contents give byte-equal text.  Departures:

- ``sample_device_memory`` reads the card's allocator
  (``torch.cuda.memory_allocated``, ``max_memory_allocated`` and the
  total of ``mem_get_info``) where JAX reads ``device.memory_stats()``.
  Without an initialised card (the CPU) it returns ``{}`` and sets
  nothing, as JAX's does on the CPU.
- JAX's ``CompileTracker``, ``abstract_signature`` and ``compiled_cost``
  have no counterpart: the port compiles no program, so there is no
  compile or recompile to count and no XLA cost analysis.  A round's
  FLOPs come from ``fed/engine.round_cost_analysis`` (``FlopCounterMode``
  and the attention kernels' formula).  :func:`render_top` still renders
  a snapshot's ``telemetry.compile_total`` when it holds one (a JAX
  process's).

Everything here is dependency-free host-side code: no prometheus
client, no agent, no thread unless an exporter is explicitly started.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Optional

from colearn_federated_learning_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    get_registry,
)

__all__ = [
    "EventLog",
    "MetricsExporter",
    "prometheus_text",
    "render_top",
    "sample_device_memory",
]


# ------------------------------------------------------------ HBM gauges --
def sample_device_memory(registry: Optional[MetricsRegistry] = None,
                         device=None) -> dict:
    """Sample the card's allocator into live gauges; returns the stats
    (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``), or ``{}``
    on the CPU.  ``device``: the card to read (a CPU device returns
    ``{}``); ``None`` reads the current card once CUDA is initialised in
    this process, and nothing otherwise.  Cheap host call, safe every
    round."""
    import torch

    if device is None:
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = {
        "bytes_in_use": int(torch.cuda.memory_allocated(device)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
        "bytes_limit": int(torch.cuda.mem_get_info(device)[1]),
    }
    reg = registry if registry is not None else get_registry()
    reg.gauge("runtime.hbm_bytes_in_use").set(stats["bytes_in_use"])
    reg.gauge("runtime.hbm_bytes_limit").set(stats["bytes_limit"])
    reg.gauge("runtime.hbm_peak_bytes_in_use").set(
        stats["peak_bytes_in_use"])
    return stats


# -------------------------------------------------------- Prometheus text --
_LABELED_RE = re.compile(r"^(?P<base>[^{]+)\{(?P<labels>.*)\}$")
_INVALID_CHARS = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    return "colearn_" + _INVALID_CHARS.sub("_", name)


def _prom_labels(label_str: str) -> str:
    pairs = []
    for item in label_str.split(","):
        if not item:
            continue
        k, _, v = item.partition("=")
        v = v.replace("\\", "\\\\").replace('"', '\\"')
        pairs.append(f'{k}="{v}"')
    return "{" + ",".join(pairs) + "}"


def prometheus_text(typed_snapshot: dict) -> str:
    """Render a :meth:`MetricsRegistry.typed_snapshot` in the Prometheus
    text exposition format (version 0.0.4).

    Counters/gauges become single samples; histograms become Prometheus
    summaries (``_count``/``_sum`` + ``{quantile=...}`` lines).  Labeled
    children (``name{k=v}``) share their parent's metric family.  Gauges
    never set stay out of the exposition entirely.
    """
    families: dict = {}
    for name, (kind, value) in sorted(typed_snapshot.items()):
        m = _LABELED_RE.match(name)
        base, labels = (m.group("base"), m.group("labels")) if m else (
            name, None)
        families.setdefault(base, {"kind": kind, "samples": []})
        families[base]["samples"].append((labels, value))
    lines = []
    for base in sorted(families):
        kind = families[base]["kind"]
        pname = _prom_name(base)
        if kind == "histogram":
            lines.append(f"# TYPE {pname} summary")
            for labels, summary in families[base]["samples"]:
                # A labeled child merges its labels into each quantile
                # line and suffixes _count/_sum, sharing the family of
                # the unlabeled aggregate parent.
                extra = ""
                if labels is not None:
                    extra = _prom_labels(labels)[1:-1]  # inner k="v" pairs
                for q, key in (("0.5", "p50"), ("0.9", "p90"),
                               ("0.99", "p99")):
                    if summary.get(key) is not None:
                        qlabels = f'quantile="{q}"' + (
                            f",{extra}" if extra else "")
                        lines.append(
                            f'{pname}{{{qlabels}}} '
                            f'{summary[key]:.10g}')
                suffix = "{" + extra + "}" if extra else ""
                lines.append(f"{pname}_count{suffix} {summary['count']}")
                lines.append(
                    f"{pname}_sum{suffix} {summary['sum']:.10g}")
            continue
        samples = [(labels, value)
                   for labels, value in families[base]["samples"]
                   if value is not None]    # gauges never set are skipped
        if not samples:
            continue                  # no samples, no family header
        lines.append(f"# TYPE {pname} {kind}")
        for labels, value in samples:
            suffix = _prom_labels(labels) if labels is not None else ""
            lines.append(f"{pname}{suffix} {float(value):.10g}")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------- exporter --
class MetricsExporter:
    """Pull-based exporter: a daemon HTTP thread serving the process
    registry.  ``GET /metrics`` → Prometheus text; ``GET /snapshot.json``
    → the raw registry snapshot (what ``colearn top`` renders).

    ``port=0`` binds an ephemeral port (read it back from ``.port`` —
    the CLI announces it on stderr so harnesses can find it).
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None):
        self._registry = registry
        self._host = host
        self._want_port = port
        self._server = None
        self._thread = None

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None else (
            get_registry())

    @property
    def port(self) -> Optional[int]:
        return self._server.server_address[1] if self._server else None

    def start(self) -> "MetricsExporter":
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802  (stdlib handler name)
                reg = exporter._reg()
                if self.path.startswith("/metrics"):
                    body = prometheus_text(reg.typed_snapshot()).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.startswith("/snapshot.json"):
                    body = json.dumps(reg.snapshot()).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                reg.counter("export.scrapes_total").inc()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *log_args):
                pass                   # scrapes must not spam stderr

        self._server = ThreadingHTTPServer((self._host, self._want_port),
                                           Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="metrics-exporter",
            daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            self._thread = None

    def __enter__(self):
        return self.start() if self._server is None else self

    def __exit__(self, *exc):
        self.close()


# -------------------------------------------------------------- EventLog --
class EventLog:
    """Push-based JSONL event stream: one JSON object per line, flushed
    per write so a tail (or a post-crash reader) always sees complete
    recent events.  Events carry ``ts`` (epoch) and ``event`` (type)."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()

    def emit(self, event: str, **payload) -> None:
        doc = {"ts": time.time(), "event": event, **payload}
        line = json.dumps(doc, separators=(",", ":"), default=str) + "\n"
        with self._lock:
            if self._f is None:
                return
            self._f.write(line)
            self._f.flush()
        self._reg_count()

    def _reg_count(self) -> None:
        get_registry().counter("export.events_written_total").inc()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


# ---------------------------------------------------------- `colearn top` --
def render_top(snapshot: dict, prev: Optional[dict] = None,
               interval_s: float = 0.0) -> str:
    """Terminal dashboard body from a registry snapshot (pure function —
    the CLI loops it; tests call it directly).  ``prev`` + ``interval_s``
    turn cumulative counters into per-second rates."""

    def val(name, default=0.0):
        v = snapshot.get(name)
        return default if v is None or isinstance(v, dict) else float(v)

    def rate(name):
        if not prev or interval_s <= 0:
            return None
        return (val(name) - float(prev.get(name) or 0.0)) / interval_s

    lines = ["colearn top — live federation metrics", ""]
    rounds = (val("fed.rounds_total") or val("engine.rounds_total")
              or val("fleetsim.rounds_total"))
    rps = (rate("fed.rounds_total") or rate("engine.rounds_total")
           or rate("fleetsim.rounds_total"))
    lines.append(f"rounds total        {rounds:>12.0f}"
                 + (f"   ({rps:.3f}/s)" if rps is not None else ""))
    rt = snapshot.get("fed.round_time_s") or snapshot.get(
        "engine.round_time_s") or snapshot.get("fleetsim.round_time_s")
    if isinstance(rt, dict) and rt.get("count"):
        lines.append(
            f"round time          p50 {rt.get('p50', 0.0):.3f}s   "
            f"p90 {rt.get('p90', 0.0):.3f}s   max {rt.get('max', 0.0):.3f}s")
    lines.append("")
    lines.append("cohort health")
    for label, name in (("  clients dropped  ", "fed.clients_dropped"),
                        ("  clients evicted  ", "fed.clients_evicted"),
                        ("  quorum skips     ", "fed.rounds_skipped_quorum"),
                        ("  resumes          ", "fed.rounds_resumed_total")):
        lines.append(f"{label}{val(name):>12.0f}")
    lines.append("")
    lines.append("faults / retries")
    for label, name in (("  retries          ", "comm.retry_total"),
                        ("  corrupt frames   ", "comm.corrupt_frames_total"),
                        ("  faults injected  ", "fault.injected_total"),
                        ("  reconnect fails  ",
                         "comm.reconnect_failures_total")):
        lines.append(f"{label}{val(name):>12.0f}")
    # Aggregator tier: shown only when a tree is (or was) enrolled —
    # per-agg rows come from the coordinator-side labeled children
    # (heartbeat age gauge, slice-size gauge, partials-folded counter).
    agg_rows: dict[str, dict] = {}
    for name, v in snapshot.items():
        m = _LABELED_RE.match(name)
        if not m or v is None or isinstance(v, dict):
            continue
        base, labels = m.group("base"), m.group("labels")
        field = {"comm.agg_heartbeat_age_s": "hb_age",
                 "comm.agg_slice_devices": "slice",
                 "comm.agg_partials_folded_total": "partials"}.get(base)
        if field is None:
            continue
        agg = dict(item.partition("=")[::2] for item in labels.split(","))
        agg_id = agg.get("agg")
        if agg_id is None:
            continue
        agg_rows.setdefault(agg_id, {})[field] = float(v)
    failovers = val("comm.agg_failovers_total")
    expired = val("comm.agg_heartbeat_expired_total")
    if agg_rows or failovers or expired:
        lines.append("")
        lines.append("aggregator tier")
        for agg_id in sorted(agg_rows):
            row = agg_rows[agg_id]
            lines.append(
                f"  agg {agg_id:<4} hb age {row.get('hb_age', 0.0):>7.2f}s"
                f"   slice {row.get('slice', 0.0):>4.0f}"
                f"   partials {row.get('partials', 0.0):>6.0f}")
        lines.append(f"  failovers        {failovers:>12.0f}")
        lines.append(f"  heartbeats expired{expired:>11.0f}")
    # Async plane (the staleness observatory): shown only when the
    # buffered-async coordinator — or fleetsim's async mode — exported
    # something; flat sync snapshots keep the classic layout.
    async_aggs = (val("async.aggregations_total")
                  or val("fleetsim.async_aggregations_total"))
    stale = (snapshot.get("async.staleness")
             or snapshot.get("fleetsim.async_staleness"))
    if not (isinstance(stale, dict) and stale.get("count")):
        stale = None
    if async_aggs or stale:
        lines.append("")
        lines.append("async plane")
        aps = (rate("async.aggregations_total")
               or rate("fleetsim.async_aggregations_total"))
        lines.append(f"  aggregations     {async_aggs:>12.0f}"
                     + (f"   ({aps:.3f}/s)" if aps is not None else ""))
        buf_k = (val("async.buffer_target")
                 or val("fleetsim.async_buffer_size"))
        if buf_k:
            lines.append(f"  buffer K         {buf_k:>12.0f}")
        arr_s = val("async.arrival_rate_per_s")
        if arr_s:
            lines.append(f"  arrival rate     {arr_s:>12.3f}/s")
        arr_min = val("fleetsim.async_arrival_rate_per_min")
        if arr_min:
            lines.append(f"  arrival rate     {arr_min:>12.3f}/min")
        discards = (val("async.updates_discarded_stale")
                    or val("fleetsim.async_updates_discarded_total"))
        lines.append(f"  stale discards   {discards:>12.0f}")
        if stale:
            lines.append(
                f"  staleness        p50 {stale.get('p50', 0.0):.1f}   "
                f"p90 {stale.get('p90', 0.0):.1f}   "
                f"p99 {stale.get('p99', 0.0):.1f}")
        mass_f = (val("async.contribution_mass{outcome=folded}")
                  or val("fleetsim.async_contribution_mass"
                         "{outcome=folded}"))
        mass_d = (val("async.contribution_mass{outcome=discarded}")
                  or val("fleetsim.async_contribution_mass"
                         "{outcome=discarded}"))
        if mass_f or mass_d:
            lines.append(f"  mass folded      {mass_f:>12.2f}"
                         f"   discarded {mass_d:.2f}")
        pump_rows = [
            f"{st} {val(f'async.pumps{{state={st}}}'):.0f}"
            for st in ("wait", "train", "retry", "pruned", "evicted")
            if snapshot.get(f"async.pumps{{state={st}}}") is not None]
        if pump_rows:
            lines.append("  pumps            " + "   ".join(pump_rows))
    # Learning plane (the convergence observatory): shown only when a
    # --learn-observe run exported learn.* gauges; default snapshots
    # keep the classic layout.
    upd_norm = snapshot.get("learn.update_norm")
    if upd_norm is not None and not isinstance(upd_norm, dict):
        lines.append("")
        lines.append("learning")
        lines.append(f"  update norm      {float(upd_norm):>12.6f}")
        ewma = val("learn.update_norm_ewma")
        if ewma:
            lines.append(f"  norm ewma        {ewma:>12.6f}")
        step = val("learn.step_size")
        if step:
            lines.append(f"  step size        {step:>12.6f}")
        cos = snapshot.get("learn.cos_prev")
        if cos is not None and not isinstance(cos, dict):
            lines.append(f"  cos(prev update) {float(cos):>12.4f}")
        skew = snapshot.get("learn.cohort_skew")
        if skew is not None and not isinstance(skew, dict):
            lines.append(f"  cohort skew      {float(skew):>12.4f}")
        trend_rows = [
            f"{t} {val(f'learn.trend_total{{trend={t}}}'):.0f}"
            for t in ("warmup", "progress", "plateau", "oscillation",
                      "divergence")
            if snapshot.get(f"learn.trend_total{{trend={t}}}") is not None]
        if trend_rows:
            lines.append("  trends           " + "   ".join(trend_rows))
    compiles = val("telemetry.compile_total")
    recompiles = val("telemetry.recompile_total")
    if compiles or recompiles:
        lines.append("")
        lines.append(f"xla compiles        {compiles:>12.0f}   "
                     f"recompiles {recompiles:.0f}")
    hbm = snapshot.get("runtime.hbm_bytes_in_use")
    if hbm is not None and not isinstance(hbm, dict):
        limit = snapshot.get("runtime.hbm_bytes_limit") or 0.0
        pct = f" ({100.0 * hbm / limit:.1f}%)" if limit else ""
        lines.append("")
        lines.append(f"hbm in use          {hbm / 2**30:>11.3f}G{pct}")
    return "\n".join(lines)
