"""Per-device fleet health ledger: the straggler-attribution data plane.

The comm planes already *count* failure (``comm.retry_total``,
``fed.clients_evicted``) but the aggregate erases WHO — and the
ROADMAP's buffered-async / CLIP-style pruning item needs exactly the
per-device record: which devices miss deadlines, how often they retry,
what their observed round latency looks like.  This module is that
record.

Durability follows ckpt/wal.py wholesale: one JSONL file per writing
process (``health_<source>.jsonl`` — coordinator, each aggregator, and
fleetsim write disjoint files, so there is no cross-process append
interleaving to reason about), ``fsync`` per flush, torn final line
tolerated on load, torn mid-file raises.  Boundedness comes from
compaction: when the event log outgrows ``max_lines`` the file is
atomically rewritten (tmp + ``os.replace``) as one snapshot line that
the next load replays before any subsequent event deltas.

Latency is kept two ways per device: an EWMA (cheap trend the eviction
heuristics can read) and a stride-thinned sample sketch (the same
deterministic thinning as registry.Histogram) for tail quantiles.

The counterpart of the JAX package's ``telemetry/health.py``: the same
ledger lines, so either package's ``load_health`` merges the other's
files.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from colearn_federated_learning_tpu_torch.telemetry import registry as _metrics

# Event-count fields a ledger line may carry, in render order.
# ``prune`` / ``pump_stall`` are the async-plane feeds (a paused pump and
# a dispatch that burned most of its timeout budget, per device) — old
# ledgers without them load as zeros via ``from_dict``'s defaults.
# ``norm_anomaly`` is the convergence-observatory feed (an update whose
# norm towers over the cohort median — a poisoned or diverging device is
# a health event, same as a straggler); it rides the same
# forward-compatible zero-default path and is deliberately NOT a rendered
# column (`colearn health` output is contract-stable).
# ``rehomed`` is the aggregator-tree failover feed: the device's in-flight
# contribution was re-sent to a sibling aggregator after its assigned one
# died.  It attributes infrastructure faults, not device behavior, so it
# carries ZERO weight in score() and (like norm_anomaly) is not a
# rendered column.
COUNT_FIELDS = ("deadline_miss", "retry", "corrupt_frame", "eviction",
                "secure_dropout", "prune", "pump_stall", "norm_anomaly",
                "rehomed")

_EWMA_ALPHA = 0.2
_MAX_SAMPLES = 256


def _quantile(samples: list, q: float) -> Optional[float]:
    if not samples:
        return None
    ordered = sorted(samples)
    idx = min(len(ordered) - 1, int(q * len(ordered)))
    return ordered[max(0, idx)]


class DeviceHealth:
    """Mutable in-memory record for one device.  ``to_dict`` is the
    JSON snapshot form the ledger compacts to and ``merge`` combines
    records for the same device written by different processes."""

    def __init__(self, device_id: str):
        self.device_id = str(device_id)
        self.counts = {k: 0 for k in COUNT_FIELDS}
        self.rounds = 0
        self.last_round: Optional[int] = None
        self.lat_ewma: Optional[float] = None
        self.lat_samples: list = []
        self._stride = 1
        self._seen = 0
        self.agg: Optional[str] = None

    # ----------------------------------------------------------- update --
    def apply(self, event: dict) -> None:
        for k in COUNT_FIELDS:
            n = event.get(k)
            if n:
                self.counts[k] += int(n)
        r = event.get("round")
        if r is not None:
            r = int(r)
            if self.last_round is None or r > self.last_round:
                self.last_round = r
            self.rounds += 1
        if event.get("agg") is not None:
            self.agg = str(event["agg"])
        lat = event.get("latency_s")
        if lat is not None:
            self._observe(float(lat))

    def _observe(self, lat: float) -> None:
        self.lat_ewma = lat if self.lat_ewma is None else (
            _EWMA_ALPHA * lat + (1.0 - _EWMA_ALPHA) * self.lat_ewma)
        if self._seen % self._stride == 0:
            self.lat_samples.append(lat)
            if len(self.lat_samples) >= _MAX_SAMPLES:
                self.lat_samples = self.lat_samples[::2]
                self._stride *= 2
        self._seen += 1

    # -------------------------------------------------------- summaries --
    def score(self) -> float:
        """Offender ranking: weighted failure count.  Evictions are the
        terminal symptom, deadline misses the leading one; retries are
        the cheapest noise.  Async-plane feeds slot in between: a prune
        is a predicted dropout (nearly an eviction), a pump stall a
        near-miss of the dispatch timeout."""
        c = self.counts
        return (5.0 * c["eviction"] + 3.0 * c["deadline_miss"]
                + 3.0 * c["prune"] + 3.0 * c["norm_anomaly"]
                + 2.0 * c["corrupt_frame"] + 2.0 * c["secure_dropout"]
                + 1.0 * c["retry"] + 1.0 * c["pump_stall"])

    def to_dict(self) -> dict:
        out: dict = {"device_id": self.device_id, "rounds": self.rounds}
        out.update({k: v for k, v in self.counts.items() if v})
        if self.last_round is not None:
            out["last_round"] = self.last_round
        if self.lat_ewma is not None:
            out["lat_ewma"] = self.lat_ewma
        if self.lat_samples:
            out["lat_samples"] = [round(s, 6) for s in self.lat_samples]
        if self.agg is not None:
            out["agg"] = self.agg
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "DeviceHealth":
        dev = cls(str(d.get("device_id", "")))
        for k in COUNT_FIELDS:
            dev.counts[k] = int(d.get(k, 0))
        dev.rounds = int(d.get("rounds", 0))
        dev.last_round = d.get("last_round")
        dev.lat_ewma = d.get("lat_ewma")
        dev.lat_samples = [float(s) for s in d.get("lat_samples", [])]
        dev._seen = len(dev.lat_samples)
        if d.get("agg") is not None:
            dev.agg = str(d["agg"])
        return dev

    def merge(self, other: "DeviceHealth") -> None:
        """Fold another process's record for the same device into this
        one — counts sum, latency EWMAs average weighted by rounds seen,
        sample sketches concatenate under the same bound."""
        for k in COUNT_FIELDS:
            self.counts[k] += other.counts[k]
        if other.last_round is not None and (
                self.last_round is None
                or other.last_round > self.last_round):
            self.last_round = other.last_round
        if other.lat_ewma is not None:
            if self.lat_ewma is None:
                self.lat_ewma = other.lat_ewma
            else:
                w_a = max(1, self.rounds)
                w_b = max(1, other.rounds)
                self.lat_ewma = (
                    (w_a * self.lat_ewma + w_b * other.lat_ewma)
                    / (w_a + w_b))
        self.rounds += other.rounds
        self.lat_samples = (self.lat_samples
                            + other.lat_samples)[-_MAX_SAMPLES:]
        if other.agg is not None:
            self.agg = other.agg


class HealthLedger:
    """Bounded durable per-device ledger for ONE writing process.

    ``record`` accumulates in memory and buffers the event line;
    ``flush`` appends all buffered lines and fsyncs once — call it at
    round granularity so a SIGKILL loses at most the in-flight round.
    """

    def __init__(self, directory: str, source: str,
                 max_lines: int = 4096):
        os.makedirs(directory, exist_ok=True)
        self.source = str(source)
        self.path = os.path.join(directory, f"health_{self.source}.jsonl")
        self._max_lines = int(max_lines)
        self._f = None
        self._pending: list = []
        self._lines = 0
        self._devices: dict[str, DeviceHealth] = {}
        for entry in _load_entries(self.path):
            self._lines += 1
            self._replay(entry)

    # ----------------------------------------------------------- write --
    def record(self, device_id: str, *, round: Optional[int] = None,
               latency_s: Optional[float] = None,
               agg: Optional[str] = None, **counts) -> None:
        """Note one device observation.  ``counts`` are increments over
        COUNT_FIELDS (``retry=2``, ``eviction=1``); unknown fields
        raise so feed-site typos cannot silently drop attribution."""
        unknown = set(counts) - set(COUNT_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown health fields {sorted(unknown)!r}; "
                f"expected {COUNT_FIELDS}")
        event: dict = {"d": str(device_id)}
        if round is not None:
            event["round"] = int(round)
        if latency_s is not None:
            event["latency_s"] = float(latency_s)
        if agg is not None:
            event["agg"] = str(agg)
        event.update({k: int(v) for k, v in counts.items() if v})
        self._pending.append(event)
        self._apply_event(event)

    def flush(self) -> None:
        """Durably append every buffered event (single fsync), then
        compact if the log outgrew its bound."""
        if not self._pending:
            return
        f = self._handle()
        for event in self._pending:
            f.write(json.dumps(event, separators=(",", ":")) + "\n")
        f.flush()
        os.fsync(f.fileno())
        _metrics.get_registry().counter(
            "health.ledger_appends_total").inc(len(self._pending))
        self._lines += len(self._pending)
        self._pending.clear()
        if self._lines > self._max_lines:
            self._compact()

    def _compact(self) -> None:
        """Atomically rewrite the log as one snapshot line — the bound
        that keeps a long-lived federation's ledger O(devices), not
        O(events)."""
        snap = {"snapshot": [dev.to_dict()
                             for _, dev in sorted(self._devices.items())],
                "source": self.source}
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps(snap, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self.close()
        os.replace(tmp, self.path)
        self._lines = 1
        _metrics.get_registry().counter(
            "health.ledger_compactions_total").inc()

    def _handle(self):
        if self._f is None:
            self._f = open(self.path, "a", encoding="utf-8")
        return self._f

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    # ------------------------------------------------------------ read --
    def _replay(self, entry: dict) -> None:
        if "snapshot" in entry:
            self._devices = {
                str(d.get("device_id", "")): DeviceHealth.from_dict(d)
                for d in entry["snapshot"]}
            return
        self._apply_event(entry)

    def _apply_event(self, event: dict) -> None:
        did = str(event.get("d", ""))
        if not did:
            return
        dev = self._devices.get(did)
        if dev is None:
            dev = self._devices[did] = DeviceHealth(did)
        dev.apply(event)

    def devices(self) -> dict:
        """``device_id -> DeviceHealth`` (includes un-flushed events)."""
        return dict(self._devices)


# ------------------------------------------------------------- loading --
def _load_entries(path: str) -> list:
    """Decodable JSONL entries; torn final line dropped (the flush that
    was in flight when the process died), torn mid-file raises."""
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    out: list = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break
            raise ValueError(f"corrupt health ledger at {path}:{i + 1}")
    return out


def load_health(directory: str) -> dict:
    """Merge every ``health_*.jsonl`` under ``directory`` (recursive —
    procsoak scatters per-role workdirs) into one
    ``device_id -> DeviceHealth`` view."""
    merged: dict[str, DeviceHealth] = {}
    if not os.path.isdir(directory):
        return merged
    for root, _, files in os.walk(directory):
        for fname in sorted(files):
            if not (fname.startswith("health_")
                    and fname.endswith(".jsonl")):
                continue
            local: dict[str, DeviceHealth] = {}
            for entry in _load_entries(os.path.join(root, fname)):
                if "snapshot" in entry:
                    local = {
                        str(d.get("device_id", "")):
                            DeviceHealth.from_dict(d)
                        for d in entry["snapshot"]}
                    continue
                did = str(entry.get("d", ""))
                if not did:
                    continue
                dev = local.get(did)
                if dev is None:
                    dev = local[did] = DeviceHealth(did)
                dev.apply(entry)
            for did, dev in local.items():
                if did in merged:
                    merged[did].merge(dev)
                else:
                    merged[did] = dev
    return merged


# --------------------------------------------------------------- feeds --
def feed_transport_retries(ledger: HealthLedger, seen: dict,
                           registry=None) -> None:
    """Attribute the transport's labeled retry counters
    (``comm.retry_total{device=...}``) to devices: record the delta since
    the last call (``seen`` carries the per-device high-water marks).
    Peers that are not devices — aggregators (``agg:N``), raw
    ``host:port`` idents — are skipped."""
    reg = registry if registry is not None else _metrics.get_registry()
    prefix = "comm.retry_total{device="
    for name, v in reg.snapshot().items():
        if not (name.startswith(prefix) and name.endswith("}")):
            continue
        did = name[len(prefix):-1]
        if ":" in did or not did:
            continue
        delta = float(v) - seen.get(did, 0.0)
        seen[did] = float(v)
        if delta > 0:
            ledger.record(did, retry=int(delta))


# ----------------------------------------------------------- reporting --
def render_health(devices: dict, top: int = 10) -> str:
    """``colearn health`` body: top offenders, fleet straggler tail,
    per-aggregator slice skew.  Pure function over :func:`load_health`
    output."""
    lines = ["colearn health — per-device fleet ledger", ""]
    if not devices:
        lines.append("no health records found")
        return "\n".join(lines)
    lines.append(f"devices tracked     {len(devices):>8}")
    lines.append("")
    ranked = sorted(devices.values(),
                    key=lambda d: (-d.score(), -(d.lat_ewma or 0.0),
                                   d.device_id))
    lines.append("top offenders (score = 5*evict + 3*miss + 3*prune "
                 "+ 2*corrupt + 2*dropout + retry + stall)")
    lines.append("  device   score  miss retry corrupt evict dropout"
                 " prune stall   lat ewma")
    for dev in ranked[:top]:
        c = dev.counts
        ewma = f"{dev.lat_ewma:.3f}s" if dev.lat_ewma is not None else "-"
        lines.append(
            f"  {dev.device_id:<8} {dev.score():>5.0f} {c['deadline_miss']:>5}"
            f" {c['retry']:>5} {c['corrupt_frame']:>7} {c['eviction']:>5}"
            f" {c['secure_dropout']:>7} {c['prune']:>5} {c['pump_stall']:>5}"
            f" {ewma:>10}")
    all_samples: list = []
    for dev in devices.values():
        all_samples.extend(dev.lat_samples)
    if all_samples:
        lines.append("")
        lines.append(
            "straggler tail      "
            f"p50 {_quantile(all_samples, 0.50):.3f}s   "
            f"p90 {_quantile(all_samples, 0.90):.3f}s   "
            f"p99 {_quantile(all_samples, 0.99):.3f}s")
    by_agg: dict[str, list] = {}
    for dev in devices.values():
        if dev.agg is not None and dev.lat_samples:
            by_agg.setdefault(dev.agg, []).extend(dev.lat_samples)
    if len(by_agg) > 1:
        lines.append("")
        lines.append("per-aggregator slice skew")
        means = {}
        for agg_id in sorted(by_agg):
            samples = by_agg[agg_id]
            means[agg_id] = sum(samples) / len(samples)
            lines.append(
                f"  agg {agg_id:<4} mean {means[agg_id]:.3f}s"
                f"   p90 {_quantile(samples, 0.90):.3f}s"
                f"   n {len(samples)}")
        lo = min(means.values())
        if lo > 0:
            lines.append(f"  skew (max/min mean) {max(means.values()) / lo:.2f}x")
    return "\n".join(lines)


def export_gauges(devices: dict, registry=None, top: int = 16) -> None:
    """Surface the ledger as labeled gauges so the Prometheus endpoint
    shows attribution without a file read.  Bounded to the ``top`` worst
    devices — a 10k-device fleet must not mint 10k gauge children."""
    reg = registry if registry is not None else _metrics.get_registry()
    reg.gauge("health.devices_tracked").set(len(devices))
    ranked = sorted(devices.values(),
                    key=lambda d: (-d.score(), -(d.lat_ewma or 0.0),
                                   d.device_id))
    for dev in ranked[:top]:
        labels = {"device": dev.device_id}
        reg.gauge("health.device_score", labels=labels).set(dev.score())
        if dev.lat_ewma is not None:
            reg.gauge("health.device_latency_ewma_s",
                      labels=labels).set(dev.lat_ewma)


def health_record_keys(devices: dict) -> dict:
    """Round-record summary (``health_*`` keys) — stamped only when the
    plane is enabled, so default records stay byte-identical."""
    out = {"health_devices": len(devices)}
    all_samples: list = []
    worst, worst_score = None, 0.0
    for dev in devices.values():
        all_samples.extend(dev.lat_samples)
        s = dev.score()
        if s > worst_score:
            worst, worst_score = dev.device_id, s
    p99 = _quantile(all_samples, 0.99)
    if p99 is not None:
        out["health_lat_p99_s"] = round(p99, 6)
    if worst is not None:
        out["health_worst_device"] = worst
        out["health_worst_score"] = worst_score
    return out
