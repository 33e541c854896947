"""Process-wide metrics registry: counters, gauges, histograms.

Spans answer *where the time went* inside one round; the registry holds
the cumulative process counters a production federation is tuned by —
bytes on the wire, dropped clients, dispatch retries, host-to-device
transfer time — with quantile summaries for the distributions.  All
instruments are thread-safe (the comm planes increment from fan-out and
dispatcher threads) and dependency-free.

The counterpart of the JAX package's ``telemetry/registry.py``, with the
same instruments and snapshots.  Its process-wide registry is this
package's own: in a process that holds both packages, each counts into
its own.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Union

from colearn_federated_learning_tpu_torch.analysis import metric_catalog

Number = Union[int, float]

# Opt-in guard for ad-hoc scripts: with COLEARN_METRICS_STRICT=1, a name
# missing from analysis/metric_catalog.py raises at first touch.  The
# default stays permissive (tests register scratch instruments); the
# CL005 lint enforces the catalog on the codebase itself either way.
_STRICT = os.environ.get("COLEARN_METRICS_STRICT", "") not in ("", "0")


def labeled_name(name: str, labels: dict) -> str:
    """Canonical key for a labeled instrument: ``name{k=v,...}`` with
    keys sorted, so the same label set always maps to the same child."""
    items = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{items}}}"


class Counter:
    """Monotonically increasing value (bytes sent, retries, drops)."""

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: Number = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease by {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class _ChildCounter(Counter):
    """Labeled child (``comm.retry_total{device=3}``): every increment
    rolls up into the unlabeled parent, so aggregate readers (the soak
    gate's counter deltas, coordinator round records) keep working while
    snapshots additionally show per-label attribution."""

    def __init__(self, name: str, parent: Counter):
        super().__init__(name)
        self._parent = parent

    def inc(self, n: Number = 1) -> None:
        super().inc(n)
        self._parent.inc(n)


class Gauge:
    """Last-observed value (current cohort size, h2d transfer seconds)."""

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, v: Number) -> None:
        self.value = float(v)


class _ChildGauge(Gauge):
    """Labeled gauge child (``comm.agg_heartbeat_age_s{agg=0}``).  Unlike
    counters there is no meaningful aggregate roll-up — a gauge is
    last-observed, and "last across labels" is noise — so the parent is
    left untouched and exists only to reserve the family name/kind."""




class Histogram:
    """Streaming distribution summary with bounded memory.

    Running count/sum/min/max are exact; quantiles come from a bounded
    sample buffer.  When the buffer fills, it is thinned by keeping every
    other sample and the admission stride doubles — a deterministic
    sketch (no RNG) whose bias is acceptable for the p50/p90/p99 this
    registry reports.
    """

    def __init__(self, name: str, max_samples: int = 8192):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._samples: list[float] = []
        self._max_samples = max_samples
        self._stride = 1
        self._lock = threading.Lock()

    def observe(self, v: Number) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if (self.count - 1) % self._stride == 0:
                self._samples.append(v)
                if len(self._samples) >= self._max_samples:
                    self._samples = self._samples[::2]
                    self._stride *= 2

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            samples = sorted(self._samples)
        if not samples:
            return None
        idx = min(len(samples) - 1, int(q * len(samples)))
        return samples[max(0, idx)]

    def summary(self) -> dict:
        out = {"count": self.count, "sum": self.sum}
        if self.count:
            out.update(
                mean=self.sum / self.count, min=self.min, max=self.max,
                p50=self.quantile(0.50), p90=self.quantile(0.90),
                p99=self.quantile(0.99),
            )
        return out


class _ChildHistogram(Histogram):
    """Labeled histogram child (``comm.agg_fold_time_s{agg=0}``): every
    observation also lands in the unlabeled parent, so aggregate readers
    (render_top's latency lines, SLO gates over the family) keep working
    while the exposition additionally shows per-label quantiles."""

    def __init__(self, name: str, parent: Histogram,
                 max_samples: int = 8192):
        super().__init__(name, max_samples=max_samples)
        self._parent = parent

    def observe(self, v: Number) -> None:
        super().observe(v)
        self._parent.observe(v)


class MetricsRegistry:
    """Named instruments, created on first touch (prometheus-client
    idiom without the dependency).  Asking for an existing name with a
    different instrument kind raises — silent type confusion would
    corrupt both series."""

    def __init__(self):
        self._instruments: dict = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                if _STRICT and not metric_catalog.is_known(name):
                    raise ValueError(
                        f"metric {name!r} is not declared in "
                        "analysis/metric_catalog.py "
                        "(COLEARN_METRICS_STRICT=1)"
                    )
                inst = self._instruments[name] = cls(name, **kw)
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(inst).__name__}, "
                    f"not a {cls.__name__}"
                )
            return inst

    def counter(self, name: str,
                labels: Optional[dict] = None) -> Counter:
        """Without ``labels``, the (aggregate) counter.  With ``labels``,
        the child registered under ``name{k=v,...}`` whose increments
        also roll up into the aggregate (see _ChildCounter)."""
        parent = self._get(name, Counter)
        if not labels:
            return parent
        full = labeled_name(name, labels)
        with self._lock:
            inst = self._instruments.get(full)
            if inst is None:
                inst = self._instruments[full] = _ChildCounter(full, parent)
            elif not isinstance(inst, Counter):
                raise TypeError(
                    f"metric {full!r} is a {type(inst).__name__}, "
                    "not a Counter"
                )
            return inst

    def gauge(self, name: str, labels: Optional[dict] = None) -> Gauge:
        """Without ``labels``, the plain gauge.  With ``labels``, the
        child registered under ``name{k=v,...}``; no aggregate roll-up
        (a last-observed value has no meaningful sum across labels)."""
        parent = self._get(name, Gauge)
        if not labels:
            return parent
        full = labeled_name(name, labels)
        with self._lock:
            inst = self._instruments.get(full)
            if inst is None:
                inst = self._instruments[full] = _ChildGauge(full)
            elif not isinstance(inst, Gauge):
                raise TypeError(
                    f"metric {full!r} is a {type(inst).__name__}, "
                    "not a Gauge"
                )
            return inst

    def histogram(self, name: str, labels: Optional[dict] = None,
                  max_samples: int = 8192) -> Histogram:
        """Without ``labels``, the (aggregate) histogram.  With
        ``labels``, the child registered under ``name{k=v,...}`` whose
        observations also roll up into the aggregate (_ChildHistogram),
        mirroring the labeled-counter contract."""
        parent = self._get(name, Histogram, max_samples=max_samples)
        if not labels:
            return parent
        full = labeled_name(name, labels)
        with self._lock:
            inst = self._instruments.get(full)
            if inst is None:
                inst = self._instruments[full] = _ChildHistogram(
                    full, parent, max_samples=max_samples)
            elif not isinstance(inst, Histogram):
                raise TypeError(
                    f"metric {full!r} is a {type(inst).__name__}, "
                    "not a Histogram"
                )
            return inst

    def snapshot(self) -> dict:
        """Flat JSON-safe dump: counters/gauges map to their value,
        histograms to their summary dict."""
        with self._lock:
            items = list(self._instruments.items())
        out = {}
        for name, inst in items:
            if isinstance(inst, Counter):
                out[name] = inst.value
            elif isinstance(inst, Gauge):
                out[name] = inst.value
            else:
                out[name] = inst.summary()
        return out

    def typed_snapshot(self) -> dict:
        """Like :meth:`snapshot` but each value is ``(kind, value)`` with
        kind in {counter, gauge, histogram} — exposition formats (the
        Prometheus endpoint's ``# TYPE`` lines) need the instrument kind,
        which the flat snapshot erases."""
        with self._lock:
            items = list(self._instruments.items())
        out = {}
        for name, inst in items:
            if isinstance(inst, Counter):
                out[name] = ("counter", inst.value)
            elif isinstance(inst, Gauge):
                out[name] = ("gauge", inst.value)
            else:
                out[name] = ("histogram", inst.summary())
        return out

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every layer increments into; tests that
    need isolation construct their own MetricsRegistry."""
    return _default_registry
