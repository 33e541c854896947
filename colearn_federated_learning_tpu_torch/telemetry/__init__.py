"""End-to-end round telemetry (the counterpart of the JAX package's
``telemetry/``; see tracer/registry/export/lifecycle/health/arrival).

Public surface:

- :class:`Tracer` / :func:`get_tracer` — nested spans, monotonic timing,
  cross-process trace propagation (``current_context`` + ``adopt``);
- :class:`MetricsRegistry` / :func:`get_registry` — process-wide
  counters, gauges, quantile histograms;
- :mod:`.export` — Chrome-trace/Perfetto JSON writer/loader and the
  ``trace-summary`` text breakdown;
- :class:`RoundTelemetry` — the per-round span-trace window;
- :mod:`.health` — durable per-device health ledger (straggler
  attribution, latency sketches, the ``health`` renderer);
- :mod:`.arrival` — seeded-EWMA arrival-rate estimation (fleet +
  per-device), a verbatim copy of JAX's for the asynchronous plane.

Not ported yet: JAX's ``runtime`` (exporter, event log, XLA cost
analysis), ``convergence`` and ``flight`` — ROADMAP.md Queue A items 10b
and 16.
"""

from colearn_federated_learning_tpu_torch.telemetry.tracer import (  # noqa: F401
    Span,
    SpanContext,
    Tracer,
    get_tracer,
    new_id,
)
from colearn_federated_learning_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from colearn_federated_learning_tpu_torch.telemetry.export import (  # noqa: F401
    default_trace_path,
    load_trace,
    spans_to_chrome,
    summarize_trace,
    trace_spans,
    write_trace,
    write_tracer,
)
from colearn_federated_learning_tpu_torch.telemetry.lifecycle import (  # noqa: F401
    RoundTelemetry,
)
from colearn_federated_learning_tpu_torch.telemetry.health import (  # noqa: F401
    DeviceHealth,
    HealthLedger,
    export_gauges,
    feed_transport_retries,
    health_record_keys,
    load_health,
    render_health,
)
from colearn_federated_learning_tpu_torch.telemetry.arrival import (  # noqa: F401
    ArrivalEstimator,
)
