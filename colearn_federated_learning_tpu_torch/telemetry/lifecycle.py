"""Round-scoped telemetry lifecycle: span-trace window + ``torch.profiler``
(the counterpart of the JAX package's ``telemetry/lifecycle.py``).

One object owns BOTH per-round observability mechanisms so they share a
lifecycle (open before the round, settle after it, flush on close, even
on an exception mid-round):

- the span tracer window: with ``RunConfig.trace_dir`` set, spans are
  recorded and written as Chrome-trace JSON; ``trace_rounds`` > 0 limits
  recording to the first N rounds the lifecycle sees (0 = all rounds);
- the profiler window (``RunConfig.profile_dir``):
  :class:`~..utils.profiling.RoundProfiler` over ``torch.profiler``, with
  the card's activity when the learner runs on the card.

``engine.fit`` drives ``before_round``/``after_round``/``end_round``/
``close``; the coordinators use the tracer half only.
"""

from __future__ import annotations

from typing import Optional

from colearn_federated_learning_tpu_torch.telemetry import export, registry
from colearn_federated_learning_tpu_torch.telemetry.tracer import Tracer
from colearn_federated_learning_tpu_torch.utils.profiling import RoundProfiler


class RoundTelemetry:
    """Drive the trace window and the profiler window together.
    ``device``: the learner's device (the card's activity is profiled
    when it is a card)."""

    def __init__(self, run_config, tracer: Tracer, device=None):
        self.tracer = tracer
        self.trace_dir: Optional[str] = getattr(run_config, "trace_dir", None)
        self.trace_rounds: int = getattr(run_config, "trace_rounds", 0) or 0
        self.run_name: str = getattr(run_config, "name", "default")
        self.profiler = RoundProfiler(getattr(run_config, "profile_dir", None),
                                      device=device, name=self.run_name)
        self._first_round: Optional[int] = None
        self._written: Optional[str] = None
        tracer.enabled = bool(self.trace_dir)

    @property
    def profiling(self) -> bool:
        """A profiler window is open — the engine puts up its round
        barrier only while this (or span tracing) is on."""
        return self.profiler.active

    @property
    def tracing(self) -> bool:
        """Spans are being recorded — the engine settles the card inside
        ``client_update`` only while this is on."""
        return self.tracer.enabled

    @property
    def trace_path(self) -> Optional[str]:
        """Where the Chrome-trace JSON lands (None without a trace_dir).
        Valid before the file exists — the CLI reports it up front."""
        if not self.trace_dir:
            return None
        return export.default_trace_path(self.trace_dir, self.run_name)

    def before_round(self, round_idx: int) -> None:
        self.profiler.before_round(round_idx)
        if not self.trace_dir:
            return
        if self._first_round is None:
            self._first_round = round_idx
        if self.trace_rounds:
            in_window = round_idx - self._first_round < self.trace_rounds
            self.tracer.enabled = in_window

    def after_round(self, round_idx: int) -> None:
        """Profiler half — call once the round's device work is settled,
        still inside the round span."""
        self.profiler.after_round(round_idx)

    def end_round(self, round_idx: int) -> None:
        """Trace-window half — call AFTER the round span has closed, so an early flush includes
        the final traced round."""
        if (self.trace_dir and self.trace_rounds
                and self._first_round is not None
                and round_idx - self._first_round == self.trace_rounds - 1):
            # The window just closed: flush now, so a long run yields its
            # trace file without waiting for the final round.
            self.write()

    def write(self) -> Optional[str]:
        if not self.trace_dir:
            return None
        self._written = export.write_tracer(
            self.trace_dir, self.run_name, self.tracer,
            metrics=registry.get_registry().snapshot(),
        )
        return self._written

    def close(self) -> Optional[str]:
        """Settle both windows, even after an exception mid-round: the
        profiler is never left running, and whatever spans were recorded
        reach disk."""
        self.profiler.close()
        if self.trace_dir and (self._written is None or self.tracer.enabled):
            self.write()
        return self._written
