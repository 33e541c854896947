"""Round-scoped telemetry lifecycle: the span-trace window (the tracer
half of the JAX package's ``telemetry/lifecycle.py``).

With ``RunConfig.trace_dir`` set, spans are recorded and written as
Chrome-trace JSON; ``trace_rounds`` > 0 limits recording to the first N
rounds the lifecycle sees (0 = all rounds).  ``engine.fit`` drives
``before_round``/``end_round``/``close`` (the file is written even on an
exception mid-round).

JAX's lifecycle also drives the ``jax.profiler`` window
(``RunConfig.profile_dir``); that window is ROADMAP.md Queue A item 10b
(``--profile-dir`` through ``torch.profiler``), and the engine refuses
``profile_dir`` until then.
"""

from __future__ import annotations

from typing import Optional

from colearn_federated_learning_tpu_torch.telemetry import export, registry
from colearn_federated_learning_tpu_torch.telemetry.tracer import Tracer


class RoundTelemetry:
    """Drive the span-trace window."""

    def __init__(self, run_config, tracer: Tracer):
        self.tracer = tracer
        self.trace_dir: Optional[str] = getattr(run_config, "trace_dir", None)
        self.trace_rounds: int = getattr(run_config, "trace_rounds", 0) or 0
        self.run_name: str = getattr(run_config, "name", "default")
        self._first_round: Optional[int] = None
        self._written: Optional[str] = None
        tracer.enabled = bool(self.trace_dir)

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
        if not self.trace_dir:
            return
        if self._first_round is None:
            self._first_round = round_idx
        if self.trace_rounds:
            in_window = round_idx - self._first_round < self.trace_rounds
            self.tracer.enabled = in_window

    def end_round(self, round_idx: int) -> None:
        """Call AFTER the round span has closed, so an early flush includes
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
        """Settle the window: whatever spans were recorded reach disk, even
        after an exception mid-round."""
        if self.trace_dir and (self._written is None or self.tracer.enabled):
            self.write()
        return self._written
