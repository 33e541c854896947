"""Dependency-free span tracer for federated rounds (the counterpart of
the JAX package's ``telemetry/tracer.py``; the same spans, the same wire
form, so a trace stitches across processes of both packages).

This tracer answers *where* a round spends its time: nested spans with
monotonic-clock durations and wall-clock anchors, cheap enough to leave
on in production paths.

Design points:

- ``tracer.span("aggregate", round=3)`` is a context manager; nesting is
  tracked per thread, so spans opened inside a fan-out worker thread do
  not accidentally parent onto the coordinator's round span.
- The context manager ALWAYS yields a timed :class:`Span` — even when the
  tracer is disabled — so hot paths can read ``sp.duration_s`` for
  metrics (JSONL phase fields) without a second clock read; only the
  *recording* into the in-memory buffer is gated on ``enabled``.
- Spans carry ``(trace_id, span_id, parent_id)``; ``current_context()``
  exports the active identity for wire propagation and ``span(parent=…)``
  adopts a remote parent, which is how a worker's local-train span
  stitches under the coordinator's round span across processes.
- Cross-process stitching is completed by ``Span.to_dict`` /
  ``Tracer.adopt``: a worker ships its finished spans back in the reply
  metadata and the coordinator adopts them into its own buffer.

Wall-clock (``time.time``) anchors position spans on a shared timeline
across processes on one machine; durations always come from
``time.perf_counter`` so individual spans are immune to clock steps.

Departure: :func:`new_id` mints from a counter space of its own (the
counter's top bit set), so ids minted here never equal those of a JAX
package tracer in the same process — a mixed federation in one process
(a port coordinator over JAX workers, or back) adopts spans with no
colliding ids.  The ids keep JAX's 16-hex-digit form.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator, Optional

SpanContext = tuple[str, str]            # (trace_id, span_id)

_id_counter = itertools.count(1)
_id_lock = threading.Lock()
# The JAX package's ids count up from 1 in the low 48 bits; this
# package's keep bit 47 set, a space that counter never reaches.
_ID_SPACE = 1 << 47


def new_id() -> str:
    """Process-unique 64-bit-style hex id (pid-salted so ids minted by a
    coordinator and an in-process loopback worker never collide; see the
    module docstring for the counter space)."""
    with _id_lock:
        n = next(_id_counter)
    n = _ID_SPACE | (n & (_ID_SPACE - 1))
    return f"{os.getpid() & 0xFFFF:04x}{n:012x}"


@dataclass
class Span:
    """One timed operation.  ``t_wall`` anchors the span on the shared
    wall-clock timeline; ``duration_s`` is monotonic-clock elapsed."""

    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    process: str = "main"
    t_wall: float = 0.0                  # epoch seconds at start
    attrs: dict = field(default_factory=dict)
    _t0: float = 0.0                     # perf_counter at start
    _t1: Optional[float] = None          # perf_counter at end

    @property
    def ended(self) -> bool:
        return self._t1 is not None

    @property
    def duration_s(self) -> float:
        return (self._t1 if self._t1 is not None else time.perf_counter()) - self._t0

    @property
    def context(self) -> SpanContext:
        return (self.trace_id, self.span_id)

    def to_dict(self) -> dict:
        """JSON-safe wire form (worker reply metadata / trace files)."""
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "process": self.process,
            "t_wall": self.t_wall,
            "duration_s": self.duration_s,
            "attrs": dict(self.attrs),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        sp = cls(
            name=d["name"], trace_id=d["trace_id"], span_id=d["span_id"],
            parent_id=d.get("parent_id"), process=d.get("process", "main"),
            t_wall=float(d.get("t_wall", 0.0)), attrs=dict(d.get("attrs", {})),
        )
        sp._t0 = 0.0
        sp._t1 = float(d.get("duration_s", 0.0))
        return sp


class Tracer:
    """Per-component span recorder (engine, coordinator, one per worker).

    ``enabled`` gates recording only — ``span()`` always times.  The
    buffer is bounded by ``max_spans``; once full, new spans are dropped
    and counted in ``dropped`` (a trace that silently swallows its own
    overflow would misreport coverage).
    """

    def __init__(self, process: str = "main", enabled: bool = True,
                 max_spans: int = 100_000):
        self.process = process
        self.enabled = enabled
        self.max_spans = max_spans
        self.spans: list[Span] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    # -- per-thread span stack -----------------------------------------
    def _stack(self) -> list[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current_context(self) -> Optional[SpanContext]:
        """(trace_id, span_id) of this thread's innermost open span —
        the identity to inject into outbound messages."""
        stack = self._stack()
        return stack[-1].context if stack else None

    @contextmanager
    def span(self, name: str, parent: Optional[SpanContext] = None,
             **attrs) -> Iterator[Span]:
        """Open a span.  ``parent`` overrides the thread-local nesting
        with an explicit (possibly remote) parent context."""
        stack = self._stack()
        if parent is not None:
            trace_id, parent_id = parent
        elif stack:
            trace_id, parent_id = stack[-1].trace_id, stack[-1].span_id
        else:
            trace_id, parent_id = new_id(), None
        sp = Span(name=name, trace_id=trace_id, span_id=new_id(),
                  parent_id=parent_id, process=self.process,
                  t_wall=time.time(), attrs=attrs)
        sp._t0 = time.perf_counter()
        stack.append(sp)
        try:
            yield sp
        finally:
            sp._t1 = time.perf_counter()
            stack.pop()
            self._record(sp)

    def _record(self, sp: Span) -> None:
        sink = getattr(self._local, "capture", None)
        if sink is not None:
            sink.append(sp)
        if not self.enabled:
            return
        with self._lock:
            if len(self.spans) < self.max_spans:
                self.spans.append(sp)
            else:
                self.dropped += 1

    @contextmanager
    def capture(self) -> Iterator[list[Span]]:
        """Additionally collect every span FINISHED on this thread while
        active — how a worker gathers the spans of one request to ship
        them back to the coordinator, without draining the shared
        buffer under concurrent requests."""
        prev = getattr(self._local, "capture", None)
        captured: list[Span] = []
        self._local.capture = captured
        try:
            yield captured
        finally:
            self._local.capture = prev

    # -- cross-process stitching ---------------------------------------
    def adopt(self, span_dicts: list, process: Optional[str] = None) -> int:
        """Ingest remote spans (``Span.to_dict`` forms) into this buffer;
        returns how many were adopted.  Malformed entries are skipped —
        a peer must not be able to kill the coordinator's trace."""
        adopted = 0
        for d in span_dicts or []:
            try:
                sp = Span.from_dict(d)
            except (KeyError, TypeError, ValueError):
                continue
            if process is not None:
                sp.process = process
            with self._lock:
                if len(self.spans) < self.max_spans:
                    self.spans.append(sp)
                    adopted += 1
                else:
                    self.dropped += 1
        return adopted

    def snapshot(self) -> list[Span]:
        with self._lock:
            return list(self.spans)

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.dropped = 0


_default_tracer = Tracer(process="main")


def get_tracer() -> Tracer:
    """Process-wide default tracer (components that want isolation — the
    engine, each worker — hold their own instance instead)."""
    return _default_tracer
