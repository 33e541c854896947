"""Crash flight recorder: bounded in-memory forensics, dumped on death (the
counterpart of the JAX package's ``telemetry/flight.py``, in its dump
format, so each package's ``postmortem`` reads the other's dumps).

The process soak (``faults/procsoak.py``) kills real processes with
SIGKILL, which no handler can catch.  So the recorder keeps bounded rings
of recent activity (events, the metric snapshot, the tails of attached
tracers) and a background heartbeat thread rewrites ``flight_<pid>.json``
atomically every few seconds: after a SIGKILL the last heartbeat dump is
the black box, at most one heartbeat stale.  The catchable ends of a
process (SIGTERM, an uncaught exception, a stall the watchdog declares)
also dump at once, with the trigger and the traceback.

``postmortem`` merges a directory of flight dumps with the round WAL: the
last committed round, and what each process was doing when it died.

Every write is atomic (a temporary file, then ``os.replace``): a dump
either parses or does not exist.

Departure from JAX: on SIGTERM the recorder stops its heartbeat before it
writes the ``sigterm`` dump.  The port's ``broker``, ``worker`` and
``aggregator`` exit 0 through their own SIGTERM handler, which this one
chains to, and a heartbeat during that shutdown would overwrite the
trigger; JAX's processes die by the signal at once.  ``close`` also puts
back the SIGTERM handler it replaced.
"""

from __future__ import annotations

import faulthandler
import json
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Optional

from colearn_federated_learning_tpu_torch.telemetry.registry import (
    get_registry)

__all__ = [
    "FlightRecorder",
    "get_flight_recorder",
    "install_flight_recorder",
    "load_flight_dumps",
    "postmortem_report",
    "render_postmortem",
]

SCHEMA = "colearn-flight-v1"
_SPAN_TAIL = 256          # most recent spans kept per attached tracer
_EVENT_RING = 512         # most recent recorded events


class FlightRecorder:
    """Black box for one process.

    ``record(kind, **fields)`` appends to the event ring.
    ``mark_progress()`` feeds the watchdog: if ``watchdog_s`` passes
    without a mark after the first one, the heartbeat thread dumps once
    with ``trigger="watchdog_stall"``.  ``attach_tracer`` registers span
    sources whose recent tails are embedded in every dump.
    """

    def __init__(self, directory: str, role: str = "main",
                 heartbeat_s: float = 5.0,
                 watchdog_s: Optional[float] = None):
        self.directory = directory
        self.role = role
        self.heartbeat_s = heartbeat_s
        self.watchdog_s = watchdog_s
        self.path = os.path.join(directory, f"flight_{os.getpid()}.json")
        self._events: deque = deque(maxlen=_EVENT_RING)
        self._tracers: list = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_progress: Optional[float] = None
        self._stall_dumped = False
        self._prev_sigterm = None
        self._sigterm_installed = False
        self._prev_excepthook = None
        self.dumps = 0
        os.makedirs(directory, exist_ok=True)

    # -- feeding the box ------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        self._events.append({"ts": time.time(), "kind": kind, **fields})

    def mark_progress(self) -> None:
        self._last_progress = time.monotonic()
        self._stall_dumped = False

    def attach_tracer(self, tracer) -> None:
        with self._lock:
            if tracer not in self._tracers:
                self._tracers.append(tracer)

    # -- dumping --------------------------------------------------------
    def _payload(self, trigger: str, exc: Optional[str] = None) -> dict:
        with self._lock:
            tracers = list(self._tracers)
        spans = []
        for tr in tracers:
            try:
                tail = tr.snapshot()[-_SPAN_TAIL:]
            except Exception:   # a broken tracer must not cost the dump
                continue
            spans.extend(sp.to_dict() for sp in tail)
        doc = {
            "schema": SCHEMA,
            "pid": os.getpid(),
            "role": self.role,
            "trigger": trigger,
            "ts": time.time(),
            "argv": list(sys.argv),
            "events": list(self._events),
            "metrics": get_registry().snapshot(),
            "spans": spans,
        }
        if exc is not None:
            doc["exception"] = exc
        return doc

    def dump(self, trigger: str, exc: Optional[str] = None) -> str:
        """Atomically (re)write the flight file; returns its path.  Never
        raises: the recorder must not be the second failure."""
        try:
            doc = self._payload(trigger, exc)
            tmp = f"{self.path}.tmp.{threading.get_ident()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, separators=(",", ":"), default=str)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self.dumps += 1
            get_registry().counter("flight.dumps_total").inc()
        except Exception:       # see the docstring: never the second failure
            pass
        return self.path

    # -- lifecycle ------------------------------------------------------
    def install(self) -> "FlightRecorder":
        """Write the first dump, hook SIGTERM and ``sys.excepthook``, start
        the heartbeat and watchdog thread, and enable faulthandler (a hard
        fault at least leaves a native traceback on stderr)."""
        self.dump("install")
        try:
            faulthandler.enable()
        except (RuntimeError, AttributeError, ValueError):
            pass                       # no usable stderr (daemonized)
        if threading.current_thread() is threading.main_thread():
            try:
                self._prev_sigterm = signal.signal(
                    signal.SIGTERM, self._on_sigterm)
                self._sigterm_installed = True
            except (ValueError, OSError):
                pass
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._on_exception
        self._thread = threading.Thread(
            target=self._heartbeat_loop, name="flight-recorder", daemon=True)
        self._thread.start()
        return self

    def _stop_heartbeat(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=2.0)

    def _on_sigterm(self, signum, frame) -> None:
        self._stop_heartbeat()
        self.dump("sigterm")
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        else:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    def _on_exception(self, etype, value, tb) -> None:
        exc = "".join(traceback.format_exception(etype, value, tb))
        self.dump("fatal_exception", exc=exc)
        hook = self._prev_excepthook or sys.__excepthook__
        hook(etype, value, tb)

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            trigger = "heartbeat"
            if (self.watchdog_s is not None
                    and self._last_progress is not None
                    and not self._stall_dumped
                    and time.monotonic() - self._last_progress
                    > self.watchdog_s):
                trigger = "watchdog_stall"
                self._stall_dumped = True
            self.dump(trigger)

    def close(self, final_trigger: str = "shutdown") -> None:
        self._stop_heartbeat()
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        if (self._sigterm_installed
                and threading.current_thread() is threading.main_thread()):
            signal.signal(signal.SIGTERM, self._prev_sigterm
                          if self._prev_sigterm is not None
                          else signal.SIG_DFL)
            self._sigterm_installed = False
        self.dump(final_trigger)


_recorder: Optional[FlightRecorder] = None


def install_flight_recorder(directory: str, role: str = "main",
                            heartbeat_s: float = 5.0,
                            watchdog_s: Optional[float] = None,
                            ) -> FlightRecorder:
    """Install the process-wide recorder (idempotent per process: a second
    call returns the existing one)."""
    global _recorder
    if _recorder is None:
        _recorder = FlightRecorder(
            directory, role=role, heartbeat_s=heartbeat_s,
            watchdog_s=watchdog_s).install()
    return _recorder


def get_flight_recorder() -> Optional[FlightRecorder]:
    return _recorder


# ------------------------------------------------------------ postmortem --
def load_flight_dumps(directory: str) -> list:
    """Parse every ``flight_*.json`` under ``directory`` (recursive),
    sorted by dump timestamp.  An unparseable file is reported as an
    ``{"error": ..., "path": ...}`` stub, not skipped: a corrupt black box
    is itself a finding."""
    dumps = []
    for root, _dirs, files in os.walk(directory):
        for fn in sorted(files):
            if not (fn.startswith("flight_") and fn.endswith(".json")):
                continue
            path = os.path.join(root, fn)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    doc = json.load(f)
                doc["_path"] = path
                dumps.append(doc)
            except (OSError, ValueError) as e:
                dumps.append({"schema": SCHEMA, "error": str(e),
                              "_path": path})
    dumps.sort(key=lambda d: d.get("ts", 0.0))
    return dumps


def postmortem_report(dumps: list, wal_entries: Optional[list] = None,
                      checkpoint_step: Optional[int] = None) -> dict:
    """Merge flight dumps with round-WAL entries: the last committed
    round, the rounds in flight at death, and per pid what each process
    was doing (trigger, last events, recent spans).

    WAL entries carry no committed flag: commitment is positional (entries
    past the latest checkpoint step are uncommitted).  With
    ``checkpoint_step`` the split is exact; without it every logged round
    counts as committed, and "in flight" means rounds the flight dumps saw
    past the last WAL entry."""
    logged = [e.get("round") for e in (wal_entries or [])
              if e.get("round") is not None]
    if checkpoint_step is not None:
        committed = logged[:checkpoint_step]
        in_flight = logged[checkpoint_step:]
    else:
        committed, in_flight = logged, []
    processes = []
    for d in dumps:
        if "error" in d:
            processes.append({"path": d.get("_path"), "error": d["error"]})
            continue
        spans = d.get("spans", [])
        events = d.get("events", [])
        metrics = d.get("metrics", {})
        rounds_seen = sorted({e.get("round") for e in events
                              if e.get("round") is not None})
        if (checkpoint_step is None and rounds_seen and committed
                and rounds_seen[-1] > committed[-1]):
            for r in rounds_seen:
                if r > committed[-1] and r not in in_flight:
                    in_flight.append(r)
        processes.append({
            "pid": d.get("pid"),
            "role": d.get("role"),
            "trigger": d.get("trigger"),
            "ts": d.get("ts"),
            "exception": d.get("exception"),
            "last_round_seen": rounds_seen[-1] if rounds_seen else None,
            "last_events": events[-5:],
            "last_spans": [s.get("name") for s in spans[-8:]],
            "metrics_of_note": {
                k: v for k, v in metrics.items()
                if isinstance(v, (int, float)) and v
                and any(k.startswith(p) for p in
                        ("fed.", "comm.", "fault.", "flight.",
                         "telemetry."))},
        })
    return {
        "schema": "colearn-postmortem-v1",
        "last_committed_round": committed[-1] if committed else None,
        "committed_rounds": len(committed),
        "rounds_in_flight": sorted(in_flight),
        "process_count": len(processes),
        "crash_triggers": sorted({p.get("trigger") for p in processes
                                  if p.get("trigger")}),
        "processes": processes,
    }


def render_postmortem(report: dict) -> str:
    """Human-readable rendering of :func:`postmortem_report`."""
    lines = ["colearn postmortem", ""]
    lines.append(f"last committed round : "
                 f"{report.get('last_committed_round')}")
    lines.append(f"committed rounds     : {report.get('committed_rounds')}")
    ifl = report.get("rounds_in_flight") or []
    lines.append(f"rounds in flight     : "
                 f"{', '.join(map(str, ifl)) if ifl else '-'}")
    lines.append("")
    for p in report.get("processes", []):
        if "error" in p:
            lines.append(f"  [unparseable] {p.get('path')}: {p['error']}")
            continue
        lines.append(f"  pid {p.get('pid')} ({p.get('role')}) "
                     f"— trigger={p.get('trigger')} "
                     f"last_round={p.get('last_round_seen')}")
        if p.get("exception"):
            first = p["exception"].strip().splitlines()[-1]
            lines.append(f"      exception: {first}")
        if p.get("last_spans"):
            lines.append(
                "      recent spans: " + ", ".join(p["last_spans"]))
    return "\n".join(lines)
