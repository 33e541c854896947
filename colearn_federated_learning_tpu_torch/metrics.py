"""Structured metrics: JSONL records + throughput counters + TensorBoard
(the counterpart of the JAX package's ``metrics.py``).

One JSONL record per federated round, the headline counters
(``rounds_per_sec``, ``client_samples_per_sec_per_chip``, ``acc@round``)
folded from them, and optionally the scalar metrics mirrored to
TensorBoard event files (``tensorboard_dir``) through
``torch.utils.tensorboard.SummaryWriter`` in place of flax's writer, under
the same tags and steps.  The writer is imported lazily, and the mirror
is a no-op when it cannot be built (no ``tensorboard`` package).
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Optional


class MetricsLogger:
    """Append-only JSONL round log with throughput summarization.

    Every record gets ``ts`` (wall clock) and the experiment ``name``;
    ``summary()`` folds the stream into the headline throughput numbers.
    """

    def __init__(self, path: Optional[str] = None, name: str = "default",
                 stream: Optional[IO] = None,
                 tensorboard_dir: Optional[str] = None):
        if path is not None and stream is not None:
            raise ValueError(
                "pass either path or stream, not both (a path-opened file "
                "would silently shadow the stream)"
            )
        self.name = name
        self.path = path
        self._fh: Optional[IO] = stream
        self._owns_fh = False
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
            self._owns_fh = True
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except Exception:
                self._tb = None
        self.records: list[dict] = []
        self._t_start = time.perf_counter()

    def log(self, record: dict) -> dict:
        rec = dict(record)
        rec.setdefault("name", self.name)
        rec.setdefault("ts", time.time())
        self.records.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
        if self._tb is not None and "round" in rec:
            step = int(rec["round"])
            for k, v in rec.items():
                if isinstance(v, (int, float)) and k not in ("round", "ts"):
                    self._tb.add_scalar(k, v, step)
        return rec

    def summary(self, samples_per_round: float = 0.0, n_chips: int = 1) -> dict:
        rounds = [r for r in self.records if "round" in r]
        elapsed = time.perf_counter() - self._t_start
        out = {
            "name": self.name,
            "rounds": len(rounds),
            "elapsed_s": elapsed,
        }
        timed = [r["round_time_s"] for r in rounds if "round_time_s" in r]
        if timed:
            out["rounds_per_sec"] = len(timed) / sum(timed)
            if samples_per_round:
                out["client_samples_per_sec_per_chip"] = (
                    out["rounds_per_sec"] * samples_per_round / max(n_chips, 1)
                )
        accs = [(r["round"], r["eval_acc"]) for r in rounds if "eval_acc" in r]
        if accs:
            out["final_acc"] = accs[-1][1]
            out["best_acc"] = max(a for _, a in accs)
            out["acc_at_round"] = dict(accs)
        return out

    def flush(self) -> None:
        """Push buffered records to their sinks without closing anything —
        long runs call this to make the JSONL/TensorBoard tail readable
        mid-flight."""
        if self._fh is not None:
            try:
                self._fh.flush()
            except (OSError, ValueError):
                pass                     # sink already closed by its owner
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        """Flush and release OWNED sinks.  An externally-provided stream is
        flushed but NEVER closed — its lifetime belongs to the caller (e.g.
        a test's StringIO, or stdout)."""
        self.flush()
        if self._fh is not None:
            if self._owns_fh:
                self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
