"""Checkpoint and resume of federated rounds, keyed by round number: the
counterpart of the JAX package's ``ckpt/manager.py``, with its API
(``for_run``, ``save``, ``latest_step``, ``restore``, ``close``; three
steps kept).

JAX writes this checkpoint with orbax, which imports JAX, so the port
keeps its own format and a JAX ``train --checkpoint-dir`` directory does
not resume here (the streaming generations of ``ckpt/streaming.py`` move
both ways).  Each step is one directory, committed atomically: the state
is written into a temporary directory beside it as ``state.npz`` (one
entry per leaf, keyed by the leaf's JAX path, written leaf by leaf, and
a ``__leaves__`` entry listing each leaf's path, shape and dtype, and a
``__meta__`` entry with what the saver records beside the state) with
``history.json``, both fsynced, and the directory is renamed to
``<dir>/<step>``.  A kill mid-save leaves a temporary directory that no
restore reads (the next save removes it) and the previous step intact.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any, Iterator, Optional

import numpy as np

from colearn_federated_learning_tpu_torch.ckpt import streaming
from colearn_federated_learning_tpu_torch.telemetry import registry as _metrics

STATE = "state.npz"
_LEAVES = "__leaves__"
_META = "__meta__"


class RoundCheckpointer:
    """Save/restore (server_state, history) keyed by round number."""

    @classmethod
    def for_run(cls, run_config) -> "RoundCheckpointer":
        """Checkpointer for a RunConfig: the one place the
        checkpoint-dir-required validation lives (engine + coordinator)."""
        if not run_config.checkpoint_dir:
            raise ValueError("config.run.checkpoint_dir is not set")
        return cls(run_config.checkpoint_dir)

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _steps(self) -> list[int]:
        """Committed steps, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def save(self, step: int, server_state: Any, history: list[dict],
             meta: Optional[dict] = None) -> None:
        """Commit ``server_state`` and ``history`` as ``step``; ``meta``,
        a JSON-able dict, is kept beside the leaves (:meth:`step_meta`)."""
        t0 = time.perf_counter()
        for name in os.listdir(self.directory):
            if name.startswith(".tmp-"):       # a killed save's leftovers
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp-")
        try:
            flat = streaming.flatten_state(server_state)
            table = []
            for path, leaf in flat:
                shape, entry, _ = streaming._leaf_meta(leaf)
                table.append({"path": path, "shape": list(shape),
                              "dtype": entry})
            entries = [(_LEAVES, lambda: _json_bytes(table)),
                       (_META, lambda: _json_bytes(meta or {}))] + [
                (path, lambda leaf=leaf, rec=rec: _stored(leaf, rec))
                for (path, leaf), rec in zip(flat, table)]
            with open(os.path.join(tmp, STATE), "wb") as f:
                streaming.write_npz_streaming(f, entries)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp, streaming.HISTORY), "w",
                      encoding="utf-8") as f:
                json.dump(history, f)
                f.flush()
                os.fsync(f.fileno())
            streaming.fsync_dir(tmp)
            final = os.path.join(self.directory, str(int(step)))
            if os.path.isdir(final):           # re-save of a step
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        streaming.fsync_dir(self.directory)
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)
        reg = _metrics.get_registry()
        reg.counter("ckpt.saves_total").inc()
        reg.histogram("ckpt.save_s").observe(time.perf_counter() - t0)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: Optional[int]) -> tuple[int, str]:
        step = self.latest_step() if step is None else step
        path = (os.path.join(self.directory, str(int(step)))
                if step is not None else None)
        if path is None or not os.path.isdir(path):
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return int(step), path

    def restore(self, target_state: Any, step: Optional[int] = None):
        """Restore into the structure of ``target_state``, each leaf on its
        template leaf's device.  Returns ``(server_state, history,
        step)``."""
        step, path = self._step_dir(step)
        t0 = time.perf_counter()
        flat = streaming.flatten_state(target_state)
        out = []
        with np.load(os.path.join(path, STATE)) as z:
            table = json.loads(z[_LEAVES].tobytes())
            if len(flat) != len(table):
                raise ValueError(
                    f"checkpoint step {step} holds {len(table)} leaves; "
                    f"restore template has {len(flat)}")
            for (_, tmpl), rec in zip(flat, table):
                shape = tuple(rec["shape"])
                tshape = streaming._leaf_meta(tmpl)[0]
                if shape != tshape:
                    raise ValueError(
                        f"leaf {rec['path']!r}: saved shape {shape} != "
                        f"template shape {tshape}")
                _, view, _ = streaming._storage(rec["dtype"])
                out.append(streaming._place(tmpl, z[rec["path"]], view))
        with open(os.path.join(path, streaming.HISTORY),
                  encoding="utf-8") as f:
            history = json.load(f)
        reg = _metrics.get_registry()
        reg.counter("ckpt.restores_total").inc()
        reg.histogram("ckpt.restore_s").observe(time.perf_counter() - t0)
        return (streaming.unflatten_state(target_state, iter(out)),
                list(history), step)

    def leaf_table(self, step: Optional[int] = None) -> list[dict]:
        """Each leaf's ``path``, ``shape`` and ``dtype`` entry as a step
        records them (no leaf is read)."""
        _, path = self._step_dir(step)
        with np.load(os.path.join(path, STATE)) as z:
            return json.loads(z[_LEAVES].tobytes())

    def step_meta(self, step: Optional[int] = None) -> dict:
        """The ``meta`` a step was saved with (``{}`` for none)."""
        _, path = self._step_dir(step)
        with np.load(os.path.join(path, STATE)) as z:
            return (json.loads(z[_META].tobytes()) if _META in z.files
                    else {})

    def load_leaves(self, step: Optional[int] = None
                    ) -> Iterator[tuple[str, Any]]:
        """Template-free read of a step, one leaf at a time: ``(path, CPU
        tensor)`` in flatten order."""
        _, path = self._step_dir(step)
        with np.load(os.path.join(path, STATE)) as z:
            for rec in json.loads(z[_LEAVES].tobytes()):
                _, view, _ = streaming._storage(rec["dtype"])
                yield rec["path"], streaming._as_tensor(z[rec["path"]], view)

    def close(self) -> None:
        pass


def _json_bytes(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), np.uint8)


def _stored(leaf, rec: dict) -> np.ndarray:
    """A leaf as ``state.npz`` stores it: its own dtype, bf16 as 16-bit
    words."""
    dtype, _, _ = streaming._storage(rec["dtype"])
    return streaming._host_bytes(leaf).view(dtype).reshape(rec["shape"])
