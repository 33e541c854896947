"""Runtime lock witness: observed acquisition order and guarded-access
stamps (the counterpart of the JAX package's ``faults/lockwitness.py``,
with its environment names, its per-pid dump and its report's keys, so
the reports of either package's processes merge and compare).

It costs nothing when off: the :func:`lock` / :func:`condition` /
:func:`guarded` factories return plain ``threading`` primitives and the
bare object unless the ``COLEARN_LOCK_WITNESS`` environment variable is
truthy, so the constructors call them unconditionally.

When on:

- every witnessed lock keeps a per-thread held stack; acquiring B while
  holding A adds the edge ``A -> B`` to a process-global graph, and an
  acquisition whose edge closes a path back to a lock already held is
  recorded as an **inversion** (a deadlock's shape, seen as it happens);
- :func:`guarded` wraps a declared dict, list or set so that every
  mutating (and iterating) operation checks that the declared guard is
  held by the calling thread; a bare access is recorded as an
  **unguarded access** with the caller's file:line;
- at interpreter exit each process writes its report to
  ``$COLEARN_LOCK_WITNESS_DIR/lockwitness-<pid>.json`` (when the
  directory is set), which the process soaks collect into their summary:
  the ``chaos --async/--tree-async --lock-witness`` gate requires zero
  inversions and zero unguarded accesses.

The wrappers keep ``threading``'s semantics: a witnessed Condition is a
real ``threading.Condition`` built around a witnessed lock (``wait``
releases and re-acquires through the wrapper's ``_release_save`` and
``_acquire_restore``, so the held stack stays true across the block).
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

_ENV = "COLEARN_LOCK_WITNESS"
_DIR_ENV = "COLEARN_LOCK_WITNESS_DIR"
_TRUTHY = {"1", "true", "on", "yes"}


def enabled() -> bool:
    return os.environ.get(_ENV, "").strip().lower() in _TRUTHY


# ------------------------------------------------------------- registry --
class _Witness:
    """Process-global witness state (edges, inversions, unguarded)."""

    def __init__(self) -> None:
        self.mu = threading.Lock()
        self.edges: Dict[Tuple[str, str], int] = {}
        self.inversions: List[dict] = []
        self.unguarded: List[dict] = []
        self.acquires = 0
        self.guarded_ops = 0
        self._tls = threading.local()
        self._dump_registered = False

    # held stack for the calling thread
    def held(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def on_attempt(self, name: str) -> None:
        """Record ordering edges at acquire ATTEMPT: the inversion exists
        the moment a thread tries B-while-holding-A against an observed
        A-after-B order — even if the acquire then times out (which is
        exactly how a real deadlock manifests)."""
        stack = self.held()
        with self.mu:
            for h in stack:
                if h == name:
                    continue
                edge = (h, name)
                fresh = edge not in self.edges
                self.edges[edge] = self.edges.get(edge, 0) + 1
                if fresh and self._path(name, h):
                    self.inversions.append({
                        "edge": [h, name],
                        "held": list(stack),
                        "thread": threading.current_thread().name,
                    })

    def on_acquired(self, name: str) -> None:
        with self.mu:
            self.acquires += 1
        self.held().append(name)

    def on_released(self, name: str) -> None:
        stack = self.held()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    def _path(self, src: str, dst: str) -> bool:  # colearn: holds(mu)
        """True when ``src`` already reaches ``dst`` in the edge graph
        (so a fresh dst->src edge closes a cycle).  Caller holds mu."""
        seen: Set[str] = set()
        frontier = [src]
        while frontier:
            node = frontier.pop()
            if node == dst:
                return True
            if node in seen:
                continue
            seen.add(node)
            frontier.extend(b for (a, b) in self.edges if a == node)
        return False

    def on_unguarded(self, structure: str, op: str, guard: str) -> None:
        # 0=here, 1=_stamp, 2=_check, 3=guarded dunder, 4=caller
        frame = sys._getframe(4)
        site = f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"
        with self.mu:
            self.unguarded.append({
                "structure": structure, "op": op, "guard": guard,
                "site": site,
                "thread": threading.current_thread().name,
            })

    def report(self) -> dict:
        with self.mu:
            return {
                "enabled": True,
                "pid": os.getpid(),
                "acquires": self.acquires,
                "guarded_ops": self.guarded_ops,
                "edges": sorted(f"{a}->{b}" for a, b in self.edges),
                "inversions": list(self.inversions),
                "unguarded": list(self.unguarded),
            }

    def maybe_register_dump(self) -> None:
        if self._dump_registered or not os.environ.get(_DIR_ENV):
            return
        self._dump_registered = True
        atexit.register(self._dump)

    def _dump(self) -> None:
        out_dir = os.environ.get(_DIR_ENV)
        if not out_dir:
            return
        try:
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"lockwitness-{os.getpid()}.json")
            with open(path, "w") as f:
                json.dump(self.report(), f, indent=2, sort_keys=True)
                f.write("\n")
        except OSError:  # colearn: noqa(CL003): atexit dump is best-effort diagnostics; nowhere left to report
            pass


_WITNESS = _Witness()


def report() -> dict:
    """Current process's witness report (``{"enabled": False}`` when off)."""
    if not enabled():
        return {"enabled": False}
    return _WITNESS.report()


def reset() -> None:
    """Drop all witness state (unit tests seed fresh scenarios)."""
    global _WITNESS
    registered = _WITNESS._dump_registered
    _WITNESS = _Witness()
    _WITNESS._dump_registered = registered


# ---------------------------------------------------------------- locks --
class WitnessLock:
    """Duck-typed ``threading.Lock`` recording acquisition order.  Also
    implements the private ``_is_owned`` / ``_release_save`` /
    ``_acquire_restore`` hooks ``threading.Condition`` probes for, so a
    Condition built on top keeps the held stack truthful across wait()."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._owner: Optional[int] = None
        _WITNESS.maybe_register_dump()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking:
            _WITNESS.on_attempt(self.name)
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            _WITNESS.on_acquired(self.name)
        return got

    def release(self) -> None:
        self._owner = None
        _WITNESS.on_released(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def _release_save(self):
        self.release()

    def _acquire_restore(self, _state) -> None:
        self.acquire()

    def __enter__(self) -> "WitnessLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class WitnessRLock(WitnessLock):
    """Reentrant variant: re-acquisition by the owner only deepens a
    count (one held-stack entry, one edge set)."""

    def __init__(self, name: str):
        super().__init__(name)
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._owner == threading.get_ident():
            self._count += 1
            return True
        if blocking:
            _WITNESS.on_attempt(self.name)
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            self._count = 1
            _WITNESS.on_acquired(self.name)
        return got

    def release(self) -> None:
        if self._owner != threading.get_ident():
            raise RuntimeError(f"release of un-owned witness rlock "
                               f"{self.name}")
        self._count -= 1
        if self._count == 0:
            self._owner = None
            _WITNESS.on_released(self.name)
            self._lock.release()


def lock(name: str):
    """A ``threading.Lock`` (witness-wrapped when the witness is on)."""
    if not enabled():
        return threading.Lock()
    return WitnessLock(name)


def rlock(name: str):
    if not enabled():
        return threading.RLock()
    return WitnessRLock(name)


def condition(name: str):
    """A ``threading.Condition`` (built on a witnessed lock when on)."""
    if not enabled():
        return threading.Condition()
    return threading.Condition(WitnessLock(name))


# ------------------------------------------------------------- guarded --
def _guard_lock(guard):
    """The WitnessLock inside a witnessed lock/Condition, else None."""
    if isinstance(guard, WitnessLock):
        return guard
    inner = getattr(guard, "_lock", None)
    return inner if isinstance(inner, WitnessLock) else None


def _stamp(structure: str, guard, op: str) -> None:
    gl = _guard_lock(guard)
    with _WITNESS.mu:
        _WITNESS.guarded_ops += 1
    if gl is not None and gl._is_owned():
        return
    _WITNESS.on_unguarded(structure, op,
                          gl.name if gl is not None else "?")


class _GuardedDict(dict):
    def __init__(self, data, structure, guard):
        super().__init__(data)
        self._structure = structure
        self._guard = guard

    def _check(self, op):
        _stamp(self._structure, self._guard, op)

    def __getitem__(self, k):
        self._check("getitem")
        return super().__getitem__(k)

    def __setitem__(self, k, v):
        self._check("setitem")
        super().__setitem__(k, v)

    def __delitem__(self, k):
        self._check("delitem")
        super().__delitem__(k)

    def __iter__(self):
        self._check("iter")
        return super().__iter__()

    def get(self, k, default=None):
        self._check("get")
        return super().get(k, default)

    def pop(self, *a, **kw):
        self._check("pop")
        return super().pop(*a, **kw)

    def update(self, *a, **kw):
        self._check("update")
        return super().update(*a, **kw)

    def setdefault(self, *a, **kw):
        self._check("setdefault")
        return super().setdefault(*a, **kw)

    def clear(self):
        self._check("clear")
        return super().clear()

    def items(self):
        self._check("items")
        return super().items()

    def values(self):
        self._check("values")
        return super().values()


class _GuardedSet(set):
    def __init__(self, data, structure, guard):
        super().__init__(data)
        self._structure = structure
        self._guard = guard

    def _check(self, op):
        _stamp(self._structure, self._guard, op)

    def add(self, v):
        self._check("add")
        return super().add(v)

    def discard(self, v):
        self._check("discard")
        return super().discard(v)

    def remove(self, v):
        self._check("remove")
        return super().remove(v)

    def __contains__(self, v):
        self._check("contains")
        return super().__contains__(v)

    def __iter__(self):
        self._check("iter")
        return super().__iter__()

    def clear(self):
        self._check("clear")
        return super().clear()


class _GuardedList(list):
    def __init__(self, data, structure, guard):
        super().__init__(data)
        self._structure = structure
        self._guard = guard

    def _check(self, op):
        _stamp(self._structure, self._guard, op)

    def append(self, v):
        self._check("append")
        return super().append(v)

    def extend(self, it):
        self._check("extend")
        return super().extend(it)

    def pop(self, *a):
        self._check("pop")
        return super().pop(*a)

    def remove(self, v):
        self._check("remove")
        return super().remove(v)

    def __setitem__(self, i, v):
        self._check("setitem")
        return super().__setitem__(i, v)

    def __iter__(self):
        self._check("iter")
        return super().__iter__()

    def clear(self):
        self._check("clear")
        return super().clear()


def guarded(obj, structure: str, guard):
    """Stamp ``obj`` (dict/list/set) so accesses assert ``guard`` is held
    by the calling thread.  Returns ``obj`` unchanged when the witness is
    off or the guard is not witness-wrapped (plain threading primitive)."""
    if not enabled() or _guard_lock(guard) is None:
        return obj
    if isinstance(obj, dict):
        return _GuardedDict(obj, structure, guard)
    if isinstance(obj, set):
        return _GuardedSet(obj, structure, guard)
    if isinstance(obj, list):
        return _GuardedList(obj, structure, guard)
    return obj
