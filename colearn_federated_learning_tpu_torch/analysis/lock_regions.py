"""Lock-region indexing shared by the concurrency rules (CL017–CL021).

Pure AST, single file, no imports of the linted code.  For every class
in a file this builds a :class:`ClassLockIndex` that answers the
questions the concurrency rules ask:

- which ``self._*`` attributes are locks / condition variables
  (``threading.Lock/RLock/Condition`` or the ``faults.lockwitness``
  factories assigned in ``__init__``, plus any lock-ish name used as
  ``with self._x:``);
- which locks are lexically held at any AST node (``with self._lock:``
  nesting; the held set RESETS inside nested ``def``/``lambda`` bodies
  because those run later, on whichever thread calls them);
- the acquire-while-holding edge set (for the lock-order graph);
- every read/write of a ``self._*`` attribute with the held set at the
  access site (for GuardedBy inference);
- which methods are thread entry points (passed bare — not called — as
  a call argument: ``threading.Thread(target=self._loop)``,
  ``threading.Timer(1, self._tick)``, ``pool.submit(self._work)``,
  server-callback ctors) and which methods those entries reach through
  ``self.m()`` calls.

Two annotation forms extend the inference where the AST cannot see:

- ``# colearn: holds(_lock[, _other])`` on a ``def`` line declares a
  caller-holds contract — the whole function body is treated as holding
  those locks (the caller-side ``with`` is the acquire site).
- ``# colearn: guarded-by(_lock)`` on a ``self._attr = ...`` assignment
  pins the attribute's guard explicitly instead of relying on counting.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

_HOLDS_RE = re.compile(
    r"#\s*colearn:\s*holds\(\s*(?P<locks>[A-Za-z_]\w*"
    r"(?:\s*,\s*[A-Za-z_]\w*)*)\s*\)"
)
_GUARDED_RE = re.compile(
    r"#\s*colearn:\s*guarded-by\(\s*(?P<lock>[A-Za-z_]\w*)\s*\)"
)

# threading.X ctor tails that create a lock-like primitive, and the
# faults.lockwitness factory names that stand in for them.
_LOCK_TAILS = {"Lock", "RLock"}
_CV_TAILS = {"Condition"}
_WITNESS_LOCK_TAILS = {"lock", "rlock"}
_WITNESS_CV_TAILS = {"condition"}
# fallback: `with self._x:` on a name that looks like a lock
_LOCKISH_NAME = re.compile(r"lock|mutex|_cv$|_cond", re.IGNORECASE)

# collection initializers recognized for CL021 ("guarded" is the
# faults.lockwitness stamp around a literal)
_COLLECTION_CTORS = {"dict", "list", "set", "OrderedDict", "defaultdict",
                     "deque", "Counter", "guarded"}
# method tails that mutate a collection in place (count as writes)
MUTATOR_TAILS = {"append", "appendleft", "add", "pop", "popleft", "popitem",
                 "clear", "update", "discard", "remove", "setdefault",
                 "extend", "insert"}


def self_attr(node: ast.AST) -> Optional[str]:
    """``'_x'`` when ``node`` is the attribute access ``self._x``."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


@dataclasses.dataclass
class Access:
    """One read or write of ``self.<attr>`` inside a method body."""

    attr: str
    node: ast.AST
    kind: str                 # "read" | "write"
    held: FrozenSet[str]
    method: str


class ClassLockIndex:
    """Lock facts for one ``class`` body (see module docstring)."""

    def __init__(self, classdef: ast.ClassDef, comments: Dict[int, str]):
        self.classdef = classdef
        self.name = classdef.name
        self.comments = comments
        self.methods: Dict[str, ast.AST] = {}
        self.locks: Set[str] = set()
        self.conditions: Set[str] = set()
        self.guard_annotations: Dict[str, str] = {}
        self.collections: Set[str] = set()
        self.accesses: List[Access] = []
        self.edges: Set[Tuple[str, str]] = set()
        self.edge_sites: Dict[Tuple[str, str], ast.AST] = {}
        self.calls: Dict[str, Set[str]] = {}
        self.entry_methods: Set[str] = set()
        self._held: Dict[int, FrozenSet[str]] = {}
        self._consumed: Set[int] = set()
        self._build()

    # ------------------------------------------------------------- build --
    def _build(self) -> None:
        for node in self.classdef.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[node.name] = node
        self._scan_init()
        self._scan_with_locks()
        for name, fn in self.methods.items():
            base = self._holds_annotation(fn)
            for child in ast.iter_child_nodes(fn):
                self._visit(child, frozenset(base), name)
        self._scan_entries()

    def _holds_annotation(self, fn: ast.AST) -> Set[str]:
        m = _HOLDS_RE.search(self.comments.get(fn.lineno, ""))
        if not m:
            return set()
        names = {n.strip() for n in m.group("locks").split(",")}
        self.locks.update(names)
        return names

    def _scan_init(self) -> None:
        """Lock ctors, guarded-by annotations and collection literals in
        ``__init__`` (the only place attributes are born)."""
        init = self.methods.get("__init__")
        targets: Iterator[ast.AST] = (
            ast.walk(init) if init is not None else iter(()))
        for node in targets:
            if isinstance(node, ast.Assign):
                attrs = [a for a in map(self_attr, node.targets) if a]
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                attrs = [a for a in (self_attr(node.target),) if a]
            else:
                continue
            if not attrs:
                continue
            is_lock, is_cv = self._lock_ctor(node.value)
            for attr in attrs:
                if is_lock or is_cv:
                    self.locks.add(attr)
                    if is_cv:
                        self.conditions.add(attr)
                if self._collection_init(node.value):
                    self.collections.add(attr)
                # the annotation may sit on any line of a wrapped
                # assignment statement
                for ln in range(node.lineno,
                                (node.end_lineno or node.lineno) + 1):
                    m = _GUARDED_RE.search(self.comments.get(ln, ""))
                    if m:
                        self.guard_annotations[attr] = m.group("lock")
                        self.locks.add(m.group("lock"))
                        break

    @staticmethod
    def _lock_ctor(value: ast.AST) -> Tuple[bool, bool]:
        if not isinstance(value, ast.Call):
            return False, False
        tail = (value.func.attr if isinstance(value.func, ast.Attribute)
                else value.func.id if isinstance(value.func, ast.Name)
                else "")
        # lockwitness.condition(...) vs threading.Condition(...)
        if tail in _CV_TAILS or tail in _WITNESS_CV_TAILS:
            return True, True
        if tail in _LOCK_TAILS or tail in _WITNESS_LOCK_TAILS:
            return True, False
        return False, False

    @staticmethod
    def _collection_init(value: ast.AST) -> bool:
        if isinstance(value, (ast.Dict, ast.List, ast.Set,
                              ast.DictComp, ast.ListComp, ast.SetComp)):
            return True
        if isinstance(value, ast.Call):
            tail = (value.func.attr
                    if isinstance(value.func, ast.Attribute)
                    else value.func.id
                    if isinstance(value.func, ast.Name) else "")
            return tail in _COLLECTION_CTORS
        return False

    def _scan_with_locks(self) -> None:
        """Heuristic: any lock-ish name used as ``with self._x:`` counts as
        a lock even without a visible ctor (e.g. passed in)."""
        for node in ast.walk(self.classdef):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            for item in node.items:
                attr = self_attr(item.context_expr)
                if attr and _LOCKISH_NAME.search(attr):
                    self.locks.add(attr)
                    if attr.endswith(("_cv", "_cond")) or "cond" in attr:
                        self.conditions.add(attr)

    def _scan_entries(self) -> None:
        """Methods passed bare as call arguments run on other threads
        (Thread targets, Timer callbacks, executor submissions, server
        handler ctors)."""
        for node in ast.walk(self.classdef):
            if not isinstance(node, ast.Call):
                continue
            candidates = list(node.args) + [kw.value for kw in node.keywords]
            for arg in candidates:
                attr = self_attr(arg)
                if attr and attr in self.methods:
                    self.entry_methods.add(attr)

    # ------------------------------------------------------------- visit --
    def _visit(self, node: ast.AST, held: FrozenSet[str],
               method: str) -> None:
        self._held[id(node)] = held
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: runs later, on whichever thread calls it — the
            # enclosing held set does not apply (unless annotated).
            inner = frozenset(self._holds_annotation(node))
            for child in ast.iter_child_nodes(node):
                self._visit(child, inner, method)
            return
        if isinstance(node, ast.Lambda):
            for child in ast.iter_child_nodes(node):
                self._visit(child, frozenset(), method)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired: List[str] = []
            for item in node.items:
                self._visit(item.context_expr, held, method)
                if item.optional_vars is not None:
                    self._visit(item.optional_vars, held, method)
                attr = self_attr(item.context_expr)
                if attr and attr in self.locks:
                    acquired.append(attr)
            inner_held = held
            for attr in acquired:
                for h in inner_held:
                    if h != attr:
                        edge = (h, attr)
                        self.edges.add(edge)
                        self.edge_sites.setdefault(edge, node)
                inner_held = inner_held | {attr}
            for stmt in node.body:
                self._visit(stmt, inner_held, method)
            return
        # writes through subscripts / attribute stores / mutator calls
        if isinstance(node, (ast.Subscript,)) and isinstance(
                node.ctx, (ast.Store, ast.Del)):
            attr = self_attr(node.value)
            if attr is not None:
                self._record(attr, node, "write", held, method)
                self._consumed.add(id(node.value))
        if isinstance(node, ast.Call):
            func = node.func
            if (isinstance(func, ast.Attribute)
                    and func.attr in MUTATOR_TAILS):
                attr = self_attr(func.value)
                if attr is not None:
                    self._record(attr, node, "write", held, method)
                    self._consumed.add(id(func.value))
            fattr = self_attr(func)
            if fattr and fattr in self.methods:
                self.calls.setdefault(method, set()).add(fattr)
        attr = self_attr(node)
        if attr is not None and id(node) not in self._consumed:
            kind = ("write" if isinstance(node.ctx, (ast.Store, ast.Del))
                    else "read")
            self._record(attr, node, kind, held, method)
        for child in ast.iter_child_nodes(node):
            self._visit(child, held, method)

    def _record(self, attr: str, node: ast.AST, kind: str,
                held: FrozenSet[str], method: str) -> None:
        if attr in self.locks or attr in self.methods:
            return
        self.accesses.append(Access(attr=attr, node=node, kind=kind,
                                    held=held, method=method))

    # -------------------------------------------------------------- query --
    def held_at(self, node: ast.AST) -> FrozenSet[str]:
        return self._held.get(id(node), frozenset())

    def reachable_methods(self) -> Set[str]:
        """Methods reachable from a thread entry via ``self.m()`` calls."""
        seen: Set[str] = set()
        frontier = list(self.entry_methods)
        while frontier:
            m = frontier.pop()
            if m in seen:
                continue
            seen.add(m)
            frontier.extend(self.calls.get(m, ()))
        return seen

    def inferred_guards(self, min_locked: int = 2) -> Dict[str, Set[str]]:
        """``{attr: {locks}}`` — a lock guards an attribute when at least
        ``min_locked`` accesses happen under it (outside ``__init__``) and
        the attribute is written somewhere outside ``__init__``.  Explicit
        ``guarded-by`` annotations override counting."""
        out: Dict[str, Set[str]] = {}
        per_attr: Dict[str, List[Access]] = {}
        for acc in self.accesses:
            if acc.method == "__init__":
                continue
            per_attr.setdefault(acc.attr, []).append(acc)
        for attr, accs in per_attr.items():
            if attr in self.guard_annotations:
                out[attr] = {self.guard_annotations[attr]}
                continue
            if not any(a.kind == "write" for a in accs):
                continue
            counts: Dict[str, int] = {}
            for a in accs:
                for lock in a.held:
                    counts[lock] = counts.get(lock, 0) + 1
            guards = {lock for lock, n in counts.items() if n >= min_locked}
            if guards:
                out[attr] = guards
        # annotated attrs with zero non-init accesses still get a guard
        for attr, lock in self.guard_annotations.items():
            out.setdefault(attr, {lock})
        return out

    def cycles(self) -> List[List[str]]:
        """Elementary cycles in the acquire-while-holding graph, each in a
        canonical rotation (deterministic report order)."""
        graph: Dict[str, List[str]] = {}
        for a, b in self.edges:
            graph.setdefault(a, []).append(b)
        for targets in graph.values():
            targets.sort()
        found: Set[Tuple[str, ...]] = set()
        out: List[List[str]] = []

        def dfs(node: str, path: List[str], on_path: Set[str]) -> None:
            for nxt in graph.get(node, ()):
                if nxt in on_path:
                    cycle = path[path.index(nxt):]
                    pivot = cycle.index(min(cycle))
                    canon = tuple(cycle[pivot:] + cycle[:pivot])
                    if canon not in found:
                        found.add(canon)
                        out.append(list(canon))
                    continue
                dfs(nxt, path + [nxt], on_path | {nxt})

        for start in sorted(graph):
            dfs(start, [start], {start})
        return out


def class_indexes(ctx) -> List[ClassLockIndex]:
    """Per-class lock indexes for a FileContext, cached on the context so
    the five concurrency rules share one pass."""
    cached = getattr(ctx, "_lock_indexes", None)
    if cached is None:
        cached = [ClassLockIndex(node, ctx.comments)
                  for node in ast.walk(ctx.tree)
                  if isinstance(node, ast.ClassDef)]
        ctx._lock_indexes = cached
    return cached
