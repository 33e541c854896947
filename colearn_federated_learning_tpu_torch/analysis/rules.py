"""The colearn rule set of the PyTorch port (CL002–CL021, CL023).

Each rule is ~30 lines: subclass :class:`~.engine.Rule`, set ``id`` /
``title`` / ``hint``, yield :class:`~.findings.Finding` objects from
``check(ctx)``, and decorate with ``@register``.  Rules are pure AST
heuristics — single-file, name-based, no imports of the linted code —
so false positives are possible and are handled with a justified
``# colearn: noqa(RULE)`` on the offending line.

The rules keep the JAX package's ids, titles, messages and hints.  Two
departures: CL001 (side effects in a ``jax.jit``/``pmap``/``shard_map``
body) is not here, and neither is CL006's traced-region half, because
this package traces nothing: both see only JAX-traced bodies.  CL006's
hot-loop half stays.

The JAX-idiom call sets keep JAX's names and add torch's counterparts,
so a JAX-idiom source gives JAX's findings and torch code is seen too:

- CL006 host syncs: ``.cpu()``, ``.tolist()``, ``.numpy()`` and
  ``torch.cuda.synchronize()`` beside JAX's ``float()``,
  ``np.asarray``/``np.array``, ``jax.device_get``,
  ``.block_until_ready()`` and ``.item()``;
- CL012 full-tree gathers: ``.cpu()``, ``.item()``, ``.tolist()``,
  ``.numpy()`` and ``torch.cuda.synchronize()`` beside
  ``jax.device_get``, and the port's tree map ``trees.map_leaves`` /
  ``map_leaves`` beside ``jax.tree.map`` and its aliases;
- CL013 full-shape buffers: ``torch.zeros``, ``torch.zeros_like``,
  ``torch.empty``, ``torch.empty_like``, ``torch.full`` and
  ``torch.full_like`` beside the numpy and ``jnp`` allocators.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from colearn_federated_learning_tpu_torch.analysis import lock_regions
from colearn_federated_learning_tpu_torch.analysis import metric_catalog
from colearn_federated_learning_tpu_torch.analysis.engine import (
    FileContext,
    Rule,
    register,
)
from colearn_federated_learning_tpu_torch.analysis.findings import Finding


def dotted_name(node: ast.expr) -> str:
    """``a.b.c`` for Name/Attribute chains, "" otherwise."""
    parts: list = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _enclosing_functions(tree: ast.AST) -> dict:
    """``{id(node): (outer, ..., innermost FunctionDef)}`` for every node."""
    out: dict = {}

    def visit(node: ast.AST, stack: tuple) -> None:
        out[id(node)] = stack
        child_stack = stack
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            child_stack = stack + (node,)
        for child in ast.iter_child_nodes(node):
            visit(child, child_stack)

    visit(tree, ())
    return out


def _has_timeout_param(fn: ast.AST) -> bool:
    args = fn.args
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return any("timeout" in n or "deadline" in n for n in names)


def _has_kwarg(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


# ----------------------------------------------------------------- CL002 --
@register
class SocketTimeout(Rule):
    """Every blocking socket op in comm/ must carry an explicit timeout
    (or live in a function that accepts one), so a dead peer costs a
    bounded slice of the round deadline, never the whole round."""

    id = "CL002"
    title = "blocking socket operation without an explicit timeout"
    hint = ("pass timeout= (or add a timeout/deadline parameter to the "
            "enclosing function and settimeout before the call)")

    _CLIENT_CTORS = {"BrokerClient", "TensorClient"}
    _BLOCKING_ATTRS = {"accept", "recv", "recv_into"}

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.in_dir("comm"):
            return
        enclosing = _enclosing_functions(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = dotted_name(node.func)
            tail = dotted.rsplit(".", 1)[-1]
            if _has_kwarg(node, "timeout"):
                continue
            if (dotted.endswith("create_connection")
                    or tail == "connect"
                    or tail in self._CLIENT_CTORS):
                if tail == "connect" and len(node.args) >= 3:
                    continue      # connect(host, port, timeout) positional
            elif (tail in self._BLOCKING_ATTRS
                    and isinstance(node.func, ast.Attribute)):
                # raw socket .accept()/.recv(n) have no timeout arg: require
                # a timeout-bearing enclosing function (which is expected
                # to settimeout the socket) or a justified noqa.
                pass
            else:
                continue
            fns = enclosing.get(id(node), ())
            if any(_has_timeout_param(fn) for fn in fns):
                continue
            yield self.finding(
                ctx, node,
                f"{dotted or tail}() without an explicit timeout: a dead "
                "peer blocks forever")


# ----------------------------------------------------------------- CL003 --
@register
class SwallowedError(Rule):
    """Bare ``except:`` and pass-only handlers hide real failures in the
    planes where failures are the whole point (comm, faults, engine)."""

    id = "CL003"
    title = "bare except / silently swallowed error"
    hint = ("narrow the exception type and count or log it "
            "(comm.protocol.close_quietly for socket teardown)")

    def _applies(self, ctx: FileContext) -> bool:
        return (ctx.in_dir("comm") or ctx.in_dir("faults")
                or ctx.relpath.endswith("fed/engine.py"))

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not self._applies(ctx):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                yield self.finding(
                    ctx, node,
                    "bare `except:` also catches SystemExit/KeyboardInterrupt")
                continue
            if all(isinstance(s, (ast.Pass, ast.Continue))
                   for s in node.body):
                caught = dotted_name(node.type) or "exception"
                yield self.finding(
                    ctx, node,
                    f"`except {caught}` swallows the error with no count, "
                    "log, or re-raise")


# ----------------------------------------------------------------- CL004 --
@register
class Nondeterminism(Rule):
    """Fault injection replays byte-identically from a seed; wall-clock
    and unseeded RNG calls break that contract."""

    id = "CL004"
    title = "nondeterministic source in a seeded code path"
    hint = ("thread the plan's seeded rng / use time.monotonic for "
            "durations only")

    _WALL_CLOCK = {"time.time", "datetime.now", "datetime.datetime.now",
                   "datetime.utcnow", "datetime.datetime.utcnow"}
    _SEEDED_CTORS = {"Random", "default_rng", "RandomState"}

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.in_dir("faults"):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = dotted_name(node.func)
            tail = dotted.rsplit(".", 1)[-1]
            if dotted in self._WALL_CLOCK:
                yield self.finding(
                    ctx, node,
                    f"{dotted}() is wall-clock: replay of a seeded fault "
                    "plan diverges")
            elif dotted.startswith(("random.", "np.random.",
                                    "numpy.random.")):
                if tail in self._SEEDED_CTORS and (node.args
                                                   or node.keywords):
                    continue          # random.Random(seed) etc. — seeded
                yield self.finding(
                    ctx, node,
                    f"{dotted}() draws from global/unseeded RNG state")


# ----------------------------------------------------------------- CL005 --
@register
class MetricNameDrift(Rule):
    """Every literal metric name handed to the registry must be declared
    in analysis/metric_catalog.py — a typo'd counter is a silently-empty
    series the chaos-soak gate never sees."""

    id = "CL005"
    title = "metric name not declared in the catalog"
    hint = "add it to analysis/metric_catalog.py (or fix the typo)"

    _REGISTRY_METHODS = {"counter", "gauge", "histogram"}

    def _first_name_arg(self, call: ast.Call):
        if call.args:
            return call.args[0]
        for kw in call.keywords:
            if kw.arg == "name":
                return kw.value
        return None

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if "analysis" in ctx.parts:
            return  # the catalog itself and its tooling
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self._REGISTRY_METHODS):
                continue
            arg = self._first_name_arg(node)
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                if not metric_catalog.is_known(arg.value):
                    yield self.finding(
                        ctx, node,
                        f"metric name {arg.value!r} is not in the catalog")
            elif isinstance(arg, ast.JoinedStr):
                # f"fault.injected.{kind}" — validate the static prefix
                # against the catalog's `family.*` wildcards.
                prefix = ""
                for part in arg.values:
                    if isinstance(part, ast.Constant):
                        prefix += str(part.value)
                    else:
                        break
                if not metric_catalog.is_known(prefix + "x"):
                    yield self.finding(
                        ctx, node,
                        f"dynamic metric name with prefix {prefix!r} matches "
                        "no `family.*` wildcard in the catalog")
            elif arg is not None:
                # A plain-variable name used to slip through unvalidated —
                # the exact hole a typo'd series hides in.  Loops over a
                # catalog-declared tuple (metric_catalog.SOAK_DELTA_COUNTERS)
                # carry a justified noqa.
                yield self.finding(
                    ctx, node,
                    "non-literal metric name: the catalog cannot validate "
                    "it — inline the literal, use an f-string with a "
                    "`family.*` prefix, or iterate a catalog-declared "
                    "tuple with a justified noqa")


# ----------------------------------------------------------------- CL006 --
@register
class HostSyncInHotLoop(Rule):
    """``float(x)`` / ``np.asarray`` / ``.item()`` / ``.cpu()`` force a
    device→host sync; inside a marked hot loop they serialize the
    pipeline.  (JAX's traced-region half has no counterpart here: this
    package traces nothing.)"""

    id = "CL006"
    title = "host synchronization inside a traced region or hot loop"
    hint = ("batch the transfer after the loop / keep values on device; "
            "mark intentional syncs with `# colearn: noqa(CL006)`")

    _SYNC_CALLS = {"np.asarray", "numpy.asarray", "np.array", "numpy.array",
                   "jax.device_get", "torch.cuda.synchronize"}
    _SYNC_METHODS = ("block_until_ready", "item", "cpu", "tolist", "numpy")

    def _sync(self, node: ast.AST) -> Optional[str]:
        if not isinstance(node, ast.Call):
            return None
        func = node.func
        if isinstance(func, ast.Name) and func.id == "float":
            if node.args and not isinstance(node.args[0], ast.Constant):
                return "float()"
            return None
        dotted = dotted_name(func)
        if dotted in self._SYNC_CALLS:
            return f"{dotted}()"
        if isinstance(func, ast.Attribute) and func.attr in self._SYNC_METHODS:
            return f".{func.attr}()"
        return None

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        hot = ctx.hot_lines()
        if not hot:
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.For, ast.While)) and node.lineno in hot:
                for inner in ast.walk(node):
                    what = self._sync(inner)
                    if what:
                        yield self.finding(
                            ctx, inner,
                            f"{what} inside a `# colearn: hot` loop "
                            "serializes the device pipeline")


# ----------------------------------------------------------------- CL007 --
@register
class SerializeInFanOutLoop(Rule):
    """The coordinator's broadcast is serialize-ONCE: one CLW1 encode per
    round, shared read-only by every cohort send (comm/downlink.py).  A
    ``pytree_to_bytes`` (or npz save) inside a ``# colearn: hot`` fan-out
    loop re-encodes the full model per device per round — exactly the
    O(cohort) host cost the fast path removed.  Guards that invariant the
    way CL006 guards host syncs."""

    id = "CL007"
    title = "per-request serialization inside a hot fan-out loop"
    hint = ("encode once before the loop and hand every send the shared "
            "frame via request(body=...) — see comm/downlink."
            "DownlinkEncoder; mark a justified per-iteration encode with "
            "`# colearn: noqa(CL007)`")

    _ENCODERS = {"pytree_to_bytes", "save_pytree_npz"}
    # Fan-outs submit via comprehensions as often as statement loops.
    _LOOPS = (ast.For, ast.While, ast.ListComp, ast.SetComp, ast.DictComp,
              ast.GeneratorExp)

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        hot = ctx.hot_lines()
        if not hot:
            return
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, self._LOOPS) and node.lineno in hot):
                continue
            for inner in ast.walk(node):
                if not isinstance(inner, ast.Call):
                    continue
                tail = dotted_name(inner.func).rsplit(".", 1)[-1]
                if tail in self._ENCODERS:
                    yield self.finding(
                        ctx, inner,
                        f"{tail}() inside a `# colearn: hot` fan-out loop "
                        "re-encodes the full model per request; encode "
                        "once and pass request(body=...)")


# ----------------------------------------------------------------- CL008 --
@register
class NonAtomicExchangeWrite(Rule):
    """The file-exchange plane (fed/) hands artifacts to OTHER processes
    by path: a reader (or a SIGKILL mid-write) that lands between open
    and close sees a torn file.  Every exchange write must go through a
    temp file + ``os.replace`` so readers only ever observe complete
    artifacts (utils.serialization.atomic_save_pytree_npz)."""

    id = "CL008"
    title = "non-atomic write on a file-exchange path"
    hint = ("write via utils.serialization.atomic_save_pytree_npz (or "
            "temp file + os.replace in the same function); mark a "
            "single-process scratch write with `# colearn: noqa(CL008)`")

    # Explicit dotted forms for the numpy writers so a method named
    # `.save()` on some manager object (orbax is atomic internally)
    # doesn't trip the rule; save_pytree_npz is unambiguous at any depth.
    _NP_WRITERS = {"np.savez", "numpy.savez", "np.savez_compressed",
                   "numpy.savez_compressed", "np.save", "numpy.save"}

    def _is_writer(self, call: ast.Call) -> Optional[str]:
        dotted = dotted_name(call.func)
        if dotted in self._NP_WRITERS:
            return dotted
        if dotted.rsplit(".", 1)[-1] == "save_pytree_npz":
            return "save_pytree_npz"
        if isinstance(call.func, ast.Name) and call.func.id == "open":
            mode = None
            if len(call.args) >= 2:
                mode = call.args[1]
            for kw in call.keywords:
                if kw.arg == "mode":
                    mode = kw.value
            if (isinstance(mode, ast.Constant)
                    and isinstance(mode.value, str)
                    and "w" in mode.value):
                return f"open(..., {mode.value!r})"
        return None

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.in_dir("fed"):
            return
        enclosing = _enclosing_functions(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            writer = self._is_writer(node)
            if writer is None:
                continue
            fns = enclosing.get(id(node), ())
            atomic = False
            for fn in fns:
                for inner in ast.walk(fn):
                    if (isinstance(inner, ast.Call)
                            and dotted_name(inner.func) == "os.replace"):
                        atomic = True
                        break
                if atomic:
                    break
            if atomic:
                continue
            yield self.finding(
                ctx, node,
                f"{writer} writes an exchange file in place: a reader or "
                "kill mid-write sees a torn artifact; use temp file + "
                "os.replace")


# ----------------------------------------------------------------- CL009 --
@register
class PerClientLoopInFleetHotPath(Rule):
    """fleetsim exists to make simulated clients a ``jax.vmap`` axis
    (fleetsim/sim.py): the ONLY Python loop a hot fleet path may contain
    iterates over fixed-size CHUNKS, each dispatching one jitted vmapped
    step.  A per-client/per-device Python loop — or a ``local_update``
    call per iteration — re-creates the one-at-a-time engine inside the
    subsystem built to kill it, and at fleet scale turns a ~250-dispatch
    million-client round into a million dispatches."""

    id = "CL009"
    title = "per-client Python loop in a fleetsim hot path"
    hint = ("make clients a vmap axis: materialize the chunk and call the "
            "jitted chunk step once per CHUNK (see fleetsim/sim."
            "FleetSim.run_round); mark a justified host-side loop with "
            "`# colearn: noqa(CL009)`")

    _TRAINERS = {"local_update", "scaffold_update"}
    _WORDS = ("client", "device")
    _LOOPS = (ast.For, ast.While, ast.ListComp, ast.SetComp, ast.DictComp,
              ast.GeneratorExp)

    def _idents(self, node: ast.AST) -> Iterator[str]:
        for n in ast.walk(node):
            if isinstance(n, ast.Name):
                yield n.id
            elif isinstance(n, ast.Attribute):
                yield n.attr

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.in_dir("fleetsim"):
            return
        hot = ctx.hot_lines()
        if not hot:
            return
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, self._LOOPS) and node.lineno in hot):
                continue
            # (a) the loop head names a per-client/per-device quantity.
            if isinstance(node, ast.For):
                head: tuple = (node.target, node.iter)
            elif isinstance(node, ast.While):
                head = (node.test,)
            else:
                head = tuple(part for comp in node.generators
                             for part in (comp.target, comp.iter))
            per_client = [i for h in head for i in self._idents(h)
                          if any(w in i.lower() for w in self._WORDS)]
            if per_client:
                yield self.finding(
                    ctx, node,
                    f"`# colearn: hot` loop iterates per "
                    f"{per_client[0]!r}: clients must be a vmap axis — "
                    "loop over chunks")
                continue
            # (b) one local-training call per iteration.
            for inner in ast.walk(node):
                if not isinstance(inner, ast.Call):
                    continue
                tail = dotted_name(inner.func).rsplit(".", 1)[-1]
                if tail in self._TRAINERS:
                    yield self.finding(
                        ctx, inner,
                        f"{tail}() called once per iteration of a "
                        "`# colearn: hot` loop; vmap it over the chunk "
                        "instead")


# ----------------------------------------------------------------- CL010 --
@register
class NoPrintInLibrary(Rule):
    """Library code has two sanctioned output planes — the metrics
    registry and the JSONL event/record streams; a stray ``print()`` to
    stdout interleaves with the machine-readable stdout contract the CLI
    maintains (round records, bench JSON) and corrupts downstream
    parsers.  CLI entry surfaces own stdout and are exempt; stderr
    diagnostics and ``__main__``-guarded debug mains are allowed."""

    id = "CL010"
    title = "print() to stdout in library code"
    hint = ("route through the metrics/event plane, or print to stderr "
            "(`print(..., file=sys.stderr)`); CLI entry modules are "
            "exempt by name")

    # Modules whose contract IS stdout (subcommand surface, bench JSON).
    _EXEMPT_FILES = {"cli.py", "bench.py"}

    @staticmethod
    def _is_main_guard(test: ast.AST) -> bool:
        return (isinstance(test, ast.Compare)
                and isinstance(test.left, ast.Name)
                and test.left.id == "__name__"
                and any(isinstance(c, ast.Constant)
                        and c.value == "__main__"
                        for c in test.comparators))

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if ctx.parts and ctx.parts[-1] in self._EXEMPT_FILES:
            return
        if ctx.in_dir("scripts"):
            return
        guarded: set = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.If) and self._is_main_guard(node.test):
                for inner in ast.walk(node):
                    guarded.add(id(inner))
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "print"):
                continue
            if id(node) in guarded:
                continue
            file_kw = next((kw.value for kw in node.keywords
                            if kw.arg == "file"), None)
            if file_kw is not None and dotted_name(file_kw) != "sys.stdout":
                continue              # explicit non-stdout sink
            yield self.finding(
                ctx, node,
                "print() to stdout in library code interleaves with the "
                "machine-readable stdout contract; use the metrics/event "
                "plane or stderr")


# ----------------------------------------------------------------- CL011 --
@register
class PerPairLoopInMaskingHotPath(Rule):
    """Secure-aggregation mask expansion is ONE vectorized dispatch:
    build the (P, 2) pair-key table, then a single
    ``pairwise_mask_with_keys`` / ``mask_update_with_keys`` call expands
    every pair's PRG stream inside one jitted ``fori_loop``
    (privacy/secure_agg.py).  A Python loop that calls a mask expander
    once per pair pays a dispatch — and, called eagerly, a full
    retrace+compile — per pair; under the secure chaos soak that turned
    sub-second rounds into deadline blowouts.  Deriving the pair KEYS
    per pair (``shared_secret`` / ``pair_prng_key``, one scalar modexp
    each) is the sanctioned loop shape and is exempt."""

    id = "CL011"
    title = "per-pair Python loop in a hot masking path"
    hint = ("build the pair-key table once and make a single "
            "*_with_keys call (privacy/secure_agg."
            "pairwise_mask_with_keys); mark a justified per-pair loop "
            "with `# colearn: noqa(CL011)`")

    _EXPANDERS = {"pairwise_mask", "mask_update", "mask_scalar",
                  "pairwise_mask_with_keys", "mask_update_with_keys",
                  "_sample_tree"}
    _KEY_DERIVATION = {"shared_secret", "pair_prng_key"}
    _WORDS = ("pair", "partner", "peer", "neighbor")
    _LOOPS = (ast.For, ast.While, ast.ListComp, ast.SetComp, ast.DictComp,
              ast.GeneratorExp)

    def _idents(self, node: ast.AST) -> Iterator[str]:
        for n in ast.walk(node):
            if isinstance(n, ast.Name):
                yield n.id
            elif isinstance(n, ast.Attribute):
                yield n.attr

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not (ctx.in_dir("privacy") or ctx.in_dir("comm")):
            return
        hot = ctx.hot_lines()
        if not hot:
            return
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, self._LOOPS) and node.lineno in hot):
                continue
            tails = {dotted_name(inner.func).rsplit(".", 1)[-1]
                     for inner in ast.walk(node)
                     if isinstance(inner, ast.Call)}
            # (a) a mask expander called once per iteration.
            expanded = sorted(tails & self._EXPANDERS)
            if expanded:
                yield self.finding(
                    ctx, node,
                    f"{expanded[0]}() called once per iteration of a "
                    "`# colearn: hot` loop: one dispatch (and possibly "
                    "one retrace) per pair — make a single *_with_keys "
                    "call over the pair-key table")
                continue
            # (b) the loop head names a per-pair quantity (and the body
            # is not just the sanctioned scalar key derivation).
            if tails & self._KEY_DERIVATION:
                continue
            if isinstance(node, ast.For):
                head: tuple = (node.target, node.iter)
            elif isinstance(node, ast.While):
                head = (node.test,)
            else:
                head = tuple(part for comp in node.generators
                             for part in (comp.target, comp.iter))
            per_pair = [i for h in head for i in self._idents(h)
                        if any(w in i.lower() for w in self._WORDS)]
            if per_pair:
                yield self.finding(
                    ctx, node,
                    f"`# colearn: hot` loop iterates per "
                    f"{per_pair[0]!r}: pairs must be a table axis — "
                    "expand every mask in one *_with_keys dispatch")


# ----------------------------------------------------------------- CL012 --
@register
class FullTreeGatherInHotWirePath(Rule):
    """The sharded-server wire path never gathers the full model:
    the downlink encoder and the streaming fold read/scatter PER-DEVICE
    shards (parallel/partition.host_leaf / ServerPlacement.slice_tree),
    so no chip ever materializes a replicated copy and multi-host meshes
    stay legal.  A ``jax.device_get(...)`` — or the tree-mapped
    ``np.asarray`` full-tree-gather idiom — inside a ``# colearn: hot``
    region of the comm plane reintroduces exactly the O(model) gather the
    refactor removed."""

    id = "CL012"
    title = "full-tree gather on a hot downlink/aggregation path"
    hint = ("read per-device shards instead (parallel/partition."
            "host_tree, comm/downlink.host_params) or stage per-shard "
            "slices (ServerPlacement.slice_tree); mark a justified "
            "host-side conversion with `# colearn: noqa(CL012)`")

    _GATHERS = {"jax.device_get", "device_get", "torch.cuda.synchronize"}
    _GATHER_METHODS = {"cpu", "item", "tolist", "numpy"}
    _CONVERTERS = {"np.asarray", "numpy.asarray", "np.array", "numpy.array",
                   "jnp.asarray"}
    _TREE_MAPS = {"jax.tree.map", "jax.tree_map", "jax.tree_util.tree_map",
                  "tree.map", "tree_map", "trees.map_leaves", "map_leaves"}
    # Hot markers land on statement heads: defs, loops, withs, or the
    # offending statement line itself.
    _REGIONS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.For, ast.While,
                ast.With)

    def _gather(self, node: ast.AST) -> Optional[str]:
        if not isinstance(node, ast.Call):
            return None
        dotted = dotted_name(node.func)
        if dotted in self._GATHERS:
            return f"{dotted}()"
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in self._GATHER_METHODS):
            return f".{node.func.attr}()"
        if dotted in self._TREE_MAPS and node.args:
            first = dotted_name(node.args[0])
            if first in self._CONVERTERS:
                return f"{dotted}({first}, ...)"
        return None

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.in_dir("comm"):
            return
        hot = ctx.hot_lines()
        if not hot:
            return
        seen: set = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, self._REGIONS) and node.lineno in hot:
                inners: Iterator[ast.AST] = ast.walk(node)
            elif isinstance(node, ast.Call) and node.lineno in hot:
                inners = iter((node,))
            else:
                continue
            for inner in inners:
                what = self._gather(inner)
                if what is None:
                    continue
                key = (inner.lineno, inner.col_offset)
                if key in seen:
                    continue
                seen.add(key)
                yield self.finding(
                    ctx, inner,
                    f"{what} inside a `# colearn: hot` wire path gathers "
                    "the full tree to one host buffer per chip; read "
                    "per-device shards (partition.host_tree) or stage "
                    "per-shard slices instead")


# ----------------------------------------------------------------- CL013 --
@register
class FullShapeMaterializeInHotAggregation(Rule):
    """The sparse-native uplink fold stages topk contributions as
    (indices, values) and scatter-adds them at finalize: per-contribution
    host cost is O(k), not O(model).  Densifying a compressed update —
    a ``decompress_delta`` call, or allocating a full-shape buffer
    (``np.zeros`` / ``np.empty`` / ``np.full`` / ``*_like``) per update —
    inside a ``# colearn: hot`` aggregation/wire region of the comm plane
    reintroduces exactly the O(model)-per-client work the fast path
    removed.  The once-per-round accumulator allocation at finalize is
    fine (it is not hot); the int8 dequantize is inherently dense (every
    entry carries signal) and keeps a justified noqa."""

    id = "CL013"
    title = "full-shape materialization on a hot aggregation path"
    hint = ("stage sparse (indices, values) and scatter-add at finalize "
            "(StreamingFolder._stage_topk / ServerPlacement."
            "partition_flat_indices); mark an inherently-dense decode "
            "with `# colearn: noqa(CL013)`")

    _ALLOCATORS = {"np.zeros", "numpy.zeros", "np.empty", "numpy.empty",
                   "np.full", "numpy.full", "np.zeros_like",
                   "numpy.zeros_like", "np.full_like", "numpy.full_like",
                   "jnp.zeros", "jnp.zeros_like", "torch.zeros",
                   "torch.zeros_like", "torch.empty", "torch.empty_like",
                   "torch.full", "torch.full_like"}
    _REGIONS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.For, ast.While,
                ast.With)

    def _materialize(self, node: ast.AST) -> Optional[str]:
        if not isinstance(node, ast.Call):
            return None
        dotted = dotted_name(node.func)
        if dotted.rsplit(".", 1)[-1] == "decompress_delta":
            return (f"{dotted}() densifies a compressed update to full "
                    "model shape")
        if dotted in self._ALLOCATORS and node.args:
            return f"{dotted}(...) allocates a full-shape buffer"
        return None

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.in_dir("comm"):
            return
        hot = ctx.hot_lines()
        if not hot:
            return
        seen: set = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, self._REGIONS) and node.lineno in hot:
                inners: Iterator[ast.AST] = ast.walk(node)
            elif isinstance(node, ast.Call) and node.lineno in hot:
                inners = iter((node,))
            else:
                continue
            for inner in inners:
                what = self._materialize(inner)
                if what is None:
                    continue
                key = (inner.lineno, inner.col_offset)
                if key in seen:
                    continue
                seen.add(key)
                yield self.finding(
                    ctx, inner,
                    f"{what} inside a `# colearn: hot` aggregation path — "
                    "O(model) host work per update; stage sparse "
                    "(indices, values) and scatter-add at finalize "
                    "(StreamingFolder._stage_topk)")


# ----------------------------------------------------------------- CL014 --
@register
class UnattributedTimingInHotWirePath(Rule):
    """The fleet health plane attributes every hot-path duration
    to a named sink: a tracer span (stitched into the round trace), a
    registry histogram (``fed.phase_time_s`` / ``comm.agg_fold_time_s``),
    or an accumulated stat shipped in round meta (``fold_s``).  A raw
    wall-clock delta — ``time.time() - t0`` computed in a ``# colearn:
    hot`` comm region and not fed into one of those sinks — is a timing
    measurement the health ledger, ``colearn top``, and the sentinel
    windows never see: it ages into a print/log or a local nobody reads.
    Accumulations (``self.fold_s += perf_counter() - t0``) and deltas
    passed straight into ``observe``/``set``/``record``/``inc`` are
    attributed and stay clean."""

    id = "CL014"
    title = "unattributed wall-clock delta on a hot wire path"
    hint = ("time it with `tracer.span(...)` or feed the delta to a "
            "registry histogram (fed.phase_time_s) / the health ledger; "
            "mark a justified raw delta with `# colearn: noqa(CL014)`")

    _CLOCKS = {"time.time", "time.monotonic", "time.perf_counter",
               "perf_counter", "monotonic"}
    _SINKS = {"observe", "set", "record", "inc", "set_attr"}
    _REGIONS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.For, ast.While,
                ast.With)

    def _delta(self, node: ast.AST) -> Optional[str]:
        # A duration is clock-call-minus-start; deadline arithmetic
        # (``deadline - time.monotonic()``) keeps the clock on the right
        # and is budget bookkeeping, not a measurement.
        if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub)):
            return None
        if not isinstance(node.left, ast.Call):
            return None
        dotted = dotted_name(node.left.func)
        if dotted not in self._CLOCKS:
            return None
        return f"{dotted}() - ..."

    def _attributed(self, tree: ast.AST) -> set:
        """ids of every node under an AugAssign value (stat accumulation)
        or a metric-sink call argument — deltas landing there are fed to
        a named series and exempt."""
        out: set = set()
        for node in ast.walk(tree):
            roots: tuple = ()
            if isinstance(node, ast.AugAssign):
                roots = (node.value,)
            elif isinstance(node, ast.Call):
                # ``reg.histogram(...).observe(dt)`` roots the attribute
                # chain at a Call, so read the attr directly rather than
                # via dotted_name (which needs a Name root).
                func = node.func
                tail = (func.attr if isinstance(func, ast.Attribute)
                        else dotted_name(func))
                if tail in self._SINKS:
                    roots = tuple(node.args) + tuple(
                        kw.value for kw in node.keywords)
            for root in roots:
                out.update(id(n) for n in ast.walk(root))
        return out

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.in_dir("comm"):
            return
        hot = ctx.hot_lines()
        if not hot:
            return
        attributed = self._attributed(ctx.tree)
        seen: set = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, self._REGIONS) and node.lineno in hot:
                inners: Iterator[ast.AST] = ast.walk(node)
            elif node.__class__ is ast.BinOp and node.lineno in hot:
                inners = iter((node,))
            else:
                continue
            for inner in inners:
                what = self._delta(inner)
                if what is None or id(inner) in attributed:
                    continue
                key = (inner.lineno, inner.col_offset)
                if key in seen:
                    continue
                seen.add(key)
                yield self.finding(
                    ctx, inner,
                    f"{what} inside a `# colearn: hot` wire path is a "
                    "duration no sink ever sees; route it through a "
                    "tracer span or a registry histogram so the health "
                    "plane can attribute it")


# ----------------------------------------------------------------- CL015 --
@register
class UninterruptibleBackoffSleep(Rule):
    """A bare ``time.sleep()`` inside a comm retry/dispatch loop is an
    uninterruptible stall: ``close()``/``stop()`` cannot wake the thread,
    so shutdown blocks for a full backoff (and the chaos gate's SIGKILL
    relaunch inherits a zombie that finishes its nap before noticing the
    socket died).  Every backoff in the comm plane waits on a
    ``threading.Event`` (``self._stop.wait(delay)``/``_closing.wait``)
    instead — same delay when idle, immediate wakeup on teardown.  Sleeps
    outside loops (test fixtures, one-shot startup grace) are not
    backoffs and stay clean."""

    id = "CL015"
    title = "uninterruptible time.sleep() in a comm retry/dispatch loop"
    hint = ("wait on the owner's stop event instead: "
            "`if self._stop.wait(delay): return` wakes on shutdown; "
            "mark a justified bare sleep with `# colearn: noqa(CL015)`")

    _SLEEPS = {"time.sleep", "sleep"}

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.in_dir("comm"):
            return
        loops = [n for n in ast.walk(ctx.tree)
                 if isinstance(n, (ast.For, ast.While))]
        in_loop: set = set()
        for loop in loops:
            in_loop.update(id(n) for n in ast.walk(loop))
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call) and id(node) in in_loop):
                continue
            if dotted_name(node.func) not in self._SLEEPS:
                continue
            yield self.finding(
                ctx, node,
                "bare time.sleep() in a retry/dispatch loop cannot be "
                "interrupted by close()/stop(): the backoff outlives "
                "teardown; wait on the stop Event so shutdown wakes it")


# ----------------------------------------------------------------- CL016 --
@register
class RecordKeyDrift(Rule):
    """Every literal round-record key the comm/fleetsim hot paths stamp
    must be declared in analysis/metric_catalog.RECORD_KEYS — a typo'd
    key ("train_los") forks a series that sentinels, `colearn converge`,
    and the bench harness silently never match."""

    id = "CL016"
    title = "round-record key not declared in the catalog"
    hint = ("add it to RECORD_KEYS in analysis/metric_catalog.py "
            "(or fix the typo)")

    # The hot-path files whose rec/out dicts ARE round records.  Other
    # comm files use `out` for wire headers etc. — out of scope.
    _FILES = {"coordinator.py", "async_coordinator.py", "sim.py"}
    _RECORD_NAMES = {"rec", "out", "record"}

    def _is_record(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Name)
                and node.id in self._RECORD_NAMES)

    def _check_key(self, ctx, node, key) -> Iterator[Finding]:
        if isinstance(key, str) and not metric_catalog.is_known_record_key(
                key):
            yield self.finding(
                ctx, node,
                f"record key {key!r} is not in RECORD_KEYS")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not (ctx.in_dir("comm") or ctx.in_dir("fleetsim")):
            return
        if ctx.parts[-1] not in self._FILES:
            return
        for node in ast.walk(ctx.tree):
            # rec["key"] = ... / out["key"] = ...
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if (isinstance(tgt, ast.Subscript)
                            and self._is_record(tgt.value)
                            and isinstance(tgt.slice, ast.Constant)):
                        yield from self._check_key(
                            ctx, node, tgt.slice.value)
                    # rec = {"key": ...} / out = {...}
                    if self._is_record(tgt) and isinstance(
                            node.value, ast.Dict):
                        for k in node.value.keys:
                            if isinstance(k, ast.Constant):
                                yield from self._check_key(
                                    ctx, node, k.value)
            # rec.update(key=..., ...) / out.update({"key": ...})
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "update"
                    and self._is_record(node.func.value)):
                for kw in node.keywords:
                    if kw.arg is not None:       # **expr stays unvalidated
                        yield from self._check_key(ctx, node, kw.arg)
                for arg in node.args:
                    if isinstance(arg, ast.Dict):
                        for k in arg.keys:
                            if isinstance(k, ast.Constant):
                                yield from self._check_key(
                                    ctx, node, k.value)


# ------------------------------------------------------- CL017–CL021 ------
# Concurrency family.  All five share the per-class lock index built by
# analysis.lock_regions and are scoped to the threaded planes: comm/,
# telemetry/, faults/.

_CONCURRENCY_DIRS = ("comm", "telemetry", "faults")


def _concurrency_scope(ctx: FileContext) -> bool:
    return any(ctx.in_dir(d) for d in _CONCURRENCY_DIRS)


# ----------------------------------------------------------------- CL017 --
@register
class GuardedByInference(Rule):
    """An attribute consistently touched under one lock but read/written
    bare on a thread-reachable path is a data race waiting for a chaos
    soak to find it — flag it now, statically."""

    id = "CL017"
    title = "unguarded access to a lock-guarded attribute"
    hint = ("acquire the guarding lock around the access, or pin the "
            "contract with `# colearn: guarded-by(_lock)` / a reasoned "
            "noqa citing a witness-clean soak")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not _concurrency_scope(ctx):
            return
        for idx in lock_regions.class_indexes(ctx):
            if not idx.locks:
                continue
            guards = idx.inferred_guards()
            reachable = idx.reachable_methods()
            for acc in idx.accesses:
                attr_guards = guards.get(acc.attr)
                if not attr_guards or acc.method == "__init__":
                    continue
                if acc.held & attr_guards:
                    continue
                if acc.method not in reachable:
                    continue
                locks = "/".join(sorted(attr_guards))
                yield self.finding(
                    ctx, acc.node,
                    f"{idx.name}.{acc.attr} is guarded by {locks} "
                    f"elsewhere but {acc.kind} without it in "
                    f"thread-reachable `{acc.method}`")


# ----------------------------------------------------------------- CL018 --
@register
class LockOrderCycle(Rule):
    """Two threads acquiring the same locks in opposite orders deadlock;
    the acquire-while-holding graph must stay a DAG."""

    id = "CL018"
    title = "lock-order cycle (deadlock potential)"
    hint = ("break the cycle: always acquire these locks in one global "
            "order, or narrow one critical section so the nesting "
            "disappears")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not _concurrency_scope(ctx):
            return
        for idx in lock_regions.class_indexes(ctx):
            for cycle in idx.cycles():
                ring = " -> ".join(cycle + [cycle[0]])
                first_edge = (cycle[0], cycle[1 % len(cycle)])
                site = idx.edge_sites.get(
                    first_edge) or idx.classdef
                yield self.finding(
                    ctx, site,
                    f"{idx.name} acquires locks in a cycle: {ring}")


# ----------------------------------------------------------------- CL019 --
@register
class BlockingWhileHolding(Rule):
    """Sleeping, socket I/O, or broker RPC inside a critical section
    stalls every thread contending for the lock (and turned a lock into
    a convoy in the async plane more than once)."""

    id = "CL019"
    title = "blocking call while holding a lock"
    hint = ("move the blocking call outside the `with self._lock:` "
            "block — snapshot state under the lock, do I/O bare, merge "
            "results back under the lock")

    _BLOCKING_TAILS = {
        "sleep", "recv", "recv_into", "recvfrom", "send", "sendall",
        "sendto", "accept", "connect", "create_connection", "request",
        "publish", "subscribe", "select", "acquire", "wait",
        "fetch_aggregators",
    }
    _BLOCKING_CTORS = {"BrokerClient", "TensorClient", "TensorServer"}

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not _concurrency_scope(ctx):
            return
        for idx in lock_regions.class_indexes(ctx):
            if not idx.locks:
                continue
            for node in ast.walk(idx.classdef):
                if not isinstance(node, ast.Call):
                    continue
                held = idx.held_at(node)
                if not held:
                    continue
                func = node.func
                tail = (func.attr if isinstance(func, ast.Attribute)
                        else func.id if isinstance(func, ast.Name)
                        else "")
                if tail == "wait":
                    # waiting on the very condition you hold is the CV
                    # protocol (CL020 checks the predicate loop).
                    recv = lock_regions.self_attr(
                        func.value) if isinstance(
                            func, ast.Attribute) else None
                    if recv is not None and recv in held:
                        continue
                if tail in self._BLOCKING_TAILS or (
                        isinstance(func, ast.Name)
                        and func.id in self._BLOCKING_CTORS):
                    locks = "/".join(sorted(held))
                    what = tail or getattr(func, "id", "call")
                    yield self.finding(
                        ctx, node,
                        f"{idx.name} calls blocking `{what}` while "
                        f"holding {locks}")


# ----------------------------------------------------------------- CL020 --
@register
class CvWaitWithoutPredicateLoop(Rule):
    """`Condition.wait` wakes spuriously and after stolen wakeups; a
    wait that is not re-checked in a `while` loop acts on stale state."""

    id = "CL020"
    title = "Condition.wait outside a predicate loop"
    hint = ("wrap the wait: `while not predicate: cv.wait(timeout)` "
            "(or use cv.wait_for(predicate, timeout))")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not _concurrency_scope(ctx):
            return
        for idx in lock_regions.class_indexes(ctx):
            if not idx.conditions:
                continue
            for name, fn in idx.methods.items():
                yield from self._scan(ctx, idx, fn, in_while=False)

    def _scan(self, ctx, idx, node, in_while) -> Iterator[Finding]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                # nested body runs elsewhere: loop context does not carry
                yield from self._scan(ctx, idx, child, in_while=False)
                continue
            inner = in_while or isinstance(child, ast.While)
            if (isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Attribute)
                    and child.func.attr == "wait"):
                recv = lock_regions.self_attr(child.func.value)
                if recv in idx.conditions and not in_while:
                    yield self.finding(
                        ctx, child,
                        f"{idx.name}.{recv}.wait() outside a `while` "
                        f"predicate loop")
            yield from self._scan(ctx, idx, child, inner)


# ----------------------------------------------------------------- CL021 --
@register
class UnlockedIteration(Rule):
    """Iterating a shared dict/list/set while another thread mutates it
    raises `RuntimeError: changed size during iteration` — or worse,
    silently skips entries."""

    id = "CL021"
    title = "iteration over a guarded collection without its lock"
    hint = ("hold the guard while iterating, or snapshot first "
            "(`list(self._x.items())` under the lock, iterate the copy)")

    _VIEW_TAILS = {"items", "keys", "values"}

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not _concurrency_scope(ctx):
            return
        for idx in lock_regions.class_indexes(ctx):
            if not idx.locks or not idx.collections:
                continue
            guards = idx.inferred_guards()
            shared = {a: g for a, g in guards.items()
                      if a in idx.collections}
            if not shared:
                continue
            for node in ast.walk(idx.classdef):
                iters = self._iter_exprs(node)
                for expr in iters:
                    attr = self._iterated_attr(expr)
                    if attr is None or attr not in shared:
                        continue
                    if idx.held_at(node) & shared[attr]:
                        continue
                    locks = "/".join(sorted(shared[attr]))
                    yield self.finding(
                        ctx, expr,
                        f"{idx.name}.{attr} iterated without {locks}")

    @staticmethod
    def _iter_exprs(node: ast.AST) -> list:
        if isinstance(node, ast.For):
            return [node.iter]
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            return [gen.iter for gen in node.generators]
        return []

    def _iterated_attr(self, expr: ast.AST) -> Optional[str]:
        """``self._x`` or ``self._x.items()/keys()/values()`` — a
        `list(...)`/`sorted(...)` wrapper counts as a snapshot and is
        not reported (it still races in theory, but is the conventional
        copy idiom and completes in one pass)."""
        attr = lock_regions.self_attr(expr)
        if attr is not None:
            return attr
        if (isinstance(expr, ast.Call)
                and isinstance(expr.func, ast.Attribute)
                and expr.func.attr in self._VIEW_TAILS):
            return lock_regions.self_attr(expr.func.value)
        return None


# ----------------------------------------------------------------- CL023 --
@register
class NonDurableCheckpointWrite(NonAtomicExchangeWrite):
    """CL008 keeps exchange READERS from seeing torn files (tmp +
    ``os.replace``); the durable-state plane — ckpt/ generations and the
    fed/offline.py exchange root — must also survive POWER LOSS.  A
    rename without an fsync can reach the directory before the data
    blocks do, so a crash leaves a complete-looking file of stale or
    zero bytes that passes every existence check and fails on read.
    Every durable write must fsync the temp file BEFORE the rename (the
    ckpt/streaming._atomic_write / utils.serialization.
    atomic_save_pytree_npz discipline)."""

    id = "CL023"
    title = "durable-state write without fsync-before-rename"
    hint = ("route the write through an atomic helper (ckpt/streaming."
            "_atomic_write, utils.serialization.atomic_save_pytree_npz) "
            "or add os.fsync before the os.replace in the same function; "
            "mark a justified non-durable write with "
            "`# colearn: noqa(CL023)`")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        in_offline = ctx.in_dir("fed") and ctx.parts[-1] == "offline.py"
        if not (ctx.in_dir("ckpt") or in_offline):
            return
        enclosing = _enclosing_functions(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            writer = self._is_writer(node)
            if writer is None:
                continue
            if self._durable(enclosing.get(id(node), ())):
                continue
            yield self.finding(
                ctx, node,
                f"{writer} writes durable state without tmp + fsync + "
                "os.replace: a crash can surface a torn — or "
                "complete-looking but stale — file")

    @staticmethod
    def _durable(fns: tuple) -> bool:
        """True when an enclosing function either performs the full
        fsync-then-replace dance itself or hands the bytes to an
        ``*atomic*``-named helper that owns it."""
        for fn in fns:
            replaced = synced = False
            for inner in ast.walk(fn):
                if not isinstance(inner, ast.Call):
                    continue
                dotted = dotted_name(inner.func)
                if "atomic" in dotted.rsplit(".", 1)[-1]:
                    return True
                if dotted == "os.replace":
                    replaced = True
                elif dotted == "os.fsync":
                    synced = True
            if replaced and synced:
                return True
        return False
