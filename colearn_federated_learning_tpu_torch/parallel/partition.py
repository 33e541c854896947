"""Regex-driven parameter partition rules, and the shard/gather helpers.

The rule engine of the JAX package's ``parallel/partition.py``, copied:
an ordered ``(regex, spec)`` rule list over '/'-joined flax parameter
paths gives every leaf a partition spec.  A spec here is a tuple with one
entry per dimension, the mesh axis name or None (the JAX
``PartitionSpec``'s entries; ``()`` is replicated).  First match wins;
scalars are replicated; a dimension that does not divide by its axis size
replicates the whole leaf (numerics stay exact).

The rules are written on flax shapes.  The port's parameters carry other
layouts (``convert.py``: a query kernel is (H·hd, D) here, (D, H, hd) in
flax), so :func:`torch_shard_dims` evaluates the rules on each
parameter's flax path and shape and maps the sharded flax axis onto the
torch one; divisibility is checked on the flax dimension (the head count
H, not H·hd).

The rule grammar: each rule is ``(regex, spec)`` or ``(regex, spec,
ndim)``.  ``spec`` is ``None`` (replicate), an ``int`` dimension
(possibly negative) to shard over the default axis, or an explicit tuple
of axis names right-aligned to the leaf rank.  An optional ``ndim``
restricts the rule to leaves of that exact rank.

The server plane's placement (:class:`ServerPlacement`) is the JAX
package's over a 1-D ``(model,)`` mesh, held in the flax layout the
server state keeps: a position of the axis is a ``torch.device`` (a
device may repeat: N positions on one card, as JAX's forced host devices
are N positions on one CPU), a shard is a block of the flax-layout leaf
on the index ranges JAX's ``devices_indices_map`` gives, and a sharded
leaf is a :class:`ShardedTensor`.  The per-shard host reads
(:func:`host_leaf`, :func:`host_tree`), the gather accounting behind
``comm.gather_bytes_avoided_total`` (:func:`leaf_gather_avoided`,
:func:`tree_gather_avoided`, :func:`estimate_gather_avoided`) and
:func:`bytes_per_chip` are JAX's too.
"""

from __future__ import annotations

import dataclasses
import re
from collections.abc import Mapping
from typing import Any, Iterable, Optional, Sequence

import numpy as np
import torch

from colearn_federated_learning_tpu_torch import convert
from colearn_federated_learning_tpu_torch.utils import trees


def path_str(path) -> str:
    """'/'-joined key path."""
    return "/".join(str(p) for p in path)


# ---------------------------------------------------------------- rules --

# Transformer models (BERT, ViT, MoE banks): the tensor-parallel table.
TRANSFORMER_RULES: tuple = (
    (r"experts", 0),                               # MoE bank: (E, ...)
    (r"(^|/)embedding$", 0, 2),                    # vocab-sharded table
    (r"(^|/)(query|key|value)/kernel$", -2),       # (D, H, hd) head dim
    (r"(^|/)(query|key|value)/[^/]+$", 0),         # qkv bias (H, hd)
    (r"(^|/)out/kernel$", 0, 3),                   # row parallel (H, hd, D)
    (r"Block.*/Dense_0/kernel$", 1),               # MLP up (D, F)
    (r"Block.*/Dense_0/[^/]+$", 0),                # MLP up bias (F,)
    (r"Block.*/Dense_1/kernel$", 0),               # MLP down (F, D)
    (r"", None),                                   # everything else
)
BERT_RULES = TRANSFORMER_RULES

# CNN stem + dense head: shard the output-channel dim.
CNN_RULES: tuple = (
    (r"Conv[^/]*/kernel$", -1),                    # HWIO: out channels
    (r"Conv[^/]*/bias$", 0),
    (r"Dense[^/]*/kernel$", -1),
    (r"Dense[^/]*/bias$", 0),
    (r"", None),
)

# Unknown models: try the transformer rules first, then the CNN ones.
DEFAULT_RULES: tuple = TRANSFORMER_RULES[:-1] + CNN_RULES

_TRANSFORMER_NAMES = ("bert", "vit", "transformer", "moe", "gpt")
_CNN_NAMES = ("cnn", "conv", "mlp", "dense", "logreg", "linear")


def rules_for_model(model_name: str) -> tuple:
    """Pick the rule set for a registered model name."""
    name = (model_name or "").lower()
    if any(k in name for k in _TRANSFORMER_NAMES):
        return TRANSFORMER_RULES
    if any(k in name for k in _CNN_NAMES):
        return CNN_RULES
    return DEFAULT_RULES


def _resolve_spec(spec, shape: tuple, axis: str,
                  sizes: Mapping[str, int]) -> tuple:
    """One rule spec as a concrete spec tuple for ``shape``, replicating
    whenever the sharded dim would not divide evenly."""
    if spec is None:
        return ()
    if isinstance(spec, int):
        d = spec + len(shape) if spec < 0 else spec
        if not 0 <= d < len(shape):
            return ()
        size = sizes.get(axis, 0)
        if size and shape[d] % size:
            return ()
        out = [None] * len(shape)
        out[d] = axis
        return tuple(out)
    entries = tuple(spec)
    pad = len(shape) - len(entries)
    if pad < 0:
        return ()
    entries = (None,) * pad + entries
    for d, name in enumerate(entries):
        if name is None:
            continue
        for ax in (name if isinstance(name, tuple) else (name,)):
            size = sizes.get(ax, 0)
            if size and shape[d] % size:
                return ()
    return entries


def _compile(rules: Sequence[tuple]) -> list:
    return [(re.compile(r[0]), r[1], r[2] if len(r) > 2 else None)
            for r in rules]


def _spec_for(compiled, name: str, shape: tuple, axis: str,
              sizes: Mapping[str, int]) -> tuple:
    if len(shape) == 0:
        return ()                # scalar -> replicated, regardless of rules
    for pat, spec, ndim in compiled:
        if ndim is not None and len(shape) != ndim:
            continue
        if pat.search(name):
            return _resolve_spec(spec, shape, axis, sizes)
    raise ValueError(
        f"no partition rule matched param {name!r} (shape {shape}); "
        "rule sets should end with a catch-all (r\"\", None)")


def match_partition_rules(rules: Sequence[tuple], params: Any, *,
                          axis: str = "model",
                          sizes: Optional[Mapping[str, int]] = None) -> Any:
    """Nested dict of spec tuples for the nested dict ``params`` (flax
    paths; leaves anything with a ``shape``) from an ordered rule list."""
    sizes = dict(sizes or {})
    compiled = _compile(rules)

    def walk(tree, path):
        if isinstance(tree, Mapping):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return _spec_for(compiled, path_str(path), tuple(np.shape(tree)),
                         axis, sizes)

    return walk(params, ())


def torch_shard_dims(named_shapes: Mapping[str, tuple], rules: Sequence[tuple],
                     axis: str, size: int,
                     num_heads: Optional[int] = None) -> dict:
    """{torch parameter name: the torch dim sharded over ``axis``, or None}
    for the port's parameters ``named_shapes`` (name -> torch shape): the
    rules run on each parameter's flax path and shape."""
    compiled = _compile(rules)
    out = {}
    for name, shape in named_shapes.items():
        path, fshape, to_torch = convert.flax_layout(name, tuple(shape),
                                                     num_heads)
        spec = _spec_for(compiled, path_str(path), fshape, axis,
                         {axis: size})
        dims = [to_torch[d] for d, e in enumerate(spec) if e == axis]
        out[name] = dims[0] if dims else None
    return out


# ------------------------------------------------------ shard and gather --

def shard(t: torch.Tensor, dim: Optional[int], size: int,
          index: int) -> torch.Tensor:
    """Rank ``index``'s contiguous slice of ``t`` along ``dim`` (all of
    ``t`` when ``dim`` is None)."""
    if dim is None:
        return t
    return t.chunk(size, dim=dim)[index]


def make_shard_and_gather_fns(dims: Mapping[str, Optional[int]], ax):
    """Per-parameter ``(shard_fns, gather_fns)`` for the axis ``ax``
    (``parallel.mesh.Axis``): ``shard_fns[name](full)`` is this rank's
    slice, ``gather_fns[name](local)`` the full tensor, all-gathered over
    the axis for a sharded parameter and the tensor itself otherwise."""
    from colearn_federated_learning_tpu_torch.parallel import collectives

    def gather(t, dim):
        if dim is None:
            return t
        full = collectives.all_gather(t.movedim(dim, 0), ax.group)
        return _regroup(full, dim, ax.size)

    shard_fns = {n: (lambda t, d=d: shard(t, d, ax.size, ax.index))
                 for n, d in dims.items()}
    gather_fns = {n: (lambda t, d=d: gather(t, d)) for n, d in dims.items()}
    return shard_fns, gather_fns


def _regroup(gathered: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """Undo the dim-0 all-gather of ``local.movedim(dim, 0)`` slices."""
    parts = gathered.chunk(size, dim=0)
    return torch.cat([p.movedim(0, dim) for p in parts], dim=dim)


# ------------------------------------------------------- sharded leaves --

class ShardedTensor:
    """One leaf of a placed tree: its distinct shards, ``parts[j]`` the
    block ``index[j]`` (a tuple of slices of the full ``shape``) on the
    device of position ``j`` of a ``positions``-wide axis.  A leaf of one
    part is replicated: it is held once, on the first position's device,
    and charged to every position, as JAX charges every device for a
    replicated array (:func:`bytes_per_chip`)."""

    __slots__ = ("shape", "parts", "index", "positions")

    def __init__(self, shape: tuple, parts: list, index: list,
                 positions: int):
        self.shape = tuple(int(d) for d in shape)
        self.parts = list(parts)
        self.index = list(index)
        self.positions = int(positions)

    @property
    def nbytes(self) -> int:
        return (int(np.prod(self.shape, dtype=np.int64))
                * self.parts[0].element_size())

    def map_parts(self, fn) -> "ShardedTensor":
        """``fn(part, index)`` over the parts, in the same layout."""
        return ShardedTensor(self.shape,
                             [fn(p, i) for p, i in zip(self.parts,
                                                       self.index)],
                             self.index, self.positions)


def _tensor_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's host copy (a CPU tensor is copied too: the server state
    is updated in place)."""
    host = t.detach().cpu().numpy()
    return host.copy() if t.device.type == "cpu" else host


# ------------------------------------------------------- host-side reads --

def host_leaf(a: Any) -> np.ndarray:
    """One leaf to host numpy: a :class:`ShardedTensor` shard by shard into
    one buffer (each shard read once, never a gathered device copy), a
    tensor in one device-to-host copy, anything else as it is."""
    if isinstance(a, ShardedTensor):
        if len(a.parts) == 1:
            return _tensor_host(a.parts[0])
        out = None
        for part, idx in zip(a.parts, a.index):  # colearn: hot
            host = part.detach().cpu().numpy()  # colearn: noqa(CL006): per-shard D2H is the point, no full-array sync
            if out is None:
                out = np.empty(a.shape, host.dtype)
            out[idx] = host
        return out
    if isinstance(a, torch.Tensor):
        return _tensor_host(a)
    return np.asarray(a)


def host_tree(tree: Any) -> Any:
    """Per-shard host read of a whole nested-dict tree (:func:`host_leaf`)."""
    return trees.map_leaves(host_leaf, tree)


def leaf_gather_avoided(a: Any) -> int:
    """Bytes of per-position replication a sharded leaf avoids: with ``n``
    distinct shards each position holds ``nbytes/n``, so a replicated
    layout (or the gather that builds one) would hold ``nbytes·(n−1)/n``
    more per position."""
    if not isinstance(a, ShardedTensor) or len(a.parts) <= 1:
        return 0
    n = len(a.parts)
    return a.nbytes * (n - 1) // n


def tree_gather_avoided(tree: Any) -> int:
    return sum(leaf_gather_avoided(l) for l in trees.leaves(tree))


def estimate_gather_avoided(params: Any, rules: Sequence[tuple], axis: str,
                            size: int) -> int:
    """Pure shape math (no placement, no devices): the per-position
    replication bytes a ``size``-way sharded server avoids for ``params``
    under ``rules``."""
    if size <= 1:
        return 0
    specs = match_partition_rules(rules, params, axis=axis,
                                  sizes={axis: size})
    total = 0
    for w, s in zip(trees.leaves(params), trees.leaves(specs)):
        if any(e == axis for e in s):
            nbytes = int(np.prod(np.shape(w), dtype=np.int64)) * np.dtype(
                getattr(w, "dtype", np.float32)).itemsize
            total += nbytes * (size - 1) // size
    return total


def _state_leaves(tree: Any) -> list:
    """The leaves of a state tree: nested dicts, lists, tuples and
    dataclasses (the server state) walked, sharded leaves kept whole."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in _state_leaves(tree[k])]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in _state_leaves(getattr(tree, f.name))]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in _state_leaves(sub)]
    return [tree]


def bytes_per_chip(tree: Any) -> int:
    """The most bytes of ``tree`` any position holds (a sharded leaf charges
    each position its own shard, a replicated one every position), plus
    the leaves no placement holds (host arrays, tensors), counted once:
    the ``comm.server_bytes_per_chip`` gauge."""
    per: dict = {}
    rest = 0
    for l in _state_leaves(tree):
        if isinstance(l, ShardedTensor):
            if len(l.parts) == 1:
                for pos in range(l.positions):
                    per[pos] = per.get(pos, 0) + l.nbytes
                continue
            for pos, part in enumerate(l.parts):
                per[pos] = per.get(pos, 0) + part.nbytes
        elif hasattr(l, "nbytes"):
            rest += int(l.nbytes)
    return (max(per.values()) if per else 0) + rest


# ------------------------------------------------------ server placement --

def _index_key(index: tuple) -> tuple:
    return tuple((s.start, s.stop, s.step) for s in index)


def _spec_index(shape: tuple, spec: tuple, axis: str, n: int,
                pos: int) -> tuple:
    """Position ``pos``'s block of a leaf under ``spec`` over an ``n``-wide
    axis: JAX's ``devices_indices_map`` entry of a 1-D mesh."""
    index = []
    for d, dim in enumerate(shape):
        if d < len(spec) and spec[d] == axis:
            step = dim // n
            index.append(slice(pos * step, (pos + 1) * step, None))
        else:
            index.append(slice(None, None, None))
    return tuple(index)


class ServerPlacement:
    """The server plane over a 1-D ``(axis,)`` mesh of ``devices`` (one
    ``torch.device`` per position; a device may repeat).

    The server's round math is elementwise (the fold, the server
    optimizer), so slicing every leaf over the axis is bitwise exact: a
    per-shard sum in cohort order gives the bytes of the full-leaf sum in
    that order.  Each leaf's distinct shards are precomputed in position
    order (a replicated leaf has one, on the first position):

    - :meth:`shard`: a flax-layout tree placed as :class:`ShardedTensor`
      leaves, each shard on its position's device;
    - :meth:`slice_tree`: each leaf as the tuple of its per-shard numpy
      slices (the folder's staging layout);
    - :meth:`partition_flat_indices`: the sparse counterpart for one leaf;
    - :meth:`assemble`: per-shard slices as a placed tree;
    - :meth:`keys`, :meth:`flatten`, :meth:`unflatten`: a placed tree as
      the server state's flat dict, one tensor per (leaf, shard), and
      back (views, no copy).
    """

    def __init__(self, devices: Sequence, axis: str, specs: Any,
                 params: Any):
        self.devices = [torch.device(d) for d in devices]
        self.axis = axis
        self.specs = specs
        self._shapes = trees.map_leaves(
            lambda a: np.broadcast_to(np.zeros((), np.asarray(a).dtype),
                                      np.shape(a)), params)
        n = len(self.devices)
        self._meta = []
        self._keys: list[str] = []
        for i, (w, spec) in enumerate(zip(
                trees.leaves(params), trees.flatten_up_to(params, specs))):
            shape = tuple(int(d) for d in np.shape(w))
            slices, seen = [], set()
            for pos in range(n):
                idx = _spec_index(shape, spec, axis, n, pos)
                key = _index_key(idx)
                if key in seen:
                    continue
                seen.add(key)
                slices.append((pos, idx))
            self._meta.append((shape, spec, slices))
            self._keys += ([str(i)] if len(slices) == 1
                           else [f"{i}/{j}" for j in range(len(slices))])

    @classmethod
    def from_params(cls, params: Any, devices: Sequence, axis: str,
                    rules: Sequence[tuple]) -> "ServerPlacement":
        specs = match_partition_rules(rules, params, axis=axis,
                                      sizes={axis: len(devices)})
        return cls(devices, axis, specs, params)

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def sharded_fraction(self) -> float:
        """Fraction of the parameter COUNT living sharded."""
        tot = sharded = 0
        for shape, spec, _ in self._meta:
            n = int(np.prod(shape, dtype=np.int64)) if shape else 1
            tot += n
            if any(e == self.axis for e in spec):
                sharded += n
        return sharded / max(tot, 1)

    def _place(self, leaf: Any, meta: tuple) -> ShardedTensor:
        """A host leaf cut onto its shards, each a fresh tensor on its
        position's device (a placed leaf as it is)."""
        if isinstance(leaf, ShardedTensor):
            return leaf
        shape, _, slices = meta
        arr = np.asarray(leaf).reshape(shape)
        return ShardedTensor(
            shape, [torch.from_numpy(np.array(arr[idx])).to(self.devices[pos])
                    for pos, idx in slices],
            [i for _, i in slices], len(self.devices))

    def shard(self, tree: Any) -> Any:
        """The flax-layout host ``tree`` placed: every shard a fresh tensor
        on its position's device."""
        return trees.unflatten(self._shapes, [
            self._place(l, m) for l, m in zip(
                trees.flatten_up_to(self._shapes, tree), self._meta)])

    def slice_tree(self, tree: Any, scale: Optional[float] = None) -> Any:
        """Each leaf as the tuple of its distinct per-shard numpy slices;
        with ``scale``, each slice times it, in one pass (the product is
        the slice's copy, bitwise the slice of the scaled leaf)."""
        out = []
        for l, (_, _, slices) in zip(trees.flatten_up_to(self._shapes, tree),
                                     self._meta):
            arr = np.asarray(l)
            out.append(tuple(
                np.ascontiguousarray(arr[idx]) if scale is None
                else np.multiply(arr[idx], scale, order="C")
                for _, idx in slices))
        return trees.unflatten(self._shapes, out)

    def partition_flat_indices(self, leaf_pos: int, idx: np.ndarray,
                               vals: np.ndarray) -> list:
        """Flat ``(indices, values)`` into leaf ``leaf_pos`` (flatten order)
        scattered onto its shards without densifying: one
        ``(local_flat_idx, values, shard_shape)`` per distinct shard in
        :meth:`slice_tree`'s order, indices in the shard's own frame."""
        shape, _, slices = self._meta[leaf_pos]
        idx = np.asarray(idx, np.int64)
        if len(slices) == 1 or not shape:
            return [(idx, vals, shape)]
        multi = np.unravel_index(idx, shape)
        out = []
        for _, index in slices:
            starts = [0 if s.start is None else int(s.start) for s in index]
            stops = [shape[d] if s.stop is None else int(s.stop)
                     for d, s in enumerate(index)]
            sub_shape = tuple(b - a for a, b in zip(starts, stops))
            mask = np.ones(idx.shape, bool)
            for d in range(len(shape)):
                mask &= (multi[d] >= starts[d]) & (multi[d] < stops[d])
            local = np.ravel_multi_index(
                tuple(m[mask] - s for m, s in zip(multi, starts)), sub_shape)
            out.append((local.astype(np.int64), vals[mask], sub_shape))
        return out

    def assemble(self, sliced: Any) -> Any:
        """Per-shard slices (the :meth:`slice_tree` layout, numpy or
        tensors) as a placed tree, each slice on its own position's
        device."""
        out = []
        for parts, (shape, _, slices) in zip(
                trees.flatten_up_to(self._shapes, sliced), self._meta):
            placed = []
            for p, (pos, _) in zip(parts, slices):
                t = p if isinstance(p, torch.Tensor) else torch.from_numpy(
                    np.ascontiguousarray(p))
                placed.append(t.to(self.devices[pos]))
            out.append(ShardedTensor(shape, placed, [i for _, i in slices],
                                     len(self.devices)))
        return trees.unflatten(self._shapes, out)

    def shapes_tree(self) -> Any:
        """Zero-memory shape stand-ins of the params tree (read-only
        broadcast views): folder and recovery templates."""
        return self._shapes

    def keys(self) -> list[str]:
        """The server state's flat keys: ``"<leaf>"`` for a replicated
        leaf, ``"<leaf>/<shard>"`` for each shard of a sharded one."""
        return list(self._keys)

    def flatten(self, tree: Any) -> dict:
        """A tree (placed, or host arrays, which are placed first) as the
        flat dict of :meth:`keys`."""
        parts = [p for l, m in zip(trees.flatten_up_to(self._shapes, tree),
                                   self._meta)
                 for p in self._place(l, m).parts]
        return dict(zip(self._keys, parts))

    def unflatten(self, flat: dict) -> Any:
        """The flat dict of :meth:`keys` as a placed tree of views of its
        tensors."""
        it = iter(self._keys)
        out = []
        for shape, _, slices in self._meta:
            out.append(ShardedTensor(
                shape, [flat[next(it)] for _ in slices],
                [i for _, i in slices], len(self.devices)))
        return trees.unflatten(self._shapes, out)


def make_server_placement(params: Any, tp_size: int, axis: str,
                          model_name: str,
                          devices: Optional[Iterable] = None,
                          device=None) -> Optional[ServerPlacement]:
    """The coordinator's sharded-server placement, or ``None`` with a
    labelled ``fed.mesh_fallback_total`` count (``insufficient_devices``,
    ``rules_matched_nothing``) when the host cannot honour ``tp_size`` or
    the rules shard nothing of this model.  ``devices`` default to the
    positions of ``device``'s kind (``utils.device.placement_devices``:
    the distinct cards, or the CPU's host positions)."""
    from colearn_federated_learning_tpu_torch import telemetry
    from colearn_federated_learning_tpu_torch.utils import device as dev_lib

    if tp_size <= 1:
        return None
    devs = (list(devices) if devices is not None
            else dev_lib.placement_devices(device))
    reg = telemetry.get_registry()
    if len(devs) < tp_size:
        reg.counter("fed.mesh_fallback_total",
                    labels={"reason": "insufficient_devices"}).inc()
        return None
    placement = ServerPlacement.from_params(params, devs[:tp_size], axis,
                                            rules_for_model(model_name))
    if placement.sharded_fraction() == 0.0:
        reg.counter("fed.mesh_fallback_total",
                    labels={"reason": "rules_matched_nothing"}).inc()
        return None
    return placement
