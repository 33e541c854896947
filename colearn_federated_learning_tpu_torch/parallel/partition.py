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

The sharded server plane (``ServerPlacement``) is not here: its callers
are the socket coordinators, ROADMAP.md Queue A item 8.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Optional, Sequence

import numpy as np
import torch

from colearn_federated_learning_tpu_torch import convert


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
