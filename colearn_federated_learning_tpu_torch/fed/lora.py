"""Rank-r LoRA adapters: federating factors instead of dense deltas (the
counterpart of the JAX package's ``fed/lora.py``).

Each targeted weight W keeps a frozen base and trains a rank-r pair
``B (m, r)`` / ``A (r, n)``; the effective weight is

    W_eff = W + (alpha / r) * reshape(B @ A, W.shape),

so clients train and ship only the factors.  Trees here are in the flax
layout the wire carries (``convert.py``): nested dicts whose leaves are
tensors (or numpy arrays where only shapes are read), walked in sorted-key
order as ``jax.tree`` walks a dict.  The factor tree holds, at each
targeted leaf's path, a ``{A_KEY: A, B_KEY: B}`` pair; every other leaf is
absent.

Targeting is the JAX package's: a leaf is adapted iff its first-matching
partition rule (``parallel/partition.py``) carries a spec, before any
divisibility check, and it has rank >= 2; bias leaves never are.  The
factorization splits the leaf's dims where ``m + n`` is least (ties to
the lowest split), so an attention kernel (D, H, hd) factors as
(D, r) x (r, H·hd).

The math runs on torch tensors on whatever device they live on.  On a
sharded base (``parallel.partition.ShardedTensor`` leaves) the merge
runs shard by shard: each leaf's (α/r)·B·A is computed whole, as the
replicated merge computes it, and every shard adds its own block, so the
sharded merge is bitwise the replicated one.  :func:`factor_specs` gives
the factors' partition specs on a sharded base (JAX's).
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch

from colearn_federated_learning_tpu_torch.parallel import partition

# The pair dict at an adapted leaf's position in the factor tree.
A_KEY = "lora_a"
B_KEY = "lora_b"

# Init scale of A; B starts at zero, so round 0 is the base model exactly.
DEFAULT_SIGMA = 0.02


def _leaves_with_path(tree: Mapping, prefix: tuple = ()):
    """(path, leaf) in sorted-key order, as ``jax.tree`` flattens a dict."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _leaves_with_path(value, prefix + (key,))
        else:
            yield prefix + (key,), value


# ------------------------------------------------------------ targeting --
def _compile_rules(rules) -> list:
    return [(re.compile(r[0]), r[1], r[2] if len(r) > 2 else None)
            for r in rules]


def _raw_spec(compiled, name: str, shape) -> Any:
    """The first matching rule's raw spec for a '/'-joined path, before
    divisibility: targeting must not depend on a mesh size."""
    if len(shape) == 0:
        return None
    for pat, spec, ndim in compiled:
        if ndim is not None and len(shape) != ndim:
            continue
        if pat.search(name):
            return spec
    return None


def target_paths(params: Mapping, model_name: str = "",
                 rules: Optional[tuple] = None) -> dict:
    """``{path: shape}`` of the adapted leaves: the first matching rule has
    a spec, the leaf has rank >= 2 and is not a bias (rank-r factors of a
    (heads, head_dim) bias cost more bytes than the bias)."""
    compiled = _compile_rules(
        rules if rules is not None else partition.rules_for_model(model_name))
    out = {}
    for path, leaf in _leaves_with_path(params):
        shape = tuple(leaf.shape)
        name = partition.path_str(path)
        if path[-1] == "bias":
            continue
        if len(shape) >= 2 and _raw_spec(compiled, name, shape) is not None:
            out[name] = shape
    return out


def split_point(shape) -> int:
    """The split k minimizing prod(shape[:k]) + prod(shape[k:]) (ties
    break low)."""
    best_k, best = 1, None
    for k in range(1, len(shape)):
        m = int(np.prod(shape[:k], dtype=np.int64))
        n = int(np.prod(shape[k:], dtype=np.int64))
        if best is None or m + n < best:
            best_k, best = k, m + n
    return best_k


def factor_dims(shape) -> tuple[int, int]:
    """(m, n) of a leaf's ``B (m, r) @ A (r, n)`` factorization."""
    k = split_point(shape)
    return (int(np.prod(shape[:k], dtype=np.int64)),
            int(np.prod(shape[k:], dtype=np.int64)))


def _nested_set(tree: dict, path: str, value: Any) -> None:
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def init_factors(params: Mapping, rank: int,
                 generator: Optional[torch.Generator] = None,
                 model_name: str = "", rules: Optional[tuple] = None,
                 sigma: float = DEFAULT_SIGMA, device=None) -> dict:
    """The factor tree of ``params`` (only their shapes are read): at each
    adapted leaf ``{A_KEY: (r, n) f32, B_KEY: (m, r) f32}`` on ``device``.

    A ~ N(0, sigma), drawn leaf by leaf in sorted-path order from
    ``generator`` (on the generator's device, then moved), and B = 0, so
    the adapters start at a zero delta.  Without a generator A is zero
    too: the shape template of masks and frames."""
    targets = target_paths(params, model_name=model_name, rules=rules)
    out: dict = {}
    for path, shape in sorted(targets.items()):
        m, n = factor_dims(shape)
        if generator is None:
            a = torch.zeros((rank, n), dtype=torch.float32, device=device)
        else:
            a = (sigma * torch.randn((rank, n), generator=generator,
                                     dtype=torch.float32,
                                     device=generator.device)).to(device)
        _nested_set(out, path, {
            A_KEY: a,
            B_KEY: torch.zeros((m, rank), dtype=torch.float32, device=device),
        })
    return out


def factor_index(factors: Mapping) -> dict:
    """A factor tree as ``{path: (A, B)}``."""
    out: dict = {}

    def walk(node, prefix):
        if isinstance(node, Mapping):
            if set(node) == {A_KEY, B_KEY}:
                out[prefix] = (node[A_KEY], node[B_KEY])
            else:
                for k in node:
                    walk(node[k], f"{prefix}/{k}" if prefix else str(k))

    walk(factors, "")
    return out


def count_factor_params(factors: Mapping) -> int:
    return sum(int(np.prod(tuple(l.shape), dtype=np.int64))
               for _, l in _leaves_with_path(factors))


# ---------------------------------------------------------- apply / merge --
def adapter_delta(a: torch.Tensor, b: torch.Tensor, shape, alpha: float,
                  rank: int) -> torch.Tensor:
    """``(B @ A)`` reshaped to the leaf's flax ``shape``, times α/r (f32)."""
    return (b @ a).reshape(tuple(shape)) * (alpha / float(rank))


def adapt_leaf(w: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``w + delta`` accumulated in f32, in ``w``'s dtype."""
    return (w.float() + delta).to(w.dtype)


def apply_adapters(params: Mapping, factors: Mapping, alpha: float,
                   rank: int) -> dict:
    """``params`` with ``(α/r)·reshape(B @ A)`` added at every factor
    position, in the JAX package's operation order."""
    idx = factor_index(factors)

    def walk(node, prefix):
        out = {}
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                out[k] = walk(v, path)
                continue
            ab = idx.get(path)
            if ab is None:
                out[k] = v
                continue
            a, b = ab
            delta = adapter_delta(a, b, v.shape, alpha, rank)
            if isinstance(v, partition.ShardedTensor):
                out[k] = v.map_parts(lambda part, idx, d=delta: adapt_leaf(
                    part, d[idx].to(part.device)))
            else:
                out[k] = adapt_leaf(v, delta)
        return out

    return walk(params, "")


def merge_adapters(params: Mapping, factors: Mapping, alpha: float,
                   rank: int) -> dict:
    """Fold B·A·(α/r) into the base: :func:`apply_adapters`, named for the
    server's merge."""
    return apply_adapters(params, factors, alpha, rank)


def reset_factors(factors: Mapping) -> dict:
    """After a merge: B goes to zero (its delta is in the base now), A is
    kept, so the next cycle starts from the same basis."""

    def walk(node):
        if isinstance(node, Mapping):
            if set(node) == {A_KEY, B_KEY}:
                return {A_KEY: node[A_KEY],
                        B_KEY: torch.zeros_like(node[B_KEY])}
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(factors)


# ------------------------------------------------------ sharding specs --
def factor_specs(params: Mapping, rank: int, axis: str = "model",
                 model_name: str = "", rules: Optional[tuple] = None,
                 sizes: Optional[Mapping[str, int]] = None) -> dict:
    """The factor tree's partition specs (tuples, ``parallel/partition.py``'s
    form): the base leaf's resolved spec inherited by the factor whose
    flattened dim group holds the sharded base dim as its major
    component.

    - base sharded at dim 0        -> B: ``(axis, None)``
    - base sharded at dim split(k) -> A: ``(None, axis)``
    - anything else                -> both replicated (``()``)

    A factor dim that does not divide by the axis size replicates."""
    rules = rules if rules is not None else partition.rules_for_model(
        model_name)
    sizes = dict(sizes or {})
    specs = partition.match_partition_rules(rules, params, axis=axis,
                                            sizes=sizes)
    spec_by_path = {partition.path_str(p): s
                    for p, s in _leaves_with_path(specs)}
    size = int(sizes.get(axis, 0))
    out: dict = {}
    for path, shape in sorted(target_paths(
            params, model_name=model_name, rules=rules).items()):
        spec = spec_by_path.get(path, ())
        sharded_dim = next(
            (d for d, name in enumerate(spec) if name == axis), None)
        k = split_point(shape)
        m, n = factor_dims(shape)
        a_spec, b_spec = (), ()
        if sharded_dim == 0 and (not size or m % size == 0):
            b_spec = (axis, None)
        elif sharded_dim == k and (not size or n % size == 0):
            a_spec = (None, axis)
        _nested_set(out, path, {A_KEY: a_spec, B_KEY: b_spec})
    return out
