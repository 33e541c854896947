"""Trees of parameters as nested dicts of numpy arrays.

The file and wire planes carry the flax layout (``convert.py``): nested
dicts whose leaves are arrays.  These helpers walk them in the order
``jax.tree`` flattens a dict, by sorted key, so a leaf list lines up with
the JAX package's slot for slot.
"""

from __future__ import annotations

from typing import Any, Callable


def leaves(tree: Any) -> list:
    """The leaves in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def flatten_up_to(ref: Any, tree: Any) -> list:
    """The nodes of ``tree`` at ``ref``'s leaf positions (a node may itself
    be a dict, such as a compressed leaf's frame)."""
    if isinstance(ref, dict):
        if not isinstance(tree, dict) or set(tree) != set(ref):
            raise ValueError("tree does not match the reference's structure")
        return [n for k in sorted(ref) for n in flatten_up_to(ref[k], tree[k])]
    return [tree]


def unflatten(ref: Any, values: list) -> Any:
    """``ref``'s structure with its leaves replaced by ``values`` in order."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(ref)
    if next(it, None) is not None:
        raise ValueError("more values than the reference has leaves")
    return out


def map_leaves(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching nodes of
    ``rest``), keeping the structure."""
    parts = [flatten_up_to(tree, r) for r in rest]
    return unflatten(tree, [fn(*args) for args in zip(leaves(tree), *parts)])
