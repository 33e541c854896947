"""Exact conversion between flax params and the port's ``state_dict``.

Flax params are a nested dict of numpy arrays, as ``jax.device_get`` gives
them for any of the JAX package's models; the port's are the flat
``state_dict`` of the matching module.  The port's submodules carry their
flax names, so a parameter's torch name is its flax path joined by dots
with the leaf renamed, and one walk serves every family.  Both directions
only transpose and reshape, so a round trip is bit-exact:

- ``Dense`` kernels (in, out) <-> ``weight`` (out, in);
- ``Conv`` kernels HWIO <-> OIHW, and WIO <-> OIW for 1-D convs;
- ``DenseGeneral`` query/key/value kernels (D, H, hd) and biases (H, hd)
  <-> (H·hd, D) and (H·hd,); the attention ``out`` kernel (H, hd, D) <->
  (D, H·hd);
- ``Embed.embedding`` and ``LayerNorm``/``GroupNorm`` ``scale`` <->
  ``weight``;
- raw parameters (``pos_embed``, ``cls``, the MoE ``experts_*`` banks) as
  they are.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch

_QKV = ("query", "key", "value")


def _kind(module: str) -> str:
    """The flax layer kind of a module name (``Conv_3`` -> ``Conv``)."""
    return module.rsplit("_", 1)[0] if module[-1:].isdigit() else module


def _leaves(tree, path=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), np.asarray(value)


def leaf_to_torch(path: tuple, a: torch.Tensor) -> tuple[str, torch.Tensor]:
    """One flax leaf at ``path`` as the port's ``(name, tensor)``.  Only
    reshapes and permutes (views where they can be), so it is safe under
    autograd: the LoRA trainer maps its adapted weights with it."""
    module, leaf = (path[-2] if len(path) > 1 else ""), path[-1]
    prefix = ".".join(path[:-1])
    if leaf == "kernel":
        if module in _QKV:
            a = a.reshape(a.shape[0], -1).T
        elif module == "out":
            a = a.reshape(-1, a.shape[-1]).T
        else:                         # Dense (in, out); Conv (*k, in, out)
            a = a.permute(a.ndim - 1, a.ndim - 2, *range(a.ndim - 2))
        name = "weight"
    elif leaf == "bias":
        a = a.reshape(-1) if module in _QKV else a
        name = "bias"
    elif leaf in ("scale", "embedding"):
        name = "weight"
    else:
        name = leaf
    return (f"{prefix}.{name}" if prefix else name), a


def leaf_to_flax(name: str, t: torch.Tensor, num_heads: Optional[int] = None,
                 batch_dims: int = 0) -> tuple[tuple, torch.Tensor]:
    """The port's parameter ``name`` as its flax ``(path, tensor)``: the
    inverse of :func:`leaf_to_torch`, as a view of ``t`` (a transpose and
    a split of one dim are both views), so nothing is copied until the
    caller reads it.  ``batch_dims`` leading dims (a stack of per-client
    rows) are kept in front."""
    path = name.split(".")
    module, leaf = (path[-2] if len(path) > 1 else ""), path[-1]
    kind, lead = _kind(module), tuple(t.shape[:batch_dims])
    if module in _QKV + ("out",) and leaf in ("weight", "bias") \
            and num_heads is None:
        raise ValueError(f"{name}: attention weights need num_heads")
    if leaf == "weight" and kind == "Embed":
        return (*path[:-1], "embedding"), t
    if leaf == "weight" and kind in ("LayerNorm", "GroupNorm"):
        return (*path[:-1], "scale"), t
    if leaf == "weight":
        if module in _QKV:         # (H·hd, D) -> (D, H, hd)
            t = t.transpose(-1, -2).reshape(*lead, t.shape[-1], num_heads,
                                            -1)
        elif module == "out":      # (D, H·hd) -> (H, hd, D)
            t = t.transpose(-1, -2).reshape(*lead, num_heads, -1,
                                            t.shape[-2])
        else:                      # (out, in, *k) -> (*k, in, out)
            b, n = batch_dims, t.ndim
            t = t.permute(*range(b), *range(b + 2, n), b + 1, b)
        return (*path[:-1], "kernel"), t
    if leaf == "bias" and module in _QKV:
        return tuple(path), t.reshape(*lead, num_heads, -1)
    return tuple(path), t


def nest(pairs) -> dict:
    """A nested dict from ``(path tuple, value)`` pairs."""
    out: dict = {}
    for path, value in pairs:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def flax_to_state_dict(flax_params: Any) -> dict[str, torch.Tensor]:
    """flax params -> the port's ``state_dict`` (CPU tensors)."""
    sd = {}
    for path, a in _leaves(flax_params):
        name, t = leaf_to_torch(path, torch.from_numpy(np.array(a, copy=True)))
        sd[name] = t.contiguous()
    return sd


def flax_layout(name: str, shape: tuple,
                num_heads: Optional[int] = None) -> tuple:
    """Where the port's parameter ``name`` of torch ``shape`` lives in
    flax, without touching data: ``(flax path, flax shape, to_torch)``,
    ``to_torch[f]`` being the torch dim that flax axis ``f`` maps onto
    (None for a flax axis folded into a torch dim after its leading
    one, the head size of a query kernel)."""
    path = name.split(".")
    module, leaf = (path[-2] if len(path) > 1 else ""), path[-1]
    kind, n = _kind(module), len(shape)
    if module in _QKV + ("out",) and leaf in ("weight", "bias") \
            and num_heads is None:
        raise ValueError(f"{name}: attention weights need num_heads")
    if leaf == "weight" and kind == "Embed":
        return (*path[:-1], "embedding"), shape, list(range(n))
    if leaf == "weight" and kind in ("LayerNorm", "GroupNorm"):
        return (*path[:-1], "scale"), shape, list(range(n))
    if leaf == "weight":
        kernel = (*path[:-1], "kernel")
        if module in _QKV:
            return kernel, (shape[1], num_heads, shape[0] // num_heads), \
                [1, 0, None]
        if module == "out":
            return kernel, (num_heads, shape[1] // num_heads, shape[0]), \
                [1, None, 0]
        perm = (n - 1, n - 2, *range(n - 2))      # torch dim i <- flax perm[i]
        fshape = [0] * n
        for i, f in enumerate(perm):
            fshape[f] = shape[i]
        return kernel, tuple(fshape), [perm.index(f) for f in range(n)]
    if leaf == "bias" and module in _QKV:
        return tuple(path), (num_heads, shape[0] // num_heads), [0, None]
    return tuple(path), shape, list(range(n))


def state_dict_to_flax(state_dict: dict[str, torch.Tensor],
                       num_heads: Optional[int] = None) -> dict:
    """The port's ``state_dict`` -> flax params (numpy arrays);
    ``num_heads`` is needed where there is attention."""
    out: dict = {}
    for key, t in state_dict.items():
        a = t.detach().cpu().numpy()
        path = key.split(".")
        module, leaf = (path[-2] if len(path) > 1 else ""), path[-1]
        kind = _kind(module)
        if module in _QKV + ("out",) and num_heads is None:
            raise ValueError(f"{key}: attention weights need num_heads")
        if leaf == "weight" and kind == "Embed":
            layer = {"embedding": a}
        elif leaf == "weight" and kind in ("LayerNorm", "GroupNorm"):
            layer = {"scale": a}
        elif leaf == "weight":
            if module in _QKV:
                a = a.T.reshape(a.shape[1], num_heads, -1)
            elif module == "out":
                a = a.T.reshape(num_heads, -1, a.shape[0])
            else:
                a = np.transpose(a, (*range(2, a.ndim), 1, 0))
            layer = {"kernel": a}
        elif leaf == "bias" and module in _QKV:
            layer = {"bias": a.reshape(num_heads, -1)}
        else:
            layer = {leaf: a}
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node.update({k: np.ascontiguousarray(v) for k, v in layer.items()})
    return out
