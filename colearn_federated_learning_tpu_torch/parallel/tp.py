"""Tensor parallelism: parameter partition rules over a ``model`` axis.

The counterpart of the JAX package's ``parallel/tp.py``.  The rules are
its table (``partition.TRANSFORMER_RULES``):

==========================================  =======================  ==========
leaf (flax path suffix, flax shape)         role                     spec
==========================================  =======================  ==========
``{query,key,value}/kernel`` (D, H, hd)     column (head) parallel   (·, model, ·)
``{query,key,value}/bias``   (H, hd)        column bias              (model, ·)
``out/kernel``               (H, hd, D)     row parallel             (model, ·, ·)
``Dense_0/kernel`` in a block (D, F)        MLP up projection        (·, model)
``Dense_0/bias``             (F,)           MLP up bias              (model,)
``Dense_1/kernel`` in a block (F, D)        MLP down projection      (model, ·)
``experts*`` leading dim E                  expert parallel          (model, ···)
``embedding`` (V, D)                        vocab parallel           (model, ·)
everything else                             replicated               ()
==========================================  =======================  ==========

Where JAX leaves the collectives to the GSPMD partitioner, here each rank
holds its slices of the sharded leaves and the modules run the
tensor-parallel forward explicitly (``models/``: Megatron's column/row
pair, the masked vocab lookup, the expert-sharded combine), with the
gradient conventions of ``parallel/collectives.py``.  A module whose
wide dimension does not divide by the axis size stays replicated, as its
leaves do.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from colearn_federated_learning_tpu_torch.parallel import mesh as mesh_lib
from colearn_federated_learning_tpu_torch.parallel import partition


def param_specs(params: Any, axis: str, size: int) -> Any:
    """Nested dict of spec tuples for flax-layout ``params``."""
    return partition.match_partition_rules(
        partition.TRANSFORMER_RULES, params, axis=axis, sizes={axis: size})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def sharded_fraction(params: Any, axis: str, size: int) -> float:
    """Fraction of parameter COUNT whose leaves are sharded over ``axis``."""
    specs = list(_leaves(param_specs(params, axis, size)))
    tot = sharded = 0
    for w, s in zip(_leaves(params), specs):
        n = int(np.prod(np.shape(w))) if np.shape(w) else 1
        tot += n
        if any(e == axis for e in s):
            sharded += n
    return sharded / max(tot, 1)


def num_heads_of(model: torch.nn.Module):
    """The attention head count of ``model`` (None without attention)."""
    return next((m.num_heads for m in model.modules()
                 if hasattr(m, "num_heads")), None)


def shard_dims(model: torch.nn.Module, axis: str, size: int) -> dict:
    """{parameter name: torch dim sharded over ``axis`` or None}."""
    return partition.torch_shard_dims(
        {n: tuple(p.shape) for n, p in model.named_parameters()},
        partition.TRANSFORMER_RULES, axis, size, num_heads_of(model))


@torch.no_grad()
def shard_params(model: torch.nn.Module, mesh, axis: str = "model") -> dict:
    """Keep this rank's slice of every sharded parameter of ``model`` (in
    place) and switch on the tensor-parallel forward of each module whose
    leaves were sharded (a module names the parameter that decides in
    ``TP_KEY``).  Returns :func:`shard_dims`."""
    ax = mesh_lib.axis(mesh, axis)
    dims = shard_dims(model, axis, ax.size)
    for name, p in model.named_parameters():
        if dims[name] is not None:
            p.data = partition.shard(p.data, dims[name], ax.size,
                                     ax.index).clone()
    for prefix, module in model.named_modules():
        key = getattr(module, "TP_KEY", None)
        full = f"{prefix}.{key}" if prefix else key
        if key is not None and dims.get(full) is not None:
            module.tp = ax
    return dims


def gather_params(params: dict, dims: dict, ax) -> dict:
    """The full parameters from this rank's slices (an all-gather over
    the axis per sharded parameter)."""
    _, gather = partition.make_shard_and_gather_fns(dims, ax)
    return {n: gather[n](t) for n, t in params.items()}
