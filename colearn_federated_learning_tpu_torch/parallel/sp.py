"""Sequence-parallel model execution outside the federated engine.

The counterpart of the JAX package's ``parallel/sp.py``.  A model built
with a sequence group (``models.registry.build_model(..., seq_group=)``)
computes on sequence shards: ring or Ulysses attention over the group,
position embeddings at the shard's global offset, and a pooling sum
finished over the group.  These helpers take the FULL (B, L) token batch
on every rank and run the model on this rank's (B, L/S) shard.
"""

from __future__ import annotations

from typing import Callable

import torch

from colearn_federated_learning_tpu_torch.parallel import collectives
from colearn_federated_learning_tpu_torch.parallel import mesh as mesh_lib


def _seq_axis(mesh, seq_axis: str):
    if seq_axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(
            f"mesh {tuple(mesh.mesh_dim_names)} has no {seq_axis!r} axis")
    return mesh_lib.axis(mesh, seq_axis)


def _local(ids: torch.Tensor, ax) -> torch.Tensor:
    return ids.chunk(ax.size, dim=1)[ax.index]


def make_sp_apply(model, mesh, seq_axis: str = "seq") -> Callable:
    """``fn(ids) -> logits`` running ``model`` sequence-parallel on the
    full (B, L) ``ids``; the logits are the same on every rank of the
    axis (the pooling sum is all-reduced)."""
    ax = _seq_axis(mesh, seq_axis)

    def apply(ids):
        with torch.no_grad():
            return model(_local(ids, ax))

    return apply


def make_sp_loss_grad(model, loss_fn: Callable, mesh,
                      seq_axis: str = "seq") -> Callable:
    """``fn(ids, labels) -> (loss, grads)`` sequence-parallel: the grads
    (in ``model.parameters()`` order) are averaged over the axis in one
    flat all-reduce; with the model's ``psum_for_grad_pmean`` pooling
    this is the exact full-sequence gradient, the same on every rank."""
    ax = _seq_axis(mesh, seq_axis)
    params = list(model.parameters())

    def loss_grad(ids, labels):
        loss = loss_fn(model(_local(ids, ax)), labels)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), collectives.mean_grads(grads, ax.group)

    return loss_grad
