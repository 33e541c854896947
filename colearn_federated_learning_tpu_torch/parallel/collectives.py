"""Collectives of the mesh path, counted, with the gradient conventions
of sequence and tensor parallelism.

Every collective the port makes goes through this module, and each call
adds one to ``counts[kind]`` (``all_reduce``, ``broadcast``,
``all_gather``, ``all_to_all``, ``ring_shift``, ``barrier``), so a caller
can hold a round to the exact calls its path implies.  A group is always
a real process group: at
world size 1 the calls still run (the mesh path never skips its
collectives).

Gradient conventions (the counterpart of the JAX package's
``parallel/collectives.py`` and of the TP collectives GSPMD inserts):

- :func:`psum_for_grad_pmean`: an all-reduce whose backward is also an
  all-reduce.  Under SP a model has a TOKEN path (grads are partial sums
  over the sequence shards) and a REPLICATED path after the pooling sum
  (grads already full); with this at the pooling boundary and a plain
  mean of ALL grads over the axis (:func:`mean_grads`), both come out
  exact: (partial · S) / S summed = full, and full · S / S = full.
- :func:`copy_to_group` / :func:`reduce_from_group`: Megatron's pair for
  tensor parallelism.  The first is the identity forward and an
  all-reduce backward (before a column-parallel product, whose input
  grads are partial per rank); the second an all-reduce forward and the
  identity backward (after a row-parallel product, whose outputs are
  partial per rank).  Replicated parameters then get full, identical
  grads on every rank of the model axis.
- :func:`ring_shift`: send to the next rank of the ring and receive from
  the previous one; its backward sends the gradient the opposite way.
- :func:`all_to_all`: JAX's tiled ``lax.all_to_all``; its backward is the
  all-to-all with the split and concat axes swapped.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

counts: Counter = Counter()


def reset_counts() -> None:
    counts.clear()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``; returns ``t``."""
    counts["all_reduce"] += 1
    dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def broadcast(t: torch.Tensor, group, index: int = 0) -> torch.Tensor:
    """In-place broadcast of ``t`` from the rank at ``index`` of ``group``
    to every rank of it; returns ``t``."""
    counts["broadcast"] += 1
    dist.broadcast(t, src=dist.get_global_rank(group, index), group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Concatenation over ``group`` of every rank's ``t`` along dim 0, in
    rank order (JAX's tiled ``all_gather``)."""
    counts["all_gather"] += 1
    size = dist.get_world_size(group)
    t = t.contiguous()
    out = t.new_empty((size * t.shape[0],) + tuple(t.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, t, group=group)
    return out


def barrier(group, device: torch.device) -> None:
    """Wait until every rank of ``group`` has reached this call (on NCCL,
    on the rank's own card)."""
    counts["barrier"] += 1
    kw = {"device_ids": [device.index]} if device.type == "cuda" else {}
    dist.barrier(group=group, **kw)


def group_rank(group) -> int:
    return dist.get_group_rank(group, dist.get_rank())


def _all_to_all(x: torch.Tensor, group, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    counts["all_to_all"] += 1
    size = dist.get_world_size(group)
    inp = torch.stack(x.chunk(size, dim=split_dim)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), dim=concat_dim)


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    counts["ring_shift"] += 1
    size = dist.get_world_size(group)
    ranks = dist.get_process_group_ranks(group)
    me = group_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(me + step) % size], group),
           dist.P2POp(dist.irecv, out, ranks[(me - step) % size], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PsumForGradPmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        # g is replicated over the axis, so this is S · g.
        return all_reduce(g.clone(), ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _all_to_all(g, group, concat_dim, split_dim), None, None, None


def psum_for_grad_pmean(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) whose backward is also a sum over ``group``."""
    return _PsumForGradPmean.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduced gradient backward."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduced forward, identity backward."""
    return _ReduceFromGroup.apply(x, group)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Rank i's ``x`` arrives at rank i + 1 of ``group`` (mod its size)."""
    return _RingShift.apply(x, group)


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Split ``x`` into ``size`` chunks along ``split_dim``, send chunk j
    to rank j, and concatenate what arrives along ``concat_dim`` in rank
    order (JAX's ``lax.all_to_all(..., tiled=True)``); differentiable."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def flat_all_reduce(tensors: list, group) -> list:
    """Sum a list of tensors over ``group`` as ONE flat bucket (one
    collective); returns new tensors of the inputs' shapes and dtype."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce(flat, group)
    return [v.view_as(t) for v, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)]


def mean_grads(grads, group) -> list:
    """Mean of ``grads`` over ``group`` in one flat all-reduce (the SP
    trainer's per-step gradient pmean)."""
    out = flat_all_reduce(list(grads), group)
    size = dist.get_world_size(group)
    torch._foreach_div_(out, float(size))
    return out
