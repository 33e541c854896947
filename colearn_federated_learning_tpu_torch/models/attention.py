"""Multi-head attention with a pluggable core.

The q/k/v/out projections are plain linear layers, identical across
cores, so the parameters do not depend on which core computes the
softmax:

- ``dense``: the reference einsum core (``ops.attention.dense_attention``);
- ``flash``: the CUDA flash-attention kernels (``ops.attention``), their
  plain versions on the CPU;
- ``ring``, ``ulysses``: sequence parallelism over ``seq_group`` (set by
  ``models.registry.build_model``), ``parallel/ring.py`` and
  ``parallel/ulysses.py``; the module then runs on a sequence shard.

Under tensor parallelism (``parallel/tp.py`` sets ``tp``) this rank holds
the q/k/v rows and the ``out`` columns of its heads: the input's gradient
is all-reduced over the model group (column parallel), the ``out``
product is all-reduced forward and its bias added once after the sum (row
parallel).  Parameters are f32 masters cast to the compute dtype in the
forward pass, as flax ``dtype=`` does.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from colearn_federated_learning_tpu_torch.models.layers import linear
from colearn_federated_learning_tpu_torch.ops import attention as attn_ops

ATTN_IMPLS = ("dense", "flash", "ring", "ulysses")


class MultiHeadAttention(nn.Module):
    TP_KEY = "query.weight"

    def __init__(self, embed_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, impl: str = "dense"):
        super().__init__()
        if impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn impl {impl!r}; use {ATTN_IMPLS}")
        if embed_dim % num_heads:
            raise ValueError(
                f"embed dim {embed_dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.dtype = dtype
        self.impl = impl
        self.seq_group = None
        self.tp = None
        self.query = nn.Linear(embed_dim, embed_dim)
        self.key = nn.Linear(embed_dim, embed_dim)
        self.value = nn.Linear(embed_dim, embed_dim)
        self.out = nn.Linear(embed_dim, embed_dim)

    def _core(self, q, k, v, kv_mask):
        if self.impl == "flash":
            return attn_ops.flash_attention(q, k, v, kv_mask)
        if self.impl == "dense":
            return attn_ops.dense_attention(q, k, v, kv_mask)
        if self.seq_group is None:
            raise ValueError(f"impl={self.impl!r} needs a sequence group "
                             "(a mesh axis)")
        if self.impl == "ring":
            from colearn_federated_learning_tpu_torch.parallel.ring import (
                ring_attention)

            return ring_attention(q, k, v, kv_mask, group=self.seq_group)
        from colearn_federated_learning_tpu_torch.parallel.ulysses import (
            ulysses_attention)

        return ulysses_attention(q, k, v, kv_mask, group=self.seq_group)

    def forward(self, x, kv_mask=None):
        """x: (B, L, D); kv_mask: optional (B, L) bool, False = padding."""
        B, L, D = x.shape
        hd = D // self.num_heads
        heads = self.num_heads // (self.tp.size if self.tp else 1)
        if self.tp:
            from colearn_federated_learning_tpu_torch.parallel import (
                collectives)

            x = collectives.copy_to_group(x, self.tp.group)
        q, k, v = (linear(x, layer, self.dtype).view(B, L, heads, hd)
                   for layer in (self.query, self.key, self.value))
        o = self._core(q, k, v, kv_mask).reshape(B, L, heads * hd)
        if not self.tp:
            return linear(o, self.out, self.dtype)
        y = F.linear(o.to(self.dtype), self.out.weight.to(self.dtype))
        y = collectives.reduce_from_group(y, self.tp.group)
        return y + self.out.bias.to(self.dtype)
