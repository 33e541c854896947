"""Multi-head attention with a pluggable core.

The q/k/v/out projections are plain linear layers, identical across
cores, so the parameters do not depend on which core computes the
softmax:

- ``dense``: the reference einsum core (``ops.attention.dense_attention``);
- ``flash``: the CUDA flash-attention kernels (``ops.attention``), their
  plain versions on the CPU.

``ring`` and ``ulysses`` (sequence parallelism) are not ported yet; see
ROADMAP.md.  Parameters are f32 masters cast to the compute dtype in the
forward pass, as flax ``dtype=`` does.
"""

from __future__ import annotations

import torch
from torch import nn

from colearn_federated_learning_tpu_torch.models.layers import linear
from colearn_federated_learning_tpu_torch.ops import attention as attn_ops

ATTN_IMPLS = ("dense", "flash")


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, impl: str = "dense"):
        super().__init__()
        if impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attn_impl={impl!r} (sequence parallelism) is not ported "
                "yet; see ROADMAP.md Queue A")
        if impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn impl {impl!r}; use {ATTN_IMPLS}")
        if embed_dim % num_heads:
            raise ValueError(
                f"embed dim {embed_dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.dtype = dtype
        self.impl = impl
        self.query = nn.Linear(embed_dim, embed_dim)
        self.key = nn.Linear(embed_dim, embed_dim)
        self.value = nn.Linear(embed_dim, embed_dim)
        self.out = nn.Linear(embed_dim, embed_dim)

    def forward(self, x, kv_mask=None):
        """x: (B, L, D); kv_mask: optional (B, L) bool, False = padding."""
        B, L, D = x.shape
        shape = (B, L, self.num_heads, D // self.num_heads)
        q, k, v = (linear(x, layer, self.dtype).view(shape)
                   for layer in (self.query, self.key, self.value))
        core = (attn_ops.flash_attention if self.impl == "flash"
                else attn_ops.dense_attention)
        o = core(q, k, v, kv_mask)
        return linear(o.reshape(B, L, D), self.out, self.dtype)
