"""BERT-style text classifier — BASELINE config #4 ("FedAvg BERT-base on
AG-News, 50 text clients"), the counterpart of the JAX package's
``models/bert.py``; with ``num_experts > 0`` it is ``moe_bert``.

Token + learned position embeddings, post-LN transformer blocks, masked
mean pooling, classification head.  Token id 0 is padding and is masked
out of attention, pooling and MoE routing.  Numerics follow flax:
LayerNorm eps 1e-6 with f32 statistics, tanh-approximate GELU, pooling
and head in f32.  Submodules carry their flax names (``Embed_0``,
``TransformerBlock_i``, ``MultiHeadAttention_0``, ...), so the parameter
names are the flax paths (``convert.py``).

- ``remat``: every block runs under activation checkpointing
  (``layers.run_block``); the parameter names do not change.
- Sequence parallelism (``seq_group``, with ``attn_impl`` ring or
  ulysses): the module runs on a (B, L/S) shard, position embeddings are
  sliced at the shard's global offset rank·L, and the masked-mean
  pooling's sums finish over the group (``psum_for_grad_pmean`` for the
  token sum, a plain all-reduce for the mask count), so the logits are
  the same on every rank of the group.
- Tensor parallelism (``tp`` on the modules, ``parallel/tp.py``): the
  vocab-sharded embedding is a masked lookup of this rank's rows and an
  all-reduce; attention, the block MLPs and the expert banks run on
  their local slices.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from colearn_federated_learning_tpu_torch.models.attention import (
    MultiHeadAttention,
)
from colearn_federated_learning_tpu_torch.models.layers import (
    flax_init_,
    layer_norm,
    ln,
    mlp,
    run_block,
)
from colearn_federated_learning_tpu_torch.models.moe import MoEFfn


class TransformerBlock(nn.Module):
    TP_KEY = "Dense_0.weight"

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "dense",
                 num_experts: int = 0):
        super().__init__()
        self.dtype = dtype
        self.MultiHeadAttention_0 = MultiHeadAttention(
            embed_dim, num_heads, dtype=dtype, impl=attn_impl)
        self.LayerNorm_0 = ln(embed_dim)
        if num_experts > 0:
            self.MoEFfn_0 = MoEFfn(embed_dim, num_experts, mlp_ratio,
                                   dtype=dtype)
        else:
            self.Dense_0 = nn.Linear(embed_dim, embed_dim * mlp_ratio)
            self.Dense_1 = nn.Linear(embed_dim * mlp_ratio, embed_dim)
        self.LayerNorm_1 = ln(embed_dim)
        self.tp = None

    def forward(self, x, pad_mask):
        # Post-LN (BERT-style): sublayer -> residual -> LayerNorm.
        x = layer_norm(x + self.MultiHeadAttention_0(x, pad_mask),
                       self.LayerNorm_0, self.dtype)
        if hasattr(self, "MoEFfn_0"):
            h = self.MoEFfn_0(x, token_mask=pad_mask)
        else:
            h = mlp(x, self.Dense_0, self.Dense_1, self.dtype, self.tp)
        return layer_norm(x + h, self.LayerNorm_1, self.dtype)


class BertClassifier(nn.Module):
    TP_KEY = "Embed_0.weight"

    def __init__(self, num_classes: int = 4, vocab_size: int = 30522,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 max_len: int = 128, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "dense", num_experts: int = 0,
                 remat: bool = False, seq_group=None):
        super().__init__()
        self.dtype = dtype
        self.depth = depth
        self.remat = remat
        self.seq_group = seq_group
        self.tp = None
        self.Embed_0 = nn.Embedding(vocab_size, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, max_len, embed_dim))
        self.LayerNorm_0 = ln(embed_dim)
        for i in range(depth):
            # MoE in every odd block (block 0 when depth == 1).
            moe_here = num_experts > 0 and (i % 2 == 1 or depth == 1)
            self.add_module(f"TransformerBlock_{i}", TransformerBlock(
                embed_dim, num_heads, dtype=dtype, attn_impl=attn_impl,
                num_experts=num_experts if moe_here else 0))
            getattr(self, f"TransformerBlock_{i}").MultiHeadAttention_0 \
                .seq_group = seq_group
        self.Dense_0 = nn.Linear(embed_dim, num_classes)

    def _embed(self, ids):
        """Token embeddings in the compute dtype; vocab-parallel under TP
        (ids outside this rank's rows look up zeros, then the sum over the
        model group fills them in, exactly)."""
        table = self.Embed_0.weight
        if self.tp is None:
            return F.embedding(ids, table).to(self.dtype)
        from colearn_federated_learning_tpu_torch.parallel import collectives

        rows = table.shape[0]
        local = ids - self.tp.index * rows
        inside = (local >= 0) & (local < rows)
        tok = F.embedding(local.clamp(0, rows - 1), table).to(self.dtype)
        tok = tok * inside[..., None].to(self.dtype)
        return collectives.reduce_from_group(tok, self.tp.group)

    def forward(self, ids):
        """``ids``: (B, L) integer token ids -> (B, num_classes) f32 logits."""
        L = ids.shape[1]
        sp = self.seq_group
        pad_mask = ids != 0
        if sp is not None:
            from colearn_federated_learning_tpu_torch.parallel import (
                collectives)

            offset = collectives.group_rank(sp) * L
            pos = self.pos_embed[:, offset:offset + L]
        else:
            pos = self.pos_embed[:, :L]
        x = self._embed(ids) + pos.to(self.dtype)
        x = layer_norm(x, self.LayerNorm_0, self.dtype)
        for i in range(self.depth):
            x = run_block(getattr(self, f"TransformerBlock_{i}"), self.remat,
                          x, pad_mask)
        # Masked mean pooling and the head in f32.
        m = pad_mask[..., None].float()
        sum_x, sum_m = (x.float() * m).sum(1), m.sum(1)
        if sp is not None:
            sum_x = collectives.psum_for_grad_pmean(sum_x, sp)
            sum_m = collectives.all_reduce(sum_m, sp)       # mask: no grad
        pooled = sum_x / sum_m.clamp_min(1.0)
        return F.linear(pooled, self.Dense_0.weight, self.Dense_0.bias)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's default init, drawn from ``generator``
        (``layers.flax_init_``), plus N(0, 1/width) embeddings (flax's
        fan-in of a (vocab, width) table is its width), N(0, 0.02) position
        embeddings and the MoE expert banks."""
        flax_init_(self, generator)
        for module in self.modules():
            if isinstance(module, MoEFfn):
                module.reset_experts(generator)
        width = self.Embed_0.embedding_dim
        self.Embed_0.weight.normal_(0.0, 1.0 / math.sqrt(width),
                                    generator=generator)
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
