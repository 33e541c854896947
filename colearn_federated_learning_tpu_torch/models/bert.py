"""BERT-style text classifier — BASELINE config #4 ("FedAvg BERT-base on
AG-News, 50 text clients"), the counterpart of the JAX package's
``models/bert.py``.

Token + learned position embeddings, post-LN transformer blocks, masked
mean pooling, classification head.  Token id 0 is padding and is masked
out of both attention and pooling.  Numerics follow flax: LayerNorm eps
1e-6 with f32 statistics, tanh-approximate GELU, pooling and head in f32.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from colearn_federated_learning_tpu_torch.models.attention import (
    MultiHeadAttention,
    linear,
)

LN_EPS = 1e-6


def layer_norm(x, ln: nn.LayerNorm, dtype: torch.dtype):
    """flax ``LayerNorm(dtype=...)``: statistics in f32, output in dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(dtype)


class TransformerBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "dense"):
        super().__init__()
        self.dtype = dtype
        self.attn = MultiHeadAttention(embed_dim, num_heads, dtype=dtype,
                                       impl=attn_impl)
        self.ln1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.mlp_in = nn.Linear(embed_dim, embed_dim * mlp_ratio)
        self.mlp_out = nn.Linear(embed_dim * mlp_ratio, embed_dim)
        self.ln2 = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x, pad_mask):
        # Post-LN (BERT-style): sublayer -> residual -> LayerNorm.
        x = layer_norm(x + self.attn(x, pad_mask), self.ln1, self.dtype)
        h = F.gelu(linear(x, self.mlp_in, self.dtype), approximate="tanh")
        h = linear(h, self.mlp_out, self.dtype)
        return layer_norm(x + h, self.ln2, self.dtype)


class BertClassifier(nn.Module):
    def __init__(self, num_classes: int = 4, vocab_size: int = 30522,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 max_len: int = 128, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "dense"):
        super().__init__()
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, max_len, embed_dim))
        self.ln_embed = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.blocks = nn.ModuleList(
            TransformerBlock(embed_dim, num_heads, dtype=dtype,
                             attn_impl=attn_impl)
            for _ in range(depth))
        self.head = nn.Linear(embed_dim, num_classes)

    def forward(self, ids):
        """``ids``: (B, L) integer token ids -> (B, num_classes) f32 logits."""
        L = ids.shape[1]
        pad_mask = ids != 0
        tok = F.embedding(ids, self.embed.weight).to(self.dtype)
        x = tok + self.pos_embed[:, :L].to(self.dtype)
        x = layer_norm(x, self.ln_embed, self.dtype)
        for block in self.blocks:
            x = block(x, pad_mask)
        # Masked mean pooling and the head in f32.
        m = pad_mask[..., None].float()
        pooled = (x.float() * m).sum(1) / m.sum(1).clamp_min(1.0)
        return F.linear(pooled, self.head.weight, self.head.bias)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's default init, drawn from ``generator``: lecun-normal
        (truncated) kernels, zero biases, N(0, 1/width) embeddings (flax's
        fan-in of a (vocab, width) table is its width), N(0, 0.02) position
        embeddings, unit LayerNorm scales."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                _lecun_normal_(module.weight, module.in_features, generator)
                nn.init.zeros_(module.bias)
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
        width = self.embed.embedding_dim
        self.embed.weight.normal_(0.0, 1.0 / math.sqrt(width),
                                  generator=generator)
        self.pos_embed.normal_(0.0, 0.02, generator=generator)


def _lecun_normal_(weight, fan_in: int, generator: torch.Generator) -> None:
    # variance_scaling(1, fan_in, truncated_normal): the std of a unit
    # normal truncated to [-2, 2] is 0.8796..., hence the correction.
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
