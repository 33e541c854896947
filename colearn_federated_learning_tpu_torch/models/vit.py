"""ViT-B/16 — BASELINE config #5 ("Cross-silo ViT-B/16 on FEMNIST"), the
counterpart of the JAX package's ``models/vit.py``.

Pre-LN vision transformer: a conv patch embedding (``SAME`` padding, the
patch shrinking until there are ≥ 4 patches per side: FEMNIST's 28 × 28
takes p = 4, so 49 patches and a class token, L = 50), tokens in
row-major (h', w') order, a zero-initialised class token, N(0, 0.02)
position embeddings, tanh-GELU MLPs, a final LayerNorm in the dtype and an
f32 head on the class token.  Attention is ``MultiHeadAttention`` with no
key mask, so ``attn_impl="flash"`` runs kernels K1–K3.  With ``remat``
every block runs under activation checkpointing (``layers.run_block``);
under tensor parallelism the blocks run on their local heads and hidden
units (``parallel/tp.py``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from colearn_federated_learning_tpu_torch.models.attention import (
    MultiHeadAttention,
)
from colearn_federated_learning_tpu_torch.models.layers import (
    conv,
    flax_init_,
    layer_norm,
    ln,
    mlp,
    run_block,
)


def patch_size_for(height: int, patch_size: int) -> int:
    """The patch, halved until there are at least 4 patches per side."""
    p = patch_size
    while p > 1 and height // p < 4:
        p //= 2
    return p


class ViTBlock(nn.Module):
    TP_KEY = "Dense_0.weight"

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "dense"):
        super().__init__()
        self.dtype = dtype
        self.LayerNorm_0 = ln(embed_dim)
        self.MultiHeadAttention_0 = MultiHeadAttention(
            embed_dim, num_heads, dtype=dtype, impl=attn_impl)
        self.LayerNorm_1 = ln(embed_dim)
        self.Dense_0 = nn.Linear(embed_dim, embed_dim * mlp_ratio)
        self.Dense_1 = nn.Linear(embed_dim * mlp_ratio, embed_dim)
        self.tp = None

    def forward(self, x):
        dt = self.dtype
        x = x + self.MultiHeadAttention_0(layer_norm(x, self.LayerNorm_0, dt))
        return x + mlp(layer_norm(x, self.LayerNorm_1, dt), self.Dense_0,
                       self.Dense_1, dt, self.tp)


class ViT(nn.Module):
    def __init__(self, input_shape: tuple[int, ...] = (28, 28, 1),
                 num_classes: int = 62, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, patch_size: int = 16,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "dense",
                 remat: bool = False):
        super().__init__()
        H, W, C = input_shape
        self.dtype, self.depth, self.embed_dim = dtype, depth, embed_dim
        self.remat = remat
        self.patch = p = patch_size_for(H, patch_size)
        tokens = -(-H // p) * -(-W // p) + 1
        self.Conv_0 = nn.Conv2d(C, embed_dim, p)
        self.cls = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, embed_dim))
        for i in range(depth):
            self.add_module(f"ViTBlock_{i}", ViTBlock(
                embed_dim, num_heads, dtype=dtype, attn_impl=attn_impl))
        self.LayerNorm_0 = ln(embed_dim)
        self.Dense_0 = nn.Linear(embed_dim, num_classes)

    def forward(self, x):
        """``x``: (B, H, W, C) images -> (B, num_classes) f32 logits."""
        B, dt = x.shape[0], self.dtype
        x = conv(x.to(dt).permute(0, 3, 1, 2), self.Conv_0, dt, stride=self.patch)
        x = x.flatten(2).transpose(1, 2)                      # (B, N, D)
        x = torch.cat([self.cls.to(dt).expand(B, 1, self.embed_dim), x], 1)
        x = x + self.pos_embed.to(dt)
        for i in range(self.depth):
            x = run_block(getattr(self, f"ViTBlock_{i}"), self.remat, x)
        x = layer_norm(x, self.LayerNorm_0, dt)
        return F.linear(x[:, 0].float(), self.Dense_0.weight, self.Dense_0.bias)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's default init; ``cls`` zeros, ``pos_embed`` N(0, 0.02)."""
        flax_init_(self, generator)
        self.cls.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
