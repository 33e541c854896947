"""Small conv net — BASELINE config #2 ("FedAvg CNN on CIFAR-10"), the
counterpart of the JAX package's ``models/cnn.py``.

Three stages of (3×3 conv, GroupNorm(min(32, ch)), ReLU) × 2 at widths
w, 2w, 4w, each followed by a 2×2 max-pool while H ≥ 2; spatial mean in
f32 rounded to the dtype, Dense head in the dtype, f32 logits.  The batch
arrives NHWC, as the engine keeps the shards; its channels-first view and
the channels-last conv weights are what cuDNN's NHWC kernels take.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from colearn_federated_learning_tpu_torch.models.layers import (
    conv,
    flax_init_,
    gn,
    group_norm,
    linear,
)


def space_to_depth(x, block: int = 2):
    """(N, H, W, C) -> (N, H/b, W/b, C·b²), channels in flax's (bh, bw, c)
    order."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // block, w // block,
                                               c * block * block)


class CNN(nn.Module):
    def __init__(self, input_shape: tuple[int, ...] = (32, 32, 3),
                 num_classes: int = 10, width: int = 64,
                 dtype: torch.dtype = torch.float32, stem: str = "conv",
                 norm: str = "group"):
        super().__init__()
        if stem not in ("conv", "space_to_depth"):
            raise ValueError(f"unknown stem {stem!r}")
        if norm not in ("group", "none"):
            raise ValueError(f"unknown norm {norm!r}")
        self.dtype, self.stem, self.norm = dtype, stem, norm
        cin = input_shape[-1] * (4 if stem == "space_to_depth" else 1)
        i = 0
        for mult in (1, 2, 4):
            ch = width * mult
            for _ in range(2):
                self.add_module(f"Conv_{i}", nn.Conv2d(cin, ch, 3))
                if norm == "group":
                    self.add_module(f"GroupNorm_{i}", gn(ch, min(32, ch)))
                cin, i = ch, i + 1
        self.Dense_0 = nn.Linear(cin, num_classes)
        self.to(memory_format=torch.channels_last)

    def forward(self, x):
        """``x``: (B, H, W, C) images -> (B, num_classes) f32 logits."""
        x = x.to(self.dtype)
        if self.stem == "space_to_depth":
            x = space_to_depth(x, 2)
        x = x.permute(0, 3, 1, 2)                 # channels-last NCHW view
        for i in range(6):
            x = conv(x, getattr(self, f"Conv_{i}"), self.dtype)
            if self.norm == "group":
                x = group_norm(x, getattr(self, f"GroupNorm_{i}"), self.dtype)
            x = F.relu(x)
            # flax pools while H (axis 1 of NHWC) is at least 2.
            if i % 2 == 1 and x.shape[2] >= 2:
                x = F.max_pool2d(x, 2, 2)
        x = x.float().mean((2, 3)).to(self.dtype)
        return linear(x, self.Dense_0, self.dtype).float()

    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init_(self, generator)
