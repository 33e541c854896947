"""Temporal convolutional network for IoT traffic windows, the counterpart
of the JAX package's ``models/tcn.py``.

Residual blocks of two dilated ``SAME`` 1-D convs (dilation 2^i in block
i), each followed by GroupNorm(min(8, ch)); a 1×1 conv on the residual
only where the channel count changes; mean over time in f32 and a Dense
head in f32.  Input (B, T, F) windows, taken as a channels-first view.
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
)


class TCNBlock(nn.Module):
    def __init__(self, cin: int, channels: int, dilation: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dilation, self.dtype = dilation, dtype
        groups = min(8, channels)
        self.Conv_0 = nn.Conv1d(cin, channels, 3)
        self.GroupNorm_0 = gn(channels, groups)
        self.Conv_1 = nn.Conv1d(channels, channels, 3)
        self.GroupNorm_1 = gn(channels, groups)
        if cin != channels:
            self.Conv_2 = nn.Conv1d(cin, channels, 1)

    def forward(self, x):
        """x: (B, C, T)."""
        dt, d = self.dtype, self.dilation
        h = F.relu(group_norm(conv(x, self.Conv_0, dt, dilation=d),
                              self.GroupNorm_0, dt))
        h = group_norm(conv(h, self.Conv_1, dt, dilation=d),
                       self.GroupNorm_1, dt)
        if hasattr(self, "Conv_2"):
            x = conv(x, self.Conv_2, dt)
        return F.relu(x + h)


class TCN(nn.Module):
    def __init__(self, input_shape: tuple[int, ...] = (64, 16),
                 num_classes: int = 8, width: int = 64, depth: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.depth = dtype, depth
        cin = input_shape[-1]
        for i in range(depth):
            self.add_module(f"TCNBlock_{i}",
                            TCNBlock(cin, width, 2 ** i, dtype=dtype))
            cin = width
        self.Dense_0 = nn.Linear(width, num_classes)

    def forward(self, x):
        """``x``: (B, T, F) windows -> (B, num_classes) f32 logits."""
        x = x.to(self.dtype).transpose(1, 2)
        for i in range(self.depth):
            x = getattr(self, f"TCNBlock_{i}")(x)
        pooled = x.float().mean(2)
        return F.linear(pooled, self.Dense_0.weight, self.Dense_0.bias)

    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init_(self, generator)
