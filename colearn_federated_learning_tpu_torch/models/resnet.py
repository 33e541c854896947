"""ResNet-18, CIFAR variant — BASELINE config #3 ("FedProx ResNet-18 on
CIFAR-100"), the counterpart of the JAX package's ``models/resnet.py``.

3×3 stem with no max-pool, four stages of two basic blocks at widths w,
2w, 4w, 8w (stride 2 at the first block of stages 2–4), GroupNorm
(min(32, ch)) in place of BatchNorm, bias-free convs, and a 1×1 stride-2
projection (+ GroupNorm) on the shortcut where the shapes differ.  A
stride-2 3×3 ``SAME`` conv on an even size pads (0, 1) (``layers.conv``).
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

STAGE_SIZES = (2, 2, 2, 2)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        groups = min(32, channels)
        self.Conv_0 = nn.Conv2d(cin, channels, 3, bias=False)
        self.GroupNorm_0 = gn(channels, groups)
        self.Conv_1 = nn.Conv2d(channels, channels, 3, bias=False)
        self.GroupNorm_1 = gn(channels, groups)
        # flax projects when the residual's shape differs from the output's.
        if stride != 1 or cin != channels:
            self.Conv_2 = nn.Conv2d(cin, channels, 1, bias=False)
            self.GroupNorm_2 = gn(channels, groups)

    def forward(self, x):
        dt = self.dtype
        y = conv(x, self.Conv_0, dt, stride=self.stride)
        y = F.relu(group_norm(y, self.GroupNorm_0, dt))
        y = group_norm(conv(y, self.Conv_1, dt), self.GroupNorm_1, dt)
        if hasattr(self, "Conv_2"):
            x = group_norm(conv(x, self.Conv_2, dt, stride=self.stride),
                           self.GroupNorm_2, dt)
        return F.relu(y + x)


class ResNet18(nn.Module):
    def __init__(self, input_shape: tuple[int, ...] = (32, 32, 3),
                 num_classes: int = 100, width: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(input_shape[-1], width, 3, bias=False)
        self.GroupNorm_0 = gn(width, min(32, width))
        cin, ch, n = width, width, 0
        for stage, blocks in enumerate(STAGE_SIZES):
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                self.add_module(f"BasicBlock_{n}",
                                BasicBlock(cin, ch, stride, dtype))
                cin, n = ch, n + 1
            ch *= 2
        self.num_blocks = n
        self.Dense_0 = nn.Linear(cin, num_classes)
        self.to(memory_format=torch.channels_last)

    def forward(self, x):
        """``x``: (B, H, W, C) images -> (B, num_classes) f32 logits."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)   # channels-last NCHW view
        x = conv(x, self.Conv_0, self.dtype)
        x = F.relu(group_norm(x, self.GroupNorm_0, self.dtype))
        for i in range(self.num_blocks):
            x = getattr(self, f"BasicBlock_{i}")(x)
        x = x.float().mean((2, 3)).to(self.dtype)
        return linear(x, self.Dense_0, self.dtype).float()

    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init_(self, generator)

