"""Two-layer MLP — BASELINE config #1 ("FedAvg 2-layer MLP on MNIST"), the
counterpart of the JAX package's ``models/mlp.py``."""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from colearn_federated_learning_tpu_torch.models.layers import flax_init_, linear


class MLP(nn.Module):
    def __init__(self, input_shape: tuple[int, ...] = (28, 28, 1),
                 num_classes: int = 10, hidden_dim: int = 200, depth: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.depth = dtype, depth
        dims = [math.prod(input_shape)] + [hidden_dim] * depth + [num_classes]
        for i in range(depth + 1):
            self.add_module(f"Dense_{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        """``x``: (B, *input_shape) as stored (NHWC for images) -> f32
        logits.  Flattened as it arrives, so ``Dense_0``'s rows keep
        flax's order."""
        x = x.reshape(x.shape[0], -1)
        for i in range(self.depth):
            x = F.relu(linear(x, getattr(self, f"Dense_{i}"), self.dtype))
        return linear(x, getattr(self, f"Dense_{self.depth}"),
                      self.dtype).float()

    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init_(self, generator)
