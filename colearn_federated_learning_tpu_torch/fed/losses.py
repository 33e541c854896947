"""Loss and metric functions (float32 regardless of the model's dtype)."""

from __future__ import annotations

import torch
from torch.nn import functional as F


def softmax_cross_entropy(logits, labels) -> torch.Tensor:
    """Mean cross-entropy; logits (B, K), labels (B,) int."""
    return F.cross_entropy(logits.float(), labels.long())

