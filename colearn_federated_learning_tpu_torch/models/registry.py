"""Model registry: config name -> ``nn.Module`` (f32 parameters)."""

from __future__ import annotations

import torch

from colearn_federated_learning_tpu_torch.utils.config import ModelConfig
from colearn_federated_learning_tpu_torch.utils.device import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(cfg: ModelConfig, device=None,
                generator: torch.Generator | None = None):
    """The module for ``cfg`` on ``device`` (``None``: the card, raising
    without one); with ``generator`` its parameters are drawn from it
    (flax's default init), else they are left for the caller to load."""
    device = resolve_device(device)
    if cfg.remat:
        raise NotImplementedError("remat is not ported yet; see ROADMAP.md")
    if cfg.name != "bert":
        raise NotImplementedError(
            f"model {cfg.name!r} is not ported yet (only 'bert' is); see "
            "ROADMAP.md Queue A")
    from colearn_federated_learning_tpu_torch.models.bert import BertClassifier

    model = BertClassifier(num_classes=cfg.num_classes,
                           vocab_size=cfg.vocab_size, embed_dim=cfg.width,
                           depth=cfg.depth, num_heads=cfg.num_heads,
                           max_len=cfg.seq_len, dtype=DTYPES[cfg.dtype],
                           attn_impl=cfg.attn_impl)
    if generator is not None:
        model.reset_parameters(generator)
    return model.to(device)
