"""Model registry: config name -> ``nn.Module`` (f32 parameters)."""

from __future__ import annotations

import torch

from colearn_federated_learning_tpu_torch.utils.config import ModelConfig
from colearn_federated_learning_tpu_torch.utils.device import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TEXT_MODELS = ("bert", "moe_bert")


def _module(cfg: ModelConfig, input_shape, seq_group=None):
    dtype = DTYPES[cfg.dtype]
    if cfg.name not in TEXT_MODELS and input_shape is None:
        raise ValueError(f"model {cfg.name!r} needs the per-example "
                         "input_shape of its dataset")
    shape = tuple(input_shape or ())
    if cfg.name == "mlp":
        from colearn_federated_learning_tpu_torch.models.mlp import MLP

        return MLP(shape, cfg.num_classes, cfg.hidden_dim, cfg.depth, dtype)
    if cfg.name == "cnn":
        from colearn_federated_learning_tpu_torch.models.cnn import CNN

        return CNN(shape, cfg.num_classes, cfg.width, dtype, cfg.stem, cfg.norm)
    if cfg.name == "resnet18":
        from colearn_federated_learning_tpu_torch.models.resnet import ResNet18

        return ResNet18(shape, cfg.num_classes, cfg.width, dtype)
    if cfg.name == "tcn":
        from colearn_federated_learning_tpu_torch.models.tcn import TCN

        return TCN(shape, cfg.num_classes, cfg.width, cfg.depth, dtype)
    if cfg.name == "vit_b16":
        from colearn_federated_learning_tpu_torch.models.vit import ViT

        return ViT(shape, cfg.num_classes, cfg.width, cfg.depth, cfg.num_heads,
                   cfg.patch_size, dtype, cfg.attn_impl, cfg.remat)
    if cfg.name in TEXT_MODELS:
        from colearn_federated_learning_tpu_torch.models.bert import (
            BertClassifier,
        )

        return BertClassifier(
            num_classes=cfg.num_classes, vocab_size=cfg.vocab_size,
            embed_dim=cfg.width, depth=cfg.depth, num_heads=cfg.num_heads,
            max_len=cfg.seq_len, dtype=dtype, attn_impl=cfg.attn_impl,
            num_experts=cfg.num_experts if cfg.name == "moe_bert" else 0,
            remat=cfg.remat, seq_group=seq_group)
    raise KeyError(f"unknown model {cfg.name!r}")


def build_model(cfg: ModelConfig, device=None,
                generator: torch.Generator | None = None,
                input_shape: tuple[int, ...] | None = None, seq_group=None):
    """The module for ``cfg`` on ``device`` (``None``: the card, raising
    without one), sized for examples of ``input_shape`` (the dataset's
    per-example shape; required but for text models, which take
    ``cfg.seq_len``); with ``generator`` its parameters are drawn from it
    (flax's default init), else they are left for the caller to load.

    ``seq_group``: the process group of the sequence axis for sequence
    parallelism (text models with ``attn_impl`` ring or ulysses); the
    module then runs on sequence shards.  ``cfg.remat`` runs every
    transformer block under activation checkpointing."""
    device = resolve_device(device)
    if seq_group is not None and cfg.name not in TEXT_MODELS:
        raise ValueError(
            "sequence parallelism is only supported for 'bert'/'moe_bert', "
            f"not {cfg.name!r}")
    if cfg.remat and cfg.name not in TEXT_MODELS + ("vit_b16",):
        raise ValueError(
            "remat is only implemented for the transformer families "
            f"(bert/moe_bert/vit_b16), not {cfg.name!r} — silently "
            "ignoring it would fake the memory savings")
    model = _module(cfg, input_shape, seq_group)
    if generator is not None:
        model.reset_parameters(generator)
    return model.to(device)
