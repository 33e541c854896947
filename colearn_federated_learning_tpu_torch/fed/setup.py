"""Config -> runtime pieces shared by the in-process engine and the file
plane (the counterpart of the JAX package's ``fed/setup.py``).

The same config must give the same partition, step budget and local
trainer whether a client is simulated in the engine or runs as a silo
against model files (``fed/offline.py``).  Parameters cross the file
plane in the flax layout (``convert.py``), so either package reads the
other's files.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from colearn_federated_learning_tpu_torch import convert
from colearn_federated_learning_tpu_torch.fed import local as local_lib
from colearn_federated_learning_tpu_torch.fed import programs
from colearn_federated_learning_tpu_torch.fed.engine import (
    num_steps_for_config)
from colearn_federated_learning_tpu_torch.privacy import dp as dp_lib
from colearn_federated_learning_tpu_torch.utils.config import ExperimentConfig


def local_model_config(model_cfg):
    """The model config one process runs: the sequence-parallel cores
    (ring, ulysses) become the dense core, whose params are the same."""
    if model_cfg.attn_impl in ("ring", "ulysses"):
        return dataclasses.replace(model_cfg, attn_impl="dense")
    return model_cfg


def local_trainer_for_config(config: ExperimentConfig,
                             model: torch.nn.Module,
                             capacity: int,
                             lora_dense_ok: bool = False
                             ) -> tuple[Callable, int]:
    """(local_update fn, num_steps) for one client round under ``config``,
    with the JAX package's refusals.  ``lora_dense_ok``: fleetsim prices
    LoRA factor frames but trains dense by design (``fleetsim/sim.py``);
    only it may build this dense trainer under ``lora_rank > 0``."""
    c = config.fed
    if not (lora_dense_ok and c.lora_rank > 0):
        local_lib.check_dense_trainer(c)
    local_lib.check_strategy_optimizer(c)
    num_steps = num_steps_for_config(config, capacity)
    optimizer = local_lib.make_optimizer(c.lr, c.momentum, c.local_optimizer)
    update_fn = local_lib.make_local_update(
        model, optimizer, num_steps,
        prox_mu=c.prox_mu if c.strategy == "fedprox" else 0.0,
        min_steps_fraction=c.straggler_min_fraction,
        aux_loss_weight=(config.model.moe_aux_weight
                         if config.model.name.startswith("moe") else 0.0))
    return update_fn, num_steps


def lora_trainer_for_config(config: ExperimentConfig,
                            model: torch.nn.Module,
                            capacity: int) -> tuple[Callable, int]:
    """(lora_update fn, num_steps): the factor-only twin of
    :func:`local_trainer_for_config`, with its step budget and optimizer
    (the strategy's restriction to fedavg/fedprox is
    ``validate_robustness``'s)."""
    c = config.fed
    num_steps = num_steps_for_config(config, capacity)
    optimizer = local_lib.make_optimizer(c.lr, c.momentum, c.local_optimizer)
    update_fn = local_lib.make_lora_local_update(
        model, optimizer, num_steps, rank=c.lora_rank, alpha=c.lora_alpha,
        num_heads=config.model.num_heads,
        prox_mu=c.prox_mu if c.strategy == "fedprox" else 0.0,
        min_steps_fraction=c.straggler_min_fraction,
        aux_loss_weight=(config.model.moe_aux_weight
                         if config.model.name.startswith("moe") else 0.0))
    return update_fn, num_steps


def init_lora_factors(config: ExperimentConfig, params: Any,
                      device=None) -> dict:
    """The seed-deterministic factor tree of ``params`` (a flax-layout
    tree; only its shapes are read) under ``config``, on ``device``: A
    from the port's LoRA init generator (``utils/prng``, JAX's tag
    0x10AA), B zero."""
    from colearn_federated_learning_tpu_torch.fed import lora
    from colearn_federated_learning_tpu_torch.utils import prng

    return lora.init_factors(
        params, config.fed.lora_rank,
        generator=prng.lora_init_generator(config.run.seed),
        model_name=config.model.name, device=device)


def require_stateless_strategy(config: ExperimentConfig, where: str) -> None:
    """File participants keep no cross-round client state: SCAFFOLD and
    FedNova run only in the engine."""
    if config.fed.strategy == "scaffold":
        raise NotImplementedError(
            f"{where} does not support 'scaffold' (per-client control "
            "variates are engine-resident); use the on-device simulation "
            "or a stateless strategy")
    if config.fed.strategy == "fednova":
        raise NotImplementedError(
            f"{where} does not support 'fednova' (its normalized "
            "aggregation is engine-resident); use the on-device "
            "simulation or fedavg/fedprox")


def require_mean_aggregator(config: ExperimentConfig, where: str) -> None:
    """The file plane folds updates one by one; the robust aggregators need
    all of them at once and run only in the engine."""
    if config.fed.aggregator != "mean":
        raise NotImplementedError(
            f"{where} does not support aggregator="
            f"{config.fed.aggregator!r} (robust aggregation is "
            "engine-only); use the on-device simulation or aggregator="
            "'mean'")


def params_to_flax(model: torch.nn.Module, values: Optional[list],
                   config: ExperimentConfig) -> dict:
    """``values`` (tensors in ``model.parameters()`` order; the model's own
    parameters when None) as a flax-layout tree of float32 numpy arrays."""
    names = [n for n, _ in model.named_parameters()]
    if values is None:
        values = [p.detach() for p in model.parameters()]
    return convert.state_dict_to_flax(
        {n: v.float() for n, v in zip(names, values)},
        num_heads=config.model.num_heads)


def params_to_flax_tensors(model: torch.nn.Module, values: list,
                           config: ExperimentConfig) -> dict:
    """The tensor twin of :func:`params_to_flax`: ``values`` (tensors in
    ``model.parameters()`` order) as a flax-layout tree of contiguous
    float32 tensors on their own device, so a delta is compressed where
    it was trained."""
    names = [n for n, _ in model.named_parameters()]
    return convert.nest(
        (path, t.contiguous())
        for path, t in (convert.leaf_to_flax(n, v.detach().float(),
                                             config.model.num_heads)
                        for n, v in zip(names, values)))


def flax_to_params(model: torch.nn.Module, flax_params: Any,
                   device) -> list:
    """A flax-layout tree as float32 tensors on ``device`` in
    ``model.parameters()`` order; raises if it does not fit the model."""
    sd = convert.flax_to_state_dict(flax_params)
    names = [n for n, _ in model.named_parameters()]
    if sorted(sd) != sorted(names):
        raise ValueError(f"params do not match the model: "
                         f"{sorted(set(sd) ^ set(names))}")
    out = []
    for name, p in model.named_parameters():
        if tuple(sd[name].shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(sd[name].shape)}, the "
                             f"model's {tuple(p.shape)}")
        out.append(sd[name].to(device, torch.float32))
    return out


def init_global_params(config: ExperimentConfig, device=None) -> dict:
    """The seed-deterministic global model of ``config`` in the flax
    layout, drawn by the port's init generator (``utils/prng``), so every
    participant of the port derives the same start from the config."""
    from colearn_federated_learning_tpu_torch.data import registry as data_registry
    from colearn_federated_learning_tpu_torch.models import registry as model_registry
    from colearn_federated_learning_tpu_torch.utils import prng

    ds = data_registry.get_dataset(config.data.dataset, seed=config.run.seed,
                                   max_train=4 * config.fed.batch_size,
                                   max_test=1)
    model = model_registry.build_model(
        local_model_config(config.model), device,
        generator=prng.init_generator(config.run.seed),
        input_shape=np.asarray(ds.x_train).shape[1:])
    return params_to_flax(model, None, config)


def dp_effective_cohort(config: ExperimentConfig) -> int:
    """The cohort the per-client DP noise is calibrated against
    (``σ·C/√B`` per update, so the sum of B updates carries ``σ·C``)."""
    return max(config.fed.cohort_size or config.data.num_clients, 1)


def finalize_client_delta(config: ExperimentConfig, result, client_id: int,
                          round_idx: int, draws=None) -> tuple[list, float]:
    """Apply the config's privacy hooks to one client's ``LocalResult``:
    ``(delta, aggregation_weight)``.  Fixed-clip DP clips and noises the
    delta (noise from ``draws.dp_noise``, by default the port's
    ``utils/prng.dp_generator``) and weights it uniformly."""
    delta = result.delta
    weight = float(result.num_examples)
    c = config.fed
    if c.dp_adaptive_clip:
        raise NotImplementedError(
            "dp_adaptive_clip is engine-only: the clip norm is cross-round "
            "server state the stateless file/socket participants don't "
            "carry; use the on-device simulation or a fixed dp_clip")
    if c.dp_clip > 0.0:
        draws = draws if draws is not None else programs.Draws(
            config.run.seed)
        noise = draws.dp_noise(round_idx, client_id, [d.shape for d in delta],
                               delta[0].device)
        delta = dp_lib.clip_and_noise(delta, c.dp_clip, c.dp_noise_multiplier,
                                      dp_effective_cohort(config), noise)
        weight = 1.0
    return delta, weight
