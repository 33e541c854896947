"""Federated round orchestration on one CUDA device.

The counterpart of the JAX package's ``FederatedLearner`` on its
single-device path: data, model and server state are built once, then
each ``run_round`` samples the cohort, trains every client, folds the
weighted deltas and applies the server step (``fed/programs.py``).

``device=None`` means ``"cuda"``; without a card the constructor raises
instead of running somewhere else.  ``device="cpu"`` runs the same round
with every kernel's plain PyTorch version (the tests do this).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from colearn_federated_learning_tpu_torch import convert
from colearn_federated_learning_tpu_torch.data import partition as partition_lib
from colearn_federated_learning_tpu_torch.data import registry as data_registry
from colearn_federated_learning_tpu_torch.data.sharding import pack_client_shards
from colearn_federated_learning_tpu_torch.fed import evaluation, local, programs
from colearn_federated_learning_tpu_torch.fed import strategies
from colearn_federated_learning_tpu_torch.models import registry as model_registry
from colearn_federated_learning_tpu_torch.utils import prng
from colearn_federated_learning_tpu_torch.utils.config import ExperimentConfig
from colearn_federated_learning_tpu_torch.utils.device import resolve_device


def check_supported(config: ExperimentConfig) -> None:
    """Refuse what this package does not run yet rather than ignore it."""
    f = config.fed
    unported = {
        "dp_clip > 0": f.dp_clip > 0.0,
        "secure_agg": f.secure_agg,
        f"aggregator={f.aggregator!r}": f.aggregator != "mean",
        "lora_rank > 0": f.lora_rank > 0,
        "edge_groups > 1": f.edge_groups > 1,
        "tp_size > 1": config.run.tp_size > 1,
    }
    bad = [name for name, on in unported.items() if on]
    if f.strategy not in strategies.STRATEGIES:
        bad.insert(0, f"strategy {f.strategy!r}")
    if bad:
        raise NotImplementedError(
            f"not ported yet: {', '.join(bad)}; see ROADMAP.md Queue A")


def partition_for_config(config: ExperimentConfig, labels: np.ndarray):
    """Per-client index lists for ``config.data`` (iid | dirichlet |
    pathological), as the JAX package's ``fed/setup.py`` derives them."""
    c = config.data
    seed = config.run.seed
    if c.partition == "dirichlet":
        return partition_lib.dirichlet_partition(
            labels, c.num_clients, c.dirichlet_alpha, seed=seed)
    if c.partition == "pathological":
        return partition_lib.pathological_partition(labels, c.num_clients,
                                                    seed=seed)
    if c.partition != "iid":
        raise ValueError(f"unknown data.partition {c.partition!r}; "
                         "use iid | dirichlet | pathological")
    return partition_lib.iid_partition(len(labels), c.num_clients, seed=seed)


def num_steps_for_config(config: ExperimentConfig, capacity: int) -> int:
    """Static per-round local step budget: explicit ``local_steps`` or
    ``local_epochs * ceil(capacity / batch_size)``."""
    c = config.fed
    if c.local_steps > 0:
        return c.local_steps
    return c.local_epochs * max(1, int(np.ceil(capacity / c.batch_size)))


class FederatedLearner:
    """End-to-end federated experiment on one device: data, model, round
    loop, evaluation.

    ``plan``: optional object with the methods of
    :class:`fed.programs.Draws` (``cohort``, ``batch_indices``,
    ``step_budgets``) supplying the round's random draws; by default they
    come from ``utils/prng``.
    """

    def __init__(self, config: ExperimentConfig,
                 dataset: Optional[data_registry.Dataset] = None,
                 device=None, plan=None):
        self.config = c = config
        self.device = resolve_device(device)
        check_supported(c)

        # --- data -----------------------------------------------------
        self.dataset = dataset or data_registry.get_dataset(
            c.data.dataset, seed=c.run.seed)
        labels = np.asarray(self.dataset.y_train)
        shards = pack_client_shards(
            np.asarray(self.dataset.x_train), labels,
            partition_for_config(c, labels),
            capacity=c.data.max_examples_per_client)
        self.shards = shards
        self.num_clients = shards.num_clients
        self.client_ids = np.arange(self.num_clients, dtype=np.int64)
        self.counts = shards.counts
        self.x = torch.from_numpy(shards.x).to(self.device)
        self.y = torch.from_numpy(shards.y.astype(np.int64)).to(self.device)

        # --- model and server state -----------------------------------
        self.model = model_registry.build_model(
            c.model, self.device, generator=prng.init_generator(c.run.seed),
            input_shape=shards.x.shape[2:])
        self.server_state = strategies.init_server_state(
            self._param_copy(), c.fed)

        # --- local trainer and cohort ---------------------------------
        self.num_steps = num_steps_for_config(c, shards.capacity)
        optimizer = local.make_optimizer(c.fed.lr, c.fed.momentum,
                                         c.fed.local_optimizer)
        self.local_update = local.make_local_update(
            self.model, optimizer, self.num_steps,
            prox_mu=c.fed.prox_mu if c.fed.strategy == "fedprox" else 0.0,
            min_steps_fraction=c.fed.straggler_min_fraction,
            aux_loss_weight=(c.model.moe_aux_weight
                             if c.model.name.startswith("moe") else 0.0))
        cohort = c.fed.cohort_size or self.num_clients
        self.cohort_size = min(cohort, self.num_clients)
        self.draws = plan if plan is not None else programs.Draws(c.run.seed)

        self._eval_fn = evaluation.make_eval_fn(
            self.model, self.dataset.x_test, self.dataset.y_test,
            batch=max(c.fed.batch_size, 64), device=self.device)
        self.history: list[dict] = []

    def _param_copy(self) -> dict:
        return {name: p.detach().clone()
                for name, p in self.model.named_parameters()}

    def load_flax_params(self, flax_params) -> None:
        """Start from parameters in the JAX package's flax layout (a nested
        dict of numpy arrays), converted exactly by ``convert.py``."""
        sd = convert.flax_to_state_dict(flax_params)
        names = [n for n, _ in self.model.named_parameters()]
        if sorted(sd) != sorted(names):
            raise ValueError(f"flax params do not match the model: "
                             f"{sorted(set(sd) ^ set(names))}")
        params = {n: sd[n].to(self.device, torch.float32).clone()
                  for n in names}
        self.server_state = strategies.init_server_state(params,
                                                         self.config.fed)

    @property
    def params(self) -> dict:
        """The global model's parameters (name -> f32 tensor)."""
        return self.server_state.params

    def run_round(self) -> dict:
        """One federated round; returns its metrics (one host sync)."""
        r = len(self.history)
        t0 = time.perf_counter()
        metrics = programs.run_round(self, r)
        out = {k: float(v) for k, v in metrics.items()}
        out["round"] = r
        out["phase_update_s"] = time.perf_counter() - t0
        self.history.append(out)
        return out

    def evaluate(self) -> tuple[float, float]:
        """(mean loss, accuracy) of the global model on the test set."""
        return self._eval_fn(self.server_state.params.values())

    def fit(self, rounds: Optional[int] = None, log_fn=None) -> list[dict]:
        """Run ``rounds`` more rounds (default: up to ``config.fed.rounds``),
        evaluating every ``run.eval_every`` rounds and after the last."""
        if rounds is None:
            rounds = max(0, self.config.fed.rounds - len(self.history))
        eval_every = max(1, self.config.run.eval_every)
        last_round = len(self.history) + rounds - 1
        for _ in range(rounds):
            t0 = time.perf_counter()
            rec = self.run_round()
            if rec["round"] % eval_every == 0 or rec["round"] == last_round:
                rec["eval_loss"], rec["eval_acc"] = self.evaluate()
            rec["round_time_s"] = time.perf_counter() - t0
            if log_fn is not None:
                log_fn(rec)
        return self.history
