"""Federated round orchestration on one CUDA device.

The counterpart of the JAX package's ``FederatedLearner`` on its
single-device path: data, model and server state are built once, then
each ``run_round`` samples the cohort, trains every client, folds the
weighted deltas and applies the server step (``fed/programs.py``).  It
validates the privacy and robustness knobs as the JAX engine does, keeps
SCAFFOLD's per-client variates on the host, carries the adaptive DP clip
from round to round as a device scalar and steps the RDP accountant.

``device=None`` means ``"cuda"``; without a card the constructor raises
instead of running somewhere else.  ``device="cpu"`` runs the same round
with every kernel's plain PyTorch version (the tests do this).
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from colearn_federated_learning_tpu_torch import convert
from colearn_federated_learning_tpu_torch.data import partition as partition_lib
from colearn_federated_learning_tpu_torch.data import registry as data_registry
from colearn_federated_learning_tpu_torch.data.sharding import pack_client_shards
from colearn_federated_learning_tpu_torch.fed import evaluation, local, programs
from colearn_federated_learning_tpu_torch.fed import robust, strategies
from colearn_federated_learning_tpu_torch.models import registry as model_registry
from colearn_federated_learning_tpu_torch.privacy import dp as dp_lib
from colearn_federated_learning_tpu_torch.privacy.accountant import RdpAccountant
from colearn_federated_learning_tpu_torch.utils import prng
from colearn_federated_learning_tpu_torch.utils.config import ExperimentConfig
from colearn_federated_learning_tpu_torch.utils.device import resolve_device


def check_supported(config: ExperimentConfig) -> None:
    """Refuse what this package does not run yet rather than ignore it.
    ``edge_groups`` is not refused: the hierarchical learner
    (``fed/hierarchical.py``) builds its groups from copies of a config
    that still carries it, as the JAX package's does."""
    f = config.fed
    unported = {
        "lora_rank > 0": f.lora_rank > 0,
        "tp_size > 1": config.run.tp_size > 1,
    }
    bad = [name for name, on in unported.items() if on]
    if f.strategy not in strategies.STRATEGIES:
        bad.insert(0, f"strategy {f.strategy!r}")
    if bad:
        raise NotImplementedError(
            f"not ported yet: {', '.join(bad)}; see ROADMAP.md Queue A")


def check_fed_options(fed) -> None:
    """The JAX engine's checks of the secure-aggregation, SCAFFOLD and
    robust-aggregation options, with its messages."""
    if fed.secure_agg and fed.secure_agg_neighbors and (
            fed.secure_agg_neighbors % 2 or fed.secure_agg_neighbors < 2):
        raise ValueError(
            "secure_agg_neighbors must be an even integer >= 2, got "
            f"{fed.secure_agg_neighbors}")
    if fed.secure_agg and not 0.0 < fed.secure_agg_threshold <= 1.0:
        raise ValueError(
            "secure_agg_threshold must be in (0, 1], got "
            f"{fed.secure_agg_threshold}")
    scaffold = fed.strategy == "scaffold"
    if scaffold and (fed.secure_agg or fed.dp_clip > 0.0):
        raise ValueError(
            "scaffold is incompatible with secure_agg/dp hooks: the "
            "control-variate deltas are a second payload the masks and "
            "noise calibration do not cover")
    if fed.aggregator not in robust.AGGREGATORS:
        raise ValueError(
            f"unknown aggregator {fed.aggregator!r}; use {robust.AGGREGATORS}")
    if fed.aggregator != "mean":
        if not 0.0 <= fed.trim_fraction < 0.5:
            raise ValueError(
                f"trim_fraction must be in [0, 0.5), got {fed.trim_fraction}")
        if fed.secure_agg:
            raise ValueError(
                "robust aggregators need the individual updates; "
                "secure-agg masks only cancel in a plain sum")
        if scaffold:
            raise ValueError(
                "scaffold assumes mean aggregation of its control "
                "variates; use aggregator='mean'")
        if fed.dp_noise_multiplier > 0.0:
            raise ValueError(
                "robust aggregation of noised updates is not the "
                "Gaussian mechanism the RDP accountant models; use "
                "dp_clip alone (norm bounding) with robust aggregators")


def check_trim_at_cohort(fed, cohort_size: int) -> None:
    """A trimmed mean or Krum whose floor(trim · cohort) is 0 would be the
    plain mean in disguise: refuse it, as the JAX engine does."""
    if (fed.aggregator not in ("trimmed_mean", "krum")
            or int(fed.trim_fraction * cohort_size + 1e-4) >= 1):
        return
    what = ("trims zero clients" if fed.aggregator == "trimmed_mean"
            else "assumes zero Byzantine clients (f = 0)")
    if cohort_size < 3:
        raise ValueError(
            f"aggregator={fed.aggregator!r} needs a cohort of at "
            f"least 3 (got {cohort_size}); use aggregator='median'")
    ok_frac = math.ceil(1e6 / cohort_size) / 1e6
    raise ValueError(
        f"trim_fraction={fed.trim_fraction} {what} at "
        f"cohort_size={cohort_size}; raise it to at least "
        f"{ok_frac:.6f} (or use aggregator='median')")


class VariateStore:
    """SCAFFOLD's per-client control variates, one row per client, held on
    the host (pinned when the params live on a card): each client's row
    goes to the device for its local update, and a contributor's refreshed
    row comes back, so the device holds O(model) of them, not
    O(clients × model)."""

    def __init__(self, params: dict, num_clients: int, device):
        pin = torch.device(device).type == "cuda"
        self.device = device
        self.rows = [torch.zeros((num_clients,) + p.shape, dtype=p.dtype,
                                 pin_memory=pin) for p in params.values()]

    def gather(self, slot: int) -> list:
        return [r[slot].to(self.device, non_blocking=True) for r in self.rows]

    def scatter(self, slot: int, values: list) -> None:
        for r, v in zip(self.rows, values):
            r[slot].copy_(v)


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

    ``partitions``: optional explicit per-client index lists into the
    dataset's train split, overriding ``config.data.partition`` (clustered
    FL injects its members' exact shards this way).

    ``plan``: optional object with the methods of
    :class:`fed.programs.Draws` (``cohort``, ``batch_indices``,
    ``step_budgets``, ``dp_noise``, ``pair_mask``, ``ring_order``,
    ``clip_bit_noise``) supplying the round's random draws; by default
    they come from ``utils/prng``.

    ``last_cohort`` describes the last round's cohort (numpy arrays):
    ``clients``, ``steps_run`` and ``contributed``, and with the options
    that make them ``nova_a`` (FedNova's coefficients), ``partners``
    (secure aggregation's partner table) and ``selected`` (the clients
    Krum kept).
    """

    def __init__(self, config: ExperimentConfig,
                 dataset: Optional[data_registry.Dataset] = None,
                 device=None, plan=None, partitions: Optional[list] = None):
        self.config = c = config
        self.device = resolve_device(device)
        check_supported(c)
        check_fed_options(c.fed)
        local.check_strategy_optimizer(c.fed)
        self.scaffold = c.fed.strategy == "scaffold"
        self.fednova = c.fed.strategy == "fednova"
        self.robust = c.fed.aggregator != "mean"

        # --- data -----------------------------------------------------
        self.dataset = dataset or data_registry.get_dataset(
            c.data.dataset, seed=c.run.seed)
        labels = np.asarray(self.dataset.y_train)
        parts = (partitions if partitions is not None
                 else partition_for_config(c, labels))
        shards = pack_client_shards(
            np.asarray(self.dataset.x_train), labels, parts,
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
                             if c.model.name.startswith("moe") else 0.0),
            scaffold=self.scaffold, lr=c.fed.lr)
        self.variates = (VariateStore(self.server_state.params,
                                      self.num_clients, self.device)
                         if self.scaffold else None)
        cohort = c.fed.cohort_size or self.num_clients
        self.cohort_size = min(cohort, self.num_clients)
        if self.robust:
            check_trim_at_cohort(c.fed, self.cohort_size)
        self.draws = plan if plan is not None else programs.Draws(c.run.seed)
        self.last_cohort: dict = {}

        # --- DP -------------------------------------------------------
        # Noise is calibrated to the cohort (the JAX engine's dp_cohort,
        # min(cohort, real clients), is cohort_size here: this engine pads
        # no ghost clients).  With adaptive clipping the clip is a device
        # scalar carried from round to round, and the bit query's noise is
        # paid for by inflating the update noise, so the joint mechanism
        # still costs z.
        self.adaptive_clip = c.fed.dp_adaptive_clip
        self.dp_z = self.dp_bit_noise = 0.0
        if self.adaptive_clip:
            if c.fed.dp_clip <= 0.0:
                raise ValueError(
                    "dp_adaptive_clip needs dp_clip > 0 as the initial norm")
            z = c.fed.dp_noise_multiplier
            if z > 0.0:
                self.dp_bit_noise = c.fed.dp_bit_noise or max(
                    self.cohort_size / 20.0, 1.0)
                self.dp_z = dp_lib.adaptive_noise_multiplier(
                    z, self.dp_bit_noise)
        self.dp_clip = torch.tensor(c.fed.dp_clip, dtype=torch.float32,
                                    device=self.device)
        self.accountant = RdpAccountant.from_config(
            c.fed, sampling_rate=self.cohort_size / self.num_clients)

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

    def _sync(self) -> None:
        """Wait for the card's queued work, so a host clock read after it
        covers that work (nothing to wait for on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_round(self, sync: bool = True) -> dict:
        """One federated round; returns its metrics (one host sync).

        ``phase_update_s`` runs from the cohort draw until the card has
        finished the round; ``phase_sync_s`` is the metrics' copy to the
        host; under SCAFFOLD ``phase_cohort_sample_s`` is the cohort draw,
        as in the JAX record.  ``sync=False`` leaves the metrics on the
        device and does not wait for the card, so rounds queue back to
        back (``phase_update_s`` is then the host's time to queue the
        round); :meth:`finalize_history` turns them into floats."""
        r = len(self.history)
        t0 = time.perf_counter()
        sel = programs.sample_cohort(self, r)
        t_sample = time.perf_counter() - t0
        metrics = programs.run_round(self, r, sel)
        if self.adaptive_clip:
            self.dp_clip = metrics["dp_clip"]
        if sync:
            self._sync()
        t1 = time.perf_counter()
        out = ({k: float(v) for k, v in metrics.items()} if sync
               else dict(metrics))
        out["round"] = r
        out["phase_update_s"] = t1 - t0
        out["phase_sync_s"] = time.perf_counter() - t1
        if self.scaffold:
            out["phase_cohort_sample_s"] = t_sample
        if self.accountant is not None:
            self.accountant.step()
            out["dp_epsilon"] = self.accountant.epsilon()
            out["dp_delta"] = self.accountant.delta
        self.history.append(out)
        return out

    def finalize_history(self) -> list[dict]:
        """Turn the device metrics of ``sync=False`` rounds into floats
        (waits for the card)."""
        self.history = [{k: (float(v) if isinstance(v, torch.Tensor) else v)
                         for k, v in rec.items()} for rec in self.history]
        return self.history

    def evaluate(self) -> tuple[float, float]:
        """(mean loss, accuracy) of the global model on the test set."""
        return self._eval_fn(self.server_state.params.values())

    def evaluate_per_client(self) -> dict:
        """Score the current global model on every client's own shard:
        per-client arrays in client-id order (``per_client_loss``,
        ``per_client_acc``, ``num_examples``) and their example-weighted
        aggregates and accuracy spread (``evaluation.summarize_per_client``)."""
        loss, acc = programs.build_client_eval_fn(self)(
            self.server_state.params.values())
        counts = np.asarray(self.counts)
        out = evaluation.summarize_per_client(loss, acc, counts)
        out.update(per_client_loss=loss, per_client_acc=acc,
                   num_examples=counts)
        return out

    def client_update_similarity(self, steps: int = 1) -> np.ndarray:
        """(N, N) cosine similarity of every client's local update from the
        current global model: the clustering signal of clustered FL
        (``fed/clustered.py``).  Clients train one after another; their
        normalised flat updates are stacked and multiplied once."""
        if self.scaffold:
            raise NotImplementedError(
                "clustering uses the plain local trainer; run it with a "
                "stateless strategy")
        return programs.build_similarity_fn(self, steps)(
            list(self.server_state.params.values()))

    def id_order_slots(self) -> np.ndarray:
        """Array slot of every real client in client-id order: the
        identity on one device (the JAX package's mesh interleaves them)."""
        return np.arange(self.num_clients)

    def fit(self, rounds: Optional[int] = None, log_fn=None) -> list[dict]:
        """Run ``rounds`` more rounds (default: up to ``config.fed.rounds``),
        evaluating every ``run.eval_every`` rounds and after the last, and
        handing every ``run.log_every``-th record and the last to
        ``log_fn``.  ``round_time_s`` is the round alone; an evaluation's
        time is its own ``phase_eval_s``.  On the card the record also
        carries ``hbm_used_gb``, the memory allocated after the round."""
        if rounds is None:
            rounds = max(0, self.config.fed.rounds - len(self.history))
        run = self.config.run
        eval_every = max(1, run.eval_every)
        log_every = max(1, run.log_every)
        last_round = len(self.history) + rounds - 1
        for _ in range(rounds):
            t0 = time.perf_counter()
            rec = self.run_round()
            rec["round_time_s"] = time.perf_counter() - t0
            if self.device.type == "cuda":
                rec["hbm_used_gb"] = round(
                    torch.cuda.memory_allocated(self.device) / 2**30, 3)
            if rec["round"] % eval_every == 0 or rec["round"] == last_round:
                t1 = time.perf_counter()
                rec["eval_loss"], rec["eval_acc"] = self.evaluate()
                self._sync()
                rec["phase_eval_s"] = time.perf_counter() - t1
            if log_fn is not None and (rec["round"] % log_every == 0
                                       or rec["round"] == last_round):
                log_fn(rec)
        return self.history
