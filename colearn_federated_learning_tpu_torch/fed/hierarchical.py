"""Hierarchical (edge → cloud) federation: HierFAVG-style two-tier rounds.

The counterpart of the JAX package's ``fed/hierarchical.py``.  Each edge
group runs full federated rounds over its own client population (one
port ``FederatedLearner`` per group, over its contiguous slice of the
training corpus), and every ``sync_period`` rounds the edge models
average into the cloud model, weighted by the groups' example counts,
which then re-seeds every group.  Devices talk only to their gateway
every round; the WAN carries one model per group every ``sync_period``
rounds.

Cloud sync averages params, so only the strategies whose server state is
exactly params (fedavg, fedprox) are accepted.  Secure aggregation
composes group-locally (each group masks over its own clients);
:meth:`HierarchicalLearner.mask_cost_summary` prices the cut.

Not ported yet: the FaultPlan branches of the sync (dropped downlinks and
uplinks), which wait for the fault plane (ROADMAP.md Queue A item 8).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from colearn_federated_learning_tpu_torch.data import registry as data_registry
from colearn_federated_learning_tpu_torch.fed.engine import FederatedLearner
from colearn_federated_learning_tpu_torch.privacy import dropout
from colearn_federated_learning_tpu_torch.utils.config import ExperimentConfig


class HierarchicalLearner:
    """Two-tier federated simulation (see the module docstring).

    ``num_groups`` edge groups each own a disjoint contiguous shard of the
    training corpus and ``num_clients // num_groups`` clients, partitioned
    within the group by the config's scheme.  Group ``g`` runs with seed
    ``seed · num_groups + g``.  ``device`` is every group's device
    (``None`` = the card); ``plans`` is an optional list of one draw plan
    per group (``FederatedLearner``'s ``plan``).
    """

    def __init__(self, config: ExperimentConfig, num_groups: int = 2,
                 sync_period: int = 2, device=None,
                 plans: Optional[list] = None):
        if num_groups < 2:
            raise ValueError(f"num_groups must be >= 2, got {num_groups}")
        if sync_period < 1:
            raise ValueError(f"sync_period must be >= 1, got {sync_period}")
        if config.fed.strategy not in ("fedavg", "fedprox"):
            raise ValueError(
                "hierarchical sync averages params; strategy "
                f"{config.fed.strategy!r} carries extra server state "
                "(moments/variates) a param average would desynchronise")
        self.config = config
        self.num_groups = num_groups
        self.sync_period = sync_period

        if config.data.num_clients % num_groups:
            raise ValueError(
                f"num_clients={config.data.num_clients} is not divisible "
                f"by num_groups={num_groups}; remainder clients would be "
                "silently dropped while their data still lands in a group")
        base = data_registry.get_dataset(config.data.dataset,
                                         seed=config.run.seed)
        self.dataset = base
        n = len(base.y_train)
        clients_per_group = config.data.num_clients // num_groups
        self.groups: list[FederatedLearner] = []
        self.group_examples: list[int] = []
        for g in range(num_groups):
            lo, hi = g * n // num_groups, (g + 1) * n // num_groups
            ds = dataclasses.replace(base, x_train=base.x_train[lo:hi],
                                     y_train=base.y_train[lo:hi])
            gcfg = config.replace(
                data=dataclasses.replace(config.data,
                                         num_clients=clients_per_group),
                run=dataclasses.replace(
                    config.run, name=f"{config.run.name}_edge{g}",
                    # Client ids restart at 0 in every group: distinct
                    # seeds de-correlate their draws.
                    seed=config.run.seed * num_groups + g))
            self.groups.append(FederatedLearner(
                gcfg, dataset=ds, device=device,
                plan=plans[g] if plans is not None else None))
            self.group_examples.append(int(np.asarray(ds.y_train).size))

        # The cloud model starts from group 0's init, and so does every
        # group.
        self.global_params = {k: v.clone()
                              for k, v in self.groups[0].params.items()}
        w = np.asarray(self.group_examples, np.float64)
        self._weights = [float(x) for x in w / w.sum()]
        self._seed_groups()
        # Group 0's evaluation program scores the global test set with
        # its model as scratch, as the cloud's would.
        self._eval_fn = self.groups[0]._eval_fn
        self.history: list[dict] = []

    def _seed_groups(self) -> None:
        cloud = list(self.global_params.values())
        for g in self.groups:
            torch._foreach_copy_(list(g.params.values()), cloud)

    @torch.no_grad()
    def _cloud_sync(self) -> None:
        """Cloud aggregation: the example-count-weighted mean of the edge
        models, weights in float64 and applied in f32 in the JAX order
        (w₀·p₀ + w₁·p₁ + …), then every group re-seeded from it."""
        acc = torch._foreach_mul(list(self.groups[0].params.values()),
                                 self._weights[0])
        for w, g in zip(self._weights[1:], self.groups[1:]):
            torch._foreach_add_(acc, torch._foreach_mul(
                list(g.params.values()), w))
        self.global_params = dict(zip(self.global_params, acc))
        self._seed_groups()

    def run_round(self) -> dict:
        """One edge round in every group; cloud sync on period boundaries."""
        r = len(self.history)
        recs = [g.run_round() for g in self.groups]
        synced = (r + 1) % self.sync_period == 0
        if synced:
            self._cloud_sync()
        out = {
            "round": r,
            "synced": synced,
            "train_loss": float(np.mean([x["train_loss"] for x in recs])),
            "completed": float(np.sum([x["completed"] for x in recs])),
            "group_losses": [float(x["train_loss"]) for x in recs],
        }
        self.history.append(out)
        return out

    def mask_cost_summary(self) -> dict:
        """Per-device secure-aggregation cost of this topology against the
        flat one (``privacy.dropout.mask_cost``; no masking need be on).
        ``quadratic_ratio`` is the system-wide pair-count cut: flat
        O(cohort²) pairs over grouped O(cohort · group)."""
        cohort = self.config.data.num_clients
        group = cohort // self.num_groups
        cost = dropout.mask_cost(
            cohort=cohort,
            param_count=sum(p.numel() for p in self.global_params.values()),
            neighbors=self.config.fed.secure_agg_neighbors,
            group_size=group)
        cost["num_groups"] = self.num_groups
        cost["group_size"] = group
        cost["quadratic_ratio"] = (
            cost["flat_pairs_total"] / max(1, cost["grouped_pairs_total"]))
        return cost

    def evaluate(self) -> tuple[float, float]:
        """The cloud model's score on the global test set.  Between syncs
        the cloud model is the last synced one."""
        return self._eval_fn(self.global_params.values())

    def fit(self, rounds: Optional[int] = None, log_fn=None) -> list[dict]:
        """Run ``rounds`` rounds (default ``config.fed.rounds``), evaluating
        the cloud model on synced rounds; the last round always syncs, so
        the reported model folds the groups' last partial period."""
        rounds = rounds if rounds is not None else self.config.fed.rounds
        log_every = max(1, self.config.run.log_every)
        last_round = len(self.history) + rounds - 1
        for _ in range(rounds):
            rec = self.run_round()
            if rec["round"] == last_round and not rec["synced"]:
                self._cloud_sync()
                rec["synced"] = True
            if rec["synced"]:
                rec["eval_loss"], rec["eval_acc"] = self.evaluate()
            if log_fn is not None and (rec["round"] % log_every == 0
                                       or rec["round"] == last_round):
                log_fn(rec)
        return self.history


# ---- tree-async secure-agg groundwork (per-buffer mask cohorts) ----------
def buffer_mask_cohorts(assignment: dict, pruned=()) -> dict:
    """Per-buffer mask cohorts for the tree-async plane.

    ``assignment`` maps device id -> aggregator id.  Pairwise masks only
    cancel within a complete sum, and each aggregator's buffer is folded
    as its own partial, so a mask pair must never span two buffers: each
    buffer is its own pairing cohort.  ``pruned`` devices (predicted
    dropouts) are left out of the pair graph up front.

    Returns ``agg_id -> sorted device-id list``.
    """
    cut = {str(d) for d in pruned}
    out: dict = {}
    for dev, aid in assignment.items():
        if str(dev) in cut:
            continue
        out.setdefault(aid, []).append(str(dev))
    return {aid: sorted(devs, key=str) for aid, devs in sorted(out.items())}


def async_mask_cost(assignment: dict, param_count: int,
                    neighbors: int = 0, pruned=()) -> dict:
    """Analytic secure-aggregation cost of the per-buffer cohort layout:
    per-buffer pair degrees, the predicted dropouts (which cost no
    recovery), and the share recoveries one mid-buffer death would cost."""
    cohorts = buffer_mask_cohorts(assignment, pruned=pruned)
    active = sum(len(devs) for devs in cohorts.values())
    per_buffer: dict = {}
    pairs_total = 0
    for aid, devs in cohorts.items():
        if not devs:
            continue
        cost = dropout.mask_cost(
            cohort=max(1, active), param_count=param_count,
            neighbors=neighbors, group_size=len(devs))
        degree = cost["pairs_per_device"]
        per_buffer[aid] = {
            "devices": len(devs),
            "pairs_per_device": degree,
            "mask_flops_per_device": cost["mask_flops_per_device"],
            "reactive_recovery_shares": degree,
        }
        pairs_total += len(devs) * degree // 2
    predicted = sum(1 for d in assignment if str(d) in
                    {str(p) for p in pruned})
    return {
        "buffers": per_buffer,
        "active_devices": active,
        "pairs_total": pairs_total,
        "predicted_dropouts": predicted,
        "predicted_recovery_shares": 0,
    }
