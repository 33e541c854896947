"""Clustered federated learning: per-concept models from update similarity.

The counterpart of the JAX package's ``fed/clustered.py``.  When client
populations carry conflicting concepts, no single global model fits
everyone; clustered FL recovers the latent grouping from the geometry of
the clients' own updates and trains one model per cluster:

1. warm up a global model a few rounds;
2. compute the (N, N) cosine similarity of the clients' local updates
   (``FederatedLearner.client_update_similarity``);
3. cluster its rows (k-means on the host; the matrix is small);
4. build one ``FederatedLearner`` per cluster over its members' shards,
   seeded from the warm global model, and train them independently.

Evaluation is per client, on the members' own shards.  Not ported yet:
the client mesh of the JAX learner (ROADMAP.md Queue A item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from colearn_federated_learning_tpu_torch.fed import programs
from colearn_federated_learning_tpu_torch.fed.engine import FederatedLearner
from colearn_federated_learning_tpu_torch.fed.evaluation import (
    summarize_per_client)


def kmeans_rows(X: np.ndarray, k: int, iters: int = 50,
                seed: int = 0) -> np.ndarray:
    """Tiny k-means (numpy, k-means++ init) over the rows of ``X``."""
    rng = np.random.default_rng(seed)
    n = X.shape[0]
    centers = [X[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(
            [np.sum((X - c) ** 2, axis=1) for c in centers], axis=0
        )
        total = d2.sum()
        if total <= 0.0:
            # Degenerate: all rows identical — any choice is equivalent.
            centers.append(X[rng.integers(n)])
            continue
        centers.append(X[rng.choice(n, p=d2 / total)])
    C = np.stack(centers)
    labels = np.zeros(n, np.int32)
    for _ in range(iters):
        d = ((X[:, None, :] - C[None]) ** 2).sum(-1)
        new = d.argmin(1).astype(np.int32)
        if (new == labels).all():
            break
        labels = new
        for j in range(k):
            if (labels == j).any():
                C[j] = X[labels == j].mean(0)
    return labels


class ClusteredLearner:
    """Warm up → cluster by update similarity → one learner per cluster.

    Built on an existing ``FederatedLearner``, whose device shards
    (``base.x``, ``base.y``) are the ground truth of who owns which
    examples, so a caller may edit them before clustering.  The cluster
    learners run on the base learner's device, with its draw plan.
    """

    def __init__(self, base: FederatedLearner, num_clusters: int = 2):
        if num_clusters < 2:
            raise ValueError(f"num_clusters must be >= 2, got {num_clusters}")
        self.base = base
        self.num_clusters = num_clusters
        self.labels: Optional[np.ndarray] = None
        self.clusters: list[Optional[FederatedLearner]] = []
        self.members: list[np.ndarray] = []

    def cluster_and_specialize(self, warmup_rounds: int = 2,
                               sim_steps: int = 3) -> np.ndarray:
        """Run the pipeline; returns the per-client cluster labels."""
        base = self.base
        for _ in range(warmup_rounds):
            base.run_round()
        sim = base.client_update_similarity(steps=sim_steps)
        labels = kmeans_rows(sim, self.num_clusters,
                             seed=base.config.run.seed)
        self._build_clusters(labels, [base.params] * self.num_clusters)
        return self.labels

    def _build_clusters(self, labels: np.ndarray, init_params: list) -> None:
        """(Re)build the per-cluster learners for ``labels``, seeding
        cluster ``j`` from ``init_params[j]`` (a name -> tensor dict): the
        warm global model on first clustering, each cluster's own trained
        model on reassignment.  Every member keeps its exact shard rows."""
        base = self.base
        self.labels = labels
        self.clusters, self.members = [], []
        x = base.x.cpu().numpy()
        y = base.y.cpu().numpy().astype(np.int32)     # callers may edit y
        counts = np.asarray(base.counts)
        slots = base.id_order_slots()
        for j in range(self.num_clusters):
            members = np.where(labels == j)[0]
            self.members.append(members)
            if members.size == 0:
                self.clusters.append(None)
                continue
            m_slots = slots[members]
            xs = np.concatenate([x[i][:counts[i]] for i in m_slots])
            ys = np.concatenate([y[i][:counts[i]] for i in m_slots])
            offsets = np.cumsum([0] + [int(counts[i]) for i in m_slots])
            parts = [np.arange(offsets[m], offsets[m + 1])
                     for m in range(members.size)]
            ds = dataclasses.replace(base.dataset, x_train=xs, y_train=ys)
            cfg = base.config.replace(
                data=dataclasses.replace(base.config.data,
                                         num_clients=int(members.size)),
                run=dataclasses.replace(
                    base.config.run,
                    name=f"{base.config.run.name}_cluster{j}"))
            # The cluster runs with the base's seed, as in JAX, so the
            # base's draw plan serves it (keyed by the cluster's own ids).
            learner = FederatedLearner(cfg, dataset=ds, device=base.device,
                                       plan=base.draws, partitions=parts)
            with torch.no_grad():
                torch._foreach_copy_(list(learner.params.values()),
                                     list(init_params[j].values()))
            self.clusters.append(learner)

    def reassign(self) -> np.ndarray:
        """IFCA step: every client picks the cluster whose current model
        has the lowest loss on its own shard (the base learner's
        per-client evaluation under each cluster's params)."""
        base = self.base
        slots = base.id_order_slots()
        client_eval = programs.build_client_eval_fn(base)
        losses = []
        for learner in self.clusters:
            if learner is None:
                losses.append(np.full(slots.size, np.inf))
                continue
            loss, _ = client_eval(learner.params.values())
            losses.append(loss[slots])
        return np.argmin(np.stack(losses), axis=0).astype(np.int32)

    def refine(self, iters: int = 2, rounds_per_iter: int = 2) -> np.ndarray:
        """Alternate cluster training with IFCA reassignment.  Clients that
        move adopt the model of their new cluster; clusters keep their
        trained models across reassignments."""
        if self.labels is None:
            raise RuntimeError("call cluster_and_specialize() first")
        for _ in range(iters):
            self.fit(rounds=rounds_per_iter)
            new = self.reassign()
            if (new == self.labels).all():
                break
            params = [c.params if c is not None else self.base.params
                      for c in self.clusters]
            self._build_clusters(new, params)
        return self.labels

    def fit(self, rounds: int) -> None:
        if self.labels is None:
            raise RuntimeError("call cluster_and_specialize() first")
        for learner in self.clusters:
            if learner is not None:
                learner.fit(rounds=rounds)

    def evaluate_per_client(self) -> dict:
        """Per-client accuracy of each cluster's model on its members' own
        shards, and the weighted aggregate across all clusters."""
        losses, accs, counts = [], [], []
        for learner in self.clusters:
            if learner is None:
                continue
            rep = learner.evaluate_per_client()
            losses.extend(rep["per_client_loss"])
            accs.extend(rep["per_client_acc"])
            counts.extend(rep["num_examples"])
        out = summarize_per_client(losses, accs, counts)
        out["num_clusters"] = sum(c is not None for c in self.clusters)
        out["cluster_sizes"] = [int(m.size) for m in self.members]
        return out
