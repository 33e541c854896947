"""Per-client dataset partitioning (IID and Dirichlet non-IID).

The reference assumes each IoT device already owns its local shard and only
negotiates dataset identity over MQTT (SURVEY.md §2 "Data loaders:
per-client (non-IID) partitioning").  In simulation we materialize the
partition: IID round-robin, or the standard Dirichlet(α) label-skew scheme
used by BASELINE config #2 ("100 non-IID clients (Dirichlet α=0.5)").

Partitioning is host-side preprocessing (runs once, feeds static-shape
device arrays), so it uses numpy.  A copy of the JAX package's
``data/partition.py``; both packages produce identical partitions.
"""

from __future__ import annotations

import numpy as np


def iid_partition(n_examples: int, num_clients: int, seed: int = 0) -> list[np.ndarray]:
    """Shuffle and deal examples round-robin; sizes differ by at most 1."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_examples)
    return [np.sort(perm[c::num_clients]) for c in range(num_clients)]


def dirichlet_partition(
    labels: np.ndarray,
    num_clients: int,
    alpha: float,
    seed: int = 0,
    min_per_client: int = 1,
) -> list[np.ndarray]:
    """Label-skewed split: for each class, proportions ~ Dirichlet(α).

    Small α → each client sees few classes (highly non-IID); large α → IID.
    Re-draws until every client holds at least ``min_per_client`` examples so
    downstream static-shape packing never sees an empty shard.
    """
    labels = np.asarray(labels)
    n_classes = int(labels.max()) + 1
    rng = np.random.default_rng(seed)

    for _attempt in range(100):
        shards: list[list[np.ndarray]] = [[] for _ in range(num_clients)]
        for c in range(n_classes):
            idx = np.flatnonzero(labels == c)
            rng.shuffle(idx)
            props = rng.dirichlet(np.full(num_clients, alpha))
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for client, part in enumerate(np.split(idx, cuts)):
                shards[client].append(part)
        out = [np.sort(np.concatenate(s)) if s else np.empty(0, np.int64) for s in shards]
        if min(len(s) for s in out) >= min_per_client:
            return out
    raise RuntimeError(
        f"dirichlet_partition: could not give every one of {num_clients} clients "
        f">= {min_per_client} examples (alpha={alpha}, n={len(labels)})"
    )


def pathological_partition(
    labels: np.ndarray,
    num_clients: int,
    shards_per_client: int = 2,
    seed: int = 0,
) -> list[np.ndarray]:
    """McMahan et al. (2017) §3 "pathological non-IID" split: sort the
    examples by label, cut them into ``num_clients * shards_per_client``
    equal contiguous shards, and deal each client ``shards_per_client``
    shards at random — so most clients see only ``shards_per_client``
    distinct digits.  This is the partition behind the paper's Table 1
    non-IID rows, which scripts/validate_literature.py reproduces as the
    framework's literature anchor (SURVEY.md hard-part #5).

    A stable mergesort keeps equal-label runs in index order, so the split
    is deterministic given (labels, seed).
    """
    labels = np.asarray(labels)
    n = len(labels)
    n_shards = num_clients * shards_per_client
    if n_shards > n:
        raise ValueError(
            f"need >= {n_shards} examples for {num_clients} clients x "
            f"{shards_per_client} shards, have {n}"
        )
    order = np.argsort(labels, kind="stable")
    shard_ids = np.random.default_rng(seed).permutation(n_shards)
    bounds = np.linspace(0, n, n_shards + 1).astype(int)
    return [
        np.sort(np.concatenate([
            order[bounds[s]:bounds[s + 1]]
            for s in shard_ids[c * shards_per_client:(c + 1) * shards_per_client]
        ]))
        for c in range(num_clients)
    ]


def partition_counts(parts: list[np.ndarray]) -> np.ndarray:
    return np.array([len(p) for p in parts], dtype=np.int32)


def label_distribution(labels: np.ndarray, parts: list[np.ndarray], n_classes: int) -> np.ndarray:
    """(num_clients, n_classes) histogram — used by tests to assert skew."""
    out = np.zeros((len(parts), n_classes), dtype=np.int64)
    for i, p in enumerate(parts):
        binc = np.bincount(labels[p], minlength=n_classes)
        out[i] = binc[:n_classes]
    return out
