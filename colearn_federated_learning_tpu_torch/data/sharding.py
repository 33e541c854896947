"""Packing ragged per-client shards into static-shape stacked arrays.

Clients own different numbers of examples; every client's shard is padded
to a common capacity ``M`` and a true-count vector rides beside it.  Local
training samples batch indices below the true count, so padding rows are
never trained on, and a client's FedAvg weight is its true count.

A copy of the JAX package's ``data/sharding.py`` (the row gather is plain
numpy here); both packages produce identical arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ClientShards:
    """Stacked, padded per-client data: leaves shaped (num_clients, M, ...)."""

    x: np.ndarray        # (C, M, *example_shape)
    y: np.ndarray        # (C, M) int32
    counts: np.ndarray   # (C,) int32 — true examples per client

    @property
    def num_clients(self) -> int:
        return self.x.shape[0]

    @property
    def capacity(self) -> int:
        return self.x.shape[1]


def pack_client_shards(
    x: np.ndarray,
    y: np.ndarray,
    parts: list[np.ndarray],
    capacity: int = 0,
) -> ClientShards:
    """Stack per-client index lists into padded (C, M, ...) arrays.

    ``capacity`` defaults to the largest shard.  Padding rows repeat the
    client's own data (cyclic tiling) rather than zeros; correctness does
    not depend on it because sampling always stays below ``counts``.
    """
    sizes = [len(p) for p in parts]
    if min(sizes) == 0:
        raise ValueError("pack_client_shards: a client has zero examples")
    cap = capacity or max(sizes)
    C = len(parts)
    tiled_all = np.empty((C, cap), dtype=np.int64)
    counts = np.zeros((C,), dtype=np.int32)
    for c, idx in enumerate(parts):
        take = np.asarray(idx[:cap])
        reps = int(np.ceil(cap / len(take)))
        tiled_all[c] = np.tile(take, reps)[:cap]
        counts[c] = min(len(idx), cap)
    xs = np.ascontiguousarray(x)[tiled_all.reshape(-1)]
    xs = xs.reshape((C, cap) + x.shape[1:])
    ys = np.asarray(y, np.int32)[tiled_all]
    return ClientShards(x=xs, y=ys, counts=counts)
