"""Packing ragged per-client shards into static-shape stacked arrays.

Clients own different numbers of examples; every client's shard is padded
to a common capacity ``M`` and a true-count vector rides beside it.  Local
training samples batch indices below the true count, so padding rows are
never trained on, and a client's FedAvg weight is its true count.

A copy of the JAX package's ``data/sharding.py``; both packages produce
identical arrays.  On the host the row gather is numpy's; the engine packs
its block of clients on its device instead (:func:`gather_block`: the
source uploaded once and N2, ``ops/gather.py``, gathering the rows the
host's index arithmetic picks).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from colearn_federated_learning_tpu_torch.ops import gather


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
    tiled_all, counts = client_rows(parts, capacity)
    C, cap = tiled_all.shape
    xs = np.ascontiguousarray(x)[tiled_all.reshape(-1)]
    xs = xs.reshape((C, cap) + x.shape[1:])
    ys = np.asarray(y, np.int32)[tiled_all]
    return ClientShards(x=xs, y=ys, counts=counts)


def client_rows(parts: list[np.ndarray], capacity: int = 0
                ) -> tuple[np.ndarray, np.ndarray]:
    """The source rows of :func:`pack_client_shards`'s slots: ``(rows (C,
    M) int64, counts (C,) int32)``, each client's indices tiled to the
    capacity."""
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
    return tiled_all, counts


def pad_rows_to_multiple(rows: np.ndarray, counts: np.ndarray,
                         multiple: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad the client axis of :func:`client_rows`' output so it divides
    the client mesh axis evenly.  Ghost clients get count 0, which zeroes
    their FedAvg weight: they train on copies of client 0's rows but
    contribute nothing."""
    rem = (-len(counts)) % multiple
    if rem == 0:
        return rows, counts
    return (np.concatenate([rows, np.repeat(rows[:1], rem, axis=0)]),
            np.concatenate([counts, np.zeros(rem, np.int32)]))


def gather_block(x: np.ndarray, y: np.ndarray, rows: np.ndarray, device,
                 seq_split: Optional[tuple[int, int]] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed ``(x, y)`` of the slots whose source rows are ``rows``
    (L, M), on ``device``: ``x`` and ``y`` (as int32 labels widened to
    int64) uploaded whole, once, then one row gather each (N2 on a card).
    ``seq_split`` ``(n, i)`` keeps the ``i``-th of ``n`` equal slices of
    every example's last axis (a sequence-parallel rank's).  Bit for bit
    the host's ``pack_client_shards`` rows at ``rows``."""
    src_x = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    src_y = torch.from_numpy(
        np.asarray(y, np.int32).astype(np.int64)).to(device)
    idx = torch.from_numpy(np.ascontiguousarray(rows.reshape(-1),
                                                np.int64)).to(device)
    xs = gather.gather_rows(src_x, idx).view(rows.shape + src_x.shape[1:])
    if seq_split is not None:
        n, i = seq_split
        xs = xs.tensor_split(n, dim=-1)[i].contiguous()
    ys = gather.gather_rows(src_y, idx).view(rows.shape)
    return xs, ys
