"""Downlink delta compression for the socket broadcast (the counterpart of
the JAX package's ``comm/downlink.py``; the frames are byte-equal to its
for the same params).

- The coordinator broadcasts the server delta (params_r − base_{r−1})
  through the ``int8``/``topk`` codecs (``fed.compress_down``; ``none``,
  the default, keeps the plain full-params frame).
- Every worker caches the last global params it applied, keyed by round
  (:class:`WorkerParamCache`), and rebuilds ``base + delta``.
- The codecs are lossy, so the coordinator diffs against the params the
  workers actually rebuilt (implicit error feedback).
- A cache miss or a round gap makes the worker reply ``status="resync"``
  and the coordinator re-send the full rebuilt params, so every worker
  holds the same bytes however it rejoined.

The synchronous coordinator only.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from colearn_federated_learning_tpu_torch import telemetry
from colearn_federated_learning_tpu_torch.fed import compression
from colearn_federated_learning_tpu_torch.parallel import partition
from colearn_federated_learning_tpu_torch.utils import trees
from colearn_federated_learning_tpu_torch.utils.serialization import (
    pytree_to_bytes, wire_frame_length)

# Broadcast meta slots (CLW1 frame meta, beside "round").
DOWN_KEY = "down"            # "full" | "delta"; absent = plain broadcast
DOWN_BASE_KEY = "down_base"  # round whose cached params the delta is against
MODE_FULL = "full"
MODE_DELTA = "delta"


def apply_dense_delta(base: Any, delta: Any) -> Any:
    """``base + delta`` leafwise with float32 accumulation, base dtypes
    kept.  The coordinator and every worker run this on identical arrays,
    so their rebuilt params agree bitwise."""
    def add(b, d):
        b = np.asarray(b)
        return (b.astype(np.float32)
                + np.asarray(d, np.float32)).astype(b.dtype)

    return trees.map_leaves(add, base, delta)


def host_params(tree: Any) -> Any:  # colearn: hot
    """A host copy of the server params (``parallel.partition.host_tree``):
    a tensor leaf in one device-to-host copy (a copy of a CPU tensor too,
    which the server updates in place), a sharded leaf shard by shard
    into one buffer with no gathered device copy, numpy leaves as they
    are.  The bytes the sharded leaves' replicated layout would have held
    per position count in ``comm.gather_bytes_avoided_total``."""
    avoided = partition.tree_gather_avoided(tree)
    if avoided:
        telemetry.get_registry().counter(
            "comm.gather_bytes_avoided_total").inc(avoided)
    return partition.host_tree(tree)


def _float32_tensors(tree: Any) -> bool:
    leaves = trees.leaves(tree)
    return bool(leaves) and all(
        isinstance(l, torch.Tensor) and l.dtype == torch.float32
        for l in leaves)


class DownlinkEncoder:
    """Per-round broadcast encoder (coordinator side): one CLW1 encode per
    round — counted in ``comm.broadcast_encode_total`` — whose frame every
    cohort send shares read-only (serialize-once)."""

    def __init__(self, scheme: str = "none"):
        if scheme not in compression.SCHEMES:
            raise ValueError(
                f"unknown compress_down {scheme!r} "
                f"(use {compression.SCHEMES})")
        self.scheme = scheme
        # (round, rebuilt params): what the workers' caches hold.
        self._base: Optional[tuple[int, Any]] = None

    def encode_round(
        self, r: int, params: Any
    ) -> tuple[memoryview, Optional[Callable[[], memoryview]], int]:
        """Round ``r``'s broadcast: ``(body, resync_body,
        bytes_saved_per_send)``.  ``body`` is the shared frame;
        ``resync_body`` (None when the scheme is off) encodes, at most
        once, the full rebuilt params for workers that answered
        "resync"; ``bytes_saved_per_send`` is what a delta send saves over
        a full-params one.  ``params`` is a tree of tensors or arrays."""
        reg = telemetry.get_registry()
        # A topk scheme over plain float32 tensors (the server state on its
        # device) diffs, selects (N1 on a card) and rebuilds there, so after
        # the first round only the frame's kept entries reach the host.
        on_device = (self.scheme in compression.TOPK_SCHEMES
                     and _float32_tensors(params))
        if on_device and self._base is not None:
            return self._encode_on_device(r, params)
        params_np = host_params(params)
        if self.scheme == "none":
            body = pytree_to_bytes(params_np, {"round": r})
            reg.counter("comm.broadcast_encode_total").inc()
            return memoryview(body), None, 0
        if self._base is None:
            body = pytree_to_bytes(params_np,
                                   {"round": r, DOWN_KEY: MODE_FULL})
            reg.counter("comm.broadcast_encode_total").inc()
            self._base = (r, trees.map_leaves(
                lambda p: p.detach().clone(), params) if on_device
                else params_np)
            return memoryview(body), self._resync_fn(r, params_np), 0

        base_round, base = self._base
        delta = trees.map_leaves(
            lambda a, b: np.asarray(a, np.float32) - np.asarray(b, np.float32),
            params_np, base)
        wire, cmeta = compression.compress_delta(delta, self.scheme)
        meta = {"round": r, DOWN_KEY: MODE_DELTA, DOWN_BASE_KEY: base_round,
                **cmeta}
        body = pytree_to_bytes(wire, meta)
        reg.counter("comm.broadcast_encode_total").inc()
        recon = apply_dense_delta(
            base, compression.decompress_delta(wire, cmeta, shapes=base))
        self._base = (r, recon)
        # What a full-params broadcast would have cost this round, minus
        # the delta frame.
        full_len = wire_frame_length(
            params_np, {"round": r, DOWN_KEY: MODE_FULL})
        saved = max(0, full_len - len(body))
        return memoryview(body), self._resync_fn(r, recon), saved

    def _encode_on_device(
        self, r: int, params: Any
    ) -> tuple[memoryview, Callable[[], memoryview], int]:
        """:meth:`encode_round`'s delta round on the params' device, its
        base there too: the same frame and rebuilt params as the host's."""
        base_round, base = self._base
        delta = trees.map_leaves(lambda p, b: p.detach() - b, params, base)
        wire, cmeta, decoded = compression.compress_decode(delta,
                                                           self.scheme)
        meta = {"round": r, DOWN_KEY: MODE_DELTA, DOWN_BASE_KEY: base_round,
                **cmeta}
        body = pytree_to_bytes(wire, meta)
        telemetry.get_registry().counter("comm.broadcast_encode_total").inc()
        recon = trees.map_leaves(torch.add, base, decoded)
        self._base = (r, recon)
        shapes = trees.map_leaves(
            lambda p: np.broadcast_to(np.float32(0), tuple(p.shape)), params)
        full_len = wire_frame_length(
            shapes, {"round": r, DOWN_KEY: MODE_FULL})
        saved = max(0, full_len - len(body))
        return memoryview(body), self._resync_fn(r, recon), saved

    def _resync_fn(self, r: int, recon: Any) -> Callable[[], memoryview]:
        """Lazy one-shot encoder of the round's full rebuilt params, shared
        by concurrent resyncs."""
        lock = threading.Lock()
        cache: list[memoryview] = []

        def resync_body() -> memoryview:
            with lock:
                if not cache:
                    telemetry.get_registry().counter(
                        "comm.broadcast_encode_total").inc()
                    cache.append(memoryview(pytree_to_bytes(
                        compression.host_tree(recon),
                        {"round": r, DOWN_KEY: MODE_FULL})))
                return cache[0]

        return resync_body


class WorkerParamCache:
    """Worker-side cache of the last applied global params, keyed by
    round.  ``resolve`` returns the round's full params (applying a delta
    to the cache when the broadcast is compressed), or ``None`` when the
    worker must ask for a resync."""

    def __init__(self) -> None:
        self._round: Optional[int] = None
        self._params: Any = None

    def resolve(self, round_idx: int, meta: dict, tree: Any) -> Any:
        mode = meta.get(DOWN_KEY)
        if mode == MODE_DELTA:
            if self._round == round_idx:
                # A transport retry of a round already applied.
                return self._params
            base = meta.get(DOWN_BASE_KEY)
            if self._params is None or self._round != base:
                return None          # restart or skipped round: resync
            delta = compression.decompress_delta(tree, meta,
                                                 shapes=self._params)
            params = apply_dense_delta(self._params, delta)
            self._round, self._params = round_idx, params
            return params
        params = trees.map_leaves(np.asarray, tree)
        self._round, self._params = round_idx, params
        return params
