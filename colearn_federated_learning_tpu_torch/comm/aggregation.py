"""Weighted folding of client updates: ``UpdateFolder`` and
``StreamingFolder``.

The counterpart of the JAX package's ``comm/aggregation.py`` folders.
Contributions are wire trees (``fed/compression.py`` frames) in the flax
layout; the folder accumulates their weight-scaled sum, the total weight
and the weighted loss, and ``mean()`` divides.

``StreamingFolder`` stages each contribution when it arrives and sums the
staged contributions in COHORT order at :meth:`StreamingFolder.finalize`,
so the fold is bitwise the same whatever the arrival order.  Topk and
topk8 contributions never densify: they stage as ``(indices, values)``
and scatter into the accumulator.  ``slices`` regroups the sum at block
boundaries, as an aggregator tree folds it.  With ``device_fold=True``
each block folds through the fold kernel (``ops/fold.py``, CUDA on the
card, its plain version when ``device="cpu"``), bitwise equal to the host
fold, which stays the parity oracle.

With ``placement`` (``parallel.partition.ServerPlacement``, the sharded
server) every contribution is sliced into its per-shard layout as it is
staged (topk indices partitioned with offset-adjusted coordinates), the
fold accumulates shard-wise (each leaf a tuple of its shards; the device
fold one slot per shard) and :meth:`StreamingFolder.mean` assembles a
placed tree.  Per element the sum sequence is unchanged, so the sharded
fold is bitwise the replicated one.
"""

from __future__ import annotations

import math
import time
from typing import Any, Optional, Sequence

import numpy as np

from colearn_federated_learning_tpu_torch import telemetry
from colearn_federated_learning_tpu_torch.fed import compression
from colearn_federated_learning_tpu_torch.utils import trees


class _SparseStage:
    """One topk contribution staged sparse: per leaf (flatten order), a
    list of ``(flat_idx, scaled_values, target_shape)`` triples, one per
    shard under a placement and exactly one otherwise."""

    __slots__ = ("leaves",)

    def __init__(self, leaves: list):
        self.leaves = leaves


class _RawSparseStage:
    """One topk contribution staged for the fold kernel: per slot,
    ``(flat_idx, raw_values, dequant_scale)`` (the frame's int32 indices,
    which the kernel stages as they are), topk8 values still
    int8 and the weight not applied (the kernel applies ``(value * scale)
    * weight`` itself)."""

    __slots__ = ("slots", "vals_dtype")

    def __init__(self, slots: list, vals_dtype: Any):
        self.slots = slots
        self.vals_dtype = vals_dtype


def _own_leaf(leaf: Any) -> np.ndarray:
    """A writable, C-contiguous array the fold may mutate in place (a copy
    only if the input is neither)."""
    a = np.asarray(leaf)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a)
    return a


def _partwise(fn):
    """``fn`` over a leaf, or over each shard of a sharded leaf (the tuple
    ``ServerPlacement.slice_tree`` gives)."""
    def apply(*xs):
        if isinstance(xs[0], tuple):
            return tuple(fn(*p) for p in zip(*xs))
        return fn(*xs)
    return apply


def _merge_dense(acc: Any, contrib: Any) -> Any:
    """Elementwise host add for the dense fold, in place where the
    accumulator allows."""
    def add(a, c):
        a = np.asarray(a)
        if a.flags.writeable and a.dtype == np.result_type(a, c):
            return np.add(a, c, out=a)
        return np.add(a, c)
    return trees.map_leaves(_partwise(add), acc, contrib)


class UpdateFolder:
    """Accumulate weighted client deltas; ``mean()`` is None-safe."""

    def __init__(self, shapes: Any):
        self.shapes = shapes            # params-shaped numpy tree
        self.wsum: Optional[Any] = None
        self.total_w = 0.0
        self.loss_sum = 0.0
        self.count = 0

    def add(self, meta: dict, delta: Any,
            weight: Optional[float] = None) -> float:
        """Fold one update; ``weight`` overrides ``meta["weight"]``.
        Returns the weight applied."""
        delta = compression.decompress_delta(delta, meta, shapes=self.shapes)
        w = float(meta.get("weight", 1.0)) if weight is None else float(weight)
        contrib = trees.map_leaves(lambda x: np.asarray(x) * w, delta)
        self.wsum = (contrib if self.wsum is None
                     else trees.map_leaves(np.add, self.wsum, contrib))
        self.total_w += w
        self.loss_sum += float(meta.get("mean_loss", 0.0)) * w
        self.count += 1
        return w

    def mean(self) -> tuple[Optional[Any], float, float]:
        """``(mean_delta | None, total_weight, weighted_mean_loss)``; a
        fold of zero total weight gives ``(None, 0, nan)``."""
        if self.total_w <= 0.0:
            return None, 0.0, math.nan
        return (trees.map_leaves(_partwise(lambda x: x * (1.0 / self.total_w)),
                                 self.wsum),
                self.total_w, self.loss_sum / self.total_w)


class StreamingFolder(UpdateFolder):
    """An ``UpdateFolder`` that stages each update as it arrives and sums
    in ``order`` (the cohort order) at :meth:`finalize`.

    - Topk/topk8 updates stage sparse (O(k) per update) and scatter into
      the accumulator: the first contribution of a block is assigned into
      fresh zeros, the rest are added.  ``densify_avoided`` counts them.
    - ``slices`` partitions the cohort order into blocks, each folded from
      zero and then combined in block order (staged ids outside every
      slice fold as one trailing block).
    - ``device_fold=True`` folds each block through ``ops/fold.py``'s
      kernel on ``device`` (``None``: the card, raising without one):
      topk updates stage raw (int8 values and scale, weight unapplied)
      and fold as one batched sparse call per run, dense ones as one
      batched add, split only where the run's kind or value dtype
      changes, so the order is the cohort order and the result is bitwise
      :meth:`_fold_block`'s.  Under a placement the kernel's slots are the
      shards (:meth:`_slot_layout`).
    - ``placement`` slices every contribution per shard as it is staged;
      :meth:`mean` assembles the placed tree.
    """

    def __init__(self, shapes: Any, order: Optional[Sequence[str]] = None,
                 placement: Optional[Any] = None,
                 slices: Optional[Sequence[Sequence[str]]] = None,
                 device_fold: bool = False, device=None):
        super().__init__(shapes)
        self._order = list(order) if order is not None else None
        self._staged: dict[str, tuple[float, Any, float]] = {}
        self._placement = placement
        self._slices = ([list(s) for s in slices]
                        if slices is not None else None)
        self.folded_ids: list[str] = []
        self.densify_avoided = 0
        # Seconds add() spent decoding and staging: work a streaming
        # caller overlaps with the replies still in flight.
        self.fold_s = 0.0
        self._finalized = False
        self._device_fold = bool(device_fold)
        self._device = device
        self._kernel = None
        self._slot_meta: Optional[list] = None
        self._fold_batch_max: Optional[int] = None

    def add(self, meta: dict, delta: Any,
            weight: Optional[float] = None) -> float:
        if self._finalized:
            raise RuntimeError("StreamingFolder already finalized")
        t0 = time.perf_counter()
        w = float(meta.get("weight", 1.0)) if weight is None else float(weight)
        if meta.get("compress") in compression.TOPK_SCHEMES:
            contrib = (self._stage_topk_raw(delta) if self._device_fold
                       else self._stage_topk(delta, w))
            self.densify_avoided += 1
            telemetry.get_registry().counter(
                "comm.uplink_densify_avoided_total").inc()
        else:
            # int8 and none are dense by nature.
            delta = compression.decompress_delta(delta, meta,
                                                 shapes=self.shapes)
            if self._placement is not None:
                # Sliced and scaled in one pass: the slices of the scaled
                # leaf, bit for bit.
                contrib = self._placement.slice_tree(delta, scale=w)
            else:
                contrib = trees.map_leaves(lambda x: np.asarray(x) * w,
                                           delta)
        cid = str(meta.get("client_id", len(self._staged)))
        self._staged[cid] = (w, contrib,
                             float(meta.get("mean_loss", 0.0)) * w)
        self.count += 1
        self.fold_s += time.perf_counter() - t0
        return w

    def _stage_topk(self, wire_tree: Any, w: float) -> _SparseStage:
        """Scaled ``(indices, values)`` per leaf: scaling before the scatter
        equals scaling after densifying, bit for bit."""
        nodes = trees.flatten_up_to(self.shapes, wire_tree)
        sw = np.float32(w)
        leaves = []
        for pos, (node, ref) in enumerate(zip(nodes,
                                              trees.leaves(self.shapes))):
            idx, vals, _ = compression.topk_leaf_arrays(node)
            vals = vals * sw
            if self._placement is not None:
                leaves.append(
                    self._placement.partition_flat_indices(pos, idx, vals))
            else:
                leaves.append([(idx, vals, tuple(np.shape(ref)))])
        return _SparseStage(leaves)

    def _stage_topk_raw(self, wire_tree: Any) -> _RawSparseStage:
        """Raw ``(indices, values, scale)`` per slot for the kernel, the
        frame's int32 indices as they came (a shard's own int64 ones under
        a placement; masking keeps the values' dtype)."""
        slots = []
        vdt = np.dtype(np.float32)
        for pos, node in enumerate(trees.flatten_up_to(self.shapes,
                                                       wire_tree)):
            idx, vals, scale, _ = compression.topk_leaf_raw(node)
            vdt = vals.dtype
            if self._placement is not None:
                slots += [(li, lv, scale) for li, lv, _ in
                          self._placement.partition_flat_indices(
                              pos, idx, vals)]
            else:
                slots.append((idx, vals, scale))
        return _RawSparseStage(slots, vdt)

    def add_partial(self, key: str, total_w: float, tree: Any,
                    loss_sum: float, count: int = 1) -> None:
        """Stage one pre-folded partial sum (an aggregator's slice fold):
        ``tree`` its weighted-sum tree (or ``None``), ``total_w`` and
        ``loss_sum`` its weight and weighted loss."""
        if self._finalized:
            raise RuntimeError("StreamingFolder already finalized")
        t0 = time.perf_counter()
        contrib = (None if tree is None
                   else trees.map_leaves(_own_leaf, tree))
        if contrib is not None and self._placement is not None:
            # Slicing commutes with the adds, so the sharded combine is
            # bitwise the replicated one.
            contrib = self._placement.slice_tree(contrib)
        self._staged[str(key)] = (float(total_w), contrib, float(loss_sum))
        self.count += int(count)
        self.fold_s += time.perf_counter() - t0

    def discard(self, key: str) -> bool:
        """Drop one staged contribution before finalize; True if one was
        dropped."""
        if self._finalized:
            raise RuntimeError("StreamingFolder already finalized")
        if self._staged.pop(str(key), None) is None:
            return False
        self.count -= 1
        return True

    def _scatter_fold(self, acc: Any, stage: _SparseStage) -> Any:
        """Fold one sparse contribution: assignment into fresh zeros when
        it is the first, else an in-place scatter-add (untouched entries
        keep their bits, a -0.0 included), shard by shard under a
        placement."""
        sharded = self._placement is not None
        if acc is None:
            out = []
            for shards in stage.leaves:
                parts = []
                for idx, vals, shape in shards:
                    flat = np.zeros(int(np.prod(shape, dtype=np.int64)),
                                    np.float32)
                    flat[idx] = vals
                    parts.append(flat.reshape(shape))
                out.append(tuple(parts) if sharded else parts[0])
            return trees.unflatten(self.shapes, out)
        for leaf, shards in zip(trees.flatten_up_to(self.shapes, acc),
                                stage.leaves):
            for arr, (idx, vals, _) in zip(leaf if sharded else (leaf,),
                                           shards):
                # reshape(-1) of a C-contiguous array is a view: += mutates
                # acc.
                arr.reshape(-1)[idx] += vals
        return acc

    def _fold_block(self, ids: Sequence[str]) -> tuple[Any, float, float]:
        """The host fold of one block, from zero: the parity oracle."""
        acc, tw, ls = None, 0.0, 0.0
        for cid in ids:
            w, contrib, loss_w = self._staged[cid]
            if isinstance(contrib, _SparseStage):
                acc = self._scatter_fold(acc, contrib)
            elif contrib is not None:
                acc = contrib if acc is None else _merge_dense(acc, contrib)
            tw += w
            ls += loss_w
        return acc, tw, ls

    def _slot_layout(self) -> list:
        """Per leaf (flatten order): the shapes of the slots the device fold
        accumulates into, one per distinct shard under a placement
        (``slice_tree``'s order) and exactly one otherwise."""
        if self._slot_meta is None:
            refs = trees.leaves(self.shapes)
            if self._placement is None:
                self._slot_meta = [[tuple(np.shape(r))] for r in refs]
            else:
                no_idx = np.zeros(0, np.int64)
                no_val = np.zeros(0, np.float32)
                self._slot_meta = [
                    [tuple(shape) for _, _, shape in
                     self._placement.partition_flat_indices(
                         pos, no_idx, no_val)]
                    for pos in range(len(refs))]
        return self._slot_meta

    def _dense_slots(self, contrib: Any) -> list:
        """One staged dense or partial tree as the kernel's flat slot list
        (views: staged leaves are C-contiguous)."""
        return [np.asarray(part).reshape(-1)
                for leaf in trees.flatten_up_to(self.shapes, contrib)
                for part in (leaf if isinstance(leaf, tuple) else (leaf,))]

    def _fold_block_device(self, ids: Sequence[str]) -> tuple:
        """The block fold through the fold kernel: sparse runs as batched
        sparse calls, dense runs as batched adds, one copy to the host at
        the block's end."""
        from colearn_federated_learning_tpu_torch.ops import fold

        if self._kernel is None:
            sizes = [int(np.prod(shape, dtype=np.int64))
                     for group in self._slot_layout() for shape in group]
            self._kernel = fold.get_kernel(sizes, self._device)
        kernel = self._kernel
        acc = None
        tw, ls, folded = 0.0, 0.0, 0
        cap = self._fold_batch_max or len(ids) or 1
        sparse_run: list = []
        dense_run: list = []
        run_dtype = None

        def flush_sparse():
            nonlocal acc
            while sparse_run:
                acc = kernel.fold_sparse(acc, sparse_run[:cap])
                del sparse_run[:cap]

        def flush_dense():
            nonlocal acc
            while dense_run:
                acc = kernel.fold_dense(acc, dense_run[:cap])
                del dense_run[:cap]

        for cid in ids:
            w, contrib, loss_w = self._staged[cid]
            tw += w
            ls += loss_w
            if isinstance(contrib, _RawSparseStage):
                if dense_run:
                    flush_dense()
                if sparse_run and run_dtype != contrib.vals_dtype:
                    flush_sparse()
                run_dtype = contrib.vals_dtype
                sparse_run.append((np.float32(w), contrib.slots))
                folded += 1
            elif contrib is not None:
                if sparse_run:
                    flush_sparse()
                dense_run.append(self._dense_slots(contrib))
                folded += 1
        flush_sparse()
        flush_dense()
        if folded:
            telemetry.get_registry().counter(
                "comm.fold_device_total").inc(folded)
        if acc is None:
            return None, tw, ls
        it = iter(kernel.to_host(acc))
        out = []
        for group in self._slot_layout():
            parts = [next(it).reshape(shape) for shape in group]
            out.append(tuple(parts) if self._placement is not None
                       else parts[0])
        return trees.unflatten(self.shapes, out), tw, ls

    def finalize(self) -> None:
        """Sum the staged contributions in cohort order (idempotent)."""
        if self._finalized:
            return
        self._finalized = True
        order = (self._order if self._order is not None
                 else sorted(self._staged))
        ids = [cid for cid in order if cid in self._staged]
        ids += [cid for cid in self._staged if cid not in ids]
        if self._slices is None:
            blocks = [ids]
        else:
            covered: set[str] = set()
            blocks = []
            for sl in self._slices:
                covered.update(str(c) for c in sl)
                blk = [str(c) for c in sl if str(c) in self._staged]
                if blk:
                    blocks.append(blk)
            stragglers = [cid for cid in ids if cid not in covered]
            if stragglers:
                blocks.append(stragglers)
            ids = [cid for blk in blocks for cid in blk]
        for blk in blocks:
            acc, tw, ls = (self._fold_block_device(blk) if self._device_fold
                           else self._fold_block(blk))
            if acc is not None:
                self.wsum = (acc if self.wsum is None
                             else _merge_dense(self.wsum, acc))
            self.total_w += tw
            self.loss_sum += ls
        self.folded_ids = ids
        self._staged.clear()

    def apply_correction(self, tree: Any) -> None:
        """Subtract a correction term (secure aggregation's recovered masks)
        from the finalized weighted sum."""
        if not self._finalized:
            raise RuntimeError(
                "apply_correction requires a finalized fold (the "
                "correction is defined relative to the completed sum)")
        if self.wsum is None:
            return
        if self._placement is not None:
            # The staged layout: the subtraction runs slice-wise.
            tree = self._placement.slice_tree(tree)
        self.wsum = trees.map_leaves(_partwise(np.subtract), self.wsum, tree)

    def mean(self) -> tuple[Optional[Any], float, float]:
        """``UpdateFolder.mean`` after :meth:`finalize`; under a placement
        the mean is assembled, each shard on its position's device."""
        self.finalize()
        mean_delta, total_w, mean_loss = super().mean()
        if mean_delta is not None and self._placement is not None:
            mean_delta = self._placement.assemble(mean_delta)
        return mean_delta, total_w, mean_loss
