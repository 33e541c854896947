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

The sharded server (``placement=``) is not ported: it raises, naming
ROADMAP.md Queue A item 7.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import numpy as np

from colearn_federated_learning_tpu_torch.fed import compression
from colearn_federated_learning_tpu_torch.utils import trees


class _SparseStage:
    """One topk contribution staged sparse: per leaf (flatten order), one
    ``(flat_idx, scaled_values, target_shape)`` triple."""

    __slots__ = ("leaves",)

    def __init__(self, leaves: list):
        self.leaves = leaves


class _RawSparseStage:
    """One topk contribution staged for the fold kernel: per slot,
    ``(flat_idx int64, raw_values, dequant_scale)``, topk8 values still
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


def _merge_dense(acc: Any, contrib: Any) -> Any:
    """Elementwise host add for the dense fold, in place where the
    accumulator allows."""
    def add(a, c):
        a = np.asarray(a)
        if a.flags.writeable and a.dtype == np.result_type(a, c):
            return np.add(a, c, out=a)
        return np.add(a, c)
    return trees.map_leaves(add, acc, contrib)


def _refuse_placement(placement: Any) -> None:
    if placement is not None:
        raise NotImplementedError(
            "the sharded server (placement=) is not ported yet; see "
            "ROADMAP.md Queue A item 7 (TP and SP)")


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
        return (trees.map_leaves(lambda x: x * (1.0 / self.total_w),
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
      :meth:`_fold_block`'s.
    """

    def __init__(self, shapes: Any, order: Optional[Sequence[str]] = None,
                 placement: Optional[Any] = None,
                 slices: Optional[Sequence[Sequence[str]]] = None,
                 device_fold: bool = False, device=None):
        _refuse_placement(placement)
        super().__init__(shapes)
        self._order = list(order) if order is not None else None
        self._staged: dict[str, tuple[float, Any, float]] = {}
        self._slices = ([list(s) for s in slices]
                        if slices is not None else None)
        self.folded_ids: list[str] = []
        self.densify_avoided = 0
        self._finalized = False
        self._device_fold = bool(device_fold)
        self._device = device
        self._kernel = None
        self._fold_batch_max: Optional[int] = None

    def add(self, meta: dict, delta: Any,
            weight: Optional[float] = None) -> float:
        if self._finalized:
            raise RuntimeError("StreamingFolder already finalized")
        w = float(meta.get("weight", 1.0)) if weight is None else float(weight)
        if meta.get("compress") in compression.TOPK_SCHEMES:
            contrib = (self._stage_topk_raw(delta) if self._device_fold
                       else self._stage_topk(delta, w))
            self.densify_avoided += 1
        else:
            # int8 and none are dense by nature.
            delta = compression.decompress_delta(delta, meta,
                                                 shapes=self.shapes)
            contrib = trees.map_leaves(lambda x: np.asarray(x) * w, delta)
        cid = str(meta.get("client_id", len(self._staged)))
        self._staged[cid] = (w, contrib,
                             float(meta.get("mean_loss", 0.0)) * w)
        self.count += 1
        return w

    def _stage_topk(self, wire_tree: Any, w: float) -> _SparseStage:
        """Scaled ``(indices, values)`` per leaf: scaling before the scatter
        equals scaling after densifying, bit for bit."""
        nodes = trees.flatten_up_to(self.shapes, wire_tree)
        sw = np.float32(w)
        leaves = []
        for node, ref in zip(nodes, trees.leaves(self.shapes)):
            idx, vals, _ = compression.topk_leaf_arrays(node)
            leaves.append((idx, vals * sw, tuple(np.shape(ref))))
        return _SparseStage(leaves)

    def _stage_topk_raw(self, wire_tree: Any) -> _RawSparseStage:
        """Raw ``(int64 indices, values, scale)`` per slot for the kernel."""
        slots = []
        vdt = np.dtype(np.float32)
        for node in trees.flatten_up_to(self.shapes, wire_tree):
            idx, vals, scale, _ = compression.topk_leaf_raw(node)
            vdt = vals.dtype
            slots.append((np.ascontiguousarray(idx, np.int64), vals, scale))
        return _RawSparseStage(slots, vdt)

    def add_partial(self, key: str, total_w: float, tree: Any,
                    loss_sum: float, count: int = 1) -> None:
        """Stage one pre-folded partial sum (an aggregator's slice fold):
        ``tree`` its weighted-sum tree (or ``None``), ``total_w`` and
        ``loss_sum`` its weight and weighted loss."""
        if self._finalized:
            raise RuntimeError("StreamingFolder already finalized")
        contrib = (None if tree is None
                   else trees.map_leaves(_own_leaf, tree))
        self._staged[str(key)] = (float(total_w), contrib, float(loss_sum))
        self.count += int(count)

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
        keep their bits, a -0.0 included)."""
        if acc is None:
            out = []
            for idx, vals, shape in stage.leaves:
                flat = np.zeros(int(np.prod(shape, dtype=np.int64)),
                                np.float32)
                flat[idx] = vals
                out.append(flat.reshape(shape))
            return trees.unflatten(self.shapes, out)
        new = []
        for arr, (idx, vals, _) in zip(trees.flatten_up_to(self.shapes, acc),
                                       stage.leaves):
            # reshape(-1) of a C-contiguous array is a view: += mutates acc.
            arr.reshape(-1)[idx] += vals
            new.append(arr)
        return trees.unflatten(self.shapes, new)

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

    def _fold_block_device(self, ids: Sequence[str]) -> tuple:
        """The block fold through the fold kernel: sparse runs as batched
        sparse calls, dense runs as batched adds, one copy to the host at
        the block's end."""
        from colearn_federated_learning_tpu_torch.ops import fold

        refs = trees.leaves(self.shapes)
        if self._kernel is None:
            sizes = [int(np.prod(np.shape(r), dtype=np.int64)) for r in refs]
            self._kernel = fold.get_kernel(sizes, self._device)
        kernel = self._kernel
        acc = None
        tw, ls = 0.0, 0.0
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
            elif contrib is not None:
                if sparse_run:
                    flush_sparse()
                dense_run.append([np.asarray(leaf).reshape(-1) for leaf
                                  in trees.flatten_up_to(self.shapes,
                                                         contrib)])
        flush_sparse()
        flush_dense()
        if acc is None:
            return None, tw, ls
        flat = kernel.to_host(acc)
        tree = trees.unflatten(self.shapes, [
            part.reshape(np.shape(r)) for part, r in zip(flat, refs)])
        return tree, tw, ls

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
        self.wsum = trees.map_leaves(np.subtract, self.wsum, tree)

    def mean(self) -> tuple[Optional[Any], float, float]:
        self.finalize()
        return super().mean()
