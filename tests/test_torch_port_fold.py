"""The port's folders (``comm/aggregation.py``) and fold kernel
(``ops/fold.py``, its plain version on the CPU) against the JAX package's
``StreamingFolder``, which is held to its host fold and to both of its
kernel lowerings (``COLEARN_FOLD_BACKEND`` ``native`` and ``xla``).

Every comparison is BITWISE (the weighted sums' bytes, the total weight
and the weighted loss exactly): both folds make the same float32
roundings in the same order, ``(value * scale) * weight`` for topk8, the
first contribution assigned and the rest added in cohort order.  Mirrors
``tests/test_fold_kernel.py`` and ``tests/test_uplink_fastpath.py``: every
frame type, partial cohorts, ``slices`` (the aggregator-tree layout),
pre-folded partials, ``apply_correction``, batched against one-at-a-time
folding, a staged ``-0.0``, the kernel cache and staging ownership.

The kernel's staging is checked here too: int32 indices whatever the
caller's integer dtype, 5 (topk8) or 8 (topk) staged bytes per entry, the
whole batch checked before anything is written, int32-sized slots, and
the tile plan (``fold.tile_table``) walked as ``csrc/fold.cu`` walks it:
every entry exactly once, in its own slot, over empty slots, empty
contributions, a one-entry contribution and runs that start unaligned.
"""

import os
import random

import jax
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.comm.aggregation import (
    StreamingFolder as JaxFolder)
from colearn_federated_learning_tpu.comm.aggregation import (
    UpdateFolder as JaxUpdateFolder)
from colearn_federated_learning_tpu.ops import fold_kernel
from colearn_federated_learning_tpu_torch.comm.aggregation import (
    StreamingFolder, UpdateFolder)
from colearn_federated_learning_tpu_torch.fed import compression
from colearn_federated_learning_tpu_torch.ops import fold
from colearn_federated_learning_tpu_torch.utils import trees

JAX_BACKENDS = ["native", "xla"]
SCHEMES = ["none", "int8", "topk", "topk8"]


@pytest.fixture(autouse=True)
def _fresh_kernel_caches():
    fold_kernel.clear_kernel_cache()
    fold.clear_kernel_cache()
    yield
    fold_kernel.clear_kernel_cache()
    fold.clear_kernel_cache()


def _params():
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {
        "params": {
            "Embed_0": {"embedding": f(16, 8)},
            "TransformerBlock_0": {
                "attn": {"query": {"kernel": f(8, 4, 2), "bias": f(4, 2)},
                         "out": {"kernel": f(4, 2, 8)}},
                "Dense_0": {"kernel": f(8, 32), "bias": f(32)},
                "Dense_1": {"kernel": f(32, 8)},
                "LayerNorm_0": {"scale": f(8)},
            },
        }
    }


def _updates(scheme, n=5, fraction=0.1, seed=300, shapes=None):
    """n (meta, wire) contributions, compressed by the port (its frames are
    JAX's, tests/test_torch_port_fileplane.py)."""
    shapes = _params() if shapes is None else shapes
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        d = trees.map_leaves(
            lambda w: rng.standard_normal(w.shape).astype(np.float32), shapes)
        wire, cmeta = compression.compress_delta(d, scheme,
                                                 topk_fraction=fraction)
        meta = {"client_id": str(i), "weight": 1.0 + 0.25 * i,
                "mean_loss": 0.5 + 0.1 * i, **cmeta}
        out.append((meta, wire))
    return out


def _copy(wire):
    return jax.tree.map(np.copy, wire)


def _feed(f, updates, partials=(), correction=None, batch_max=None):
    if batch_max is not None:
        f._fold_batch_max = batch_max
    for meta, wire in updates:
        f.add(dict(meta), _copy(wire))
    for key, tw, tree, ls in partials:
        f.add_partial(key, tw, tree, ls)
    f.finalize()
    if correction is not None:
        f.apply_correction(correction)
    return f


def _order(updates, partials=()):
    return ([m["client_id"] for m, _ in updates]
            + [key for key, *_ in partials])


def _port(shapes, updates, *, device=False, order=None, slices=None,
          **kw):
    order = _order(updates, kw.get("partials", ())) if order is None else order
    f = StreamingFolder(shapes, order=order, slices=slices,
                        device_fold=device, device="cpu")
    return _feed(f, updates, **kw)


def _jax(shapes, updates, *, backend=None, order=None, slices=None, **kw):
    order = _order(updates, kw.get("partials", ())) if order is None else order
    prev = os.environ.get("COLEARN_FOLD_BACKEND")
    if backend is not None:
        os.environ["COLEARN_FOLD_BACKEND"] = backend
    try:
        f = JaxFolder(shapes, order=order, slices=slices,
                      device_fold=backend is not None)
        return _feed(f, updates, **kw)
    finally:
        if prev is None:
            os.environ.pop("COLEARN_FOLD_BACKEND", None)
        else:
            os.environ["COLEARN_FOLD_BACKEND"] = prev


def _tree_bytes(tree):
    return [np.asarray(l).tobytes() for l in jax.tree.leaves(tree)]


def _assert_equal(a, b):
    assert a.total_w == b.total_w
    assert a.loss_sum == b.loss_sum
    assert a.count == b.count
    assert _tree_bytes(a.wsum) == _tree_bytes(b.wsum)


def _all_folds(shapes, updates, **kw):
    """Port host, port device (plain kernel), JAX host, JAX native, JAX
    xla."""
    return ([_port(shapes, updates, **kw), _port(shapes, updates,
                                                  device=True, **kw),
             _jax(shapes, updates, **kw)]
            + [_jax(shapes, updates, backend=b, **kw) for b in JAX_BACKENDS])


@pytest.mark.parametrize("scheme", SCHEMES)
def test_folds_are_bitwise_jax_folds(scheme):
    folds = _all_folds(_params(), _updates(scheme))
    for f in folds[1:]:
        _assert_equal(folds[0], f)
    assert folds[0].densify_avoided == (5 if "topk" in scheme else 0)
    m0, w0, l0 = folds[0].mean()
    m1, w1, l1 = folds[2].mean()
    assert (w0, l0) == (w1, l1) and _tree_bytes(m0) == _tree_bytes(m1)


@pytest.mark.parametrize("scheme", ["topk8", "none"])
def test_partial_cohort_is_bitwise_jax(scheme):
    order = [str(i) for i in range(5)]
    updates = _updates(scheme)[:3]          # two cohort slots never reply
    folds = _all_folds(_params(), updates, order=order)
    assert folds[0].count == 3
    for f in folds[1:]:
        _assert_equal(folds[0], f)


@pytest.mark.parametrize("scheme", ["topk", "topk8", "int8"])
def test_slices_regroup_as_jax(scheme):
    updates = _updates(scheme, n=6, seed=600)
    slices = [["0", "1"], ["2", "3", "4"]]            # "5" is a straggler
    folds = _all_folds(_params(), updates, slices=slices)
    for f in folds[1:]:
        _assert_equal(folds[0], f)
    assert folds[0].folded_ids == ["0", "1", "2", "3", "4", "5"]


def test_partials_and_correction_are_bitwise_jax():
    shapes = _params()
    updates = _updates("topk", seed=900)
    direct, sliced = updates[:3], updates[3:]
    sub = _jax(shapes, sliced)
    partials = [("agg:0", sub.total_w, sub.wsum, sub.loss_sum)]
    rng = np.random.default_rng(17)
    correction = trees.map_leaves(
        lambda w: (rng.standard_normal(w.shape) * 1e-3).astype(np.float32),
        shapes)
    folds = _all_folds(shapes, direct, partials=partials,
                       correction=correction)
    for f in folds[1:]:
        _assert_equal(folds[0], f)


@pytest.mark.parametrize("batch_max", [None, 1, 2])
def test_mixed_cohort_batched_and_sequential(batch_max):
    """topk8 / topk (a value-dtype boundary) / dense, interleaved: batched
    runs and one contribution at a time give the same bits."""
    mixed = []
    for i, scheme in enumerate(["topk8", "topk8", "topk", "none", "topk8",
                                "int8"]):
        meta, wire = _updates(scheme, n=1, seed=1100 + i)[0]
        meta["client_id"] = str(i)
        mixed.append((meta, wire))
    shapes = _params()
    host = _jax(shapes, mixed)
    _assert_equal(host, _port(shapes, mixed, device=True,
                              batch_max=batch_max))
    _assert_equal(host, _port(shapes, mixed))


def test_negative_zero_survives():
    shapes = {"w": np.zeros((8,), np.float32)}
    upd = []
    for i, (idx, val) in enumerate([(3, -0.0), (1, 1.5), (6, -2.0)]):
        wire = {"w": {"i": np.array([idx], np.int64),
                      "v": np.array([val], np.float32),
                      "n": np.array([8], np.int64)}}
        upd.append(({"client_id": str(i), "weight": 1.0, "mean_loss": 0.0,
                     "compress": "topk"}, wire))
    for f in _all_folds(shapes, upd):
        out = np.asarray(f.wsum["w"])
        assert out[3] == 0.0 and np.signbit(out[3])


@pytest.mark.parametrize("present", [5, 3])
def test_sparse_fold_is_bitwise_the_dense_fold(present):
    """The sparse-native staging equals decompress-then-sum, arrival order
    shuffled (tests/test_uplink_fastpath.py's parity)."""
    shapes = _params()
    order = [str(i) for i in range(5)]
    updates = _updates("topk", fraction=0.1, seed=100)[:present]
    arrival = list(updates)
    random.Random(13).shuffle(arrival)
    sparse = StreamingFolder(shapes, order=order, device="cpu")
    dense = StreamingFolder(shapes, order=order, device="cpu")
    for meta, wire in arrival:
        sparse.add(dict(meta), _copy(wire))
        d = compression.decompress_delta(wire, meta, shapes=shapes)
        dense.add({k: v for k, v in meta.items() if k != "compress"}, d)
    (m_sp, w_sp, l_sp), (m_dn, w_dn, l_dn) = sparse.mean(), dense.mean()
    assert (w_sp, l_sp) == (w_dn, l_dn)
    assert _tree_bytes(m_sp) == _tree_bytes(m_dn)
    assert sparse.densify_avoided == present and dense.densify_avoided == 0


@pytest.mark.parametrize("scheme", SCHEMES)
def test_update_folder_is_bitwise_jax(scheme):
    shapes = _params()
    ours, theirs = UpdateFolder(shapes), JaxUpdateFolder(shapes)
    for meta, wire in _updates(scheme, n=3):
        assert ours.add(dict(meta), _copy(wire)) == theirs.add(dict(meta),
                                                               _copy(wire))
    (m0, w0, l0), (m1, w1, l1) = ours.mean(), theirs.mean()
    assert (w0, l0) == (w1, l1) and _tree_bytes(m0) == _tree_bytes(m1)
    assert UpdateFolder(shapes).mean()[0] is None


def test_discard_and_finalized_guards():
    f = StreamingFolder(_params(), device="cpu")
    (m0, w0), (m1, w1) = _updates("topk8", n=2)
    f.add(m0, w0)
    f.add(m1, w1)
    assert f.discard("1") and not f.discard("1")
    assert f.count == 1
    with pytest.raises(RuntimeError, match="requires a finalized"):
        f.apply_correction(_params())
    f.finalize()
    for call in (lambda: f.add(m0, w0), lambda: f.discard("0"),
                 lambda: f.add_partial("p", 1.0, None, 0.0)):
        with pytest.raises(RuntimeError, match="already finalized"):
            call()


def test_kernel_cache_keys_on_slot_fingerprint():
    a = fold.get_kernel([16, 8], "cpu")
    assert fold.get_kernel((16, 8), "cpu") is a
    assert fold.get_kernel([16, 9], "cpu") is not a
    shapes = _params()
    f1 = _port(shapes, _updates("topk8"), device=True)
    f2 = _port(shapes, _updates("topk8", n=6, seed=1400), device=True)
    assert f1._kernel is f2._kernel


@pytest.mark.parametrize("device", [False, True])
def test_read_only_partial_is_copied_at_staging(device):
    shapes = _params()
    base = trees.map_leaves(lambda w: np.ones(w.shape, np.float32), shapes)
    for leaf in trees.leaves(base):
        leaf.setflags(write=False)
    snapshot = _tree_bytes(base)
    updates = _updates("topk", n=2, seed=1500)
    f = _port(shapes, updates, device=device,
              partials=[("agg:0", 1.0, base, 0.0)])
    assert _tree_bytes(base) == snapshot
    _assert_equal(f, _jax(shapes, updates,
                          partials=[("agg:0", 1.0, base, 0.0)]))


def test_fold_kernel_plain_version_refuses_bad_input():
    k = fold.FoldKernel([8, 4], "cpu")
    slot = (np.array([1], np.int64), np.ones(1, np.float32), np.float32(1.0))
    with pytest.raises(IndexError, match="slot 1"):
        k.fold_sparse(None, [(np.float32(1.0), [
            slot, (np.array([4], np.int64), np.ones(1, np.float32),
                   np.float32(1.0))])])
    with pytest.raises(ValueError, match="slots"):
        k.fold_sparse(None, [(np.float32(1.0), [slot])])
    with pytest.raises(ValueError, match="one value dtype"):
        k.fold_sparse(None, [(np.float32(1.0), [
            slot, (np.array([0], np.int64), np.ones(1, np.int8),
                   np.float32(1.0))])])
    with pytest.raises(ValueError, match="values for"):
        k.fold_dense(None, [[np.ones(8, np.float32), np.ones(3, np.float32)]])
    assert fold.launches == {"fold_sparse": 0, "fold_dense": 0}


def test_device_fold_without_a_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f = StreamingFolder(_params(), device_fold=True)
    meta, wire = _updates("topk8", n=1)[0]
    f.add(meta, wire)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        f.finalize()


def test_sharded_server_is_refused_naming_its_item():
    """Refused until the sharded server was ported: a placed folder now
    folds every frame type bitwise as the replicated one, and its mean is
    the placed tree of that mean."""
    from colearn_federated_learning_tpu_torch.parallel import partition

    placement = partition.make_server_placement(_params(), 2, "model",
                                                "bert", device="cpu")
    assert placement is not None
    for scheme in SCHEMES:
        updates = _updates(scheme)
        rep = _port(_params(), updates)
        shd = _feed(StreamingFolder(_params(), order=_order(updates),
                                    placement=placement), updates)
        assert (shd.total_w, shd.loss_sum) == (rep.total_w, rep.loss_sum)
        assert _tree_bytes(partition.host_tree(shd.mean()[0])) == \
            _tree_bytes(rep.mean()[0])


# ------------------------------------------------------- the kernel's plan
KERNEL_THREADS, KERNEL_U = 128, 8          # csrc/fold.cu kSparseThreads, kU


def _walk(begin, tiles):
    """The slot ``csrc/fold.cu`` gives each entry: per tile, warp and lane,
    the lane's first entry's slot searched within the tile's range, then a
    walk forward across run boundaries over its entries 32 apart.  Returns
    ``(entry, slot)`` pairs."""
    k = int(begin[-1])
    assert KERNEL_THREADS * KERNEL_U == fold.TILE
    seen = []
    for t in range(-(-k // fold.TILE)):
        for tid in range(KERNEL_THREADS):
            base = t * fold.TILE + (tid // 32) * 32 * KERNEL_U + tid % 32
            if base >= k:
                continue
            lo, hi = int(tiles[t]), int(tiles[t + 1])
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                lo, hi = (mid, hi) if begin[mid] <= base else (lo, mid - 1)
            s = lo
            for e in range(base, min(base + 32 * KERNEL_U, k), 32):
                while e >= begin[s + 1]:
                    s += 1
                seen.append((e, s))
    return seen


def _sparse_batch(rng, sizes, counts, vdt=np.float32, idx_dtype=np.int32):
    """Contributions with ``counts[r][s]`` entries in slot s (unique, sorted
    indices), raw values of ``vdt``, per-slot scales, float32 weights."""
    batch = []
    for row in counts:
        slots = []
        for n, c in zip(sizes, row):
            idx = np.sort(rng.choice(n, c, replace=False)).astype(idx_dtype)
            vals = (rng.integers(-127, 128, c).astype(np.int8)
                    if vdt == np.int8
                    else rng.standard_normal(c).astype(np.float32))
            slots.append((idx, vals, np.float32(rng.uniform(1e-4, 1e-2))))
        batch.append((np.float32(rng.uniform(1.0, 300.0)), slots))
    return batch


PLAN_SIZES = [5000, 0, 3, 2049, 1, 70, 70, 9000, 2048]
PLAN_CASES = {
    # runs of every length, so slot starts fall anywhere in a tile
    "unaligned_runs": [[1234, 0, 3, 2049, 1, 17, 70, 4001, 2048]],
    "empty_slots": [[5000, 0, 0, 1, 0, 0, 70, 0, 1]],
    "empty_contribution": [[0] * 9, [3, 0, 1, 5, 0, 0, 0, 9, 0], [0] * 9],
    "one_entry": [[0, 0, 0, 0, 1, 0, 0, 0, 0]],
    "whole_tiles": [[2048, 0, 0, 2048, 0, 0, 0, 2048, 2048]],
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_tile_plan_covers_every_entry_once(case):
    rng = np.random.default_rng(11)
    batch = _sparse_batch(rng, PLAN_SIZES, PLAN_CASES[case])
    st = fold.FoldKernel(PLAN_SIZES, "cpu").stage_sparse(batch)
    assert len(st.parts) == len(batch)
    for part, (_, slots) in zip(st.parts, batch):
        begin = part.begin_host
        assert begin[0] == 0 and list(np.diff(begin)) == [
            idx.size for idx, _, _ in slots]
        tiles = part.tiles.numpy()
        assert tiles.size == -(-int(begin[-1]) // fold.TILE) + 1
        seen = sorted(_walk(begin, tiles))
        assert [e for e, _ in seen] == list(range(int(begin[-1])))
        for e, s in seen:
            assert begin[s] <= e < begin[s + 1]


@pytest.mark.parametrize("vdt,per_entry", [(np.int8, 5), (np.float32, 8)])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64, np.uint16])
def test_staged_indices_are_int32(vdt, per_entry, idx_dtype):
    """Any integer index dtype stages as int32: 5 bytes per topk8 entry,
    8 per topk entry, each contribution's arrays 16-byte aligned."""
    rng = np.random.default_rng(12)
    batch = _sparse_batch(rng, PLAN_SIZES, PLAN_CASES["unaligned_runs"] * 2,
                          vdt, idx_dtype)
    st = fold.FoldKernel(PLAN_SIZES, "cpu").stage_sparse(batch)
    for part, (w, slots) in zip(st.parts, batch):
        assert part.idx.dtype == torch.int32 and part.weight == w
        assert part.idx.element_size() + part.vals.element_size() == per_entry
        assert part.idx.data_ptr() % 16 == 0 and part.vals.data_ptr() % 16 == 0
        assert np.array_equal(part.idx.numpy(), np.concatenate(
            [idx for idx, _, _ in slots]).astype(np.int32))
        assert np.array_equal(part.vals.numpy(), np.concatenate(
            [vals for _, vals, _ in slots]))
        assert np.array_equal(part.scales.numpy(),
                              [scale for _, _, scale in slots])


@pytest.mark.parametrize("bad", [-1, 4, 2 ** 32 + 1])
def test_out_of_range_index_raises_before_any_write(bad):
    """A bad index in the last contribution: nothing of the batch is
    folded, the accumulator keeps its bits and nothing launches."""
    k = fold.FoldKernel([8, 4], "cpu")
    good = (np.array([1, 5], np.int64), np.ones(2, np.float32),
            np.float32(1.0))
    batch = [(np.float32(1.0), [good, (np.array([0], np.int64),
                                       np.ones(1, np.float32),
                                       np.float32(1.0))]),
             (np.float32(2.0), [good, (np.array([bad], np.int64),
                                       np.ones(1, np.float32),
                                       np.float32(1.0))])]
    acc = torch.arange(12, dtype=torch.float32)
    before = acc.clone()
    fold.reset_launches()
    with pytest.raises(IndexError, match="slot 1 of 4"):
        k.fold_sparse(acc, batch)
    assert torch.equal(acc, before)
    with pytest.raises(TypeError, match="integers"):
        k.fold_sparse(acc, [(np.float32(1.0), [
            good, (np.array([0.0]), np.ones(1, np.float32),
                   np.float32(1.0))])])
    assert fold.launches == {"fold_sparse": 0, "fold_dense": 0}


def test_a_slot_of_2_31_entries_is_refused():
    with pytest.raises(ValueError, match="int32 indices"):
        fold.FoldKernel([8, 2 ** 31], "cpu")
    assert fold.FoldKernel([8, 2 ** 31 - 1], "cpu").total == 2 ** 31 + 7


@pytest.mark.parametrize("vdt", [np.int8, np.float32])
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_edge_batches_fold_as_the_host_scatter(vdt, case):
    """The staged edge cases through the plain version equal a numpy
    scatter of ``(value * scale) * weight``, assigned then added."""
    rng = np.random.default_rng(13)
    batch = _sparse_batch(rng, PLAN_SIZES, PLAN_CASES[case] * 2, vdt)
    kernel = fold.FoldKernel(PLAN_SIZES, "cpu")
    got = kernel.fold_sparse(None, batch).numpy()
    want = np.zeros(kernel.total, np.float32)
    for r, (w, slots) in enumerate(batch):
        for off, (idx, vals, scale) in zip(kernel.offsets, slots):
            v = (vals.astype(np.float32) * scale) * w
            if r == 0:
                want[off + idx] = v
            else:
                want[off + idx] += v
    assert got.tobytes() == want.tobytes()


def test_device_fold_stages_the_frames_int32_indices():
    shapes = _params()
    f = StreamingFolder(shapes, device_fold=True, device="cpu")
    meta, wire = _updates("topk8", n=1)[0]
    f.add(meta, wire)
    (_, stage, _), = f._staged.values()
    assert {idx.dtype for idx, _, _ in stage.slots} == {np.dtype(np.int32)}
