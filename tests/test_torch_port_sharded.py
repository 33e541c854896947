"""The port's sharded server (``parallel/partition.py``'s placement, the
folders' ``placement=``, the downlink's per-shard read, both coordinators
and the LoRA merge) against the JAX package's, on the CPU.

JAX runs on the 8 host devices ``tests/conftest.py`` forces; the port's
placement takes as many CPU positions from the same ``XLA_FLAGS`` entry.
Mirrors ``tests/test_sharded_server.py``:

- the placement: ``slice_tree`` and ``partition_flat_indices`` bitwise
  JAX's at tp = 4 under the BERT rules, ``sharded_fraction``,
  ``estimate_gather_avoided``, ``leaf_gather_avoided`` and
  ``bytes_per_chip`` equal to JAX's, and each fallback label;
- the fold: a placed ``StreamingFolder`` bitwise the port's replicated
  one and JAX's placed one (full and partial cohorts, dense and topk8,
  with ``slices=``, with the secure-aggregation correction), and its
  device fold's slot layout JAX's and its plain B4 fold bitwise the host
  fold;
- the downlink: frames of a placed tree byte-identical to the replicated
  ones (schemes ``none`` and int8 delta), the avoided gather counted;
- end to end: tp = 2 socket federations (synchronous, asynchronous, the
  synchronous tree) bitwise the replicated ones, the state truly sharded;
- LoRA: ``factor_specs`` JAX's; the sharded merge bitwise the replicated
  merge, counting the avoided bytes.
"""

import contextlib
import random

import jax
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.comm.aggregation import (
    StreamingFolder as JaxFolder)
from colearn_federated_learning_tpu.comm.downlink import (
    DownlinkEncoder as JaxEncoder)
from colearn_federated_learning_tpu.fed import lora as jax_lora
from colearn_federated_learning_tpu.parallel import partition as jax_part
from colearn_federated_learning_tpu_torch import telemetry
from colearn_federated_learning_tpu_torch.comm import broker
from colearn_federated_learning_tpu_torch.comm.aggregation import (
    StreamingFolder)
from colearn_federated_learning_tpu_torch.comm.async_coordinator import (
    AsyncFederatedCoordinator)
from colearn_federated_learning_tpu_torch.comm.downlink import (
    DownlinkEncoder)
from colearn_federated_learning_tpu_torch.comm.coordinator import (
    FederatedCoordinator)
from colearn_federated_learning_tpu_torch.fed import compression, lora
from colearn_federated_learning_tpu_torch.ops import fold
from colearn_federated_learning_tpu_torch.parallel import partition
from colearn_federated_learning_tpu_torch.utils import device, trees
from test_torch_port_async import start_worker
from test_torch_port_socket import WAIT, configs, jax_init, leaves
from test_torch_port_tree import tree_configs, tree_run

TP = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _params():
    """``tests/test_sharded_server.py``'s tree."""
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


@pytest.fixture(scope="module")
def placements():
    """(port placement, JAX placement) at tp = 4 under the BERT rules."""
    devs = jax.devices("cpu")
    assert len(devs) >= TP and device.host_device_count() >= TP
    ours = partition.make_server_placement(_params(), TP, "model", "bert",
                                           device="cpu")
    theirs = jax_part.make_server_placement(_params(), TP, "model", "bert",
                                            devices=devs[:TP])
    assert ours is not None and theirs is not None
    return ours, theirs


def _bytes(tree):
    return [np.asarray(l).tobytes() for l in trees.leaves(tree)]


def _jax_bytes(tree):
    return [np.asarray(l).tobytes() for l in jax.tree.leaves(tree)]


def _counter(name):
    return telemetry.get_registry().counter(name).value


# ------------------------------------------------------------ placement --
def test_slice_tree_and_flat_indices_are_jax_s(placements):
    ours, theirs = placements
    params = _params()
    mine = [p for leaf in trees.leaves(ours.slice_tree(params))
            for p in leaf]
    assert _jax_bytes(theirs.slice_tree(params)) == [p.tobytes()
                                                     for p in mine]
    assert [p.shape for p in mine] == [
        p.shape for p in jax.tree.leaves(theirs.slice_tree(params))]
    rng = np.random.default_rng(3)
    for pos, leaf in enumerate(trees.leaves(params)):
        n = leaf.size
        idx = np.sort(rng.choice(n, size=max(1, n // 3), replace=False))
        vals = rng.standard_normal(idx.size).astype(np.float32)
        got = ours.partition_flat_indices(pos, idx, vals)
        want = theirs.partition_flat_indices(pos, idx, vals)
        assert len(got) == len(want)
        for (gi, gv, gs), (wi, wv, ws) in zip(got, want):
            assert gi.dtype == wi.dtype and np.array_equal(gi, wi)
            assert gv.tobytes() == wv.tobytes() and tuple(gs) == tuple(ws)


@pytest.mark.parametrize("model,size", [("bert", 2), ("bert", 4),
                                        ("mlp", 2), ("cnn", 8),
                                        ("other", 4)])
def test_fractions_and_estimates_equal_jax(model, size):
    params = _params()
    devs = jax.devices("cpu")[:size]
    ours = partition.ServerPlacement.from_params(
        params, ["cpu"] * size, "model", partition.rules_for_model(model))
    theirs = jax_part.ServerPlacement.from_params(
        params, jax.sharding.Mesh(np.array(devs), ("model",)), "model",
        jax_part.rules_for_model(model))
    assert ours.sharded_fraction() == theirs.sharded_fraction()
    assert ours.n_devices == theirs.n_devices == size
    assert (partition.estimate_gather_avoided(
        params, partition.rules_for_model(model), "model", size)
        == jax_part.estimate_gather_avoided(
            params, jax_part.rules_for_model(model), "model", size))


def test_gather_avoided_and_bytes_per_chip_equal_jax(placements):
    ours, theirs = placements
    mine, jaxs = ours.shard(_params()), theirs.shard(_params())
    assert [partition.leaf_gather_avoided(l) for l in trees.leaves(mine)] == [
        jax_part.leaf_gather_avoided(l) for l in jax.tree.leaves(jaxs)]
    assert partition.tree_gather_avoided(mine) == jax_part.tree_gather_avoided(
        jaxs) > 0
    assert partition.bytes_per_chip(mine) == jax_part.bytes_per_chip(jaxs)
    assert _bytes(partition.host_tree(mine)) == _jax_bytes(
        jax_part.host_tree(jaxs))
    # The flat state: one tensor per (leaf, shard), views of the placed
    # tree, and back.
    flat = ours.flatten(mine)
    assert list(flat) == ours.keys() and len(flat) == len(
        jax.tree.leaves(theirs.slice_tree(_params())))
    assert _bytes(partition.host_tree(ours.unflatten(flat))) == _bytes(
        _params())


def test_make_server_placement_falls_back_with_each_label():
    reg = telemetry.get_registry()
    assert partition.make_server_placement(_params(), 1, "model", "bert",
                                           device="cpu") is None
    name = "fed.mesh_fallback_total{reason=insufficient_devices}"
    before = reg.snapshot().get(name, 0)
    too_many = device.host_device_count() + 1
    assert partition.make_server_placement(_params(), too_many, "model",
                                           "bert", device="cpu") is None
    assert reg.snapshot()[name] == before + 1
    name = "fed.mesh_fallback_total{reason=rules_matched_nothing}"
    before = reg.snapshot().get(name, 0)
    assert partition.make_server_placement(
        {"w": np.ones((5,), np.float32)}, 2, "model", "mlp",
        devices=["cpu", "cpu"]) is None
    assert reg.snapshot()[name] == before + 1


# ----------------------------------------------------------------- fold --
def _deltas(scheme, n=5):
    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        d = trees.map_leaves(
            lambda w: rng.standard_normal(w.shape).astype(np.float32),
            _params())
        meta = {"client_id": str(i), "weight": 1.0 + 0.25 * i,
                "mean_loss": 0.5 + 0.1 * i}
        if scheme != "none":
            d, cmeta = compression.compress_delta(d, scheme,
                                                  topk_fraction=0.2)
            meta.update(cmeta)
        out.append((meta, d))
    return out


def _copy(tree):
    return jax.tree.map(np.copy, tree)


def _folds(placements, updates, order, slices=None, partials=(),
           correction=None):
    """(port replicated, port placed, port placed through the plain B4
    fold, JAX placed), each finalized, corrected and averaged."""
    ours, theirs = placements
    shapes = ours.shapes_tree()
    folders = [StreamingFolder(shapes, order=order, slices=slices),
               StreamingFolder(shapes, order=order, slices=slices,
                               placement=ours),
               StreamingFolder(shapes, order=order, slices=slices,
                               placement=ours, device_fold=True,
                               device="cpu"),
               JaxFolder(theirs.shapes_tree(), order=order, slices=slices,
                         placement=theirs)]
    arrival = list(updates)
    random.Random(13).shuffle(arrival)         # the fold must not care
    out = []
    for f in folders:
        for meta, d in arrival:
            f.add(dict(meta), _copy(d))
        for key, tw, tree, ls in partials:
            f.add_partial(key, tw, _copy(tree), ls)
        f.finalize()
        if correction is not None:
            f.apply_correction(correction)
        out.append((f, f.mean()))
    return out


def _assert_folds_equal(results):
    (_, (m_rep, w, l)), *rest = results
    want = _bytes(m_rep)
    for f, (m, w2, l2) in rest:
        assert w2 == w and l2 == l
        host = (jax_part.host_tree(m) if isinstance(f, JaxFolder)
                else partition.host_tree(m))
        got = (_jax_bytes(host) if isinstance(f, JaxFolder)
               else _bytes(host))
        assert got == want
    placed = results[1][1][0]
    assert all(isinstance(l, partition.ShardedTensor)
               for l in trees.leaves(placed))


@pytest.mark.parametrize("present", [5, 3])
@pytest.mark.parametrize("scheme", ["none", "topk8"])
def test_sharded_fold_is_bitwise_the_replicated_and_jax_s(placements,
                                                          scheme, present):
    order = [str(i) for i in range(5)]
    _assert_folds_equal(_folds(placements, _deltas(scheme)[:present],
                               order))


@pytest.mark.parametrize("scheme", ["none", "topk8"])
def test_sharded_fold_with_slices_is_bitwise(placements, scheme):
    order = [str(i) for i in range(5)]
    slices = [["0", "1"], ["2", "3", "4"]]
    partial = _deltas("none", 1)[0][1]
    _assert_folds_equal(_folds(
        placements, _deltas(scheme), order + ["p"], slices=slices,
        partials=[("p", 0.75, partial, 0.3)]))


def test_sharded_correction_is_bitwise(placements):
    corr = trees.map_leaves(lambda w: np.full(w.shape, 0.125, np.float32),
                            _params())
    _assert_folds_equal(_folds(placements, _deltas("none", 4),
                               [str(i) for i in range(4)],
                               correction=corr))


def test_device_fold_slot_layout_is_jax_s(placements):
    ours, theirs = placements
    mine = StreamingFolder(ours.shapes_tree(), placement=ours,
                           device_fold=True, device="cpu")
    jaxs = JaxFolder(theirs.shapes_tree(), placement=theirs,
                     device_fold=True)
    assert mine._slot_layout() == [[tuple(s) for s in g]
                                   for g in jaxs._slot_layout()]
    # One slot per distinct shard, through the plain B4 fold.
    fold.reset_launches()
    for meta, d in _deltas("topk8", 3):
        mine.add(dict(meta), _copy(d))
    mine.finalize()
    assert len(mine._kernel.sizes) == sum(len(g) for g in
                                          mine._slot_layout()) > len(
        trees.leaves(_params()))


# ------------------------------------------------------------- downlink --
def test_downlink_frames_are_byte_identical_and_counted(placements):
    ours, _ = placements
    params = _params()
    placed = ours.shard(params)
    avoided = partition.tree_gather_avoided(placed)
    before = _counter("comm.gather_bytes_avoided_total")
    body_rep, _, _ = DownlinkEncoder("none").encode_round(2, params)
    body_shd, _, _ = DownlinkEncoder("none").encode_round(2, placed)
    body_jax, _, _ = JaxEncoder("none").encode_round(2, params)
    assert bytes(body_rep) == bytes(body_shd) == bytes(body_jax)
    assert _counter("comm.gather_bytes_avoided_total") - before == avoided


def test_downlink_int8_delta_frames_are_byte_identical(placements):
    ours, _ = placements
    p0 = _params()
    p1 = trees.map_leaves(lambda w: w + np.float32(0.01), _params())
    rep, shd, jx = (DownlinkEncoder("int8"), DownlinkEncoder("int8"),
                    JaxEncoder("int8"))
    for r, p in ((0, p0), (1, p1)):
        a = bytes(rep.encode_round(r, p)[0])
        assert a == bytes(shd.encode_round(r, ours.shard(p))[0])
        assert a == bytes(jx.encode_round(r, p)[0])


# ------------------------------------------------------------ end to end --
def _sharded(tree) -> bool:
    return any(isinstance(l, partition.ShardedTensor) and len(l.parts) > 1
               for l in trees.leaves(tree))


def _sync_run(tp_size, **fed):
    cfgs = configs(num_clients=4, strategy="fedadam", server_lr=0.05,
                   run_kw=dict(tp_size=tp_size), **fed)
    with contextlib.ExitStack() as stack:
        b = broker.MessageBroker().start()
        stack.callback(b.stop)
        for i in range(4):
            stack.callback(start_worker(cfgs, i, b).stop)
        c = FederatedCoordinator(cfgs[1], b.host, b.port, round_timeout=60.0,
                                 want_evaluator=False, device="cpu")
        stack.callback(c.close)
        c._load_params(jax_init(cfgs[0]))
        c.enroll(min_devices=4, timeout=WAIT)
        hist = c.fit(rounds=2)
        state = c._checkpoint_server_state()
        return (hist, leaves(partition.host_tree(c.params_tree())),
                [leaves(partition.host_tree(t)) for t in (state.opt_m,
                                                          state.opt_v)],
                _sharded(c.params_tree()))


@pytest.mark.parametrize("fed", [{}, dict(compress="topk8",
                                          compress_feedback=True)],
                         ids=["dense", "topk8"])
def test_synchronous_federation_at_tp2_is_bitwise_the_replicated(fed):
    reg = telemetry.get_registry()
    before = _counter("comm.gather_bytes_avoided_total")
    h1, p1, o1, s1 = _sync_run(1, **fed)
    h2, p2, o2, s2 = _sync_run(2, **fed)
    assert not s1 and s2
    assert all(r["completed"] == 4 for r in h1 + h2)
    assert [r["total_weight"] for r in h1] == [r["total_weight"] for r in h2]
    assert [r["train_loss"] for r in h1] == [r["train_loss"] for r in h2]
    assert all(np.array_equal(p1[k], p2[k]) for k in p1)
    for a, b in zip(o1, o2):                  # FedAdam's moments, sharded
        assert all(np.array_equal(a[k], b[k]) for k in a)
    assert _counter("comm.gather_bytes_avoided_total") > before
    assert (reg.gauge("comm.server_bytes_per_chip").value or 0) > 0


def _async_run(tp_size):
    """One trainer at K = 1: every aggregation folds one update, so the
    arrival order cannot differ between the runs."""
    cfgs = configs(num_clients=2, strategy="fedadam", server_lr=0.05,
                   run_kw=dict(tp_size=tp_size))
    with contextlib.ExitStack() as stack:
        b = broker.MessageBroker().start()
        stack.callback(b.stop)
        stack.callback(start_worker(cfgs, 0, b).stop)
        c = AsyncFederatedCoordinator(cfgs[1], b.host, b.port, buffer_size=1,
                                      want_evaluator=False, device="cpu")
        stack.callback(c.close)
        c._load_params(jax_init(cfgs[0]))
        c.enroll(min_devices=1, timeout=WAIT)
        hist = c.fit(aggregations=3)
        return (hist, leaves(partition.host_tree(c.params_tree())),
                leaves(c._host_np), _sharded(c.params_tree()))


def test_asynchronous_federation_at_tp2_is_bitwise_the_replicated():
    h1, p1, n1, s1 = _async_run(1)
    h2, p2, n2, s2 = _async_run(2)
    assert not s1 and s2
    assert [r["model_version"] for r in h2] == [1, 2, 3]
    assert [r["train_loss"] for r in h1] == [r["train_loss"] for r in h2]
    assert all(np.array_equal(p1[k], p2[k]) for k in p1)
    # The pumps' host copy, read per shard, is the same params.
    assert all(np.array_equal(n2[k], p2[k]) for k in p2)


def test_tree_federation_at_tp2_is_bitwise_the_replicated():
    rep, pr = tree_run(tree_configs(compress="topk8"), 3)
    shd, ps = tree_run(tree_configs(compress="topk8",
                                    run_kw=dict(tp_size=2)), 3)
    assert [r["completed"] for r in shd] == [3, 3]
    assert [r["total_weight"] for r in rep] == [r["total_weight"]
                                                for r in shd]
    assert all(np.array_equal(pr[k], ps[k]) for k in pr)


# ----------------------------------------------------------------- LoRA --
@pytest.mark.parametrize("model,size", [("bert", 2), ("bert", 4),
                                        ("mlp", 2), ("cnn", 4)])
def test_factor_specs_are_jax_s(model, size):
    params = _params()
    theirs = jax_lora.factor_specs(params, 4, "model", model_name=model,
                                   sizes={"model": size})
    ours = lora.factor_specs(params, 4, "model", model_name=model,
                             sizes={"model": size})
    flat_t = {jax_part.path_str(p): tuple(s) for p, s in
              jax.tree_util.tree_leaves_with_path(
                  theirs, is_leaf=lambda x: isinstance(
                      x, jax.sharding.PartitionSpec))}
    flat_o = {"/".join(p): s for p, s in lora._leaves_with_path(ours)}
    assert flat_o == flat_t and flat_o


def _lora_coordinator(stack, tp_size):
    cfgs = configs(num_clients=2, lora_rank=4, lora_alpha=16.0,
                   lora_merge_every=1, run_kw=dict(tp_size=tp_size))
    b = broker.MessageBroker().start()
    stack.callback(b.stop)
    c = FederatedCoordinator(cfgs[1], b.host, b.port, want_evaluator=False,
                             device="cpu")
    stack.callback(c.close)
    c._load_params(jax_init(cfgs[0]))
    rng = np.random.default_rng(5)
    for a, bb in lora.factor_index(c._factors).values():
        bb.copy_(torch.from_numpy(
            (0.05 * rng.standard_normal(tuple(bb.shape))).astype(
                np.float32)))
    return c


def test_sharded_lora_merge_is_bitwise_and_counts_the_gather():
    with contextlib.ExitStack() as stack:
        rep = _lora_coordinator(stack, 1)
        shd = _lora_coordinator(stack, 2)
        assert shd._placement is not None and shd._fold_placement is None
        avoided = partition.tree_gather_avoided(shd.params_tree())
        assert avoided > 0
        rep._merge_lora()
        before = _counter("comm.gather_bytes_avoided_total")
        shd._merge_lora()
        assert _counter("comm.gather_bytes_avoided_total") - before \
            == avoided
        assert _sharded(shd.params_tree())
        assert _bytes(partition.host_tree(rep.params_tree())) == _bytes(
            partition.host_tree(shd.params_tree()))
        assert _bytes(partition.host_tree(rep._eval_params())) == _bytes(
            partition.host_tree(shd._eval_params()))
