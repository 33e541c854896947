"""The aggregator tree's buffered half (``comm/aggregator.py``'s ``aprep``,
``abuf``, ``adrain`` and auto-K, and the asynchronous coordinator's tree
mode) against the JAX package's, on the CPU at small sizes.

- A port ``AggregatorServer`` answers the three ops with JAX's meta keys
  and values and a partial bitwise JAX's aggregator's (dense, topk and
  topk8 uplinks, a repeated key deduplicated; on the host and through the
  fold kernel's plain version); before ``aprep`` both give JAX's error.
- The slice's auto-K over a scripted arrival stream is JAX's.
- Ports of ``tests/test_tree_async.py``: the per-aggregator partial folds
  combine bitwise as the flat slice-blocked fold (2 and 3 aggregators,
  three schemes), a re-homed key folds once, and the tree's record keys
  are in the metric catalog.
- Mixed tiers: a port root over JAX aggregators and workers, and a JAX
  root over port aggregators and workers, run with JAX's record keys and
  fold every dispatched contribution at most once.
- An aggregator that dies as a contribution reaches it: the contribution
  fails over to its sibling and nothing folds twice.

Every wait has its own timeout in code (no pytest-timeout here).
"""

import contextlib
import copy
import time
import types

import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.comm import aggregation as jax_aggregation
from colearn_federated_learning_tpu.comm import aggregator as jax_agg
from colearn_federated_learning_tpu.comm import async_coordinator as jax_async
from colearn_federated_learning_tpu.comm import broker as jax_broker
from colearn_federated_learning_tpu.telemetry import arrival as jax_arrival
from colearn_federated_learning_tpu_torch.analysis import metric_catalog
from colearn_federated_learning_tpu_torch.comm import aggregator, broker
from colearn_federated_learning_tpu_torch.comm.aggregation import (
    StreamingFolder)
from colearn_federated_learning_tpu_torch.comm.async_coordinator import (
    AsyncFederatedCoordinator)
from colearn_federated_learning_tpu_torch.comm.transport import TensorClient
from colearn_federated_learning_tpu_torch.fed import compression
from colearn_federated_learning_tpu_torch.telemetry import arrival
from colearn_federated_learning_tpu_torch.utils import trees
from test_torch_port_async import start_worker
from test_torch_port_socket import WAIT, configs, jax_init

TREE_KEYS = ("agg_id", "agg_buffer_k", "agg_buffer_staged",
             "agg_buffer_rate_per_s", "oldest_version", "folded_keys",
             "rehomed_devices", "rehomed_total", "agg_fold_tracking_min",
             "aggregators")
# The drain's meta values that follow each side's own clock.
CLOCKED = ("buffer_k", "arrival_rate_per_s", "fold_s")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _shapes():
    return {"Dense_0": {"kernel": np.zeros((20, 8), np.float32),
                        "bias": np.zeros(8, np.float32)},
            "Dense_1": {"kernel": np.zeros((8, 4), np.float32),
                        "bias": np.zeros(4, np.float32)}}


def _contributions(scheme, n=5, seed=11):
    """``n`` (key, device, version, meta, wire) for one slice, of mixed
    versions, then the first one again (a re-homed copy)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        delta = trees.map_leaves(
            lambda a: (0.01 * rng.standard_normal(a.shape)).astype(
                np.float32), _shapes())
        meta = {"client_id": str(i), "round": i % 2,
                "weight": float(rng.integers(5, 60)) * (1.0 + i) ** -0.5,
                "mean_loss": float(rng.random())}
        if scheme == "dense":
            wire = delta
        else:
            wire, fields = compression.compress_delta(delta, scheme,
                                                      topk_fraction=0.25)
            meta.update(fields)
        v = 3 + i % 2
        out.append((f"{v:08d}@{i}", str(i), v, meta, wire))
    return out + [out[0]]


def _bytes(tree):
    return [np.asarray(leaf).tobytes() for leaf in trees.leaves(tree)]


def _serve(side, device_fold=False):
    jcfg, tcfg = configs(run_kw=dict(fold_device=device_fold))
    if side == "port":
        return aggregator.AggregatorServer(tcfg, 0, device="cpu").start()
    return jax_agg.AggregatorServer(jcfg, 0).start()


def _conversation(side, scheme, device_fold):
    """The buffered ops against one aggregator of ``side``: two early
    calls, ``aprep``, every ``abuf``, a drain and an idle drain."""
    agg = _serve(side, device_fold)
    cli = TensorClient(agg.host, agg.port, timeout=WAIT)
    items = _contributions(scheme)
    try:
        early = [cli.request({"op": "abuf", "key": "k", "device": "0",
                              "meta": {}}, {"w": np.zeros(2, np.float32)},
                             timeout=WAIT)[0],
                 cli.request({"op": "adrain", "timeout": 0.1},
                             timeout=WAIT)[0]]
        prep = cli.request({"op": "aprep", "meta": {}}, _shapes(),
                           timeout=WAIT)[0]
        staged = []
        for key, dev, v, meta, wire in items:
            hdr, _ = cli.request(
                {"op": "abuf", "key": key, "device": dev, "version": v,
                 "rehomed": key == items[-1][0] and len(staged) > 0,
                 "meta": dict(meta)}, copy.deepcopy(wire), timeout=WAIT)
            staged.append(hdr)
        drain, partial = cli.request(
            {"op": "adrain", "interval_s": 0.5, "timeout": 0.2,
             "slice_devices": len(items)}, timeout=WAIT)
        idle, _ = cli.request({"op": "adrain", "interval_s": 0.5,
                               "timeout": 0.1, "slice_devices": 2},
                              timeout=WAIT)
    finally:
        cli.close()
        agg.stop()
    return early, prep, staged, drain, partial, idle


@pytest.mark.parametrize("device_fold", [False, True],
                         ids=["host", "plain_fold"])
@pytest.mark.parametrize("scheme", ["dense", "topk", "topk8"])
def test_buffered_ops_answer_as_jax(scheme, device_fold):
    ours = _conversation("port", scheme, device_fold)
    theirs = _conversation("jax", scheme, False)
    (e_o, p_o, s_o, d_o, part_o, i_o) = ours
    (e_t, p_t, s_t, d_t, part_t, i_t) = theirs
    assert [h["status"] for h in e_o] == ["error", "error"]
    assert [h["error"] for h in e_o] == [h["error"] for h in e_t]
    assert "aprep first" in e_o[0]["error"]
    assert p_o["meta"] == p_t["meta"]
    assert [h["meta"] for h in s_o] == [h["meta"] for h in s_t]
    assert s_o[-1]["meta"]["dedup"] is True
    mo, mt = d_o["meta"], d_t["meta"]
    assert sorted(mo) == sorted(mt)
    for key in mt:
        if key not in CLOCKED:
            assert mo[key] == mt[key], key
    assert mo["count"] == 5 and mo["dedup"] == 1
    assert mo["rehomed"] == ["0"] and mo["oldest_version"] == 3
    assert mo["keys"] == sorted(mo["keys"])
    assert _bytes(part_o) == _bytes(part_t)
    assert sorted(i_o["meta"]) == sorted(i_t["meta"])
    assert i_o["meta"]["count"] == i_t["meta"]["count"] == 0


def _auto_k_sequence(side, steps):
    est = (arrival if side == "port" else jax_arrival).ArrivalEstimator()
    ns = types.SimpleNamespace(arrival=est, _abuf_k=None)
    fn = (aggregator.AggregatorServer._auto_k if side == "port"
          else jax_agg.AggregatorServer._auto_k)
    out = []
    for times, interval, slice_n in steps:
        for t, dev in times:
            est.observe(dev, now=t)
        out.append(fn(ns, interval, slice_n))
    return out


def test_auto_k_equals_jax():
    rng = np.random.default_rng(9)
    steps, t = [], 50.0
    for i in range(30):
        gap = 0.02 if (i // 5) % 2 == 0 else 0.8
        times = []
        for _ in range(int(rng.integers(1, 6))):
            t += float(rng.exponential(gap))
            times.append((t, str(int(rng.integers(0, 6)))))
        steps.append((times, float(rng.choice([0.5, 2.0])),
                      int(rng.choice([0, 2, 6]))))
    ours = _auto_k_sequence("port", steps)
    assert ours == _auto_k_sequence("jax", steps)
    assert len(set(ours)) > 2


# ------------------------------------------ tests/test_tree_async.py ----
def _async_updates(scheme, n=6):
    out = []
    for i in range(n):
        rng = np.random.default_rng(300 + i)
        d = trees.map_leaves(
            lambda w: rng.standard_normal(w.shape).astype(np.float32),
            _shapes())
        meta = {"client_id": str(i), "weight": 1.0 + 0.125 * i,
                "mean_loss": 0.4 + 0.05 * i}
        if scheme == "dense":
            wire = d
        else:
            wire, cmeta = compression.compress_delta(d, scheme,
                                                     topk_fraction=0.1)
            meta.update(cmeta)
        out.append((meta, wire))
    return out


def _flat(cls, order, layout, updates):
    flat = cls(_shapes(), order=order, slices=layout)
    for meta, wire in updates:
        flat.add(dict(meta), copy.deepcopy(wire))
    flat.finalize()
    return flat


@pytest.mark.parametrize("n_agg", [2, 3])
@pytest.mark.parametrize("scheme", ["dense", "topk", "topk8"])
def test_partial_fold_at_aggregator_bitwise_vs_flat(scheme, n_agg):
    updates = _async_updates(scheme)
    order = [m["client_id"] for m, _ in updates]
    layout = aggregator.slice_cohort(order, n_agg)
    staged = {m["client_id"]: (m, w) for m, w in updates}
    root = StreamingFolder(_shapes(),
                           order=[f"agg:{i}" for i in range(n_agg)])
    for i, sl in enumerate(layout):
        leaf = StreamingFolder(_shapes(), order=list(sl))
        for cid in sl:
            meta, wire = staged[cid]
            leaf.add(dict(meta), copy.deepcopy(wire))
        leaf.finalize()
        root.add_partial(f"agg:{i}", leaf.total_w, leaf.wsum,
                         leaf.loss_sum, count=leaf.count)
    root.finalize()
    for flat in (_flat(StreamingFolder, order, layout, updates),
                 _flat(jax_aggregation.StreamingFolder, order, layout,
                       updates)):
        assert root.total_w == flat.total_w
        assert root.loss_sum == flat.loss_sum
        assert _bytes(root.wsum) == _bytes(flat.wsum)
    # tau = 0 at the root: the f32 scale by (1 + 0)^-0.5 == 1.0 is exact.
    scaled = trees.map_leaves(lambda x: np.asarray(x) * (1.0 + 0) ** -0.5,
                              root.wsum)
    assert _bytes(scaled) == _bytes(root.wsum)


def test_rehome_dedup_folds_once():
    meta, wire = _async_updates("dense", n=3)[0]
    key = f"{7:08d}@{meta['client_id']}"
    once = StreamingFolder(_shapes())
    once.add({**meta, "client_id": key}, copy.deepcopy(wire))
    twice = StreamingFolder(_shapes())
    twice.add({**meta, "client_id": key}, copy.deepcopy(wire))
    assert twice.discard(key) is True
    assert twice.discard(key) is False
    twice.add({**meta, "client_id": key}, copy.deepcopy(wire))
    once.finalize()
    twice.finalize()
    assert twice.count == once.count == 1
    assert twice.total_w == once.total_w
    assert _bytes(twice.wsum) == _bytes(once.wsum)
    with pytest.raises(RuntimeError):
        twice.discard(key)


def test_tree_gated_record_keys_registered():
    assert set(TREE_KEYS) <= set(metric_catalog.RECORD_KEYS)


# --------------------------------------------------- tree federations ----
def tree_configs(n_agg=2, **fed):
    return configs(num_clients=4, momentum=0.0, run_kw=dict(
        num_aggregators=n_agg, agg_buffer_interval_s=0.5,
        agg_heartbeat_timeout=1.0), **fed)


@contextlib.contextmanager
def tree(cfgs, n=4, coord="port", aggs="port", workers="port", **kw):
    """A broker, ``n`` workers, 2 aggregators and an async coordinator in
    tree mode, each tier of either package, enrolled; yields (coordinator,
    aggregators)."""
    jcfg, tcfg = cfgs
    with contextlib.ExitStack() as stack:
        b = (broker.MessageBroker() if coord == "port"
             else jax_broker.MessageBroker()).start()
        stack.callback(b.stop)
        for i in range(n):
            stack.callback(start_worker(cfgs, i, b, workers).stop)
        tier = []
        for a in range(jcfg.run.num_aggregators):
            agg = (aggregator.AggregatorServer(tcfg, a, b.host, b.port)
                   if aggs == "port"
                   else jax_agg.AggregatorServer(jcfg, a, b.host, b.port))
            stack.callback(agg.start().stop)
            tier.append(agg)
        if coord == "port":
            c = AsyncFederatedCoordinator(tcfg, b.host, b.port,
                                          want_evaluator=False,
                                          device="cpu", **kw)
            c._load_params(jax_init(jcfg))
        else:
            c = jax_async.AsyncFederatedCoordinator(
                jcfg, b.host, b.port, want_evaluator=False, **kw)
        stack.callback(c.close)
        c.enroll(min_devices=n, timeout=WAIT)
        assert c.enroll_aggregators(timeout=WAIT) == list(
            range(jcfg.run.num_aggregators))
        yield c, tier


def _check_once(records):
    """Each drained key at most once; every record's keys are its
    contributors' dispatches."""
    keys = [k for r in records for k in r["folded_keys"]]
    assert len(keys) == len(set(keys)), keys
    for r in records:
        assert [k.split("@")[1] for k in r["folded_keys"]] == \
            r["contributors"]
        assert np.isfinite(r["train_loss"])
    assert [r["model_version"] for r in records] == list(
        range(1, len(records) + 1))


@pytest.mark.parametrize("coord_side,other", [("port", "jax"),
                                              ("jax", "port")])
def test_mixed_tiers_run_with_jax_records(coord_side, other):
    """A root of one package over the other's aggregators and workers:
    JAX's tree record keys, one partial per aggregation, every key folded
    once."""
    with tree(tree_configs(), coord=coord_side, aggs=other,
              workers=other, buffer_size=2) as (c, _):
        records = [dict(c.run_aggregation()) for _ in range(4)]
    with tree(tree_configs(), coord="jax", aggs="jax", workers="jax",
              buffer_size=2) as (c, _):
        jax_keys = sorted(c.run_aggregation())
    for r in records:
        assert sorted(r) == jax_keys
    _check_once(records)


def test_aggregator_dying_mid_staging_fails_over_once():
    """Aggregator 0 dies as the next contribution reaches it: that
    contribution lands at aggregator 1 (a failover in the records), and
    every dispatched contribution is drained at most once and otherwise
    still in flight."""
    with tree(tree_configs(), buffer_size=2) as (c, tier):
        records = [c.run_aggregation() for _ in range(2)]
        handle = tier[0]._handle

        def handler(header, tree_):
            if header.get("op") == "abuf":
                tier[0]._server._handler = handle
                tier[0].stop()
                raise ConnectionError("aggregator 0 stopped")
            return handle(header, tree_)

        tier[0]._server._handler = handler
        deadline = time.monotonic() + WAIT
        while not c._failovers_pending and time.monotonic() < deadline:
            time.sleep(0.01)
        records += [c.run_aggregation() for _ in range(3)]
        c.close()
        dispatched = sorted(
            f"{sp.attrs['version']:08d}@{sp.attrs['device']}"
            for sp in c.tracer.snapshot() if sp.name == "dispatch_train")
        queued = []
        while not c._partials.empty():
            queued.extend(c._partials.get_nowait()[0]["keys"])
        inflight = set(c._inflight)
    assert any(r["agg_failovers"] for r in records[2:])
    _check_once(records)
    drained = [k for r in records for k in r["folded_keys"]] + queued
    assert not set(drained) & inflight
    assert sorted(set(drained) | inflight) == dispatched
    assert not c.failures
