"""The port's aggregator tree (``comm/aggregator.py`` and the coordinator's
tree branch) against the JAX package's, on the CPU at small sizes (the
tiny MLP of ``tests/test_aggregator_tree.py``, 3-4 workers, 2
aggregators).

- ``slice_cohort`` and ``combine_partial_weights`` equal JAX's.
- The partial combine (one folder per slice, the root's
  ``add_partial``) is bitwise the slice-blocked flat fold and JAX's
  ``StreamingFolder(slices=)``, for dense, topk and topk8 uplinks, full
  and partial cohorts, on the host and through the fold kernel's plain
  version.
- A port tree federation is bitwise the port's flat federation (dense and
  topk); fed JAX's draws it gives JAX's tree federation (f32 rtol 1e-4 /
  atol 2e-5) with JAX's record keys.
- Mixed tiers: a port coordinator over JAX aggregators over JAX workers,
  and a JAX coordinator over port aggregators over port workers, each
  bitwise the one-package tree on the same updates (FedAvg); the fold
  request and its reply carry JAX's header and meta keys.
- Failover with JAX's records: a killed aggregator's slice re-homes;
  with every aggregator dead the slices drop and their devices are
  ``dropped``; a slice whose fold is lost within the round's budget drops
  and the mean renormalises over the other.
- Slice-local secure aggregation: shared seed and DH within JAX's 5e-4 of
  the flat secure mean, and a dropout in one slice recovered to the
  survivors' plain aggregate at ``test_torch_port_wire_secure``'s bound.
- The tree's config checks and refusals, and ``broker``, 2 ×
  ``aggregator``, 3 × ``worker`` and ``coordinate --num-aggregators 2`` as
  processes (``--backend cpu``).

Every wait has its own timeout in code (no pytest-timeout here).
"""

import contextlib
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu import faults as jax_faults
from colearn_federated_learning_tpu.comm import aggregation as jax_aggregation
from colearn_federated_learning_tpu.comm import aggregator as jax_agg
from colearn_federated_learning_tpu.comm import broker as jax_broker
from colearn_federated_learning_tpu.comm import coordinator as jax_coord
from colearn_federated_learning_tpu.comm import worker as jax_worker
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu_torch import faults
from colearn_federated_learning_tpu_torch.comm import aggregator, broker
from colearn_federated_learning_tpu_torch.comm.aggregation import (
    StreamingFolder)
from colearn_federated_learning_tpu_torch.comm.coordinator import (
    FederatedCoordinator)
from colearn_federated_learning_tpu_torch.comm.transport import TensorClient
from colearn_federated_learning_tpu_torch.comm.worker import DeviceWorker
from colearn_federated_learning_tpu_torch.fed import compression
from colearn_federated_learning_tpu_torch.utils import config, trees
from test_torch_port_round import JaxDraws
from test_torch_port_socket import (
    ATOL, ROOT, RTOL, TIMING, WAIT, assert_records_match, configs, jax_init,
    params_of)

# JAX's bound for the tree's secure mean against the flat one
# (tests/test_aggregator_tree.py): masks cancel to f32 noise, not bitwise,
# across regrouped sums.
SECURE_TREE_ATOL = 5e-4
# tests/test_torch_port_wire_secure.py's bound on a recovered aggregate.
CANCEL_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def plans():
    """Install a FaultPlan on the port's or JAX's transport; uninstalled
    after the test."""
    def install(doc, side):
        text = json.dumps(doc)
        if side == "port":
            faults.install(faults.FaultPlan.from_json(text))
        else:
            jax_faults.install(jax_faults.FaultPlan.from_json(text))

    yield install
    faults.uninstall()
    jax_faults.uninstall()


# ------------------------------------------------------------- slicing ----
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_slice_cohort_and_weights_equal_jax(n):
    rng = np.random.default_rng(n)
    for size in range(10):
        cohort = [str(i) for i in range(size)]
        assert aggregator.slice_cohort(cohort, n) == jax_agg.slice_cohort(
            cohort, n)
        ws = list(rng.random(size) * 10.0 ** rng.integers(-8, 3, size))
        assert (aggregator.combine_partial_weights(ws)
                == jax_agg.combine_partial_weights(ws))
    assert aggregator.slice_cohort(["a"], 0) == [["a"]]


@pytest.mark.parametrize("cohort,n,update,partial", [
    (10, 4, 100, 700), (10, 1, 100, 700), (7, 3, 64, 64), (0, 2, 5, 9),
    (3, 0, 8, 16)])
def test_expected_ingest_bill_equals_jax(cohort, n, update, partial):
    """The cases of JAX's ``tests/test_aggregator_tree.py::
    test_expected_ingest_bill`` and around them: the bill is JAX's."""
    ours = aggregator.expected_ingest(cohort=cohort, n_aggregators=n,
                                      update_bytes=update,
                                      partial_bytes=partial)
    assert ours == jax_agg.expected_ingest(
        cohort=cohort, n_aggregators=n, update_bytes=update,
        partial_bytes=partial)
    if (cohort, n) == (10, 4):
        assert ours == {"agg_ingest_bytes": 3 * 100,
                        "root_ingest_bytes": 4 * 700,
                        "flat_root_ingest_bytes": 10 * 100}


# ------------------------------------------------ partial-combine parity --
def _shapes():
    return {"Dense_0": {"kernel": np.zeros((20, 8), np.float32),
                        "bias": np.zeros(8, np.float32)},
            "Dense_1": {"kernel": np.zeros((8, 4), np.float32),
                        "bias": np.zeros(4, np.float32)}}


def _updates(scheme, n, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        delta = trees.map_leaves(
            lambda a: (0.01 * rng.standard_normal(a.shape)).astype(
                np.float32), _shapes())
        meta = {"client_id": str(i), "round": 0,
                "weight": float(rng.integers(5, 60)),
                "mean_loss": float(rng.random())}
        if scheme == "dense":
            wire = delta
        else:
            wire, fields = compression.compress_delta(delta, scheme,
                                                      topk_fraction=0.25)
            meta.update(fields)
        out.append((meta, wire))
    return out


def _port_tree_fold(layout, updates, device_fold=False):
    """What the tree runs: one folder per slice (an aggregator), then the
    root's folder over the partials in slice order."""
    staged = {m["client_id"]: (m, w) for m, w in updates}
    kw = dict(device_fold=device_fold, device="cpu") if device_fold else {}
    root = StreamingFolder(_shapes(), order=[f"slice:{i}"
                                             for i in range(len(layout))],
                           **kw)
    for i, sl in enumerate(layout):
        leaf = StreamingFolder(_shapes(), order=list(sl), **kw)
        for cid in sl:
            if cid in staged:
                meta, wire = staged[cid]
                leaf.add(dict(meta), copy.deepcopy(wire))
        leaf.finalize()
        root.add_partial(f"slice:{i}", leaf.total_w, leaf.wsum,
                         leaf.loss_sum, count=leaf.count)
    root.finalize()
    return root


def _flat_fold(cls, order, layout, updates):
    folder = cls(_shapes(), order=order, slices=layout)
    for meta, wire in reversed(updates):      # arrival order is immaterial
        folder.add(dict(meta), copy.deepcopy(wire))
    folder.finalize()
    return folder


def _bytes(tree):
    return [np.asarray(leaf).tobytes() for leaf in trees.leaves(tree)]


@pytest.mark.parametrize("present", [5, 3])
@pytest.mark.parametrize("scheme", ["dense", "topk", "topk8"])
def test_partial_combine_is_bitwise_the_slice_blocked_flat_fold(scheme,
                                                                present):
    updates = _updates(scheme, 5)[:present]
    order = [str(i) for i in range(5)]
    layout = aggregator.slice_cohort(order, 2)
    flat = _flat_fold(StreamingFolder, order, layout, updates)
    jflat = _flat_fold(jax_aggregation.StreamingFolder, order, layout,
                       updates)
    for tree in (_port_tree_fold(layout, updates),
                 _port_tree_fold(layout, updates, device_fold=True)):
        for other in (flat, jflat):
            assert tree.total_w == other.total_w
            assert tree.loss_sum == other.loss_sum
            assert _bytes(tree.wsum) == _bytes(other.wsum)
        assert tree.count == present


# ------------------------------------------------------ tree federation --
def _hooked(agg, seen):
    """Record every fold request's header keys and its reply's meta keys
    at ``agg`` (either package's ``AggregatorServer``)."""
    def handler(header, tree):
        out_header, out_tree = agg._handle(header, tree)
        if header.get("op") == "fold":
            seen.append((sorted(header), sorted(out_header.get("meta", {}))))
        return out_header, out_tree

    agg._server._handler = handler
    return agg


def tree_run(cfgs, n, rounds=2, coord="port", aggs="port", workers="port",
             n_agg=2, on_round=None, worker_kw=None, seen=None):
    """One federation of ``n`` workers behind ``n_agg`` aggregators (0: the
    flat plane), each tier of either package, as threads.  Port workers
    replay JAX's batch draws unless ``worker_kw`` says otherwise; a port
    coordinator starts from JAX's init.  ``on_round(r, aggs, coord)``
    runs after each round.  Returns (records, final params)."""
    jcfg, tcfg = cfgs
    with contextlib.ExitStack() as stack:
        b = (broker.MessageBroker() if coord == "port"
             else jax_broker.MessageBroker()).start()
        stack.callback(b.stop)
        for i in range(n):
            if workers == "port":
                kw = {"draws": JaxDraws(tcfg.run.seed), **(worker_kw or {})}
                w = DeviceWorker(tcfg, i, b.host, b.port, device="cpu", **kw)
            else:
                w = jax_worker.DeviceWorker(jcfg, i, b.host, b.port)
            stack.callback(w.start().stop)
        tier = []
        for a in range(n_agg):
            agg = (aggregator.AggregatorServer(tcfg, a, b.host, b.port)
                   if aggs == "port"
                   else jax_agg.AggregatorServer(jcfg, a, b.host, b.port))
            if seen is not None:
                _hooked(agg, seen)
            stack.callback(agg.start().stop)
            tier.append(agg)
        if coord == "port":
            c = FederatedCoordinator(tcfg, b.host, b.port, round_timeout=30.0,
                                     want_evaluator=False, device="cpu")
            c._load_params(jax_init(jcfg))
        else:
            c = jax_coord.FederatedCoordinator(jcfg, b.host, b.port,
                                               round_timeout=30.0,
                                               want_evaluator=False)
        stack.callback(c.close)
        c.enroll(min_devices=n, timeout=WAIT)
        if n_agg:
            assert c.enroll_aggregators(timeout=WAIT) == list(
                range(n_agg))
        hist = []
        for r in range(rounds):
            hist.append(dict(c.run_round()))
            if on_round is not None:
                on_round(r, tier, c)
        return hist, params_of(c)


def tree_configs(num_clients=3, n_agg=2, run_kw=None, **fed_kw):
    return configs(num_clients=num_clients, momentum=0.0,
                   run_kw=dict(num_aggregators=n_agg, **(run_kw or {})),
                   **fed_kw)


def assert_tree_records_match(ours, theirs):
    """JAX's keys, the tree's among them; counts, drops and weights
    equal, losses close; the tier's wall time is not compared."""
    timing = set(TIMING) | {"phase_agg_fold_s"}
    for a, b in zip(ours, theirs):
        assert sorted(set(a) - {"retries"}) == sorted(set(b) - {"retries"})
    assert_records_match([{k: v for k, v in r.items() if k not in timing}
                          for r in ours],
                         [{k: v for k, v in r.items() if k not in timing}
                          for r in theirs])


def assert_params_close(ours, theirs, atol=ATOL):
    assert list(ours) == list(theirs)
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=RTOL, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("fed_kw", [{}, dict(compress="topk")],
                         ids=["dense", "topk"])
def test_tree_federation_is_bitwise_the_flat_federation(fed_kw):
    flat, pf = tree_run(tree_configs(n_agg=0, **fed_kw), 3, n_agg=0)
    tree, pt = tree_run(tree_configs(**fed_kw), 3)
    for rf, rt in zip(flat, tree):
        assert rt["completed"] == rf["completed"] == 3
        assert not rt["dropped"] and rt["aggregators"] == 2
        assert rt["phase_agg_fold_s"] > 0
        assert "aggregators" not in rf and "phase_agg_fold_s" not in rf
        assert rt["total_weight"] == rf["total_weight"]
    assert all(np.array_equal(pt[k], pf[k]) for k in pf)


def test_tree_federation_matches_jax():
    cfgs = tree_configs(compress="topk8", compress_feedback=True,
                        topk_fraction=0.2)
    ours, op = tree_run(cfgs, 3)
    theirs, tp = tree_run(cfgs, 3, coord="jax", aggs="jax", workers="jax")
    assert [r["completed"] for r in ours] == [3, 3]
    assert_tree_records_match(ours, theirs)
    assert_params_close(op, tp)


@pytest.mark.parametrize("coord_side,other", [("port", "jax"),
                                              ("jax", "port")])
def test_mixed_tiers_fold_as_the_one_package_tree(coord_side, other):
    """A coordinator of one package over the other's aggregators and
    workers, against the tree of the aggregators' own package: the same
    updates and partials, folded bit for bit."""
    cfgs = tree_configs()
    seen_mixed, seen_same = [], []
    mixed, mp = tree_run(cfgs, 3, coord=coord_side, aggs=other,
                         workers=other, seen=seen_mixed)
    same, sp = tree_run(cfgs, 3, coord=other, aggs=other, workers=other,
                        seen=seen_same)
    assert [r["completed"] for r in mixed] == [3, 3]
    assert all(np.array_equal(mp[k], sp[k]) for k in sp)
    for a, b in zip(mixed, same):
        for key in ("completed", "dropped", "total_weight", "aggregators"):
            assert a[key] == b[key], key
        assert a["train_loss"] == b["train_loss"]
    # Both roots send the same fold request, the trace context included.
    assert len(seen_mixed) == len(seen_same) == 4
    assert {tuple(sorted(h)) for h, _ in seen_mixed} == {
        tuple(sorted(h)) for h, _ in seen_same}
    assert all("trace" in h for h, _ in seen_mixed + seen_same)


def test_port_aggregator_replies_with_jax_meta_keys():
    """Under a JAX root (which traces the round), the port's aggregator
    replies with JAX's aggregator's meta keys, ``trace_spans`` included."""
    seen = {"port": [], "jax": []}
    for side in seen:
        tree_run(tree_configs(), 3, rounds=1, coord="jax", aggs=side,
                 workers=side, seen=seen[side])
    assert {tuple(m) for _, m in seen["port"]} == {
        tuple(m) for _, m in seen["jax"]}
    assert all("trace_spans" in m for _, m in seen["port"])


# --------------------------------------------------------------- failover --
def _stop_after_first(which):
    def on_round(r, tier, coord):
        if r == 0:
            for a in which:
                tier[a].stop()
    return on_round


def _rounds_both(cfgs, n, rounds, on_round):
    ours, op = tree_run(cfgs, n, rounds=rounds, on_round=on_round)
    theirs, tp = tree_run(cfgs, n, rounds=rounds, on_round=on_round,
                          coord="jax", aggs="jax", workers="jax")
    return ours, op, theirs, tp


def test_killed_aggregator_rehomes_its_slice_as_jax():
    cfgs = tree_configs(run_kw=dict(agg_heartbeat_timeout=2.0))
    ours, op, theirs, tp = _rounds_both(cfgs, 3, 3, _stop_after_first([0]))
    assert all(r["completed"] == 3 and not r["dropped"] for r in ours)
    assert "agg_failovers" not in ours[0]
    assert all(r["agg_failovers"] >= 1 for r in ours[1:])
    assert_tree_records_match(ours, theirs)
    assert_params_close(op, tp)


def test_every_aggregator_dead_drops_every_slice_as_jax():
    cfgs = tree_configs(run_kw=dict(agg_heartbeat_timeout=2.0))
    ours, op, theirs, tp = _rounds_both(cfgs, 3, 2,
                                        _stop_after_first([0, 1]))
    last = ours[1]
    assert last["completed"] == 0 and sorted(last["dropped"]) == [
        "0", "1", "2"]
    assert last["agg_failovers"] == 2 and last["total_weight"] == 0.0
    assert_tree_records_match(ours, theirs)
    assert_params_close(op, tp)


LOSE_FOLD_0 = {"seed": 3, "faults": [
    {"kind": "drop_request", "device_id": "agg:0", "round": 1,
     "op": "fold"}]}


def test_slice_lost_within_the_budget_drops_and_renormalises(plans):
    """Aggregator 0 loses round 1's fold request: slice 0 waits out the
    round's budget, so no sibling can take it; it drops, and the mean is
    slice 1's alone.  The port's records and params equal JAX's."""
    out = {}
    for side in ("port", "jax"):
        def lose(r, tier, coord, side=side):
            if r == 0:
                coord.round_timeout = 4.0
                plans(LOSE_FOLD_0, side)

        kw = ({} if side == "port"
              else dict(coord="jax", aggs="jax", workers="jax"))
        out[side] = tree_run(tree_configs(), 3, on_round=lose, **kw)
        faults.uninstall()
        jax_faults.uninstall()
    (ours, op), (theirs, tp) = out["port"], out["jax"]
    assert ours[1]["dropped"] == ["0", "1"]
    assert ours[1]["completed"] == 1 and ours[1]["agg_failovers"] == 1
    # Renormalised over the surviving slice: a weight, and no more.
    assert 0.0 < ours[1]["total_weight"] < ours[0]["total_weight"]
    assert_tree_records_match(ours, theirs)
    assert_params_close(op, tp)


# ----------------------------------------------------- secure aggregation --
SECURE_DRAWS = {"draws": None}     # the port's own draws (masks, ring)


@pytest.mark.parametrize("kx", ["shared_seed", "dh"])
def test_tree_secure_mean_matches_the_flat_secure_mean(kx):
    fed = dict(secure_agg=True, secure_agg_key_exchange=kx)
    flat, pf = tree_run(tree_configs(4, 0, **fed), 4, n_agg=0,
                        worker_kw=SECURE_DRAWS)
    tree, pt = tree_run(tree_configs(4, **fed), 4, worker_kw=SECURE_DRAWS)
    assert [r["completed"] for r in tree] == [r["completed"] for r in flat]
    assert all(r["completed"] == 4 and not r["unmask_failed"] for r in tree)
    for k in pf:
        np.testing.assert_allclose(pt[k], pf[k], rtol=0,
                                   atol=SECURE_TREE_ATOL, err_msg=k)


LOSE_TRAIN_3 = {"seed": 5, "faults": [
    {"kind": "corrupt_payload", "device_id": "3", "round": 1,
     "op": "train"}]}


def test_dropout_in_one_slice_is_recovered_to_the_survivors_sum(plans):
    """Trainer 3's train reply of round 1 is lost after the share phase
    (slice 1 = devices 2 and 3): slice 1's recovery rebuilds its pair
    masks, and the aggregate is the survivors' plain one."""
    def lose(r, tier, coord):
        if r == 0:
            plans(LOSE_TRAIN_3, "port")

    out = {}
    for secure in (True, False):
        cfgs = tree_configs(4, secure_agg=secure,
                            run_kw=dict(comm_retries=0))
        recs, params = tree_run(cfgs, 4, on_round=lose,
                                worker_kw=SECURE_DRAWS)
        faults.uninstall()
        out[secure] = (recs, params)
    recs, masked = out[True]
    assert recs[1]["completed"] == 3 and recs[1]["dropped"] == ["3"]
    assert recs[1]["unmask_failed"] is False
    assert out[False][0][1]["dropped"] == ["3"]
    plain = out[False][1]
    for k in plain:
        np.testing.assert_allclose(masked[k], plain[k], rtol=0,
                                   atol=CANCEL_ATOL, err_msg=k)


# ---------------------------------------------------- checks and refusals --
@pytest.mark.parametrize("run_kw", [
    dict(num_aggregators=-1),
    dict(num_aggregators=2, agg_heartbeat_timeout=0.0),
    dict(agg_buffer_interval_s=0.0)])
def test_tree_config_checks_are_jax_checks(run_kw):
    jcfg, tcfg = configs(run_kw=run_kw)
    with pytest.raises(ValueError) as theirs:
        jax_config.validate_robustness(jcfg)
    with pytest.raises(ValueError) as ours:
        config.validate_robustness(tcfg)
    assert str(ours.value) == str(theirs.value)


def test_tree_refuses_compress_down_as_jax():
    jcfg, tcfg = tree_configs(compress_down="int8")
    with jax_broker.MessageBroker() as b:
        with pytest.raises(ValueError) as theirs:
            jax_coord.FederatedCoordinator(jcfg, b.host, b.port)
    with broker.MessageBroker() as b:
        with pytest.raises(ValueError) as ours:
            FederatedCoordinator(tcfg, b.host, b.port, device="cpu")
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("op", ["aprep", "abuf", "adrain"])
def test_aggregator_serves_the_buffered_ops_as_jax(op):
    """The buffered-async ops, refused until the asynchronous coordinator
    was ported: after ``aprep``, each answers as JAX's aggregator does
    (``abuf`` stages, ``adrain`` drains what is staged)."""
    jcfg, tcfg = tree_configs()
    replies = {}
    for side, agg in (("port", aggregator.AggregatorServer(tcfg, 0)),
                      ("jax", jax_agg.AggregatorServer(jcfg, 0))):
        with agg:
            cli = TensorClient(agg.host, agg.port, timeout=WAIT)
            try:
                seen = [cli.request({"op": "aprep", "meta": {}}, _shapes(),
                                    timeout=WAIT)[0]]
                if op != "aprep":
                    meta, wire = _updates("topk8", 1)[0]
                    seen.append(cli.request(
                        {"op": "abuf", "key": "00000002@0", "device": "0",
                         "version": 2, "meta": meta}, wire,
                        timeout=WAIT)[0])
                if op == "adrain":
                    seen.append(cli.request(
                        {"op": "adrain", "interval_s": 0.5, "timeout": 0.2,
                         "slice_devices": 1}, timeout=WAIT)[0])
            finally:
                cli.close()
        replies[side] = seen
    for ours, theirs in zip(replies["port"], replies["jax"]):
        assert ours["status"] == theirs["status"] == "ok"
        assert sorted(ours["meta"]) == sorted(theirs["meta"])
        for key in ("count", "keys", "staged", "dedup", "prepared"):
            assert ours["meta"].get(key) == theirs["meta"].get(key), key


def test_device_fold_aggregator_raises_without_a_card(monkeypatch):
    """With ``fold_device`` the aggregator resolves its device and raises
    without a card; without it, it folds on the host and needs none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = tree_configs(run_kw=dict(fold_device=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aggregator.AggregatorServer(tcfg, 0)
    _, host_cfg = tree_configs()
    agg = aggregator.AggregatorServer(host_cfg, 0)
    assert agg.device is None
    agg.stop()


def test_fetch_aggregators_returns_while_heartbeats_flow():
    """Heartbeats closer together than the read's bound never leave a
    quiet gap; the read ends at its bound all the same (JAX's waits for a
    gap, so a 0.05 s heartbeat keeps it reading)."""
    _, tcfg = tree_configs()
    with broker.MessageBroker() as b, contextlib.ExitStack() as stack:
        for a in range(2):
            stack.callback(aggregator.AggregatorServer(
                tcfg, a, b.host, b.port, heartbeat_s=0.05).start().stop)
        sub = broker.BrokerClient(b.host, b.port, timeout=WAIT)
        stack.callback(sub.close)
        sub.subscribe(aggregator.AGG_TOPIC + "#")
        known: dict = {}
        t0 = time.monotonic()
        while len(known) < 2 and time.monotonic() - t0 < WAIT:
            aggregator.fetch_aggregators(sub, known, drain_timeout=0.3)
        first = {a: dict(info) for a, info in known.items()}
        while (not all(known[a]["ts"] > first[a]["ts"] for a in first)
               and time.monotonic() - t0 < WAIT):
            t1 = time.monotonic()
            aggregator.fetch_aggregators(sub, known, drain_timeout=0.3)
            # Beats every 0.05 s leave no 0.3 s gap: only the bound ends
            # the read.
            assert time.monotonic() - t1 < 5.0
    assert sorted(first) == [0, 1]
    assert all(known[a]["ts"] > first[a]["ts"] for a in first)


# -------------------------------------------------------------------- CLI --
def test_cli_tree_processes(tmp_path):
    """The tree as processes, with ``--trace-dir`` and ``--health-dir``:
    the root and each aggregator write their traces and the aggregators
    their ledgers, which ``trace-summary`` and ``health`` read."""
    args = ["--config", "mnist_mlp_fedavg", "--dataset", "mnist_tiny",
            "--num-clients", "3", "--local-steps", "2", "--rounds", "2",
            "--backend", "cpu", "--trace-dir", str(tmp_path / "trace"),
            "--health-dir", str(tmp_path / "health")]
    mod = [sys.executable, "-m", "colearn_federated_learning_tpu_torch.cli"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = []
    try:
        b = subprocess.Popen([*mod, "broker"], env=env, cwd=ROOT,
                             stdout=subprocess.PIPE, text=True)
        procs.append(b)
        port = str(json.loads(b.stdout.readline())["port"])
        for a in range(2):
            procs.append(subprocess.Popen(
                [*mod, "aggregator", *args, "--agg-id", str(a),
                 "--broker-port", port, "--heartbeat", "0.2"], env=env,
                cwd=ROOT, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL))
        for i in range(3):
            procs.append(subprocess.Popen(
                [*mod, "worker", *args, "--client-id", str(i),
                 "--broker-port", port], env=env, cwd=ROOT,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        out = subprocess.run(
            [*mod, "coordinate", *args, "--broker-port", port,
             "--min-devices", "3", "--no-evaluator", "--num-aggregators",
             "2", "--enroll-timeout", "120", "--round-timeout", "120"],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=180)
        assert out.returncode == 0, out.stderr[-2000:]
        last = json.loads(out.stdout.strip().splitlines()[-1])
        assert last["round"] == 1 and last["completed"] == 3
        assert last["aggregators"] == 2 and not last["dropped"]
        lines = [json.loads(line) for line in out.stderr.splitlines()
                 if line.startswith("{")]
        assert lines[0] == {"event": "aggregators_enrolled",
                            "aggregators": [0, 1]}
        assert [r["round"] for r in lines[1:]] == [0, 1]
        assert all(r["health_devices"] == 3 for r in lines[1:])
        for p in procs:
            p.terminate()
        assert [p.wait(WAIT) for p in procs] == [0] * 6
    finally:
        for p in procs:
            p.kill()
    from colearn_federated_learning_tpu_torch import telemetry

    assert sorted(os.listdir(tmp_path / "trace")) == [
        "mnist_mlp_fedavg_aggregator0_trace.json",
        "mnist_mlp_fedavg_aggregator1_trace.json",
        "mnist_mlp_fedavg_trace.json"]
    root = telemetry.trace_spans(telemetry.load_trace(
        str(tmp_path / "trace" / "mnist_mlp_fedavg_trace.json")))
    names = [sp.name for sp in root]
    assert names.count("round") == 2 and names.count("aggregator.fold") == 4
    assert names.count("worker.train") == 6
    tier = telemetry.trace_spans(telemetry.load_trace(str(
        tmp_path / "trace" / "mnist_mlp_fedavg_aggregator0_trace.json")))
    assert [sp.name for sp in tier] == ["aggregator.fold"] * 2
    assert sorted(telemetry.load_health(str(tmp_path / "health"))) == [
        "0", "1", "2"]
