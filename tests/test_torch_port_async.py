"""The port's buffered-asynchronous coordinator
(``comm/async_coordinator.py``) against the JAX package's, on the CPU with
the tiny MLP of ``tests/test_async_coordinator.py``.

- With K = the number of trainers each pump trains once per version, so
  every aggregation folds one fresh update per trainer: fed JAX's draws
  and JAX's init, the port's federation gives JAX's (the same record
  keys, params at f32 rtol 1e-4 / atol 2e-5), and it gives the port's own
  synchronous full-participation rounds.
- Mixed federations: a port coordinator over JAX workers and a JAX
  coordinator over port workers fold as the one-package federation.
- The arrival-keyed staging is bitwise JAX's (dense, topk and topk8
  streams with a device twice), on the host and through the fold
  kernel's plain version; ``_charge_privacy``, ``_update_pruning`` (JAX's
  own cases) and auto-K over a scripted arrival stream give JAX's values;
  the refusals are JAX's, and the port's own name their ROADMAP items.
- JAX's behaviour tests, ported: learning and staleness at K = 2 of 4,
  the escalation, elastic late join, a slow device, topk, pruning,
  default record keys, dead-pump eviction, the version condition's poll,
  DP's ε; the ``fold_update`` spans parent onto their ``dispatch_train``;
  ``device=None`` raises without a card; ``broker``, 3 × ``worker`` and
  ``coordinate --async-buffer 3`` run as processes.

Every wait has its own timeout in code (no pytest-timeout here).
"""

import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu import telemetry as jax_telemetry
from colearn_federated_learning_tpu.comm import aggregation as jax_aggregation
from colearn_federated_learning_tpu.comm import async_coordinator as jax_async
from colearn_federated_learning_tpu.comm import broker as jax_broker
from colearn_federated_learning_tpu.comm import worker as jax_worker
from colearn_federated_learning_tpu.privacy import accountant as jax_acc
from colearn_federated_learning_tpu.telemetry import arrival as jax_arrival
from colearn_federated_learning_tpu.telemetry import health as jax_health
from colearn_federated_learning_tpu_torch import telemetry
from colearn_federated_learning_tpu_torch.comm import broker
from colearn_federated_learning_tpu_torch.comm.aggregation import (
    StreamingFolder, UpdateFolder)
from colearn_federated_learning_tpu_torch.comm.async_coordinator import (
    AsyncFederatedCoordinator)
from colearn_federated_learning_tpu_torch.comm.coordinator import (
    FederatedCoordinator)
from colearn_federated_learning_tpu_torch.comm.worker import DeviceWorker
from colearn_federated_learning_tpu_torch.fed import compression
from colearn_federated_learning_tpu_torch.privacy import accountant
from colearn_federated_learning_tpu_torch.telemetry import arrival, health
from colearn_federated_learning_tpu_torch.utils import trees
from test_torch_port_round import JaxDraws
from test_torch_port_socket import (
    ATOL, ROOT, RTOL, WAIT, configs, jax_init, leaves)

# The record keys that are times on each side's own clock.
TIMING = ("agg_time_s", "phase_collect_s", "phase_apply_s")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def params_of(coord):
    """The coordinator's global params as host numpy leaves."""
    if isinstance(coord, AsyncFederatedCoordinator):
        return leaves(_host(coord.params_tree()))
    return leaves(coord.server_state.params)


def _host(tree):
    return trees.map_leaves(lambda t: t.detach().cpu().numpy(), tree)


@contextlib.contextmanager
def federation(cfgs, n, coord="port", workers="port", ids=None,
               enroll=True, jax_draws=True, **coord_kw):
    """A broker, ``n`` workers (ids ``ids``) and an async coordinator, each
    of either package, as threads; port workers replay JAX's batch draws
    (unless ``jax_draws`` is False: DP's noise is the port's own) and a
    port coordinator starts from JAX's init.  Yields (coordinator,
    workers, broker); everything is stopped on exit."""
    jcfg, tcfg = cfgs
    with contextlib.ExitStack() as stack:
        b = (broker.MessageBroker() if coord == "port"
             else jax_broker.MessageBroker()).start()
        stack.callback(b.stop)
        ws = []
        for i in (ids if ids is not None else range(n)):
            ws.append(start_worker(cfgs, i, b, workers, jax_draws))
            stack.callback(ws[-1].stop)
        if coord == "port":
            c = AsyncFederatedCoordinator(tcfg, b.host, b.port,
                                          device="cpu", **coord_kw)
            c._load_params(jax_init(jcfg))
        else:
            c = jax_async.AsyncFederatedCoordinator(jcfg, b.host, b.port,
                                                    **coord_kw)
        stack.callback(c.close)
        if enroll:
            c.enroll(min_devices=len(ws), timeout=WAIT)
        yield c, ws, b


def start_worker(cfgs, i, b, side="port", jax_draws=True):
    jcfg, tcfg = cfgs
    if side == "port":
        return DeviceWorker(tcfg, i, b.host, b.port, device="cpu",
                            draws=(JaxDraws(tcfg.run.seed) if jax_draws
                                   else None)).start()
    return jax_worker.DeviceWorker(jcfg, i, b.host, b.port).start()


def run(cfgs, n, aggregations, coord="port", workers="port", **kw):
    with federation(cfgs, n, coord, workers, **kw) as (c, _, _):
        hist = c.fit(aggregations=aggregations)
        return [dict(r) for r in hist], params_of(c)


def assert_async_records_match(ours, theirs, rtol=RTOL, atol=ATOL):
    """Same keys; versions, counts, staleness and weights equal (the
    contributors as sets: the arrival order is the threads'); losses and
    scores close."""
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for key in a:
            if key in TIMING:
                continue
            if key == "contributors":
                assert sorted(a[key]) == sorted(b[key])
            elif isinstance(b[key], float) and key != "total_weight":
                np.testing.assert_allclose(a[key], b[key], rtol=rtol,
                                           atol=atol, err_msg=key)
            else:
                assert a[key] == b[key], (key, a[key], b[key])


def assert_params_close(ours, theirs):
    assert list(ours) == list(theirs)
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


# ------------------------------------------------ K = N, the deterministic --
def test_k_equals_n_federation_matches_jax():
    """3 trainers and the evaluator, K = 3: two full-participation
    aggregations, JAX's records and params."""
    cfgs = configs(num_clients=4)
    ours, op = run(cfgs, 4, 2, buffer_size=3)
    theirs, tp = run(cfgs, 4, 2, coord="jax", workers="jax", buffer_size=3)
    assert [r["model_version"] for r in ours] == [1, 2]
    assert all(r["staleness_max"] == 0 and len(r["contributors"]) == 3
               for r in ours)
    assert {"eval_loss", "eval_acc"} <= set(ours[-1])
    assert_async_records_match(ours, theirs)
    assert_params_close(op, tp)


def test_k_equals_n_is_the_synchronous_round():
    """The port's K = N aggregations are its synchronous full-participation
    rounds, up to the fold order."""
    cfgs = configs(num_clients=3)
    ours, op = run(cfgs, 3, 2, buffer_size=3, want_evaluator=False)
    with contextlib.ExitStack() as stack:
        b = broker.MessageBroker().start()
        stack.callback(b.stop)
        for i in range(3):
            stack.callback(start_worker(cfgs, i, b).stop)
        c = FederatedCoordinator(cfgs[1], b.host, b.port,
                                 want_evaluator=False, device="cpu")
        stack.callback(c.close)
        c._load_params(jax_init(cfgs[0]))
        c.enroll(min_devices=3, timeout=WAIT)
        sync = c.fit(rounds=2)
        sp = leaves(_host(c.params_tree()))
    for a, s in zip(ours, sync):
        assert sorted(a["contributors"]) == ["0", "1", "2"]
        assert a["total_weight"] == s["total_weight"]
        np.testing.assert_allclose(a["train_loss"], s["train_loss"],
                                   rtol=RTOL, atol=ATOL)
    assert_params_close(op, sp)


@pytest.mark.parametrize("coord_side,worker_side", [("port", "jax"),
                                                    ("jax", "port")])
def test_mixed_federation_folds_as_the_workers_package(coord_side,
                                                       worker_side):
    """An async coordinator of one package over workers of the other,
    against the federation of the workers' own package (K = N)."""
    cfgs = configs(num_clients=3)
    mixed, mp = run(cfgs, 3, 2, coord=coord_side, workers=worker_side,
                    buffer_size=3, want_evaluator=False)
    same, sp = run(cfgs, 3, 2, coord=worker_side, workers=worker_side,
                   buffer_size=3, want_evaluator=False)
    assert_async_records_match(mixed, same)
    assert_params_close(mp, sp)


# ------------------------------------------------------ staging parity --
def _shapes():
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"params": {"Embed_0": {"embedding": f(16, 8)},
                       "Dense_0": {"kernel": f(8, 32), "bias": f(32)},
                       "Dense_1": {"kernel": f(32, 8)},
                       "LayerNorm_0": {"scale": f(8)}}}


def _arrival_stream(n, scheme):
    """JAX's test stream: ``n`` (device, meta, payload, weight) in arrival
    order, the same device first and last, staleness-style weights."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(300 + i)
        d = trees.map_leaves(
            lambda w: rng.standard_normal(np.shape(w)).astype(np.float32),
            _shapes())
        dev = "dup" if i in (0, n - 1) else str(i)
        meta = {"client_id": dev, "mean_loss": 0.3 + 0.05 * i}
        if scheme != "dense":
            wire, cmeta = compression.compress_delta(d, scheme,
                                                     topk_fraction=0.2)
            meta.update(cmeta)
            d = wire
        out.append((dev, meta, d, (1.0 + i) ** -0.5))
    return out


def _async_stage(folder, stream):
    """Stage as ``run_aggregation`` does: arrival-indexed keys."""
    for idx, (dev, meta, payload, w) in enumerate(stream):
        fmeta = dict(meta)
        fmeta["client_id"] = f"{idx:08d}@{dev}"
        folder.add(fmeta, copy.deepcopy(payload), weight=w)


def _bytes(tree):
    return [np.asarray(leaf).tobytes() for leaf in trees.leaves(tree)]


@pytest.mark.parametrize("device_fold", [False, True],
                         ids=["host", "plain_fold"])
@pytest.mark.parametrize("scheme", ["dense", "topk", "topk8"])
def test_arrival_keyed_staging_is_bitwise_jax(scheme, device_fold):
    """JAX's ``test_async_fold_bitwise_parity_dense/topk``: the staging is
    the arrival-order sum of JAX's legacy ``UpdateFolder`` and its
    ``StreamingFolder``, bit for bit."""
    stream = _arrival_stream(5, scheme)
    legacy = jax_aggregation.UpdateFolder(_shapes())
    for dev, meta, d, w in stream:
        legacy.add(dict(meta), copy.deepcopy(d), weight=w)
    theirs = jax_aggregation.StreamingFolder(_shapes())
    _async_stage(theirs, stream)
    kw = dict(device_fold=True, device="cpu") if device_fold else {}
    ours = StreamingFolder(_shapes(), **kw)
    _async_stage(ours, stream)
    port_legacy = UpdateFolder(_shapes())
    for dev, meta, d, w in stream:
        port_legacy.add(dict(meta), copy.deepcopy(d), weight=w)
    m_leg, w_leg, l_leg = legacy.mean()
    for other in (theirs, ours, port_legacy):
        m, w, l = other.mean()
        assert w == w_leg and l == l_leg
        assert _bytes(m) == _bytes(m_leg)
    assert ours.folded_ids == theirs.folded_ids
    assert ours.densify_avoided == theirs.densify_avoided == (
        0 if scheme == "dense" else 5)


# ---------------------------------------------------- the policies --
def test_charge_privacy_equals_jax():
    """JAX's oracle cases, and a longer sequence: the effective
    multipliers and the accountant's ε are JAX's."""
    cfgs = configs(num_clients=4, dp_clip=1.0, dp_noise_multiplier=2.0,
                   cohort_size=4)
    ours = types.SimpleNamespace(
        config=cfgs[1],
        accountant=accountant.RdpAccountant.from_config(cfgs[1].fed, 1.0))
    theirs = types.SimpleNamespace(
        config=cfgs[0],
        accountant=jax_acc.RdpAccountant.from_config(cfgs[0].fed, 1.0))
    cases = [([1.0, 1.0], ["a", "b"]), ([1.0, 1.0], ["a", "a"]),
             ([1.0, 0.5], ["a", "b"]),
             ([0.7, 0.5 ** 0.5, 1.0 / 3 ** 0.5], ["c", "a", "c"])]
    for weights, devices in cases:
        z = AsyncFederatedCoordinator._charge_privacy(ours, weights,
                                                      devices)
        assert z == jax_async.AsyncFederatedCoordinator._charge_privacy(
            theirs, weights, devices)
        assert ours.accountant.epsilon() == pytest.approx(
            theirs.accountant.epsilon(), rel=1e-12)
    assert ours.accountant.steps == theirs.accountant.steps == 4


def _pruning_cases(side):
    """JAX's ``test_async_update_pruning_policy`` namespaces, built from
    ``side``'s ``DeviceHealth``."""
    mk = lambda ids: [types.SimpleNamespace(device_id=d) for d in ids]
    streak = types.SimpleNamespace(
        _pruned={}, _stale_streak={"a": 5, "b": 5, "c": 1},
        prune_after=3, prune_score=0.0, probation=2, buffer_size=2,
        _health_lock=threading.Lock(), health=None,
        trainers=mk(["a", "b", "c"]), _state_lock=threading.Lock())
    DH = (health if side == "port" else jax_health).DeviceHealth
    slow, fast = DH("s"), DH("f")
    slow.counts["deadline_miss"] = 4
    slow.lat_ewma, fast.lat_ewma = 9.0, 1.0
    attributed = []
    score = types.SimpleNamespace(
        _pruned={}, _stale_streak={},
        prune_after=0, prune_score=12.5, probation=4, buffer_size=1,
        _health_lock=threading.Lock(),
        health=types.SimpleNamespace(
            devices=lambda: {"s": slow, "f": fast},
            record=lambda d, **kw: attributed.append((d, kw))),
        trainers=mk(["s", "f"]), _state_lock=threading.Lock())
    return streak, score, attributed


def _prune_counts(reg):
    return (reg.counter("async.devices_pruned_total",
                        labels={"reason": "stale"}).value,
            reg.counter("async.devices_pruned_total",
                        labels={"reason": "score"}).value,
            reg.counter("async.devices_readmitted_total").value)


def test_update_pruning_equals_jax():
    outcomes = {}
    for side, upd, reg in (
            ("port", AsyncFederatedCoordinator._update_pruning,
             telemetry.get_registry()),
            ("jax", jax_async.AsyncFederatedCoordinator._update_pruning,
             jax_telemetry.get_registry())):
        streak, score, attributed = _pruning_cases(side)
        before = _prune_counts(reg)
        steps = []
        upd(streak, 0)
        steps.append(dict(streak._pruned))
        streak._stale_streak["a"] = 5
        upd(streak, 2)
        steps.append((dict(streak._pruned), dict(streak._stale_streak)))
        upd(score, 0)
        steps.append((dict(score._pruned), list(attributed)))
        counts = [a - b for a, b in zip(_prune_counts(reg), before)]
        outcomes[side] = (steps, counts)
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][0][0] == {"a": 2}
    assert outcomes["port"][1] == [2, 1, 1]


class _KSeen(Exception):
    """Raised where JAX's run_aggregation starts its pumps: auto-K ran."""


def _auto_k_sequence(side, arrivals):
    """K before each of a scripted run of aggregations: ``arrivals`` is a
    list of (arrival times since the last aggregation, folded, discarded)
    steps, fed through ``side``'s estimator and auto-K."""
    est = (arrival if side == "port" else jax_arrival).ArrivalEstimator()
    ns = types.SimpleNamespace(
        tree_mode=False, auto_buffer=True, arrival=est, buffer_size=4,
        auto_interval_s=2.0, _folded_total=0, _discarded_total=0,
        trainers=[object()] * 8)
    reg = (telemetry if side == "port" else jax_telemetry).get_registry()
    seq = []
    for times, folded, discarded in arrivals:
        for t, dev in times:
            est.observe(dev, now=t)
        if side == "port":
            AsyncFederatedCoordinator._auto_resize(ns, reg)
        else:
            def seen():
                raise _KSeen
            ns._start_dispatchers = seen
            try:
                jax_async.AsyncFederatedCoordinator.run_aggregation(ns)
            except _KSeen:
                pass
        seq.append(ns.buffer_size)
        ns._folded_total += folded
        ns._discarded_total += discarded
    return seq


def test_auto_k_sequence_equals_jax():
    rng = np.random.default_rng(5)
    steps, t = [], 100.0
    for i in range(24):
        # Bursts and lulls: the rate swings by 20x over the run.
        gap = 0.05 if (i // 6) % 2 == 0 else 1.0
        times = []
        for _ in range(int(rng.integers(1, 7))):
            t += float(rng.exponential(gap))
            times.append((t, str(int(rng.integers(0, 8)))))
        steps.append((times, int(rng.integers(0, 4)),
                      int(rng.integers(0, 2))))
    ours = _auto_k_sequence("port", steps)
    assert ours == _auto_k_sequence("jax", steps)
    assert len(set(ours)) > 2          # the sequence does move


def _refusal(make):
    try:
        make()
    except Exception as e:          # noqa: BLE001 - the type is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("fed,run_kw,kw", [
    (dict(secure_agg=True), {}, {}),
    (dict(dp_clip=1.0, dp_noise_multiplier=0.5, dp_adaptive_clip=True), {},
     {}),
    (dict(compress_down="int8"), {}, {}),
    (dict(aggregator="median"), {}, {}),
    ({}, {}, dict(prune_after=3)),
    ({}, {}, dict(prune_score=1.0)),
    ({}, {}, dict(probation=0)),
    ({}, {}, dict(buffer_size=0)),
    ({}, {}, dict(buffer_size="many")),
    ({}, {}, dict(auto_interval_s=0.0)),
    ({}, {}, dict(prune_after=-1)),
    ({}, dict(agg_buffer_interval_s=0.0), {})])
def test_refusals_are_jax_refusals(fed, run_kw, kw):
    jcfg, tcfg = configs(run_kw=run_kw, **fed)
    theirs = _refusal(lambda: jax_async.AsyncFederatedCoordinator(
        jcfg, "127.0.0.1", 1, **kw))
    ours = _refusal(lambda: AsyncFederatedCoordinator(
        tcfg, "127.0.0.1", 1, device="cpu", **kw))
    assert theirs is not None and ours == theirs


@pytest.mark.parametrize("fed,run_kw,item", [
    (dict(lora_rank=4), {}, "no LoRA branch"),
    ({}, dict(checkpoint_dir="ck"), None),
    ({}, dict(learn_observe=True), None),
    ({}, dict(tp_size=2), "sharded")])
def test_port_refusals_name_their_items(fed, run_kw, item, monkeypatch,
                                       tmp_path):
    """What the port does not run yet.  LoRA is refused in the port's own
    words: the JAX coordinator has no LoRA branch (it constructs, and
    every dispatch to a LoRA worker fails).  ``checkpoint_dir``, refused
    until the checkpoint plane was ported, is taken (nothing is written
    before a save); ``tp_size`` 2, refused on a host with two cards until
    the sharded server was ported, shards the server state over two of
    the CPU's forced host positions, with no fallback counted;
    ``learn_observe``, refused until item 10b was ported, builds the
    convergence observatory (``tests/test_torch_port_convergence.py``
    holds its records to JAX's)."""
    if item is None:
        monkeypatch.chdir(tmp_path)
        _, tcfg = configs(run_kw=run_kw, **fed)
        with broker.MessageBroker() as b:
            c = AsyncFederatedCoordinator(tcfg, b.host, b.port, device="cpu")
            c.close()
        assert (c._learn is not None) == bool(run_kw.get("learn_observe"))
        assert list(tmp_path.iterdir()) == []
        return
    _, tcfg = configs(run_kw=run_kw, **fed)
    if item == "sharded":
        reg = telemetry.get_registry()
        before = dict(reg.snapshot())
        with broker.MessageBroker() as b:
            c = AsyncFederatedCoordinator(tcfg, b.host, b.port, device="cpu")
            c.close()
        assert c._placement is not None and c._fold_placement is not None
        assert c._placement.n_devices == 2
        assert {k: v for k, v in reg.snapshot().items()
                if k.startswith("fed.mesh_fallback_total")} == {
            k: v for k, v in before.items()
            if k.startswith("fed.mesh_fallback_total")}
        return
    match = (f"ROADMAP.md Queue A {item}" if item.startswith("item ")
             else item)
    with pytest.raises(NotImplementedError, match=match):
        AsyncFederatedCoordinator(tcfg, "127.0.0.1", 1, device="cpu")


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with broker.MessageBroker() as b:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AsyncFederatedCoordinator(configs()[1], b.host, b.port)


# ------------------------------------------------- JAX's behaviour tests --
def test_learns_and_tracks_staleness():
    """K = 2 of 3 trainers (and the evaluator): every aggregation folds 2
    updates and advances the version, staleness stays bounded, the loss
    falls."""
    with federation(configs(num_clients=4), 4, buffer_size=2) as (c, _, _):
        before = c.evaluate()
        hist = c.fit(aggregations=10)
        after = c.evaluate()
    assert [r["model_version"] for r in hist] == list(range(1, 11))
    assert all(len(r["contributors"]) == 2 for r in hist)
    assert all(r["staleness_max"] <= c.max_staleness for r in hist)
    assert any(r["staleness_max"] > 0 for r in hist)
    assert min(r["train_loss"] for r in hist[4:]) < hist[0]["train_loss"]
    assert np.isfinite(before["eval_loss"]) and np.isfinite(
        after["eval_loss"])


def test_escalates_when_no_updates_arrive():
    with federation(configs(num_clients=3), 3, buffer_size=2,
                    request_timeout=1.0, want_evaluator=False) as (c, ws, _):
        for w in ws:
            w.stop()
        with pytest.raises(RuntimeError, match="no update arrived"):
            c.run_aggregation()


def test_elastic_late_join():
    cfgs = configs(num_clients=4)
    with federation(cfgs, 3, buffer_size=2, want_evaluator=False) as (
            c, _, b):
        c.fit(aggregations=2)
        late = start_worker(cfgs, 3, b)
        try:
            deadline = time.time() + 30.0
            admitted = []
            while not admitted and time.time() < deadline:
                admitted = c.refresh_membership()
            assert admitted == ["3"]
            contributors = set()
            while "3" not in contributors and time.time() < deadline:
                contributors.update(c.run_aggregation()["contributors"])
            assert "3" in contributors
        finally:
            late.stop()


def test_slow_device_does_not_stall():
    with federation(configs(num_clients=3), 3, buffer_size=1,
                    request_timeout=30.0, want_evaluator=False) as (
            c, ws, _):
        real = ws[0]._train

        def slow_train(*args, **kw):
            time.sleep(1.5)
            return real(*args, **kw)

        ws[0]._train = slow_train
        c.fit(aggregations=2)
        t0 = time.perf_counter()
        hist = c.fit(aggregations=4)
        wall = time.perf_counter() - t0
    assert len(hist) == 6
    assert wall < 4 * 1.5, wall


def test_topk_composes():
    cfgs = configs(num_clients=3, compress="topk")
    with federation(cfgs, 3, buffer_size=2, want_evaluator=False) as (
            c, ws, _):
        header, wire = ws[0]._train(0, jax_init(cfgs[0]))
        assert header["meta"]["compress"] == "topk"
        hist = c.fit(aggregations=3)
    assert len(hist) == 3
    assert all(np.isfinite(r["train_loss"]) for r in hist)


def test_pruning_pauses_and_readmits(tmp_path):
    cfgs = configs(num_clients=3,
                   run_kw=dict(health_dir=str(tmp_path / "health")))
    with federation(cfgs, 3, buffer_size=1, want_evaluator=False,
                    prune_after=2, probation=3) as (c, _, _):
        rec0 = c.fit(aggregations=1)[0]
        assert rec0["pruned"] == [] and rec0["health_devices"] >= 1
        rec1 = None
        for _ in range(12):
            c._stale_streak["0"] = 99
            rec1 = c.run_aggregation()
            if rec1["pruned"] == ["0"]:
                break
        assert rec1 is not None and rec1["pruned"] == ["0"]
        recs = [c.run_aggregation() for _ in range(2)]
        assert sum(r["contributors"].count("0") for r in recs) <= 1
        assert all(r["pruned"] == ["0"] for r in recs)
        rec4 = c.run_aggregation()
        assert rec4["pruned"] == []
        assert "0" not in c._stale_streak


def test_default_records_have_jax_keys():
    """The default record's keys are exactly JAX's: no pruning, eviction,
    health or observatory key unless those planes are on."""
    keys = {}
    for side in ("port", "jax"):
        with federation(configs(num_clients=3), 3, coord=side,
                        workers=side, buffer_size=2,
                        want_evaluator=False) as (c, _, _):
            keys[side] = sorted(c.run_aggregation())
    assert keys["port"] == keys["jax"]
    for key in ("pruned", "evicted", "skipped_quorum", "health_devices",
                "mass_folded", "arrival_rate_per_s", "staleness_p50"):
        assert key not in keys["port"]


def test_observe_records_have_jax_keys():
    keys = {}
    for side in ("port", "jax"):
        with federation(configs(num_clients=3), 3, coord=side,
                        workers=side, buffer_size=3, observe=True,
                        want_evaluator=False) as (c, _, _):
            keys[side] = sorted(c.run_aggregation())
    assert keys["port"] == keys["jax"]
    assert {"mass_folded", "arrival_rate_per_s",
            "staleness_p99"} <= set(keys["port"])


def test_dead_pump_eviction_and_reenroll():
    cfgs = configs(num_clients=4, run_kw=dict(evict_after=2))
    evicted = telemetry.get_registry().counter("fed.devices_evicted_total")
    e0 = evicted.value
    with federation(cfgs, 3, buffer_size=1, request_timeout=1.0,
                    want_evaluator=False) as (c, ws, b):
        ws[0].stop()
        deadline = time.time() + 60.0
        recs = []
        while "0" not in c.evicted and time.time() < deadline:
            recs.append(c.run_aggregation())
        assert c.evicted == ["0"]
        assert "0" not in {t.device_id for t in c.trainers}
        assert evicted.value - e0 == 1
        recs.append(c.run_aggregation())
        tagged = [r for r in recs if "evicted" in r]
        assert len(tagged) == 1 and tagged[0]["evicted"] == ["0"]
        revived = start_worker(cfgs, 0, b)
        try:
            admitted = []
            while not admitted and time.time() < deadline:
                admitted = c.refresh_membership()
            assert admitted == ["0"]
            contributors = set()
            while "0" not in contributors and time.time() < deadline:
                contributors.update(c.run_aggregation()["contributors"])
            assert "0" in contributors
        finally:
            revived.stop()


def test_version_cv_poll_is_not_load_bearing():
    with federation(configs(num_clients=3), 3, buffer_size=2,
                    request_timeout=30.0, want_evaluator=False,
                    enroll=False) as (c, _, _):
        c._cv_poll_s = 300.0
        c.enroll(min_devices=3, timeout=WAIT)
        hist = c.fit(aggregations=3)
        t_close = time.perf_counter()
        c.close()
        close_s = time.perf_counter() - t_close
    assert [r["model_version"] for r in hist] == [1, 2, 3]
    assert close_s < 10.0, close_s


def test_dp_federation_reports_jax_epsilon():
    """K = N under DP: every aggregation's effective multiplier and ε are
    JAX's; ε grows.  (The noise is each package's own draw.)"""
    cfgs = configs(num_clients=3, dp_clip=1.0, dp_noise_multiplier=1.0)
    ours, _ = run(cfgs, 3, 3, buffer_size=3, want_evaluator=False,
                  jax_draws=False)
    theirs, _ = run(cfgs, 3, 3, coord="jax", workers="jax", buffer_size=3,
                    want_evaluator=False)
    for a, b in zip(ours, theirs):
        assert a["dp_z_eff"] == pytest.approx(b["dp_z_eff"], rel=1e-12)
        assert a["dp_epsilon"] == pytest.approx(b["dp_epsilon"], rel=1e-9)
    eps = [r["dp_epsilon"] for r in ours]
    assert all(y > x for x, y in zip(eps, eps[1:]))


def test_fold_update_spans_parent_onto_their_dispatch():
    with federation(configs(num_clients=3), 3, buffer_size=2,
                    want_evaluator=False) as (c, _, _):
        hist = c.fit(aggregations=3)
        c.close()
        spans = c.tracer.snapshot()
    dispatch = {sp.span_id: sp for sp in spans
                if sp.name == "dispatch_train"}
    folds = [sp for sp in spans if sp.name == "fold_update"]
    aggs = {sp.span_id: sp for sp in spans if sp.name == "async.aggregate"}
    assert len(folds) == sum(len(r["contributors"]) for r in hist) == 6
    for sp in folds:
        parent = dispatch[sp.parent_id]
        assert parent.trace_id == sp.trace_id
        assert parent.attrs["device"] == sp.attrs["device"]
        assert parent.attrs["version"] == sp.attrs["version"]
        assert sp.attrs["outcome"] == "folded"
        assert sp.attrs["link_agg"] in aggs
    for sp in aggs.values():
        kids = {s.name for s in spans if s.parent_id == sp.span_id}
        assert kids == {"collect_updates", "apply_update"}
    # The workers' spans are adopted under their dispatch.
    trains = [sp for sp in spans if sp.name == "worker.train"]
    assert trains and all(sp.parent_id in dispatch for sp in trains)


# -------------------------------------------------------------- the CLI --
def test_cli_async_coordinate_processes():
    args = ["--config", "mnist_mlp_fedavg", "--dataset", "mnist_tiny",
            "--num-clients", "3", "--local-steps", "2", "--rounds", "2",
            "--backend", "cpu"]
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
        for i in range(3):
            procs.append(subprocess.Popen(
                [*mod, "worker", *args, "--client-id", str(i),
                 "--broker-port", port], env=env, cwd=ROOT,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        out = subprocess.run(
            [*mod, "coordinate", *args, "--broker-port", port,
             "--min-devices", "3", "--enroll-timeout", "120",
             "--round-timeout", "120", "--no-evaluator", "--fold-device",
             "--async-buffer", "3"],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
        assert out.returncode == 0, out.stderr[-2000:]
        last = json.loads(out.stdout.strip().splitlines()[-1])
        assert last["aggregation"] == 1 and last["model_version"] == 2
        assert sorted(last["contributors"]) == ["0", "1", "2"]
        assert math.isfinite(last["train_loss"])
        records = [json.loads(line) for line in out.stderr.splitlines()
                   if line.startswith("{")]
        assert [r["aggregation"] for r in records] == [0, 1]
        for p in procs:
            p.terminate()
        assert [p.wait(WAIT) for p in procs] == [0, 0, 0, 0]
    finally:
        for p in procs:
            p.kill()


def test_cli_async_buffer_zero_is_the_synchronous_plane(capsys):
    """``--async-buffer 0`` (JAX's default) runs the synchronous rounds."""
    from colearn_federated_learning_tpu_torch import cli

    argv = ["coordinate", "--broker-port", "1", "--async-buffer", "0"]
    assert cli.build_parser().parse_args(argv).async_buffer == 0
    flags = ["--backend", "cpu", "--config", "mnist_mlp_fedavg",
             "--dataset", "mnist_tiny", "--num-clients", "3",
             "--local-steps", "2", "--rounds", "1"]
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["train", *flags]))
    with contextlib.ExitStack() as stack:
        b = broker.MessageBroker().start()
        stack.callback(b.stop)
        for i in range(3):
            stack.callback(DeviceWorker(cfg, i, b.host, b.port,
                                        device="cpu").start().stop)
        ours = cli.main(["coordinate", *flags, "--broker-port", str(b.port),
                         "--min-devices", "3", "--no-evaluator",
                         "--async-buffer", "0", "--enroll-timeout",
                         str(WAIT)])
    capsys.readouterr()
    assert ours["round"] == 0 and ours["completed"] == 3
