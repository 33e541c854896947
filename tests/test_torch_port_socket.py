"""The port's synchronous socket plane (``comm/``) against the JAX
package's, on the CPU at small sizes.

- Frames are byte-equal to JAX's ``send_msg`` for the same header and
  body, and each package's broker and tensor server serve the other's
  clients (wildcard topics, retained messages, trees both ways).
- A port federation (broker, coordinator and workers as threads) fed
  JAX's batch draws and JAX's initial params gives JAX's federation of
  ``tests/test_comm.py``'s config: params and records at f32 rtol 1e-4 /
  atol 2e-5 (the tiny MLP, SGD with momentum) and the same record keys.
  The small BERT (Adam) is held to the round test's rule
  (``tests/test_torch_port_round.py``): every entry within Adam's step
  bound and 99.9 % of each tensor's entries within rtol 1e-4 / atol 1e-5.
- Mixed federations: a port coordinator folds JAX workers' updates, and a
  JAX coordinator the port workers', each against the all-one-package
  federation on the same updates: FedAvg bit for bit (the same f32
  products and sums in the same order) and FedAdam within 1e-6 (the same
  arithmetic, checked to roundoff), as the file plane was held; with
  int8 uplinks, and topk8 uplinks with error feedback, too.
- Per-client evaluation gives JAX's report.  (The robustness machinery,
  straggler drop, eviction, elastic admission and the quorum no-op, is
  held to JAX's records in ``tests/test_torch_port_faults.py``.)
- ``--compress-down`` frames are byte-equal to JAX's encoder's, and the
  workers' caches rebuild the same params; adaptive top-k moves the
  density as JAX's worker does.
- ``broker``, ``worker`` and ``coordinate`` run as processes
  (``--backend cpu``), as JAX's ``test_cli_multiprocess_federation``.

Every wait has its own timeout in code (no pytest-timeout here).
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.comm import broker as jax_broker
from colearn_federated_learning_tpu.comm import coordinator as jax_coord
from colearn_federated_learning_tpu.comm import downlink as jax_downlink
from colearn_federated_learning_tpu.comm import protocol as jax_protocol
from colearn_federated_learning_tpu.comm import transport as jax_transport
from colearn_federated_learning_tpu.comm import worker as jax_worker
from colearn_federated_learning_tpu.fed import setup as jax_setup
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu_torch.comm import broker, downlink
from colearn_federated_learning_tpu_torch.comm import protocol, transport
from colearn_federated_learning_tpu_torch.comm.coordinator import (
    FederatedCoordinator)
from colearn_federated_learning_tpu_torch.comm.worker import DeviceWorker
from colearn_federated_learning_tpu_torch.utils import config, serialization
from test_torch_port_round import (
    AGREE_FRACTION, FAMILIES, PARAM_ATOL, PARAM_RTOL, JaxDraws)

RTOL, ATOL = 1e-4, 2e-5
WAIT = 20.0          # seconds any enrollment or reply may take here
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs tensors of a few thousand entries: one
    intra-op thread keeps it from crowding the processes beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def configs(num_clients=4, family="mlp", data_kw=None, run_kw=None,
            **fed_kw):
    """(JAX config, port config) of ``tests/test_comm.py``'s federation
    (the tiny MLP), or of the round test's small BERT."""
    if family == "mlp":
        data = dict(dataset="mnist_tiny", partition="iid")
        model = dict(name="mlp", num_classes=10, hidden_dim=32, depth=2)
        fed = dict(strategy="fedavg", rounds=2, cohort_size=0, local_steps=3,
                   batch_size=16, lr=0.1, momentum=0.9)
    else:
        data, model, base = FAMILIES[family]
        fed = dict(base, strategy="fedavg", rounds=2, cohort_size=0,
                   local_steps=2, batch_size=8)
    fed.update(fed_kw)
    data = dict(data, num_clients=num_clients, **(data_kw or {}))
    run = dict(name="comm_test", **(run_kw or {}))
    return [mod.ExperimentConfig(
        data=mod.DataConfig(**data), model=mod.ModelConfig(**model),
        fed=mod.FedConfig(**fed), run=mod.RunConfig(**run))
        for mod in (jax_config, config)]


def jax_init(jcfg):
    return jax.tree.map(np.asarray, jax_setup.init_global_params(jcfg))


def leaves(tree, path=""):
    """``{flax path: f32 array}`` in the wire's leaf order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(leaves(tree[k], f"{path}/{k}"))
        return out
    return {path: np.asarray(tree, np.float32)}


def params_of(coord):
    """The coordinator's global params as host numpy leaves."""
    if isinstance(coord, FederatedCoordinator):
        return leaves(downlink.host_params(coord.params_tree()))
    return leaves(coord.server_state.params)


class Federation:
    """A broker, ``n`` workers and a coordinator of either package, as
    threads.  Port workers replay JAX's batch draws; a port coordinator
    starts from JAX's init."""

    def __init__(self, cfgs, n, coord="port", workers="port",
                 want_evaluator=True, round_timeout=30.0, ids=None,
                 worker_kw=None):
        self.jcfg, self.tcfg = cfgs
        self.stack = contextlib.ExitStack()
        try:
            self._start(n, coord, workers, want_evaluator, round_timeout,
                        ids, worker_kw)
        except BaseException:
            self.stack.close()
            raise

    def _start(self, n, coord, workers, want_evaluator, round_timeout, ids,
               worker_kw):
        self.broker = (broker.MessageBroker() if coord == "port"
                       else jax_broker.MessageBroker()).start()
        self.stack.callback(self.broker.stop)
        self.workers = []
        self.worker_side = workers
        self.worker_kw = worker_kw or {}
        for i in (ids if ids is not None else range(n)):
            self.add_worker(i)
        if coord == "port":
            self.coord = FederatedCoordinator(
                self.tcfg, self.broker.host, self.broker.port,
                round_timeout=round_timeout, want_evaluator=want_evaluator,
                device="cpu")
            self.coord._load_params(jax_init(self.jcfg))
        else:
            self.coord = jax_coord.FederatedCoordinator(
                self.jcfg, self.broker.host, self.broker.port,
                round_timeout=round_timeout, want_evaluator=want_evaluator)
        self.stack.callback(self.coord.close)
        self.coord.enroll(min_devices=len(self.workers), timeout=WAIT)

    def add_worker(self, i, **kw):
        if self.worker_side == "port":
            kw = {"draws": JaxDraws(self.tcfg.run.seed), **self.worker_kw,
                  **kw}
            w = DeviceWorker(self.tcfg, i, self.broker.host, self.broker.port,
                             device="cpu", **kw)
        else:
            w = jax_worker.DeviceWorker(self.jcfg, i, self.broker.host,
                                        self.broker.port,
                                        **{**self.worker_kw, **kw})
        w.start()
        self.stack.callback(w.stop)
        self.workers.append(w)
        return w

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stack.close()


TIMING = ("round_time_s", "phase_broadcast_collect_s", "phase_aggregate_s",
          "phase_fold_overlap_s", "retries")


def assert_records_match(ours, theirs, rtol=RTOL, atol=ATOL):
    """Same keys; counts, drops and weights equal; losses and scores
    close."""
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert sorted(set(a) - {"retries"}) == sorted(set(b) - {"retries"})
        for key in a:
            if key in TIMING:
                continue
            if isinstance(b[key], float) and key != "total_weight":
                if np.isnan(b[key]):
                    assert np.isnan(a[key]), key
                else:
                    np.testing.assert_allclose(a[key], b[key], rtol=rtol,
                                               atol=atol, err_msg=key)
            else:
                assert a[key] == b[key], (key, a[key], b[key])


# ---------------------------------------------------------------- frames --
HEADERS = [({"op": "sub", "topic": "colearn/enroll/#"}, b""),
           ({"op": "train", "round": 3, "cohort": [0, 2, 5],
             "meta": {"w": 1.5, "name": "ü"}}, b"\x00\x01payload" * 100),
           ({"status": "ok"}, bytes(range(256)) * 4096)]


def _through_socket(send, read):
    """``send(sock)`` on one end of a socket pair in a thread, ``read`` on
    the other here (a frame may exceed the socket buffer)."""
    a, b = socket.socketpair()
    with a, b:
        sender = threading.Thread(target=send, args=(a,))
        sender.start()
        out = read(b)
        sender.join(WAIT)
        assert not sender.is_alive()
    return out


@pytest.mark.parametrize("header,body", HEADERS)
def test_frames_are_byte_equal_to_jax(header, body):
    n = 16 + len(json.dumps(header, separators=(",", ":"))) + len(body)
    frames = [bytes(_through_socket(lambda s, f=send: f(s, header, body),
                                    lambda s: protocol._recv_exact(s, n)))
              for send in (protocol.send_msg, jax_protocol.send_msg)]
    assert frames[0] == frames[1]
    for recv in (protocol.recv_msg, jax_protocol.recv_msg):
        got_h, got_b = _through_socket(lambda s: s.sendall(frames[0]), recv)
        assert got_h == header and bytes(got_b) == body


def test_corrupt_frame_is_refused_as_in_jax():
    a, b = socket.socketpair()
    with a, b:
        protocol.send_msg(a, {"x": 1}, b"abc")
        raw = bytearray(b.recv(1 << 16))
        raw[-1] ^= 0xFF
        for recv, exc in ((protocol.recv_msg, protocol.CorruptFrame),
                          (jax_protocol.recv_msg, jax_protocol.CorruptFrame)):
            c, d = socket.socketpair()
            with c, d:
                c.sendall(bytes(raw))
                with pytest.raises(exc, match="crc32"):
                    recv(d)


# ---------------------------------------------------------------- interop --
SIDES = {"port": (broker.MessageBroker, broker.BrokerClient),
         "jax": (jax_broker.MessageBroker, jax_broker.BrokerClient)}


@pytest.mark.parametrize("broker_side,client_side",
                         [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_broker_serves_either_packages_clients(broker_side, client_side):
    Broker, _ = SIDES[broker_side]
    _, Client = SIDES[client_side]
    with Broker() as b:
        sub = Client(b.host, b.port)
        # The suback orders the subscription before the publish, which
        # comes on another connection (a loaded host may serve that one
        # first, and a message nobody subscribed to yet is dropped).
        sub.subscribe("a/b", ack=True)
        assert sub.recv(timeout=WAIT)[0] == {"op": "suback", "topic": "a/b"}
        pub = Client(b.host, b.port)
        pub.publish("a/b", {"x": 1}, body=b"payload")
        header, body = sub.recv(timeout=WAIT)
        assert header["topic"] == "a/b" and header["x"] == 1
        assert bytes(body) == b"payload"
        # A retained message reaches a late subscriber; the wildcard
        # matches; suback follows the replay.  ``sub`` sees both
        # publishes first, so the broker holds them before ``late``
        # subscribes (on a third connection).
        sub.subscribe("roles/#", ack=True)
        assert sub.recv(timeout=WAIT)[0] == {"op": "suback",
                                             "topic": "roles/#"}
        pub.publish("roles/7", {"role": "trainer"}, retain=True)
        pub.publish("roles/8", {"role": "evaluator"}, retain=True)
        assert [sub.recv(timeout=WAIT)[0]["topic"] for _ in range(2)] == [
            "roles/7", "roles/8"]
        late = Client(b.host, b.port)
        late.subscribe("roles/#", ack=True)
        got = [late.recv(timeout=WAIT)[0] for _ in range(3)]
        assert [(h["topic"], h.get("role")) for h in got[:2]] == [
            ("roles/7", "trainer"), ("roles/8", "evaluator")]
        assert got[2] == {"op": "suback", "topic": "roles/#"}
        with pytest.raises(TimeoutError):
            sub.recv(timeout=0.2)
        for c in (sub, pub, late):
            c.close()


TRANSPORTS = {"port": (transport.TensorServer, transport.TensorClient),
              "jax": (jax_transport.TensorServer, jax_transport.TensorClient)}


@pytest.mark.parametrize("server_side,client_side",
                         [("port", "jax"), ("jax", "port")])
def test_transport_serves_either_packages_clients(server_side, client_side):
    Server, _ = TRANSPORTS[server_side]
    _, Client = TRANSPORTS[client_side]

    def handler(header, tree):
        if header["op"] == "boom":
            raise RuntimeError("boom")
        out = jax.tree.map(lambda v: np.asarray(v) * 2, tree)
        return {"meta": {"ok": True, "seen": header["meta"]}}, out

    tree = {"w": np.arange(6.0, dtype=np.float32).reshape(2, 3),
            "sub": {"b": np.ones(3, np.int32)}}
    with Server(handler) as srv:
        cli = Client(srv.host, srv.port)
        header, out = cli.request({"op": "double"}, tree, meta={"r": 2},
                                  timeout=WAIT)
        assert header["status"] == "ok" and header["meta"]["ok"]
        assert header["meta"]["seen"] == {"r": 2}
        np.testing.assert_array_equal(out["w"], tree["w"] * 2)
        np.testing.assert_array_equal(out["sub"]["b"], 2 * tree["sub"]["b"])
        header, _ = cli.request({"op": "boom"}, None, timeout=WAIT)
        assert header["status"] == "error" and "boom" in header["error"]
        cli.close()


# ------------------------------------------------------------- federation --
def _run(cfgs, n, rounds, coord="port", workers="port", **kw):
    with Federation(cfgs, n, coord=coord, workers=workers, **kw) as f:
        hist = f.coord.fit(rounds=rounds)
        return [dict(r) for r in hist], params_of(f.coord)


def test_federation_matches_jax():
    cfgs = configs(num_clients=4)
    ours, op = _run(cfgs, 4, 2)
    theirs, tp = _run(cfgs, 4, 2, coord="jax", workers="jax")
    assert [r["completed"] for r in ours] == [3, 3]
    assert_records_match(ours, theirs)
    assert {"eval_loss", "eval_acc"} <= set(ours[-1])
    assert list(op) == list(tp)
    for k in op:
        np.testing.assert_allclose(op[k], tp[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_bert_federation_matches_jax():
    cfgs = configs(num_clients=2, family="bert")
    ours, op = _run(cfgs, 2, 1, want_evaluator=False)
    theirs, tp = _run(cfgs, 2, 1, coord="jax", workers="jax",
                      want_evaluator=False)
    lr = cfgs[1].fed.lr
    step_bound = 3 * lr * cfgs[1].fed.local_steps
    assert_records_match(ours, theirs, rtol=1e-3, atol=1e-3)
    for k in op:
        err = np.abs(op[k] - tp[k])
        assert err.max() <= step_bound, (k, err.max(), step_bound)
        if k.endswith("MultiHeadAttention_0/key/bias"):
            continue          # a zero true gradient: the step bound alone
        agree = err <= PARAM_ATOL + PARAM_RTOL * np.abs(tp[k])
        assert agree.mean() >= AGREE_FRACTION, (k, agree.mean())


@pytest.mark.parametrize("fed_kw,exact", [
    (dict(strategy="fedavg"), True),
    (dict(strategy="fedadam", server_lr=0.01), False),
    (dict(strategy="fedavg", compress="int8"), True),
    (dict(strategy="fedavg", compress="topk8", compress_feedback=True,
          topk_fraction=0.1), True)])
@pytest.mark.parametrize("coord_side,worker_side",
                         [("port", "jax"), ("jax", "port")])
def test_mixed_federation_folds_as_the_workers_package(
        fed_kw, exact, coord_side, worker_side):
    """A coordinator of one package over workers of the other, against
    the federation of the workers' own package: the same updates, folded
    and applied by the other package."""
    cfgs = configs(num_clients=3, **fed_kw)
    mixed, mp = _run(cfgs, 3, 2, coord=coord_side, workers=worker_side,
                     want_evaluator=False)
    same, sp = _run(cfgs, 3, 2, coord=worker_side, workers=worker_side,
                    want_evaluator=False)
    assert [r["completed"] for r in mixed] == [3, 3]
    for k in mp:
        if exact:
            assert np.array_equal(mp[k], sp[k]), k
        else:
            np.testing.assert_allclose(mp[k], sp[k], rtol=0, atol=1e-6,
                                       err_msg=k)
    for a, b in zip(mixed, same):
        for key in ("completed", "dropped", "total_weight",
                    "bytes_saved_uplink", "uplink_densify_avoided"):
            assert a.get(key) == b.get(key), key
        assert a["train_loss"] == b["train_loss"]


def test_per_client_evaluation_gives_jax_report():
    reports = {}
    for side in ("port", "jax"):
        cfgs = configs(num_clients=4, data_kw=dict(partition="dirichlet",
                                                    dirichlet_alpha=0.2))
        with Federation(cfgs, 4, coord=side, workers=side) as f:
            f.coord.fit(rounds=1)
            reports[side] = f.coord.evaluate_per_client()
    ours, theirs = reports["port"], reports["jax"]
    assert sorted(ours) == sorted(theirs)
    assert ours["num_clients_evaluated"] == 3
    assert sorted(ours["per_client"]) == sorted(theirs["per_client"])
    for cid, acc in theirs["per_client"].items():
        np.testing.assert_allclose(ours["per_client"][cid], acc, atol=1e-6)
    for key in ("weighted_loss", "weighted_acc", "acc_p10", "acc_p50",
                "acc_p90"):
        np.testing.assert_allclose(ours[key], theirs[key], rtol=RTOL,
                                   atol=ATOL, err_msg=key)


# ---------------------------------------------------------------- codecs --
@pytest.mark.parametrize("scheme", ["none", "int8", "topk8"])
def test_downlink_frames_are_byte_equal_to_jax(scheme):
    ours, theirs = downlink.DownlinkEncoder(scheme), \
        jax_downlink.DownlinkEncoder(scheme)
    cache, jcache = downlink.WorkerParamCache(), jax_downlink.WorkerParamCache()
    rng = np.random.default_rng(0)
    params = {"Dense_0": {"kernel": rng.standard_normal((20, 8)).astype(
        np.float32), "bias": np.zeros(8, np.float32)}}
    for r in range(3):
        params = jax.tree.map(
            lambda p: p + 0.01 * rng.standard_normal(p.shape).astype(
                np.float32), params)
        a, ra, sa = ours.encode_round(r, params)
        b, rb, sb = theirs.encode_round(r, params)
        assert bytes(a) == bytes(b) and sa == sb
        if scheme != "none":
            assert bytes(ra()) == bytes(rb())
            tree, meta = serialization.bytes_to_pytree(bytes(a))
            got = cache.resolve(r, meta, tree)
            want = jcache.resolve(r, meta, tree)
            got, want = leaves(got), leaves(want)
            assert all(np.array_equal(got[k], want[k]) for k in want)


def test_downlink_int8_federation_tracks_the_full_broadcast():
    """compress_down=int8 lands near the plain federation (JAX's bounds),
    saves downlink bytes after the base round and never resyncs (JAX's
    counters ``comm.bytes_saved_downlink`` and ``comm.resync_total``)."""
    from colearn_federated_learning_tpu_torch import telemetry

    base, bp = _run(configs(num_clients=3, momentum=0.0, lr=0.05), 3, 3)
    cfgs = configs(num_clients=3, momentum=0.0, lr=0.05,
                   compress_down="int8")
    reg = telemetry.get_registry()
    reg.reset()
    with Federation(cfgs, 3) as f:
        hist = f.coord.fit(rounds=3)
        dp = params_of(f.coord)
    assert reg.counter("comm.bytes_saved_downlink").value > 0
    assert reg.counter("comm.resync_total").value == 0
    np.testing.assert_allclose([r["train_loss"] for r in hist],
                               [r["train_loss"] for r in base],
                               rtol=0.15, atol=0.05)
    for k in bp:
        np.testing.assert_allclose(dp[k], bp[k], rtol=0.25, atol=0.02)


def test_adaptive_topk_moves_the_density_as_jax():
    jcfg, tcfg = configs(num_clients=2, compress="topk8",
                         compress_feedback=True, topk_adaptive=True,
                         topk_fraction=0.05, topk_min_fraction=0.02,
                         topk_max_fraction=0.2)
    ours = DeviceWorker(tcfg, 0, device="cpu")
    theirs = jax_worker.DeviceWorker(jcfg, 0)
    assert ours._topk_fraction == theirs._topk_fraction
    for norm in (1.0, 2.0, 3.0, 3.0, 1.0, 0.5, 9.0, 9.5, 10.0, 11.0):
        ours._adapt_topk(norm)
        theirs._adapt_topk(norm)
        assert ours._topk_fraction == theirs._topk_fraction


# -------------------------------------------------------------------- CLI --
def test_cli_broker_worker_coordinate_processes():
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
             "--round-timeout", "120", "--fold-device"],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
        assert out.returncode == 0, out.stderr[-2000:]
        last = json.loads(out.stdout.strip().splitlines()[-1])
        assert last["round"] == 1 and last["completed"] == 2
        assert 0.0 <= last["eval_acc"] <= 1.0
        records = [json.loads(line) for line in out.stderr.splitlines()
                   if line.startswith("{")]
        assert [r["round"] for r in records] == [0, 1]
        for p in procs:
            p.terminate()
        assert [p.wait(WAIT) for p in procs] == [0, 0, 0, 0]
    finally:
        for p in procs:
            p.kill()


@pytest.mark.parametrize("fed,run,item", [
    (dict(compress_down="int8"), dict(num_aggregators=2), "tree"),
    ({}, dict(checkpoint_dir="ck"), None),
    ({}, dict(health_dir="h"), "ledger"),
    ({}, dict(learn_observe=True), None),
    ({}, dict(tp_size=2), None)])
def test_coordinator_refuses_what_is_not_ported(fed, run, item, tmp_path,
                                                monkeypatch):
    """Each unported option raises naming its ROADMAP item; the aggregator
    tree with ``compress_down`` raises JAX's ValueError.  ``health_dir``,
    refused until the telemetry core was ported, now opens the
    coordinator's ledger file there; ``checkpoint_dir``, refused until the
    checkpoint plane was ported, is taken (nothing is written before a
    round or an enrollment); ``tp_size`` 2, refused on a host with two
    cards until the sharded server was ported, shards the server state
    over two of the CPU's forced host positions (``tests/conftest.py``);
    ``learn_observe``, refused until item 10b was ported, builds the
    convergence observatory."""
    monkeypatch.chdir(tmp_path)
    jcfg, tcfg = configs(num_clients=2, run_kw=run, **fed)
    with broker.MessageBroker() as b:
        if item is None:
            coord = FederatedCoordinator(tcfg, b.host, b.port, device="cpu")
            coord.close()
            assert list(tmp_path.iterdir()) == []
            assert (coord._learn is not None) == bool(
                run.get("learn_observe"))
            if run.get("tp_size", 1) > 1:
                assert coord._placement is not None
                assert coord._placement.n_devices == run["tp_size"]
                assert any(len(l.parts) == run["tp_size"]
                           for l in jax.tree.leaves(coord.params_tree()))
            return
        if item == "ledger":
            coord = FederatedCoordinator(tcfg, b.host, b.port, device="cpu")
            coord.close()
            assert coord.health.path == os.path.join(
                "h", "health_coordinator.jsonl")
            assert (tmp_path / "h").is_dir()
            return
        if item == "tree":
            with pytest.raises(ValueError) as theirs:
                jax_coord.FederatedCoordinator(jcfg, b.host, b.port)
            with pytest.raises(ValueError, match="requires compress_down="
                               "'none'") as ours:
                FederatedCoordinator(tcfg, b.host, b.port, device="cpu")
            assert str(ours.value) == str(theirs.value)
            return
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP.md Queue A {item}"):
            FederatedCoordinator(tcfg, b.host, b.port, device="cpu")
