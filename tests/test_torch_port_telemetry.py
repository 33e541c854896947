"""The port's telemetry core (``telemetry/``, ``metrics.py``) against the
JAX package's, on the CPU at small sizes.

- The registry: the same operations give equal ``snapshot()`` and
  ``typed_snapshot()`` (labelled children and histogram thinning
  included), and strict mode and type confusion raise on the same names.
- The arrival estimator gives JAX's estimates for the same gaps.
- Span ids of a port tracer are disjoint from a JAX tracer's in the same
  process, in JAX's 16-hex-digit form.
- Traces: a port trace file loads in JAX's ``load_trace``/``trace_spans``
  and JAX's ``summarize_trace`` text of it equals the port's, and the
  other way round.
- The engine: default records keep their keys (JAX's), traced records
  gain exactly JAX's keys (``flops_per_round`` too), the trace window
  honours ``trace_rounds``, ``client_update`` is ``phase_update_s``, and
  the engine's counters equal JAX's.
- The socket plane: the same federation of either package (broker,
  coordinator and workers as threads) gives equal deterministic counters,
  under DH secure aggregation with one lost reply too; each package's
  transport counts the same bytes for the same frames; mixed federations
  adopt each other's spans with no colliding ids.
- ``MetricsLogger``: the JSONL lines equal JAX's but for ``ts`` and the
  timings, and the TensorBoard tags and steps are JAX's.

(Every test resets both packages' process registries: they are separate
singletons.)
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu import faults as jax_faults
from colearn_federated_learning_tpu import metrics as jax_metrics
from colearn_federated_learning_tpu import telemetry as jax_telemetry
from colearn_federated_learning_tpu.comm import broker as jax_broker
from colearn_federated_learning_tpu.comm import transport as jax_transport
from colearn_federated_learning_tpu.fed.engine import (
    FederatedLearner as JaxLearner)
from colearn_federated_learning_tpu.telemetry import registry as jax_registry
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu_torch import faults, metrics, telemetry
from colearn_federated_learning_tpu_torch.comm import broker, transport
from colearn_federated_learning_tpu_torch.fed import FederatedLearner
from colearn_federated_learning_tpu_torch.telemetry import registry
from colearn_federated_learning_tpu_torch.utils import config
from test_torch_port_socket import Federation, configs
from test_torch_port_tree import tree_configs, tree_run
from test_torch_port_wire_secure import DROP_TRAIN_2, PORT_DRAWS


@pytest.fixture(autouse=True)
def _fresh_registries():
    """Both packages' process registries start empty."""
    telemetry.get_registry().reset()
    jax_telemetry.get_registry().reset()
    yield
    telemetry.get_registry().reset()
    jax_telemetry.get_registry().reset()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --------------------------------------------------------------- registry --
def _exercise(reg):
    """One sequence of registry operations (labelled children, a histogram
    thinned twice, gauges left unset and set)."""
    reg.counter("comm.messages_sent").inc(3)
    reg.counter("comm.retry_total", labels={"device": "1"}).inc()
    reg.counter("comm.retry_total", labels={"device": "2"}).inc(2.5)
    reg.counter("comm.retry_total").inc()
    reg.gauge("engine.h2d_transfer_s").set(0.25)
    reg.gauge("comm.agg_heartbeat_age_s", labels={"agg": "0"}).set(1)
    reg.gauge("health.devices_tracked")
    h = reg.histogram("fed.round_time_s", max_samples=8)
    for i in range(37):
        h.observe(float((i * 7) % 11))
    child = reg.histogram("fed.phase_time_s", labels={"phase": "aggregate"},
                          max_samples=4)
    for i in range(9):
        child.observe(i / 4)
    reg.histogram("comm.agg_fold_time_s")
    return h


def test_registry_snapshots_equal_jax():
    ours, theirs = registry.MetricsRegistry(), jax_registry.MetricsRegistry()
    h_ours, h_theirs = _exercise(ours), _exercise(theirs)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.typed_snapshot() == theirs.typed_snapshot()
    assert h_ours._stride == h_theirs._stride == 8
    assert h_ours._samples == h_theirs._samples
    for q in (0.0, 0.5, 0.9, 0.99):
        assert h_ours.quantile(q) == h_theirs.quantile(q)
    ours.reset()
    theirs.reset()
    assert ours.snapshot() == theirs.snapshot() == {}


@pytest.mark.parametrize("name", [
    "comm.messages_sent", "fault.injected.delay", "comm.retry_totl",
    "engine.rounds_total", "no.such_metric"])
def test_strict_mode_raises_on_the_same_names(name, monkeypatch):
    monkeypatch.setattr(registry, "_STRICT", True)
    monkeypatch.setattr(jax_registry, "_STRICT", True)
    outcomes = []
    for reg in (registry.MetricsRegistry(), jax_registry.MetricsRegistry()):
        try:
            reg.counter(name).inc()
            outcomes.append("ok")
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] == "ok") == (name in ("comm.messages_sent",
                                              "fault.injected.delay",
                                              "engine.rounds_total"))


def test_kind_confusion_raises_as_jax():
    for reg in (registry.MetricsRegistry(), jax_registry.MetricsRegistry()):
        reg.counter("comm.bytes_sent")
        with pytest.raises(TypeError, match="is a Counter, not a Gauge"):
            reg.gauge("comm.bytes_sent")
        with pytest.raises(ValueError, match="cannot decrease"):
            reg.counter("comm.bytes_sent").inc(-1)


def test_arrival_copy_gives_the_jax_estimates():
    from colearn_federated_learning_tpu.telemetry.arrival import (
        ArrivalEstimator as JaxArrival)

    ours, theirs = telemetry.ArrivalEstimator(), JaxArrival()
    rng = np.random.default_rng(3)
    t = 0.0
    for i in range(40):
        t += float(rng.exponential(0.5))
        dev = str(int(rng.integers(0, 5)))
        ours.observe(dev, now=t)
        theirs.observe(dev, now=t)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.rate() == theirs.rate()
    assert ours.device_rates() == theirs.device_rates()
    assert (ours.recommend_buffer(2.0, lo=1, hi=64)
            == theirs.recommend_buffer(2.0, lo=1, hi=64))


# ----------------------------------------------------------------- tracer --
def test_span_ids_are_disjoint_from_jax_ids_in_one_process():
    ours = {telemetry.new_id() for _ in range(500)}
    theirs = {jax_telemetry.new_id() for _ in range(500)}
    assert not ours & theirs
    assert all(len(i) == 16 and int(i, 16) >= 0 for i in ours | theirs)


def _trace(pkg, tmp_path, name):
    """Two rounds of nested spans with a remote parent and adopted
    worker spans, written by ``pkg``'s exporter."""
    coord = pkg.Tracer(process="coordinator")
    worker = pkg.Tracer(process="worker-1", enabled=False)
    for r in range(2):
        with coord.span("round", round=r):
            ctx = coord.current_context()
            with coord.span("broadcast_collect", cohort=2):
                with worker.capture() as captured:
                    with worker.span("worker.train", parent=ctx,
                                     client_id=1, round=r):
                        with worker.span("local_train", steps=3):
                            pass
                coord.adopt([s.to_dict() for s in captured])
            with coord.span("aggregate"):
                pass
    return pkg.write_tracer(str(tmp_path), name, coord,
                            metrics={"fed.rounds_total": 2.0})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_traces_load_and_summarize_alike_in_both_packages(writer, tmp_path):
    pkg = telemetry if writer == "port" else jax_telemetry
    path = _trace(pkg, tmp_path, writer)
    docs = [telemetry.load_trace(path), jax_telemetry.load_trace(path)]
    assert docs[0] == docs[1]
    ours, theirs = (telemetry.trace_spans(docs[0]),
                    jax_telemetry.trace_spans(docs[1]))
    assert [s.to_dict() for s in ours] == [s.to_dict() for s in theirs]
    assert len(ours) == 10 and {s.process for s in ours} == {
        "coordinator", "worker-1"}
    for root in ("round", "broadcast_collect"):
        assert (telemetry.summarize_trace(docs[0], root=root)
                == jax_telemetry.summarize_trace(docs[1], root=root))
    # The exporters agree event for event on the same spans.
    assert (telemetry.spans_to_chrome(ours)
            == jax_telemetry.spans_to_chrome(theirs))


# ----------------------------------------------------------------- engine --
def _engine_cfgs(**run_kw):
    """(port config, JAX config): the tiny MLP on 4 clients, cohort 2."""
    out = []
    for mod in (config, jax_config):
        base = mod.get_config("mnist_mlp_fedavg")
        out.append(base.replace(
            data=dataclasses.replace(base.data, dataset="mnist_tiny",
                                     num_clients=4),
            fed=dataclasses.replace(base.fed, rounds=3, local_steps=2,
                                    cohort_size=2),
            run=dataclasses.replace(base.run, **run_kw)))
    return out


@pytest.mark.parametrize("strategy", ["fedavg", "scaffold"])
def test_engine_records_and_trace_window_as_jax(strategy, tmp_path):
    """Untraced records keep JAX's keys; traced ones gain exactly JAX's,
    ``flops_per_round`` included, their window is the first
    ``trace_rounds`` rounds, and ``client_update`` is ``phase_update_s``."""
    out = {}
    for traced in (False, True):
        run_kw = dict(trace_rounds=2) if traced else {}
        tcfg, jcfg = _engine_cfgs(**run_kw)
        tcfg, jcfg = (c.replace(
            fed=dataclasses.replace(c.fed, strategy=strategy, momentum=0.0),
            run=dataclasses.replace(c.run, trace_dir=(
                str(tmp_path / side) if traced else None)))
            for c, side in ((tcfg, "port"), (jcfg, "jax")))
        ours = FederatedLearner(tcfg, device="cpu")
        theirs = JaxLearner(jcfg)
        out[traced] = (ours.fit(), theirs.fit(), ours, theirs)
    plain, _, _, _ = out[False]
    jplain = out[False][1]
    assert [sorted(r) for r in plain] == [sorted(r) for r in jplain]
    recs, jrecs, ours, theirs = out[True]
    for a, b in zip(recs, jrecs):
        assert sorted(a) == sorted(b)
        assert "flops_per_round" in a and "flops_per_round" in b
    assert [sorted(set(r) - {"flops_per_round"}) for r in recs] == [
        sorted(r) for r in plain]
    doc = telemetry.load_trace(ours.last_trace_path)
    jdoc = jax_telemetry.load_trace(theirs.last_trace_path)
    spans = jax_telemetry.trace_spans(doc)
    names = sorted(s.name for s in spans)
    # JAX's window holds the same spans; under SCAFFOLD the port scatters
    # each contributor's variates inside client_update (2 per round).
    jnames = sorted(s.name for s in jax_telemetry.trace_spans(jdoc))
    assert [n for n in names if n != "scatter_variates"] == [
        n for n in jnames if n != "scatter_variates"]
    assert names.count("scatter_variates") == (4 if strategy == "scaffold"
                                               else 0)
    rounds = sorted(s.attrs["round"] for s in spans if s.name == "round")
    assert rounds == [0, 1]
    updates = {s.attrs["round"]: s.duration_s for s in spans
               if s.name == "client_update"}
    # The trace stores microseconds; the record the float seconds.
    for r in (0, 1):
        assert updates[r] == pytest.approx(recs[r]["phase_update_s"],
                                           rel=1e-9, abs=1e-9)


def test_engine_counters_equal_jax():
    tcfg, jcfg = _engine_cfgs()
    FederatedLearner(tcfg, device="cpu").fit(rounds=2)
    JaxLearner(jcfg).fit(rounds=2)
    ours = telemetry.get_registry().snapshot()
    theirs = jax_telemetry.get_registry().snapshot()
    for name in ("engine.rounds_total", "local.trainers_built",
                 "local.steps_per_round"):
        assert ours[name] == theirs[name], name
    for name in ("engine.round_time_s", "engine.h2d_transfer_s"):
        assert name in ours and name in theirs
    assert ours["engine.round_time_s"]["count"] == 2


# ----------------------------------------------------------- socket plane --
def _settled(reg, wait_s=5.0):
    """``reg``'s snapshot once every frame received in the process was
    also counted sent: a sender counts a frame after its write returned,
    which may be after the receiver counted it."""
    deadline = time.monotonic() + wait_s
    snap = reg.snapshot()
    while (snap.get("comm.bytes_sent") != snap.get("comm.bytes_received")
           and time.monotonic() < deadline):
        time.sleep(0.01)
        snap = reg.snapshot()
    return snap


DETERMINISTIC = ("comm.messages_sent", "comm.messages_received",
                 "fed.rounds_total", "fed.clients_dropped",
                 "fed.clients_evicted", "local.trainers_built",
                 "comm.broadcast_encode_total", "comm.bytes_saved_uplink",
                 "comm.uplink_densify_avoided_total")


def _federation_counters(side, cfgs, n, rounds, evaluator, plan=None):
    telemetry.get_registry().reset()
    jax_telemetry.get_registry().reset()
    secure = cfgs[1].fed.secure_agg
    with Federation(cfgs, n, coord=side, workers=side,
                    want_evaluator=evaluator,
                    worker_kw=PORT_DRAWS if secure and side == "port"
                    else None) as f:
        for r in range(rounds):
            if plan is not None and r == 1:
                f.coord.round_timeout = 4.0
                text = json.dumps(plan)
                if side == "port":
                    faults.install(faults.FaultPlan.from_json(text))
                else:
                    jax_faults.install(jax_faults.FaultPlan.from_json(text))
            try:
                rec = f.coord.run_round()
            finally:
                faults.uninstall()
                jax_faults.uninstall()
        if evaluator:
            f.coord.evaluate()
        spans = f.coord.tracer.snapshot()
    reg = (telemetry if side == "port" else jax_telemetry).get_registry()
    return _settled(reg), rec, spans


@pytest.mark.parametrize("case", ["topk8", "dh_lost_reply"])
def test_federation_counters_equal_jax(case):
    """The same federation of either package gives the same deterministic
    counters: frames, rounds, drops, trainers, encodes and the uplink's;
    under DH secure aggregation with trainer 2's train reply lost after
    the share phase, the privacy and fault counters too."""
    if case == "topk8":
        cfgs = configs(num_clients=3, compress="topk8",
                       compress_feedback=True)
        kw = dict(n=3, rounds=2, evaluator=True)
    else:
        cfgs = configs(num_clients=4, secure_agg=True)
        kw = dict(n=4, rounds=2, evaluator=False, plan=DROP_TRAIN_2)
    ours, rec, spans = _federation_counters("port", cfgs, **kw)
    theirs, jrec, _ = _federation_counters("jax", cfgs, **kw)
    names = list(DETERMINISTIC)
    if case == "dh_lost_reply":
        assert rec["dropped"] == jrec["dropped"] == ["2"]
        names += [k for k in theirs if k.startswith(("privacy.", "fault."))]
        assert "privacy.masks_recovered_total{device=2}" in names
        assert "fault.injected_total{device=2,kind=drop_request}" in names
    for name in names:
        assert ours.get(name) == theirs.get(name), name
    assert ours["comm.messages_sent"] == ours["comm.messages_received"]
    # Every worker span of the round was adopted, none was dropped.
    assert {s.name for s in spans} >= {"round", "serialize_params",
                                       "broadcast_collect", "aggregate",
                                       "worker.train", "local_train",
                                       "compress_delta"}


def test_transports_count_the_same_bytes_for_the_same_frames():
    """A broker exchange and a tensor request, the same frames in either
    package: each package's counters hold the same bytes and messages
    (the frames are byte-equal, so their lengths are too)."""
    tree = {"w": np.arange(12, dtype=np.float32).reshape(3, 4)}
    keys = ("comm.messages_sent", "comm.messages_received",
            "comm.bytes_sent", "comm.bytes_received")

    def exchange(bmod, tmod, reg):
        reg.reset()
        with bmod.MessageBroker() as b:
            sub = bmod.BrokerClient(b.host, b.port)
            pub = bmod.BrokerClient(b.host, b.port)
            sub.subscribe("t/x", ack=True)
            sub.recv(timeout=5.0)
            pub.publish("t/x", {"v": 1})
            sub.recv(timeout=5.0)
            srv = tmod.TensorServer(lambda h, t: ({"meta": {"ok": 1}}, t))
            srv.start()
            cli = tmod.TensorClient(srv.host, srv.port)
            cli.request({"op": "train", "round": 0}, tree)
            cli.close()
            srv.stop()
            sub.close()
            pub.close()
        snap = _settled(reg)
        return {k: snap[k] for k in keys}

    ours = exchange(broker, transport, telemetry.get_registry())
    theirs = exchange(jax_broker, jax_transport,
                      jax_telemetry.get_registry())
    assert ours == theirs
    assert ours["comm.bytes_sent"] == ours["comm.bytes_received"] > 0
    assert ours["comm.messages_sent"] == ours["comm.messages_received"] == 6


@pytest.mark.parametrize("coord_side,other", [("port", "jax"),
                                              ("jax", "port")])
def test_mixed_federations_adopt_each_others_spans(coord_side, other):
    """A coordinator of one package over the other's workers (flat), and
    over the other's aggregators and workers (the tree): the worker spans
    parent onto the root's round (through the tier's ``aggregator.fold``
    under the tree) and no two spans share an id."""
    cfgs = configs(num_clients=3)
    with Federation(cfgs, 3, coord=coord_side, workers=other,
                    want_evaluator=False) as f:
        f.coord.run_round()
        flat = f.coord.tracer.snapshot()
    tracers = []
    tree_run(tree_configs(), 3, rounds=1, coord=coord_side, aggs=other,
             workers=other,
             on_round=lambda r, tier, c: tracers.append(c.tracer))
    tree = tracers[0].snapshot()
    for spans in (flat, tree):
        ids = [s.span_id for s in spans]
        assert len(ids) == len(set(ids))
        by_id = {s.span_id: s for s in spans}
        trains = [s for s in spans if s.name == "worker.train"]
        assert len(trains) == 3
        assert all(s.process.startswith("worker-") for s in trains)
        for s in trains:
            parent = by_id[s.parent_id]
            if spans is tree:
                assert parent.name == "aggregator.fold"
                parent = by_id[parent.parent_id]
            assert parent.name == "round"


# --------------------------------------------------------- metrics logger --
def _tb_scalars(directory):
    """``{(tag, step): value}`` of every scalar event under ``directory``,
    written by torch's SummaryWriter or by flax's (a tensor summary)."""
    from tensorboard.backend.event_processing.event_file_loader import (
        EventFileLoader)
    from tensorboard.util import tensor_util

    out = {}
    for name in sorted(os.listdir(directory)):
        for event in EventFileLoader(os.path.join(directory, name)).Load():
            for v in event.summary.value:
                val = (v.simple_value if v.HasField("simple_value")
                       else float(tensor_util.make_ndarray(v.tensor)))
                out[(v.tag, event.step)] = val
    return out


def test_metrics_logger_writes_jax_lines_and_tags(tmp_path):
    recs = [{"round": r, "train_loss": 2.0 - r / 4, "completed": 4,
             "round_time_s": 0.5 + r, "eval_acc": 0.25 * r,
             "dropped": [], "phase_update_s": 0.1} for r in range(3)]
    sums = {}
    for side, mod in (("port", metrics), ("jax", jax_metrics)):
        with mod.MetricsLogger(path=str(tmp_path / side / "log.jsonl"),
                               name="run",
                               tensorboard_dir=str(tmp_path / side / "tb")
                               ) as logger:
            for rec in recs:
                logger.log(rec)
            sums[side] = logger.summary(samples_per_round=64.0, n_chips=2)
    lines = {}
    for side in ("port", "jax"):
        with open(tmp_path / side / "log.jsonl") as f:
            lines[side] = [json.loads(x) for x in f]
        for rec in lines[side]:
            assert isinstance(rec.pop("ts"), float)
    assert lines["port"] == lines["jax"] == [dict(r, name="run")
                                             for r in recs]
    for s in sums.values():
        s.pop("elapsed_s")
    assert sums["port"] == sums["jax"]
    ours, theirs = (_tb_scalars(str(tmp_path / side / "tb"))
                    for side in ("port", "jax"))
    assert sorted(ours) == sorted(theirs) and len(ours) == 3 * 5
    for key in ours:
        assert ours[key] == pytest.approx(theirs[key], rel=1e-6), key


def test_metrics_logger_never_closes_an_external_stream():
    import io

    stream = io.StringIO()
    with metrics.MetricsLogger(stream=stream, name="s") as logger:
        logger.log({"round": 0, "x": 1.0})
    assert not stream.closed
    assert json.loads(stream.getvalue())["x"] == 1.0
    with pytest.raises(ValueError, match="either path or stream"):
        metrics.MetricsLogger(path="p", stream=io.StringIO())
