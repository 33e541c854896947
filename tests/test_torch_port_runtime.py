"""The port's ``telemetry/runtime.py`` against the JAX package's: the
Prometheus text, the ``top`` dashboard and the exporter's bodies are
byte-equal for the same registry contents (JAX's
``tests/test_runtime.py`` cases: labelled children, the aggregator tree,
the async plane and its fleetsim aliases, the learning plane); the
exporter answers 200 and 404 as JAX's; the event log's lines are JAX's
but for their timestamps; and the card's memory sampler returns ``{}``
on the CPU.  No tolerance: every comparison is exact."""

import json
import urllib.error
import urllib.request

import pytest

from colearn_federated_learning_tpu.telemetry import runtime as jax_runtime
from colearn_federated_learning_tpu.telemetry.arrival import (
    ArrivalEstimator as JaxArrival)
from colearn_federated_learning_tpu.telemetry.registry import (
    MetricsRegistry as JaxRegistry)
from colearn_federated_learning_tpu_torch import telemetry
from colearn_federated_learning_tpu_torch.telemetry import runtime
from colearn_federated_learning_tpu_torch.telemetry.arrival import (
    ArrivalEstimator)
from colearn_federated_learning_tpu_torch.telemetry.registry import (
    MetricsRegistry)


def _populated(reg):
    reg.counter("comm.retry_total").inc(3)
    reg.counter("telemetry.recompile_total",
                labels={"fn": "engine.round", "reason": "shape"}).inc()
    reg.gauge("runtime.hbm_bytes_in_use").set(2.5 * 2**30)
    reg.gauge("runtime.hbm_bytes_limit")          # never set: excluded
    reg.histogram("fed.round_time_s").observe(0.25)
    reg.histogram("fed.round_time_s").observe(0.75)


def _labelled(reg):
    reg.histogram("fed.phase_time_s",
                  labels={"phase": "agg_fold"}).observe(0.2)
    reg.histogram("fed.phase_time_s",
                  labels={"phase": "downlink"}).observe(0.4)
    reg.gauge("health.device_score", labels={"device": "2"}).set(11)
    reg.counter("telemetry.compile_total",
                labels={"fn": 'we"ird\\name'}).inc()


def _staleness(reg, arrival):
    for tau in (0, 1, 3):
        reg.histogram("async.staleness",
                      labels={"outcome": "folded"}).observe(tau)
    reg.histogram("async.staleness",
                  labels={"outcome": "discarded"}).observe(9)
    est = arrival()
    est.observe("d0", now=0.0)
    est.observe("d0", now=2.0)
    est.export_gauges(reg, "async.arrival_rate_per_s")


def _learning(reg):
    reg.gauge("learn.update_norm").set(0.75)
    reg.gauge("learn.update_norm_ewma").set(0.5)
    reg.gauge("learn.step_size").set(0.75)
    reg.gauge("learn.cos_prev").set(-0.25)
    reg.histogram("learn.update_norm_dist").observe(0.75)
    reg.counter("learn.trend_total{trend=progress}").inc(2)
    reg.counter("learn.trend_total{trend=warmup}").inc(2)
    reg.gauge("learn.cohort_skew").set(0.125)


SCENARIOS = {
    "populated": lambda reg, arrival: _populated(reg),
    "labelled": lambda reg, arrival: _labelled(reg),
    "staleness": _staleness,
    "learning": lambda reg, arrival: _learning(reg),
    "empty": lambda reg, arrival: None,
}


def _pair(name):
    ours, theirs = MetricsRegistry(), JaxRegistry()
    SCENARIOS[name](ours, ArrivalEstimator)
    SCENARIOS[name](theirs, JaxArrival)
    return ours, theirs


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_prometheus_text_is_jax_s(name):
    ours, theirs = _pair(name)
    text = runtime.prometheus_text(ours.typed_snapshot())
    assert text == jax_runtime.prometheus_text(theirs.typed_snapshot())
    assert text.endswith("\n")


TOP_SNAPSHOTS = {
    "classic": ({"fed.rounds_total": 10, "fed.clients_dropped": 2,
                 "comm.retry_total": 7, "telemetry.compile_total": 3,
                 "telemetry.recompile_total": 1,
                 "fed.round_time_s": {"count": 10, "p50": 0.5, "p90": 0.9,
                                      "max": 1.2},
                 "runtime.hbm_bytes_in_use": 2 * 2**30,
                 "runtime.hbm_bytes_limit": 8 * 2**30},
                {"fed.rounds_total": 6}, 2.0),
    # The port's processes never count compiles: the section is left out.
    "no_compiles": ({"fed.rounds_total": 3, "engine.round_time_s": {
                        "count": 3, "p50": 1.5, "p90": 2.0, "max": 2.5},
                     "runtime.hbm_bytes_in_use": 3 * 2**30,
                     "runtime.hbm_bytes_limit": 80 * 2**30}, None, 0.0),
    "tree": ({"fed.rounds_total": 4,
              "comm.agg_heartbeat_age_s{agg=0}": 0.8,
              "comm.agg_heartbeat_age_s{agg=1}": 12.5,
              "comm.agg_slice_devices{agg=0}": 3,
              "comm.agg_slice_devices{agg=1}": 2,
              "comm.agg_partials_folded_total{agg=0}": 12,
              "comm.agg_failovers_total": 1}, None, 0.0),
    "async": ({"fed.rounds_total": 4, "async.aggregations_total": 12,
               "async.buffer_target": 8, "async.arrival_rate_per_s": 2.5,
               "async.updates_discarded_stale": 3,
               "async.staleness": {"count": 15, "sum": 20.0, "p50": 1.0,
                                   "p90": 4.0, "p99": 6.0},
               "async.contribution_mass{outcome=folded}": 10.5,
               "async.contribution_mass{outcome=discarded}": 0.75,
               "async.pumps{state=wait}": 5, "async.pumps{state=train}": 3},
              {"async.aggregations_total": 8}, 4.0),
    "fleetsim": ({"fleetsim.rounds_total": 2,
                  "fleetsim.async_aggregations_total": 6,
                  "fleetsim.async_buffer_size": 4,
                  "fleetsim.async_arrival_rate_per_min": 1.2,
                  "fleetsim.async_updates_discarded_total": 2,
                  "fleetsim.async_staleness": {"count": 8, "sum": 9.0,
                                               "p50": 1.0, "p90": 2.0,
                                               "p99": 3.0}}, None, 0.0),
    "learning": ({"fed.rounds_total": 5, "learn.update_norm": 0.75,
                  "learn.update_norm_ewma": 0.5, "learn.step_size": 0.75,
                  "learn.cos_prev": -0.25, "learn.cohort_skew": 0.125,
                  "learn.trend_total{trend=warmup}": 2,
                  "learn.trend_total{trend=oscillation}": 3}, None, 0.0),
    "empty": ({}, None, 0.0),
}


@pytest.mark.parametrize("name", sorted(TOP_SNAPSHOTS))
def test_render_top_is_jax_s(name):
    snap, prev, interval = TOP_SNAPSHOTS[name]
    body = runtime.render_top(snap, prev=prev, interval_s=interval)
    assert body == jax_runtime.render_top(snap, prev=prev,
                                          interval_s=interval)
    assert body.startswith("colearn top")
    if name == "no_compiles":
        assert "xla compiles" not in body and "(3.8%)" in body


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers["Content-Type"], r.read()


@pytest.mark.parametrize("name", ["populated", "staleness", "learning"])
def test_exporter_bodies_are_jax_s(name):
    """``/metrics`` and ``/snapshot.json`` answer 200 with JAX's bytes
    and content types for the same registry contents, and each scrape
    counts itself in ``export.scrapes_total`` (seen by the next one)."""
    ours, theirs = _pair(name)
    with runtime.MetricsExporter(port=0, registry=ours) as a, \
            jax_runtime.MetricsExporter(port=0, registry=theirs) as b:
        for path in ("/metrics", "/snapshot.json", "/metrics"):
            got = _get(f"http://127.0.0.1:{a.port}{path}")
            want = _get(f"http://127.0.0.1:{b.port}{path}")
            assert got == want and got[0] == 200
        assert json.loads(_get(f"http://127.0.0.1:{a.port}/snapshot.json")[
            2])["export.scrapes_total"] == 3
    assert a.port is None


def test_exporter_answers_404_off_its_paths_as_jax():
    with runtime.MetricsExporter(port=0, registry=MetricsRegistry()) as a, \
            jax_runtime.MetricsExporter(port=0,
                                        registry=JaxRegistry()) as b:
        codes = []
        for port in (a.port, b.port):
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                       timeout=10)
            codes.append(exc.value.code)
        assert codes == [404, 404]


def test_event_log_lines_are_jax_s(tmp_path):
    """Flushed per line (readable before close), JAX's compact JSON but
    for ``ts``, dropped after close; each emit counts in the package's
    own ``export.events_written_total``."""
    before = telemetry.get_registry().counter(
        "export.events_written_total").value
    docs = []
    for side, mod in (("port", runtime), ("jax", jax_runtime)):
        path = tmp_path / side / "events.jsonl"
        log = mod.EventLog(str(path))
        log.emit("start", role="coordinator")
        log.emit("round", round=1, train_loss=0.5, trend="warmup",
                 ok=True)
        lines = path.read_text().splitlines()
        log.close()
        log.emit("after_close")
        assert path.read_text().splitlines() == lines
        docs.append([json.loads(ln) for ln in lines])
        for ln in lines:
            assert ln == json.dumps(json.loads(ln), separators=(",", ":"))
    for d in docs:
        for doc in d:
            assert isinstance(doc.pop("ts"), float)
    assert docs[0] == docs[1]
    assert [d["event"] for d in docs[0]] == ["start", "round"]
    assert telemetry.get_registry().counter(
        "export.events_written_total").value == before + 2


@pytest.mark.parametrize("device", [None, "cpu"])
def test_memory_sampler_returns_nothing_on_the_cpu(device):
    reg = MetricsRegistry()
    assert runtime.sample_device_memory(registry=reg, device=device) == {}
    assert reg.snapshot() == {}


def test_the_broker_s_imports_pull_in_no_torch():
    """The telemetry package and the command line load without torch: a
    ``broker`` (which touches no tensor) respawned in a chaos soak is
    back on its port in well under a second, not after torch's import
    (9-10 s on the card machine)."""
    import subprocess
    import sys

    code = ("import sys; "
            "import colearn_federated_learning_tpu_torch.telemetry; "
            "import colearn_federated_learning_tpu_torch.cli; "
            "import colearn_federated_learning_tpu_torch.comm.broker; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "False"
