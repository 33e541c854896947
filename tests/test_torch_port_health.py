"""The port's health ledger (``telemetry/health.py``) and health-ranked
slices against the JAX package's, on the CPU at small sizes.

- Ledgers written by either package (two writers, a compaction, a torn
  final line) merge in the other's ``load_health`` into equal
  ``DeviceHealth`` dicts; ``render_health``, ``health_record_keys``,
  ``export_gauges`` and ``feed_transport_retries`` give JAX's results.
- ``assign_slices`` equals JAX's on the same scores and is
  ``slice_cohort`` with none or with equal ones; on the coordinator's
  ``DeviceInfo`` cohorts it ranks by the device id (a departure: JAX's
  keys such a cohort by its repr, so its ranking never engages there).
- A ``health_dir`` federation fills the ledger from the workers' own
  ``worker.train`` spans: a port root over JAX workers and a JAX root over
  port workers, flat and through the tree (port aggregators under a JAX
  root too); the records gain JAX's ``health_*`` keys and only then.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.comm import aggregator as jax_agg
from colearn_federated_learning_tpu.telemetry import health as jax_health
from colearn_federated_learning_tpu.telemetry import registry as jax_registry
from colearn_federated_learning_tpu_torch.comm import aggregator
from colearn_federated_learning_tpu_torch.comm.enrollment import DeviceInfo
from colearn_federated_learning_tpu_torch.telemetry import health, registry
from test_torch_port_socket import Federation, configs
from test_torch_port_tree import tree_configs, tree_run


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _fresh_registries():
    """A coordinator charges the transport's per-device retry counters to
    its ledger: retries that tests run before in this process (the fault
    plane's) must not count, so each test starts from empty registries."""
    registry.get_registry().reset()
    jax_registry.get_registry().reset()


def _write(mod, directory):
    """Two writers' ledgers: the coordinator's compacts (max_lines 6) and
    gets a torn final line; an aggregator's records its slice."""
    rng = np.random.default_rng(11)
    coord = mod.HealthLedger(directory, "coordinator", max_lines=6)
    agg = mod.HealthLedger(directory, "aggregator1")
    for r in range(5):
        for d in range(4):
            coord.record(str(d), round=r,
                         latency_s=float(rng.uniform(0.1, 2.0)),
                         deadline_miss=int(d == 3 and r % 2 == 0),
                         retry=int(d == 1))
            if d >= 2:
                agg.record(str(d), round=r, agg="1",
                           latency_s=float(rng.uniform(0.1, 1.0)),
                           eviction=int(r == 4 and d == 3))
        coord.flush()
        agg.flush()
    coord.record("0", round=5, secure_dropout=1)
    coord.flush()
    coord.close()
    agg.close()
    with open(os.path.join(directory, "health_coordinator.jsonl"), "a") as f:
        f.write('{"d": "2", "round": 6, "lat')     # a torn final line


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ledgers_merge_alike_in_both_packages(writer, tmp_path):
    _write(health if writer == "port" else jax_health, str(tmp_path))
    assert len(open(tmp_path / "health_coordinator.jsonl").readlines()) < 8
    ours = health.load_health(str(tmp_path))
    theirs = jax_health.load_health(str(tmp_path))
    assert sorted(ours) == sorted(theirs) == ["0", "1", "2", "3"]
    assert {d: h.to_dict() for d, h in ours.items()} == {
        d: h.to_dict() for d, h in theirs.items()}
    assert {d: h.score() for d, h in ours.items()} == {
        d: h.score() for d, h in theirs.items()}
    for top in (10, 2):
        assert (health.render_health(ours, top=top)
                == jax_health.render_health(theirs, top=top))
    assert health.render_health({}) == jax_health.render_health({})
    assert (health.health_record_keys(ours)
            == jax_health.health_record_keys(theirs))
    reg, jreg = registry.MetricsRegistry(), jax_registry.MetricsRegistry()
    health.export_gauges(ours, registry=reg, top=3)
    jax_health.export_gauges(theirs, registry=jreg, top=3)
    assert reg.snapshot() == jreg.snapshot()


def test_a_torn_line_mid_file_raises_in_both(tmp_path):
    path = tmp_path / "health_x.jsonl"
    path.write_text('{"d": "1", "round": 0}\n{"d": \n{"d": "1"}\n')
    for mod in (health, jax_health):
        with pytest.raises(ValueError, match="corrupt health ledger"):
            mod.load_health(str(tmp_path))


def test_transport_retries_feed_the_ledger_as_jax(tmp_path):
    out = []
    for mod, reg_mod in ((health, registry), (jax_health, jax_registry)):
        reg = reg_mod.MetricsRegistry()
        ledger = mod.HealthLedger(str(tmp_path / mod.__name__), "c")
        seen: dict = {}
        for n in (2, 0, 3):
            reg.counter("comm.retry_total", labels={"device": "4"}).inc(n)
            reg.counter("comm.retry_total",
                        labels={"device": "agg:0"}).inc(1)
            mod.feed_transport_retries(ledger, seen, registry=reg)
        out.append({d: h.to_dict() for d, h in ledger.devices().items()})
        ledger.close()
    assert out[0] == out[1] == {"4": {"device_id": "4", "rounds": 0,
                                      "retry": 5}}


@pytest.mark.parametrize("scores", [
    None, {}, {str(i): 1.0 for i in range(6)},
    {"0": 9.0, "2": 3.0, "4": 0.5}, {"1": 2.0, "3": 2.0, "5": 7.0}])
@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_assign_slices_equals_jax(scores, n):
    for cohort in ([(i, "h", 9000 + i) for i in range(6)],
                   [str(i) for i in range(6)]):
        ours = aggregator.assign_slices(cohort, n, scores=scores)
        assert ours == jax_agg.assign_slices(cohort, n, scores=scores)
        if not scores or len(set(scores.values())) == 1:
            assert ours == aggregator.slice_cohort(cohort, n)


def test_assign_slices_ranks_device_infos_by_their_id():
    """The coordinator's cohort entries are ``DeviceInfo``s: the port keys
    them by ``device_id``, so the slowest-scored device lands in the last
    slice (JAX's ``_device_key`` stringifies the whole record, and no
    score ever matches)."""
    infos = [DeviceInfo(str(i), "h", 9000 + i) for i in range(4)]
    scores = {"0": 5.0, "3": 1.0}
    ranked = aggregator.assign_slices(infos, 2, scores=scores)
    assert [[d.device_id for d in sl] for sl in ranked] == [["1", "2"],
                                                            ["3", "0"]]
    tuples = [(int(d.device_id), d.host, d.port) for d in infos]
    assert [[str(t[0]) for t in sl] for sl in jax_agg.assign_slices(
        tuples, 2, scores=scores)] == [["1", "2"], ["3", "0"]]
    assert jax_agg.assign_slices(infos, 2, scores=scores) == (
        jax_agg.slice_cohort(infos, 2))


def _with_health(cfgs, directory):
    return [c.replace(run=dataclasses.replace(c.run, health_dir=directory))
            for c in cfgs]


@pytest.mark.parametrize("coord_side,workers", [("port", "jax"),
                                                ("jax", "port"),
                                                ("port", "port")])
def test_federation_fills_the_ledger_from_worker_spans(coord_side, workers,
                                                       tmp_path):
    """Flat: the root records each trainer's latency from its own
    ``worker.train`` span, whichever package the workers are; the records
    carry the ``health_*`` keys, and a run without a ledger does not."""
    directory = str(tmp_path / "h")
    cfgs = _with_health(configs(num_clients=3), directory)
    with Federation(cfgs, 3, coord=coord_side, workers=workers,
                    want_evaluator=False) as f:
        recs = [f.coord.run_round() for _ in range(2)]
    fleet = health.load_health(directory)
    assert sorted(fleet) == ["0", "1", "2"]
    for dev in fleet.values():
        assert dev.rounds == 2 and len(dev.lat_samples) == 2
        assert dev.lat_ewma > 0
    assert {d: h.to_dict() for d, h in fleet.items()} == {
        d: h.to_dict() for d, h in jax_health.load_health(directory).items()}
    for rec in recs:
        assert rec["health_devices"] == 3 and rec["health_lat_p99_s"] > 0
        assert "health_worst_device" not in rec
    with Federation(configs(num_clients=3), 3, coord=coord_side,
                    workers=workers, want_evaluator=False) as f:
        plain = f.coord.run_round()
    assert sorted(set(recs[0]) - set(plain)) == ["health_devices",
                                                 "health_lat_p99_s"]


@pytest.mark.parametrize("coord_side,aggs", [("port", "port"),
                                             ("jax", "port")])
def test_tree_aggregators_keep_their_slices_ledgers(coord_side, aggs,
                                                    tmp_path):
    """Under the tree each aggregator records its slice's devices (with
    its id) in a ledger of its own, the root merges the directory for its
    records, and ``health`` renders the per-aggregator skew."""
    directory = str(tmp_path / "h")
    cfgs = tree_configs(run_kw=dict(health_dir=directory))
    recs, _ = tree_run(cfgs, 3, rounds=2, coord=coord_side, aggs=aggs,
                       workers="port")
    # The root records nothing here (no miss, dropout, eviction or
    # retry), so it never opens its file.
    names = sorted(os.listdir(directory))
    assert names == ["health_aggregator0.jsonl", "health_aggregator1.jsonl"]
    fleet = health.load_health(directory)
    assert sorted(fleet) == ["0", "1", "2"]
    assert {h.agg for h in fleet.values()} == {"0", "1"}
    assert all(h.rounds == 2 for h in fleet.values())
    assert all(r["health_devices"] == 3 for r in recs)
    text = health.render_health(fleet)
    assert "per-aggregator slice skew" in text
    assert text == jax_health.render_health(jax_health.load_health(
        directory))
