"""The port's fleet simulator (``fleetsim/``) against the JAX package's,
case for case with JAX's ``tests/test_fleetsim.py`` where a case applies.

- Population and traffic: the port's copies give JAX's arrays exactly
  (shards, counts, home and speed classes, step budgets, availability,
  cohorts), deterministic and independent of the chunking.
- Rounds: ``FleetSim.from_learner`` with one chunk equals the port's own
  engine round bit for bit, with several chunks within 1e-5 (JAX's
  bound: chunked folding regroups the f32 sums; of the largest update
  entry where that exceeds 1); against JAX's FleetSim
  on JAX's initial params with JAX's draws replayed (``JaxDraws``), in
  population mode and from a learner, within f32 rtol 1e-4 / atol 2e-5.
- Straggler budgets, the three faults with their records, counters and
  health-ledger attribution; a drop equals an independent per-client
  re-derivation without the dropped devices.
- Byte estimates equal JAX's for every uplink and downlink scheme, LoRA
  factor frames and tp_size 2; the validator's refusals; the metric
  catalog; the ``fleetsim`` command's summary keys (JAX's less
  ``compiles``), and ``--learn-observe``, refused until item 10b was
  ported (``tests/test_torch_port_convergence.py`` holds it to JAX's).
- ``fit_async`` (fixed K, ``auto``, pruning, observe) and the two-tier
  tree: every event-count field equal to JAX's (the schedule is host
  numpy drawn in JAX's order), the losses and weights within f32 bounds.

No counterpart: JAX's ``compile_counts`` cases (``one_compile_per_sweep``,
``cli_fleetsim_reports_compile_counts`` and the compile asserts of the
async cases), since the port compiles nothing.  JAX's
``bench_fleet_writes_schema_valid_jsonl`` has its counterpart in
``tests/test_torch_port_measure.py``, beside the rest of
``scripts/torch_port_bench_fleet.py``'s cases.
"""

import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu import fleetsim as jfs
from colearn_federated_learning_tpu import telemetry as jtel
from colearn_federated_learning_tpu.cli import main as jax_main
from colearn_federated_learning_tpu.faults.plan import (
    FaultPlan as JaxPlan, FaultSpec as JaxSpec)
from colearn_federated_learning_tpu.fed.engine import (
    FederatedLearner as JaxLearner)
from colearn_federated_learning_tpu.utils import config as jc
from colearn_federated_learning_tpu_torch import cli, convert, fleetsim
from colearn_federated_learning_tpu_torch import telemetry
from colearn_federated_learning_tpu_torch.analysis import metric_catalog
from colearn_federated_learning_tpu_torch.faults.plan import (
    FaultPlan, FaultSpec)
from colearn_federated_learning_tpu_torch.fed import FederatedLearner
from colearn_federated_learning_tpu_torch.utils import config as tc
from test_torch_port_round import JaxDraws

RTOL, ATOL = 1e-4, 2e-5
# Event-count fields of an asynchronous record: the schedule's, equal.
EVENT_KEYS = ("aggregation", "model_version", "buffer_size",
              "staleness_mean", "staleness_max", "discarded", "contributors",
              "sim_time_min", "arrival_rate_per_min", "agg_rate_per_min",
              "wasted_updates_total", "pruned", "pruned_total",
              "arrival_rate_ewma_per_min", "mass_folded", "mass_discarded",
              "staleness_p50", "staleness_p90", "staleness_p99",
              "aggregators", "agg_id", "agg_buffer_k",
              "agg_fold_tracking_min")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reset_registries():
    telemetry.get_registry().reset()
    jtel.get_registry().reset()


def tiny_config(mod, **fed_kw):
    fed = dict(strategy="fedavg", rounds=2, local_epochs=1, batch_size=32,
               lr=0.05, momentum=0.9)
    fed.update(fed_kw)
    return mod.ExperimentConfig(
        data=mod.DataConfig(dataset="mnist_tiny", num_clients=10,
                            partition="iid"),
        model=mod.ModelConfig(name="mlp", num_classes=10, hidden_dim=32,
                              depth=2),
        fed=mod.FedConfig(**fed), run=mod.RunConfig(name="test", seed=0))


def fleet_config(mod, run_kw=None, **fed_kw):
    fed = dict(strategy="fedavg", local_steps=2, batch_size=8, lr=0.05,
               momentum=0.0)
    fed.update(fed_kw)
    return mod.ExperimentConfig(
        model=mod.ModelConfig(name="mlp", num_classes=10, hidden_dim=32,
                              depth=1),
        fed=mod.FedConfig(**fed),
        run=mod.RunConfig(name="test", seed=0, **(run_kw or {})))


def _population(mod, num_devices):
    spec = mod.PopulationSpec(num_devices=num_devices, feature_dim=16,
                              shard_capacity=16, min_examples=4)
    traffic = mod.TrafficModel(
        mod.TrafficSpec(base_rate=2000.0, diurnal_amplitude=0.0),
        num_devices)
    return mod.DevicePopulation(spec), traffic


def make_fleet(num_devices=256, cohort=64, chunk=32, config=None, **kw):
    """The port's population-mode fleet on the CPU."""
    pop, tm = _population(fleetsim, num_devices)
    return fleetsim.FleetSim.from_population(
        config or fleet_config(tc), pop, tm, cohort_size=cohort,
        chunk_size=chunk, device="cpu", **kw)


def fleet_pair(num_devices=256, cohort=64, chunk=32, **fed_kw):
    """JAX's population-mode fleet and the port's on JAX's initial params
    with JAX's draws."""
    pop, tm = _population(jfs, num_devices)
    j = jfs.FleetSim.from_population(
        fleet_config(jc, **fed_kw), pop, tm, cohort_size=cohort,
        chunk_size=chunk)
    t = make_fleet(num_devices, cohort, chunk, config=fleet_config(
        tc, **fed_kw), draws=JaxDraws(0))
    t.load_flax_params(jax.device_get(j.server_state.params))
    return j, t


def _params_close(port_params, jax_params, what=""):
    want = convert.flax_to_state_dict(jax.device_get(jax_params))
    for name, t in port_params.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} {name}")


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


# ------------------------------------------------------------ population --
def test_population_is_deterministic_and_chunking_independent():
    spec_kw = dict(num_devices=1000, feature_dim=8, shard_capacity=8,
                   min_examples=2)
    pop = fleetsim.DevicePopulation(fleetsim.PopulationSpec(**spec_kw))
    ids = np.array([3, 500, 999])
    x1, y1, c1 = pop.materialize(ids)
    for i in [999, 3, 500]:
        xi, yi, ci = pop.materialize(np.array([i]))
        j = int(np.where(ids == i)[0][0])
        np.testing.assert_array_equal(x1[j], xi[0])
        np.testing.assert_array_equal(y1[j], yi[0])
        assert c1[j] == ci[0]
    jpop = jfs.DevicePopulation(jfs.PopulationSpec(**spec_kw))
    for got, want in zip((x1, y1, c1), jpop.materialize(ids)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_population_counts_labels_and_padding():
    spec_kw = dict(num_devices=500, feature_dim=8, shard_capacity=8,
                   min_examples=3, label_skew=0.9)
    pop = fleetsim.DevicePopulation(fleetsim.PopulationSpec(**spec_kw))
    jpop = jfs.DevicePopulation(jfs.PopulationSpec(**spec_kw))
    ids = np.arange(500)
    x, y, counts = pop.materialize(ids)
    for got, want in zip((x, y, counts), jpop.materialize(ids)):
        assert np.array_equal(got, want)
    assert np.array_equal(pop.home_classes(ids), jpop.home_classes(ids))
    assert counts.min() >= 3 and counts.max() <= 8
    home = pop.home_classes(ids)
    valid = np.arange(8)[None, :] < counts[:, None]
    assert ((y == home[:, None]) & valid).sum() / valid.sum() > 0.75
    assert np.all(x[~valid] == 0.0)
    assert np.array_equal(pop.example_batch(20), jpop.example_batch(20))


def test_speed_classes_map_to_step_budgets():
    pop = fleetsim.DevicePopulation(fleetsim.PopulationSpec(
        num_devices=10_000))
    jpop = jfs.DevicePopulation(jfs.PopulationSpec(num_devices=10_000))
    ids = np.arange(10_000)
    idx = pop.speed_class_index(ids)
    assert np.array_equal(idx, jpop.speed_class_index(ids))
    fracs = np.bincount(idx, minlength=3) / ids.size
    for k, cls in enumerate(pop.spec.speed_classes):
        assert abs(fracs[k] - cls.fraction) < 0.03
    budgets = pop.step_budgets(ids, num_steps=8)
    assert np.array_equal(budgets, jpop.step_budgets(ids, num_steps=8))
    assert set(np.unique(budgets)) == {2, 4, 8}
    np.testing.assert_array_equal(budgets == 8, idx == 0)


# --------------------------------------------------------------- traffic --
def test_traffic_is_deterministic_and_diurnal():
    kw = dict(base_rate=2.0, diurnal_amplitude=1.0, round_minutes=60.0)
    tm = fleetsim.TrafficModel(fleetsim.TrafficSpec(**kw), 5000)
    jtm = jfs.TrafficModel(jfs.TrafficSpec(**kw), 5000)
    m0 = tm.available_mask(3)
    np.testing.assert_array_equal(m0, tm.available_mask(3))
    np.testing.assert_array_equal(m0, jtm.available_mask(3))
    fracs = [tm.expected_available(r) for r in range(24)]
    assert fracs == [jtm.expected_available(r) for r in range(24)]
    assert max(fracs) > 1.5 * min(fracs)
    assert not np.array_equal(tm.available_mask(3), tm.available_mask(4))


def test_traffic_cohort_sampling_is_a_subset_without_replacement():
    tm = fleetsim.TrafficModel(fleetsim.TrafficSpec(base_rate=20.0), 2000)
    jtm = jfs.TrafficModel(jfs.TrafficSpec(base_rate=20.0), 2000)
    cohort = tm.sample_cohort(0, 64)
    assert cohort.size == 64 and np.unique(cohort).size == 64
    assert tm.available_mask(0)[cohort].all()
    np.testing.assert_array_equal(cohort, tm.sample_cohort(0, 64))
    for r in range(3):
        np.testing.assert_array_equal(tm.sample_cohort(r, 64),
                                      jtm.sample_cohort(r, 64))


# ---------------------------------------------------------- engine parity --
def _engine_rounds(ln, rounds):
    return [ln.run_round() for _ in range(rounds)]


def test_single_chunk_round_matches_engine_exactly():
    cfg = tiny_config(tc, cohort_size=4)
    ln = FederatedLearner(cfg, device="cpu")
    fs = fleetsim.FleetSim.from_learner(
        FederatedLearner(cfg, device="cpu"), chunk_size=8)
    h_e = _engine_rounds(ln, 2)
    h_f = fs.fit(2)
    assert _max_diff(ln.params, fs.server_state.params) == 0.0
    for k in ("train_loss", "completed", "total_weight"):
        assert h_f[-1][k] == h_e[-1][k], k


def test_single_chunk_round_matches_jax_fleetsim():
    """One chunk: the port's from_learner round against JAX's, from JAX's
    initial params with JAX's draws replayed."""
    jl = JaxLearner(tiny_config(jc, cohort_size=4))
    init = jax.device_get(jl.params)
    jsim = jfs.FleetSim.from_learner(jl, chunk_size=8)
    ln = FederatedLearner(tiny_config(tc, cohort_size=4), device="cpu",
                          plan=JaxDraws(0))
    ln.load_flax_params(init)
    fs = fleetsim.FleetSim.from_learner(ln, chunk_size=8)
    h_j, h_f = jsim.fit(2), fs.fit(2)
    for a, b in zip(h_f, h_j):
        assert a["completed"] == b["completed"]
        assert a["total_weight"] == b["total_weight"]
        assert a["train_loss"] == pytest.approx(b["train_loss"], rel=RTOL,
                                                abs=ATOL)
    _params_close(fs.server_state.params, jsim.server_state.params)


def test_multi_chunk_round_matches_engine_allclose():
    cfg = tiny_config(tc)
    ln = FederatedLearner(cfg, device="cpu")          # full 10-client cohort
    fs = fleetsim.FleetSim.from_learner(
        FederatedLearner(cfg, device="cpu"), chunk_size=3)   # 4 chunks
    start = {k: v.clone() for k, v in ln.params.items()}
    h_e = _engine_rounds(ln, 2)
    h_f = fs.fit(2)
    # Chunked folding regroups the f32 sums; the same semantics otherwise.
    # The difference is roundoff of the updates: JAX's 1e-5, of the
    # largest update entry where that exceeds 1 (the bound chip_smoke.py
    # 20b holds config #1 to on the card).
    update = _max_diff(ln.params, start)
    assert _max_diff(ln.params, fs.server_state.params) <= 1e-5 * max(
        1.0, update)
    assert h_f[-1]["total_weight"] == h_e[-1]["total_weight"]
    assert h_f[-1]["completed"] == h_e[-1]["completed"]
    # ... and JAX's 4-chunk round, from its params with its draws.
    jl = JaxLearner(tiny_config(jc))
    ln = FederatedLearner(cfg, device="cpu", plan=JaxDraws(0))
    ln.load_flax_params(jax.device_get(jl.params))
    jsim = jfs.FleetSim.from_learner(jl, chunk_size=3)
    fs = fleetsim.FleetSim.from_learner(ln, chunk_size=3)
    jsim.fit(2)
    fs.fit(2)
    _params_close(fs.server_state.params, jsim.server_state.params)


def test_from_learner_leaves_the_learner_and_refuses_a_mesh():
    ln = FederatedLearner(tiny_config(tc, cohort_size=4), device="cpu")
    before = {k: v.clone() for k, v in ln.params.items()}
    fleetsim.FleetSim.from_learner(ln, chunk_size=8).run_round()
    assert _max_diff(before, ln.params) == 0.0

    class Meshed:
        mesh = object()

    with pytest.raises(NotImplementedError, match="single-device"):
        fleetsim.FleetSim.from_learner(Meshed())


def test_engine_straggler_budgets_replicated():
    kw = dict(straggler_prob=0.5, straggler_min_fraction=0.5, rounds=1)
    cfg = tiny_config(tc, **kw)
    h_e = _engine_rounds(FederatedLearner(cfg, device="cpu"), 1)
    fs = fleetsim.FleetSim.from_learner(FederatedLearner(cfg, device="cpu"),
                                        chunk_size=4)
    h_f = fs.fit(1)
    assert h_f[0]["completed"] == h_e[0]["completed"] < 10
    assert h_f[0]["total_weight"] == h_e[0]["total_weight"]


# ----------------------------------------------------------- fault parity --
def manual_engine_round(ln, exclude=frozenset()):
    """Independent per-client re-derivation of round 0 (no chunking):
    the engine's draws, weighting and server step, minus the excluded
    devices, summed in float64."""
    params = list(ln.params.values())
    wsum, total_w = None, 0.0
    for cid in range(ln.num_clients):
        count = int(ln.counts[cid])
        idx = torch.as_tensor(ln.draws.batch_indices(
            0, cid, count, ln.num_steps, ln.config.fed.batch_size))
        res = ln.local_update(params, ln.x[cid], ln.y[cid], count, idx,
                              ln.num_steps)
        w = float(res.num_examples) * float(
            res.completed and res.num_examples > 0 and cid not in exclude)
        scaled = [w * d.double() for d in res.delta]
        wsum = scaled if wsum is None else [a + b
                                            for a, b in zip(wsum, scaled)]
        total_w += w
    lr = ln.config.fed.server_lr
    return {n: p.double() + lr * d / total_w
            for (n, p), d in zip(ln.params.items(), wsum)}, total_w


def _fault_pair(specs, **kw):
    """The port's and JAX's from_learner fleets on the same start and
    draws, each with the plan of ``specs`` (kwargs of FaultSpec)."""
    jl = JaxLearner(tiny_config(jc))
    ln = FederatedLearner(tiny_config(tc), device="cpu", plan=JaxDraws(0))
    ln.load_flax_params(jax.device_get(jl.params))
    plan = FaultPlan([FaultSpec(**s) for s in specs])
    jplan = JaxPlan([JaxSpec(**s) for s in specs])
    return (fleetsim.FleetSim.from_learner(ln, fault_plan=plan, **kw), plan,
            jfs.FleetSim.from_learner(jl, fault_plan=jplan, **kw), jplan)


RECORD_KEYS = ("completed", "total_weight", "dropped", "straggled",
               "corrupted", "clients_trained", "bytes_up_est",
               "bytes_down_est", "cohort")


def test_fault_plan_drop_matches_engine_excluding_devices():
    dropped = {2, 5, 7}
    specs = [dict(kind="drop_request", device_id=str(d), round=0, op="train")
             for d in dropped]
    ref = FederatedLearner(tiny_config(tc), device="cpu")
    want, want_w = manual_engine_round(ref, exclude=dropped)
    plan = FaultPlan([FaultSpec(**s) for s in specs])
    fs = fleetsim.FleetSim.from_learner(
        FederatedLearner(tiny_config(tc), device="cpu"), chunk_size=4,
        fault_plan=plan)
    before = telemetry.get_registry().counter(
        "fault.injected_total", labels={"kind": "drop_request"}).value
    rec = fs.run_round()
    assert max(float((fs.server_state.params[k].double() - want[k])
                     .abs().max()) for k in want) <= 1e-5
    assert rec["dropped"] == len(dropped)
    assert rec["completed"] == ref.num_clients - len(dropped)
    assert rec["total_weight"] == pytest.approx(want_w)
    assert plan.total_fired() == len(dropped)
    assert telemetry.get_registry().counter(
        "fault.injected_total",
        labels={"kind": "drop_request"}).value == before + len(dropped)
    # JAX's fleet under JAX's plan gives the same record.
    fs, _, jsim, jplan = _fault_pair(specs, chunk_size=4)
    rec, jrec = fs.run_round(), jsim.run_round()
    assert {k: rec[k] for k in RECORD_KEYS} == {k: jrec[k]
                                                for k in RECORD_KEYS}
    _params_close(fs.server_state.params, jsim.server_state.params)
    assert jplan.total_fired() == len(dropped)


def test_fault_corrupt_discards_update_but_spends_uplink():
    specs = [dict(kind="corrupt_payload", device_id="4", round=0,
                  op="train")]
    base = fleetsim.FleetSim.from_learner(
        FederatedLearner(tiny_config(tc), device="cpu"), chunk_size=8)
    rec0 = base.run_round()
    fs, _, jsim, _ = _fault_pair(specs, chunk_size=8)
    rec1, jrec = fs.run_round(), jsim.run_round()
    assert rec1["corrupted"] == 1
    assert rec1["completed"] == rec0["completed"] - 1
    assert rec1["bytes_up_est"] == rec0["bytes_up_est"]
    assert rec1["clients_trained"] == rec0["clients_trained"]
    assert {k: rec1[k] for k in RECORD_KEYS} == {k: jrec[k]
                                                 for k in RECORD_KEYS}


def test_fault_delay_cuts_step_budget_to_incomplete():
    specs = [dict(kind="delay", device_id="1", round=0, op="train",
                  ms=1000.0)]
    base = fleetsim.FleetSim.from_learner(
        FederatedLearner(tiny_config(tc), device="cpu"), chunk_size=8)
    rec0 = base.run_round()
    fs, _, jsim, _ = _fault_pair(specs, chunk_size=8,
                                 round_deadline_ms=1000.0)
    rec1, jrec = fs.run_round(), jsim.run_round()
    assert rec1["straggled"] == 1
    assert rec1["completed"] == rec0["completed"] - 1
    assert rec1["bytes_up_est"] == rec0["bytes_up_est"]
    assert {k: rec1[k] for k in RECORD_KEYS} == {k: jrec[k]
                                                 for k in RECORD_KEYS}
    _params_close(fs.server_state.params, jsim.server_state.params)


def test_faults_are_attributed_in_the_health_ledger(tmp_path):
    specs = [dict(kind="drop_request", device_id="3", round=0, op="train"),
             dict(kind="delay", device_id="5", round=0, op="train", ms=250.0),
             dict(kind="corrupt_payload", device_id="7", round=0,
                  op="train")]
    plan = FaultPlan([FaultSpec(**s) for s in specs])
    cfg = tiny_config(tc)
    cfg = cfg.replace(run=dataclasses.replace(cfg.run,
                                              health_dir=str(tmp_path)))
    fs = fleetsim.FleetSim.from_learner(FederatedLearner(cfg, device="cpu"),
                                        chunk_size=8, fault_plan=plan)
    rec = fs.run_round()
    devices = fs.health.devices()
    assert {"3", "5", "7"} <= set(devices)
    assert any(k.startswith("health_") for k in rec)
    assert list(tmp_path.glob("health_*.jsonl"))


# ------------------------------------------------- population-mode rounds --
def test_population_mode_trains_and_counts_bytes():
    reg = telemetry.get_registry()
    before_rounds = reg.counter("fleetsim.rounds_total").value
    before_clients = reg.counter("fleetsim.clients_trained_total").value
    fs = make_fleet(num_devices=256, cohort=64, chunk=32)
    hist = fs.fit(4)
    assert len(hist) == 4
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    for rec in hist:
        assert rec["cohort"] == 64
        assert rec["bytes_down_est"] == 64 * fs.down_frame_bytes
        assert rec["bytes_up_est"] == 64 * fs.up_frame_bytes
        assert 0.0 < rec["available_fraction"] <= 1.0
    assert reg.counter("fleetsim.rounds_total").value == before_rounds + 4
    assert (reg.counter("fleetsim.clients_trained_total").value
            == before_clients + 4 * 64)


def test_population_mode_matches_jax_and_traces_each_chunk():
    j, t = fleet_pair(num_devices=256, cohort=48, chunk=16)
    t.tracer.enabled = True
    h_j, h_t = j.fit(3), t.fit(3)
    for a, b in zip(h_t, h_j):
        for k in ("completed", "total_weight", "cohort", "clients_trained",
                  "bytes_up_est", "bytes_down_est", "available_fraction"):
            assert a[k] == b[k], k
        assert a["train_loss"] == pytest.approx(b["train_loss"], rel=RTOL,
                                                abs=ATOL)
    _params_close(t.server_state.params, j.server_state.params)
    names = [s.name for s in t.tracer.snapshot()]
    assert names.count("train_chunk") == 3 * 3      # 48 / 16 per round
    assert names.count("fleet_round") == names.count("train_chunks") == 3


def test_chunk_size_does_not_change_population_mode_result():
    a = make_fleet(num_devices=128, cohort=48, chunk=48)
    b = make_fleet(num_devices=128, cohort=48, chunk=7)
    a.fit(2)
    b.fit(2)
    assert _max_diff(a.server_state.params, b.server_state.params) <= 1e-5


ESTIMATES = ("down_full_bytes", "down_frame_bytes", "up_frame_bytes",
             "up_saved_bytes", "gather_avoided_bytes")


@pytest.mark.parametrize("fed_kw,run_kw", [
    (dict(), {}), (dict(compress="int8"), {}), (dict(compress="topk"), {}),
    (dict(compress="topk8"), {}), (dict(compress_down="int8"), {}),
    (dict(compress="int8", compress_down="topk"), {}),
    (dict(lora_rank=4), {}), (dict(lora_rank=2, compress="topk8"), {}),
    (dict(), dict(tp_size=2))],
    ids=["none", "int8", "topk", "topk8", "down-int8", "int8-down-topk",
         "lora4", "lora2-topk8", "tp2"])
def test_byte_estimates_equal_jax(fed_kw, run_kw):
    specs = dict(num_devices=64, feature_dim=16, shard_capacity=16,
                 min_examples=4)
    sims = []
    for mod, cfgmod, kw in ((fleetsim, tc, dict(device="cpu")),
                            (jfs, jc, {})):
        pop = mod.DevicePopulation(mod.PopulationSpec(**specs))
        tm = mod.TrafficModel(mod.TrafficSpec(base_rate=2000.0,
                                              diurnal_amplitude=0.0), 64)
        sims.append(mod.FleetSim.from_population(
            fleet_config(cfgmod, run_kw, **fed_kw), pop, tm, cohort_size=16,
            chunk_size=16, **kw))
    ours, theirs = sims
    assert ({k: getattr(ours, k) for k in ESTIMATES}
            == {k: getattr(theirs, k) for k in ESTIMATES})
    if fed_kw.get("compress", "none") != "none" or fed_kw.get("lora_rank"):
        assert 0 < ours.up_frame_bytes and ours.up_saved_bytes > 0
    if fed_kw.get("compress_down"):
        assert ours.down_frame_bytes < ours.down_full_bytes
    if run_kw:
        assert ours.gather_avoided_bytes > 0
        rec = ours.run_round()
        assert rec["bytes_gather_avoided_est"] == ours.gather_avoided_bytes


def test_compressed_schemes_shrink_byte_estimates():
    pop, tm = _population(fleetsim, 64)
    plain = fleetsim.FleetSim.from_population(
        fleet_config(tc), pop, tm, cohort_size=16, chunk_size=16,
        device="cpu")
    packed = fleetsim.FleetSim.from_population(
        fleet_config(tc, compress="int8", compress_down="topk"), pop, tm,
        cohort_size=16, chunk_size=16, device="cpu")
    assert packed.up_frame_bytes < plain.up_frame_bytes
    assert packed.down_frame_bytes < plain.down_frame_bytes
    assert plain.down_frame_bytes == plain.down_full_bytes


@pytest.mark.parametrize("bad", [
    dict(strategy="scaffold"), dict(aggregator="median"), dict(dp_clip=1.0),
    dict(secure_agg=True)])
def test_fleetsim_rejects_engine_only_configs(bad):
    errors = []
    for mod, cfgmod, kw in ((fleetsim, tc, dict(device="cpu")),
                            (jfs, jc, {})):
        spec = mod.PopulationSpec(num_devices=32, feature_dim=8,
                                  shard_capacity=8, min_examples=2)
        with pytest.raises(NotImplementedError) as exc:
            mod.FleetSim.from_population(
                fleet_config(cfgmod, **bad), mod.DevicePopulation(spec),
                mod.TrafficModel(mod.TrafficSpec(), 32), cohort_size=8,
                chunk_size=8, **kw)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_fleetsim_refuses_learn_observe_naming_item_10b():
    """``learn_observe`` was refused naming item 10b until the observatory
    was ported: the fleet now stamps JAX's ``conv_*`` keys, and only
    them, on each round."""
    plain = make_fleet(num_devices=64, cohort=16, chunk=8).fit(2)
    seen = make_fleet(num_devices=64, cohort=16, chunk=8, config=fleet_config(
        tc, run_kw=dict(learn_observe=True))).fit(2)
    for a, b in zip(seen, plain):
        assert {k for k in a if k.startswith("conv_")} >= {
            "conv_update_norm", "conv_norm_p90", "conv_cohort_skew"}
        assert {k: v for k, v in a.items()
                if not k.startswith("conv_") and k != "round_time_s"} == {
            k: v for k, v in b.items() if k != "round_time_s"}


def test_fleetsim_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pop, tm = _population(fleetsim, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleetsim.FleetSim.from_population(fleet_config(tc), pop, tm,
                                          cohort_size=8)


def test_all_fleetsim_metrics_are_cataloged():
    make_fleet(num_devices=64, cohort=16, chunk=8,
               config=fleet_config(tc, compress="int8")).fit(1)
    make_fleet(num_devices=32, cohort=8, chunk=8).fit_async(
        3, buffer_size="auto", prune_after=1)
    make_fleet(num_devices=32, cohort=8, chunk=8).fit_async(
        3, buffer_size=4, aggregators=2)
    names = {k.split("{")[0] for k in telemetry.get_registry().snapshot()}
    fleet = {n for n in names if n.startswith("fleetsim.")}
    assert {"fleetsim.rounds_total", "fleetsim.clients_trained_total",
            "fleetsim.bytes_up_est_total", "fleetsim.bytes_down_est_total",
            "fleetsim.devices", "fleetsim.chunk_size",
            "fleetsim.available_fraction", "fleetsim.round_time_s",
            "fleetsim.async_aggregations_total",
            "fleetsim.async_buffer_size"} <= fleet
    for name in fleet:
        assert metric_catalog.is_known(name), name


# ----------------------------------------------------------------- CLI --
CLI_ARGS = ["fleetsim", "--devices", "128", "--cohort", "32", "--rounds",
            "2", "--chunk", "16", "--feature-dim", "8", "--capacity", "8",
            "--hidden-dim", "16", "--depth", "1", "--local-steps", "2",
            "--batch-size", "4"]


def _summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("extra", [
    [], ["--async-buffer", "8", "--rounds", "3"],
    ["--async-buffer", "auto", "--async-prune-after", "2"],
    ["--async-buffer", "4", "--aggregators", "2", "--rounds", "3"]],
    ids=["sync", "async", "async-auto-prune", "tree"])
def test_cli_fleetsim_summary_has_jax_s_keys(extra, capsys):
    """The summary's keys are JAX's less ``compiles`` (the compile census
    has no object here); the synchronous counts and the asynchronous
    schedule's fields are JAX's.  The command draws its model and batches
    from the port's own generators, so the loss is only finite here (the
    rounds are held to JAX's on JAX's draws above)."""
    _reset_registries()
    assert jax_main(CLI_ARGS + extra) == 0
    theirs = _summary(capsys)
    _reset_registries()
    ours = cli.main(CLI_ARGS + extra + ["--backend", "cpu"])
    assert ours == _summary(capsys)
    assert set(ours) == set(theirs) - {"compiles"}
    for k, v in ours.items():
        if k == "train_loss":
            assert math.isfinite(v)
        elif not k.endswith("_per_sec"):
            assert v == theirs[k], k
    if not extra:
        assert ours["rounds"] == 2 and ours["clients_trained"] == 64
        assert ours["clients_per_sec"] > 0 and ours["bytes_up_per_round"] > 0


def test_cli_fleetsim_writes_a_trace_and_counts_faults(tmp_path, capsys):
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"faults": [
        {"kind": "drop_request", "probability": 0.1, "op": "train", "count": 0},
        {"kind": "delay", "probability": 0.1, "op": "train", "ms": 600.0,
         "count": 0},
        {"kind": "corrupt_payload", "probability": 0.1, "op": "train",
         "count": 0}]}))
    args = CLI_ARGS + ["--fault-plan", str(plan), "--trace-dir",
                       str(tmp_path)]
    _reset_registries()
    assert jax_main(args) == 0
    theirs = _summary(capsys)
    _reset_registries()
    ours = cli.main(args + ["--backend", "cpu"])
    for k in ("dropped", "straggled", "corrupted", "clients_trained"):
        assert ours[k] == theirs[k], k
    assert ours["dropped"] + ours["straggled"] + ours["corrupted"] > 0
    reg = telemetry.get_registry()
    assert ours["dropped"] == reg.counter(
        "fault.injected_total", labels={"kind": "drop_request"}).value
    doc = telemetry.load_trace(str(tmp_path / "fleetsim_trace.json"))
    chunks = [s for s in telemetry.trace_spans(doc)
              if s.name == "train_chunk"]
    assert len(chunks) == 2 * 2                       # 32 / 16 per round


def test_cli_fleetsim_refuses_learn_observe_naming_item_10b(capsys):
    """``fleetsim --learn-observe``, refused naming item 10b until the
    observatory was ported, runs: every record carries the ``conv_*``
    keys, the second the cosine to the first."""
    cli.main([*CLI_ARGS, "--learn-observe", "--backend", "cpu"])
    recs = [json.loads(ln) for ln in capsys.readouterr().err.splitlines()
            if ln.startswith('{"train_loss"')]
    assert len(recs) == 2
    assert all("conv_update_norm" in r for r in recs)
    assert "conv_cos_prev" in recs[1] and "conv_cos_prev" not in recs[0]


# --------------------------------------------------------- buffered async --
def _async_pair(num_devices=32, cohort=8, chunk=8, **kw):
    _reset_registries()
    j, t = fleet_pair(num_devices, cohort, chunk)
    h_j = j.fit_async(**kw)
    _reset_registries()
    h_t = t.fit_async(**kw)
    assert len(h_t) == len(h_j)
    for a, b in zip(h_t, h_j):
        assert set(a) == set(b), set(a) ^ set(b)
        for k in EVENT_KEYS:
            if k in b:
                assert a[k] == b[k], (a["aggregation"], k, a[k], b[k])
        for k in ("train_loss", "total_weight"):
            assert a[k] == pytest.approx(b[k], rel=RTOL, abs=ATOL), k
    _params_close(t.server_state.params, j.server_state.params)
    return h_t, t


def test_fit_async_converges_and_matches_jax():
    reg = telemetry.get_registry()
    hist, _ = _async_pair(aggregations=10, buffer_size=8, max_staleness=8)
    assert [r["model_version"] for r in hist] == list(range(1, 11))
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    for rec in hist:
        assert rec["contributors"] == 8 == rec["buffer_size"]
        assert 0 <= rec["staleness_mean"] <= rec["staleness_max"] <= 8
        assert rec["sim_time_min"] > 0
        assert "pruned" not in rec and "pruned_total" not in rec
    assert reg.counter("fleetsim.async_aggregations_total").value == 10


def test_fit_async_staleness_discard_and_pruning_cut_waste():
    runs = {}
    for label, prune_after in (("unpruned", 0), ("pruned", 1)):
        runs[label], _ = _async_pair(
            aggregations=30, buffer_size=8, max_staleness=6,
            prune_after=prune_after, probation=30, straggler_fraction=0.25,
            straggler_multiplier=4.0)
    wasted_un = runs["unpruned"][-1]["wasted_updates_total"]
    wasted_pr = runs["pruned"][-1]["wasted_updates_total"]
    assert wasted_un > 0
    assert wasted_pr < wasted_un
    assert runs["pruned"][-1]["pruned_total"] >= 1
    assert all("pruned" in r and "pruned_total" in r for r in runs["pruned"])
    for hist in runs.values():
        assert math.isfinite(hist[-1]["train_loss"])


def test_fit_async_validates_inputs():
    fs = make_fleet(num_devices=16, cohort=8, chunk=8)
    with pytest.raises(ValueError, match="buffer"):
        fs.fit_async(2, buffer_size=0)
    with pytest.raises(ValueError, match="buffer"):
        fs.fit_async(2, buffer_size=17)   # > num_devices
    from_learner = fleetsim.FleetSim.from_learner(
        FederatedLearner(tiny_config(tc), device="cpu"), chunk_size=4)
    with pytest.raises(NotImplementedError, match="traffic"):
        from_learner.fit_async(2, buffer_size=2)
    narrow = make_fleet(num_devices=32, cohort=8, chunk=4)
    with pytest.raises(ValueError, match="buffer"):
        narrow.fit_async(2, buffer_size=8)
    with pytest.raises(ValueError, match="auto"):
        fs.fit_async(2, buffer_size="adaptive")
    with pytest.raises(ValueError, match=">= 2 aggregators"):
        fs.fit_async(2, buffer_size=4, aggregators=1)
    with pytest.raises(ValueError, match="slice would be empty"):
        fs.fit_async(2, buffer_size=4, aggregators=17)


def test_fit_async_observe_stamps_observatory_keys():
    hist, _ = _async_pair(aggregations=6, buffer_size=8, max_staleness=8,
                          observe=True)
    for rec in hist:
        assert rec["mass_folded"] > 0.0
        assert rec["mass_discarded"] >= 0.0
        assert rec["arrival_rate_ewma_per_min"] >= 0.0
        assert (rec["staleness_p50"] <= rec["staleness_p90"]
                <= rec["staleness_p99"])


def test_fit_async_auto_buffer_sizes_from_arrival_rate():
    hist, _ = _async_pair(aggregations=10, buffer_size="auto",
                          max_staleness=8, auto_interval_min=2.0)
    for rec in hist:
        assert 1 <= rec["buffer_size"] <= 8
        assert "arrival_rate_ewma_per_min" in rec
    assert len({rec["buffer_size"] for rec in hist}) > 1
    assert telemetry.get_registry().gauge(
        "fleetsim.async_buffer_size").value == hist[-1]["buffer_size"]


@pytest.mark.parametrize("kw", [
    dict(buffer_size=8), dict(buffer_size="auto", auto_interval_min=2.0),
    dict(buffer_size=4, max_staleness=3, prune_after=1, probation=6,
         straggler_fraction=0.25, straggler_multiplier=4.0)],
    ids=["warm-8", "auto", "prune"])
def test_fit_async_tree_matches_jax(kw):
    hist, _ = _async_pair(num_devices=48, aggregations=12, aggregators=2,
                          **kw)
    assert [r["model_version"] for r in hist] == list(range(1, 13))
    for rec in hist:
        assert rec["aggregators"] == 2 and rec["agg_id"] in (0, 1)
        assert 0.0 <= rec["agg_fold_tracking_min"] <= 1.0
        assert "staleness_p90" in rec
    assert telemetry.get_registry().counter(
        "fleetsim.async_partials_folded_total").value == 12
