"""The port's convergence observatory (``telemetry/convergence.py``) and
its wiring, against the JAX package's.

- The observatory's signals equal JAX's on the same update sequences
  (warm-up, progress, plateau, oscillation, divergence, non-finite, zero,
  no-op rounds and LoRA factor trees), with torch, numpy and sharded
  leaves: norms and steps to rtol 1e-5 and, since JAX rounds them to 8
  places, atol 1e-8; cosines to rtol 1e-5 and atol 1e-6 (their rounding);
  trends and key sets exactly.  The ``learn.*`` metrics it exports too.
- ``device_skew``, ``cohort_skew`` and ``render_convergence_report``
  equal JAX's (the skews to their 6-place rounding); ``converge``'s exit
  codes are JAX's.
- The synchronous coordinator, the asynchronous one, the tree and a
  tp = 2 sharded server stamp JAX's ``conv_*`` key sets, with the norms
  of their own mean updates (read on the host in f64, rtol 1e-5), and
  equal JAX's federations' to the records' rtol 1e-4.
- FleetSim's observed round equals JAX FleetSim's on replayed draws to
  the chunk parity's f32 bounds, and its non-IID drift separation (JAX's
  ``tests/test_convergence.py``) holds on both sides.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu import fleetsim as jfs
from colearn_federated_learning_tpu.cli import main as jax_main
from colearn_federated_learning_tpu.telemetry import convergence as jconv
from colearn_federated_learning_tpu.telemetry.registry import (
    MetricsRegistry as JaxRegistry)
from colearn_federated_learning_tpu.utils import config as jc
from colearn_federated_learning_tpu_torch import cli, fleetsim, telemetry
from colearn_federated_learning_tpu_torch.analysis import metric_catalog
from colearn_federated_learning_tpu_torch.parallel import partition
from colearn_federated_learning_tpu_torch.telemetry import convergence as conv
from colearn_federated_learning_tpu_torch.telemetry.registry import (
    MetricsRegistry)
from colearn_federated_learning_tpu_torch.utils import config as tc
from test_torch_port_async import run as async_run
from test_torch_port_fleetsim import _population, fleet_config
from test_torch_port_round import JaxDraws
from test_torch_port_socket import configs
from test_torch_port_tree import tree_run

NORM_KEYS = ("conv_update_norm", "conv_step_size", "conv_norm_ewma",
             "conv_norm_median", "conv_norm_p90")
COS_KEYS = ("conv_cos_prev", "conv_cohort_skew", "conv_cohort_cos_min")
CONV_KEYS = {"conv_update_norm", "conv_step_size", "conv_norm_ewma",
             "conv_trend"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def assert_signals_close(ours, theirs, rtol=1e-5, norm_atol=1e-8,
                         cos_atol=1e-6):
    """The same keys and trend; norms and cosines close (see the module
    docstring for the tolerances)."""
    if theirs is None:
        assert ours is None
        return
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        if isinstance(v, str):
            assert ours[k] == v, k
        elif not math.isfinite(v):
            assert not math.isfinite(ours[k]) and (
                math.isnan(v) == math.isnan(ours[k])), k
        else:
            atol = cos_atol if k in COS_KEYS else norm_atol
            np.testing.assert_allclose(ours[k], v, rtol=rtol, atol=atol,
                                       err_msg=k)


# ------------------------------------------------- the observatory itself --
SHAPES = {"Dense_0": {"kernel": (6, 5), "bias": (5,)},
          "Conv_0": {"kernel": (3, 3, 2, 4)}}


def _tree(rng, scale=1.0, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(rng, scale, v) for k, v in shapes.items()}
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def _lora(rng, scale=1.0):
    return {"Dense_0/kernel": {
                "lora_a": (scale * rng.standard_normal((4, 6))).astype(
                    np.float32),
                "lora_b": (scale * rng.standard_normal((5, 4))).astype(
                    np.float32)},
            "Conv_0/kernel": {
                "lora_a": (scale * rng.standard_normal((2, 18))).astype(
                    np.float32),
                "lora_b": np.zeros((4, 2), np.float32)}}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _sequence(kind):
    rng = np.random.default_rng({"progress": 1, "plateau": 2,
                                 "oscillation": 3, "divergence": 4,
                                 "nonfinite": 5, "zero": 6, "noop": 7,
                                 "lora": 8}[kind])
    base = _tree(rng)
    if kind == "progress":
        return [_map(lambda x, s=s: x * s + 0.05 * s, base)
                for s in (1.0, 0.7, 0.5, 0.3, 0.2, 0.12)]
    if kind == "plateau":
        return [_map(lambda x: x + 0.02 * rng.standard_normal(x.shape)
                     .astype(np.float32), base) for _ in range(6)]
    if kind == "oscillation":
        return [_map(lambda x, s=s: s * x, base)
                for s in (1.0, -1.0, 1.0, -1.0, 1.0, -1.0)]
    if kind == "divergence":
        return [_map(lambda x, s=s: s * x, base)
                for s in (1.0, 1.1, 1.2, 4.0, 20.0, 100.0)]
    if kind == "nonfinite":
        bad = _map(lambda x: x.copy(), base)
        bad["Dense_0"]["bias"][2] = np.inf
        nan = _map(lambda x: x.copy(), base)
        nan["Conv_0"]["kernel"][0, 0, 0, 0] = np.nan
        return [base, bad, base, nan, _map(lambda x: 0.5 * x, base), base]
    if kind == "zero":
        zero = _map(np.zeros_like, base)
        return [zero, base, zero, zero, base, _map(lambda x: -x, base)]
    if kind == "noop":
        return [base, None, _map(lambda x: 0.9 * x, base), None, base]
    return [_lora(rng, s) for s in (1.0, 0.8, 0.8, 0.6, 3.0)]


def _sharded(x):
    """A numpy leaf as a 2-way ``ShardedTensor`` over its first axis (a
    replicated one-part leaf when that axis has one row)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    n = x.shape[0]
    if n < 2:
        return partition.ShardedTensor(x.shape, [t],
                                       [tuple(slice(0, d) for d in x.shape)],
                                       2)
    h = n // 2
    rest = tuple(slice(0, d) for d in x.shape[1:])
    return partition.ShardedTensor(
        x.shape, [t[:h].clone(), t[h:].clone()],
        [(slice(0, h),) + rest, (slice(h, n),) + rest], 2)


LEAVES = {"torch": lambda x: torch.from_numpy(x.copy()),
          "numpy": lambda x: x.copy(),
          "sharded": _sharded}

KINDS = ["progress", "plateau", "oscillation", "divergence", "nonfinite",
         "zero", "noop", "lora"]


@pytest.mark.parametrize("leaf", sorted(LEAVES))
@pytest.mark.parametrize("kind", KINDS)
def test_observatory_signals_equal_jax_s(kind, leaf):
    ours, theirs = conv.ConvergenceObservatory(), \
        jconv.ConvergenceObservatory()
    reg, jreg = MetricsRegistry(), JaxRegistry()
    trends = []
    for i, delta in enumerate(_sequence(kind)):
        lr = 0.5 if i % 2 else 1.0
        a = ours.observe(None if delta is None else _map(LEAVES[leaf], delta),
                         lr=lr)
        b = theirs.observe(None if delta is None else _map(jnp.asarray,
                                                           delta), lr=lr)
        assert_signals_close(a, b)
        if b:
            ours.export_metrics(reg, a)
            theirs.export_metrics(jreg, b)
            trends.append(b["conv_trend"])
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    assert sorted(snap) == sorted(jsnap)
    for k in snap:
        assert metric_catalog.is_known(k.split("{")[0]), k
        if isinstance(jsnap[k], dict):
            assert snap[k]["count"] == jsnap[k]["count"]
        elif jsnap[k] is not None:
            np.testing.assert_allclose(snap[k], jsnap[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    want = {"progress": "progress", "plateau": "plateau",
            "oscillation": "oscillation", "divergence": "divergence",
            "nonfinite": "divergence"}.get(kind)
    if want is not None:
        assert want in trends


def test_observatory_keeps_a_copy_of_the_previous_update():
    """The port's folders reuse their buffers: the cosine compares with
    the update as it was observed, not as its buffer was overwritten."""
    obs = conv.ConvergenceObservatory()
    buf = {"w": torch.tensor([1.0, 0.0])}
    obs.observe(buf)
    assert obs._prev_update["w"] is not buf["w"]
    buf["w"].copy_(torch.tensor([0.0, 1.0]))
    assert obs.observe(buf)["conv_cos_prev"] == 0.0
    assert conv.ConvergenceObservatory(keep_prev=False).observe(
        buf) is not None


def test_device_skew_equals_jax_s():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 7, 64):
        norms = rng.gamma(2.0, 1.0, n).astype(np.float32)
        if n > 4:
            norms[3] *= 20.0
        assert conv.device_skew(norms) == jconv.device_skew(norms)


@pytest.mark.parametrize("weights", [[2.0, 4.0, 1.0], [2.0, 0.0, 0.0],
                                     [0.0, 0.0, 0.0], [1.0, 5.0, 3.0]])
def test_cohort_skew_equals_jax_s(weights):
    rng = np.random.default_rng(len(weights) + int(sum(weights)))
    sums = _map(lambda s: rng.standard_normal((3,) + s).astype(np.float32),
                {"a": (4, 3), "b": {"c": (5,)}})
    sums["a"][1] *= -3.0
    agg = _tree(rng, shapes={"a": (4, 3), "b": {"c": (5,)}})
    ours = conv.cohort_skew(_map(torch.from_numpy, sums), weights,
                            _map(torch.from_numpy, agg))
    theirs = jconv.cohort_skew(_map(jnp.asarray, sums), weights,
                               _map(jnp.asarray, agg))
    assert_signals_close(ours, theirs)


REPORTS = {
    "empty": [],
    "unordered": [
        {"round": 1, "conv_update_norm": 0.5, "conv_step_size": 0.5,
         "conv_norm_ewma": 0.75, "conv_trend": "progress",
         "conv_cos_prev": 0.9, "conv_cohort_skew": 0.3},
        {"round": 0, "conv_update_norm": 1.0, "conv_step_size": 1.0,
         "conv_norm_ewma": 1.0, "conv_trend": "warmup"},
        {"round": 2, "conv_update_norm": 3.0, "conv_step_size": 3.0,
         "conv_norm_ewma": 1.4, "conv_trend": "divergence",
         "conv_cos_prev": 0.1},
        {"round": 3, "unrelated": True}],
    "aggregations": [
        {"aggregation": a, "conv_update_norm": 1.0 / (a + 1),
         "conv_step_size": 1.0 / (a + 1), "conv_norm_ewma": 0.8,
         "conv_trend": t, "conv_cos_prev": -0.4}
        for a, t in enumerate(["warmup", "warmup", "oscillation",
                               "plateau"])],
}


@pytest.mark.parametrize("name", sorted(REPORTS))
def test_convergence_report_is_jax_s(name):
    recs = REPORTS[name]
    assert conv.render_convergence_report(recs) == \
        jconv.render_convergence_report(recs)


def _write(path, rows):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\nnot json\n")


def _converge(main, argv, capsys):
    try:
        code = main(argv)
    except SystemExit as e:
        code = e.code
    out = capsys.readouterr()
    return (0 if code is None else code), out.out


def test_cli_converge_exit_codes_are_jax_s(tmp_path, capsys):
    rows = [{"event": "round", "round": r, "conv_update_norm": 1.0 / (r + 1),
             "conv_step_size": 1.0 / (r + 1), "conv_norm_ewma": 1.0,
             "conv_trend": "progress"} for r in range(3)]
    _write(tmp_path / "results" / "a" / "events.jsonl", rows)
    _write(tmp_path / "none" / "x.jsonl", [{"round": 0}])
    (tmp_path / "nothing").mkdir()
    cases = [(str(tmp_path / "results"), 0),
             (str(tmp_path / "results" / "a" / "events.jsonl"), 0),
             (str(tmp_path / "none"), 1), (str(tmp_path / "nothing"), 2),
             (str(tmp_path / "missing.jsonl"), 2)]
    for target, code in cases:
        ours = _converge(cli.main, ["converge", target], capsys)
        theirs = _converge(jax_main, ["converge", target], capsys)
        assert ours == theirs and ours[0] == code, target
    assert "trends: progress=3" in _converge(
        cli.main, ["converge", str(tmp_path)], capsys)[1]


# --------------------------------------------------------- coordinators --
class _Seen:
    """Every mean update the port's observatories observe, as its f64 host
    norm (a sharded leaf read shard by shard)."""

    def __init__(self, monkeypatch):
        self.norms = []
        orig = conv.ConvergenceObservatory.observe

        def observe(obs, mean_delta, *, lr=1.0):
            if mean_delta is not None:
                leaves = [np.asarray(partition.host_leaf(x), np.float64)
                          for x in conv._leaves(mean_delta)]
                self.norms.append(math.sqrt(sum(float((x * x).sum())
                                                for x in leaves)))
            return orig(obs, mean_delta, lr=lr)

        monkeypatch.setattr(conv.ConvergenceObservatory, "observe", observe)


def _conv(recs):
    return [{k: v for k, v in r.items() if k.startswith("conv_")}
            for r in recs]


def _check_plane(ours, theirs, seen):
    assert len(ours) == len(theirs) == len(seen.norms) >= 2
    for i, (a, b) in enumerate(zip(_conv(ours), _conv(theirs))):
        assert set(a) == set(b) == CONV_KEYS | (
            {"conv_cos_prev"} if i else set())
        assert_signals_close(a, b, rtol=1e-4, norm_atol=2e-5,
                             cos_atol=1e-4)
        np.testing.assert_allclose(a["conv_update_norm"], seen.norms[i],
                                   rtol=1e-5)
    assert all(not k.startswith("conv_") for r in ours for k in r
               if k not in CONV_KEYS | {"conv_cos_prev"})


def test_synchronous_coordinator_observes_as_jax(monkeypatch):
    cfgs = configs(num_clients=3, momentum=0.0,
                   run_kw=dict(learn_observe=True))
    seen = _Seen(monkeypatch)
    ours, _ = tree_run(cfgs, 3, rounds=3, n_agg=0)
    theirs, _ = tree_run(cfgs, 3, rounds=3, n_agg=0, coord="jax",
                         aggs="jax", workers="jax")
    _check_plane(ours, theirs, seen)
    plain, _ = tree_run(configs(num_clients=3, momentum=0.0), 3, rounds=1,
                        n_agg=0)
    assert sorted(plain[0]) == sorted(set(ours[0]) - CONV_KEYS)


def test_tree_coordinator_observes_as_jax(monkeypatch):
    cfgs = configs(num_clients=3, momentum=0.0,
                   run_kw=dict(learn_observe=True, num_aggregators=2))
    seen = _Seen(monkeypatch)
    ours, _ = tree_run(cfgs, 3, rounds=2, n_agg=2)
    theirs, _ = tree_run(cfgs, 3, rounds=2, n_agg=2, coord="jax",
                         aggs="jax", workers="jax")
    _check_plane(ours, theirs, seen)


def test_asynchronous_coordinator_observes_as_jax(monkeypatch):
    cfgs = configs(num_clients=3, momentum=0.0,
                   run_kw=dict(learn_observe=True))
    seen = _Seen(monkeypatch)
    ours, _ = async_run(cfgs, 3, 3, buffer_size=3, want_evaluator=False)
    theirs, _ = async_run(cfgs, 3, 3, coord="jax", workers="jax",
                          buffer_size=3, want_evaluator=False)
    _check_plane(ours, theirs, seen)


def test_sharded_server_observes_the_placed_mean(monkeypatch):
    """At tp = 2 the mean is a placed tree: the observatory reads every
    shard once, and its signals are the replicated server's (the fold
    is bitwise; only the dot products' summation order differs)."""
    out = {}
    for tp in (1, 2):
        seen = _Seen(monkeypatch)
        cfgs = configs(num_clients=3, momentum=0.0,
                       run_kw=dict(learn_observe=True, tp_size=tp))
        out[tp] = tree_run(cfgs, 3, rounds=2, n_agg=0)[0], seen
    (rep, _), (shd, seen) = out[1], out[2]
    for a, b, n in zip(_conv(shd), _conv(rep), seen.norms):
        assert_signals_close(a, b, rtol=1e-6, norm_atol=1e-8,
                             cos_atol=1e-6)
        np.testing.assert_allclose(a["conv_update_norm"], n, rtol=1e-5)


# -------------------------------------------------------------- fleetsim --
def _fleet_pair(num_devices, cohort, chunk, label_skew=None, **run_kw):
    """JAX's observed population-mode fleet and the port's, on JAX's
    initial params with JAX's draws; and those params."""
    run_kw = dict(learn_observe=True, **run_kw)
    sides = []
    for mod, fmod in ((jc, jfs), (tc, fleetsim)):
        pop, tm = _population(fmod, num_devices)
        if label_skew is not None:
            pop = fmod.DevicePopulation(fmod.PopulationSpec(
                num_devices=num_devices, feature_dim=16, shard_capacity=16,
                min_examples=4, label_skew=label_skew, seed=0))
        kw = {} if mod is jc else dict(device="cpu", draws=JaxDraws(0))
        sides.append(fmod.FleetSim.from_population(
            fleet_config(mod, run_kw=run_kw), pop, tm, cohort_size=cohort,
            chunk_size=chunk, **kw))
    j, t = sides
    init = jax.device_get(j.server_state.params)
    t.load_flax_params(init)
    return j, t, init


def test_fleetsim_observed_round_equals_jax_s():
    """One chunk per round, JAX's draws replayed: every ``conv_*`` key of
    JAX's observed chunk program, to the f32 bounds the chunk parity
    holds the params to (rtol 1e-4, atol 2e-5; cosines atol 1e-4).
    Apart from those keys, each record is the unobserved fleet's bit for
    bit: observing changes nothing of the round."""
    j, t, init = _fleet_pair(64, 16, 16)
    h_j, h_t = j.fit(3), t.fit(3)
    for a, b in zip(h_t, h_j):
        assert {"conv_cohort_skew", "conv_norm_p90"} <= set(b)
        assert_signals_close(
            {k: v for k, v in a.items() if k.startswith("conv_")},
            {k: v for k, v in b.items() if k.startswith("conv_")},
            rtol=1e-4, norm_atol=2e-5, cos_atol=1e-4)
    pop, tm = _population(fleetsim, 64)
    plain = fleetsim.FleetSim.from_population(
        fleet_config(tc), pop, tm, cohort_size=16, chunk_size=16,
        device="cpu", draws=JaxDraws(0))
    plain.load_flax_params(init)
    for a, b in zip(plain.fit(3), h_t):
        assert not any(k.startswith("conv_") for k in a)
        assert {k: v for k, v in a.items() if k != "round_time_s"} == {
            k: v for k, v in b.items()
            if not k.startswith("conv_") and k != "round_time_s"}


def test_fleetsim_norm_anomalies_reach_the_health_ledger(tmp_path):
    """A device whose update norm passes 3 x the median is a
    ``norm_anomaly`` in the ledger, as in JAX; a large lr on a skewed
    population makes some."""
    pop = fleetsim.DevicePopulation(fleetsim.PopulationSpec(
        num_devices=64, feature_dim=16, shard_capacity=16, min_examples=2,
        label_skew=0.9, seed=0))
    _, tm = _population(fleetsim, 64)
    sim = fleetsim.FleetSim.from_population(
        fleet_config(tc, run_kw=dict(learn_observe=True,
                                     health_dir=str(tmp_path)), lr=0.5),
        pop, tm, cohort_size=32, chunk_size=16, device="cpu")
    hist = sim.fit(3)
    counted = sum(r["conv_norm_anomalies"] for r in hist)
    ledger = telemetry.load_health(str(tmp_path))
    flagged = sum(h.counts["norm_anomaly"] for h in ledger.values())
    assert flagged == counted


def test_fleetsim_async_observed_records_equal_jax_s():
    j, t, _ = _fleet_pair(32, 8, 8)
    h_j = j.fit_async(5, buffer_size=4, max_staleness=8)
    h_t = t.fit_async(5, buffer_size=4, max_staleness=8)
    assert len(h_j) == len(h_t) == 5
    for a, b in zip(h_t, h_j):
        assert_signals_close(
            {k: v for k, v in a.items() if k.startswith("conv_")},
            {k: v for k, v in b.items() if k.startswith("conv_")},
            rtol=1e-4, norm_atol=2e-5, cos_atol=1e-4)


def test_fleetsim_drift_separates_noniid_from_iid():
    """JAX's acceptance in miniature, on both sides: matched seeds, only
    the label skew differs, and the cohort-skew signal separates."""
    def mean_skew(sim) -> float:
        hist = sim.fit(4)
        vals = [r["conv_cohort_skew"] for r in hist[1:]]
        return sum(vals) / len(vals)

    skews = {}
    for label_skew in (0.9, 0.0):
        j, t, _ = _fleet_pair(48, 16, 16, label_skew=label_skew)
        skews[label_skew] = (mean_skew(t), mean_skew(j))
    assert skews[0.9][0] > skews[0.0][0] + 0.2
    assert skews[0.9][1] > skews[0.0][1] + 0.2
    for ours, theirs in skews.values():
        assert ours == pytest.approx(theirs, abs=1e-3)


def test_cli_fleetsim_learn_observe(capsys):
    out = cli.main(["fleetsim", "--devices", "64", "--cohort", "8",
                    "--rounds", "2", "--chunk", "8", "--backend", "cpu",
                    "--learn-observe"])
    err = capsys.readouterr().err
    recs = [json.loads(ln) for ln in err.splitlines()
            if ln.startswith('{"train_loss"')]
    assert out["rounds"] == 2 and len(recs) == 2
    assert {"conv_cohort_skew", "conv_norm_p90"} <= set(recs[0])
    assert "conv_cos_prev" in recs[1]
