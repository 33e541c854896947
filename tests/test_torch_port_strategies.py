"""SCAFFOLD, FedNova and the robust aggregators of the port against the
JAX package.

Module level, f32, rtol 1e-4 / atol 2e-5 unless a case says otherwise:
SCAFFOLD's corrected local update and option-II refresh (with and without
an lr schedule factor) and its server variate step; FedNova's a_i with and
without momentum; median, trimmed mean and Multi-Krum on stacked deltas,
including the zero-contributor, non-finite-row, ``n < 3`` and exact-
product (0.45 · 20) cases.  The JAX aggregators take the whole cohort and
a contributor mask; the port takes the contributors' rows only.

Two-round trajectories (5 clients, cohort 3 or 4, 3 local steps) replay
the JAX round's cohort, batch and straggler draws through the ``plan``
(``test_torch_port_round.JaxDraws``) and hold the port to the bounds of
``tests/test_torch_port_round.py``: SCAFFOLD on the CNN (momentum 0,
lr 2e-3; the convolutional rule: losses to 1e-4, update norms to rtol
1e-3, each tensor's drift within 10 % of its movement), with the server
variate and every client's variate row held to the same rule; FedNova
with momentum 0.9 and stragglers, and median, trimmed mean and Krum, on a
2-layer BERT of width 64 with SGD (losses, weights and update norms to
1e-4, params to rtol 1e-4 / atol 1e-5 for 99.9 % of every tensor).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.fed import FederatedLearner as JaxLearner
from colearn_federated_learning_tpu.fed import robust as jax_robust
from colearn_federated_learning_tpu.fed import strategies as jax_strategies
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu.utils import prng as jax_prng
from colearn_federated_learning_tpu_torch import convert
from colearn_federated_learning_tpu_torch.fed import FederatedLearner
from colearn_federated_learning_tpu_torch.fed import local, robust, strategies
from colearn_federated_learning_tpu_torch.utils import config
from test_torch_port_round import JaxDraws, _assert_params_close

RTOL, ATOL = 1e-4, 2e-5
CONV_LOSS_TOL, CONV_NORM_RTOL = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side of these tests runs tensors of a few thousand
    entries, which gain nothing from intra-op threads (the file takes the
    same time at 1 as at 8); one thread keeps it from crowding the test
    processes that run beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

MODELS = {
    "cnn": (dict(dataset="cifar10_tiny", partition="dirichlet"),
            dict(name="cnn", num_classes=10, width=8)),
    "bert": (dict(dataset="agnews_tiny", partition="iid"),
             dict(name="bert", num_classes=4, width=64, depth=2, num_heads=4,
                  seq_len=64, vocab_size=2000)),
}


def _configs(model, **fed):
    data, mdl = MODELS[model]
    fed = dict(dict(rounds=2, cohort_size=3, local_steps=3, batch_size=8,
                    lr=0.05, momentum=0.0, local_optimizer="sgd",
                    straggler_min_fraction=0.67), **fed)
    return [mod.ExperimentConfig(
        data=mod.DataConfig(**data, num_clients=5),
        model=mod.ModelConfig(**mdl), fed=mod.FedConfig(**fed),
        run=mod.RunConfig(seed=3)) for mod in (jax_config, config)]


def _pair(model, **fed):
    jcfg, tcfg = _configs(model, **fed)
    jl = JaxLearner(jcfg)
    tl = FederatedLearner(tcfg, device="cpu", plan=JaxDraws(jcfg.run.seed))
    tl.load_flax_params(jax.device_get(jl.params))
    return jl, tl


def _port(tree) -> dict:
    """A flax-layout pytree (params, deltas, variates) in the port's
    names and layout."""
    return convert.flax_to_state_dict(jax.tree.map(np.asarray, tree))


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# ------------------------------------------------------------ SCAFFOLD
@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("lr_scale", [None, 0.5])
def test_scaffold_local_update_matches_jax(lr_scale):
    jl, tl = _pair("cnn", strategy="scaffold", lr=0.01)
    rng = np.random.default_rng(11)
    c_i, c = (jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * 0.1), jl.params)
        for _ in range(2))
    slot, budget = 2, 2                   # a straggler's partial budget
    count = int(jl.shards.counts[slot])
    key = jax_prng.client_round_key(jl.base_key, jnp.int32(slot),
                                    jnp.int32(0))
    want = jl.local_update(
        jl.params, jnp.asarray(jl.shards.x[slot]),
        jnp.asarray(jl.shards.y[slot]), jnp.int32(count), key,
        jnp.int32(budget), c_i, c,
        None if lr_scale is None else jnp.float32(lr_scale))
    idx = tl.draws.batch_indices(0, slot, count, tl.num_steps, 8)
    names = list(tl.params)
    ci_t, c_t = ([_port(t)[n] for n in names] for t in (c_i, c))
    got = tl.local_update(list(tl.params.values()), tl.x[slot], tl.y[slot],
                          count, torch.as_tensor(idx), budget, ci_t, c_t,
                          lr_scale)
    assert got.result.steps_run == float(want.result.steps_run) == budget
    _close(got.result.mean_loss, want.result.mean_loss)
    for field in ("delta", "c_new", "delta_c"):
        ref = _port(getattr(want, field) if field != "delta"
                    else want.result.delta)
        mine = getattr(got, field) if field != "delta" else got.result.delta
        for n, t in zip(names, mine):
            _close(t, ref[n], what=f"{field} {n}")


def test_scaffold_server_update_matches_jax():
    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((3, 2)).astype(np.float32),
              "b": rng.standard_normal((4,)).astype(np.float32)}
    jfed = jax_config.FedConfig(strategy="scaffold", server_lr=0.7)
    tfed = config.FedConfig(strategy="scaffold", server_lr=0.7)
    js = jax_strategies.init_server_state(
        {k: jnp.asarray(v) for k, v in params.items()}, jfed)
    ts = strategies.init_server_state(
        {k: torch.from_numpy(v.copy()) for k, v in params.items()}, tfed)
    for n in (3, 0, 5):
        d, dc = ({k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
                  for k, v in params.items()} for _ in range(2))
        part = np.float32(n) / np.float32(7)
        js = jax_strategies.server_update(
            js, {k: jnp.asarray(v) for k, v in d.items()}, jfed,
            mean_delta_c={k: jnp.asarray(v) for k, v in dc.items()},
            participation=jnp.float32(part))
        strategies.server_update(
            ts, {k: torch.from_numpy(v) for k, v in d.items()}, tfed,
            mean_delta_c={k: torch.from_numpy(v) for k, v in dc.items()},
            participation=float(part))
    for k in params:
        _close(ts.params[k], js.params[k], 1e-6, 1e-7)
        _close(ts.control[k], js.control[k], 1e-6, 1e-7)


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_scaffold_trajectory_matches_jax():
    jl, tl = _pair("cnn", strategy="scaffold", lr=2e-3)
    start = {k: v.clone() for k, v in tl.params.items()}
    names = list(tl.params)
    for _ in range(2):
        jr, tr = jl.run_round(), tl.run_round()
        assert tr["completed"] == jr["completed"] == 3
        _close(tr["train_loss"], jr["train_loss"], CONV_LOSS_TOL,
               CONV_LOSS_TOL)
        for key in ("total_weight", "delta_norm_mean", "delta_norm_max"):
            _close(tr[key], jr[key], CONV_NORM_RTOL, 1e-6, key)
        _assert_params_close(jax.device_get(jl.server_state.params),
                             tl.params, None, start)
    # The server variate and every client's variate row: the drift rule
    # (rows never sampled stay exactly zero).  The conv biases feed
    # single-channel GroupNorms, have an exactly-zero true gradient and
    # train on roundoff: they are held to 1e-6, as the params are.
    def held(got, ref, what):
        if what.startswith("Conv_") and ".bias" in what:
            assert np.abs(got - ref).max() <= 1e-6, what
        else:
            assert (np.linalg.norm(got - ref)
                    <= 0.1 * np.linalg.norm(ref)), what

    control = _port(jl.server_state.control)
    for n in names:
        held(tl.server_state.control[n].numpy(), control[n].numpy(), n)
    sampled = 0
    for i in range(tl.num_clients):
        row = _port(jax.tree.map(lambda v: v[i], jl.client_c))
        moved = any(np.abs(row[n].numpy()).max() > 0 for n in names)
        sampled += moved
        for n, store in zip(names, tl.variates.rows):
            if moved:
                held(store[i].numpy(), row[n].numpy(), f"{n} row {i}")
            else:
                assert not store[i].any(), (i, n)
    assert sampled >= 3


# ------------------------------------------------------------- FedNova
@pytest.mark.parametrize("momentum", [0.0, 0.5, 0.9])
def test_fednova_coefficient_matches_jax(momentum):
    steps = np.array([0, 1, 2, 3, 7, 34, 150], np.float32)
    tau = jnp.maximum(jnp.asarray(steps), 1.0)
    m = momentum
    if m > 0.0:
        want = (tau - m * (1.0 - m ** tau) / (1.0 - m)) / (1.0 - m)
    else:
        want = tau
    got = [local.fednova_coefficient(float(s), m) for s in steps]
    assert all(isinstance(a, np.float32) for a in got)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-7)


def _bert_trajectory(**fed):
    jl, tl = _pair("bert", **fed)
    completed, cohorts, step_bound = [], [], 0.0
    for _ in range(2):
        step_bound += 3 * tl.config.fed.lr * tl.config.fed.local_steps
        jr, tr = jl.run_round(), tl.run_round()
        assert tr["completed"] == jr["completed"]
        completed.append(tr["completed"])
        for key in ("train_loss", "total_weight", "delta_norm_mean",
                    "delta_norm_max"):
            _close(tr[key], jr[key], 1e-4, 1e-5, key)
        _assert_params_close(jax.device_get(jl.server_state.params),
                             tl.params, step_bound)
        cohorts.append(tl.last_cohort)
    return cohorts, completed


def test_fednova_trajectory_with_stragglers_matches_jax():
    cohorts, completed = _bert_trajectory(
        strategy="fednova", momentum=0.9, straggler_prob=0.6, lr=0.02)
    assert min(completed) < 3                 # some client was dropped
    a = np.concatenate([c["nova_a"] for c in cohorts])
    assert len(set(a.tolist())) > 1           # unequal steps, unequal a_i


# -------------------------------------------------------------- robust
def _stacked(n, rng):
    return {"a": rng.standard_normal((n, 3, 4)).astype(np.float32),
            "b": rng.standard_normal((n, 5)).astype(np.float32)}


ROBUST_CASES = {
    "all": (7, [1] * 7, 0.2),
    "masked": (8, [1, 0, 1, 1, 0, 1, 1, 1], 0.2),
    "none": (5, [0] * 5, 0.2),
    "two": (4, [0, 1, 0, 1], 0.2),
    "nonfinite": (7, [1] * 7, 0.2),
    "exact_product": (20, [1] * 20, 0.45),
}


@pytest.mark.parametrize("case", list(ROBUST_CASES))
@pytest.mark.parametrize("method", ["median", "trimmed_mean", "krum"])
def test_robust_aggregate_matches_jax(method, case):
    n, mask, frac = ROBUST_CASES[case]
    rng = np.random.default_rng(len(case) * 7 + n)
    x = _stacked(n, rng)
    mask = np.asarray(mask, bool)
    if case == "nonfinite":
        x["a"][2, 1, 1] = np.inf
        x["b"][5, 0] = np.nan
        x["a"][4] *= 1e3                      # a far outlier
    want = jax_robust.robust_aggregate(
        {k: jnp.asarray(v) for k, v in x.items()}, jnp.asarray(mask),
        method, frac)
    got, chosen = robust.robust_aggregate(
        [torch.from_numpy(x[k][mask]) for k in ("a", "b")], method, frac)
    for k, t in zip(("a", "b"), got):
        assert t.dtype == torch.float32 and t.shape == x[k].shape[1:]
        _close(t, want[k], what=k)
    if case == "none":
        assert all(not t.any() for t in got)
    if method == "krum" and mask.any():
        f = robust._trim_count(frac, int(mask.sum()))
        assert int(chosen.sum()) <= max(int(mask.sum()) - f, 1)
        if case == "nonfinite":
            assert not chosen[2] and not chosen[5]


@pytest.mark.parametrize("n,frac,want", [(20, 0.45, 9), (10, 0.2, 2),
                                         (3, 0.1, 1), (2, 0.4, 0),
                                         (7, 0.0, 0)])
def test_trim_count_rounds_exact_products_up(n, frac, want):
    assert robust._trim_count(frac, n) == want


@pytest.mark.parametrize("aggregator,frac", [("median", 0.0),
                                             ("trimmed_mean", 0.34),
                                             ("krum", 0.34)])
def test_robust_trajectory_matches_jax(aggregator, frac):
    cohorts, _ = _bert_trajectory(aggregator=aggregator, trim_fraction=frac,
                                  cohort_size=4, lr=0.05)
    if aggregator == "krum":
        assert all(len(c["selected"]) == 3 for c in cohorts)   # n − f of 4
