"""A 2-round federated trajectory of the port against the JAX
``FederatedLearner``, plus its local optimizers, lr schedule and server
strategies against optax and the JAX package.

The round runs a tiny BERT (agnews_tiny, 5 clients, cohort 3, 3 local Adam
steps, warmup-cosine lr, flash attention on both sides; the JAX kernel in
interpret mode) from the same initial params, with the port fed the JAX
round's own draws: the cohort from ``rank_cohort(sampling_key)`` and every
step's batch indices from ``fold_in``/``randint`` on ``client_round_key``.

Tolerance of the trajectory (f32 on both sides): losses, weights and
update norms to 1e-5; params to rtol 1e-4 / atol 1e-5 for at least 99.9%
of the entries of every tensor, and every entry within the Adam step
bound (3 · lr · Σ_rounds lr_scale · steps).  Summation order differs
between XLA:CPU and PyTorch, and Adam's first steps are ±lr whatever the
gradient's size, so an entry whose gradient is at the level of Adam's eps
(1e-8) — a rare token's embedding — moves by a roundoff-driven step.  The
key-projection biases are held to the step bound alone: their true
gradient is exactly zero (a constant added to every key's score cancels
in the softmax), so both sides train them on roundoff.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from colearn_federated_learning_tpu.fed import FederatedLearner as JaxLearner
from colearn_federated_learning_tpu.fed import local as jax_local
from colearn_federated_learning_tpu.fed import strategies as jax_strategies
from colearn_federated_learning_tpu.fed.programs import rank_cohort
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu.utils import prng as jax_prng
from colearn_federated_learning_tpu_torch import convert
from colearn_federated_learning_tpu_torch.fed import FederatedLearner
from colearn_federated_learning_tpu_torch.fed import local, strategies
from colearn_federated_learning_tpu_torch.utils import config

PARAM_RTOL, PARAM_ATOL, LOSS_TOL = 1e-4, 1e-5, 1e-5
AGREE_FRACTION = 0.999


def _configs(straggler_prob=0.0, strategy="fedavg"):
    kw = dict(
        data=dict(dataset="agnews_tiny", num_clients=5, partition="iid"),
        model=dict(name="bert", num_classes=4, width=32, depth=2, num_heads=4,
                   seq_len=64, vocab_size=2000, attn_impl="flash"),
        fed=dict(strategy=strategy, rounds=2, cohort_size=3, local_steps=3,
                 batch_size=8, lr=1e-3, momentum=0.0, local_optimizer="adam",
                 lr_schedule="warmup_cosine", warmup_rounds=1,
                 lr_min_fraction=0.1, straggler_prob=straggler_prob,
                 straggler_min_fraction=0.67),
        run=dict(seed=3))
    out = []
    for mod in (jax_config, config):
        out.append(mod.ExperimentConfig(
            data=mod.DataConfig(**kw["data"]),
            model=mod.ModelConfig(**kw["model"]),
            fed=mod.FedConfig(**kw["fed"]), run=mod.RunConfig(**kw["run"])))
    return out


class JaxDraws:
    """The JAX round's own random draws (fed/programs.py, fed/local.py)."""

    def __init__(self, seed):
        self.key = jax_prng.experiment_key(seed)

    def cohort(self, round_idx, counts, k):
        skey = jax_prng.sampling_key(self.key, jnp.int32(round_idx))
        return np.asarray(rank_cohort(skey, jnp.asarray(counts), k))

    def batch_indices(self, round_idx, client_id, count, num_steps, batch):
        key = jax_prng.client_round_key(self.key, jnp.int32(client_id),
                                        jnp.int32(round_idx))
        return np.stack([np.asarray(jax.random.randint(
            jax.random.fold_in(key, t), (batch,), 0,
            jnp.maximum(jnp.int32(count), 1))) for t in range(num_steps)])

    def step_budgets(self, round_idx, client_ids, num_steps, prob):
        skey = jax_prng.straggler_key(self.key, jnp.int32(round_idx))
        out = []
        for i in client_ids:
            k = jax.random.fold_in(skey, jnp.int32(i))
            slow = bool(jax.random.bernoulli(k, prob))
            frac = float(jax.random.uniform(jax.random.fold_in(k, 1)))
            out.append(int(np.float32(frac) * num_steps) if slow
                       else num_steps)
        return np.asarray(out)


def _assert_params_close(jax_params, port_params, step_bound):
    want = convert.flax_to_state_dict(jax.tree.map(np.asarray, jax_params))
    for name, t in port_params.items():
        got, ref = t.numpy(), want[name].numpy()
        err = np.abs(got - ref)
        assert err.max() <= step_bound, (name, err.max(), step_bound)
        if name.endswith("attn.key.bias"):
            continue
        agree = err <= PARAM_ATOL + PARAM_RTOL * np.abs(ref)
        assert agree.mean() >= AGREE_FRACTION, (name, agree.mean())


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("straggler_prob,strategy", [
    (0.0, "fedavg"), (0.6, "fedprox")])
def test_two_round_trajectory_matches_jax(straggler_prob, strategy):
    jcfg, tcfg = _configs(straggler_prob, strategy)
    if strategy == "fedprox":
        jcfg = jcfg.replace(fed=dataclasses.replace(jcfg.fed, prox_mu=0.1))
        tcfg = tcfg.replace(fed=dataclasses.replace(tcfg.fed, prox_mu=0.1))
    jl = JaxLearner(jcfg)
    tl = FederatedLearner(tcfg, device="cpu", plan=JaxDraws(jcfg.run.seed))
    tl.load_flax_params(jax.device_get(jl.params))
    completed, step_bound = [], 0.0
    for r in range(2):
        step_bound += (3 * tcfg.fed.lr * tcfg.fed.local_steps
                       * strategies.lr_scale_for_round(tcfg.fed, r))
        jr, tr = jl.run_round(), tl.run_round()
        assert tr["completed"] == jr["completed"]
        completed.append(tr["completed"])
        np.testing.assert_allclose(tr["train_loss"], jr["train_loss"],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        for key in ("total_weight", "delta_norm_mean", "delta_norm_max"):
            np.testing.assert_allclose(tr[key], jr[key], rtol=1e-4, atol=1e-6)
        _assert_params_close(jax.device_get(jl.server_state.params),
                             tl.params, step_bound)
    if straggler_prob > 0:
        assert min(completed) < 3       # some client really was dropped
    (jloss, jacc), (tloss, tacc) = jl.evaluate(), tl.evaluate()
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert tacc == pytest.approx(jacc, abs=1e-6)


@pytest.mark.parametrize("name,momentum", [
    ("sgd", 0.0), ("sgd", 0.9), ("adam", 0.0), ("adamw", 0.0)])
def test_optimizer_steps_match_optax(name, momentum):
    rng = np.random.default_rng(7)
    params = [rng.standard_normal((5, 3)).astype(np.float32),
              rng.standard_normal((4,)).astype(np.float32)]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) * 1e-2
              for p in params] for _ in range(4)]
    opt = jax_local.make_optimizer(0.05, momentum, name)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    ours = local.make_optimizer(0.05, momentum, name)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = ours.init(tp)
    for g in grads:
        upd, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        upd = [u * jnp.float32(0.5) for u in upd]           # an lr_scale
        jp = optax.apply_updates(jp, upd)
        ours.step(tp, [torch.from_numpy(x) for x in g], tstate, lr_scale=0.5)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("schedule", ["constant", "cosine", "warmup_cosine"])
def test_lr_scale_matches_jax(schedule):
    jfed = jax_config.FedConfig(rounds=7, lr_schedule=schedule,
                                warmup_rounds=2, lr_min_fraction=0.1,
                                lr_spike_round=4, lr_spike_multiplier=3.0)
    tfed = config.FedConfig(**dataclasses.asdict(jfed))
    for r in range(9):
        want = jax_strategies.lr_scale_for_round(jfed, r)
        got = strategies.lr_scale_for_round(tfed, r)
        assert got == pytest.approx(float(want), rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("strategy", ["fedavg", "fedadam", "fedyogi"])
def test_server_update_matches_jax(strategy):
    rng = np.random.default_rng(1)
    params = {"a": rng.standard_normal((3, 2)).astype(np.float32),
              "b": rng.standard_normal((4,)).astype(np.float32)}
    jfed = jax_config.FedConfig(strategy=strategy, server_lr=0.3)
    tfed = config.FedConfig(strategy=strategy, server_lr=0.3)
    js = jax_strategies.init_server_state(
        {k: jnp.asarray(v) for k, v in params.items()}, jfed)
    ts = strategies.init_server_state(
        {k: torch.from_numpy(v.copy()) for k, v in params.items()}, tfed)
    for _ in range(3):
        d = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
             for k, v in params.items()}
        js = jax_strategies.server_update(
            js, {k: jnp.asarray(v) for k, v in d.items()}, jfed)
        strategies.server_update(ts, {k: torch.from_numpy(v)
                                      for k, v in d.items()}, tfed)
    assert ts.round_idx == int(js.round_idx) == 3
    for k in params:
        np.testing.assert_allclose(ts.params[k].numpy(),
                                   np.asarray(js.params[k]),
                                   rtol=1e-6, atol=1e-7)


def test_default_draws_are_deterministic_and_valid():
    from colearn_federated_learning_tpu_torch.fed.programs import Draws

    a, b = Draws(5), Draws(5)
    counts = np.array([4, 0, 7, 3, 9])
    sel = a.cohort(2, counts, 3)
    assert np.array_equal(sel, b.cohort(2, counts, 3))
    assert len(set(sel.tolist())) == 3 and 1 not in sel      # ghost last
    idx = a.batch_indices(1, 4, 9, 6, 8)
    assert idx.shape == (6, 8) and idx.min() >= 0 and idx.max() < 9
    assert np.array_equal(idx, b.batch_indices(1, 4, 9, 6, 8))
    assert not np.array_equal(idx, a.batch_indices(2, 4, 9, 6, 8))
    budgets = a.step_budgets(0, np.arange(50), 10, 0.5)
    assert budgets.max() == 10 and budgets.min() < 10
