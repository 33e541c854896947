"""The port's personalized evaluation (``engine.evaluate_personalized``,
``programs.build_personalized_eval_fn``) against the JAX package's.

Both learners start from JAX's initial params, train with JAX's round
draws and fine-tune with JAX's fine-tune draws (``client_round_key(...,
1 << 24)``, replayed through the port's ``plan``), on the MLP and on a
narrow flash-attention BERT.  The per-client accuracies are equal, or off
by one example on at most one client: the two packages' f32 params differ
by rounding (the trajectories are held to rtol 1e-4 elsewhere), which can
move an example that sits on a decision boundary.  The example counts and
the number of clients evaluated are equal, and the aggregates are the
weighted means of the per-client arrays.  On 4 gloo ranks the mesh's
report equals the single device's (JAX's
``tests/test_personalization.py``), and under a non-IID partition
personalization gains, as in JAX.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.fed import FederatedLearner as JaxLearner
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu_torch import cli
from colearn_federated_learning_tpu_torch.fed import FederatedLearner
from colearn_federated_learning_tpu_torch.fed import programs
from colearn_federated_learning_tpu_torch.utils import config
from test_torch_port_round import FAMILIES, JaxDraws
from torch_port_ranks import spawn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(family, **fed_kw):
    data, model, fed = FAMILIES[family]
    kw = dict(data=dict(data, num_clients=4, max_examples_per_client=48),
              model=model,
              fed=dict(fed, strategy="fedavg", rounds=1, cohort_size=0,
                       local_steps=2, batch_size=8, **fed_kw),
              run=dict(seed=5))
    return [mod.ExperimentConfig(
        data=mod.DataConfig(**kw["data"]), model=mod.ModelConfig(**kw["model"]),
        fed=mod.FedConfig(**kw["fed"]), run=mod.RunConfig(**kw["run"]))
        for mod in (jax_config, config)]


def _pair(family, **fed_kw):
    jcfg, tcfg = _configs(family, **fed_kw)
    jl = JaxLearner(jcfg)
    tl = FederatedLearner(tcfg, device="cpu", plan=JaxDraws(tcfg.run.seed))
    tl.load_flax_params(jax.device_get(jl.params))
    jl.fit()
    tl.fit()
    return jl, tl


def assert_reports_match(ours, theirs):
    n = theirs["num_eval_examples"]
    np.testing.assert_array_equal(ours["num_eval_examples"], n)
    assert ours["num_clients_evaluated"] == theirs["num_clients_evaluated"]
    for key in ("per_client_global_acc", "per_client_personalized_acc"):
        off = np.rint(np.abs(ours[key] - theirs[key]) * n).astype(int)
        assert off.max() <= 1 and (off > 0).sum() <= 1, (key, off)
    w = n / n.sum()
    for agg, g, p in (("global_acc", 1, 0), ("personalized_acc", 0, 1),
                      ("personalization_gain", -1, 1)):
        want = float(((g * ours["per_client_global_acc"]
                       + p * ours["per_client_personalized_acc"]) * w).sum())
        assert ours[agg] == pytest.approx(want, rel=1e-6, abs=1e-7)
        assert ours[agg] == pytest.approx(theirs[agg], abs=1.0 / n.min())


@pytest.mark.parametrize("family,steps", [("mlp", 3), ("bert", 2)])
def test_personalized_report_matches_jax(family, steps):
    jl, tl = _pair(family)
    theirs = jl.evaluate_personalized(steps=steps)
    ours = tl.evaluate_personalized(steps=steps)
    assert_reports_match(ours, theirs)
    assert sorted(ours) == sorted(theirs)
    assert ours["num_clients_evaluated"] == 4


def test_fine_tune_draws_are_keyed_on_their_own_round():
    """The fine-tune's batches are JAX's ``1 << 24`` draws: a plan that
    serves other rows there changes the personalized scores and nothing
    else."""
    jl, tl = _pair("mlp")
    base = tl.evaluate_personalized(steps=3)
    draws = tl.draws
    seen = []

    class Shifted:
        def __getattr__(self, name):
            return getattr(draws, name)

        def batch_indices(self, round_idx, client_id, count, steps, batch):
            seen.append((round_idx, count))
            out = draws.batch_indices(round_idx, client_id, count, steps,
                                      batch)
            return (out + 1) % max(count, 1)

    tl.draws = Shifted()
    shifted = tl.evaluate_personalized(steps=3, lr=None)
    assert {r for r, _ in seen} == {programs.PERSONALIZE_ROUND}
    assert [c for _, c in seen] == [int(c) // 2 for c in tl.counts]
    np.testing.assert_array_equal(shifted["per_client_global_acc"],
                                  base["per_client_global_acc"])
    assert (shifted["per_client_personalized_acc"]
            != base["per_client_personalized_acc"]).any()


def test_clients_without_a_holdout_half_are_dropped():
    """A client with fewer than 2 examples neither trains nor scores; with
    none left the report is JAX's empty one."""
    jl, tl = _pair("mlp")
    tl.counts = tl.block_counts = np.asarray([1, 48, 0, 48])
    rep = tl.evaluate_personalized(steps=1)
    assert rep["num_clients_evaluated"] == 2
    np.testing.assert_array_equal(rep["num_eval_examples"], [24, 24])
    tl.counts = tl.block_counts = np.asarray([1, 0, 1, 0])
    empty = tl.evaluate_personalized(steps=2)
    assert empty["num_clients_evaluated"] == 0
    assert empty["global_acc"] == empty["personalization_gain"] == 0.0


def _noniid():
    cfgs = _configs("mlp")
    return [c.replace(
        data=dataclasses.replace(c.data, num_clients=8,
                                 partition="dirichlet", dirichlet_alpha=0.1,
                                 max_examples_per_client=64),
        fed=dataclasses.replace(c.fed, local_steps=3, batch_size=16, lr=0.1,
                                momentum=0.9, rounds=2)) for c in cfgs]


def test_personalization_gains_under_non_iid():
    _, tcfg = _noniid()
    tl = FederatedLearner(tcfg, device="cpu")
    tl.fit(rounds=3)
    rep = tl.evaluate_personalized(steps=10)
    assert len(rep["per_client_global_acc"]) == 8
    assert (rep["num_eval_examples"] > 0).all()
    assert rep["personalized_acc"] > rep["global_acc"]
    assert rep["personalization_gain"] > 0.02


def test_mesh_matches_single_device(tmp_path):
    """4 gloo ranks, 8 clients, full participation: each rank fine-tunes
    and scores its block, and the gathered report is the single device's
    (JAX's tolerances: global atol 1e-6, personalized 1e-5)."""
    _, tcfg = _noniid()
    ref = FederatedLearner(tcfg, device="cpu")
    ref.fit(rounds=2)
    want = ref.evaluate_personalized(steps=4)
    ranks = spawn(4, tmp_path, [("personalized", dict(
        config=tcfg, rounds=2, steps=4))])
    for (got,) in ranks:
        np.testing.assert_allclose(got["per_client_global_acc"],
                                   want["per_client_global_acc"], atol=1e-6)
        np.testing.assert_allclose(got["per_client_personalized_acc"],
                                   want["per_client_personalized_acc"],
                                   atol=1e-5)
        np.testing.assert_array_equal(got["num_eval_examples"],
                                      want["num_eval_examples"])


def test_cli_train_dumps_the_personalized_report(capsys):
    """``train --personalize-steps N`` dumps JAX's report keys on stderr
    after the summary's training."""
    import json

    out = cli.main(["train", "--backend", "cpu", "--config",
                    "mnist_mlp_fedavg", "--dataset", "mnist_tiny",
                    "--num-clients", "4", "--rounds", "1", "--local-steps",
                    "2", "--personalize-steps", "2"])
    err = capsys.readouterr().err.splitlines()
    rep = json.loads(err[-1])
    assert out["rounds"] == 1
    assert sorted(rep) == sorted([
        "global_acc", "personalized_acc", "personalization_gain",
        "per_client_global_acc", "per_client_personalized_acc",
        "num_eval_examples", "num_clients_evaluated"])
    assert rep["num_clients_evaluated"] == 4
