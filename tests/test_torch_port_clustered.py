"""The port's clustered FL, update similarity and per-client evaluation
against the JAX package's on the same inputs and draws.

The concept-shift learner of ``tests/test_clustered.py``: the tiny MLP on
``mnist_tiny``, 8 clients, clients 4-7 with permuted labels (y -> 9 - y).
Both sides start from the JAX init and the port replays the JAX draws
(``test_torch_port_round.JaxDraws``), the similarity's included: JAX keys
its batches on ``client_round_key(key, id, 1 << 23)``, which the port
takes through ``Draws.batch_indices`` at ``programs.SIMILARITY_ROUND``.
f32 throughout; tolerance rtol 1e-4 / atol 2e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from colearn_federated_learning_tpu.data import registry as jax_registry
from colearn_federated_learning_tpu.fed import clustered as jax_clustered
from colearn_federated_learning_tpu.fed.engine import (
    FederatedLearner as JaxLearner)
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu_torch import convert
from colearn_federated_learning_tpu_torch.fed import FederatedLearner
from colearn_federated_learning_tpu_torch.fed import clustered, programs
from colearn_federated_learning_tpu_torch.utils import config
from test_torch_port_round import JaxDraws

RTOL, ATOL = 1e-4, 2e-5
SHIFTED = np.arange(4, 8)


def _configs(**fed_kw):
    fed = dict(strategy="fedavg", rounds=4, cohort_size=0, local_steps=3,
               batch_size=16, lr=0.1, momentum=0.9)
    fed.update(fed_kw)
    return [mod.ExperimentConfig(
        data=mod.DataConfig(dataset="mnist_tiny", num_clients=8,
                            partition="iid", max_examples_per_client=64),
        model=mod.ModelConfig(name="mlp", num_classes=10, hidden_dim=32,
                              depth=2),
        fed=mod.FedConfig(**fed), run=mod.RunConfig(name="clustered_test"))
        for mod in (jax_config, config)]


def _concept_shift_pair(shift=True, **fed_kw):
    """The JAX learner and the port's, on the same init and draws, with
    clients 4-7 in a permuted-label concept when ``shift``."""
    jcfg, tcfg = _configs(**fed_kw)
    jl = JaxLearner(jcfg)
    tl = FederatedLearner(tcfg, device="cpu", plan=JaxDraws(tcfg.run.seed))
    tl.load_flax_params(jax.device_get(jl.params))
    if shift:
        x, y, counts, ids = jl._device_data
        yh = np.array(y)
        yh[SHIFTED] = (9 - yh[SHIFTED]) % 10
        jl._device_data = (x, jnp.asarray(yh), counts, ids)
        tl.y[SHIFTED] = (9 - tl.y[SHIFTED]) % 10
    return jl, tl


def _hold_report(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if key in ("num_examples", "num_clusters", "cluster_sizes"):
            assert np.array_equal(np.asarray(got[key]), np.asarray(w)), key
        else:
            np.testing.assert_allclose(got[key], w, rtol=RTOL, atol=ATOL,
                                       err_msg=key)


@pytest.mark.parametrize("seed,k", [(0, 2), (1, 3), (7, 4)])
def test_kmeans_rows_gives_the_jax_labels(seed, k):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.normal(c, 0.3, (9, 5)) for c in range(k)])
    X = X[rng.permutation(len(X))]
    for s in (0, seed):
        assert np.array_equal(clustered.kmeans_rows(X, k, seed=s),
                              jax_clustered.kmeans_rows(X, k, seed=s))


@pytest.mark.parametrize("steps", [1, 3])
def test_client_update_similarity_matches_jax(steps):
    assert programs.SIMILARITY_ROUND == 1 << 23      # JAX's sentinel round
    jl, tl = _concept_shift_pair()
    want = np.asarray(jl.client_update_similarity(steps=steps))
    got = tl.client_update_similarity(steps=steps)
    assert got.shape == want.shape == (8, 8)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # The shifted clients anti-align with the others.
    assert got[0, 1] > 0 > got[0, 5]


def test_similarity_refuses_scaffold_as_jax_does():
    jcfg, tcfg = _configs(strategy="scaffold", momentum=0.0)
    with pytest.raises(NotImplementedError) as jerr:
        JaxLearner(jcfg).client_update_similarity()
    with pytest.raises(NotImplementedError) as terr:
        FederatedLearner(tcfg, device="cpu").client_update_similarity()
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("shift", [False, True])
def test_evaluate_per_client_matches_jax(shift):
    jl, tl = _concept_shift_pair(shift=shift)
    jl.run_round()
    tl.run_round()
    _hold_report(tl.evaluate_per_client(), jl.evaluate_per_client())
    assert np.array_equal(tl.id_order_slots(), jl.id_order_slots())


def _clustered_pair():
    jl, tl = _concept_shift_pair()
    return (jax_clustered.ClusteredLearner(jl, num_clusters=2),
            clustered.ClusteredLearner(tl, num_clusters=2))


def _hold_clusters(tc, jc):
    """Labels, members, cluster params and the per-client report agree."""
    assert np.array_equal(tc.labels, jc.labels)
    for tm, jm in zip(tc.members, jc.members):
        assert np.array_equal(tm, jm)
    for tlearner, jlearner in zip(tc.clusters, jc.clusters):
        for name, t in tlearner.params.items():
            want = _flax_to_numpy(jlearner.server_state.params)[name]
            np.testing.assert_allclose(t.numpy(), want, rtol=RTOL,
                                       atol=ATOL, err_msg=name)
    _hold_report(tc.evaluate_per_client(), jc.evaluate_per_client())


def _flax_to_numpy(params):
    return {k: v.numpy() for k, v in convert.flax_to_state_dict(
        jax.tree.map(np.asarray, jax.device_get(params))).items()}


def test_cluster_and_specialize_matches_jax():
    """Warm-up, similarity and k-means give JAX's labels (the planted
    concept split), and one round of cluster training JAX's models and
    per-client report."""
    jc, tc = _clustered_pair()
    jlabels = jc.cluster_and_specialize(warmup_rounds=2)
    tlabels = tc.cluster_and_specialize(warmup_rounds=2)
    assert np.array_equal(tlabels, jlabels)
    assert len(set(tlabels[:4])) == 1 and len(set(tlabels[4:])) == 1
    assert tlabels[0] != tlabels[4]
    jc.fit(rounds=1)
    tc.fit(rounds=1)
    _hold_clusters(tc, jc)


def test_reassign_and_refine_match_jax():
    """From a clustering that swaps one client each way, IFCA reassignment
    and refinement move them back on both sides alike."""
    jc, tc = _clustered_pair()
    jc.cluster_and_specialize(warmup_rounds=2)
    tc.cluster_and_specialize(warmup_rounds=2)
    true = np.array(tc.labels)
    bad = true.copy()
    bad[0], bad[4] = true[4], true[0]
    jc._build_clusters(bad, [c.server_state.params for c in jc.clusters])
    tc._build_clusters(bad, [c.params for c in tc.clusters])
    assert np.array_equal(tc.reassign(), jc.reassign())
    jlabels = jc.refine(iters=3, rounds_per_iter=2)
    tlabels = tc.refine(iters=3, rounds_per_iter=2)
    assert np.array_equal(tlabels, jlabels) and np.array_equal(tlabels, true)
    _hold_clusters(tc, jc)


def test_partitions_override_the_config_as_in_jax():
    """Explicit per-client index lists give the JAX learner's shards and
    the same first round."""
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(3)
    order = rng.permutation(
        len(jax_registry.get_dataset("mnist_tiny", seed=0).y_train))
    cuts = [0, 5, 40, 41, 90, 200, 260, 300, 333]
    parts = [order[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    jl = JaxLearner(jcfg, partitions=parts)
    tl = FederatedLearner(tcfg, device="cpu", plan=JaxDraws(0),
                          partitions=parts)
    tl.load_flax_params(jax.device_get(jl.params))
    assert np.array_equal(tl.counts, np.asarray(jl.shards.counts))
    assert np.array_equal(tl.y.numpy(), np.asarray(jl.shards.y))
    np.testing.assert_allclose(tl.run_round()["train_loss"],
                               jl.run_round()["train_loss"], rtol=RTOL,
                               atol=ATOL)


def test_cluster_learners_run_on_the_base_device_and_draws():
    _, tl = _concept_shift_pair()
    tc = clustered.ClusteredLearner(tl)
    tc._build_clusters(np.array([0, 1] * 4), [tl.params, tl.params])
    for learner in tc.clusters:
        assert learner.device == tl.device and learner.draws is tl.draws
        assert learner.num_clients == 4
    with pytest.raises(ValueError, match="num_clusters"):
        clustered.ClusteredLearner(tl, num_clusters=1)
    fresh = clustered.ClusteredLearner(tl)
    with pytest.raises(RuntimeError, match="cluster_and_specialize"):
        fresh.fit(rounds=1)
    assert dataclasses.asdict(tc.clusters[0].config.fed) == \
        dataclasses.asdict(tl.config.fed)
