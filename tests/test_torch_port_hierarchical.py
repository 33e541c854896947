"""The port's hierarchical (edge → cloud) federation against the JAX
package's ``HierarchicalLearner`` on the same inputs and draws.

Both sides start from the JAX init (the port's groups load it through
``convert``), and every port group replays its JAX group's draws
(``test_torch_port_round.JaxDraws`` at the group's seed ``seed · G + g``).
Tiny MLP on ``mnist_tiny``, 8 clients in 2 groups, as in
``tests/test_hierarchical.py``; f32 throughout.  Tolerance: params, losses
and scores to rtol 1e-4 / atol 2e-5.  The one BERT case (the small BERT of
``test_torch_port_round.py`` on the flash path, Adam) is held to that
file's BERT rule, for its reason: Adam's first steps move an entry whose
gradient is at the level of eps by a roundoff-driven ±lr.
"""

import dataclasses

import jax
import numpy as np
import pytest

from colearn_federated_learning_tpu.fed import hierarchical as jax_hier
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu_torch import convert
from colearn_federated_learning_tpu_torch.fed import hierarchical, strategies
from colearn_federated_learning_tpu_torch.utils import config
from test_torch_port_round import FAMILIES, JaxDraws, _assert_params_close

RTOL, ATOL = 1e-4, 2e-5


def _configs(fed_kw=None, family="mlp", num_clients=8):
    if family == "mlp":
        data = dict(dataset="mnist_tiny", num_clients=num_clients,
                    partition="iid", max_examples_per_client=64)
        model = dict(name="mlp", num_classes=10, hidden_dim=32, depth=2)
        fed = dict(strategy="fedavg", rounds=6, cohort_size=0,
                   local_steps=3, batch_size=16, lr=0.1, momentum=0.9)
    else:
        fdata, model, ffed = FAMILIES[family]
        data = dict(fdata, num_clients=num_clients)
        fed = dict(ffed, rounds=2, cohort_size=2, local_steps=2,
                   batch_size=8)
    fed.update(fed_kw or {})
    return [mod.ExperimentConfig(
        data=mod.DataConfig(**data), model=mod.ModelConfig(**model),
        fed=mod.FedConfig(**fed), run=mod.RunConfig(name="hier_test"))
        for mod in (jax_config, config)]


def _pair(jcfg, tcfg, num_groups=2, sync_period=2):
    """The JAX learner and the port's, the port on JAX's init and draws."""
    jh = jax_hier.HierarchicalLearner(jcfg, num_groups=num_groups,
                                      sync_period=sync_period)
    plans = [JaxDraws(tcfg.run.seed * num_groups + g)
             for g in range(num_groups)]
    th = hierarchical.HierarchicalLearner(tcfg, num_groups=num_groups,
                                          sync_period=sync_period,
                                          device="cpu", plans=plans)
    init = jax.device_get(jh.global_params)
    for g in th.groups:
        g.load_flax_params(init)
    th.global_params = {k: v.clone() for k, v in th.groups[0].params.items()}
    return jh, th


def _state_dict(flax_params):
    return {k: v.numpy() for k, v in convert.flax_to_state_dict(
        jax.tree.map(np.asarray, jax.device_get(flax_params))).items()}


def _fit_with_snapshots(h, rounds, port):
    """fit(rounds) and, per logged round, the record with every group's
    params and the cloud params as name -> numpy dicts."""
    snaps = []

    def log_fn(rec):
        if port:
            groups = [{k: v.numpy().copy() for k, v in g.params.items()}
                      for g in h.groups]
            cloud = {k: v.numpy().copy() for k, v in h.global_params.items()}
        else:
            groups = [_state_dict(g.server_state.params) for g in h.groups]
            cloud = _state_dict(h.global_params)
        snaps.append((dict(rec), groups, cloud))

    h.fit(rounds=rounds, log_fn=log_fn)
    return snaps


def _hold_records(trec, jrec):
    assert sorted(trec) == sorted(jrec)
    for key, want in jrec.items():
        if isinstance(want, (bool, int)) or key == "round":
            assert trec[key] == want, key
        else:
            np.testing.assert_allclose(trec[key], want, rtol=RTOL,
                                       atol=ATOL, err_msg=key)


def test_groups_and_cloud_match_jax_round_by_round():
    """3 rounds with sync period 2: round 1 syncs at its boundary, round 2
    by the terminal sync; every group's params and the cloud params agree
    with JAX after every round, the records and evaluate() too."""
    jh, th = _pair(*_configs())
    jsnaps = _fit_with_snapshots(jh, 3, port=False)
    tsnaps = _fit_with_snapshots(th, 3, port=True)
    assert [s[0]["synced"] for s in tsnaps] == [False, True, True]
    for (trec, tgroups, tcloud), (jrec, jgroups, jcloud) in zip(tsnaps,
                                                                jsnaps):
        _hold_records(trec, jrec)
        for tg, jg in zip(tgroups, jgroups):
            for name in tg:
                np.testing.assert_allclose(tg[name], jg[name], rtol=RTOL,
                                           atol=ATOL, err_msg=name)
        for name in tcloud:
            np.testing.assert_allclose(tcloud[name], jcloud[name],
                                       rtol=RTOL, atol=ATOL, err_msg=name)
        if trec["synced"]:
            for tg in tgroups:           # every group holds the cloud model
                for name in tg:
                    assert np.array_equal(tg[name], tcloud[name]), name
    # Round 0 does not sync, and the two edge populations part.
    g0, g1 = tsnaps[0][1]
    assert any(not np.array_equal(g0[n], g1[n]) for n in g0)
    np.testing.assert_allclose(th.evaluate(), jh.evaluate(), rtol=RTOL,
                               atol=ATOL)
    assert len(th.history) == len(jh.history) == 3


def test_cloud_sync_is_the_example_weighted_mean():
    """Three groups weigh by their example counts: the sync equals the
    float64 weighted mean of the groups' params to f32 rounding."""
    _, tcfg = _configs(num_clients=9)
    th = hierarchical.HierarchicalLearner(tcfg, num_groups=3,
                                          sync_period=1, device="cpu")
    for g in th.groups:
        g.run_round()
    w = np.asarray(th.group_examples, np.float64)
    want = {n: sum(wi / w.sum() * g.params[n].double().numpy()
                   for wi, g in zip(w, th.groups)) for n in th.global_params}
    th._cloud_sync()
    for name, t in th.global_params.items():
        np.testing.assert_allclose(t.numpy(), want[name], rtol=1e-6,
                                   atol=1e-7)


def test_mask_costs_match_jax():
    jh, th = _pair(*_configs(dict(secure_agg_neighbors=2)))
    assert th.mask_cost_summary() == jh.mask_cost_summary()
    assignment = {f"d{i}": i % 3 for i in range(11)}
    for pruned in ((), ("d1", "d4"), ("d0", "d3", "d6", "d9")):
        assert (hierarchical.buffer_mask_cohorts(assignment, pruned)
                == jax_hier.buffer_mask_cohorts(assignment, pruned))
        for neighbors in (0, 2):
            assert (hierarchical.async_mask_cost(assignment, 12345,
                                                 neighbors, pruned)
                    == jax_hier.async_mask_cost(assignment, 12345,
                                                neighbors, pruned))


def test_composes_with_a_robust_aggregator():
    """Each group is a whole engine, so a per-group median composes with
    the cloud sync: 2 rounds, both synced, against JAX."""
    jh, th = _pair(*_configs(dict(aggregator="median")), sync_period=1)
    assert all(g.robust for g in th.groups)
    jsnaps = _fit_with_snapshots(jh, 2, port=False)
    tsnaps = _fit_with_snapshots(th, 2, port=True)
    for (trec, _, tcloud), (jrec, _, jcloud) in zip(tsnaps, jsnaps):
        _hold_records(trec, jrec)
        for name in tcloud:
            np.testing.assert_allclose(tcloud[name], jcloud[name],
                                       rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_small_bert_on_the_flash_path_matches_jax():
    """The small BERT (Adam, warmup-cosine lr, flash attention; the JAX
    kernel in interpret mode): 4 clients in 2 groups, cohort 2, 2 local
    steps, 2 rounds with a sync after each."""
    jcfg, tcfg = _configs(family="bert", num_clients=4)
    jh, th = _pair(jcfg, tcfg, sync_period=1)
    jsnaps = _fit_with_snapshots(jh, 2, port=False)
    tsnaps = _fit_with_snapshots(th, 2, port=True)
    step_bound = 0.0
    for r, ((trec, _, _), (jrec, _, _)) in enumerate(zip(tsnaps, jsnaps)):
        scale = strategies.lr_scale_for_round(tcfg.fed, r)
        step_bound += (3 * tcfg.fed.lr * tcfg.fed.local_steps
                       * (1.0 if scale is None else scale))
        _hold_records(trec, jrec)
    _assert_params_close(jax.device_get(jh.global_params), th.global_params,
                         step_bound)


@pytest.mark.parametrize("kw,fed_kw,num_clients", [
    (dict(num_groups=1), {}, 8),
    (dict(sync_period=0), {}, 8),
    (dict(num_groups=2), dict(strategy="fedadam"), 8),
    (dict(num_groups=3), {}, 8)])
def test_refusals_give_the_jax_messages(kw, fed_kw, num_clients):
    jcfg, tcfg = _configs(fed_kw, num_clients=num_clients)
    with pytest.raises(ValueError) as jerr:
        jax_hier.HierarchicalLearner(jcfg, **kw)
    with pytest.raises(ValueError) as terr:
        hierarchical.HierarchicalLearner(tcfg, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def test_groups_run_with_the_jax_seeds_and_data_slices():
    """Group g runs with seed · G + g over the g-th contiguous slice of
    the training corpus, with num_clients // G clients."""
    jcfg, tcfg = _configs(dict(rounds=1))
    tcfg = tcfg.replace(run=dataclasses.replace(tcfg.run, seed=5))
    th = hierarchical.HierarchicalLearner(tcfg, device="cpu")
    n = len(th.dataset.y_train)
    for g, learner in enumerate(th.groups):
        assert learner.config.run.seed == 5 * 2 + g
        assert learner.num_clients == 4
        assert np.array_equal(learner.dataset.y_train,
                              th.dataset.y_train[g * n // 2:(g + 1) * n // 2])
    assert th.group_examples == [n // 2, n - n // 2]
