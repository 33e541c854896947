"""The port's ``fit`` records against the JAX engine's record layout.

On the CPU, for the same config, every record carries exactly the JAX
record's keys (``phase_sync_s``, ``phase_eval_s`` on evaluated rounds,
``phase_cohort_sample_s`` under SCAFFOLD, the DP keys; no ``hbm_used_gb``,
which both sides write only where the device reports its memory);
``round_time_s`` is the round alone, the evaluation being timed on its
own; and ``log_fn`` fires on the rounds JAX's does under ``log_every``.
The socket coordinator's records through the aggregator tree carry JAX's
keys too (``aggregators``, ``phase_agg_fold_s``, and the codec's and
secure aggregation's keys under the tree).
"""

import time

import pytest

from colearn_federated_learning_tpu.fed import FederatedLearner as JaxLearner
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu_torch.fed import FederatedLearner
from colearn_federated_learning_tpu_torch.utils import config

CASES = {
    "fedavg": {},
    "scaffold": dict(strategy="scaffold", momentum=0.0),
    "dp_secure_agg": dict(dp_clip=1.0, dp_noise_multiplier=0.5,
                          dp_adaptive_clip=True, secure_agg=True),
    "krum": dict(aggregator="krum", trim_fraction=0.25),
    "fednova_stragglers": dict(strategy="fednova", straggler_prob=0.5),
}


def _configs(fed_kw, run_kw):
    fed = dict(strategy="fedavg", rounds=4, cohort_size=4, local_steps=2,
               batch_size=16, lr=0.1, momentum=0.9)
    fed.update(fed_kw)
    return [mod.ExperimentConfig(
        data=mod.DataConfig(dataset="mnist_tiny", num_clients=8,
                            partition="iid", max_examples_per_client=64),
        model=mod.ModelConfig(name="mlp", num_classes=10, hidden_dim=32,
                              depth=2),
        fed=mod.FedConfig(**fed), run=mod.RunConfig(name="rec", **run_kw))
        for mod in (jax_config, config)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_records_have_the_jax_keys(case):
    jcfg, tcfg = _configs(CASES[case], dict(eval_every=2))
    jhist = JaxLearner(jcfg).fit(rounds=3)
    thist = FederatedLearner(tcfg, device="cpu").fit(rounds=3)
    assert [sorted(r) for r in thist] == [sorted(r) for r in jhist]
    assert ["phase_eval_s" in r for r in thist] == [True, False, True]


@pytest.mark.parametrize("rounds,log_every", [(3, 2), (4, 2), (5, 3)])
def test_log_fn_fires_on_the_jax_rounds(rounds, log_every):
    jcfg, tcfg = _configs({}, dict(log_every=log_every))
    jseen, tseen = [], []
    JaxLearner(jcfg).fit(rounds=rounds,
                         log_fn=lambda r: jseen.append(r["round"]))
    FederatedLearner(tcfg, device="cpu").fit(
        rounds=rounds, log_fn=lambda r: tseen.append(r["round"]))
    assert tseen == jseen


def test_round_time_excludes_evaluation(monkeypatch):
    """An evaluation that takes 0.3 s shows in ``phase_eval_s`` and not in
    ``round_time_s``, which is the round's own phases (update and metrics
    sync) and nothing more.  Measured against those phases, not against a
    wall-clock bound, so a loaded host cannot fail it."""
    _, tcfg = _configs({}, {})
    learner = FederatedLearner(tcfg, device="cpu")
    evaluate = learner.evaluate

    def slow_evaluate():
        time.sleep(0.3)
        return evaluate()

    monkeypatch.setattr(learner, "evaluate", slow_evaluate)
    hist = learner.fit(rounds=2)
    for rec in hist:
        assert rec["phase_eval_s"] >= 0.3
        phases = rec["phase_update_s"] + rec["phase_sync_s"]
        assert phases <= rec["round_time_s"] < phases + 0.3


@pytest.mark.parametrize("fed_kw", [{}, dict(compress="topk8"),
                                    dict(secure_agg=True)],
                         ids=["dense", "topk8", "secure_agg"])
def test_tree_round_records_have_the_jax_keys(fed_kw):
    from test_torch_port_tree import tree_configs, tree_run

    cfgs = tree_configs(4, **fed_kw)
    # Secure rounds draw their masks from the port's own streams.
    kw = dict(worker_kw={"draws": None}) if fed_kw.get("secure_agg") else {}
    ours, _ = tree_run(cfgs, 4, rounds=1, **kw)
    theirs, _ = tree_run(cfgs, 4, rounds=1, coord="jax", aggs="jax",
                         workers="jax")
    assert [sorted(set(r) - {"retries"}) for r in ours] == [
        sorted(set(r) - {"retries"}) for r in theirs]
    assert {"aggregators", "phase_agg_fold_s"} <= set(ours[0])
