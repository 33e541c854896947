"""What the port does without a mesh, held to the JAX package's behaviour.

- A ``ring`` or ``ulysses`` config on one device runs the dense core (a
  single process has no sequence axis): the learner's round equals the
  dense config's, and the JAX learner's on the same config and draws
  (JAX ``tests/test_sp.py::test_ring_config_single_device_falls_back_to_dense``).
- ``tp_size > 1`` without a mesh: ``FederatedLearner`` runs with
  ``tp_size`` 1, and ``from_config`` in a plain process warns with JAX's
  message and runs untiled; a ring config with ``tp_size > 1`` is refused
  by ``from_config`` with JAX's message.
- The command line takes ``--attn-impl ring|ulysses``, ``--tp-size`` and
  ``--remat`` into the config as JAX's does, and a ``train`` with
  ``--tp-size 2 --remat`` (which warns) or ``--attn-impl ring --remat``
  on the CPU runs on one device.

f32; rtol 1e-4 / atol 2e-5 against JAX, exact between the port's runs.
"""

import argparse
import dataclasses
import re
import warnings

import jax
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu import cli as jax_cli
from colearn_federated_learning_tpu.fed import FederatedLearner as JaxLearner
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu_torch import cli, convert
from colearn_federated_learning_tpu_torch.fed import FederatedLearner
from colearn_federated_learning_tpu_torch.models.attention import (
    MultiHeadAttention)
from colearn_federated_learning_tpu_torch.utils import config
from test_torch_port_round import JaxDraws

RTOL, ATOL = 1e-4, 2e-5
BERT = dict(name="bert", num_classes=4, width=32, depth=2, num_heads=4,
            seq_len=64, vocab_size=2000)


def _configs(attn_impl="dense", tp_size=1):
    kw = dict(data=dict(dataset="agnews_tiny", partition="iid", num_clients=4,
                        max_examples_per_client=16),
              model=dict(BERT, attn_impl=attn_impl),
              fed=dict(rounds=1, cohort_size=2, local_steps=2, batch_size=4,
                       lr=0.05, momentum=0.0, local_optimizer="sgd"),
              run=dict(seed=3, tp_size=tp_size))
    return [mod.ExperimentConfig(
        data=mod.DataConfig(**kw["data"]), model=mod.ModelConfig(**kw["model"]),
        fed=mod.FedConfig(**kw["fed"]), run=mod.RunConfig(**kw["run"]))
        for mod in (jax_config, config)]


def _cores(learner):
    return {m.impl for m in learner.model.modules()
            if isinstance(m, MultiHeadAttention)}


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sp_config_on_one_device_runs_the_dense_core(impl):
    jcfg, tcfg = _configs(impl)
    jl = JaxLearner(jcfg)
    assert not jl.sp
    flax = jax.device_get(jl.params)
    out = []
    for cfg in (tcfg, _configs("dense")[1]):
        ln = FederatedLearner(cfg, device="cpu", plan=JaxDraws(3))
        assert not ln.sp and ln.mesh is None and _cores(ln) == {"dense"}
        ln.load_flax_params(flax)
        out.append((ln.run_round(), ln.params))
    (rec, params), (dense_rec, dense_params) = out
    assert rec["train_loss"] == dense_rec["train_loss"]
    for k, v in params.items():
        assert torch.equal(v, dense_params[k]), k
    jrec = jl.run_round()
    np.testing.assert_allclose(rec["train_loss"], jrec["train_loss"],
                               rtol=RTOL)
    want = convert.flax_to_state_dict(jax.tree.map(
        np.asarray, jax.device_get(jl.server_state.params)))
    for k, v in params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_tp_size_without_a_mesh_runs_untiled():
    """A learner built without a mesh has ``tp_size`` 1, as JAX's
    (``fed/engine.py``: no mesh, no model axis)."""
    jcfg, tcfg = _configs(tp_size=2)
    assert JaxLearner(jcfg).tp_size == 1
    ln = FederatedLearner(tcfg, device="cpu")
    assert ln.tp_size == 1 and ln.tp_dims is None
    ref = FederatedLearner(_configs()[1], device="cpu")
    assert ln.run_round()["train_loss"] == ref.run_round()["train_loss"]


def _warning(fn):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = fn()
    msgs = [str(w.message) for w in seen if "tp_size" in str(w.message)]
    assert len(msgs) == 1, msgs
    return out, msgs[0]


def test_from_config_warns_like_jax_and_runs_untiled():
    jcfg, tcfg = _configs(tp_size=3)
    # JAX sees 8 CPU devices here, the port a world of 1: the same
    # message with the count it had.
    _, jax_msg = _warning(lambda: JaxLearner.from_config(
        jcfg.replace(run=dataclasses.replace(jcfg.run, backend="cpu"))))
    ln, msg = _warning(lambda: FederatedLearner.from_config(tcfg,
                                                            device="cpu"))
    assert re.sub(r"have \d+", "have N", msg) == \
        re.sub(r"have \d+", "have N", jax_msg)
    assert ln.mesh is None and ln.tp_size == 1
    ref = FederatedLearner(_configs()[1], device="cpu")
    assert ln.run_round()["train_loss"] == ref.run_round()["train_loss"]
    jcfg, tcfg = _configs("ring", tp_size=2)
    with pytest.raises(ValueError) as theirs:
        JaxLearner.from_config(jcfg)
    with pytest.raises(ValueError) as ours:
        FederatedLearner.from_config(tcfg, device="cpu")
    assert str(ours.value) == str(theirs.value)


FLAGS = ["--attn-impl", "ring", "--tp-size", "2", "--remat"]


@pytest.mark.parametrize("flags", [FLAGS, ["--attn-impl", "ulysses"]])
def test_cli_takes_sp_tp_and_remat_flags_like_jax(flags):
    base = ["--config", "agnews_bert_fedavg", "--dataset", "agnews_tiny",
            "--width", "48"]
    ours = cli.config_from_args(cli.build_parser().parse_args(
        ["train", *base, *flags]))
    parser = argparse.ArgumentParser()
    jax_cli._add_override_flags(parser)
    theirs = jax_cli.config_from_args(parser.parse_args([*base, *flags]))
    assert vars(ours.model) == vars(theirs.model)
    assert ours.run.tp_size == theirs.run.tp_size


@pytest.mark.parametrize("flags", [["--tp-size", "2", "--remat"],
                                   ["--attn-impl", "ring", "--remat"]])
def test_cli_train_with_ring_tp_and_remat_runs_on_one_device(flags):
    argv = ["train", "--backend", "cpu", "--config", "agnews_bert_fedavg",
            "--dataset", "agnews_tiny", "--width", "48", "--num-clients", "2",
            "--cohort-size", "1", "--local-steps", "1", "--batch-size", "2",
            "--rounds", "1", *flags]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        summary = cli.main(argv)
        msgs = [str(w.message) for w in seen if "tp_size" in str(w.message)]
    assert len(msgs) == ("--tp-size" in flags)
    assert summary["rounds"] == 1 and summary["n_chips"] == 1
    assert np.isfinite(summary["final_loss"])
