"""The port's command line: ``python -m colearn_federated_learning_tpu_torch
.cli train``.  Its overrides reach the config as the JAX command line's
do, a run on the CPU gives the round of ``FederatedLearner`` called
directly, a flag of a feature not ported yet exits non-zero naming its
ROADMAP item, and the default backend is the card, which raises without
one."""

import argparse
import json

import pytest
import torch

from colearn_federated_learning_tpu import cli as jax_cli
from colearn_federated_learning_tpu_torch import cli
from colearn_federated_learning_tpu_torch.fed import FederatedLearner

TINY = ["--config", "mnist_mlp_fedavg", "--dataset", "mnist_tiny",
        "--num-clients", "4", "--cohort-size", "2", "--local-steps", "2",
        "--rounds", "1"]


def test_train_on_the_cpu_matches_the_learner(capsys):
    records = []
    summary = cli.main(["train", "--backend", "cpu", *TINY],
                       on_round=lambda ln, rec: rec and records.append(rec))
    out = capsys.readouterr()
    assert (json.loads(out.out.strip().splitlines()[-1])
            == json.loads(json.dumps(summary)))
    assert json.loads(out.err.strip().splitlines()[0]) == records[0]
    assert summary["rounds"] == 1 and summary["device"] == "cpu"
    config = cli.config_from_args(cli.build_parser().parse_args(
        ["train", *TINY]))
    direct = FederatedLearner(config, device="cpu").run_round()
    assert records[0]["train_loss"] == direct["train_loss"]
    assert 0.0 <= summary["final_acc"] <= 1.0


@pytest.mark.parametrize("extra", [
    [], ["--strategy", "scaffold", "--momentum", "0", "--lr", "0.01"],
    ["--dp-clip", "0.5", "--dp-noise-multiplier", "1.1",
     "--dp-adaptive-clip", "--dp-target-quantile", "0.6", "--dp-clip-lr",
     "0.1", "--dp-bit-noise", "2.0", "--dp-delta", "1e-6"],
    ["--secure-agg", "--secure-agg-neighbors", "4", "--seed", "7",
     "--eval-every", "3", "--straggler-prob", "0.2"],
    ["--aggregator", "krum", "--trim-fraction", "0.2", "--partition",
     "dirichlet", "--dirichlet-alpha", "0.3", "--width", "48"]])
def test_overrides_reach_the_config_as_in_jax(extra):
    ours = cli.config_from_args(cli.build_parser().parse_args(
        ["train", *TINY, *extra]))
    parser = argparse.ArgumentParser()
    jax_cli._add_override_flags(parser)
    theirs = jax_cli.config_from_args(parser.parse_args([*TINY, *extra]))
    for section in ("fed", "data", "model"):
        assert vars(getattr(ours, section)) == vars(getattr(theirs, section))
    assert ours.run.seed == theirs.run.seed
    assert ours.run.eval_every == theirs.run.eval_every


@pytest.mark.parametrize("flag,item", [
    (["--lora-rank", "4"], "item 5"), (["--edge-groups", "2"], "item 4"),
    (["--tp-size", "2"], "item 7"), (["--compress", "topk"], "item 8"),
    (["--role", "client"], "item 8"), (["--checkpoint-dir", "ck"], "item 9"),
    (["--resume"], "item 9"), (["--trace-dir", "tr"], "item 10"),
    (["--profile-dir", "pr"], "item 10")])
def test_unported_override_exits_naming_its_roadmap_item(flag, item, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["train", "--backend", "cpu", *TINY, *flag])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert flag[0] in err and f"ROADMAP.md Queue A {item}" in err


def test_default_backend_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.build_parser().parse_args(["train"]).backend == "gpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", *TINY])
