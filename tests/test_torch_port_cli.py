"""The port's command line: ``python -m colearn_federated_learning_tpu_torch
.cli train``.  Its overrides reach the config as the JAX command line's
do, a run on the CPU gives the round of ``FederatedLearner`` called
directly, a flag of a feature not ported yet exits non-zero naming its
ROADMAP item, and the default backend is the card, which raises without
one.  The parser accepts every flag of the JAX ``train``, ``init``,
``aggregate``, ``eval`` and ``bench`` parsers; the file plane's flags
(``--role client``, ``--compress*``, ``--topk-fraction``,
``--min-cohort-fraction`` and the client's files) do in ``--role sim``
what they do in JAX, which is nothing beyond the config; the
hierarchical path (``--edge-groups``) prints JAX's summary keys and
refuses what JAX's refuses with its message; ``--per-client-eval`` dumps
JAX's report; the summary's rates are over the ``--log-every`` records."""

import argparse
import io
import json
import re
from contextlib import redirect_stdout

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
     "dirichlet", "--dirichlet-alpha", "0.3", "--width", "48"],
    ["--edge-groups", "2", "--edge-sync-period", "3", "--log-every", "2"],
    ["--compress", "topk8", "--compress-feedback", "--topk-fraction", "0.2",
     "--min-cohort-fraction", "0.5"]])
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
    assert ours.run.log_every == theirs.run.log_every


@pytest.mark.parametrize("flag,item", [
    (["--lora-rank", "4"], "item 5"),
    (["--lora-alpha", "8", "--edge-groups", "2"], "item 5"),
    (["--tp-size", "2"], "item 7"), (["--compress-down", "int8"], "item 8"),
    (["--fold-device"], "item 8"), (["--checkpoint-dir", "ck"], "item 9"),
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


def _jax_train_flags() -> set:
    out = io.StringIO()
    with redirect_stdout(out), pytest.raises(SystemExit):
        jax_cli.main(["train", "--help"])
    # Each option's own line of the help opens with two spaces.
    return set(re.findall(r"^  (--[a-z][a-z0-9-]*)", out.getvalue(), re.M))


def test_every_jax_train_flag_is_accepted():
    jax_flags = _jax_train_flags()
    assert {"--edge-groups", "--client-id", "--log-every"} <= jax_flags
    ours = set(cli.build_parser()._subparsers._group_actions[0]
               .choices["train"]._option_string_actions)
    assert jax_flags <= ours, sorted(jax_flags - ours)


# The flags of the JAX train parser that belong to the socket planes and
# faults/, with a value of their type.
COMM_FLAGS = [
    ("--agg-buffer-interval", "1.5"), ("--agg-heartbeat-timeout", "2.0"),
    ("--num-aggregators", "3"), ("--comm-backoff-base", "0.1"),
    ("--comm-backoff-max", "1.0"), ("--comm-retries", "4"),
    ("--evict-after", "2"), ("--fault-seed", "9"),
    ("--fault-plan", "plan.json"), ("--compress-down", "int8"),
    ("--compress-down", "topk8"), ("--topk-max-fraction", "0.3"),
    ("--topk-min-fraction", "0.02"), ("--worker-enroll-timeout", "5.0")]


@pytest.mark.parametrize("flag,value", COMM_FLAGS)
def test_comm_plane_flag_exits_naming_item_8(flag, value, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["train", "--backend", "cpu", *TINY, flag, value])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"{flag} is not ported" in err
    assert "ROADMAP.md Queue A item 8" in err


EDGE = ["--config", "mnist_mlp_fedavg", "--dataset", "mnist_tiny",
        "--num-clients", "4", "--local-steps", "2", "--rounds", "3",
        "--edge-groups", "2", "--edge-sync-period", "2"]


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def test_edge_groups_prints_the_jax_summary(capsys):
    records = []
    summary = cli.main(["train", "--backend", "cpu", *EDGE],
                       on_round=lambda ln, rec: rec and records.append(rec))
    ours = capsys.readouterr()
    assert _last_json(ours.out) == json.loads(json.dumps(summary))
    assert jax_cli.main(["train", "--backend", "cpu", *EDGE]) == 0
    theirs = capsys.readouterr()
    jax_summary = _last_json(theirs.out)
    assert sorted(summary) == sorted(jax_summary)
    for key in ("name", "rounds", "edge_groups", "data_source"):
        assert summary[key] == jax_summary[key]
    assert [r["synced"] for r in records] == [False, True, True]
    assert summary["final_acc"] == records[-1]["eval_acc"]
    ours_recs = [json.loads(line) for line in ours.err.strip().splitlines()]
    jax_recs = [json.loads(line) for line in theirs.err.strip().splitlines()]
    assert [sorted(r) for r in ours_recs] == [sorted(r) for r in jax_recs]


@pytest.mark.parametrize("extra", [["--per-client-eval"],
                                   ["--per-client-eval", "--resume"]])
def test_edge_groups_refuses_as_jax_does(extra, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["train", "--backend", "cpu", *EDGE, *extra])
    assert exc.value.code == 2
    ours = capsys.readouterr().err.strip()
    assert jax_cli.main(["train", "--backend", "cpu", *EDGE, *extra]) == 2
    assert ours == capsys.readouterr().err.strip()


def test_per_client_eval_dumps_the_jax_report(capsys):
    summary = cli.main(["train", "--backend", "cpu", *TINY,
                        "--per-client-eval"])
    report = _last_json(capsys.readouterr().err)
    assert jax_cli.main(["train", "--backend", "cpu", *TINY,
                         "--per-client-eval"]) == 0
    jax_report = _last_json(capsys.readouterr().err)
    assert sorted(report) == sorted(jax_report)
    assert len(report["per_client_acc"]) == 4
    assert report["num_examples"] == jax_report["num_examples"]
    assert 0.0 <= report["weighted_acc"] <= 1.0
    assert summary["rounds"] == 1


def test_summary_rates_are_over_the_logged_rounds(capsys):
    records = []
    summary = cli.main(["train", "--backend", "cpu", *TINY[:-1], "3",
                        "--log-every", "2"],
                       on_round=lambda ln, rec: rec and records.append(rec))
    capsys.readouterr()
    assert [r["round"] for r in records] == [0, 2]
    assert summary["rounds"] == 2
    assert summary["rounds_per_sec"] == pytest.approx(
        2 / sum(r["round_time_s"] for r in records))
    assert jax_cli.main(["train", "--backend", "cpu", *TINY[:-1], "3",
                         "--log-every", "2"]) == 0
    jax_summary = _last_json(capsys.readouterr().out)
    assert jax_summary["rounds"] == summary["rounds"]
    assert set(jax_summary) <= set(summary)


def _jax_flags(cmd: str) -> set:
    out = io.StringIO()
    with redirect_stdout(out), pytest.raises(SystemExit):
        jax_cli.main([cmd, "--help"])
    return set(re.findall(r"^  (--[a-z][a-z0-9-]*)", out.getvalue(), re.M))


@pytest.mark.parametrize("cmd", ["init", "aggregate", "eval", "bench"])
def test_every_jax_flag_of_the_file_plane_and_bench_is_accepted(cmd):
    ours = set(cli.build_parser()._subparsers._group_actions[0]
               .choices[cmd]._option_string_actions)
    theirs = _jax_flags(cmd)
    assert theirs and theirs <= ours, sorted(theirs - ours)


def test_file_plane_flags_in_sim_run_the_plain_round(capsys):
    """``--role sim`` with the file plane's flags trains exactly as without
    them: the in-process round never reads them, in JAX either."""
    extra = ["--client-id", "3", "--global-model", "g.npz", "--out", "u.npz",
             "--residual-path", "r.npz", "--compress", "topk8",
             "--compress-feedback", "--topk-fraction", "0.2",
             "--min-cohort-fraction", "0.5", "--role", "sim"]
    with_flags = cli.main(["train", "--backend", "cpu", *TINY, *extra])
    plain = cli.main(["train", "--backend", "cpu", *TINY])
    capsys.readouterr()
    assert with_flags["final_loss"] == plain["final_loss"]
    assert with_flags["acc_at_round"] == plain["acc_at_round"]


@pytest.mark.parametrize("argv,item", [
    (["eval", "--global-model", "g.npz", "--detection-eval"], "item 10"),
    (["init", "--out", "g.npz", "--lora-rank", "4"], "item 5"),
    (["aggregate", "--global-model", "g.npz", "--updates", "u.npz", "--out",
      "g1.npz", "--fault-plan", "p.json"], "item 8"),
    (["train", "--role", "client", "--client-id", "0", "--global-model",
      "g.npz", "--out", "u.npz", "--fold-device"], "item 8")])
def test_file_plane_refusals_name_their_items(argv, item, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main([argv[0], "--backend", "cpu", *argv[1:]])
    assert exc.value.code == 2
    assert f"ROADMAP.md Queue A {item}" in capsys.readouterr().err


def test_file_plane_commands_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["init", "--out", str(tmp_path / "g.npz")])
