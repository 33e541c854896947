"""The port's command line: ``python -m colearn_federated_learning_tpu_torch
.cli train``.  Its overrides reach the config as the JAX command line's
do, a run on the CPU gives the round of ``FederatedLearner`` called
directly, every JAX command runs (``lint`` and ``sentinel`` with JAX's
exit codes), and the default backend is the card,
which raises without one.  The parser accepts every flag of the JAX ``train``, ``init``,
``aggregate``, ``eval``, ``bench``, ``broker``, ``worker``,
``aggregator``, ``coordinate``, ``chaos`` and ``postmortem`` parsers
(the socket plane's flags are parsed into the
config as JAX does); the file plane's flags
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

import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu import cli as jax_cli
from colearn_federated_learning_tpu_torch import cli
from colearn_federated_learning_tpu_torch.fed import FederatedLearner
from colearn_federated_learning_tpu_torch.utils.config import RunConfig

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


@pytest.mark.parametrize("flag,report", [
    (["--personalize-steps", "2"], "personalization_gain"),
    (["--detection-eval"], "macro_f1"),
    (["--profile-dir", "pr"], None), (["--learn-observe"], None)])
def test_unported_override_exits_naming_its_roadmap_item(flag, report,
                                                         capsys, tmp_path,
                                                         monkeypatch):
    """The ``train`` flags refused until item 10b was ported now run as
    JAX's: the evaluation flags dump their report on stderr after the
    records, ``--profile-dir`` writes one trace and changes nothing of
    the run, and ``--learn-observe`` is a no-op in ``train``, as in JAX
    (its ``conv_*`` keys are the coordinators' and fleetsim's)."""
    monkeypatch.chdir(tmp_path)
    # The profiler's window opens at round 1: give it one.
    rounds = ["--rounds", "2"] if flag[0] == "--profile-dir" else []
    plain = cli.main(["train", "--backend", "cpu", *TINY, *rounds])
    capsys.readouterr()
    out = cli.main(["train", "--backend", "cpu", *TINY, *rounds, *flag])
    err = capsys.readouterr().err.strip().splitlines()
    assert out["acc_at_round"] == plain["acc_at_round"]
    assert out["final_loss"] == plain["final_loss"]
    rec = json.loads(err[0])
    assert not any(k.startswith("conv_") for k in rec)
    if report is not None:
        assert report in json.loads(err[-1])
    elif flag[0] == "--profile-dir":
        assert len(list((tmp_path / "pr").iterdir())) == 1


@pytest.mark.parametrize("cmd,flag,rest", [
    ("train", ["--lora-rank", "4"], []),
    ("train", ["--lora-alpha", "8"], ["--edge-groups", "2"]),
    ("train", ["--lora-merge-every", "2"], []),
    ("init", ["--lora-rank", "4"], [])])
def test_lora_flags_do_in_train_and_init_what_jax_s_do(cmd, flag, rest,
                                                       tmp_path, capsys):
    """The ``--lora-*`` flags, refused until LoRA was ported, reach the
    config as JAX's; ``train`` with a rank raises JAX's ``ValueError``
    (LoRA runs on the socket plane only), without one it trains as without
    the flags, and ``init`` writes the same model file, as JAX's."""
    base = TINY if cmd == "train" else ["--config", "mnist_mlp_fedavg"]
    argv = [*base, *rest, *flag]
    out = [] if cmd == "train" else ["--out", "g.npz"]
    ours = cli.config_from_args(cli.build_parser().parse_args(
        [cmd, *argv, *out]))
    parser = argparse.ArgumentParser()
    jax_cli._add_override_flags(parser)
    theirs = jax_cli.config_from_args(parser.parse_args(argv))
    assert vars(ours.fed) == vars(theirs.fed)
    if cmd == "init":
        files = []
        for extra in (flag, []):
            out = str(tmp_path / f"g{len(files)}.npz")
            cli.main(["init", "--backend", "cpu", "--config",
                      "mnist_mlp_fedavg", *extra, "--out", out])
            files.append(np.load(out))
        assert sorted(files[0]) == sorted(files[1])
        for key in files[1]:
            assert files[0][key].tobytes() == files[1][key].tobytes()
        return
    if ours.fed.lora_rank > 0:
        for main in (cli.main, jax_cli.main):
            with pytest.raises(ValueError,
                               match="requires the socket federation plane"):
                main(["train", "--backend", "cpu", *argv])
        return
    with_flag = cli.main(["train", "--backend", "cpu", *argv])
    without = cli.main(["train", "--backend", "cpu", *base, *rest])
    capsys.readouterr()
    assert with_flag["final_loss"] == without["final_loss"]


@pytest.mark.parametrize("flag", ["--health-dir", "--trace-dir"])
def test_telemetry_override_runs_as_jax(flag, tmp_path, capsys):
    """``--health-dir`` and ``--trace-dir`` were refused until the
    telemetry core was ported.  On ``train`` the ledger flag changes
    nothing (only the socket plane keeps ledgers, in JAX too); the trace
    flag writes a trace that JAX's loader reads, named in the summary."""
    where = str(tmp_path / "out")
    with_flag = cli.main(["train", "--backend", "cpu", *TINY, flag, where])
    plain = cli.main(["train", "--backend", "cpu", *TINY])
    capsys.readouterr()
    assert with_flag["final_loss"] == plain["final_loss"]
    if flag == "--health-dir":
        assert "trace_file" not in with_flag
        assert not (tmp_path / "out").exists()
        return
    from colearn_federated_learning_tpu import telemetry as jax_telemetry

    assert with_flag["trace_file"] == str(
        tmp_path / "out" / "mnist_mlp_fedavg_trace.json")
    spans = jax_telemetry.trace_spans(
        jax_telemetry.load_trace(with_flag["trace_file"]))
    assert sorted(sp.name for sp in spans) == [
        "client_update", "evaluate", "round", "sync_metrics"]


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
# faults/, with a value of their type.  All are ported: ``train`` (the
# simulation role) parses each into the config as JAX does and runs
# without reading it.
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
    """Every comm-plane flag, the aggregator tree's and the buffered-async
    tree's interval included (refused until the asynchronous coordinator
    was ported), reaches the config as in JAX and ``train`` runs, or its
    value is refused by the parser as JAX's refuses it."""
    argv = ["train", "--backend", "cpu", *TINY, flag, value]
    parser = argparse.ArgumentParser()
    jax_cli._add_override_flags(parser)
    try:
        jax_args = parser.parse_args([*TINY, flag, value])
    except SystemExit:
        capsys.readouterr()
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code == 2
        assert f"argument {flag}: invalid choice" in capsys.readouterr().err
        return
    ours = cli.config_from_args(cli.build_parser().parse_args(argv))
    theirs = jax_cli.config_from_args(jax_args)
    for section in ("fed", "data", "model"):
        assert vars(getattr(ours, section)) == vars(getattr(theirs, section))
    for key, val in vars(theirs.run).items():
        if key in vars(ours.run) and key != "backend":
            assert getattr(ours.run, key) == val, key
    summary = cli.main(argv)
    assert summary["rounds"] == 1 and summary["device"] == "cpu"


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


@pytest.mark.parametrize("argv,keys", [
    (["eval", "--global-model", "g.npz", "--detection-eval"],
     ["detection_rate", "false_alarm_rate", "macro_f1",
      "per_class_f1"])])
def test_file_plane_refusals_name_their_items(argv, keys, capsys, tmp_path,
                                              monkeypatch):
    """``eval --detection-eval``, refused until item 10b was ported, adds
    JAX's detection view (``tests/test_torch_port_detection.py`` holds
    its values to JAX's)."""
    monkeypatch.chdir(tmp_path)
    cli.main(["init", "--backend", "cpu", *TINY, "--out", "g.npz"])
    out = cli.main([argv[0], "--backend", "cpu", *TINY, *argv[1:]])
    capsys.readouterr()
    assert set(keys) <= set(out) and "accuracy" not in out
    assert out["round"] == 0 and np.isfinite(out["eval_loss"])


def test_file_plane_takes_the_tree_flags_as_jax(tmp_path, capsys):
    """``--num-aggregators`` and ``--agg-heartbeat-timeout`` are taken by
    every command whose JAX parser takes them; only ``coordinate`` reads
    them, so the file plane runs as without them."""
    tree = ["--num-aggregators", "2", "--agg-heartbeat-timeout", "1.0"]
    g0, u0 = str(tmp_path / "g0.npz"), str(tmp_path / "u0.npz")
    base = ["--backend", "cpu", *TINY]
    cli.main(["init", *base, *tree, "--out", g0])
    cli.main(["train", *base, *tree, "--role", "client", "--client-id", "0",
              "--global-model", g0, "--out", u0])
    out = {}
    for name, extra in (("tree", tree), ("plain", [])):
        out[name] = str(tmp_path / f"g1_{name}.npz")
        cli.main(["aggregate", *base, *extra, "--global-model", g0,
                  "--updates", u0, "--out", out[name]])
    capsys.readouterr()
    a, b = (np.load(out[n]) for n in ("tree", "plain"))
    assert sorted(a.files) == sorted(b.files)
    assert all(np.array_equal(a[k], b[k]) for k in a.files)


def test_file_plane_commands_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["init", "--out", str(tmp_path / "g.npz")])


@pytest.mark.parametrize("cmd", ["broker", "worker", "aggregator",
                                 "coordinate", "chaos", "postmortem"])
def test_every_jax_flag_of_the_socket_plane_is_accepted(cmd):
    ours = set(cli.build_parser()._subparsers._group_actions[0]
               .choices[cmd]._option_string_actions)
    theirs = _jax_flags(cmd)
    assert theirs and theirs <= ours, sorted(theirs - ours)


def _served(argv, tmp_path, between=None):
    """Run a serving command (``broker``, ``worker``) as a process with
    ``--metrics-port 0 --events-file``: its announced exporter answers
    ``/metrics``, and SIGTERM (after ``between()``) stops it with exit 0
    after a ``stop`` event.  Returns (exit code, event kinds, the
    /metrics body)."""
    import os
    import signal
    import subprocess
    import sys
    import urllib.request

    import time

    events = tmp_path / "events.jsonl"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    err_path = tmp_path / "stderr.txt"
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "colearn_federated_learning_tpu_torch.cli",
             *argv, "--metrics-port", "0", "--events-file", str(events)],
            stdout=subprocess.DEVNULL, stderr=err, env=env,
            cwd=str(tmp_path))
    try:
        port, deadline = None, time.monotonic() + 60
        while port is None and time.monotonic() < deadline:
            for line in err_path.read_text().splitlines():
                if line.startswith('{"event": "metrics_port"'):
                    port = json.loads(line)["port"]
            time.sleep(0.1)
        assert port, "no metrics_port event"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            body = r.read().decode()
        if between is not None:
            between()
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    kinds = [json.loads(ln)["event"] for ln in
             events.read_text().splitlines()]
    return code, kinds, body


@pytest.mark.parametrize("argv,role", [
    (["coordinate", "--events-file", "e.jsonl"], "coordinator"),
    (["worker", "--client-id", "0", "--metrics-port", "9"], "worker0"),
    (["broker", "--events-file", "e.jsonl"], "broker")])
def test_socket_plane_refusals_name_their_items(argv, role, capsys, tmp_path,
                                                monkeypatch):
    """``--metrics-port`` and ``--events-file``, refused until item 10b
    was ported, run on ``broker``, ``worker`` and ``coordinate``: the
    exporter serves while the process does, and the event log holds a
    ``start`` line, the coordinator's ``round`` lines and a ``stop``
    line (JAX's broker writes the ``stop``; the port's every role)."""
    from colearn_federated_learning_tpu_torch.comm.broker import (
        MessageBroker)
    from colearn_federated_learning_tpu_torch.comm.worker import DeviceWorker

    monkeypatch.chdir(tmp_path)
    with MessageBroker() as b:
        base = ["--backend", "cpu", *TINY, "--broker-port", str(b.port)]
        if argv[0] == "broker":
            code, kinds, body = _served(["broker"], tmp_path)
        elif argv[0] == "worker":
            def enroll():
                # A worker serves (and stops on SIGTERM) once it has a role.
                from colearn_federated_learning_tpu_torch.comm.coordinator \
                    import FederatedCoordinator

                cfg = cli.config_from_args(cli.build_parser().parse_args(
                    ["worker", *base, "--client-id", "0"]))
                with FederatedCoordinator(cfg, b.host, b.port,
                                          want_evaluator=False,
                                          device="cpu") as coord:
                    coord.enroll(min_devices=1, timeout=60)
                    time.sleep(1.0)

            import time

            code, kinds, body = _served(["worker", *base, *argv[1:3]],
                                        tmp_path, between=enroll)
        else:
            cfg = cli.config_from_args(cli.build_parser().parse_args(
                ["coordinate", *base]))
            workers = [DeviceWorker(cfg, i, b.host, b.port,
                                    device="cpu").start() for i in range(2)]
            try:
                rec = cli.main(["coordinate", *base, "--min-devices", "2",
                                "--no-evaluator", "--metrics-port", "0",
                                "--learn-observe", *argv[1:]])
            finally:
                for w in workers:
                    w.stop()
            err = capsys.readouterr().err.splitlines()
            port = json.loads(err[0])["port"]
            kinds = [json.loads(ln)["event"] for ln in
                     (tmp_path / "e.jsonl").read_text().splitlines()]
            assert {"conv_update_norm", "conv_trend"} <= set(rec)
            import urllib.error
            import urllib.request

            with pytest.raises(urllib.error.URLError):   # closed on exit
                urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                       timeout=5)
            code, body = 0, "colearn_"
    assert code == 0
    assert kinds[0] == "start" and kinds[-1] == "stop"
    if argv[0] == "coordinate":
        assert kinds == ["start", "round", "stop"]
    assert "colearn_" in body or body == ""


# The asynchronous coordinator's flags, refused until it was ported: each
# is parsed as JAX's parser parses it, and nothing refuses it.
ASYNC_ARGV = [
    ["train", *TINY, "--agg-buffer-interval", "1.5"],
    ["aggregate", "--global-model", "g.npz", "--updates", "u.npz", "--out",
     "g1.npz", "--agg-buffer-interval", "2.5"],
    ["train", "--role", "client", "--client-id", "0", "--global-model",
     "g.npz", "--out", "u.npz", "--agg-buffer-interval", "1.0"],
    ["coordinate", "--broker-port", "1", "--agg-buffer-interval", "1.0"],
    ["coordinate", "--broker-port", "1", "--async-buffer", "4"],
    ["coordinate", "--broker-port", "1", "--async-buffer", "auto"],
    ["coordinate", "--broker-port", "1", "--async-observe",
     "--async-prune-after", "3", "--async-prune-score", "2.5",
     "--async-probation", "4"]]
ASYNC_DESTS = ("async_buffer", "async_observe", "async_prune_after",
               "async_prune_score", "async_probation")


def _jax_args(argv):
    """JAX's parser's namespace for ``argv``."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def keep(parser, args=None, namespace=None):
        seen["args"] = real(parser, args, namespace)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = keep
    try:
        with pytest.raises(SystemExit):
            jax_cli.main(argv)
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen["args"]


@pytest.mark.parametrize("argv", ASYNC_ARGV,
                         ids=lambda a: "-".join(a[:1] + a[-2:]))
def test_async_flags_are_accepted_as_jax(argv):
    ours = cli.build_parser().parse_args([*argv, "--backend", "cpu"])
    theirs = _jax_args(argv)
    for dest in ASYNC_DESTS + ("agg_buffer_interval_s",):
        if hasattr(theirs, dest):
            assert getattr(ours, dest) == getattr(theirs, dest), dest
    if argv[0] == "coordinate":
        assert cli.build_parser().parse_args(
            ["coordinate", "--broker-port", "1"]).async_buffer == 0
        return
    assert (cli.config_from_args(ours).run.agg_buffer_interval_s
            == jax_cli.config_from_args(theirs).run.agg_buffer_interval_s
            != RunConfig().agg_buffer_interval_s)


def test_async_buffer_refuses_what_jax_refuses(capsys):
    """``--async-buffer`` takes an integer or ``auto``, as JAX's."""
    argv = ["coordinate", "--broker-port", "1", "--async-buffer", "many"]
    with pytest.raises(SystemExit):
        jax_cli.main(argv)
    theirs = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2
    ours = capsys.readouterr().err.strip().splitlines()[-1]
    assert ours.split(": ", 1)[1] == theirs.split(": ", 1)[1]


def test_aggregator_requires_an_agg_id_as_jax(capsys):
    argv = ["aggregator", "--broker-port", "1", "--backend", "cpu"]
    assert jax_cli.main(argv) == 2
    theirs = capsys.readouterr().err.strip()
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2
    assert capsys.readouterr().err.strip() == theirs


def test_socket_plane_commands_raise_without_a_card(monkeypatch):
    """A worker, an aggregator with ``--fold-device`` or a coordinator
    (``--fold-device`` or not) built for the card without one raises;
    none moves to the CPU by itself."""
    from colearn_federated_learning_tpu_torch.comm.broker import MessageBroker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with MessageBroker() as b:
        for argv in (["worker", "--client-id", "0"],
                     ["aggregator", "--agg-id", "0", "--fold-device"],
                     ["coordinate", "--fold-device"], ["coordinate"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main([*argv, *TINY, "--broker-port", str(b.port)])


@pytest.mark.parametrize("flag,value", [("--compress", "gzip"),
                                        ("--compress-down", "topk8")])
def test_codec_flags_take_the_jax_parsers_choices(flag, value, capsys):
    """A codec the JAX parser refuses, the port's refuses (exit 2)."""
    parser = argparse.ArgumentParser()
    jax_cli._add_override_flags(parser)
    with pytest.raises(SystemExit) as theirs:
        parser.parse_args([*TINY, flag, value])
    with pytest.raises(SystemExit) as ours:
        cli.main(["train", "--backend", "cpu", *TINY, flag, value])
    assert ours.value.code == theirs.value.code == 2
    assert f"argument {flag}: invalid choice" in capsys.readouterr().err


def _subcommands(main) -> set:
    out = io.StringIO()
    with redirect_stdout(out), pytest.raises(SystemExit):
        main(["--help"])
    return set(re.search(r"\{([a-z,-]+)\}", out.getvalue()).group(1)
               .split(","))


def test_every_jax_subcommand_is_ported_or_refused():
    """Every JAX subcommand is the port's too, and none is refused any
    more: the last two, ``lint`` and ``sentinel``, run since item 17."""
    theirs = _subcommands(jax_cli.main)
    assert _subcommands(cli.main) == theirs
    assert not hasattr(cli, "_UNPORTED_COMMANDS")
    assert {"lint", "sentinel"} < theirs


def test_configs_prints_the_jax_lines(capsys):
    assert jax_cli.main(["configs"]) == 0
    theirs = capsys.readouterr().out
    assert cli.main(["configs"]) is None
    ours = capsys.readouterr().out
    assert ours.splitlines() == theirs.splitlines() and len(ours) > 0


@pytest.mark.parametrize("argv,item", [
    (["top", "--once", "--url", "http://127.0.0.1:1/snapshot.json"], None),
    (["converge", "r.jsonl"], None)])
def test_unported_commands_exit_naming_their_items(argv, item, capsys,
                                                   tmp_path, monkeypatch):
    """``top`` and ``converge``, refused until item 10b was ported, run
    and exit with JAX's codes (nothing to fetch: 1; nothing to read: 2).
    ``lint`` and ``sentinel``, refused until item 17, run in the cases
    below."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    err = capsys.readouterr().err
    assert item is None
    assert exc.value.code == jax_cli.main(argv) != 0
    assert f"colearn {argv[0]}: " in err


def _exit_of(main, argv) -> int:
    """A command's exit code: JAX's ``main`` returns it, the port's raises
    SystemExit on a non-zero one."""
    try:
        rc = main(argv)
    except SystemExit as e:
        return e.code
    return 0 if main is cli.main else rc


@pytest.mark.parametrize("argv,code", [
    (["lint", "pkg/comm/mod.py", "--root", "."], 1),
    (["lint", "pkg/comm/mod.py", "--root", ".", "--format", "json"], 1),
    (["lint", "pkg/fed/mod.py", "--root", "."], 0),
    (["lint", "pkg", "--root", ".", "--disable", "CL002"], 0),
    (["lint", "pkg", "--root", ".", "--rules", "CL002,CL003"], 1),
    (["lint", "pkg", "--root", ".", "--rules", "CL999"], 2),
    (["sentinel"], 0),
    (["sentinel", "--format", "json"], 0),
    (["sentinel", "--root", "r"], 0),
    (["sentinel", "--root", "r", "--format", "json"], 0)])
def test_lint_and_sentinel_run_where_they_were_refused(argv, code, capsys,
                                                      tmp_path, monkeypatch):
    """``lint`` and ``sentinel`` were refused naming item 17 until the
    analysis tools were ported: they now run in a scratch root (a comm
    file with a finding, a clean fed file; a bare root without rules and a
    root ``r`` with one kept rule; without ``--root`` the command falls
    back to the package's parent, the repo) and give JAX's exit codes and
    text (the unknown rule's message lists the port's ids, JAX's less
    CL001; ``tests/test_torch_port_lint.py`` and
    ``test_torch_port_sentinel.py`` hold them to JAX's further)."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "pkg" / "comm").mkdir(parents=True)
    (tmp_path / "pkg" / "fed").mkdir()
    (tmp_path / "pkg" / "comm" / "mod.py").write_text(
        "def drain(sock):\n    return sock.recv(4)\n")
    (tmp_path / "pkg" / "fed" / "mod.py").write_text("X = 1\n")
    (tmp_path / "r" / "results").mkdir(parents=True)
    (tmp_path / "r" / "pyproject.toml").write_text(
        '[[tool.colearn.slo.rules]]\nid = "n"\nfile = "results/f.jsonl"\n'
        'agg = "count"\nmin = 1\n')
    (tmp_path / "r" / "results" / "f.jsonl").write_text('{"x": 1}\n')
    ours = _exit_of(cli.main, argv)
    out = capsys.readouterr()
    assert ours == _exit_of(jax_cli.main, argv) == code
    theirs = capsys.readouterr()
    if code == 2:
        assert out.err.startswith("colearn lint: unknown lint rule 'CL999'")
        assert out.err.replace("['CL002'", "['CL001', 'CL002'") == theirs.err
    else:
        assert (out.out, out.err) == (theirs.out, theirs.err)


def test_fleetsim_runs_where_it_was_refused(capsys):
    """``fleetsim`` was refused naming item 9b until the fleet simulator
    was ported: it now runs (``tests/test_torch_port_fleetsim.py`` holds
    it to JAX's), and so does ``--learn-observe`` since item 10b
    (``tests/test_torch_port_convergence.py``)."""
    out = cli.main(["fleetsim", "--devices", "64", "--cohort", "8",
                    "--rounds", "1", "--chunk", "8", "--backend", "cpu"])
    assert out["rounds"] == 1 and out["clients_trained"] == 8
    observed = cli.main(["fleetsim", "--devices", "64", "--cohort", "8",
                         "--rounds", "1", "--chunk", "8", "--backend",
                         "cpu", "--learn-observe"])
    assert observed == {**out, "rounds_per_sec": observed["rounds_per_sec"],
                        "clients_per_sec": observed["clients_per_sec"]}
    recs = [json.loads(ln) for ln in capsys.readouterr().err.splitlines()
            if ln.startswith('{"train_loss"')]
    assert not any(k.startswith("conv_") for k in recs[0])
    assert "conv_cohort_skew" in recs[1]


# ``chaos --ckpt`` was refused naming item 15 (the three cases above)
# until its soak was ported: a budget under 3 rounds now raises JAX's
# ValueError, and the command runs the soak with JAX's defaults.
@pytest.mark.parametrize("argv", [
    ["chaos", "--rounds", "2", "--ckpt", "--no-faults"],
    ["chaos", "--rounds", "2", "--ckpt"]])
def test_chaos_ckpt_refuses_a_short_budget_as_jax(argv):
    with pytest.raises(ValueError) as theirs:
        jax_cli.main(argv)
    with pytest.raises(ValueError) as ours:
        cli.main(argv + ["--backend", "cpu"])
    assert str(ours.value) == str(theirs.value)
    assert "needs >= 3 rounds" in str(ours.value)


def test_chaos_ckpt_runs_the_soak_with_jax_s_defaults(monkeypatch):
    from colearn_federated_learning_tpu_torch.faults import procsoak

    seen = []

    def fake(**kw):
        seen.append(kw)
        return {"mode": "smoke", "exit_code": 0, "resume_exit_code": 0,
                "rounds_run": kw["rounds"], "resume_round_ok": True,
                "digest_ok": True, "reshard_ok": True}

    monkeypatch.setattr(procsoak, "run_ckpt_soak", fake)
    assert cli.main(["chaos", "--ckpt", "--no-faults"])["mode"] == "smoke"
    (kw,) = seen
    assert (kw["rounds"], kw["n_workers"], kw["kill"], kw["backend"],
            kw["round_timeout"], kw["timeout_s"]) == (
        10, 4, False, "gpu", 120.0, 600.0)


def _telemetry_files(tmp_path):
    """A trace with nested spans of two processes, and a health directory
    of two ledgers (an aggregator's and the coordinator's), written by the
    port."""
    from colearn_federated_learning_tpu_torch import telemetry

    tracer = telemetry.Tracer(process="coordinator")
    for r in range(2):
        with tracer.span("round", round=r):
            with tracer.span("broadcast_collect", cohort=3):
                with tracer.span("worker.train", client_id=1):
                    pass
            with tracer.span("aggregate"):
                pass
    trace = telemetry.write_tracer(str(tmp_path), "run", tracer,
                                   metrics={"fed.rounds_total": 2.0})
    health_dir = tmp_path / "health"
    for source, agg in (("coordinator", None), ("aggregator0", "0")):
        ledger = telemetry.HealthLedger(str(health_dir), source)
        for r in range(3):
            for d in range(3):
                ledger.record(str(d), round=r, agg=agg,
                              latency_s=0.1 * (d + 1) + 0.01 * r,
                              deadline_miss=int(d == 2 and r == 1))
        ledger.flush()
        ledger.close()
    (tmp_path / "empty").mkdir()
    return {"trace": trace, "missing": str(tmp_path / "nope.json"),
            "health": str(health_dir), "empty": str(tmp_path / "empty")}


@pytest.mark.parametrize("argv", [
    ["trace-summary", "trace"], ["trace-summary", "trace", "--root",
                                 "broadcast_collect"],
    ["trace-summary", "missing"], ["health", "health"],
    ["health", "health", "--format", "json", "--top", "2"],
    ["health", "empty"]])
def test_trace_summary_and_health_print_jax_text(argv, tmp_path, capsys):
    """``trace-summary`` and ``health`` were refused until the telemetry
    core was ported; now they print the JAX commands' text for the same
    files and exit with their codes (0, 2 for an unreadable trace, 1 for
    a health directory with no device)."""
    files = _telemetry_files(tmp_path)
    argv = [argv[0], *(files.get(a, a) for a in argv[1:])]
    rc_jax = jax_cli.main(argv)
    theirs = capsys.readouterr()
    try:
        cli.main(argv)
        rc = 0
    except SystemExit as e:
        rc = e.code
    ours = capsys.readouterr()
    assert rc == rc_jax
    assert (ours.out, ours.err) == (theirs.out, theirs.err)
    assert (ours.out or ours.err).strip()
