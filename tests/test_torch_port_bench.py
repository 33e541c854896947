"""The port's headline benchmark (``bench.py``, ``cli bench``) against the
JAX package's: the same workloads and config, one well-formed JSON line
with the JAX bench's keys, no result and a non-zero exit without a card,
and the JAX bench's probe and fallback flags refused."""

import dataclasses
import json

import pytest
import torch

from colearn_federated_learning_tpu import bench as jax_bench
from colearn_federated_learning_tpu_torch import bench, cli

JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "platform",
            "n_devices", "rounds_timed", "seconds_timed",
            "client_samples_per_sec_per_chip"}
CPU_ARGS = ["--backend", "cpu", "--rounds", "1", "--warmup", "0",
            "--min-time", "0", "--skip-baseline"]


@pytest.mark.parametrize("workload", ["TPU_WORKLOAD", "CPU_WORKLOAD"])
def test_workload_and_config_are_jax_fields(workload):
    ours, theirs = getattr(bench, workload), getattr(jax_bench, workload)
    assert ours == theirs
    assert (dataclasses.asdict(bench._make_config(ours))
            == dataclasses.asdict(jax_bench._make_config(theirs)))
    assert bench._metric_name(ours) == jax_bench._metric_name(theirs)
    assert bench._metric_name(bench.TPU_WORKLOAD) == (
        "fedavg_cifar10_cnn_rounds_per_sec")


@pytest.mark.parametrize("entry", ["bench", "cli"])
def test_cpu_bench_prints_one_well_formed_line(entry, capsys):
    out = (bench.main(CPU_ARGS) if entry == "bench"
           else cli.main(["bench", *CPU_ARGS]))
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert set(out) == JAX_KEYS | {"note"}
    assert out["metric"] == "fedavg_mnist_mlp_rounds_per_sec"
    assert out["platform"] == "cpu" and out["n_devices"] == 1
    assert out["rounds_timed"] == 1 and out["value"] > 0
    assert out["vs_baseline"] == 0.0
    assert "--backend cpu" in out["note"]
    assert "round_time_s" in captured.err and "median" in captured.err


def test_bench_without_a_card_exits_nonzero_with_no_result(monkeypatch,
                                                           capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: bench.main([]), lambda: cli.main(["bench"])):
        with pytest.raises(SystemExit) as exc:
            call()
        assert exc.value.code == 1
        captured = capsys.readouterr()
        assert captured.out == "" and "no CUDA device" in captured.err


@pytest.mark.parametrize("flag", [["--probe-timeout", "5"],
                                  ["--probe-budget", "30"], ["--force-cpu"]])
def test_probe_and_fallback_flags_are_refused(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["bench", *CPU_ARGS, *flag])
    assert exc.value.code == 2
    captured = capsys.readouterr()
    assert captured.out == "" and f"{flag[0]} is refused" in captured.err


def test_bench_accepts_the_jax_bench_flags():
    """Every flag of the JAX bench parses, with the JAX defaults."""
    parser = bench.build_parser()
    ours = set(parser._option_string_actions)
    for flag in ("--rounds", "--warmup", "--baseline-rounds",
                 "--skip-baseline", "--probe-timeout", "--probe-budget",
                 "--force-cpu", "--min-time"):
        assert flag in ours
    args = parser.parse_args([])
    assert (args.rounds, args.warmup, args.baseline_rounds,
            args.min_time) == (20, 2, 1, 15.0)
