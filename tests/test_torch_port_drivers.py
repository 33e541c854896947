"""The port's last drivers against the JAX package's scripts.

- ``torch_port_trace_smoke.py`` on the CPU: JAX's ``REQUIRED_PHASES``
  present and coverage >= 0.95.
- The copies of ``check_soak``, ``check_proc_soak`` and the Prometheus
  grammar oracle give JAX's verdicts on the same passing and failing
  inputs (``tests/test_procsoak.py::test_check_proc_soak_gate``'s cases
  among them); both soak scripts pass their gates on the CPU.
- ``scaled_variants()`` equals JAX's, field by field; one
  ``run_baseline_configs --only mnist_mlp_fedavg --rounds 1`` writes JAX's
  meta line and record keys.
- ``record_dryrun`` writes JAX's record keys; the obs smoke's classic
  phase passes on the CPU; the lint wrapper exits 0; the literature script
  exits 3 with JAX's message without MNIST on disk.
"""

import ast
import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from colearn_federated_learning_tpu.fed import FederatedLearner as JaxLearner
from colearn_federated_learning_tpu.faults.procsoak import (
    KillSpec as JaxKillSpec)
from colearn_federated_learning_tpu_torch import telemetry
from colearn_federated_learning_tpu_torch.faults.procsoak import KillSpec

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _script(name: str):
    path = ROOT / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{name}_script", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_functions(name: str, functions: tuple) -> dict:
    """``functions`` of a JAX script, executed alone: the script's module
    body (a compile cache, a platform switch) does not run."""
    tree = ast.parse((ROOT / "scripts" / f"{name}.py").read_text())
    body = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in functions]
    ns = {"dataclasses": dataclasses}
    exec(compile(ast.Module(body=body, type_ignores=[]), name, "exec"), ns)
    return ns


# --------------------------------------------------------- trace smoke
def test_trace_smoke_has_jax_phases_and_coverage(tmp_path):
    ours, theirs = _script("torch_port_trace_smoke"), _script("trace_smoke")
    assert ours.REQUIRED_PHASES == theirs.REQUIRED_PHASES
    out = ours.main(str(tmp_path), device="cpu")
    assert set(out["phases"]) >= theirs.REQUIRED_PHASES
    assert out["coverage"] >= 0.95 and out["device"] == "cpu"
    assert out["trace_file"].startswith(str(tmp_path))


# --------------------------------------------------------- soak gates
def _soak(**over):
    s = dict(rounds_run=6, skipped_rounds=[2], evicted=["3"],
             weighted_acc=0.9, per_client_acc={"0": 0.9, "1": 0.9},
             counters={"fault.injected_total": 5, "comm.retry_total": 2,
                       "comm.corrupt_frames_total": 1})
    s.update(over)
    return s


SOAK_CASES = {
    "pass": (_soak(skipped_rounds=[]), _soak()),
    "lost_records": (_soak(skipped_rounds=[]), _soak(rounds_run=5)),
    "baseline_skipped": (_soak(), _soak()),
    "unexpected_skip": (_soak(skipped_rounds=[]), _soak(skipped_rounds=[2, 4])),
    "no_quorum_skip": (_soak(skipped_rounds=[]), _soak(skipped_rounds=[])),
    "plan_silent": (_soak(skipped_rounds=[]), _soak(counters={
        "fault.injected_total": 0, "comm.retry_total": 0,
        "comm.corrupt_frames_total": 0})),
    "not_evicted": (_soak(skipped_rounds=[]), _soak(evicted=[])),
    "no_accuracy": (_soak(skipped_rounds=[]), _soak(weighted_acc=None)),
    "drift": (_soak(skipped_rounds=[]), _soak(per_client_acc={"0": 0.2,
                                                              "1": 0.2})),
    "drift_all": (_soak(skipped_rounds=[], per_client_acc={}),
                  _soak(per_client_acc={}, weighted_acc=0.5)),
}


@pytest.mark.parametrize("case", list(SOAK_CASES))
def test_check_soak_copy_gives_jax_verdicts(case):
    base, faulted = SOAK_CASES[case]
    ours = _script("torch_port_chaos_soak").check_soak(base, faulted, 6, 0.1)
    theirs = _script("chaos_soak").check_soak(base, faulted, 6, 0.1)
    assert ours == theirs
    assert (ours == []) == (case == "pass")


def _summary(**over):            # tests/test_procsoak.py:76
    base = dict(exit_code=0, rounds_run=3, rounds_resumed=0, kills=[],
                weighted_acc=0.8, per_client_acc={"0": 0.8, "1": 0.8})
    base.update(over)
    return base


KILLED = [{"target": "coordinator", "fired_after_round": 0}]
PROC_CASES = {                   # tests/test_procsoak.py:85 and more
    "ok": (_summary(), _summary(rounds_resumed=1, kills=KILLED), "ok"),
    "never_resumed": (_summary(), _summary(kills=KILLED), "never resumed"),
    "rounds_lost": (_summary(), _summary(rounds_run=2, rounds_resumed=1,
                                         kills=[{"target": "coordinator"}]),
                    "rounds were lost"),
    "drifted": (_summary(), _summary(
        rounds_resumed=1, kills=[{"target": "coordinator"}],
        per_client_acc={"0": 0.1, "1": 0.1}, weighted_acc=0.1), "drifted"),
    "baseline_resumed": (_summary(rounds_resumed=1),
                         _summary(rounds_resumed=1, kills=[{"t": 1}]),
                         "baseline resumed"),
    "bad_exit": (_summary(exit_code=-9), _summary(rounds_resumed=1,
                                                  kills=KILLED),
                 "coordinator exited"),
    "kills_missing": (_summary(), _summary(rounds_resumed=1),
                      "scheduled kills"),
    "no_accuracy": (_summary(), _summary(rounds_resumed=1, kills=KILLED,
                                         weighted_acc=None),
                    "missing final accuracy"),
}


@pytest.mark.parametrize("case", list(PROC_CASES))
def test_check_proc_soak_copy_gives_jax_verdicts(case):
    base, faulted, want = PROC_CASES[case]
    ours = _script("torch_port_chaos_soak_mp").check_proc_soak(
        base, faulted, rounds=3, tol=0.1,
        kills=[KillSpec("coordinator", after_round=0)])
    theirs = _script("chaos_soak_mp").check_proc_soak(
        base, faulted, rounds=3, tol=0.1,
        kills=[JaxKillSpec("coordinator", after_round=0)])
    assert ours == theirs
    assert ours == [] if want == "ok" else any(want in p for p in ours)


def test_soak_scripts_pass_their_gates_on_the_cpu(capsys):
    assert _script("torch_port_chaos_soak").main(["--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["problems"] == []
    assert _script("torch_port_chaos_soak_mp").main(
        ["--rounds", "3", "--num-workers", "2", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["problems"] == [] and out["faulted"]["rounds_resumed"] >= 1


# ------------------------------------------------------ grammar oracle
def test_grammar_oracle_copy_gives_jax_verdicts():
    ours, theirs = _script("torch_port_obs_smoke"), _script("obs_smoke")
    assert ours._PROM_LINE.pattern == theirs._PROM_LINE.pattern
    reg = telemetry.MetricsRegistry()
    reg.counter("fed.rounds_total").inc(3)
    reg.gauge("comm.server_bytes_per_chip").set(1.5e9)
    reg.histogram("fed.phase_time_s", labels={"phase": "fold"}).observe(0.2)
    lines = telemetry.prometheus_text(reg.typed_snapshot()).splitlines() + [
        "colearn_x 1", "colearn_x{a=\"b\"} -2.5e-3", "colearn_x NaN",
        "colearn_x +Inf", "# HELP colearn_x help text", "# TYPE colearn_x",
        "colearn x 1", "colearn_x{a=\"b\"", "9colearn 1", "colearn_x one",
        "colearn_x{a={b}} 1", "", "# COMMENT other"]
    verdicts = [bool(ours._PROM_LINE.match(ln)) for ln in lines]
    assert verdicts == [bool(theirs._PROM_LINE.match(ln)) for ln in lines]
    assert any(verdicts) and not all(verdicts)
    assert ours.bad_lines("colearn_x 1\n\ncolearn x 1\n") == (
        ["colearn_x 1", "colearn x 1"], ["colearn x 1"])


def test_obs_smoke_refuses_unknown_phases_as_jax():
    ours = _script("torch_port_obs_smoke")
    assert set(ours._PHASES) == set(_script("obs_smoke")._PHASES)
    assert ours.main(["nope"]) == 2
    assert ours.main(["--device", "tpu"]) == 2


def test_obs_smoke_classic_phase_on_the_cpu():
    """The classic phase alone takes ~11 s on the CPU: broker, 2 workers
    and a coordinator as processes, the scrape, top, the SIGKILL dump,
    the event stream and postmortem."""
    assert _script("torch_port_obs_smoke").main(
        ["--device", "cpu", "classic"]) == 0


# -------------------------------------------------- baseline variants
def _fields(cfg) -> dict:
    return {s: dataclasses.asdict(getattr(cfg, s))
            for s in ("data", "model", "fed", "run")}


def test_scaled_variants_equal_jax_field_by_field():
    ns = _jax_functions("run_baseline_configs",
                        ("_vit_tiny7", "scaled_variants"))
    theirs = ns["scaled_variants"]()
    ours = _script("torch_port_run_baseline_configs").scaled_variants()
    assert list(ours) == list(theirs) and len(ours) == 10
    for name, (cfg, note) in ours.items():
        jcfg, jnote = theirs[name]
        assert note == jnote, name
        assert _fields(cfg) == _fields(jcfg), name


def test_run_baseline_configs_writes_jax_meta_and_records(tmp_path, capsys):
    mod = _script("torch_port_run_baseline_configs")
    assert mod.main(["--only", "mnist_mlp_fedavg", "--rounds", "1",
                     "--device", "cpu", "--out", str(tmp_path)]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert [s["config"] for s in summary] == ["mnist_mlp_fedavg"]
    meta, *records = [json.loads(ln) for ln in
                      (tmp_path / "mnist_mlp_fedavg.jsonl").read_text()
                      .splitlines()]
    assert set(meta) == {"config", "note", "device", "platform",
                         "num_clients", "cohort", "local_steps", "rounds"}
    assert (meta["device"], meta["platform"], meta["rounds"]) == (
        "cpu", "cpu", 1)
    jcfg = _jax_functions("run_baseline_configs", ("_vit_tiny7",
                                                   "scaled_variants"))[
        "scaled_variants"]()["mnist_mlp_fedavg"][0]
    jcfg = jcfg.replace(fed=dataclasses.replace(jcfg.fed, rounds=1))
    jl = JaxLearner(jcfg)
    want = []
    jl.fit(log_fn=want.append)
    assert (meta["num_clients"], meta["cohort"], meta["local_steps"]) == (
        jl.num_clients, jl.cohort_size, jl.num_steps)
    assert len(records) == len(want) == 1
    assert set(records[0]) == set(want[0])
    assert np.isfinite(records[0]["train_loss"])


def test_run_baseline_configs_overrides_and_selection():
    """``--only`` takes several variants (run in the variants' order);
    each override lands in the config and in the meta line's note;
    ``--attn-impl`` touches the transformer variants alone."""
    mod = _script("torch_port_run_baseline_configs")
    picked = mod.select(mod.build_parser().parse_args([
        "--only", "agnews_bert_fedavg,mnist_mlp_fedavg", "--rounds", "1",
        "--cohort", "5", "--attn-impl", "flash"]))
    assert [name for name, _, _ in picked] == ["mnist_mlp_fedavg",
                                               "agnews_bert_fedavg"]
    variants = mod.scaled_variants()
    for name, cfg, note in picked:
        assert (cfg.fed.rounds, cfg.fed.cohort_size) == (1, 5)
        assert note.startswith(variants[name][1])
        assert note.endswith("-> 5 (cut)")
    (_, mlp, mlp_note), (_, bert, bert_note) = picked
    assert mlp.model.attn_impl == "dense" and "attn_impl" not in mlp_note
    assert bert.model.attn_impl == "flash"
    assert "attn_impl dense -> flash" in bert_note


def test_run_baseline_configs_refuses_without_the_card(tmp_path):
    mod = _script("torch_port_run_baseline_configs")
    assert mod.main(["--only", "mnist_mlp_fedavg", "--out",
                     str(tmp_path)]) == 1
    assert not list(tmp_path.iterdir())
    with pytest.raises(SystemExit, match="unknown variant"):
        mod.main(["--only", "nope", "--device", "cpu", "--out",
                  str(tmp_path)])


# ------------------------------------------------------ record_dryrun
def test_record_dryrun_writes_jax_record_keys(tmp_path):
    out = tmp_path / "dryrun.json"
    mod = _script("torch_port_record_dryrun")
    assert mod.main(["--device", "cpu", "2", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert set(doc) == {"recorded_unix", "platform", "runs"}
    (run,) = doc["runs"]
    assert set(run) == {"n_devices", "ok", "rc", "wall_seconds", "meshes"}
    assert (run["n_devices"], run["ok"], run["rc"]) == (2, True, 0)
    assert run["meshes"] == "1-D clients (+2-D if even)"
    assert mod.meshes(8) == ("1-D clients + 3-D (clients, seq, model) "
                             "MoE-BERT")
    assert mod.main(["--out", str(tmp_path / "card.json")]) == 1


# ------------------------------------------------ lint and literature
def test_lint_wrapper_exits_0():
    assert _script("torch_port_lint").main([]) == 0


def _jax_literature_message() -> str:
    tree = ast.parse((ROOT / "scripts" / "validate_literature.py")
                     .read_text())
    return next(n.args[0].value for n in ast.walk(tree)
                if isinstance(n, ast.Call) and getattr(n.func, "id", "")
                == "print" and n.args and isinstance(n.args[0], ast.Constant)
                and "REAL MNIST" in str(n.args[0].value))


def test_literature_script_exits_3_with_jax_message(tmp_path):
    env = dict(os.environ, COLEARN_DATA_DIR=str(tmp_path))
    r = subprocess.run(
        [sys.executable, str(ROOT / "scripts" /
                             "torch_port_validate_literature.py"),
         "--device", "cpu", "--only", "iid", "--out",
         str(tmp_path / "lit.json")],
        capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 3
    assert r.stderr.strip() == _jax_literature_message()
    assert not (tmp_path / "lit.json").exists()
