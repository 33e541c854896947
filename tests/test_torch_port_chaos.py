"""The port's chaos soaks (``faults/soak.py``, ``faults/procsoak.py``) and
its ``chaos`` command, against the JAX package's, on the CPU.

- The plans (``canned_plan``, ``canned_secure_plan``, ``oracle_plan``),
  the kill schedules and ``KillSpec``'s validation, the soak configs
  (field by field, the port's asked for the CPU), the process soak's
  command-line flags and ``strip_timing`` equal JAX's.
- JAX's ``tests/test_chaos_soak.py`` against the port: the canned plan
  meets the acceptance of JAX's ``scripts/chaos_soak.py``, no round record
  is lost, every fault fires and is counted, the crashed worker is
  evicted, and an empty plan leaves the records identical.
- The secure soak under the dropout matrix of JAX's
  ``test_wire_dropout_matrix_exact_recovery``: the recovered aggregates
  equal the plain oracle's and 3 masks are recovered.
- ``chaos``: each mode's gate and exit codes, JAX's conflicts between the
  modes, and the lock witness's gate (``_lock_witness_ok``) on crafted
  summaries with JAX's verdicts.
- The asynchronous soaks: their flags (``_async_config_flags``), fault
  plan, loss tail and tiny-budget refusals are JAX's; every gate key of
  ``--async`` and ``--tree-async`` fails the command when flipped.
- JAX's SIGKILL tests of the process soaks (``tests/test_procsoak.py``)
  stay ``slow``, as in JAX, with a ``--tree-async --lock-witness`` run.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import pathlib

import pytest
import torch

from colearn_federated_learning_tpu.faults import procsoak as jax_procsoak
from colearn_federated_learning_tpu.faults import soak as jax_soak
from colearn_federated_learning_tpu_torch import cli, faults
from colearn_federated_learning_tpu_torch.faults import procsoak, soak
from colearn_federated_learning_tpu_torch.faults.plan import (
    FaultPlan, FaultSpec)

ROUNDS = 10
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The soaks' tensors hold a few thousand entries: one intra-op thread
    keeps the workers from crowding each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_script(name: str):
    path = ROOT / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{name}_script", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------ parity with JAX --
def _plan_doc(plan) -> dict:
    return json.loads(plan.to_json())


@pytest.mark.parametrize("seed", [None, 0, 5])
def test_plans_are_jax_s(seed):
    kw = {} if seed is None else {"seed": seed}
    assert _plan_doc(soak.canned_plan(**kw)) == \
        _plan_doc(jax_soak.canned_plan(**kw))
    ours, theirs = (soak.canned_secure_plan(**kw),
                    jax_soak.canned_secure_plan(**kw))
    assert _plan_doc(ours) == _plan_doc(theirs)
    assert _plan_doc(soak.oracle_plan(ours)) == \
        _plan_doc(jax_soak.oracle_plan(theirs))


def test_oracle_plan_is_jax_s_on_every_op():
    from colearn_federated_learning_tpu.faults.plan import (
        FaultPlan as JaxPlan, FaultSpec as JaxSpec)

    specs = [dict(kind="drop_request", device_id="0", round=1, op="unmask"),
             dict(kind="drop_request", device_id="1", round=2,
                  op="share_setup", count=3),
             dict(kind="delay", device_id="2", round=3, op="train", ms=20),
             dict(kind="corrupt_payload", device_id="3", round=4,
                  op="eval")]
    ours = soak.oracle_plan(FaultPlan([FaultSpec(**s) for s in specs],
                                      seed=3))
    theirs = jax_soak.oracle_plan(JaxPlan([JaxSpec(**s) for s in specs],
                                          seed=3))
    assert _plan_doc(ours) == _plan_doc(theirs)
    assert [f.op for f in ours.faults] == ["train", "train", "eval"]


def test_kill_schedules_are_jax_s():
    for rounds in range(1, 9):
        for n in range(1, 5):
            assert ([dataclasses.asdict(k)
                     for k in procsoak.canned_kill_schedule(rounds, n)]
                    == [dataclasses.asdict(k) for k in
                        jax_procsoak.canned_kill_schedule(rounds, n)])


KILL_CASES = [("worker:3", 0, True), ("coordinator", 2, True),
              ("broker", 1, True), ("aggregator:0", 1, False),
              ("aggregator:1", 0, True), ("async-coordinator", 1, True),
              ("edge", 0, True), ("worker:x", 0, True),
              ("aggregator", 0, True), ("aggregator:x", 0, True),
              ("coordinator", -1, True), ("coordinator", 0, False),
              ("broker", 0, False), ("async-coordinator", 0, False),
              ("worker:", 0, True)]


@pytest.mark.parametrize("target,after,restart", KILL_CASES)
def test_kill_spec_validation_is_jax_s(target, after, restart):
    def outcome(cls):
        try:
            return dataclasses.asdict(cls(target, after_round=after,
                                          restart=restart))
        except ValueError as e:
            return f"ValueError: {e}"

    ours = outcome(procsoak.KillSpec)
    assert ours == outcome(jax_procsoak.KillSpec)
    valid = ("worker:3", "coordinator", "broker", "aggregator:0",
             "aggregator:1", "async-coordinator")
    singleton = target in ("coordinator", "broker", "async-coordinator")
    assert isinstance(ours, dict) == (target in valid and after >= 0
                                      and (restart or not singleton))


def test_canned_schedule_scales_with_run_length():
    short = procsoak.canned_kill_schedule(3, 2)
    assert [k.target for k in short] == ["coordinator"]
    assert short[0].after_round == 0
    full = procsoak.canned_kill_schedule(6, 3)
    assert [k.target for k in full] == ["worker:1", "coordinator", "broker"]
    assert [k.after_round for k in full] == [1, 2, 3]


@pytest.mark.parametrize("name,kw", [
    ("default_soak_config", {}),
    ("default_soak_config", dict(n_workers=3, seed=4,
                                 min_cohort_fraction=0.25, evict_after=3,
                                 comm_retries=1)),
    ("secure_soak_config", {}),
    ("secure_soak_config", dict(n_workers=6, seed=2, comm_retries=0))])
def test_soak_configs_are_jax_s_field_by_field(name, kw):
    theirs = dataclasses.asdict(getattr(jax_soak, name)(**kw))
    ours = getattr(soak, name)(**kw, backend="cpu")
    assert dataclasses.asdict(ours) == theirs
    assert soak.soak_device(ours) == "cpu"
    # Unless asked for the CPU, the port's soak runs on the card.
    on_card = getattr(soak, name)(**kw)
    assert on_card.run.backend == "gpu"
    assert soak.soak_device(on_card) == "cuda"
    assert dataclasses.asdict(dataclasses.replace(
        on_card, run=dataclasses.replace(on_card.run, backend="cpu"))) \
        == theirs


@pytest.mark.parametrize("ckpt", [None, "run/ckpt"])
def test_process_soak_flags_are_jax_s(ckpt):
    assert procsoak._config_flags(6, 3, 2, checkpoint_dir=ckpt,
                                  backend="cpu") == \
        jax_procsoak._config_flags(6, 3, 2, checkpoint_dir=ckpt)
    ours = procsoak._config_flags(6, 3, 2, checkpoint_dir=ckpt)
    assert ours[ours.index("--backend") + 1] == "gpu"


def test_strip_timing_is_jax_s():
    rec = {"round": 3, "completed": 2, "round_time_s": 1.5,
           "phase_broadcast_collect_s": 0.2, "phase_x": 1, "train_loss": 0.5,
           "evicted": ["1"], "skipped_quorum": False}
    assert soak.strip_timing(rec) == jax_soak.strip_timing(rec) == {
        "round": 3, "completed": 2, "train_loss": 0.5, "evicted": ["1"],
        "skipped_quorum": False}


def test_parse_json_is_jax_s():
    for line in ['{"round": 1}', "[1, 2]", "plain log", '{"event": "x"}',
                 "3"]:
        assert procsoak._parse_json(line) == jax_procsoak._parse_json(line)


# --------------------------------------------------- the in-process soak --
@pytest.fixture(scope="module")
def soak_pair():
    base = faults.run_soak(rounds=ROUNDS, backend="cpu")
    faulted = faults.run_soak(rounds=ROUNDS, plan=faults.canned_plan(),
                              backend="cpu")
    return base, faulted


def test_canned_plan_meets_acceptance(soak_pair):
    base, faulted = soak_pair
    problems = _jax_script("chaos_soak").check_soak(base, faulted, ROUNDS,
                                                    tol=0.1)
    assert problems == []


def test_no_round_records_lost(soak_pair):
    for s in soak_pair:
        assert [r["round"] for r in s["records"]] == list(range(ROUNDS))


def test_faulted_run_recovers_and_counts(soak_pair):
    _, faulted = soak_pair
    plan = faults.canned_plan()
    assert set(faulted["faults_fired"]) == set(range(len(plan.faults)))
    assert faulted["counters"]["fault.injected_total"] == sum(
        faulted["faults_fired"].values())
    assert faulted["counters"]["comm.retry_total"] > 0
    assert faulted["counters"]["comm.corrupt_frames_total"] == 1
    assert faulted["counters"]["fed.rounds_skipped_quorum"] == 1
    skipped = [r for r in faulted["records"] if r.get("skipped_quorum")]
    assert [r["round"] for r in skipped] == [2]
    for r in faulted["records"]:
        if not r.get("skipped_quorum"):
            assert r["completed"] >= max(1, r["cohort"] // 2)
    assert faulted["evicted"] == ["3"]
    assert sorted(faulted) == sorted(soak_pair[0])
    labels = {t["label"] for t in faulted["top_faults"]}
    assert labels and all(t["count"] > 0 for t in faulted["top_faults"])
    assert any("crash_worker" in lab for lab in labels)


def test_fault_layer_is_zero_cost_when_disabled():
    kw = dict(rounds=3, n_workers=2, round_timeout=60.0, backend="cpu")
    plain = faults.run_soak(**kw)
    empty = faults.run_soak(plan=faults.FaultPlan([]), **kw)
    assert empty["counters"]["fault.injected_total"] == 0
    a = json.dumps([soak.strip_timing(r) for r in plain["records"]],
                   sort_keys=True)
    b = json.dumps([soak.strip_timing(r) for r in empty["records"]],
                   sort_keys=True)
    assert a == b


def test_soak_rejects_no_rounds():
    with pytest.raises(ValueError, match="rounds"):
        faults.run_soak(rounds=0, backend="cpu")
    with pytest.raises(ValueError, match="rounds"):
        soak.run_secure_soak(rounds=1, backend="cpu")


def test_soak_without_a_card_raises(monkeypatch):
    """The default soak runs on the card and never moves to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        faults.run_soak(rounds=1, n_workers=1)


# ------------------------------------------------------- the secure soak --
def test_wire_dropout_matrix_exact_recovery():
    """JAX's dropout matrix (``tests/test_secure_agg.py``): 0, 1 and 2
    maskers lost mid-train over consecutive rounds; every recovered
    aggregate equals the plain oracle's over the same survivors, and each
    dead masker is one recovered mask.  The faulted rounds' deadline is 4 s
    (JAX's test: 8 s): a dropped request waits it out, twice per faulted
    round (the secure run and the oracle)."""
    plan = FaultPlan([
        FaultSpec(kind="drop_request", device_id="0", round=1, op="train",
                  count=3),
        FaultSpec(kind="drop_request", device_id="1", round=2, op="train",
                  count=3),
        FaultSpec(kind="drop_request", device_id="2", round=2, op="train",
                  count=3),
    ], seed=13)
    summary = soak.run_secure_soak(rounds=4, n_workers=5, plan=plan,
                                   round_timeout=4.0, backend="cpu")
    assert summary["rounds_run"] == 4
    assert summary["oracle_ok"], summary["param_diffs"]
    assert summary["skipped_rounds"] == []
    assert not any(r.get("unmask_failed") for r in summary["records"])
    counters = summary["counters"]
    assert counters["privacy.masks_recovered_total"] == 3
    assert counters["privacy.share_recovery_failures_total"] == 0
    assert counters["fed.rounds_skipped_quorum"] == 0
    assert [r["completed"] for r in summary["records"]] == [5, 4, 3, 5]
    assert [r["completed"] for r in summary["oracle_records"]] == \
        [5, 4, 3, 5]
    assert summary["faults_fired"] == summary["oracle_faults_fired"]


# --------------------------------------------------------------- chaos --
def test_chaos_in_process_gate_passes_and_prints(capsys):
    out = cli.main(["chaos", "--backend", "cpu", "--rounds", "3",
                    "--num-workers", "2", "--no-faults"])
    printed = capsys.readouterr()
    assert json.loads(printed.out.strip().splitlines()[-1]) == \
        json.loads(json.dumps(out))
    assert out["rounds_run"] == 3 and out["weighted_acc"] is not None
    assert out["faults_fired"] == {}
    assert [json.loads(line)["round"]
            for line in printed.err.strip().splitlines()] == [0, 1, 2]


def test_chaos_secure_gate_passes_without_faults(capsys):
    out = cli.main(["chaos", "--secure", "--backend", "cpu", "--rounds",
                    "2", "--num-workers", "3", "--no-faults"])
    capsys.readouterr()
    assert out["oracle_ok"] and out["rounds_run"] == 2
    assert out["counters"]["privacy.masks_recovered_total"] == 0


def _fake(monkeypatch, module, name, summary):
    calls = []

    def fake(**kw):
        calls.append(kw)
        return summary
    monkeypatch.setattr(module, name, fake)
    return calls


MP_OK = dict(exit_code=0, rounds_run=6, weighted_acc=0.9, rounds_resumed=1,
             flight_missing=[], kills=[{"target": "coordinator",
                                        "fired_after_round": 2}])


@pytest.mark.parametrize("bad,code", [
    ({}, None), ({"rounds_resumed": 0}, 1), ({"flight_missing": [7]}, 1),
    ({"exit_code": 3}, 1), ({"rounds_run": 5}, 1),
    ({"weighted_acc": None}, 1)])
def test_chaos_mp_gate(monkeypatch, capsys, bad, code):
    calls = _fake(monkeypatch, procsoak, "run_proc_soak", {**MP_OK, **bad})
    argv = ["chaos", "--mp", "--rounds", "6", "--num-workers", "3",
            "--backend", "cpu"]
    if code is None:
        assert cli.main(argv)["rounds_resumed"] == 1
    else:
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code == code
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1])["rounds_run"] in (5, 6)
    assert "# killed coordinator after round 2" in out.err
    (kw,) = calls
    assert kw["backend"] == "cpu" and kw["rounds"] == 6
    assert [k.target for k in kw["kills"]] == ["worker:1", "coordinator",
                                               "broker"]


AGG_OK = dict(exit_code=0, oracle_exit_code=0, rounds_run=4, oracle_ok=True,
              health_ledger_ok=True, agg_failovers=1,
              postmortem_attributed=True, flight_missing=[])


@pytest.mark.parametrize("bad,no_faults,code", [
    ({}, False, None), ({"agg_failovers": 0}, False, 1),
    ({"agg_failovers": 0, "postmortem_attributed": False}, True, None),
    ({"oracle_ok": False}, False, 1), ({"health_ledger_ok": False}, True, 1),
    ({"flight_missing": [3]}, False, 1)])
def test_chaos_agg_gate(monkeypatch, capsys, bad, no_faults, code):
    calls = _fake(monkeypatch, procsoak, "run_agg_soak", {**AGG_OK, **bad})
    argv = ["chaos", "--agg", "--rounds", "4", "--num-workers", "3"]
    argv += ["--no-faults"] if no_faults else []
    if code is None:
        assert cli.main(argv)["rounds_run"] == 4
    else:
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code == code
    capsys.readouterr()
    assert calls[0]["kill"] is not no_faults
    assert calls[0]["backend"] == "gpu"


def test_chaos_in_process_gate_fails_without_a_score(monkeypatch, capsys):
    _fake(monkeypatch, faults, "run_soak",
          {"rounds_run": 3, "weighted_acc": None, "top_faults": []})
    with pytest.raises(SystemExit) as exc:
        cli.main(["chaos", "--rounds", "3"])
    assert exc.value.code == 1
    assert json.loads(capsys.readouterr().out)["weighted_acc"] is None


@pytest.mark.parametrize("argv,item", [
    (["--ckpt"], "item 15"), (["--ckpt", "--no-faults"], "item 15")])
def test_chaos_refuses_the_unported_soaks(argv, item, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["chaos", *argv])
    assert exc.value.code == 2
    assert f"ROADMAP.md Queue A {item} " in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--secure", "--mp"], ["--agg", "--mp"],
                                  ["--agg", "--secure"], ["--async", "--mp"],
                                  ["--tree-async", "--async"],
                                  ["--ckpt", "--tree-async"],
                                  ["--lock-witness"]])
def test_chaos_rejects_jax_s_conflicts(argv, capsys):
    from colearn_federated_learning_tpu import cli as jax_cli

    assert jax_cli.main(["chaos", *argv]) == 2
    theirs = capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        cli.main(["chaos", *argv])
    assert exc.value.code == 2
    assert capsys.readouterr().err == theirs


def test_proc_soak_checks_kill_targets_before_spawning(tmp_path):
    with pytest.raises(ValueError, match="out of range"):
        procsoak.run_proc_soak(rounds=3, n_workers=2,
                               kills=[procsoak.KillSpec("worker:2", 0)],
                               workdir=str(tmp_path), backend="cpu")
    with pytest.raises(ValueError, match="out of range"):
        procsoak.run_proc_soak(rounds=3, n_workers=2,
                               kills=[procsoak.KillSpec("aggregator:0", 0)],
                               workdir=str(tmp_path), backend="cpu")
    with pytest.raises(ValueError, match="rounds"):
        procsoak.run_proc_soak(rounds=0, backend="cpu")
    assert list(tmp_path.iterdir()) == []


# ------------------------------------------------- the asynchronous soaks --
@pytest.mark.parametrize("ckpt", [None, "run/ckpt"])
def test_async_soak_flags_are_jax_s(ckpt):
    ours = procsoak._async_config_flags(6, 3, 2, checkpoint_dir=ckpt,
                                        backend="cpu")
    assert ours == jax_procsoak._async_config_flags(6, 3, 2,
                                                    checkpoint_dir=ckpt)
    on_card = procsoak._async_config_flags(6, 3, 2, checkpoint_dir=ckpt)
    assert on_card[on_card.index("--backend") + 1] == "gpu"
    i = on_card.index("--backend")
    assert on_card[:i] + on_card[i + 2:] == ours[:i] + ours[i + 2:]


@pytest.mark.parametrize("ambient", [None, "3"])
def test_soak_children_take_one_cpu_thread_unless_told(monkeypatch, ambient):
    if ambient is None:
        monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    else:
        monkeypatch.setenv("OMP_NUM_THREADS", ambient)
    cpu, card = procsoak._child_env("cpu"), procsoak._child_env("gpu")
    assert cpu["OMP_NUM_THREADS"] == (ambient or "1")
    assert card.get("OMP_NUM_THREADS") == ambient
    for env in (cpu, card):
        assert env["PYTHONUNBUFFERED"] == "1"
        assert env["PYTHONPATH"].split(os.pathsep)[0] == procsoak._ROOT


def test_async_fault_plan_and_dp_constants_are_jax_s():
    assert procsoak._async_fault_plan() == jax_procsoak._async_fault_plan()
    assert (procsoak._ASYNC_DP_NOISE, procsoak._ASYNC_DP_DELTA) == \
        (jax_procsoak._ASYNC_DP_NOISE, jax_procsoak._ASYNC_DP_DELTA)
    plan = FaultPlan.from_json(json.dumps(procsoak._async_fault_plan()))
    assert [(f.kind, f.site) for f in plan.faults] == [
        ("flap_reconnect", "client"), ("delay", "client")]


@pytest.mark.parametrize("records,n", [
    ([], 3), ([{"round": 1}], 3),
    ([{"train_loss": v} for v in (2.0, 1.5, float("nan"), 1.0, 0.5)], 3),
    ([{"train_loss": v} for v in (2.0, float("inf"), 1.25)], 2),
    ([{"train_loss": 0.75}, {"aggregation": 1}], 1)])
def test_tail_loss_is_jax_s(records, n):
    assert procsoak._tail_loss(records, n) == \
        jax_procsoak._tail_loss(records, n)


def test_async_coordinator_kill_spec_is_jax_s():
    ours = procsoak.KillSpec("async-coordinator", after_round=1)
    theirs = jax_procsoak.KillSpec("async-coordinator", after_round=1)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for mod in (procsoak, jax_procsoak):
        with pytest.raises(ValueError, match="restart"):
            mod.KillSpec("async-coordinator", after_round=0, restart=False)


@pytest.mark.parametrize("name", ["run_async_soak", "run_tree_async_soak"])
@pytest.mark.parametrize("aggregations", [0, 3])
def test_async_soaks_reject_tiny_budgets(name, aggregations, tmp_path):
    with pytest.raises(ValueError, match="aggregations") as ours:
        getattr(procsoak, name)(aggregations=aggregations,
                                workdir=str(tmp_path), backend="cpu")
    with pytest.raises(ValueError) as theirs:
        getattr(jax_procsoak, name)(aggregations=aggregations,
                                    workdir=str(tmp_path))
    assert str(ours.value) == str(theirs.value)
    assert list(tmp_path.iterdir()) == []


LW_OK = {"enabled": True, "reports": 2, "acquires": 40, "guarded_ops": 9,
         "inversions": 0, "unguarded": 0, "inversion_records": [],
         "unguarded_records": []}


@pytest.mark.parametrize("armed", [True, False])
@pytest.mark.parametrize("lw", [
    LW_OK, None, {"enabled": False}, {**LW_OK, "reports": 0},
    {**LW_OK, "acquires": 0},
    {**LW_OK, "inversions": 1, "inversion_records": [{"edge": ["B", "A"]}]},
    {**LW_OK, "unguarded": 2, "unguarded_records": [{"op": "iter"},
                                                    {"op": "pop"}]},
    {"enabled": True}])
def test_lock_witness_gate_is_jax_s(armed, lw, capsys):
    from colearn_federated_learning_tpu import cli as jax_cli

    summary = {} if lw is None else {"lock_witness": lw}
    args = argparse.Namespace(lock_witness=armed)
    theirs = jax_cli._lock_witness_ok(summary, args)
    theirs_err = capsys.readouterr().err
    assert cli._lock_witness_ok(summary, args) is theirs
    assert capsys.readouterr().err == theirs_err
    assert theirs == (not armed or lw is LW_OK)


ASYNC_OK = dict(exit_code=0, baseline_exit_code=0, aggregations_run=6,
                baseline_aggregations_run=6, version_monotonic=True,
                dp_replay_ok=True, loss_gap_ok=True, health_ledger_ok=True,
                resumed=1, postmortem_attributed=True,
                faults_attributed=True, flight_missing=[], lock_witness=LW_OK)
TREE_OK = dict(exit_code=0, oracle_exit_code=0, aggregations_run=6,
               oracle_aggregations_run=6, version_monotonic=True,
               double_folds=0, loss_gap_ok=True, health_ledger_ok=True,
               failover_fired=True, rehomed_attributed=True,
               postmortem_attributed=True, flight_missing=[],
               lock_witness=LW_OK)
# Each gate key, flipped: (key, failing value, whether --no-faults waives it).
ASYNC_FLIPS = [("exit_code", 1, False), ("baseline_exit_code", 3, False),
               ("aggregations_run", 5, False),
               ("baseline_aggregations_run", 5, False),
               ("version_monotonic", False, False),
               ("dp_replay_ok", False, False), ("loss_gap_ok", False, False),
               ("health_ledger_ok", False, False), ("resumed", 0, True),
               ("postmortem_attributed", False, True),
               ("faults_attributed", False, True),
               ("flight_missing", [7], True),
               ("lock_witness", {**LW_OK, "inversions": 1}, False),
               ("lock_witness", {**LW_OK, "unguarded": 1}, False),
               ("lock_witness", {**LW_OK, "reports": 0}, False),
               ("lock_witness", {"enabled": False}, False)]
TREE_FLIPS = [("exit_code", 1, False), ("oracle_exit_code", 3, False),
              ("aggregations_run", 5, False),
              ("oracle_aggregations_run", 5, False),
              ("version_monotonic", False, False), ("double_folds", 1, False),
              ("loss_gap_ok", False, False),
              ("health_ledger_ok", False, False),
              ("failover_fired", False, True),
              ("rehomed_attributed", False, True),
              ("postmortem_attributed", False, True),
              ("flight_missing", [7], True),
              ("lock_witness", {**LW_OK, "inversions": 1}, False),
              ("lock_witness", {**LW_OK, "unguarded": 1}, False),
              ("lock_witness", {**LW_OK, "acquires": 0}, False),
              ("lock_witness", {"enabled": False}, False)]
ASYNC_CASES = (
    [("--async", "run_async_soak", ASYNC_OK, k, v, w) for k, v, w in
     [(None, None, False)] + ASYNC_FLIPS]
    + [("--tree-async", "run_tree_async_soak", TREE_OK, k, v, w)
       for k, v, w in [(None, None, False)] + TREE_FLIPS])


@pytest.mark.parametrize("no_faults", [False, True])
@pytest.mark.parametrize("flag,runner,ok,key,value,waived", ASYNC_CASES)
def test_chaos_async_gates(monkeypatch, capsys, flag, runner, ok, key, value,
                           waived, no_faults):
    """Every gate key of ``--async`` and ``--tree-async`` flipped alone
    exits 1 in both packages (the kill-only keys pass under
    ``--no-faults``); the soak gets the command's budget, backend and
    witness."""
    from colearn_federated_learning_tpu import cli as jax_cli

    summary = dict(ok) if key is None else {**ok, key: value}
    calls = _fake(monkeypatch, procsoak, runner, summary)
    _fake(monkeypatch, jax_procsoak, runner, summary)
    argv = ["chaos", flag, "--lock-witness", "--rounds", "6",
            "--num-workers", "3"] + (["--no-faults"] if no_faults else [])
    want = 0 if key is None or (waived and no_faults) else 1
    assert jax_cli.main(argv) == want
    capsys.readouterr()
    if want == 0:
        assert cli.main(argv) == summary
    else:
        with pytest.raises(SystemExit) as exc:
            cli.main(argv + ["--backend", "cpu"])
        assert exc.value.code == 1
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == \
        json.loads(json.dumps(summary))
    (kw,) = calls
    assert kw["aggregations"] == 6 and kw["n_workers"] == 3
    assert kw["lock_witness"] is True and kw["kill"] is not no_faults
    assert kw["backend"] == ("gpu" if want == 0 else "cpu")


# ---------------------------------------- real SIGKILLs (slow, as in JAX) --
@pytest.mark.slow
def test_proc_soak_coordinator_sigkill_resumes(tmp_path):
    """2 workers, 3 rounds, a real SIGKILL to the coordinator process
    mid-round 1: the ``--resume`` incarnation finishes the round budget
    with a final score, and the victim left a parseable black box."""
    from colearn_federated_learning_tpu.telemetry import flight as jax_flight

    kills = procsoak.canned_kill_schedule(3, 2)
    s = procsoak.run_proc_soak(rounds=3, n_workers=2, kills=kills,
                               workdir=str(tmp_path), round_timeout=120.0,
                               timeout_s=420.0, backend="cpu")
    assert s["exit_code"] == 0
    assert s["rounds_run"] == 3
    assert s["rounds_resumed"] >= 1
    assert s["coordinator_incarnations"] == 2
    assert len(s["kills"]) == 1
    assert s["weighted_acc"] is not None
    assert all("pid" in k for k in s["kills"])
    assert s["flight_missing"] == []
    assert s["flight_dumps"] >= 1
    dumps = jax_flight.load_flight_dumps(str(tmp_path / "flight"))
    by_pid = {d.get("pid"): d for d in dumps if "error" not in d}
    victim = by_pid[s["kills"][0]["pid"]]
    assert victim["schema"] == "colearn-flight-v1"
    assert victim["role"] == "coordinator"
    assert "--backend" in victim["argv"]


@pytest.mark.slow
def test_proc_soak_broker_sigkill_heals(tmp_path):
    """A real SIGKILL to the broker after round 1: a fresh broker on the
    same port, the workers' watchdogs and the coordinator's
    ``_rebuild_broker`` heal into it, and the round budget commits."""
    from colearn_federated_learning_tpu_torch.telemetry import flight

    kills = [procsoak.KillSpec("broker", after_round=1)]
    s = procsoak.run_proc_soak(rounds=3, n_workers=2, kills=kills,
                               workdir=str(tmp_path), round_timeout=120.0,
                               timeout_s=420.0, backend="cpu")
    assert s["exit_code"] == 0
    assert s["rounds_run"] == 3
    assert s["coordinator_incarnations"] == 1
    assert len(s["kills"]) == 1
    assert s["kills"][0]["target"] == "broker"
    assert s["weighted_acc"] is not None
    assert all("pid" in k for k in s["kills"])
    assert s["flight_missing"] == []
    dumps = flight.load_flight_dumps(str(tmp_path / "flight"))
    by_pid = {d.get("pid"): d for d in dumps if "error" not in d}
    assert by_pid[s["kills"][0]["pid"]]["role"] == "broker"


@pytest.mark.slow
def test_agg_soak_aggregator_sigkill_fails_over(tmp_path):
    """``chaos --agg``'s run: aggregator 0 SIGKILLed after round 1 stays
    dead, the root re-homes its slice, the final params are the flat
    oracle's within 2e-4, the postmortem names the aggregator and the
    tree's health ledgers survive."""
    s = procsoak.run_agg_soak(rounds=4, n_workers=3, workdir=str(tmp_path),
                              backend="cpu")
    assert s["exit_code"] == 0 and s["oracle_exit_code"] == 0
    assert s["rounds_run"] == s["oracle_rounds_run"] == 4
    assert s["oracle_ok"], s["max_param_diff"]
    assert s["checkpoint_step"] == 4
    assert s["agg_failovers"] >= 1
    assert s["postmortem_attributed"]
    assert s["health_ledger_ok"] and s["health_devices"] == 3
    assert s["flight_missing"] == []
    assert [k["target"] for k in s["kills"]] == ["aggregator:0"]


@pytest.mark.slow
def test_async_soak_coordinator_sigkill_resumes(tmp_path):
    """JAX's buffered-asynchronous acceptance run: 3 workers, a real
    SIGKILL to the asynchronous coordinator mid-aggregation, a relaunch
    with ``--resume``; the versions increase in both incarnations, the
    accountant's replay gives the final epsilon (no double charge), and
    the faulted tail loss is within tolerance of a kill-free baseline."""
    s = procsoak.run_async_soak(aggregations=5, n_workers=3,
                                workdir=str(tmp_path), round_timeout=120.0,
                                timeout_s=600.0, backend="cpu")
    assert s["exit_code"] == 0
    assert s["baseline_exit_code"] == 0
    assert s["aggregations_run"] >= 5
    assert s["version_monotonic"]
    assert s["resumed"] >= 1
    assert s["coordinator_incarnations"] == 2
    assert s["dp_replay_ok"], (s["dp_epsilon"], s["dp_epsilon_replayed"])
    assert s["loss_gap_ok"], s["loss_gap"]
    assert s["postmortem_attributed"]
    assert s["health_ledger_ok"]
    assert s["fault_retries"] >= 1        # the plan's flaps landed
    assert s["flight_missing"] == []
    assert s["lock_witness"] == {"enabled": False}


@pytest.mark.slow
def test_chaos_tree_async_with_the_lock_witness(tmp_path, capsys):
    """``chaos --tree-async --lock-witness`` at JAX's default budget (6
    aggregations): aggregator 0 SIGKILLed and left dead, the broker killed
    and rebound; the command's gate passes, the failover fired and folded
    nothing twice, and the witness reports of both fleets' coordinators
    saw lock traffic with no inversion and no unguarded access."""
    s = cli.main(["chaos", "--tree-async", "--lock-witness", "--backend",
                  "cpu", "--rounds", "6", "--num-workers", "3",
                  "--workdir", str(tmp_path)])
    capsys.readouterr()
    assert [k["target"] for k in s["kills"]] == ["aggregator:0", "broker"]
    assert all("pid" in k for k in s["kills"])
    assert s["failover_fired"] and s["double_folds"] == 0
    assert s["rehomed_attributed"] and s["rehomed_devices"]
    assert s["postmortem_attributed"] and s["flight_missing"] == []
    lw = s["lock_witness"]
    assert lw["reports"] >= 2 and lw["acquires"] >= 1
    assert lw["inversions"] == 0 and lw["unguarded"] == 0
    assert {"flight", "health", "lockwitness"} <= {
        p.name for p in (tmp_path / "faulted").iterdir()}
