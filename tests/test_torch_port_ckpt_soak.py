"""``chaos --ckpt`` (``faults/procsoak.run_ckpt_soak``) through the port's
command line on the CPU, and its parts against the JAX package's.

- The soak's fault plan and its fleets' flags equal JAX's.
- The smoke leg (``--no-faults``): a tp = 2 federation of processes runs
  to its end, a fresh fleet resumes its last generation at tp = 1, and
  JAX's gate passes: the digest across the re-cut, ``resharded`` counted.
- The kill leg: the coordinator SIGKILLed while a save is in flight,
  relaunched with ``--resume`` at tp = 1, and JAX's gate passes: the last
  committed generation restored bitwise, the federation finished near the
  kill-free oracle, the postmortem naming the coordinator.

Each leg runs JAX's defaults (4 rounds, 2 workers, tp 2 -> 1, 300 ms of
``slow_io`` per shard file) in under 60 s alone.
"""

import json
import os

import pytest

from colearn_federated_learning_tpu.faults import procsoak as jax_procsoak
from colearn_federated_learning_tpu_torch import cli
from colearn_federated_learning_tpu_torch.faults import procsoak


def test_ckpt_fault_plan_and_flags_are_jax_s():
    for ms in (300, 25):
        assert procsoak._ckpt_fault_plan(ms) == \
            jax_procsoak._ckpt_fault_plan(ms)
    ours = procsoak._config_flags(4, 2, 0, checkpoint_dir="ck",
                                  backend="cpu")
    assert ours == jax_procsoak._config_flags(4, 2, 0, checkpoint_dir="ck")


def test_ckpt_dir_scanners_read_generations_as_jax_s(tmp_path):
    ck = str(tmp_path)
    for mod in (procsoak, jax_procsoak):
        assert not mod._ckpt_has_committed(ck)
        assert mod._ckpt_in_progress(ck) is None
    (tmp_path / "gen_00000001").mkdir()
    (tmp_path / "gen_00000001" / "manifest.json").write_text("{}")
    (tmp_path / "gen_00000002").mkdir()
    (tmp_path / "gen_00000002" / "shard_00000.npz").write_bytes(b"")
    for mod in (procsoak, jax_procsoak):
        assert mod._ckpt_gen_entries(ck) == [
            os.path.join(ck, "gen_00000001"), os.path.join(ck, "gen_00000002")]
        assert mod._ckpt_has_committed(ck)
        assert mod._ckpt_in_progress(ck) == os.path.join(ck, "gen_00000002")


def _soak(argv, workdir, capsys):
    out = cli.main(["chaos", "--ckpt", "--backend", "cpu", "--rounds", "4",
                    "--num-workers", "2", "--workdir", str(workdir), *argv])
    printed = capsys.readouterr()
    assert json.loads(printed.out.strip().splitlines()[-1]) == \
        json.loads(json.dumps(out))
    return out


def test_chaos_ckpt_smoke_leg_passes_jax_s_gate(tmp_path, capsys):
    out = _soak(["--no-faults"], tmp_path, capsys)
    assert out["mode"] == "smoke" and out["rounds_run"] == 4
    assert out["committed_step"] == out["resume_round"] == 4
    assert out["digest_ok"] and out["resharded_resumes"] >= 1
    manifest = json.load(open(tmp_path / "save" / "ckpt" / "gen_00000004"
                              / "manifest.json"))
    assert manifest["saved_shards"] == 2


def test_chaos_ckpt_kill_leg_passes_jax_s_gate(tmp_path, capsys):
    out = _soak([], tmp_path, capsys)
    assert out["mode"] == "kill" and out["killed_mid_save"]
    assert out["coordinator_incarnations"] == 2 and out["resumed"] == 1
    assert out["resume_round"] == out["committed_step"] is not None
    assert out["kill_digest"] == out["resume_digest"]
    assert out["resharded_resumes"] >= 1 and out["loss_gap_ok"]
    assert out["postmortem_attributed"] and not out["flight_missing"]
    assert out["rounds_run"] == out["oracle_rounds_run"] == 4


def test_ckpt_soak_refuses_a_short_budget_as_jax():
    with pytest.raises(ValueError) as theirs:
        jax_procsoak.run_ckpt_soak(rounds=2)
    with pytest.raises(ValueError) as ours:
        procsoak.run_ckpt_soak(rounds=2, backend="cpu")
    assert str(ours.value) == str(theirs.value)
