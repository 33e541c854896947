"""The port's checkpoint plane (``ckpt/``) against the JAX package's, on
the CPU at small sizes (the tiny MLP, a few clients).

- The round WAL and the enrollment ledger are the JAX files: the same
  entries (timestamps fixed) give byte-equal files, each package loads
  the other's, a torn tail is dropped and counted, a torn line elsewhere
  raises, ``rewind`` truncates, a revocation erases a device until its
  next admission.
- Streaming generations move both ways: a JAX generation of the engine's
  state restores in the port to ``convert``'s tensors bit for bit, the
  port's save of that state has JAX's manifest ``leaves``, and JAX's
  ``load_generation_host`` gives the port's ``last_restore_digest``.
  bf16 round-trips bitwise; each discard reason falls back a generation
  with its labelled count; pruning; the shape-mismatch error; the three
  fault hooks.
- ``RoundCheckpointer``: round trip, ``latest_step``, ``max_to_keep``,
  and a save cut before its commit leaves the previous step.
- The engine: the ports of JAX's ``tests/test_ckpt_metrics.py`` resume
  tests, each bit for bit port against port, and the resumed port run
  held to JAX's resumed run at f32 rtol 1e-4 / atol 2e-5 with JAX's
  draws replayed (``plan``); SCAFFOLD's variates, the accountant's steps
  and the adaptive clip across a resume.
- The socket plane: the coordinator's WAL (one entry per round, the
  uncommitted tail rewound and counted), the RDP vector across a resume
  and a resumed federation bit for bit; the ports of JAX's
  ``tests/test_enrollment_ledger.py`` challenge tests against the port's
  worker; the asynchronous coordinator's version and the accountant's
  replay; the CLI's ``resume_cold``, ``resumed`` and
  ``challenge_verified`` events and ``train --resume``.

Every wait has its own timeout in code (no pytest-timeout here).
"""

import contextlib
import dataclasses
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.ckpt import (
    EnrollmentLedger as JaxLedger, RoundWal as JaxWal,
    StreamingCheckpointer as JaxStreaming,
    load_generation_host as jax_load_generation)
from colearn_federated_learning_tpu.fed import FederatedLearner as JaxLearner
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu_torch import cli, convert, telemetry
from colearn_federated_learning_tpu_torch.ckpt import (
    EnrollmentLedger, RoundCheckpointer, RoundWal, StreamingCheckpointer,
    load_generation_host)
from colearn_federated_learning_tpu_torch.ckpt import streaming
from colearn_federated_learning_tpu_torch.comm import (
    broker, enrollment, keyexchange)
from colearn_federated_learning_tpu_torch.comm.async_coordinator import (
    AsyncFederatedCoordinator)
from colearn_federated_learning_tpu_torch.comm.broker import BrokerClient
from colearn_federated_learning_tpu_torch.comm.coordinator import (
    FederatedCoordinator)
from colearn_federated_learning_tpu_torch.comm.worker import DeviceWorker
from colearn_federated_learning_tpu_torch.faults import inject
from colearn_federated_learning_tpu_torch.faults.plan import (
    FaultPlan, FaultSpec)
from colearn_federated_learning_tpu_torch.fed import FederatedLearner
from colearn_federated_learning_tpu_torch.utils import config
from test_torch_port_round import JaxDraws
from test_torch_port_socket import WAIT, configs, jax_init

RTOL, ATOL = 1e-4, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _counter(name, **labels):
    reg = telemetry.get_registry()
    return (reg.counter(name, labels=labels) if labels
            else reg.counter(name)).value


# ------------------------------------------------------ WAL and ledger --
class _Dev:
    def __init__(self, device_id, host="127.0.0.1", port=1, pubkey=""):
        self.device_id, self.host, self.port = device_id, host, port
        self.pubkey = pubkey


ENTRIES = [{"round": 0, "accepted": [0, 2], "completed": 2,
            "total_weight": 96.0},
           {"round": 1, "accepted": [1], "completed": 1,
            "total_weight": 48.0}]


def _write_ledger(cls, path):
    led = cls(path)
    led.admit(_Dev("0", port=7001, pubkey="aa"))
    led.admit(_Dev("1", port=7002, pubkey="bb"))
    led.revoke("0")
    led.admit(_Dev("1", port=7009, pubkey="cc"))      # key rotation
    led.close()
    return led.path


def test_wal_and_ledger_files_are_byte_equal_and_cross_load(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    paths = {}
    for side, (wal_cls, led_cls) in (("port", (RoundWal, EnrollmentLedger)),
                                     ("jax", (JaxWal, JaxLedger))):
        d = str(tmp_path / side)
        wal = wal_cls(d)
        for e in ENTRIES:
            wal.append(e)
        wal.close()
        paths[side] = (wal.path, _write_ledger(led_cls, d))
    for i in range(2):
        with open(paths["port"][i], "rb") as a, \
                open(paths["jax"][i], "rb") as b:
            assert a.read() == b.read()
    for reader, d in ((RoundWal, "jax"), (JaxWal, "port")):
        assert reader(str(tmp_path / d)).load() == ENTRIES
    for reader, d in ((EnrollmentLedger, "jax"), (JaxLedger, "port")):
        devs = reader(str(tmp_path / d)).devices()
        assert set(devs) == {"1"} and devs["1"]["pubkey"] == "cc"
        assert devs["1"]["port"] == 7009


def test_wal_torn_tail_is_dropped_and_counted(tmp_path):
    wal = RoundWal(str(tmp_path))
    wal.append({"round": 0})
    wal.close()
    with open(wal.path, "a") as f:       # the append a kill cut short
        f.write('{"round": 1, "acc')
    before = _counter("ckpt.wal_torn_tail_total")
    assert [e["round"] for e in wal.load()] == [0]
    assert _counter("ckpt.wal_torn_tail_total") == before + 1
    assert [e["round"] for e in JaxWal(str(tmp_path)).load()] == [0]


def test_wal_mid_file_corruption_raises(tmp_path):
    wal = RoundWal(str(tmp_path))
    with open(wal.path, "w") as f:
        f.write('{"round": 0}\n{"torn\n{"round": 2}\n')
    with pytest.raises(ValueError, match="corrupt WAL entry"):
        wal.load()


def test_wal_rewind_and_append_after_it(tmp_path):
    wal = RoundWal(str(tmp_path))
    assert wal.committed_rounds() is None
    for r in range(3):
        wal.append({"round": r, "accepted": [0, 1]})
    wal.rewind(1)
    assert [e["round"] for e in JaxWal(str(tmp_path)).load()] == [0]
    wal.append({"round": 1, "accepted": []})
    assert wal.committed_rounds() == 2
    assert not os.path.exists(wal.path + ".tmp")
    wal.close()


def test_ledger_revocation_is_latest_line_wins(tmp_path):
    led = EnrollmentLedger(str(tmp_path))
    led.admit(_Dev("0", pubkey="aa"))
    led.revoke("0")
    assert led.devices() == {}
    led.admit(_Dev("0", pubkey="dd"))     # re-admission supersedes it
    assert led.devices()["0"]["pubkey"] == "dd"
    with open(led.path, "a", encoding="utf-8") as f:
        f.write('{"device_id": "1", "pubk')
    assert set(EnrollmentLedger(str(tmp_path)).devices()) == {"0"}
    led.close()


# ---------------------------------------------------- streaming format --
def _tiny_cfgs(rounds=4, run_kw=None, **fed_kw):
    """(JAX config, port config) of JAX's ``tests/test_engine.tiny_config``
    at 5 clients, cohort 3."""
    fed = dict(strategy="fedavg", rounds=rounds, local_steps=2,
               batch_size=32, lr=0.05, momentum=0.9, cohort_size=3)
    fed.update(fed_kw)
    out = []
    for mod in (jax_config, config):
        out.append(mod.ExperimentConfig(
            data=mod.DataConfig(dataset="mnist_tiny", num_clients=5,
                                partition="iid"),
            model=mod.ModelConfig(name="mlp", num_classes=10, hidden_dim=32,
                                  depth=2),
            fed=mod.FedConfig(**fed),
            run=mod.RunConfig(name="test", seed=0, **(run_kw or {}))))
    return out


def _jax_scaffold_generation(tmp_path):
    """A JAX learner under SCAFFOLD after one round, and its engine state
    saved by JAX's streaming checkpointer at step 1."""
    jcfg, tcfg = _tiny_cfgs(strategy="scaffold", momentum=0.0)
    jl = JaxLearner(jcfg)
    jl.run_round()
    JaxStreaming(str(tmp_path / "jax")).save(
        1, (jl.server_state, jl.client_c), jl.history)
    return jl, tcfg


def test_jax_generation_restores_in_the_port_bitwise(tmp_path):
    jl, tcfg = _jax_scaffold_generation(tmp_path)
    tl = FederatedLearner(tcfg, device="cpu")
    ck = StreamingCheckpointer(str(tmp_path / "jax"))
    template = tl._checkpoint_state()
    state, history, step = ck.restore(template)
    streaming.copy_leaves(template, state)
    assert step == 1 and history[0]["round"] == 0
    want = convert.flax_to_state_dict(jax.device_get(jl.server_state.params))
    control = convert.flax_to_state_dict(
        jax.device_get(jl.server_state.control))
    for name, t in tl.params.items():
        assert torch.equal(t, want[name]), name
        assert torch.equal(tl.server_state.control[name], control[name])
    for name, rows in zip(tl.params, tl.variates.rows):
        for i in range(rows.shape[0]):
            row = convert.flax_to_state_dict(jax.tree.map(
                lambda a: np.asarray(a)[i], jl.client_c))[name]
            assert torch.equal(rows[i], row), (name, i)
    _, _, jax_digest = jax_load_generation(str(tmp_path / "jax"))
    assert ck.last_restore_digest == jax_digest


def test_port_generation_has_jax_s_manifest_and_digest(tmp_path):
    jl, tcfg = _jax_scaffold_generation(tmp_path)
    tl = FederatedLearner(tcfg, device="cpu")
    template = tl._checkpoint_state()
    state, history, _ = StreamingCheckpointer(
        str(tmp_path / "jax")).restore(template)
    streaming.copy_leaves(template, state)
    tl.server_state.round_idx = int(state[0].round_idx)
    StreamingCheckpointer(str(tmp_path / "port")).save(
        1, tl._checkpoint_state(), history)
    manifests = [json.load(open(tmp_path / side / "gen_00000001"
                                / "manifest.json"))
                 for side in ("jax", "port")]
    assert manifests[0]["leaves"] == manifests[1]["leaves"]
    assert manifests[0]["step"] == manifests[1]["step"] == 1
    theirs, _, jax_digest = jax_load_generation(str(tmp_path / "jax"))
    ours, step, port_digest = jax_load_generation(str(tmp_path / "port"))
    assert step == 1 and port_digest == jax_digest
    _, _, digest = load_generation_host(str(tmp_path / "port"))
    assert digest == jax_digest
    for path in theirs:
        assert np.array_equal(np.asarray(ours[path]),
                              np.asarray(theirs[path])), path


def _params(dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(3)
    bits = torch.randint(-2**15, 2**15, (8, 8), dtype=torch.int32,
                         generator=g).to(torch.int16)
    return {"Dense_0": {"kernel": bits.view(dtype),
                        "bias": torch.linspace(-1.0, 1.0, 8)}}


def _state(params):
    # The coordinator's composite: (server tree, accountant vector,
    # Python scalar).
    return (params, np.zeros(1), 7)


def _zeros(params):
    return {"Dense_0": {k: torch.zeros_like(v)
                        for k, v in params["Dense_0"].items()}}


def _assert_tree_equal(a, b):
    for (pa, x), (pb, y) in zip(streaming.flatten_state(a),
                                streaming.flatten_state(b)):
        assert pa == pb and x.dtype == y.dtype
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y), pa


def test_bf16_round_trips_bitwise_and_reads_in_jax(tmp_path):
    p = _params()
    ck = StreamingCheckpointer(str(tmp_path))
    ck.save(1, _state(p), [])
    got, _, step = ck.restore(_state(_zeros(p)))
    assert step == 1 and got[2] == 7 and got[1].dtype == np.float64
    _assert_tree_equal(got[0], p)
    theirs, _, digest = jax_load_generation(str(tmp_path))
    kernel = np.asarray(theirs["0/Dense_0/kernel"])
    assert kernel.dtype.name == "bfloat16"
    assert np.array_equal(kernel.view(np.int16),
                          p["Dense_0"]["kernel"].view(torch.int16).numpy())
    assert digest == ck.last_restore_digest


def test_prune_keeps_max_to_keep(tmp_path):
    ck = StreamingCheckpointer(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        ck.save(step, _state(_params()), [])
    assert sorted(n for n in os.listdir(tmp_path)
                  if n.startswith("gen_")) == ["gen_00000002",
                                               "gen_00000003"]


def _two_gens(tmp_path):
    ck = StreamingCheckpointer(str(tmp_path))
    ck.save(1, _state(_params()), [{"round": 0}])
    ck.save(2, _state(_params(torch.float16)), [{"round": 0}, {"round": 1}])
    return tmp_path / "gen_00000002"


def _tear(gen, reason):
    shard = gen / "shard_00000.npz"
    size = os.path.getsize(shard)
    if reason == "torn_shard":
        with open(shard, "r+b") as f:
            f.truncate(size // 2)
    elif reason == "crc_mismatch":
        with open(shard, "r+b") as f:     # same size, flipped bytes
            f.seek(size // 2)
            f.write(b"\xff\x00\xff\x00")
    elif reason == "missing_shard":
        os.unlink(shard)
    elif reason == "torn_manifest":
        mpath = gen / "manifest.json"
        with open(mpath, "r+b") as f:
            f.truncate(os.path.getsize(mpath) // 2)
    else:
        os.unlink(gen / "manifest.json")


@pytest.mark.parametrize("reason", ["missing_manifest", "torn_manifest",
                                    "missing_shard", "torn_shard",
                                    "crc_mismatch"])
def test_a_torn_generation_falls_back_a_generation(tmp_path, reason):
    _tear(_two_gens(tmp_path), reason)
    before = _counter("ckpt.generations_discarded_total", reason=reason)
    ck = StreamingCheckpointer(str(tmp_path))
    got, hist, step = ck.restore(_state(_zeros(_params())))
    assert step == 1 and [h["round"] for h in hist] == [0]
    _assert_tree_equal(got[0], _params())
    assert ck.generations_discarded == {reason: 1}
    assert _counter("ckpt.generations_discarded_total",
                    reason=reason) == before + 1
    # JAX's recovery matrix discards the same generation.
    assert jax_load_generation(str(tmp_path))[1] == 1


def test_no_restorable_generation_raises(tmp_path):
    _two_gens(tmp_path)
    for name in ("gen_00000001", "gen_00000002"):
        os.unlink(tmp_path / name / "manifest.json")
    ck = StreamingCheckpointer(str(tmp_path))
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore(_state(_params()))


def test_shape_mismatch_template_raises(tmp_path):
    StreamingCheckpointer(str(tmp_path)).save(1, _state(_params()), [])
    bad = _params()
    bad["Dense_0"]["bias"] = torch.zeros(16)
    with pytest.raises(ValueError, match="saved shape"):
        StreamingCheckpointer(str(tmp_path)).restore(_state(bad))
    with pytest.raises(ValueError, match="holds 4 leaves"):
        StreamingCheckpointer(str(tmp_path)).restore((bad, np.zeros(1)))


@contextlib.contextmanager
def _plan(**spec):
    inject.install(FaultPlan([FaultSpec(device_id=spec.pop("device_id", "*"),
                                         round=-1, **spec)]))
    try:
        yield
    finally:
        inject.uninstall()


def test_stale_manifest_fault_aborts_the_save_uncommitted(tmp_path):
    ck = StreamingCheckpointer(str(tmp_path))
    ck.save(1, _state(_params()), [{"round": 0}])
    before = _counter("ckpt.save_aborted_total")
    with _plan(kind="stale_manifest", op="manifest", hop="manifest"):
        ck.save(2, _state(_params()), [{"round": 0}, {"round": 1}])
    assert _counter("ckpt.save_aborted_total") == before + 1
    gen2 = tmp_path / "gen_00000002"
    assert not (gen2 / "manifest.json").exists()
    assert (gen2 / "shard_00000.npz").exists()
    got, hist, step = StreamingCheckpointer(str(tmp_path)).restore(
        _state(_zeros(_params())))
    assert step == 1 and len(hist) == 1
    _assert_tree_equal(got[0], _params())


def test_torn_shard_fault_is_discarded_on_restore(tmp_path):
    ck = StreamingCheckpointer(str(tmp_path))
    ck.save(1, _state(_params()), [{"round": 0}])
    with _plan(kind="torn_shard", device_id="0", op="shard", hop="shard"):
        ck.save(2, _state(_params()), [{"round": 0}, {"round": 1}])
    ck2 = StreamingCheckpointer(str(tmp_path))
    _, hist, step = ck2.restore(_state(_zeros(_params())))
    assert step == 1 and len(hist) == 1
    assert list(ck2.generations_discarded) == ["torn_shard"]


def test_slow_io_fault_stretches_the_save(tmp_path):
    with _plan(kind="slow_io", op="shard", ms=120, hop="shard"):
        t0 = time.monotonic()
        StreamingCheckpointer(str(tmp_path)).save(1, _state(_params()), [])
        assert time.monotonic() - t0 >= 0.1


# --------------------------------------------------- round checkpointer --
def test_round_checkpointer_round_trip_and_max_to_keep(tmp_path):
    ck = RoundCheckpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ck.restore(_state(_params()))
    assert ck.latest_step() is None
    for step in (1, 2, 3, 4):
        p = _params()
        p["Dense_0"]["bias"] = p["Dense_0"]["bias"] + step
        ck.save(step, _state(p), [{"round": r} for r in range(step)])
    assert ck.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["2", "3", "4"]
    got, hist, step = RoundCheckpointer(str(tmp_path)).restore(
        _state(_zeros(_params())))
    assert step == 4 and len(hist) == 4 and got[2] == 7
    _assert_tree_equal(got[0], p)
    _, hist, step = ck.restore(_state(_zeros(_params())), step=2)
    assert step == 2 and len(hist) == 2
    leaves = dict(ck.load_leaves())
    assert sorted(leaves) == ["0/Dense_0/bias", "0/Dense_0/kernel", "1", "2"]
    assert torch.equal(leaves["0/Dense_0/bias"], p["Dense_0"]["bias"])


def test_round_checkpointer_save_cut_before_commit_keeps_the_last_step(
        tmp_path, monkeypatch):
    from colearn_federated_learning_tpu_torch.ckpt import manager

    ck = RoundCheckpointer(str(tmp_path))
    ck.save(1, _state(_params()), [{"round": 0}])

    class Killed(Exception):
        pass

    def killed(*_):
        raise Killed

    monkeypatch.setattr(manager.os, "replace", killed)
    zeros = _zeros(_params())
    with pytest.raises(Killed):
        ck.save(2, _state(zeros), [{"round": 0}, {"round": 1}])
    monkeypatch.undo()
    assert ck.latest_step() == 1
    got, hist, step = ck.restore(_state(zeros))
    assert step == 1 and len(hist) == 1
    _assert_tree_equal(got[0], _params())
    # A kill leaves its temporary directory behind: restore ignores it
    # and the next save removes it.
    os.makedirs(tmp_path / ".tmp-killed")
    ck.save(2, _state(zeros), [])
    assert sorted(os.listdir(tmp_path)) == ["1", "2"]


# ------------------------------------------------------------- engine --
def _params_equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("fed_kw", [
    dict(), dict(strategy="scaffold", momentum=0.0),
    dict(strategy="fedadam")])
def test_checkpoint_resume_matches_uninterrupted(tmp_path, fed_kw):
    """4 rounds straight against 2 + checkpoint + restore + 2: bit for bit
    in the port, and the resumed port run within f32 tolerance of JAX's
    resumed run on the same draws."""
    jbase, base = _tiny_cfgs(**fed_kw)
    ck = str(tmp_path / "ck")
    jcfg = jbase.replace(run=dataclasses.replace(jbase.run,
                                                 checkpoint_dir=ck + "j"))
    cfg = base.replace(run=dataclasses.replace(base.run, checkpoint_dir=ck))
    jax_first = JaxLearner(jcfg)
    init = jax.device_get(jax_first.params)

    def port(c):
        tl = FederatedLearner(c, device="cpu", plan=JaxDraws(0))
        tl.load_flax_params(init)
        return tl

    straight = port(base)
    straight.fit(rounds=4)
    first = port(cfg)
    first.fit(rounds=2)
    first.save_checkpoint()
    resumed = port(cfg)
    assert resumed.restore_checkpoint() == 2
    resumed.fit(rounds=2)
    assert _params_equal(straight.params, resumed.params)
    assert resumed.evaluate() == straight.evaluate()
    if resumed.variates is not None:
        assert all(torch.equal(a, b) for a, b in
                   zip(straight.variates.rows, resumed.variates.rows))
    if straight.server_state.opt_m is not None:
        assert _params_equal(straight.server_state.opt_v,
                             resumed.server_state.opt_v)
    assert resumed.server_state.round_idx == 4

    jax_first.fit(rounds=2)
    jax_first.save_checkpoint()
    jax_resumed = JaxLearner(jcfg)
    jax_resumed.restore_checkpoint()
    jax_resumed.fit(rounds=2)
    want = convert.flax_to_state_dict(
        jax.device_get(jax_resumed.server_state.params))
    for name, t in resumed.params.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_fit_auto_checkpoints(tmp_path):
    _, cfg = _tiny_cfgs(rounds=3, run_kw=dict(
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2))
    learner = FederatedLearner(cfg, device="cpu")
    learner.fit(rounds=3)
    assert ["phase_checkpoint_s" in r for r in learner.history] == [
        False, True, True]
    assert sorted(os.listdir(tmp_path / "ck")) == ["2", "3"]
    fresh = FederatedLearner(cfg, device="cpu")
    assert fresh.restore_checkpoint() == 3     # the last round always saves
    assert len(fresh.history) == 3
    fresh.fit()                                # the remaining rounds: none
    assert len(fresh.history) == 3
    assert _params_equal(fresh.params, learner.params)


def test_checkpoint_dir_without_cadence_saves_final_round(tmp_path):
    _, cfg = _tiny_cfgs(rounds=2, run_kw=dict(
        checkpoint_dir=str(tmp_path / "ck")))
    learner = FederatedLearner(cfg, device="cpu")
    learner.fit()
    fresh = FederatedLearner(cfg, device="cpu")
    assert fresh.restore_checkpoint() == 2
    fresh.fit()
    assert len(fresh.history) == 2


@pytest.mark.parametrize("fed_kw", [
    dict(), dict(dp_clip=1.0, dp_noise_multiplier=0.8,
                 dp_adaptive_clip=True, momentum=0.0)])
def test_engine_interrupted_midrun_resumes_bitwise(tmp_path, fed_kw):
    """fit() dies after round 1's record is out, before round 1's save; a
    fresh learner restores step 1 and ends bit for bit on the
    uninterrupted run, with the accountant's ε and the adaptive clip."""
    _, base = _tiny_cfgs(**fed_kw)
    cfg = base.replace(run=dataclasses.replace(
        base.run, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1))
    straight = FederatedLearner(base, device="cpu")
    straight.fit(rounds=4)

    class Killed(Exception):
        pass

    def die_at_round_1(rec):
        if rec["round"] == 1:
            raise Killed

    first = FederatedLearner(cfg, device="cpu")
    with pytest.raises(Killed):
        first.fit(log_fn=die_at_round_1)
    resumed = FederatedLearner(cfg, device="cpu")
    assert resumed.restore_checkpoint() == 1
    if resumed.accountant is not None:
        assert resumed.accountant.steps == 1
        assert resumed.dp_clip.item() == first.history[0]["dp_clip"]
    resumed.fit()
    assert len(resumed.history) == 4
    assert _params_equal(straight.params, resumed.params)
    assert resumed.evaluate() == straight.evaluate()
    if resumed.accountant is not None:
        assert (resumed.history[-1]["dp_epsilon"]
                == straight.history[-1]["dp_epsilon"])
        assert torch.equal(resumed.dp_clip, straight.dp_clip)


def test_engine_refuses_checkpoints_on_a_mesh(tmp_path):
    """Item 15b retired the refusal: a SCAFFOLD learner on a world-1 gloo
    client mesh (in this process, over a FileStore) saves after round 0,
    a fresh mesh learner restores and runs round 1 bit for bit as the
    uninterrupted mesh run, and the step's leaves have the one-device
    learner's paths and shapes (the many-rank cases are
    ``tests/test_torch_port_mesh_ckpt.py``'s)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    _, base = _tiny_cfgs(strategy="scaffold", momentum=0.0)
    cfg = base.replace(run=dataclasses.replace(
        base.run, checkpoint_dir=str(tmp_path / "mesh")))
    one = base.replace(run=dataclasses.replace(
        base.run, checkpoint_dir=str(tmp_path / "one")))
    FederatedLearner(one, device="cpu").fit(rounds=1)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("clients",))
        straight = FederatedLearner(base, device="cpu", mesh=mesh)
        straight.fit(rounds=2)
        FederatedLearner(cfg, device="cpu", mesh=mesh).fit(rounds=1)
        resumed = FederatedLearner(cfg, device="cpu", mesh=mesh)
        assert resumed.restore_checkpoint() == 1
        resumed.fit(rounds=1)
    finally:
        dist.destroy_process_group()
    assert _params_equal(straight.params, resumed.params)
    assert _params_equal(straight.server_state.control,
                         resumed.server_state.control)
    assert all(torch.equal(a, b) for a, b in
               zip(straight.variates.rows, resumed.variates.rows))
    table = lambda d: [(r["path"], r["shape"]) for r in
                       RoundCheckpointer(str(tmp_path / d)).leaf_table(1)]
    assert table("mesh") == table("one")


# ------------------------------------------------------- socket plane --
@contextlib.contextmanager
def _fleet(tcfg, n):
    """A port broker and ``n`` port workers (their own draws), as
    threads."""
    with contextlib.ExitStack() as stack:
        b = broker.MessageBroker().start()
        stack.callback(b.stop)
        ws = []
        for i in range(n):
            ws.append(DeviceWorker(tcfg, i, b.host, b.port,
                                   device="cpu").start())
            stack.callback(ws[-1].stop)
        yield b, ws


def _coordinator(tcfg, b, init, n, cls=FederatedCoordinator, **kw):
    c = cls(tcfg, b.host, b.port, want_evaluator=False, device="cpu", **kw)
    c._load_params(init)
    c.enroll(min_devices=n, timeout=WAIT)
    return c


def _host_params(c):
    return {k: v.clone() for k, v in c.server_state.params.items()}


def test_coordinator_wal_rdp_and_resume_are_bitwise(tmp_path):
    """Three DP rounds straight, against two rounds whose third dies
    between its WAL append and its save: the resumed coordinator rewinds
    the uncommitted entry (counted), restores the RDP vector and ends on
    the uninterrupted params bit for bit."""
    ck = str(tmp_path / "ck")
    jcfg, tcfg = configs(num_clients=3, dp_clip=1.0,
                         dp_noise_multiplier=0.5, rounds=3)
    ckcfg = tcfg.replace(run=dataclasses.replace(tcfg.run,
                                                 checkpoint_dir=ck))
    init = jax_init(jcfg)
    with _fleet(tcfg, 3) as (b, _):
        straight = _coordinator(tcfg, b, init, 3)
        straight.fit(rounds=2)
        rdp_2 = straight.accountant.total_rdp.copy()
        straight.fit(rounds=1)
        want = _host_params(straight)
        straight.close()

        first = _coordinator(ckcfg, b, init, 3)
        first.fit(rounds=2)

        class Killed(Exception):
            pass

        def killed():
            raise Killed

        first.save_checkpoint = killed
        with pytest.raises(Killed):
            first.fit(rounds=1)
        first.close()
        wal = RoundWal(ck).load()
        assert [e["round"] for e in wal] == [0, 1, 2]
        assert all(sorted(e) == ["accepted", "completed", "round",
                                 "total_weight"] for e in wal)
        assert wal[0]["accepted"] == [0, 1, 2] and wal[0]["completed"] == 3

        before = _counter("ckpt.wal_uncommitted_discarded_total")
        resumed = FederatedCoordinator(ckcfg, b.host, b.port,
                                       want_evaluator=False, device="cpu")
        try:
            assert resumed.restore_checkpoint() == 2
            assert _counter("ckpt.wal_uncommitted_discarded_total") == \
                before + 1
            assert [e["round"] for e in RoundWal(ck).load()] == [0, 1]
            assert np.array_equal(resumed.accountant.total_rdp, rdp_2)
            assert resumed.accountant.steps == 2
            resumed.enroll(min_devices=3, timeout=WAIT)
            resumed.fit()
            assert len(resumed.history) == 3
            assert _params_equal(want, resumed.server_state.params)
            assert [e["round"] for e in RoundWal(ck).load()] == [0, 1, 2]
            assert (resumed.history[-1]["dp_epsilon"]
                    == straight.history[-1]["dp_epsilon"])
        finally:
            resumed.close()


def test_async_coordinator_resume_sets_version_and_replays_the_accountant(
        tmp_path):
    """One trainer and K = 1, where the fold order cannot follow the
    threads' arrival: three DP aggregations straight against two, a
    restore (twice: the replay charges once) and one more, bit for
    bit."""
    jcfg, tcfg = configs(num_clients=1, dp_clip=1.0,
                         dp_noise_multiplier=1.0, rounds=3)
    ckcfg = tcfg.replace(run=dataclasses.replace(
        tcfg.run, checkpoint_dir=str(tmp_path), ckpt_stream=True))
    init = jax_init(jcfg)
    with _fleet(tcfg, 1) as (b, _):
        straight = _coordinator(tcfg, b, init, 1,
                                cls=AsyncFederatedCoordinator, buffer_size=1)
        straight.fit(aggregations=3)
        want = _host_params(straight)
        straight.close()
        first = _coordinator(ckcfg, b, init, 1,
                             cls=AsyncFederatedCoordinator, buffer_size=1)
        first.fit(aggregations=2)
        eps = first.accountant.epsilon()
        first.close()
        resumed = AsyncFederatedCoordinator(ckcfg, b.host, b.port,
                                            buffer_size=1,
                                            want_evaluator=False,
                                            device="cpu")
        try:
            for _ in range(2):          # a repeated restore charges once
                assert resumed.restore_checkpoint() == 2
                assert resumed.version == 2
                assert resumed._snap_cache is None
                assert resumed.accountant.steps == 2
                assert resumed.accountant.epsilon() == eps
            assert _params_equal(_host_params(first),
                                 resumed.server_state.params)
            resumed.enroll(min_devices=1, timeout=WAIT)
            resumed.fit(aggregations=1)
            assert [r["model_version"] for r in resumed.history] == [1, 2, 3]
            assert _params_equal(want, resumed.server_state.params)
        finally:
            resumed.close()


# ---------------------------------------- challenge-on-resume (ledger) --
def _ledger_cfg(num_clients, ckpt_dir):
    _, tcfg = configs(num_clients=num_clients, local_steps=2)
    return tcfg.replace(run=dataclasses.replace(
        tcfg.run, name="ledger_test", checkpoint_dir=ckpt_dir))


def _enroll_coordinator(cfg, b, n):
    coord = FederatedCoordinator(cfg, b.host, b.port, round_timeout=WAIT,
                                 device="cpu")
    coord.enroll(min_devices=n, timeout=WAIT)
    return coord


def _rejections(reason):
    return _counter("comm.enroll_challenge_rejected_total", reason=reason)


def _workers(cfg, b, ids):
    return [DeviceWorker(cfg, i, b.host, b.port, device="cpu").start()
            for i in ids]


def test_resume_readmits_only_ledger_verified_devices(tmp_path):
    cfg = _ledger_cfg(3, str(tmp_path))
    with broker.MessageBroker() as b:
        first = _workers(cfg, b, range(2))
        late = []
        try:
            _enroll_coordinator(cfg, b, 2).close()
            assert set(EnrollmentLedger(str(tmp_path)).devices()) == \
                {"0", "1"}
            # A third device announces after the crash: its retained record
            # replays into the resumed enrollment, and no ledger line
            # vouches for it.
            late = _workers(cfg, b, [2])
            base = _rejections("not_in_ledger")
            resumed = _enroll_coordinator(cfg, b, 3)
            out = resumed.verify_resumed_devices()
            assert sorted(out["verified"]) == ["0", "1"]
            assert out["rejected"] == ["2"]
            assert _rejections("not_in_ledger") == base + 1
            survivors = {t.device_id for t in resumed.trainers} | (
                {resumed.evaluator.device_id} if resumed.evaluator else set())
            assert "2" not in survivors
            resumed.close()
            assert "2" not in EnrollmentLedger(str(tmp_path)).devices()
        finally:
            for w in first + late:
                w.stop()


def test_resume_rejects_forged_and_undecodable_ledger_keys(tmp_path):
    cfg = _ledger_cfg(2, str(tmp_path))
    with broker.MessageBroker() as b:
        workers = _workers(cfg, b, range(2))
        try:
            _enroll_coordinator(cfg, b, 2).close()
            led = EnrollmentLedger(str(tmp_path))
            devs = led.devices()
            _, wrong_pub = keyexchange.generate_keypair()
            e0 = dict(devs["0"], pubkey=keyexchange.encode_public(wrong_pub))
            e1 = dict(devs["1"], pubkey="not-hex-not-a-key")
            with open(led.path, "w", encoding="utf-8") as f:
                f.write(json.dumps(e0) + "\n" + json.dumps(e1) + "\n")
            base_tag = _rejections("bad_tag")
            base_key = _rejections("bad_ledger_key")
            resumed = _enroll_coordinator(cfg, b, 2)
            out = resumed.verify_resumed_devices()
            assert out["verified"] == []
            assert sorted(out["rejected"]) == ["0", "1"]
            assert _rejections("bad_tag") == base_tag + 1
            assert _rejections("bad_ledger_key") == base_key + 1
            assert resumed.trainers == [] and resumed.evaluator is None
            resumed.close()
        finally:
            for w in workers:
                w.stop()


def test_preledger_entry_admits_on_presence_alone(tmp_path):
    cfg = _ledger_cfg(2, str(tmp_path))
    with broker.MessageBroker() as b:
        workers = _workers(cfg, b, range(2))
        try:
            _enroll_coordinator(cfg, b, 2).close()
            led = EnrollmentLedger(str(tmp_path))
            entries = [dict(e, pubkey="") for e in led.devices().values()]
            with open(led.path, "w", encoding="utf-8") as f:
                for e in entries:
                    f.write(json.dumps(e) + "\n")
            resumed = _enroll_coordinator(cfg, b, 2)
            out = resumed.verify_resumed_devices()
            assert sorted(out["verified"]) == ["0", "1"]
            assert out["rejected"] == []
            resumed.close()
        finally:
            for w in workers:
                w.stop()


def test_reannounce_supersedes_stale_retained_record(tmp_path):
    cfg = _ledger_cfg(1, str(tmp_path))
    with broker.MessageBroker() as b:
        stale = BrokerClient(b.host, b.port)
        enrollment.announce(stale, enrollment.DeviceInfo(
            device_id="0", host="127.0.0.1", port=9))   # nothing listens
        stale.close()
        worker = DeviceWorker(cfg, 0, b.host, b.port, device="cpu").start()
        try:
            coord = FederatedCoordinator(cfg, b.host, b.port,
                                         round_timeout=WAIT,
                                         want_evaluator=False, device="cpu")
            coord.enroll(min_devices=1, timeout=WAIT)
            assert [t.port for t in coord.trainers] == [worker.port]
            assert EnrollmentLedger(
                str(tmp_path)).devices()["0"]["port"] == worker.port
            coord.close()
        finally:
            worker.stop()


# ---------------------------------------------------------------- CLI --
TINY = ["--backend", "cpu", "--config", "mnist_mlp_fedavg", "--dataset",
        "mnist_tiny", "--num-clients", "2", "--local-steps", "2"]


def _events(err):
    return [json.loads(line) for line in err.splitlines()
            if line.startswith('{"event"')]


def test_coordinate_resume_events(tmp_path, capsys):
    """``coordinate --resume`` starts cold on an empty directory (the
    asynchronous coordinator, which runs no challenge); a synchronous run
    relaunched with more rounds prints ``resumed`` (with the streaming
    digest) and ``challenge_verified``, and runs the remaining round."""
    ck = str(tmp_path / "ck")
    argv_cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["worker", *TINY, "--broker-port", "1"]))
    with _fleet(argv_cfg, 2) as (b, _):
        base = ["coordinate", *TINY, "--broker-port", str(b.port),
                "--min-devices", "2", "--no-evaluator", "--enroll-timeout",
                str(WAIT), "--ckpt-stream"]
        cli.main([*base, "--checkpoint-dir", str(tmp_path / "async"),
                  "--async-buffer", "2", "--rounds", "1", "--resume"])
        assert _events(capsys.readouterr().err)[0] == {
            "event": "resume_cold"}
        base += ["--checkpoint-dir", ck]
        cli.main([*base, "--rounds", "1"])
        assert _events(capsys.readouterr().err) == []
        before = _counter("fed.rounds_resumed_total")
        last = cli.main([*base, "--rounds", "2", "--resume"])
        assert last["round"] == 1
        events = _events(capsys.readouterr().err)
        _, _, digest = load_generation_host(ck, step=1)
        assert events[0] == {"event": "resumed", "round": 1,
                             "rounds_resumed_total": before + 1,
                             "ckpt_digest": digest, "ckpt_discarded": 0,
                             "resharded": 0}
        assert events[1]["event"] == "challenge_verified"
        assert sorted(events[1]["verified"]) == ["0", "1"]
        assert events[1]["rejected"] == []
    assert len(RoundWal(ck).load()) == 2
    assert StreamingCheckpointer(ck).latest_step() == 2


def test_train_resume_continues_to_the_uninterrupted_checkpoint(tmp_path,
                                                                capsys):
    straight, resumed = str(tmp_path / "a"), str(tmp_path / "b")
    cli.main(["train", *TINY, "--rounds", "2", "--checkpoint-dir", straight])
    cli.main(["train", *TINY, "--rounds", "1", "--checkpoint-dir", resumed])
    capsys.readouterr()
    summary = cli.main(["train", *TINY, "--rounds", "2", "--checkpoint-dir",
                        resumed, "--resume"])
    err = capsys.readouterr().err
    assert "resumed at round 1" in err.splitlines()
    assert summary["rounds"] == 1
    a = list(RoundCheckpointer(straight).load_leaves(2))
    b = list(RoundCheckpointer(resumed).load_leaves(2))
    assert [p for p, _ in a] == [p for p, _ in b]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))


def test_resume_without_a_checkpoint_raises_in_train(tmp_path):
    with pytest.raises(FileNotFoundError):
        cli.main(["train", *TINY, "--rounds", "1", "--checkpoint-dir",
                  str(tmp_path), "--resume"])



# ------------------------------------------- the sharded server's state --
def _sharded_cfgs(tmp_path, tp_size, name, stream=True, **fed):
    jcfg, tcfg = configs(num_clients=3, strategy="fedadam", server_lr=0.05,
                         rounds=3, run_kw=dict(tp_size=tp_size), **fed)
    return jcfg, tcfg.replace(run=dataclasses.replace(
        tcfg.run, checkpoint_dir=str(tmp_path / name), ckpt_stream=stream))


def _host_state(c):
    """The coordinator's state as host bytes per flax path (placement-free:
    a sharded leaf is read shard by shard into one buffer)."""
    from colearn_federated_learning_tpu_torch.parallel import partition

    return {path: partition.host_leaf(leaf).tobytes()
            for path, leaf in streaming.flatten_state(
                c._checkpoint_server_state())}


def _is_sharded(c) -> bool:
    return any(len(getattr(l, "parts", ())) > 1
               for _, l in streaming.flatten_state(c._checkpoint_server_state()))


def test_tp2_save_writes_a_file_per_shard_and_resumes_on_tp1(tmp_path):
    """A tp = 2 coordinator's generation holds 2 shard files (each sharded
    leaf in 2 slices, the gather it avoided counted); a tp = 1
    coordinator restores it bitwise and counts a resharded resume."""
    jcfg, tcfg2 = _sharded_cfgs(tmp_path, 2, "ck")
    _, tcfg1 = _sharded_cfgs(tmp_path, 1, "ck")
    with _fleet(tcfg2, 3) as (b, _):
        saver = _coordinator(tcfg2, b, jax_init(jcfg), 3)
        assert _is_sharded(saver)
        before = _counter("comm.gather_bytes_avoided_total")
        saver.fit(rounds=2)
        assert _counter("comm.gather_bytes_avoided_total") > before
        want = _host_state(saver)
        saver.close()
        gen = tmp_path / "ck" / "gen_00000002"
        assert sorted(p.name for p in gen.iterdir()) == [
            "history.json", "manifest.json", "shard_00000.npz",
            "shard_00001.npz"]
        manifest = json.load(open(gen / "manifest.json"))
        assert manifest["saved_shards"] == 2
        assert {len(l["slices"]) for l in manifest["leaves"]} == {1, 2}
        before = _counter("ckpt.resharded_resumes_total")
        resumed = FederatedCoordinator(tcfg1, b.host, b.port,
                                       want_evaluator=False, device="cpu")
    try:
        assert resumed._placement is None
        assert resumed.restore_checkpoint() == 2
        assert _counter("ckpt.resharded_resumes_total") == before + 1
        assert _host_state(resumed) == want
        _, _, digest = load_generation_host(str(tmp_path / "ck"))
        assert resumed._ckpt.last_restore_digest == digest
    finally:
        resumed.close()


@pytest.mark.parametrize("saved,restored,counted", [(1, 2, True),
                                                    (2, 2, False)])
def test_resharded_follows_jax_s_rule(tmp_path, saved, restored, counted):
    """JAX's rule: a resume is resharded when the saved slice count of a
    leaf differs from the template's shard count.  A tp = 1 save resumed
    at tp = 2 is; its shards land on their positions.  A tp = 2 save
    resumed at tp = 2 is not."""
    jcfg, tsave = _sharded_cfgs(tmp_path, saved, "ck")
    _, tload = _sharded_cfgs(tmp_path, restored, "ck")
    with _fleet(tsave, 3) as (b, _):
        saver = _coordinator(tsave, b, jax_init(jcfg), 3)
        saver.fit(rounds=1)
        want = _host_state(saver)
        saver.close()
        before = _counter("ckpt.resharded_resumes_total")
        resumed = FederatedCoordinator(tload, b.host, b.port,
                                       want_evaluator=False, device="cpu")
    try:
        live = {k: v.data_ptr() for k, v in
                resumed.server_state.params.items()}
        assert resumed.restore_checkpoint() == 1
        assert _counter("ckpt.resharded_resumes_total") == before + int(
            counted)
        assert _host_state(resumed) == want and _is_sharded(resumed)
        # Restored into the live shards, each on its own position.
        assert {k: v.data_ptr() for k, v in
                resumed.server_state.params.items()} == live
        for _, leaf in streaming.flatten_state(
                resumed._checkpoint_server_state()):
            for part, pos in zip(getattr(leaf, "parts", ()),
                                 range(resumed._placement.n_devices)):
                assert part.device == resumed._placement.devices[pos]
    finally:
        resumed.close()


@pytest.mark.parametrize("tp_load", [1, 2])
def test_tp2_generations_move_between_port_and_jax(tmp_path, tp_load):
    """A port generation saved at tp = 2 restores in JAX at tp = 1 and at
    tp = 2, and JAX's in the port, with equal digests and equal
    leaves."""
    from colearn_federated_learning_tpu.parallel import partition as jpart
    from colearn_federated_learning_tpu_torch.parallel import partition

    rng = np.random.default_rng(17)
    params = {"params": {
        "Dense_0": {"kernel": rng.standard_normal((6, 8)).astype(np.float32),
                    "bias": rng.standard_normal(8).astype(np.float32)},
        "Dense_1": {"kernel": rng.standard_normal((8, 4)).astype(np.float32),
                    "bias": rng.standard_normal(4).astype(np.float32)},
        "LayerNorm_0": {"scale": rng.standard_normal(5).astype(np.float32)}}}
    ours = partition.make_server_placement(params, 2, "model", "mlp",
                                           device="cpu")
    theirs = jpart.make_server_placement(params, 2, "model", "mlp",
                                         devices=jax.devices("cpu")[:2])
    hist = [{"round": 0}]
    StreamingCheckpointer(str(tmp_path / "port")).save(
        1, (ours.shard(params),), hist)
    JaxStreaming(str(tmp_path / "jax")).save(1, (theirs.shard(params),),
                                             hist)
    want = [np.asarray(l).tobytes() for l in jax.tree.leaves(params)]
    for side in ("port", "jax"):
        names = sorted(os.listdir(tmp_path / side / "gen_00000001"))
        assert names == ["history.json", "manifest.json", "shard_00000.npz",
                         "shard_00001.npz"], side
    # The port's generation in JAX, and JAX's in the port.
    jtmpl = ((theirs.shard(jax.tree.map(np.zeros_like, params)),)
             if tp_load == 2 else (jax.tree.map(np.zeros_like, params),))
    jck = JaxStreaming(str(tmp_path / "port"))
    (jstate,), _, step = jck.restore(jtmpl)
    assert step == 1
    assert [np.asarray(jpart.host_leaf(l)).tobytes()
            for l in jax.tree.leaves(jstate)] == want
    zeros = {"params": {k: {n: np.zeros_like(a) for n, a in v.items()}
                        for k, v in params["params"].items()}}
    ttmpl = ((ours.shard(zeros),) if tp_load == 2
             else (trees_to_torch(zeros),))
    tck = StreamingCheckpointer(str(tmp_path / "jax"))
    (tstate,), _, step = tck.restore(ttmpl)
    assert step == 1
    assert [partition.host_leaf(l).tobytes() for _, l in
            streaming.flatten_state(tstate)] == want
    _, _, d_port = jax_load_generation(str(tmp_path / "port"))
    _, _, d_jax = load_generation_host(str(tmp_path / "jax"))
    assert d_port == d_jax == jck.last_restore_digest \
        == tck.last_restore_digest


def trees_to_torch(tree):
    from colearn_federated_learning_tpu_torch.utils import trees

    return trees.map_leaves(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("stream", [True, False],
                         ids=["streaming", "round"])
def test_coordinator_resumed_at_another_tp_goes_on_bitwise(tmp_path,
                                                           stream):
    """Three FedAdam rounds at tp = 1 straight, against two at tp = 2
    saved, and a tp = 1 coordinator resumed from them for the third: the
    state (params and moments) ends bit for bit the same."""
    jcfg, tcfg2 = _sharded_cfgs(tmp_path, 2, "ck", stream=stream)
    _, tcfg1 = _sharded_cfgs(tmp_path, 1, "ck", stream=stream)
    _, plain = configs(num_clients=3, strategy="fedadam", server_lr=0.05,
                       rounds=3)
    init = jax_init(jcfg)
    with _fleet(tcfg1, 3) as (b, _):
        straight = _coordinator(plain, b, init, 3)
        straight.fit(rounds=3)
        want = _host_state(straight)
        straight.close()
        first = _coordinator(tcfg2, b, init, 3)
        first.fit(rounds=2)
        first.close()
        resumed = FederatedCoordinator(tcfg1, b.host, b.port,
                                       want_evaluator=False, device="cpu")
        try:
            assert resumed.restore_checkpoint() == 2
            resumed.enroll(min_devices=3, timeout=WAIT)
            resumed.fit()
            assert len(resumed.history) == 3
            assert _host_state(resumed) == want
        finally:
            resumed.close()
