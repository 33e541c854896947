"""Checkpoints of a learner on a client mesh: the port's save and restore
on 4 spawned gloo ranks (``tests/torch_port_ranks.py``) against the JAX
engine on ``cpu_devices[:4]``.

- SCAFFOLD on a 4-way ``clients`` axis: 6 real clients ghost-padded to 8
  and interleaved, cohort 4 (1 per device), MLP on mnist_tiny.  One run
  saves after round 1, a fresh mesh learner restores it and runs round 2:
  the params, the server control and every variate row equal the
  uninterrupted run's bit for bit.  The step holds JAX's layout: its
  ``client_c`` leaves have the shapes of JAX's (8 slots) and JAX's slot
  order (the ghost slots' rows zero), and its leaves agree with what
  JAX's engine saved after the same round.
- FedAdam on a (clients 2, model 2) mesh (BERT at width 32, vocab, heads
  and MLP sharded), full participation: saved after round 1 with the
  params and both moments gathered whole, then restored at tp 2 on the
  same mesh, at tp 1 on a 4-way clients axis and on one device.  Every
  restore puts back the saved state bit for bit (each rank cuts its
  slices from the whole leaves); the tp 2 resume then equals the
  uninterrupted run bit for bit.  At tp 1 and on one device round 2 runs
  untiled, whose sums part from the tiled round's at f32 roundoff: those
  are held to ROADMAP's f32 bounds of the uninterrupted run.
- A clients axis of another size.  JAX's engine, restoring a 4-way
  SCAFFOLD step on 2 devices, keeps the saved ``client_c`` as it was
  written (8 rows, in the 4-way mesh's slot order) beside its 6 slots,
  and its next round raises ``ValueError`` (so does any round after a
  restore on JAX's mesh: the restored server state is committed to one
  device).  The port raises ``ValueError`` at the restore, naming the
  slot counts, and re-permutes nothing.
- The same slot count in another order (8 clients: no ghosts on 4, 2 or
  1 devices).  JAX's one device restores a 4-way step's rows as written
  and trains on them, each on another client than saved them.  The port
  refuses it: every step records its slot order, and a SCAFFOLD restore
  in another order (4-way to 2-way, 4-way to one device, one device to
  4-way) raises ``ValueError``.

Every run replays JAX's draws (``record_draws``).  The port against JAX's
uninterrupted mesh run: f32, rtol 1e-4 / atol 2e-5.
"""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from colearn_federated_learning_tpu.ckpt import RoundCheckpointer as JaxCkpt
from colearn_federated_learning_tpu.fed import FederatedLearner as JaxLearner
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu_torch.ckpt import streaming
from colearn_federated_learning_tpu_torch.utils import config
from test_torch_port_mesh import record_draws
from test_torch_port_sp_tp import BERT
from torch_port_ranks import spawn

RTOL, ATOL = 1e-4, 2e-5
WORLD, ROUNDS = 4, 2


def _configs(data, model, fed, ckpt_dir=""):
    kw = dict(data=data, model=model,
              fed=dict(dict(rounds=ROUNDS, local_steps=2, batch_size=8,
                            lr=0.05, momentum=0.0, local_optimizer="sgd"),
                       **fed),
              run=dict(seed=3))
    out = []
    for mod in (jax_config, config):
        out.append(mod.ExperimentConfig(
            data=mod.DataConfig(**kw["data"]),
            model=mod.ModelConfig(**kw["model"]),
            fed=mod.FedConfig(**kw["fed"]),
            run=mod.RunConfig(**kw["run"], checkpoint_dir=ckpt_dir)))
    return out


SCAFFOLD = (dict(dataset="mnist_tiny", partition="iid", num_clients=6),
            dict(name="mlp", num_classes=10, hidden_dim=32, depth=2),
            dict(strategy="scaffold", cohort_size=4))
EQUAL = (dict(SCAFFOLD[0], num_clients=8),) + SCAFFOLD[1:]   # 8 slots on
# 4 devices, on 2 and on one: the same count, three slot orders
FEDADAM_TP = (dict(dataset="agnews_tiny", partition="iid", num_clients=4,
                   max_examples_per_client=16),
              dict(BERT),
              dict(strategy="fedadam", batch_size=4, server_lr=0.01))
TP_MESH = (("clients", "model"), (2, 2))
TP_RESUMES = [(("clients",), (WORLD,)), None, TP_MESH]   # tp 1, one device, tp 2


def _jax_state(jl):
    """JAX's ``(server_state, client_c)`` flattened as the port's step
    paths, as numpy copies (the host-resident ``client_c`` is updated in
    place by later rounds)."""
    state = jax.device_get((jl.server_state, jl.client_c))
    return {path: np.array(leaf)
            for path, leaf in streaming.flatten_state(state)}


@pytest.fixture(scope="module")
def runs(cpu_devices, tmp_path_factory):
    """The port's ranks on both cases and the resize, JAX meanwhile."""
    import threading

    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    jobs, jax_runs = [], {}
    for name, case, axes, shape, resumes in (
            ("scaffold", SCAFFOLD, ("clients",), (WORLD,),
             [(("clients",), (WORLD,))]),
            ("fedadam_tp", FEDADAM_TP, TP_MESH[0], TP_MESH[1], TP_RESUMES)):
        jck = str(tmp / f"jax_{name}")
        jcfg, tcfg = _configs(*case, ckpt_dir=jck)
        tcfg = tcfg.replace(run=dataclasses.replace(tcfg.run,
                                                    checkpoint_dir=""))
        mesh = Mesh(np.array(cpu_devices[:WORLD]).reshape(shape), axes)
        jl = JaxLearner(jcfg, mesh=mesh)
        jax_runs[name] = jl
        jobs.append(("mesh_resume", dict(
            config=tcfg, mesh=(axes, shape), rounds=ROUNDS,
            ckpt_dir=str(tmp / f"port_{name}"), resumes=resumes,
            params=jax.device_get(jl.params),
            draws=record_draws(jl, tcfg, ROUNDS))))
    jobs.append(("mesh_resize", dict(
        config=_configs(*SCAFFOLD, ckpt_dir=str(tmp / "port_scaffold"))[1],
        size=2, equal=_configs(*EQUAL, ckpt_dir=str(tmp / "port_equal"))[1],
        equal_one=str(tmp / "port_equal_one"))))
    box = {}

    def run_ranks():
        try:
            box["ranks"] = spawn(WORLD, tmp / "ranks", jobs, timeout=300.0)
        except Exception as e:           # re-raised below
            box["ranks"] = e

    (tmp / "ranks").mkdir()
    th = threading.Thread(target=run_ranks)
    th.start()
    out = {}
    for name, jl in jax_runs.items():
        jl.fit(rounds=1)                 # orbax saves the last round
        saved = _jax_state(jl)
        written = JaxCkpt(jl.config.run.checkpoint_dir).restore(
            (jl.server_state, jl.client_c))[0]
        written = {path: np.asarray(leaf) for path, leaf in
                   streaming.flatten_state(jax.device_get(written))}
        jl.run_round()
        out[name] = dict(saved=saved, written=written,
                         final=_jax_state(jl), learner=jl)
    # JAX's resize: the 4-way SCAFFOLD step restored on 2 devices.
    jcfg = _configs(*SCAFFOLD, ckpt_dir=str(tmp / "jax_scaffold"))[0]
    jl2 = JaxLearner(jcfg, mesh=Mesh(np.array(cpu_devices[:2]),
                                     ("clients",)))
    slots = jl2.num_clients
    step = jl2.restore_checkpoint()
    restored = jax.tree.leaves(jax.device_get(jl2.client_c))
    try:
        jl2.run_round()
        round_error = None
    except ValueError as e:
        round_error = e
    out["resize"] = dict(step=step, slots=slots, rows=restored,
                         round_error=round_error)
    # JAX's one device restoring a 4-way step of as many slots: the rows
    # stay as written (in the 4-way order) and the round runs on them.
    jcfg = _configs(*EQUAL, ckpt_dir=str(tmp / "jax_equal"))[0]
    saver = JaxLearner(jcfg, mesh=Mesh(np.array(cpu_devices[:WORLD]),
                                       ("clients",)))
    saver.fit(rounds=1)
    jl1 = JaxLearner(jcfg)
    jl1.restore_checkpoint()
    out["equal"] = dict(
        saver_ids=np.asarray(saver.client_ids), ids=np.asarray(jl1.client_ids),
        as_written=all(np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(jax.device_get(saver.client_c)),
            jax.tree.leaves(jax.device_get(jl1.client_c)))),
        round=jl1.run_round())
    th.join()
    if isinstance(box["ranks"], Exception):
        raise box["ranks"]
    out["ranks"] = box["ranks"]
    return out


def _bitwise(a: dict, b: dict, what: str):
    assert sorted(a) == sorted(b), (what, sorted(set(a) ^ set(b)))
    for path in a:
        assert np.array_equal(a[path], b[path]), (what, path)


def _close(got: dict, want: dict, what: str):
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want)))
    for path, w in want.items():
        assert got[path].shape == w.shape, (what, path)
        np.testing.assert_allclose(np.asarray(got[path], np.float64),
                                   np.asarray(w, np.float64), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} {path}")


def test_scaffold_mesh_resume_is_bitwise_and_matches_jax(runs):
    jx = runs["scaffold"]
    for rank, r in enumerate(runs["ranks"]):
        out = r[0]
        assert out[("step", 0)] == 1
        _bitwise(out[("restored", 0)], out["saved"], f"rank {rank} restore")
        _bitwise(out[("resumed", 0)], out["straight"], f"rank {rank} resume")
        assert [h["round"] for h in out[("history", 0)]] == [0, 1]
        _close(out["straight"], jx["final"], f"rank {rank} vs JAX")


def test_scaffold_step_has_jax_s_layout_and_slot_order(runs):
    jx, jl = runs["scaffold"], runs["scaffold"]["learner"]
    leaves = runs["ranks"][0][0]["leaves"]
    # The step holds what JAX's engine writes: the same paths, the shapes
    # of JAX's (client_c with the 8 padded slots) and its values.
    _close(leaves, jx["written"], "step vs JAX's step")
    _close(leaves, jx["saved"], "step vs JAX's state")
    ghosts = np.flatnonzero(np.asarray(jl.client_ids) >= jl.real_num_clients)
    assert len(ghosts) == 2
    rows = [v for p, v in leaves.items() if p.startswith("1/")]
    assert rows and all(v.shape[0] == jl.num_clients == 8 for v in rows)
    for v in rows:
        assert not v[ghosts].any()
    # Slot order: the rows that moved are the contributors' slots, JAX's.
    moved = {int(i) for v in rows
             for i in np.flatnonzero(np.abs(v).reshape(8, -1).sum(1))}
    want = {int(i) for p, v in jx["written"].items() if p.startswith("1/")
            for i in np.flatnonzero(np.abs(v).reshape(8, -1).sum(1))}
    assert moved == want and len(moved) == 4


def test_fedadam_tp_resumes_at_tp2_tp1_and_on_one_device(runs):
    jx = runs["fedadam_tp"]
    labels = ["tp1", "one device", "tp2"]
    for rank, r in enumerate(runs["ranks"]):
        out = r[1]
        for i, label in enumerate(labels):
            assert out[("step", i)] == 1, label
            _bitwise(out[("restored", i)], out["saved"],
                     f"rank {rank} restore at {label}")
            resumed = out[("resumed", i)]
            if label == "tp2":
                _bitwise(resumed, out["straight"], f"rank {rank} tp2")
            else:
                _close(resumed, out["straight"], f"rank {rank} {label}")
            _close(resumed, jx["final"], f"rank {rank} {label} vs JAX")
    leaves = runs["ranks"][0][1]["leaves"]
    _close(leaves, jx["written"], "tp 2 step vs JAX's step")
    # Whole leaves: the embedding of the 2000-token vocab, not a half.
    emb = [v for p, v in leaves.items() if p.endswith("embedding")]
    assert emb and all(v.shape[0] == 2000 for v in emb)


def test_resize_of_the_clients_axis_raises_as_jax(runs):
    rz = runs["resize"]
    # JAX: the restore keeps the saved rows (8 slots, the 4-way order)
    # beside its 6 slots, and the next round raises ValueError.
    assert rz["step"] == 1 and rz["slots"] == 6
    written = [v for p, v in runs["scaffold"]["written"].items()
               if p.startswith("1/")]
    assert all(r.shape[0] == 8 for r in rz["rows"])
    assert all(np.array_equal(a, b) for a, b in zip(rz["rows"], written))
    assert isinstance(rz["round_error"], ValueError)
    # The port: ValueError at the restore, naming both slot counts.
    for rank, r in enumerate(runs["ranks"]):
        res = r[2]["pad"]
        if rank >= 2:
            assert res is None
            continue
        assert res["slots"] == 6
        assert "8 client slots" in res["error"]
        assert "has 6" in res["error"]


def test_equal_slot_count_in_another_order_is_refused(runs):
    eq = runs["equal"]
    # JAX: one device takes a 4-way step of 8 slots as written, so slot 1
    # (client 1 here) gets the 4-way mesh's slot 1 (client 4), and its
    # round runs on the misplaced variates.
    assert list(eq["saver_ids"]) == [0, 4, 1, 5, 2, 6, 3, 7]
    assert list(eq["ids"]) == list(range(8))
    assert eq["as_written"] and np.isfinite(eq["round"]["train_loss"])
    # The port refuses every restore whose slot order differs, at the
    # same slot count: 4-way to 2-way, 4-way to one device, one device
    # to 4-way.
    for rank, r in enumerate(runs["ranks"]):
        res = r[2]
        cases = {"to1": "4-way", "from1": "1-way"}
        if rank < 2:
            cases["to2"] = "4-way"
        else:
            assert res["to2"] is None
        for case, saver in cases.items():
            assert res[case]["slots"] == 8, (rank, case)
            err = res[case]["error"]
            assert err and "8 client slots" in err, (rank, case, err)
            assert f"order of a {saver} clients axis" in err, (rank, case)
