"""Pod shapes of the port against the JAX package (the counterpart of
``tests/test_pod_shape.py``) and the port's dry-run entry points
(``dryrun.py``, the counterpart of ``__graft_entry__.py``).

- The full 3-D composition, MoE-BERT with ring attention on a (clients 2,
  seq 2, model 2) mesh of 8 spawned gloo ranks (data, sequence, tensor
  and expert parallelism in one round), against JAX's single-device vmap
  round (which runs the dense twin on unsharded experts) on the same
  batch draws and initial params, and against the port's own
  single-device round: ``train_loss`` at rtol 1e-4, the params at rtol
  2e-3 / atol 5e-4, JAX's bounds in ``tests/test_pod_shape.py`` (a
  different reduction order over 2 local steps drifts a few 1e-4 in
  isolated small elements; a sharding fault diverges by orders).
- ``dryrun_multichip`` on 1, 6 and 8 gloo ranks (its 1-D CNN mesh with DP
  and secure aggregation; the 2-D dense-BERT and 3-D MoE-BERT meshes), and
  its refusals: no card, and more ranks than cards.
- The bench at 4 ranks: JAX's ``n_devices``, mesh-adjusted cohort and
  samples per round for 4 devices.
- ``entry()``'s forward against JAX's ``entry()`` on the same parameters
  (through ``convert.py``) at f32 bounds, with the flagship config cut to
  a narrow f32 ViT in both packages (the full ViT-B/16 is the card's).
- The counterparts of JAX's three ``slow`` pod tests (cohort 64 over 16
  ranks, cohort 256 over 32, the dry run at 32), marked ``slow`` as JAX's
  are.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.fed import FederatedLearner as JaxLearner
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu_torch import bench, convert, dryrun
from colearn_federated_learning_tpu_torch.fed import FederatedLearner
from colearn_federated_learning_tpu_torch.utils import config
from test_torch_port_round import JaxDraws
from torch_port_ranks import RecordedDraws, spawn

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-4, 2e-5                  # f32 paths
POD_RTOL, POD_ATOL = 2e-3, 5e-4          # tests/test_pod_shape.py:84-92
POD = (("clients", "seq", "model"), (2, 2, 2))


def _moe_ring_cfgs():
    """``tests/test_pod_shape.py``'s configuration, in both packages."""
    kw = dict(
        data=dict(dataset="agnews_tiny", num_clients=4, partition="iid",
                  max_examples_per_client=8),
        model=dict(name="moe_bert", num_classes=4, width=16, depth=2,
                   num_heads=2, seq_len=64, vocab_size=2000, num_experts=4,
                   attn_impl="ring"),
        fed=dict(strategy="fedavg", rounds=1, cohort_size=0, local_steps=2,
                 batch_size=4, lr=0.05, momentum=0.9),
        run=dict(name="pod_3d"))
    return [mod.ExperimentConfig(
        data=mod.DataConfig(**kw["data"]), model=mod.ModelConfig(**kw["model"]),
        fed=mod.FedConfig(**kw["fed"]), run=mod.RunConfig(**kw["run"]))
        for mod in (jax_config, config)]


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def pod(cpu_devices, tmp_path_factory):
    """JAX's vmap round, the port's (2, 2, 2) round on 8 ranks and its
    single-device round, all from JAX's initial params and batch draws."""
    jcfg, tcfg = _moe_ring_cfgs()
    jl = JaxLearner(jcfg)
    params = jax.device_get(jl.params)
    jd = JaxDraws(jcfg.run.seed)
    counts = np.asarray(jl.shards.counts)
    draws = {"batch": {(0, i): jd.batch_indices(0, i, int(counts[i]),
                                                jl.num_steps,
                                                jcfg.fed.batch_size)
                       for i in range(jl.num_clients)}}
    ranks = spawn(8, tmp_path_factory.mktemp("pod"), [("learner_rounds", dict(
        config=tcfg, mesh=POD, rounds=1, params=params, draws=draws))],
        timeout=300.0)
    want = jl.run_round()
    single = FederatedLearner(tcfg, device="cpu", plan=RecordedDraws(draws))
    single.load_flax_params(params)
    return dict(
        ranks=[r[0] for r in ranks], jax=want,
        jax_params=convert.flax_to_state_dict(
            jax.tree.map(np.asarray, jax.device_get(
                jl.server_state.params))),
        single=single.run_round(),
        single_params={k: v.detach().numpy().copy()
                       for k, v in single.full_params().items()})


def test_3d_moe_ring_round_matches_jax_vmap_round(pod):
    want = pod["jax"]
    for rank, out in enumerate(pod["ranks"]):
        rec = out["records"][0]
        assert rec["completed"] == want["completed"] == 4, rank
        assert rec["total_weight"] == want["total_weight"], rank
        _close(rec["train_loss"], want["train_loss"], f"rank {rank} loss",
               rtol=1e-4, atol=0)
        assert set(out["params"]) == set(pod["jax_params"])
        for n, t in out["params"].items():
            _close(t, pod["jax_params"][n].numpy(), f"rank {rank} {n}",
                   POD_RTOL, POD_ATOL)


def test_3d_round_shards_every_axis(pod):
    """Each rank holds half of every sharded leaf (heads, MLP, vocab and
    expert banks) and its sequence slice; the clients axis carries 2
    clients per block."""
    for out in pod["ranks"]:
        sharded = {n for n, d in zip(out["params"], out["tp_dims"])
                   if d is not None}
        assert {"Embed_0.weight",
                "TransformerBlock_0.MultiHeadAttention_0.query.weight",
                "TransformerBlock_1.MoEFfn_0.experts_up"} <= sharded
        for n in sharded:
            full, local = out["params"][n].shape, out["local_shapes"][n]
            assert int(np.prod(full)) == 2 * int(np.prod(local)), n
        assert out["cohorts"][0]["clients"].size == 2


def test_3d_round_matches_the_ports_single_device_round(pod):
    want = pod["single"]
    for rank, out in enumerate(pod["ranks"]):
        rec = out["records"][0]
        assert rec["completed"] == want["completed"]
        _close(rec["train_loss"], want["train_loss"], f"rank {rank} loss",
               rtol=1e-4, atol=0)
        for n, t in out["params"].items():
            _close(t, pod["single_params"][n], f"rank {rank} {n}",
                   POD_RTOL, POD_ATOL)


@pytest.mark.parametrize("n", [1, 6, 8])
def test_dryrun_multichip_on_gloo_ranks(n):
    out = dryrun.dryrun_multichip(n, device="cpu")
    assert out["n_devices"] == n
    runs = out["runs"]
    assert runs[0]["mesh"] == {"clients": n} and runs[0]["model"] == "cnn"
    if n % 2:
        assert len(runs) == 1            # JAX skips the SP round too
    else:
        want = ({"clients": n // 4, "seq": 2, "model": 2}, "moe_bert") \
            if n % 4 == 0 else ({"clients": n // 2, "seq": 2}, "bert")
        assert (runs[1]["mesh"], runs[1]["model"]) == want
    for r in runs:
        assert r["completed"] >= 1 and np.isfinite(r["train_loss"]), r


def test_dryrun_refuses_the_card_it_lacks(monkeypatch):
    """No card: the card's entry points raise (no CPU fallback).  More
    ranks than cards: NCCL's one rank per card, both counts named."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=r"needs 2 cards .* has 1"):
        dryrun.check_world(2, "cuda")
    dryrun.check_world(1, "cuda")
    with pytest.raises(ValueError):
        dryrun.check_world(0, "cpu")


def test_bench_at_4_ranks_gives_jax_mesh_layout(cpu_devices, tmp_path):
    """The JAX bench on 4 devices: ``n_devices`` 4, the cohort cut to a
    multiple of 4 (10 -> 8), samples per round from that cohort, and the
    per-chip rate divided by 4."""
    from jax.sharding import Mesh

    from colearn_federated_learning_tpu import bench as jax_bench
    from colearn_federated_learning_tpu.data import registry as jax_data

    w = bench.CPU_WORKLOAD
    dataset = jax_data.get_dataset(
        w["dataset"], seed=0, max_train=w["num_clients"] *
        w["examples_per_client"], max_test=512)
    with pytest.warns(UserWarning, match="not a multiple"):
        jl = JaxLearner(jax_bench._make_config(w), dataset=dataset,
                        mesh=Mesh(np.array(cpu_devices[:4]), ("clients",)))
    want_samples = jl.cohort_size * jl.num_steps * w["batch"]
    ranks = spawn(4, tmp_path, [("bench", dict(rounds=1, warmup=0,
                                               workload=w))])
    for r in (rank[0] for rank in ranks):
        assert r["n_devices"] == jl.mesh.devices.size == 4
        assert r["cohort"] == jl.cohort_size == 8
        assert r["samples_per_round"] == want_samples
        assert r["client_samples_per_sec_per_chip"] == pytest.approx(
            r["rounds_per_sec"] * want_samples / 4)
        assert r["platform"] == "cpu" and r["rounds_timed"] == 1


def _jax_entry_module():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_forward_equals_jax_entry(cpu_devices, monkeypatch):
    small = dict(width=32, depth=2, num_heads=4, dtype="float32")
    for mod in (jax_config, config):
        cfg = mod.CONFIGS[dryrun.FLAGSHIP]
        monkeypatch.setitem(mod.CONFIGS, dryrun.FLAGSHIP, dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **small)))
    jfn, (jparams, jx) = _jax_entry_module().entry()
    fn, (params, x) = dryrun.entry(device="cpu")
    assert tuple(x.shape) == tuple(jx.shape) == dryrun.ENTRY_BATCH
    assert x.dtype == torch.float32 and not x.any()
    assert set(params) == set(convert.flax_to_state_dict(
        jax.tree.map(np.asarray, jparams)))
    ported = convert.flax_to_state_dict(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    xr = rng.standard_normal(dryrun.ENTRY_BATCH).astype(np.float32)
    for inp in (np.array(jx), xr):
        want = np.asarray(jfn(jparams, inp))
        got = fn(ported, torch.from_numpy(inp))
        assert got.shape == want.shape == (8, 62)
        _close(got.numpy(), want, "entry logits")


# ------------------------------------------- JAX's slow pod counterparts
@pytest.mark.slow
def test_cohort64_over_16_ranks(tmp_path):
    out = spawn(16, tmp_path, [("pod_rounds", dict(cohort=64,
                                                   num_clients=128))],
                timeout=600.0)[0][0]
    assert out["n_devices"] == 16
    assert out["num_clients"] == 128           # no ghost padding needed
    assert out["cohort_per_device"] == 4
    assert out["completed"] == [64, 64]
    assert all(np.isfinite(v) for v in out["train_loss"])
    assert all(w > 0 for w in out["total_weight"])


@pytest.mark.slow
def test_cohort256_over_32_ranks(tmp_path):
    out = spawn(32, tmp_path, [("pod_rounds", dict(cohort=256,
                                                   num_clients=512))],
                timeout=1200.0)[0][0]
    assert out["cohort_per_device"] == 8
    assert out["completed"] == [256, 256]
    assert out["train_loss"][1] < out["train_loss"][0]      # learning


@pytest.mark.slow
def test_dryrun_multichip_32():
    out = dryrun.dryrun_multichip(32, device="cpu")
    assert [r["mesh"] for r in out["runs"]] == [
        {"clients": 32}, {"clients": 8, "seq": 2, "model": 2}]
