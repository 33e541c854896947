"""The port's client-mesh round on spawned gloo ranks against the JAX
package's ``_build_mesh_round`` on ``cpu_devices[:4]``.

Both sides run the same config on a 4-way ``clients`` mesh: 6 real
clients ghost-padded to 8 and interleaved (2 per device), MLP on
mnist_tiny, SGD, 2 local steps of batch 8, 2 rounds, from the JAX
learner's initial params.  The port's ranks replay the JAX round's own
draws, recorded here as numpy arrays (``tests/torch_port_ranks.py``):
each device's cohort (``fold_in(sampling_key, dev)``), every client's
batch indices and straggler budget, DP noise, pair masks, the ring order
and the clip bit's noise.  One spawn of 4 ranks runs every scenario:

- full participation (ghosts in the cohort), momentum 0.9, then the
  per-client evaluation and the update similarity on the mesh;
- a per-device-stratified partial cohort (1 per device) with stragglers
  and FedProx;
- adaptive DP; secure aggregation (complete graph) with adaptive DP and
  its masked clip bit; secure aggregation on a degree-2 ring;
- Krum and the median (the stacked deltas all-gathered);
- SCAFFOLD (host-sampled per-device cohort) and FedNova with stragglers.

Each round must also make exactly the collectives its path implies.

Tolerance: f32 on both sides; records and params to rtol 1e-4 / atol
2e-5 (summation order differs: the port sums each device's cohort in
order and all-reduces one flat bucket, XLA psums per leaf).  The one
exception is ``dp_bit_frac`` under secure aggregation, held to 1e-3 as
in ``tests/test_torch_port_privacy.py``: the clip bit's masks have std
1e3, whose f32 resolution at the masked sums is about 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from colearn_federated_learning_tpu.fed import FederatedLearner as JaxLearner
from colearn_federated_learning_tpu.fed.programs import rank_cohort
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu.utils import prng as jax_prng
from colearn_federated_learning_tpu_torch import convert
from colearn_federated_learning_tpu_torch.fed import programs
from colearn_federated_learning_tpu_torch.models import registry
from colearn_federated_learning_tpu_torch.utils import config
from test_torch_port_privacy import SCALAR_STREAM_TAG, JaxPrivacyDraws
from torch_port_ranks import spawn

RTOL, ATOL, BIT_ATOL = 1e-4, 2e-5, 1e-3
WORLD, ROUNDS, NUM_CLIENTS = 4, 2, 6
BASE = dict(rounds=ROUNDS, local_steps=2, batch_size=8, lr=0.05,
            momentum=0.0, local_optimizer="sgd")
SCENARIOS = {
    "full": dict(momentum=0.9),
    "partial": dict(cohort_size=4, straggler_prob=0.5,
                    straggler_min_fraction=0.5, strategy="fedprox",
                    prox_mu=0.1),
    "dp": dict(cohort_size=4, dp_clip=0.5, dp_noise_multiplier=0.7,
               dp_adaptive_clip=True),
    "secure_agg": dict(secure_agg=True, dp_clip=1.0, dp_noise_multiplier=0.5,
                       dp_adaptive_clip=True),
    "secure_agg_ring": dict(secure_agg=True, secure_agg_neighbors=2),
    "krum": dict(aggregator="krum", trim_fraction=0.2),
    "median": dict(cohort_size=4, aggregator="median"),
    "scaffold": dict(cohort_size=4, strategy="scaffold"),
    "fednova": dict(strategy="fednova", momentum=0.9, straggler_prob=0.5,
                    straggler_min_fraction=0.5),
}
# The collectives one round of each path makes on the clients group.
NORMS = {"all_reduce": 3}                  # delta sum, scalars, norm MAX
COUNTS = {"full": NORMS, "partial": NORMS, "dp": {"all_reduce": 2},
          "secure_agg": {"all_gather": 1, "all_reduce": 2},
          "secure_agg_ring": {"all_gather": 1, "all_reduce": 2},
          "krum": {"all_gather": 2, "all_reduce": 2},
          "median": {"all_gather": 2, "all_reduce": 2},
          "scaffold": NORMS, "fednova": NORMS}


def _configs(fed_kw):
    kw = dict(data=dict(dataset="mnist_tiny", partition="iid",
                        num_clients=NUM_CLIENTS),
              model=dict(name="mlp", num_classes=10, hidden_dim=32, depth=2),
              fed=dict(BASE, **fed_kw), run=dict(seed=3))
    return [mod.ExperimentConfig(
        data=mod.DataConfig(**kw["data"]), model=mod.ModelConfig(**kw["model"]),
        fed=mod.FedConfig(**kw["fed"]), run=mod.RunConfig(**kw["run"]))
        for mod in (jax_config, config)]


def record_draws(jl, tcfg, rounds, similarity=False) -> dict:
    """Every draw the port's mesh round can ask for, from JAX."""
    c = jl.config.fed
    key = jax_prng.experiment_key(jl.config.run.seed)
    D, N = jl.clients_size, jl.num_clients
    L, cpd = N // D, jl.cohort_per_device
    counts = np.asarray(jl.shards.counts)
    count_of = dict(zip(np.asarray(jl.client_ids).tolist(), counts.tolist()))
    model = registry.build_model(tcfg.model, "cpu",
                                 input_shape=jl.shards.x.shape[2:])
    names = [n for n, _ in model.named_parameters()]
    shapes = [p.shape for p in model.parameters()]
    jd = JaxPrivacyDraws(jl.config.run.seed).bind(
        jax.device_get(jl.params), lambda tree: [
            convert.flax_to_state_dict(jax.tree.map(np.asarray, tree))[n]
            for n in names])
    rec = {k: {} for k in ("cohort", "batch", "budget", "dp", "mask",
                           "ring", "clip_bit")}
    round_ids = list(range(rounds)) + ([programs.SIMILARITY_ROUND]
                                       if similarity else [])
    for r in round_ids:
        for i in range(N):
            rec["batch"][(r, i)] = jd.batch_indices(r, i, count_of[i],
                                                    jl.num_steps, c.batch_size)
    for r in range(rounds):
        skey = jax_prng.sampling_key(key, jnp.int32(r))
        for d in range(D):
            blk = jnp.asarray(counts[d * L:(d + 1) * L])
            rec["cohort"][(r, d)] = (
                np.asarray(rank_cohort(jax.random.fold_in(skey, d), blk, cpd))
                if cpd < L else np.arange(L))
        for i in range(N):
            if c.straggler_prob > 0:
                rec["budget"][(r, i)] = int(jd.step_budgets(
                    r, [i], jl.num_steps, c.straggler_prob)[0])
            if c.dp_clip > 0:
                rec["dp"][(r, i)] = [t.numpy() for t in
                                     jd.dp_noise(r, i, shapes, "cpu")]
        if c.secure_agg:
            for a in range(N):
                for b in range(a + 1, N):
                    rec["mask"][(r, a, b, 0)] = [
                        t.numpy() for t in jd.pair_mask(r, a, b, shapes,
                                                        "cpu")]
                    if c.dp_adaptive_clip:
                        rec["mask"][(r, a, b, 1)] = [t.numpy() for t in
                                                     jd.pair_mask(r, a, b, [()],
                                                                  "cpu", 1)]
            rkey = jax_prng.sampling_key(jax_prng.mask_ring_key(key), r)
            rec["ring"][r] = np.asarray(jax.vmap(lambda i: jax.random.uniform(
                jax.random.fold_in(rkey, i)))(jnp.arange(N)))
        if c.dp_adaptive_clip:
            rec["clip_bit"][r] = float(jd.clip_bit_noise(r, "cpu"))
    return rec


@pytest.fixture(scope="module")
def runs(cpu_devices, tmp_path_factory):
    """Record the draws, start the port's ranks, run JAX meanwhile."""
    assert SCALAR_STREAM_TAG                 # the bit streams are JAX's
    mesh = Mesh(np.array(cpu_devices[:WORLD]), ("clients",))
    learners, jobs = {}, []
    for name, fed_kw in SCENARIOS.items():
        jcfg, tcfg = _configs(fed_kw)
        jl = JaxLearner(jcfg, mesh=mesh)
        learners[name] = jl
        jobs.append(("learner_rounds", dict(
            config=tcfg, mesh=(("clients",), (WORLD,)), rounds=ROUNDS,
            params=jax.device_get(jl.params),
            draws=record_draws(jl, tcfg, ROUNDS, similarity=name == "full"),
            per_client=name == "full")))
    import threading

    box = {}
    th = threading.Thread(target=lambda: box.setdefault(
        "ranks", _spawn_safe(jobs, tmp_path_factory.mktemp("mesh"))))
    th.start()
    jax_out = {}
    for name, jl in learners.items():
        recs = [jl.run_round() for _ in range(ROUNDS)]
        out = dict(records=recs, params=jax.device_get(jl.server_state.params),
                   eval=jl.evaluate())
        if name == "full":
            out["per_client"] = jl.evaluate_per_client()
            out["similarity"] = jl.client_update_similarity(steps=2)
        jax_out[name] = out
    th.join()
    ranks = box["ranks"]
    if isinstance(ranks, Exception):
        raise ranks
    return {name: (jax_out[name], [r[i] for r in ranks])
            for i, name in enumerate(SCENARIOS)}


def _spawn_safe(jobs, tmp):
    try:
        return spawn(WORLD, tmp, jobs, timeout=300.0)
    except Exception as e:           # re-raised in the fixture
        return e


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_mesh_round_matches_jax_mesh(runs, name):
    jax_out, ranks = runs[name]
    want_params = convert.flax_to_state_dict(
        jax.tree.map(np.asarray, jax_out["params"]))
    for rank, out in enumerate(ranks):
        for r, (tr, jr) in enumerate(zip(out["records"], jax_out["records"])):
            assert tr["completed"] == jr["completed"], (rank, r)
            assert set(tr) == set(jr), set(tr) ^ set(jr)
            for k in ("train_loss", "total_weight", "delta_norm_mean",
                      "delta_norm_max", "dp_clip", "dp_bit_frac",
                      "dp_epsilon"):
                assert (k in tr) == (k in jr), k
                if k in jr:
                    masked = k == "dp_bit_frac" and name == "secure_agg"
                    _close(tr[k], jr[k], f"{name} rank {rank} round {r} {k}",
                           atol=BIT_ATOL if masked else ATOL)
        for n, t in out["params"].items():
            _close(t, want_params[n].numpy(), f"{name} rank {rank} {n}")
        _close(out["eval"], jax_out["eval"], f"{name} eval")
        assert out["counts"] == [COUNTS[name]] * ROUNDS, out["counts"]


def test_mesh_cohorts_are_device_stratified_and_keyed_on_ids(runs):
    _, ranks = runs["partial"]
    ids = set()
    for rank, out in enumerate(ranks):
        for cohort in out["cohorts"][-1:]:
            assert len(cohort["clients"]) == 1
            # Interleaved placement: device d holds ids d, d + 4.
            assert cohort["clients"][0] % WORLD == rank
            ids.update(cohort["clients"].tolist())
    assert len(ids) == WORLD


def test_mesh_krum_selects_over_the_whole_mesh(runs):
    _, ranks = runs["krum"]
    sel = [sorted(out["cohorts"][-1]["selected"].tolist()) for out in ranks]
    assert all(s == sel[0] for s in sel)
    # 6 real contributors of 8 slots, f = floor(0.2 * 8) = 1: keep 5.
    assert len(sel[0]) == 5 and max(sel[0]) < NUM_CLIENTS


def test_mesh_secure_agg_pairs_against_the_whole_cohort(runs):
    _, ranks = runs["secure_agg"]
    for out in ranks:
        partners = out["cohorts"][-1]["partners"]
        assert partners.shape == (2, 8)
    _, ranks = runs["secure_agg_ring"]
    for rank, out in enumerate(ranks):
        cohort = out["cohorts"][-1]
        assert cohort["partners"].shape == (2, 2)
        assert not np.isin(cohort["clients"], cohort["partners"]).any()


def test_mesh_per_client_eval_and_similarity_match_jax(runs):
    jax_out, ranks = runs["full"]
    for out in ranks:
        got, want = out["per_client"], jax_out["per_client"]
        assert len(got["per_client_acc"]) == NUM_CLIENTS
        for k in ("per_client_loss", "per_client_acc", "num_examples",
                  "weighted_loss", "weighted_acc"):
            _close(got[k], want[k], k)
        assert out["similarity"].shape == (NUM_CLIENTS, NUM_CLIENTS)
        _close(out["similarity"], jax_out["similarity"], "similarity",
               atol=1e-5)
