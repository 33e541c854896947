"""DP, adaptive clipping, the accountant in the round and secure
aggregation of the port against the JAX package.

Every test feeds both sides the same inputs (numpy seeds) and the same
draws: ``JaxPrivacyDraws`` replays the JAX round's own DP noise, pair
masks, ring order and clip-bit noise through the port's ``plan``.  JAX
splits one key per leaf in ``jax.tree.flatten`` order, the flax order, and
its leaves are flax-shaped, so the replay draws the whole tree in the flax
layout and maps it onto the port's names and layout through ``convert``.

Tolerances: module-level parity in f32 to rtol 1e-4 / atol 2e-5; where
std-1 masks enter a sum, atol 1e-5 (the port sums the cohort in order,
JAX with one ``jnp.sum``, so their f32 cancellation residuals differ);
the clip bit's masks have std 1e3, whose f32 resolution at the masked
values (≈ 1e3 · √partners) is ≈ 1e-4, so a masked bit is held to 1e-3.
Two-round trajectories (5 clients, cohort 3 or 5, 3 local steps) hold the
port to the bounds of ``tests/test_torch_port_round.py``: a 2-layer BERT
of width 64 (losses, weights, clip and ε to 1e-4; params to rtol 1e-4 /
atol 1e-5 for 99.9 % of every tensor), the CNN by its drift rule.  Every
invalid combination raises the JAX engine's ``ValueError``, word for word.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.fed import FederatedLearner as JaxLearner
from colearn_federated_learning_tpu.privacy import dp as jax_dp
from colearn_federated_learning_tpu.privacy import secure_agg as jax_sa
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu.utils import prng as jax_prng
from colearn_federated_learning_tpu_torch import convert
from colearn_federated_learning_tpu_torch.fed import FederatedLearner
from colearn_federated_learning_tpu_torch.privacy import dp, secure_agg
from colearn_federated_learning_tpu_torch.utils import config
from test_torch_port_round import JaxDraws, _assert_params_close

RTOL, ATOL, MASK_ATOL, BIT_ATOL = 1e-4, 2e-5, 1e-5, 1e-3
SCALAR_STREAM_TAG = 0x7B17          # privacy/secure_agg.py's bit stream


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side of these tests runs tensors of a few thousand
    entries, which gain nothing from intra-op threads (the file takes the
    same time at 1 as at 8); one thread keeps it from crowding the test
    processes that run beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _normal_tree(key, template):
    """JAX's per-leaf draws: one split key per leaf in flatten order."""
    leaves, treedef = jax.tree.flatten(template)
    keys = jax.random.split(key, len(leaves))
    return jax.tree.unflatten(treedef, [
        jax.random.normal(k, jnp.shape(l), jnp.float32)
        for k, l in zip(keys, leaves)])


class JaxPrivacyDraws(JaxDraws):
    """The JAX round's draws, privacy ones included.  ``bind(flax_params,
    to_port)`` gives it the flax tree and the map of a flax-layout tree to
    the port's list of tensors."""

    def bind(self, flax_params, to_port):
        self.template, self.to_port = flax_params, to_port
        return self

    def _stream(self, key, shapes):
        out = self.to_port(_normal_tree(key, self.template))
        assert [tuple(t.shape) for t in out] == [tuple(s) for s in shapes]
        return iter(out)

    def dp_noise(self, round_idx, client_id, shapes, device):
        return self._stream(jax_prng.dp_key(self.key, client_id, round_idx),
                            shapes)

    def pair_mask(self, round_idx, a, b, shapes, device, stream=0):
        if stream == 0:
            return self._stream(
                jax_prng.pair_mask_key(self.key, a, b, round_idx), shapes)
        tagged = jax.random.fold_in(self.key, SCALAR_STREAM_TAG)
        k = jax.random.split(jax_prng.pair_mask_key(tagged, a, b,
                                                    round_idx), 1)[0]
        return iter([torch.from_numpy(np.array(
            jax.random.normal(k, (), jnp.float32)))])

    def ring_order(self, round_idx, cohort_ids):
        rkey = jax_prng.sampling_key(jax_prng.mask_ring_key(self.key),
                                     round_idx)
        ids = jnp.asarray(cohort_ids)
        scores = jax.vmap(lambda i: jax.random.uniform(
            jax.random.fold_in(rkey, i)))(ids)
        return np.asarray(ids[jnp.argsort(scores)])

    def clip_bit_noise(self, round_idx, device):
        return torch.from_numpy(np.array(jax.random.normal(
            jax_prng.clip_bit_key(self.key, jnp.int32(round_idx)), ())))


# ------------------------------------------------------------ modules
def _tree(rng, scale=1.0):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32) * scale,
            "b": {"c": rng.standard_normal((5,)).astype(np.float32) * scale}}


def _flat(tree) -> list:
    return [torch.from_numpy(np.array(x)) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("scale", [0.05, 3.0])       # under and over clip
@pytest.mark.parametrize("adaptive", [False, True])
def test_clip_and_noise_matches_jax(adaptive, scale):
    rng = np.random.default_rng(5)
    delta = _tree(rng, scale)
    key = jax.random.PRNGKey(9)
    noise = iter(_flat(_normal_tree(key, delta)))
    if adaptive:
        clip = np.float32(0.8)
        want, wbit = jax_dp.clip_and_noise_with_bit(
            jax.tree.map(jnp.asarray, delta), jnp.float32(clip), 0.7, 4, key)
        got, bit = dp.clip_and_noise_with_bit(
            _flat(delta), torch.tensor(clip), 0.7, 4, noise)
        assert float(bit) == float(wbit) == float(scale < 0.1)
    else:
        want = jax_dp.clip_and_noise(jax.tree.map(jnp.asarray, delta), 0.8,
                                     0.7, 4, key)
        got = dp.clip_and_noise(_flat(delta), 0.8, 0.7, 4, noise)
    for g, w in zip(got, jax.tree.leaves(want)):
        _close(g, w)


def test_clip_without_noise_bounds_the_norm():
    rng = np.random.default_rng(6)
    delta = _flat(_tree(rng, 5.0))
    before = float(dp.global_norm(delta))
    got = dp.clip_and_noise(delta, 1.5, 0.0, 4, None)
    assert before > 1.5
    assert float(dp.global_norm(got)) == pytest.approx(1.5, rel=1e-6)


@pytest.mark.parametrize("z,bit_noise", [(1.0, 1.0), (0.5, 2.0), (0.0, 1.0)])
def test_adaptive_noise_multiplier_matches_jax(z, bit_noise):
    assert dp.adaptive_noise_multiplier(z, bit_noise) == \
        jax_dp.adaptive_noise_multiplier(z, bit_noise)
    with pytest.raises(ValueError) as theirs:
        jax_dp.adaptive_noise_multiplier(1.0, 0.5)
    with pytest.raises(ValueError) as ours:
        dp.adaptive_noise_multiplier(1.0, 0.5)
    assert str(ours.value) == str(theirs.value)


def test_adaptive_clip_update_matches_jax():
    clip, frac = np.float32(0.9), np.float32(0.3)
    want = jax_dp.adaptive_clip_update(jnp.float32(clip), jnp.float32(frac),
                                       0.5, 0.2)
    got = dp.adaptive_clip_update(torch.tensor(clip), torch.tensor(frac),
                                  0.5, 0.2)
    _close(got, want, 1e-6, 0.0)


@pytest.mark.parametrize("neighbors,cohort", [(2, 7), (4, 9), (4, 5),
                                              (6, 6)])
def test_ring_partner_table_matches_jax(neighbors, cohort):
    key = jax.random.PRNGKey(3)
    draws = JaxPrivacyDraws(3)
    ids = np.asarray([2, 5, 9, 11, 13, 17, 19, 23, 29][:cohort])
    want = jax_sa.partner_table(key, jnp.asarray(ids), jnp.asarray(ids),
                                jnp.int32(1), neighbors=neighbors)
    got = secure_agg.partner_table(ids, ids, neighbors,
                                   draws.ring_order(1, ids))
    np.testing.assert_array_equal(got, np.asarray(want))
    if neighbors // 2 <= (cohort - 1) // 2:
        assert got.shape == (cohort, neighbors)
        assert all(i not in row for i, row in zip(ids, got))


def test_odd_ring_degree_raises_like_jax():
    ids = np.arange(8)
    with pytest.raises(ValueError) as theirs:
        jax_sa.ring_partner_table(jax.random.PRNGKey(0), jnp.asarray(ids),
                                  jnp.asarray(ids), 0, 3)
    with pytest.raises(ValueError) as ours:
        secure_agg.ring_partner_table(ids, ids, 3)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("neighbors", [0, 2])
def test_masks_match_jax_and_cancel(neighbors):
    rng = np.random.default_rng(8)
    ids = np.asarray([3, 7, 11, 20, 24])
    updates = [_tree(rng, 0.01) for _ in ids]
    bits = rng.integers(0, 2, len(ids)).astype(np.float32)
    key = jax.random.PRNGKey(21)
    draws = JaxPrivacyDraws(0)
    draws.key = key
    draws.bind(updates[0], _flat)
    rnd = 4
    table = secure_agg.partner_table(
        ids, ids, neighbors,
        draws.ring_order(rnd, ids) if neighbors else None)
    jtable = np.asarray(jax_sa.partner_table(
        key, jnp.asarray(ids), jnp.asarray(ids), jnp.int32(rnd), neighbors))
    np.testing.assert_array_equal(table, jtable)
    shapes = [t.shape for t in _flat(updates[0])]
    got_sum = [torch.zeros(s) for s in shapes]
    want_sum = jax.tree.map(jnp.zeros_like, updates[0])
    bit_sum = jbit_sum = 0.0
    for i, u, b, row in zip(ids, updates, bits, table):
        want = jax_sa.mask_update(jax.tree.map(jnp.asarray, u), key,
                                  jnp.int32(i), jnp.asarray(row),
                                  jnp.int32(rnd))
        got = secure_agg.mask_update(
            _flat(u), int(i), row,
            lambda a, c: draws.pair_mask(rnd, a, c, shapes, None))
        for g, w in zip(got, jax.tree.leaves(want)):
            _close(g, w, 0.0, MASK_ATOL)
        got_sum = [s + g for s, g in zip(got_sum, got)]
        want_sum = jax.tree.map(jnp.add, want_sum, want)
        jbit = jax_sa.mask_scalar(jnp.float32(b), key, jnp.int32(i),
                                  jnp.asarray(row), jnp.int32(rnd), std=1e3)
        pbit = secure_agg.mask_scalar(
            torch.tensor(b), int(i), row,
            lambda a, c: draws.pair_mask(rnd, a, c, [()], None, stream=1),
            std=1e3)
        _close(pbit, jbit, 0.0, BIT_ATOL)
        bit_sum, jbit_sum = bit_sum + float(pbit), jbit_sum + float(jbit)
    plain = [sum(np.asarray(x) for x in leaves) for leaves in
             zip(*[jax.tree.leaves(u) for u in updates])]
    for g, w, p in zip(got_sum, jax.tree.leaves(want_sum), plain):
        _close(g, p, 0.0, MASK_ATOL)               # the masks cancel
        _close(w, p, 0.0, MASK_ATOL)
    assert abs(bit_sum - bits.sum()) <= BIT_ATOL * len(ids)
    assert abs(jbit_sum - bits.sum()) <= BIT_ATOL * len(ids)


# -------------------------------------------------------- trajectories
MODELS = {
    "cnn": (dict(dataset="cifar10_tiny", partition="dirichlet"),
            dict(name="cnn", num_classes=10, width=8)),
    "bert": (dict(dataset="agnews_tiny", partition="iid"),
             dict(name="bert", num_classes=4, width=64, depth=2, num_heads=4,
                  seq_len=64, vocab_size=2000)),
    "mlp": (dict(dataset="mnist_tiny", partition="iid"),
            dict(name="mlp", num_classes=10, hidden_dim=32, depth=2)),
}


def _configs(model, num_clients=5, **fed):
    data, mdl = MODELS[model]
    fed = dict(dict(rounds=2, cohort_size=3, local_steps=3, batch_size=8,
                    lr=0.05, momentum=0.0, local_optimizer="sgd"), **fed)
    return [mod.ExperimentConfig(
        data=mod.DataConfig(**data, num_clients=num_clients),
        model=mod.ModelConfig(**mdl), fed=mod.FedConfig(**fed),
        run=mod.RunConfig(seed=3)) for mod in (jax_config, config)]


def _trajectory(model, num_clients=5, **fed):
    jcfg, tcfg = _configs(model, num_clients, **fed)
    jl = JaxLearner(jcfg)
    draws = JaxPrivacyDraws(jcfg.run.seed)
    tl = FederatedLearner(tcfg, device="cpu", plan=draws)
    tl.load_flax_params(jax.device_get(jl.params))
    names = list(tl.params)
    draws.bind(jax.device_get(jl.params), lambda tree: [
        convert.flax_to_state_dict(jax.tree.map(np.asarray, tree))[n]
        for n in names])
    conv = model == "cnn"
    start = {k: v.clone() for k, v in tl.params.items()} if conv else None
    tol = 1e-4
    records, step_bound = [], 0.0
    for _ in range(2):
        step_bound += 3 * tcfg.fed.lr * tcfg.fed.local_steps
        jr, tr = jl.run_round(), tl.run_round()
        assert tr["completed"] == jr["completed"]
        assert set(tr) == set(jr)     # the JAX record's keys, timings too
        for key in ("train_loss", "total_weight", "dp_clip", "dp_bit_frac",
                    "dp_epsilon", "dp_delta"):
            if key in jr:
                _close(tr[key], jr[key], tol, tol, key)
        _assert_params_close(jax.device_get(jl.server_state.params),
                             tl.params, step_bound, start)
        records.append(tr)
    return records


def test_fixed_dp_trajectory_matches_jax():
    recs = _trajectory("bert", dp_clip=0.5, dp_noise_multiplier=0.8)
    assert recs[-1]["dp_epsilon"] > recs[0]["dp_epsilon"] > 0


def test_adaptive_dp_trajectory_matches_jax():
    recs = _trajectory("bert", dp_clip=0.05, dp_noise_multiplier=1.0,
                       dp_adaptive_clip=True, dp_clip_lr=0.5)
    assert recs[0]["dp_clip"] != 0.05


def test_secure_agg_with_adaptive_bit_trajectory_matches_jax():
    recs = _trajectory("bert", secure_agg=True, dp_clip=0.05,
                       dp_noise_multiplier=1.0, dp_adaptive_clip=True)
    assert recs[0]["dp_bit_frac"] < 1.0 or recs[1]["dp_bit_frac"] < 1.0


def test_secure_agg_ring_trajectory_matches_jax():
    _trajectory("cnn", num_clients=6, cohort_size=5, lr=2e-3,
                secure_agg=True, secure_agg_neighbors=2)


@pytest.mark.parametrize("fed_kw", [
    dict(dp_clip=1.0, dp_noise_multiplier=0.5), dict(secure_agg=True)])
def test_update_norms_are_withheld_under_dp_and_secure_agg(fed_kw):
    """Exact update norms are an unaccounted release under DP and what the
    masks hide under secure aggregation: neither side reports them."""
    jcfg, tcfg = _configs("mlp", rounds=1, **fed_kw)
    rec = FederatedLearner(tcfg, device="cpu").run_round()
    jrec = JaxLearner(jcfg).run_round()
    for r in (rec, jrec):
        assert not [k for k in r if k.startswith("delta_norm")]
    plain = FederatedLearner(_configs("mlp", rounds=1)[1],
                             device="cpu").run_round()
    assert "delta_norm_mean" in plain and "delta_norm_max" in plain


REFUSALS = {
    "scaffold_dp": dict(strategy="scaffold", momentum=0.0, dp_clip=1.0),
    "scaffold_secure_agg": dict(strategy="scaffold", momentum=0.0,
                                secure_agg=True),
    "robust_secure_agg": dict(aggregator="median", secure_agg=True),
    "robust_noise": dict(aggregator="median", dp_clip=1.0,
                         dp_noise_multiplier=0.5),
    "robust_scaffold": dict(aggregator="krum", strategy="scaffold",
                            momentum=0.0),
    "trim_range": dict(aggregator="trimmed_mean", trim_fraction=0.5),
    "unknown_aggregator": dict(aggregator="mode"),
    "odd_ring": dict(secure_agg=True, secure_agg_neighbors=3),
    "threshold": dict(secure_agg=True, secure_agg_threshold=0.0),
    "trim_at_cohort": dict(aggregator="trimmed_mean", trim_fraction=0.1),
    "krum_small_cohort": dict(aggregator="krum", trim_fraction=0.1,
                              cohort_size=2),
    "adaptive_without_clip": dict(dp_adaptive_clip=True),
    "scaffold_momentum": dict(strategy="scaffold", momentum=0.9),
    "scaffold_adam": dict(strategy="scaffold", local_optimizer="adam"),
    "fednova_adam": dict(strategy="fednova", local_optimizer="adam"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_invalid_combinations_raise_like_jax(case):
    jcfg, tcfg = _configs("mlp", rounds=1, **REFUSALS[case])
    with pytest.raises(ValueError) as theirs:
        JaxLearner(jcfg)
    with pytest.raises(ValueError) as ours:
        FederatedLearner(tcfg, device="cpu")
    assert str(ours.value) == str(theirs.value)
