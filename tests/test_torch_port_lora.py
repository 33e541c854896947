"""The port's LoRA adapter federation (``fed/lora.py``, the factor-only
trainer, the composite broadcast, the factor folds and the server merge)
against the JAX package's, on the CPU at small sizes.

- Targeting, the factorization and the factor template (shapes, dtypes)
  equal JAX's for every family: MLP, CNN, ResNet-18, TCN, BERT, ViT and
  MoE-BERT, the port's flax-layout params and JAX's giving the same
  targets.
- On JAX's factors (A from JAX's init, B drawn from a seed), the merge
  equals JAX's eager ``merge_adapters`` at f32 rtol 1e-4 / atol 2e-5
  (not the tp=2 jitted merge: ``tests/test_lora.py``'s tp2 case is red on
  the reference side at its 1e-6 bound), ``reset_factors`` is JAX's, and
  the adapted weights the trainer builds in the port's layout
  (``convert.leaf_to_torch``) equal ``convert.flax_to_state_dict`` of
  JAX's ``apply_adapters`` for every layout kind (Dense, Conv HWIO, 1-D
  WIO, query/key/value, out, the embedding, the MoE banks).
- ``make_lora_local_update`` against JAX's on JAX's batch draws: SGD with
  momentum, FedProx and a ``step_budget`` cut on the MLP and SGD on the
  small CNN (its Conv kernels adapted in HWIO) at rtol 1e-4 / atol 2e-5,
  and Adam on the small BERT (flash attention; JAX's kernel in
  interpret mode) at the round test's Adam rule (99.9 % of each factor's
  entries at rtol 1e-4 / atol 1e-5, every entry within the step bound):
  Adam's early steps are ±lr whatever the gradient's size, so an entry
  whose gradient sits at eps moves by a roundoff-driven step.
- ``validate_robustness`` raises JAX's errors on the cases of
  ``tests/test_lora.py``.
- Socket federations: a port federation with JAX's draws, params and
  factors matches JAX's over 2 rounds with a merge; its no-merge twin
  gives the oracle (the merged base is ``merge_adapters`` of the held
  base and factors, B zero, A kept); secure aggregation over the factors
  lands on the plain run; LoRA off keeps the record keys; the composite
  frame is byte-equal to JAX's and mixed federations fold as the
  one-package ones.
- The tree: factor partials combine bitwise as the slice-blocked flat
  fold (host and the fold kernel's plain version, against JAX's folder),
  and an aggregator's buffered ops answer a LoRA ``aprep`` as JAX's.
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.comm import aggregation as jax_aggregation
from colearn_federated_learning_tpu.comm import aggregator as jax_agg
from colearn_federated_learning_tpu.comm import coordinator as jax_coord
from colearn_federated_learning_tpu.data import registry as jax_data
from colearn_federated_learning_tpu.fed import lora as jax_lora
from colearn_federated_learning_tpu.fed import setup as jax_setup
from colearn_federated_learning_tpu.models import registry as jax_models
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu.utils import prng as jax_prng
from colearn_federated_learning_tpu_torch import convert
from colearn_federated_learning_tpu_torch.comm import aggregator
from colearn_federated_learning_tpu_torch.comm.aggregation import (
    StreamingFolder)
from colearn_federated_learning_tpu_torch.comm.transport import TensorClient
from colearn_federated_learning_tpu_torch.fed import compression, lora
from colearn_federated_learning_tpu_torch.fed import setup
from colearn_federated_learning_tpu_torch.models import registry as models
from colearn_federated_learning_tpu_torch.utils import config, trees
from test_torch_port_round import AGREE_FRACTION, JaxDraws
from test_torch_port_socket import (
    ATOL, RTOL, WAIT, Federation, assert_records_match, configs, jax_init,
    leaves, params_of)

RANK, ALPHA = 4, 16.0
FAMILY_NAMES = ("mlp", "cnn", "resnet18", "tcn", "bert", "vit", "moe_bert")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def lora_configs(family="mlp", num_clients=2, **fed):
    kw = dict(lora_rank=RANK, lora_alpha=ALPHA, lora_merge_every=2)
    kw.update(fed)
    return configs(num_clients=num_clients, family=family, **kw)


_PARAMS: dict = {}


def family_params(family):
    """(JAX config, port config, params of JAX's init shapes as numpy, the
    port's own init params in the flax layout), once per family.  The
    values are drawn from a seed: targeting reads shapes, and the merge
    and the adapted weights hold for any base."""
    if family not in _PARAMS:
        jcfg, tcfg = lora_configs(family)
        shapes = jax.eval_shape(lambda: jax_setup.init_global_params(jcfg))
        rng = np.random.default_rng(11)
        jparams = jax.tree.map(
            lambda s: (0.05 * rng.standard_normal(s.shape)).astype(s.dtype),
            shapes)
        _PARAMS[family] = (jcfg, tcfg, jparams,
                           setup.init_global_params(tcfg, "cpu"))
    return _PARAMS[family]


def jax_factors(jcfg, jparams, seed=5, scale=0.05):
    """JAX's factors for ``jparams``: A from JAX's init, B from a seed (so
    merges and the A gradient are not zero)."""
    f = jax.tree.map(np.array, jax_setup.init_lora_factors(jcfg, jparams))
    rng = np.random.default_rng(seed)
    for a, b in jax_lora.factor_index(f).values():
        b[...] = (scale * rng.standard_normal(b.shape)).astype(np.float32)
    return f


def to_torch(tree):
    return trees.map_leaves(
        lambda l: torch.from_numpy(np.array(l, np.float32)), tree)


def host(tree):
    """A host copy (the coordinator steps its factors in place)."""
    return trees.map_leaves(
        lambda l: np.array(l.detach().cpu().numpy() if isinstance(
            l, torch.Tensor) else l), tree)


def _bytes(tree):
    return [np.asarray(leaf).tobytes() for leaf in trees.leaves(tree)]


# ------------------------------------------------------------ targeting --
@pytest.mark.parametrize("family", FAMILY_NAMES)
def test_targets_factorization_and_template_equal_jax(family):
    jcfg, _, jparams, tparams = family_params(family)
    name = jcfg.model.name
    want = jax_lora.target_paths(jparams, model_name=name)
    assert want, "the rules target no leaf"
    assert lora.target_paths(tparams, model_name=name) == want
    assert lora.target_paths(jparams, model_name=name) == want
    for shape in want.values():
        assert lora.split_point(shape) == jax_lora.split_point(shape)
        assert lora.factor_dims(shape) == jax_lora.factor_dims(shape)
    jt = jax_lora.init_factors(jparams, RANK, model_name=name)
    tt = lora.init_factors(tparams, RANK, model_name=name)
    got = {p: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for p, v in leaves(host(tt)).items()}
    assert got == {p: (v.shape, str(v.dtype))
                   for p, v in leaves(jax.tree.map(np.asarray, jt)).items()}
    assert all(np.all(v == 0) for v in leaves(host(tt)).values())
    assert lora.count_factor_params(tt) == jax_lora.count_factor_params(jt)


def test_init_factors_draw_a_and_zero_b():
    jcfg, tcfg, _, tparams = family_params("bert")
    f = setup.init_lora_factors(tcfg, tparams, "cpu")
    again = setup.init_lora_factors(tcfg, tparams, "cpu")
    assert _bytes(host(f)) == _bytes(host(again))      # seed-deterministic
    for a, b in lora.factor_index(f).values():
        assert a.dtype == b.dtype == torch.float32
        assert torch.all(b == 0) and a.std() > 0.01
        assert abs(float(a.std()) - lora.DEFAULT_SIGMA) < 0.01


# ---------------------------------------------------------------- merge --
@pytest.mark.parametrize("family", FAMILY_NAMES)
def test_merge_reset_and_adapted_weights_equal_jax(family):
    jcfg, tcfg, jparams, _ = family_params(family)
    jf = jax_factors(jcfg, jparams)
    tf = to_torch(jf)
    merged = lora.merge_adapters(to_torch(jparams), tf, ALPHA, RANK)
    oracle = jax.tree.map(np.asarray, jax_lora.merge_adapters(
        jparams, jf, ALPHA, RANK))
    got, want = leaves(host(merged)), leaves(oracle)
    assert got.keys() == want.keys()
    moved = 0
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=RTOL,
                                   atol=ATOL, err_msg=path)
        moved += int(not np.array_equal(want[path],
                                         leaves(jparams)[path]))
    assert moved == len(jax_lora.factor_index(jf))

    reset = host(lora.reset_factors(tf))
    assert _bytes(reset) == _bytes(jax.tree.map(
        np.asarray, jax_lora.reset_factors(jf)))

    # What the trainer builds: the adapted weight in the port's layout.
    applied = convert.flax_to_state_dict(jax.tree.map(
        np.asarray, jax_lora.apply_adapters(jparams, jf, ALPHA, RANK)))
    base = convert.flax_to_state_dict(jparams)
    shapes = lora.target_paths(jparams, model_name=jcfg.model.name)
    for path, (a, b) in lora.factor_index(tf).items():
        name, delta = convert.leaf_to_torch(
            tuple(path.split("/")),
            lora.adapter_delta(a, b, shapes[path], ALPHA, RANK))
        np.testing.assert_allclose(
            lora.adapt_leaf(base[name], delta).numpy(),
            applied[name].numpy(), rtol=RTOL, atol=ATOL, err_msg=name)


# -------------------------------------------------------------- trainer --
def _trainer_inputs(jcfg, capacity=24):
    ds = jax_data.get_dataset(jcfg.data.dataset, seed=jcfg.run.seed,
                              max_train=capacity, max_test=1)
    return (np.asarray(ds.x_train[:capacity]),
            np.asarray(ds.y_train[:capacity]).astype(np.int32))


@pytest.mark.parametrize("family,fed,budget,lr_scale", [
    pytest.param("mlp", dict(momentum=0.9), None, None, id="mlp-sgd"),
    pytest.param("mlp", dict(strategy="fedprox", prox_mu=0.5, momentum=0.0),
                 None, 0.5, id="mlp-fedprox"),
    pytest.param("mlp", dict(momentum=0.9), 2, None, id="mlp-budget"),
    pytest.param("cnn", dict(local_steps=2), None, None, id="cnn-sgd"),
    pytest.param("bert", dict(local_steps=3), None, 0.5, id="bert-adam")])
def test_lora_local_update_matches_jax(family, fed, budget, lr_scale):
    jcfg, tcfg = lora_configs(family, **fed)
    jparams = family_params(family)[2]
    jf = jax_factors(jcfg, jparams)
    x, y = _trainer_inputs(jcfg)
    count, client, rnd = x.shape[0] - 3, 1, 2
    jmodel = jax_models.build_model(jax_setup.local_model_config(jcfg.model))
    jupdate, steps = jax_setup.lora_trainer_for_config(jcfg, jmodel.apply,
                                                       x.shape[0])
    budget = steps if budget is None else budget
    key = jax_prng.client_round_key(jax_prng.experiment_key(jcfg.run.seed),
                                    jnp.int32(client), jnp.int32(rnd))
    want = jax.jit(jupdate)(
        jparams, jf, jnp.asarray(x), jnp.asarray(y), jnp.int32(count), key,
        jnp.int32(budget), None if lr_scale is None else jnp.float32(lr_scale))

    model = models.build_model(setup.local_model_config(tcfg.model), "cpu",
                               input_shape=x.shape[1:])
    update, tsteps = setup.lora_trainer_for_config(tcfg, model, x.shape[0])
    assert tsteps == steps
    idx = JaxDraws(tcfg.run.seed).batch_indices(rnd, client, count, steps,
                                                tcfg.fed.batch_size)
    got = update(setup.flax_to_params(model, jparams, "cpu"), to_torch(jf),
                 torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)),
                 count, torch.as_tensor(idx, dtype=torch.long), budget,
                 lr_scale)
    assert got.steps_run == float(want.steps_run) == min(budget, steps)
    assert got.completed == bool(want.completed)
    assert got.num_examples == int(want.num_examples)
    np.testing.assert_allclose(float(got.mean_loss), float(want.mean_loss),
                               rtol=1e-5, atol=1e-5)
    want_d = [np.asarray(l) for l in jax.tree.leaves(want.delta)]
    assert len(got.delta) == len(want_d)
    bound = 3 * tcfg.fed.lr * steps * (lr_scale or 1.0)
    for g, w in zip(got.delta, want_d):
        g = g.numpy()
        assert g.shape == w.shape and np.any(w != 0)
        if tcfg.fed.local_optimizer == "adam":
            assert np.max(np.abs(g - w)) <= bound
            close = np.isclose(g, w, rtol=1e-4, atol=1e-5)
            assert close.mean() >= AGREE_FRACTION
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    # The base got no gradient: the model still holds it.
    for p, w in zip(model.parameters(),
                    setup.flax_to_params(model, jparams, "cpu")):
        assert torch.equal(p, w) and not p.requires_grad


# ----------------------------------------------------------- validation --
def _refusal(fn):
    try:
        fn()
    except Exception as e:                       # noqa: BLE001 (compared)
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("kw", [
    dict(lora_rank=-1), dict(lora_alpha=0.0), dict(lora_alpha=-2.0),
    dict(lora_merge_every=0), dict(compress_down="int8"),
    dict(strategy="fedadam"), dict(strategy="fedyogi"),
    dict(), dict(strategy="fedprox", prox_mu=0.01), dict(compress="topk"),
    dict(compress="topk8", compress_feedback=True), dict(secure_agg=True)])
def test_validate_robustness_is_jax_validate_robustness(kw):
    jcfg, tcfg = lora_configs(**kw)
    theirs = _refusal(lambda: jax_config.validate_robustness(jcfg))
    ours = _refusal(lambda: config.validate_robustness(tcfg))
    assert ours == theirs
    bad = any(k in kw for k in ("lora_rank", "lora_alpha",
                                "lora_merge_every", "compress_down")) or \
        kw.get("strategy") in ("fedadam", "fedyogi")
    assert (theirs is not None) == bad


# ---------------------------------------------------- socket federations --
_RUNS: dict = {}


def lora_run(coord="port", workers="port", rounds=2, **fed):
    """A flat LoRA federation of 2 workers on the tiny MLP (SGD, lr 0.05),
    each side of either package, from JAX's params and factors: (records,
    params and factors after each round as host leaves), once per
    setup."""
    key = (coord, workers, rounds, tuple(sorted(fed.items())))
    if key in _RUNS:
        return _RUNS[key]
    cfgs = lora_configs(momentum=0.0, lr=0.05, **fed)
    jcfg = cfgs[0]
    init_f = jax.tree.map(np.asarray,
                          jax_setup.init_lora_factors(jcfg, jax_init(jcfg)))
    recs, params, factors = [], [], []
    with Federation(cfgs, 2, coord=coord, workers=workers,
                    want_evaluator=False) as f:
        c = f.coord
        c.trainers.sort(key=lambda d: int(d.device_id))
        if coord == "port":
            c._load_factors(init_f)
        for _ in range(rounds):
            recs.append(dict(c.run_round()))
            params.append(params_of(c))
            factors.append(leaves(host(c._factors)))
    _RUNS[key] = (recs, params, factors)
    return _RUNS[key]


def test_socket_federation_with_a_merge_matches_jax_and_its_oracle():
    recs, params, factors = lora_run(lora_merge_every=2)
    jrecs, jparams, jfactors = lora_run("jax", "jax", lora_merge_every=2)
    assert_records_match(recs, jrecs)
    assert [r["lora_merged"] for r in recs] == [False, True]
    assert all(r["completed"] == 2 and r["bytes_saved_uplink"] > 0
               for r in recs)
    assert [r["bytes_saved_uplink"] for r in recs] == [
        r["bytes_saved_uplink"] for r in jrecs]
    for ours, theirs in zip(params + factors, jparams + jfactors):
        assert ours.keys() == theirs.keys()
        for k in theirs:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    # The twin that holds: the base never moves, the factors do, and the
    # merge twin's base is the merge of the held base and factors.
    hrecs, hparams, hfactors = lora_run(lora_merge_every=100)
    assert not any(r["lora_merged"] for r in hrecs)
    jcfg = lora_configs()[0]
    init = leaves(jax_init(jcfg))
    assert _bytes(hparams[-1]) == _bytes(init)
    assert _bytes(hparams[0]) == _bytes(params[0])     # round 0 holds too
    assert _bytes(hfactors[0]) == _bytes(factors[0])
    held_f = {}
    for path, v in hfactors[-1].items():
        trees_path = path.strip("/").split("/")
        node = held_f
        for k in trees_path[:-1]:
            node = node.setdefault(k, {})
        node[trees_path[-1]] = v
    held_p = trees.unflatten(jax_init(jcfg), list(hparams[-1].values()))
    oracle = leaves(jax.tree.map(np.asarray, jax_lora.merge_adapters(
        held_p, held_f, ALPHA, RANK)))
    for k in oracle:
        np.testing.assert_allclose(params[-1][k], oracle[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    for path, v in factors[-1].items():
        if path.endswith(lora.B_KEY):
            assert np.all(v == 0)
        else:
            assert np.array_equal(v, hfactors[-1][path])     # A is kept
    assert any(np.any(v != 0) for p, v in hfactors[-1].items()
               if p.endswith(lora.B_KEY))


def test_socket_secure_agg_over_factors_lands_on_the_plain_run():
    recs, params, factors = lora_run(lora_merge_every=2)
    srecs, sparams, sfactors = lora_run(lora_merge_every=2, secure_agg=True)
    assert all(r["completed"] == 2 and not r["unmask_failed"]
               for r in srecs)
    assert srecs[-1]["lora_merged"]
    for a, b in zip(sfactors[-1].values(), factors[-1].values()):
        np.testing.assert_allclose(a, b, atol=2e-4)
    for a, b in zip(sparams[-1].values(), params[-1].values()):
        np.testing.assert_allclose(a, b, atol=2e-3)
    # The masked uplink is the factor tree too.
    assert srecs[0]["bytes_saved_uplink"] == recs[0]["bytes_saved_uplink"]


def test_lora_off_leaves_the_record_keys_as_they_are():
    cfgs = configs(num_clients=2)
    with Federation(cfgs, 2, want_evaluator=False) as f:
        rec = f.coord.run_round()
    for key in ("lora_merged", "bytes_saved_uplink",
                "uplink_densify_avoided"):
        assert key not in rec


def _coordinator_pair(**fed):
    """A port and a JAX coordinator of one LoRA config (no devices)."""
    jcfg, tcfg = lora_configs(**fed)
    from colearn_federated_learning_tpu.comm import broker as jax_broker
    from colearn_federated_learning_tpu_torch.comm import broker
    from colearn_federated_learning_tpu_torch.comm.coordinator import (
        FederatedCoordinator)

    stack = contextlib.ExitStack()
    tb = stack.enter_context(broker.MessageBroker())
    jb = stack.enter_context(jax_broker.MessageBroker())
    ours = FederatedCoordinator(tcfg, tb.host, tb.port, device="cpu",
                                want_evaluator=False)
    stack.callback(ours.close)
    theirs = jax_coord.FederatedCoordinator(jcfg, jb.host, jb.port,
                                            want_evaluator=False)
    stack.callback(theirs.close)
    ours._load_params(jax_init(jcfg))
    ours._load_factors(jax.tree.map(np.asarray, theirs._factors))
    return stack, ours, theirs


@pytest.mark.parametrize("compress", ["none", "topk8"])
def test_composite_frame_and_uplink_pricing_are_jax_s(compress):
    stack, ours, theirs = _coordinator_pair(compress=compress)
    with stack:
        for r in (0, 3):
            body, resync, saved = ours._encode_lora_round(r)
            jbody, jresync, jsaved = theirs._encode_lora_round(r)
            assert bytes(body) == bytes(jbody)
            assert (resync, saved) == (jresync, jsaved) == (None, 0)
        assert ours._uplink_saved_per_update == \
            theirs._uplink_saved_per_update > 0
        assert {k: v.shape for k, v in leaves(ours._fold_shapes).items()} \
            == {k: v.shape for k, v in leaves(theirs._fold_shapes).items()}


@pytest.mark.parametrize("coord,workers", [("port", "jax"), ("jax", "port")])
def test_mixed_federations_fold_as_the_one_package_ones(coord, workers):
    """A port coordinator folds JAX workers' factor updates as JAX's does,
    and a JAX coordinator the port workers' as the port's does: the same
    f32 sums in the same order, bit for bit."""
    recs, params, factors = lora_run(coord, workers, rounds=1,
                                     lora_merge_every=100)
    one = workers                                  # who trained the updates
    orecs, oparams, ofactors = lora_run(one, one, rounds=1,
                                        lora_merge_every=100)
    assert _bytes(factors[0]) == _bytes(ofactors[0])
    assert _bytes(params[0]) == _bytes(oparams[0])
    assert recs[0]["completed"] == orecs[0]["completed"] == 2
    assert recs[0]["lora_merged"] is orecs[0]["lora_merged"] is False


# ----------------------------------------------------------------- tree --
def _factor_template():
    jcfg, _, jparams, _ = family_params("bert")
    return jax.tree.map(np.asarray, jax_lora.init_factors(
        jparams, RANK, model_name=jcfg.model.name))


def _factor_updates(scheme, n, seed=70):
    shapes = _factor_template()
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        delta = trees.map_leaves(
            lambda a: (0.01 * rng.standard_normal(a.shape)).astype(
                np.float32), shapes)
        meta = {"client_id": str(i), "round": 0,
                "weight": 1.0 + 0.5 * i, "mean_loss": 0.3}
        if scheme == "dense":
            wire = delta
        else:
            wire, fields = compression.compress_delta(delta, scheme,
                                                      topk_fraction=0.25)
            meta.update(fields)
        out.append((meta, wire))
    return shapes, out


@pytest.mark.parametrize("scheme", ["dense", "topk8"])
def test_factor_partials_combine_bitwise_as_the_flat_fold(scheme):
    shapes, updates = _factor_updates(scheme, 5)
    order = [str(i) for i in range(5)]
    layout = aggregator.slice_cohort(order, 2)
    jflat = jax_aggregation.StreamingFolder(shapes, order=order,
                                            slices=layout)
    for meta, wire in reversed(updates):
        jflat.add(dict(meta), copy.deepcopy(wire))
    jflat.finalize()
    for device_fold in (False, True):
        kw = dict(device_fold=True, device="cpu") if device_fold else {}
        root = StreamingFolder(shapes, order=[f"slice:{i}" for i in
                                              range(len(layout))], **kw)
        for i, sl in enumerate(layout):
            leaf = StreamingFolder(shapes, order=list(sl), **kw)
            for meta, wire in updates:
                if meta["client_id"] in sl:
                    leaf.add(dict(meta), copy.deepcopy(wire))
            leaf.finalize()
            root.add_partial(f"slice:{i}", leaf.total_w, leaf.wsum,
                             leaf.loss_sum, count=leaf.count)
        root.finalize()
        assert root.total_w == jflat.total_w
        assert root.loss_sum == jflat.loss_sum
        assert _bytes(root.wsum) == _bytes(jflat.wsum)


def _buffer_conversation(side, scheme):
    """A LoRA ``aprep`` (the composite with the ``lora`` marker), every
    factor contribution's ``abuf`` and a drain, at one aggregator."""
    jcfg, tcfg = lora_configs()
    agg = (aggregator.AggregatorServer(tcfg, 0, device="cpu")
           if side == "port" else jax_agg.AggregatorServer(jcfg, 0)).start()
    shapes, updates = _factor_updates(scheme, 3)
    composite = {"base": {"w": np.zeros((3, 2), np.float32)},
                 "factors": shapes}
    cli = TensorClient(agg.host, agg.port, timeout=WAIT)
    try:
        prep = cli.request({"op": "aprep", "meta": {"lora": RANK}},
                           composite, timeout=WAIT)[0]
        staged = [cli.request(
            {"op": "abuf", "key": f"{4:08d}@{m['client_id']}",
             "device": m["client_id"], "version": 4, "meta": dict(m)},
            copy.deepcopy(w), timeout=WAIT)[0] for m, w in updates]
        drain, partial = cli.request(
            {"op": "adrain", "interval_s": 0.5, "timeout": 0.2,
             "slice_devices": len(updates)}, timeout=WAIT)
    finally:
        cli.close()
        agg.stop()
    return prep, staged, drain, partial


@pytest.mark.parametrize("scheme", ["dense", "topk8"])
def test_aggregator_buffers_factor_updates_as_jax(scheme):
    prep, staged, drain, partial = _buffer_conversation("port", scheme)
    jprep, jstaged, jdrain, jpartial = _buffer_conversation("jax", scheme)
    assert prep["status"] == jprep["status"] == "ok"
    assert prep["meta"] == jprep["meta"]
    assert [h["meta"] for h in staged] == [h["meta"] for h in jstaged]
    assert drain["meta"]["count"] == jdrain["meta"]["count"] == 3
    assert drain["meta"]["keys"] == jdrain["meta"]["keys"]
    assert drain["meta"]["total_w"] == jdrain["meta"]["total_w"]
    assert _bytes(partial) == _bytes(jpartial)
    assert trees.leaves(partial)[0].shape == trees.leaves(
        _factor_template())[0].shape


def test_tree_federation_folds_factor_updates_as_the_flat_one():
    """2 port aggregators relay the composite (its ``lora`` marker
    reaching the workers through the tier) and fold factor updates: the
    round equals the flat federation's."""
    from colearn_federated_learning_tpu_torch.comm import broker
    from colearn_federated_learning_tpu_torch.comm.coordinator import (
        FederatedCoordinator)
    from colearn_federated_learning_tpu_torch.comm.worker import DeviceWorker

    jcfg, tcfg = lora_configs(momentum=0.0, lr=0.05, lora_merge_every=100,
                              run_kw=dict(num_aggregators=2))
    with contextlib.ExitStack() as stack:
        b = stack.enter_context(broker.MessageBroker())
        for i in range(2):
            w = DeviceWorker(tcfg, i, b.host, b.port, device="cpu",
                             draws=JaxDraws(tcfg.run.seed))
            stack.callback(w.start().stop)
        for a in range(2):
            agg = aggregator.AggregatorServer(tcfg, a, b.host, b.port)
            stack.callback(agg.start().stop)
        c = FederatedCoordinator(tcfg, b.host, b.port, round_timeout=30.0,
                                 want_evaluator=False, device="cpu")
        stack.callback(c.close)
        c._load_params(jax_init(jcfg))
        c._load_factors(jax.tree.map(
            np.asarray, jax_setup.init_lora_factors(jcfg, jax_init(jcfg))))
        c.enroll(min_devices=2, timeout=WAIT)
        c.trainers.sort(key=lambda d: int(d.device_id))
        assert c.enroll_aggregators(timeout=WAIT) == [0, 1]
        rec = c.run_round()
        factors = leaves(host(c._factors))
    frecs, _, ffactors = lora_run(rounds=1, lora_merge_every=100)
    assert rec["aggregators"] == 2 and rec["completed"] == 2
    assert rec["lora_merged"] is False
    assert rec["bytes_saved_uplink"] == frecs[0]["bytes_saved_uplink"]
    for k, v in ffactors[0].items():
        np.testing.assert_allclose(factors[k], v, rtol=RTOL, atol=ATOL,
                                   err_msg=k)
