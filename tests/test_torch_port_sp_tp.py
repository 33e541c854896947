"""Sequence and tensor parallelism of the port against the JAX package.

- The partition rules: on every family, the port's rule engine gives
  JAX's specs on JAX's own params (``tp.param_specs``, each family's
  ``rules_for_model`` set, at axis sizes 2 and 3), the same sharded
  fraction, and its map onto the port's torch layouts shards the torch
  dim that holds the flax sharded axis (divisibility on the head count:
  3 heads at size 2 replicate, as ``tests/test_tp.py`` pins).
- On 4 spawned gloo ranks (``tests/torch_port_ranks.py``) against JAX on
  ``cpu_devices[:4]``:
  - ring and Ulysses attention on a 4-way ``seq`` axis, forward and the
    gradients of q, k and v, with a key-padding mask (one example's keys
    all masked) and causal, against the dense oracle and JAX's
    ``ring_attention``/``ulysses_attention`` under ``shard_map`` (whose
    ring gradients are NaN on the all-masked example, which is therefore
    held to the dense oracle alone), and Ulysses' refusal of 3 heads on
    4 ranks with JAX's message;
  - ``parallel.sp`` on the SP BERT (ring and Ulysses): logits, loss and
    gradients against the dense model on the full sequence;
  - ``FederatedLearner.from_config`` over the world of 4: JAX's layouts
    ((clients,), (clients, seq), (clients, model));
  - an SP federated round (ring) on a (clients 2, seq 2) mesh and a TP
    round of MoE-BERT with DP on a (clients 2, model 2) mesh (vocab,
    heads, MLP and expert banks all sharded), each 2 rounds against the
    JAX learner on the same mesh with its recorded draws.

Tolerance: f32; rtol 1e-4 / atol 2e-5 everywhere.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from colearn_federated_learning_tpu.fed import FederatedLearner as JaxLearner
from colearn_federated_learning_tpu.models import registry as jax_registry
from colearn_federated_learning_tpu.parallel import partition as jax_partition
from colearn_federated_learning_tpu.parallel import ring as jax_ring
from colearn_federated_learning_tpu.parallel import tp as jax_tp
from colearn_federated_learning_tpu.parallel import ulysses as jax_ulysses
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu.utils.jax_compat import shard_map
from colearn_federated_learning_tpu_torch import convert
from colearn_federated_learning_tpu_torch.fed import losses
from colearn_federated_learning_tpu_torch.models import registry
from colearn_federated_learning_tpu_torch.ops import attention as attn_ops
from colearn_federated_learning_tpu_torch.parallel import partition, tp
from colearn_federated_learning_tpu_torch.utils import config
from test_torch_port_mesh import record_draws
from torch_port_ranks import spawn

RTOL, ATOL = 1e-4, 2e-5
WORLD = 4
BERT = dict(name="bert", num_classes=4, width=32, depth=2, num_heads=4,
            seq_len=64, vocab_size=2000)
FAMILIES = {
    "bert": (dict(BERT), None),
    "bert_3_heads": (dict(BERT, width=48, num_heads=3), None),
    "moe_bert": (dict(BERT, name="moe_bert", num_experts=4), None),
    "vit_b16": (dict(name="vit_b16", num_classes=10, width=32, depth=2,
                     num_heads=4), (28, 28, 1)),
    "cnn": (dict(name="cnn", num_classes=10, width=8), (32, 32, 3)),
    "resnet18": (dict(name="resnet18", num_classes=10, width=8), (32, 32, 3)),
    "mlp": (dict(name="mlp", num_classes=10, hidden_dim=32, depth=2),
            (28, 28, 1)),
    "tcn": (dict(name="tcn", num_classes=8, width=8, depth=3), (32, 8)),
}


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _jax_params(kw, shape):
    """JAX's param tree of the family, as shapes (nothing is computed)."""
    model = jax_registry.build_model(jax_config.ModelConfig(**kw))
    x = (jnp.ones((2, kw.get("seq_len", 8)), jnp.int32) if shape is None
         else jnp.ones((2,) + shape, jnp.float32))
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x,
                                             train=False))["params"]


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("family", list(FAMILIES))
def test_rule_specs_equal_jax_on_every_family(family):
    kw, shape = FAMILIES[family]
    params = _jax_params(kw, shape)
    port_model = registry.build_model(config.ModelConfig(**kw), "cpu",
                                      input_shape=shape)
    heads = kw.get("num_heads")
    named = {n: tuple(p.shape) for n, p in port_model.named_parameters()}
    for size in (2, 3):
        want = jax_tp.param_specs(params, "model", size)
        got = tp.param_specs(params, "model", size)
        for (path, g), (_, w) in zip(_paths(got), _paths(want)):
            assert g == tuple(w), (path, g, w)
        assert (tp.sharded_fraction(params, "model", size)
                == jax_tp.sharded_fraction(params, "model", size))
        rules = partition.rules_for_model(kw["name"])
        assert rules == jax_partition.rules_for_model(kw["name"])
        want = jax_partition.match_partition_rules(
            rules, params, axis="model", sizes={"model": size})
        got = partition.match_partition_rules(rules, params, axis="model",
                                              sizes={"model": size})
        for (path, g), (_, w) in zip(_paths(got), _paths(want)):
            assert g == tuple(w), (path, g, w)
        # The same rules on the port's own layouts shard the torch dim
        # that holds JAX's sharded flax axis.
        specs = dict(_paths(jax_tp.param_specs(params, "model", size)))
        dims = partition.torch_shard_dims(named, partition.TRANSFORMER_RULES,
                                          "model", size, heads)
        for name, dim in dims.items():
            path, fshape, to_torch = convert.flax_layout(name, named[name],
                                                         heads)
            spec = tuple(specs[path])
            assert fshape == np.shape(dict(_paths(params))[path]), name
            want_dim = next((to_torch[i] for i, e in enumerate(spec)
                             if e == "model"), None)
            assert dim == want_dim, (name, dim, spec)
    if family == "bert_3_heads":              # tests/test_tp.py:95
        dims = tp.shard_dims(port_model, "model", 2)
        assert dims["TransformerBlock_0.MultiHeadAttention_0.query.weight"] \
            is None


# ----------------------------------------------------------- the ranks
def _attention_inputs():
    rng = np.random.default_rng(0)
    B, L, H, D = 2, 16, 4, 8
    q, k, v, cot = (rng.standard_normal((B, L, H, D)).astype(np.float32)
                    for _ in range(4))
    mask = np.ones((B, L), bool)
    mask[0, 11:] = False
    mask[1, :] = False                         # every key masked
    return dict(q=q, k=k, v=v, cot=cot, mask=mask, world=WORLD)


def _jax_attention(inp, impl, causal, devices):
    mesh = Mesh(np.array(devices), ("seq",))
    fn = {"ring": jax_ring.ring_attention,
          "ulysses": jax_ulysses.ulysses_attention}[impl]
    spec = P(None, "seq")
    sharded = shard_map(
        lambda q, k, v, m: fn(q, k, v, m, axis_name="seq", causal=causal),
        mesh=mesh, in_specs=(spec,) * 4, out_specs=spec, check_vma=False)
    @jax.jit
    def fwd_bwd(q, k, v, mask, cot):
        out, vjp = jax.vjp(lambda q, k, v: sharded(q, k, v, mask), q, k, v)
        return (out,) + vjp(cot)

    return [np.asarray(a) for a in fwd_bwd(
        *[jnp.asarray(inp[n]) for n in ("q", "k", "v", "mask", "cot")])]


def _dense(inp, causal):
    q, k, v = (torch.from_numpy(inp[n]).requires_grad_() for n in "qkv")
    o = attn_ops.dense_attention(q, k, v, torch.from_numpy(inp["mask"]),
                                 causal=causal)
    grads = torch.autograd.grad((o * torch.from_numpy(inp["cot"])).sum(),
                                [q, k, v])
    return [o.detach().numpy()] + [g.numpy() for g in grads]


def _sp_inputs():
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 2000, size=(3, 64))
    ids[0, 40:] = 0
    cfg = config.ModelConfig(**BERT)
    model = registry.build_model(cfg, "cpu", generator=torch.Generator()
                                 .manual_seed(0))
    return dict(world=WORLD, model_config=cfg, ids=ids,
                y=rng.integers(0, 4, size=3),
                state_dict={k: v.numpy() for k, v in
                            model.state_dict().items()}), model


def _round_configs(model_kw, fed_kw, run_kw=None):
    kw = dict(data=dict(dataset="agnews_tiny", partition="iid",
                        num_clients=4, max_examples_per_client=16),
              model=model_kw,
              fed=dict(dict(rounds=2, local_steps=2, batch_size=4, lr=0.05,
                            momentum=0.0, local_optimizer="sgd"), **fed_kw),
              run=dict(seed=3, **(run_kw or {})))
    return [mod.ExperimentConfig(
        data=mod.DataConfig(**kw["data"]), model=mod.ModelConfig(**kw["model"]),
        fed=mod.FedConfig(**kw["fed"]), run=mod.RunConfig(**kw["run"]))
        for mod in (jax_config, config)]


# from_config's layouts over a world of 4: (model config, fed, run).
LAYOUTS = {
    "clients": (dict(BERT), {}, {}),
    "seq": (dict(BERT, attn_impl="ulysses"), {}, {}),
    "model": (dict(BERT), {}, dict(tp_size=2)),
}
ROUND_CASES = {
    "sp_ring": (("clients", "seq"), dict(BERT, attn_impl="ring"), {}),
    "tp_moe_dp": (("clients", "model"),
                  dict(BERT, name="moe_bert", num_experts=4),
                  dict(dp_clip=1.0, dp_noise_multiplier=0.3)),
}


@pytest.fixture(scope="module")
def runs(cpu_devices, tmp_path_factory):
    import threading

    att = _attention_inputs()
    sp_inp, dense_model = _sp_inputs()
    jobs = [("attention", att), ("sp_model", sp_inp),
            ("layouts", dict(configs={name: _round_configs(*kw)[1]
                                      for name, kw in LAYOUTS.items()}))]
    learners = {}
    for name, (axes, model_kw, fed_kw) in ROUND_CASES.items():
        jcfg, tcfg = _round_configs(model_kw, fed_kw)
        mesh = Mesh(np.array(cpu_devices[:WORLD]).reshape(2, 2), axes)
        jl = JaxLearner(jcfg, mesh=mesh)
        learners[name] = jl
        jobs.append(("learner_rounds", dict(
            config=tcfg, mesh=(axes, (2, 2)), rounds=2,
            params=jax.device_get(jl.params),
            draws=record_draws(jl, tcfg, 2))))
    box = {}

    def run_ranks():
        try:
            box["ranks"] = spawn(WORLD, tmp_path_factory.mktemp("sp_tp"),
                                 jobs, timeout=300.0)
        except Exception as e:
            box["ranks"] = e

    th = threading.Thread(target=run_ranks)
    th.start()
    want = {}
    for impl in ("ring", "ulysses"):
        for causal in (False, True):
            want[(impl, causal)] = _jax_attention(att, impl, causal,
                                                  cpu_devices[:WORLD])
    rounds = {}
    for name, jl in learners.items():
        recs = [jl.run_round() for _ in range(2)]
        rounds[name] = dict(records=recs, eval=jl.evaluate(),
                            params=jax.device_get(jl.server_state.params))
    th.join()
    if isinstance(box["ranks"], Exception):
        raise box["ranks"]
    return dict(att=att, want=want, sp=sp_inp, dense_model=dense_model,
                rounds=rounds, ranks=box["ranks"])


def _assemble(ranks, job, key):
    """Concatenate the ranks' sequence blocks of each returned array."""
    parts = [r[job][key] for r in ranks]
    return [np.concatenate([p[i] for p in parts], axis=1)
            for i in range(len(parts[0]))]


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_sp_attention_matches_dense_and_jax(runs, impl, causal):
    got = _assemble(runs["ranks"], 0, (impl, causal))
    dense = _dense(runs["att"], causal)
    for what, g, d, w in zip(("out", "dq", "dk", "dv"), got, dense,
                             runs["want"][(impl, causal)]):
        _close(g, d, f"{impl} {what} vs dense")
        # JAX's ring gradients are NaN on the example whose every key is
        # masked (its forward is 0 there, like the dense oracle's); the
        # port's are the dense oracle's, checked above.
        rows = slice(None) if what == "out" else slice(0, 1)
        _close(g[rows], w[rows], f"{impl} {what} vs JAX")
    assert np.all(got[0][1] == 0.0)            # fully masked rows are 0


def test_ulysses_refuses_indivisible_heads_like_jax(runs):
    msg = runs["ranks"][0][0]["ulysses_error"]
    assert msg == ("ulysses attention needs heads (3) divisible by the "
                   "'seq' axis size (4); use attn_impl='ring' otherwise")


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sp_model_matches_the_dense_model(runs, impl):
    inp, model = runs["sp"], runs["dense_model"]
    ids = torch.from_numpy(inp["ids"]).long()
    logits = model(ids)
    loss = losses.softmax_cross_entropy(logits, torch.from_numpy(inp["y"])
                                        .long())
    grads = torch.autograd.grad(loss, list(model.parameters()))
    for rank in runs["ranks"]:
        got_logits, got_loss, got_grads = rank[1][impl]
        _close(got_logits, logits.detach().numpy(), "logits")
        _close(got_loss, float(loss.detach()), "loss")
        for (n, _), g, w in zip(model.named_parameters(), got_grads, grads):
            _close(g, w.numpy(), n)


def test_from_config_lays_the_world_as_jax_lays_its_devices(runs,
                                                           cpu_devices):
    """Under a world of 4, ``from_config`` builds the mesh JAX's
    ``from_config`` builds over 4 devices: (clients,), (clients, seq)
    for a Ulysses config, (clients, model) for ``tp_size`` 2."""
    from colearn_federated_learning_tpu.parallel.mesh import make_mesh

    want = {"clients": (("clients",), (4,)),
            "seq": (("clients", "seq"), tuple(make_mesh(
                ("clients", "seq"), devices=cpu_devices[:4]).devices.shape)),
            "model": (("clients", "model"), tuple(make_mesh(
                ("clients", "model"), (-1, 2),
                devices=cpu_devices[:4]).devices.shape))}
    for rank in runs["ranks"]:
        assert rank[2] == want


@pytest.mark.parametrize("name", list(ROUND_CASES))
def test_parallel_round_matches_jax_mesh(runs, name):
    want = runs["rounds"][name]
    want_params = convert.flax_to_state_dict(
        jax.tree.map(np.asarray, want["params"]))
    job = 3 + list(ROUND_CASES).index(name)
    for rank, r in enumerate(runs["ranks"]):
        out = r[job]
        for tr, jr in zip(out["records"], want["records"]):
            assert tr["completed"] == jr["completed"]
            for k in ("train_loss", "total_weight", "delta_norm_mean",
                      "dp_epsilon"):
                assert (k in tr) == (k in jr), k
                if k in jr:
                    _close(tr[k], jr[k], f"{name} rank {rank} {k}")
        for n, t in out["params"].items():
            _close(t, want_params[n].numpy(), f"{name} rank {rank} {n}")
        _close(out["eval"], want["eval"], f"{name} eval")
        if name.startswith("tp"):
            # Each rank holds half of every sharded leaf: vocab, heads,
            # MLP hidden units and experts.
            sharded = {n for n, d in zip(out["params"], out["tp_dims"])
                       if d is not None}
            assert {"Embed_0.weight",
                    "TransformerBlock_0.MultiHeadAttention_0.query.weight",
                    "TransformerBlock_0.Dense_0.weight",
                    "TransformerBlock_1.MoEFfn_0.experts_up"} <= sharded
            for n in sharded:
                full, local = out["params"][n].shape, out["local_shapes"][n]
                assert int(np.prod(full)) == 2 * int(np.prod(local)), n
