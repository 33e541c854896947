"""Remat (activation checkpointing) of the port's transformer families.

``ModelConfig.remat`` runs every block of BERT, MoE-BERT and ViT under
``torch.utils.checkpoint(..., use_reentrant=False)``: the parameter names
do not change (the JAX package's point of naming its remat blocks), and
the loss and gradients are those without remat — bit for bit on the CPU,
where the recomputed forward runs the same kernels on the same inputs.
MoE-BERT's load-balance term, which the MoE layers leave on themselves,
keeps its gradient through the recomputation, and a remat round of the
learner gives the round without it.  Against JAX: the port's remat BERT
gives the JAX remat BERT's loss and gradients through converted params
(f32, rtol 1e-4 / atol 2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.fed import losses as jax_losses
from colearn_federated_learning_tpu.models import registry as jax_registry
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu_torch import convert
from colearn_federated_learning_tpu_torch.fed import FederatedLearner, local
from colearn_federated_learning_tpu_torch.fed import losses
from colearn_federated_learning_tpu_torch.models import registry
from colearn_federated_learning_tpu_torch.models.moe import MoEFfn
from colearn_federated_learning_tpu_torch.utils import config, prng

RTOL, ATOL = 1e-4, 2e-5
MODELS = {
    "bert": dict(name="bert", num_classes=4, width=32, depth=2, num_heads=4,
                 seq_len=64, vocab_size=2000),
    "moe_bert": dict(name="moe_bert", num_classes=4, width=32, depth=2,
                     num_heads=4, seq_len=64, vocab_size=2000, num_experts=4),
    "vit_b16": dict(name="vit_b16", num_classes=4, width=32, depth=2,
                    num_heads=4, patch_size=4),
}
AUX_WEIGHT = 0.01


def _inputs(name):
    rng = np.random.default_rng(0)
    if name == "vit_b16":
        x = torch.from_numpy(rng.standard_normal((4, 28, 28, 1))
                             .astype(np.float32))
    else:
        ids = rng.integers(1, 2000, size=(4, 64))
        ids[1, 30:] = 0
        x = torch.from_numpy(ids).long()
    return x, torch.from_numpy(rng.integers(0, 4, size=4)).long()


def _model(name, remat):
    cfg = config.ModelConfig(**MODELS[name], remat=remat)
    return registry.build_model(cfg, "cpu", generator=prng.init_generator(0),
                                input_shape=(28, 28, 1))


def _loss_and_grads(model, x, y):
    loss = losses.softmax_cross_entropy(model(x), y)
    moe = [m for m in model.modules() if isinstance(m, MoEFfn)]
    if moe:                                  # fed/local.py's balance term
        loss = loss + AUX_WEIGHT * sum(m.aux for m in moe) / len(moe)
    return loss, torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("name", list(MODELS))
def test_remat_grads_equal_the_plain_grads(name):
    x, y = _inputs(name)
    plain, remat = _model(name, False), _model(name, True)
    assert [n for n, _ in plain.named_parameters()] == \
        [n for n, _ in remat.named_parameters()]
    l0, g0 = _loss_and_grads(plain, x, y)
    l1, g1 = _loss_and_grads(remat, x, y)
    assert float(l0.detach()) == float(l1.detach())
    for (n, _), a, b in zip(plain.named_parameters(), g0, g1):
        assert torch.equal(a, b), n


def test_moe_balance_term_keeps_its_gradient_under_remat():
    x, y = _inputs("moe_bert")
    model = _model("moe_bert", True)
    router = "TransformerBlock_1.MoEFfn_0.router.weight"
    names = [n for n, _ in model.named_parameters()]
    ce = losses.softmax_cross_entropy(model(x), y)
    g_ce = torch.autograd.grad(ce, list(model.parameters()))
    _, g_all = _loss_and_grads(model, x, y)
    i = names.index(router)
    # The balance term moves the router's gradient, and by the term's own
    # gradient: the difference is that of AUX_WEIGHT · aux alone.
    model(x)
    aux = [m for m in model.modules() if isinstance(m, MoEFfn)][0].aux
    g_aux = torch.autograd.grad(AUX_WEIGHT * aux, [model.get_parameter(router)])
    assert float((g_all[i] - g_ce[i]).abs().max()) > 0
    torch.testing.assert_close(g_all[i] - g_ce[i], g_aux[0], rtol=RTOL,
                               atol=1e-7)


def _round_config(name, remat):
    return config.ExperimentConfig(
        data=config.DataConfig(dataset="agnews_tiny", partition="iid",
                               num_clients=3),
        model=config.ModelConfig(**MODELS[name], remat=remat),
        fed=config.FedConfig(rounds=1, cohort_size=3, local_steps=2,
                             batch_size=4, lr=1e-3, local_optimizer="adam"),
        run=config.RunConfig(seed=3))


@pytest.mark.parametrize("name", ["bert", "moe_bert"])
def test_remat_round_equals_the_plain_round(name):
    out = []
    for remat in (False, True):
        ln = FederatedLearner(_round_config(name, remat), device="cpu")
        rec = ln.run_round()
        out.append((rec["train_loss"], {k: v.clone()
                                         for k, v in ln.params.items()}))
    assert out[0][0] == out[1][0]
    for k, v in out[0][1].items():
        assert torch.equal(v, out[1][1][k]), k


def test_remat_bert_matches_jax_remat_bert():
    kw = dict(MODELS["bert"], remat=True)
    x, y = _inputs("bert")
    jmodel = jax_registry.build_model(jax_config.ModelConfig(**kw))
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    params = jax_registry.init_params(jmodel, jx, jax.random.PRNGKey(0))

    def jloss(p):
        return jax_losses.softmax_cross_entropy(
            jmodel.apply({"params": p}, jx, train=True), jy)

    want_loss, want = jax.value_and_grad(jloss)(params)
    model = registry.build_model(config.ModelConfig(**kw), "cpu")
    model.load_state_dict(convert.flax_to_state_dict(jax.device_get(params)))
    loss, grads = _loss_and_grads(model, x, y)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=RTOL)
    want = convert.flax_to_state_dict(jax.tree.map(np.asarray, want))
    for (n, _), g in zip(model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=n)


def test_local_update_with_remat_keeps_the_balance_term():
    """The local trainer's MoE term under remat: 2 SGD steps give the
    plain model's delta exactly."""
    x, y = _inputs("moe_bert")
    deltas = []
    for remat in (False, True):
        model = _model("moe_bert", remat)
        upd = local.make_local_update(model, local.make_optimizer(0.1, 0.0),
                                      2, aux_loss_weight=AUX_WEIGHT)
        start = [p.detach().clone() for p in model.parameters()]
        res = upd(start, x, y, 4, torch.tensor([[0, 1, 2, 3]] * 2), 2)
        deltas.append(res.delta)
    for a, b in zip(*deltas):
        assert torch.equal(a, b)
