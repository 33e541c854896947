"""The port's BERT classifier and converter against the JAX package's.

- The flax -> torch -> flax parameter round trip is bit-exact.
- ``BertClassifier`` (depth 2, width 64, 4 heads, seq 32, vocab 500) gives
  the same logits, loss and loss gradients as flax through converted
  params, with the flash and the dense attention core.  f32; tolerance
  rtol 1e-4, atol 2e-5 (summation order is the only difference).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.fed import losses as jax_losses
from colearn_federated_learning_tpu.models import registry as jax_registry
from colearn_federated_learning_tpu.utils.config import (
    ModelConfig as JaxModelConfig,
)
from colearn_federated_learning_tpu_torch import convert
from colearn_federated_learning_tpu_torch.fed import losses
from colearn_federated_learning_tpu_torch.models import registry
from colearn_federated_learning_tpu_torch.utils import prng
from colearn_federated_learning_tpu_torch.utils.config import ModelConfig

RTOL, ATOL = 1e-4, 2e-5
SIZES = dict(name="bert", num_classes=4, width=64, depth=2, num_heads=4,
             seq_len=32, vocab_size=500)


def _batch(seed=0, B=6, L=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 500, size=(B, L)).astype(np.int32)
    lengths = rng.integers(L // 4, L + 1, size=B)
    ids[np.arange(L)[None, :] >= lengths[:, None]] = 0
    ids[2] = 0                                  # an all-padding example
    y = rng.integers(0, 4, size=B).astype(np.int32)
    return ids, y


def _flax_params(seed=0):
    model = jax_registry.build_model(JaxModelConfig(**SIZES))
    ids, _ = _batch()
    params = jax_registry.init_params(model, jnp.asarray(ids),
                                      jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_converter_round_trip_is_exact():
    params = _flax_params()
    sd = convert.flax_to_state_dict(params)
    back = convert.state_dict_to_flax(sd, num_heads=SIZES["num_heads"])
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for (path, a), (_, b) in zip(_leaves(params), _leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert np.array_equal(a, b), path
    sd2 = convert.flax_to_state_dict(back)
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)


def test_converter_matches_model_state_dict():
    model = registry.build_model(ModelConfig(**SIZES), "cpu")
    sd = convert.flax_to_state_dict(_flax_params())
    want = model.state_dict()
    assert sorted(sd) == sorted(want)
    assert all(sd[k].shape == want[k].shape for k in sd)
    model.load_state_dict(sd)


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_bert_logits_and_grads_match_flax(impl):
    params = _flax_params(seed=1)
    ids, y = _batch(seed=2)
    jcfg = JaxModelConfig(**SIZES, attn_impl=impl)
    jmodel = jax_registry.build_model(jcfg)

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(ids), train=True)
        return jax_losses.softmax_cross_entropy(logits, jnp.asarray(y)), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    model = registry.build_model(ModelConfig(**SIZES, attn_impl=impl), "cpu")
    model.load_state_dict(convert.flax_to_state_dict(params))
    logits = model(torch.from_numpy(ids))
    loss = losses.softmax_cross_entropy(logits, torch.from_numpy(y))
    loss.backward()

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL, atol=ATOL)
    want = convert.flax_to_state_dict(jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_port_init_matches_flax_init_statistics():
    """The port draws its own init (not JAX's bits) from flax's
    distributions: same shapes, same zero/one constants, same scales."""
    model = registry.build_model(ModelConfig(**SIZES), "cpu",
                                 generator=prng.init_generator(0))
    ours = convert.state_dict_to_flax(model.state_dict(), SIZES["num_heads"])
    ref = _flax_params()
    for (path, a), (_, b) in zip(_leaves(ours), _leaves(ref)):
        assert a.shape == b.shape, path
        if np.all(b == b.flat[0]):              # biases and LN params
            assert np.array_equal(a, b), path
        else:
            np.testing.assert_allclose(a.std(), b.std(), rtol=0.25,
                                       err_msg=str(path))


def test_unported_families_and_cores_raise():
    """Remat on a family without transformer blocks is refused with the
    JAX registry's message, and a sequence-parallel core outside a
    sequence group refuses to run (remat and the ring/Ulysses cores are
    ported; their tests are test_torch_port_remat.py and
    test_torch_port_sp_tp.py)."""
    for name in ("cnn", "mlp"):
        cfg = ModelConfig(name=name, width=8, remat=True)
        with pytest.raises(ValueError, match="remat is only implemented"):
            registry.build_model(cfg, "cpu", input_shape=(8, 8, 3))
        with pytest.raises(ValueError, match="remat is only implemented"):
            jax_registry.build_model(JaxModelConfig(name=name, width=8,
                                                    remat=True))
    for impl in ("ring", "ulysses"):
        model = registry.build_model(
            ModelConfig(**dict(SIZES, name="bert"), attn_impl=impl), "cpu",
            generator=prng.init_generator(0))
        ids, _ = _batch()
        with pytest.raises(ValueError, match="needs a sequence group"):
            model(torch.from_numpy(ids).long())
