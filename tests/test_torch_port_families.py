"""The port's vision, time-series and MoE families against the JAX
package's: MLP, CNN (both stems, both norms), ResNet-18, TCN, ViT and
MoE-BERT (flash and dense cores where there is attention), at small
widths.

- The flax -> torch -> flax parameter round trip is bit-exact, and the
  converter's keys and shapes are the module's ``state_dict``'s.
- In f32, logits, loss and every parameter's gradient equal flax's
  through converted params: rtol 1e-4, atol 2e-5 (summation order is the
  only difference).  MoE's loss carries the load-balance term, as the
  local trainer adds it.
- In bf16 each side is held to the f32 truth: the port's max error is at
  most twice JAX's plus one bf16 step at the largest magnitude (the rule
  of ``chip_smoke.check_close``); bf16 rounds at other points in the two
  frameworks, so the two bf16 results are not compared with each other.
- The port draws its init from flax's distributions (not JAX's bits).
- The ``SAME`` padding of a stride-2 3×3 conv on an even size is (0, 1),
  and ``space_to_depth`` keeps flax's (bh, bw, c) channel order.
- MoE: the load-balance value equals the sown one, and padding claims no
  expert capacity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.fed import local as jax_local
from colearn_federated_learning_tpu.fed import losses as jax_losses
from colearn_federated_learning_tpu.models import registry as jax_registry
from colearn_federated_learning_tpu.models.cnn import (
    space_to_depth as jax_space_to_depth,
)
from colearn_federated_learning_tpu.models.moe import MoEFfn as JaxMoEFfn
from colearn_federated_learning_tpu.utils.config import (
    ModelConfig as JaxModelConfig,
)
from colearn_federated_learning_tpu_torch import convert
from colearn_federated_learning_tpu_torch.fed import losses
from colearn_federated_learning_tpu_torch.models import layers, registry
from colearn_federated_learning_tpu_torch.models.cnn import space_to_depth
from colearn_federated_learning_tpu_torch.models.moe import MoEFfn
from colearn_federated_learning_tpu_torch.utils import prng
from colearn_federated_learning_tpu_torch.utils.config import ModelConfig

RTOL, ATOL = 1e-4, 2e-5
BF16_ULP = 2.0 ** -8
AUX_WEIGHT = 0.01
B = 6

# name -> (ModelConfig fields, input kind, per-example shape)
FAMILIES = {
    "mlp": (dict(name="mlp", num_classes=10, hidden_dim=16, depth=2),
            "image", (28, 28, 1)),
    "cnn": (dict(name="cnn", num_classes=10, width=8), "image", (32, 32, 3)),
    "cnn_s2d_nonorm": (dict(name="cnn", num_classes=10, width=8,
                            stem="space_to_depth", norm="none"),
                       "image", (32, 32, 3)),
    "resnet18": (dict(name="resnet18", num_classes=10, width=8),
                 "image", (32, 32, 3)),
    "tcn": (dict(name="tcn", num_classes=8, width=8, depth=3),
            "series", (64, 16)),
    "vit_flash": (dict(name="vit_b16", num_classes=10, width=32, depth=2,
                       num_heads=4, attn_impl="flash"), "image", (28, 28, 1)),
    "vit_dense": (dict(name="vit_b16", num_classes=10, width=32, depth=2,
                       num_heads=4), "image", (28, 28, 1)),
    "moe_bert_flash": (dict(name="moe_bert", num_classes=4, width=32, depth=2,
                            num_heads=4, seq_len=32, vocab_size=500,
                            num_experts=4, attn_impl="flash"), "text", (32,)),
    "moe_bert_dense": (dict(name="moe_bert", num_classes=4, width=32, depth=2,
                            num_heads=4, seq_len=32, vocab_size=500,
                            num_experts=4), "text", (32,)),
}
NAMES = sorted(FAMILIES)


def _x(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "text":
        L = shape[0]
        ids = rng.integers(1, 500, size=(B, L)).astype(np.int32)
        lengths = rng.integers(L // 4, L + 1, size=B)
        ids[np.arange(L)[None, :] >= lengths[:, None]] = 0
        ids[2] = 0                               # an all-padding example
        return ids
    return rng.standard_normal((B,) + shape).astype(np.float32)


def _setup(name, dtype="float32", seed=0):
    kw, kind, shape = FAMILIES[name]
    kw = dict(kw, dtype=dtype)
    x = _x(kind, shape, seed + 1)
    y = np.random.default_rng(seed + 2).integers(
        0, kw["num_classes"], size=B).astype(np.int32)
    jmodel = jax_registry.build_model(JaxModelConfig(**kw))
    params = jax.tree.map(np.asarray, jax_registry.init_params(
        jmodel, jnp.asarray(x), jax.random.PRNGKey(seed)))
    return kw, shape, x, y, jmodel, params


def _port(kw, shape, params=None, **extra):
    model = registry.build_model(ModelConfig(**dict(kw, **extra)), "cpu",
                                 input_shape=shape)
    if params is not None:
        model.load_state_dict(convert.flax_to_state_dict(params))
    return model


def _heads(kw):
    return kw.get("num_heads")


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _jax_loss_fn(jmodel, x, y, moe):
    def loss(p):
        if moe:
            logits, upd = jmodel.apply({"params": p}, jnp.asarray(x),
                                       train=True, mutable=["intermediates"])
            aux = jax_local._sown_aux_mean(upd["intermediates"])
            extra = AUX_WEIGHT * aux
        else:
            logits = jmodel.apply({"params": p}, jnp.asarray(x), train=True)
            extra = 0.0
        return (jax_losses.softmax_cross_entropy(logits, jnp.asarray(y))
                + extra), logits
    return loss


@pytest.mark.parametrize("name", NAMES)
def test_converter_round_trip_is_exact(name):
    kw, shape, _, _, _, params = _setup(name)
    sd = convert.flax_to_state_dict(params)
    back = convert.state_dict_to_flax(sd, num_heads=_heads(kw))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for (path, a), (_, b) in zip(_leaves(params), _leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert np.array_equal(a, b), path
    sd2 = convert.flax_to_state_dict(back)
    assert sorted(sd2) == sorted(sd)
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)
    # And from the module's own (channels-last) tensors.
    model = _port(kw, shape, params)
    again = convert.state_dict_to_flax(model.state_dict(), _heads(kw))
    for (path, a), (_, b) in zip(_leaves(params), _leaves(again)):
        assert np.array_equal(a, b), path


@pytest.mark.parametrize("name", NAMES)
def test_converter_matches_model_state_dict(name):
    kw, shape, _, _, _, params = _setup(name)
    sd = convert.flax_to_state_dict(params)
    want = _port(kw, shape).state_dict()
    assert sorted(sd) == sorted(want)
    assert all(sd[k].shape == want[k].shape for k in sd), [
        (k, sd[k].shape, want[k].shape) for k in sd
        if sd[k].shape != want[k].shape]


@pytest.mark.parametrize("name", NAMES)
def test_logits_loss_and_grads_match_flax(name):
    kw, shape, x, y, jmodel, params = _setup(name, seed=3)
    moe = kw["name"] == "moe_bert"
    (jl, jlogits), jgrads = jax.value_and_grad(
        _jax_loss_fn(jmodel, x, y, moe), has_aux=True)(params)

    model = _port(kw, shape, params)
    logits = model(torch.from_numpy(x))
    loss = losses.softmax_cross_entropy(logits, torch.from_numpy(y).long())
    if moe:
        aux = [m.aux for m in model.modules() if isinstance(m, MoEFfn)]
        loss = loss + AUX_WEIGHT * (sum(aux) / len(aux))
    loss.backward()

    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL, atol=ATOL)
    want = convert.flax_to_state_dict(jax.tree.map(np.asarray, jgrads))
    for pname, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[pname].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=pname)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_error_within_twice_jax_error(name):
    kw, shape, x, _, _, params = _setup(name, seed=5)
    truth = np.asarray(jax_registry.build_model(JaxModelConfig(**kw)).apply(
        {"params": params}, jnp.asarray(x)))
    jbf = np.asarray(jax_registry.build_model(
        JaxModelConfig(**dict(kw, dtype="bfloat16"))).apply(
            {"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        ours = _port(kw, shape, params, dtype="bfloat16")(
            torch.from_numpy(x)).numpy()
    assert ours.dtype == np.float32 and np.isfinite(ours).all()
    err, jerr = np.abs(ours - truth).max(), np.abs(jbf - truth).max()
    assert err <= 2.0 * jerr + BF16_ULP * np.abs(truth).max(), (err, jerr)


@pytest.mark.parametrize("name", NAMES)
def test_port_init_matches_flax_init_statistics(name):
    """The port draws its own init from flax's distributions: same
    shapes, same zero/one constants, same scales."""
    kw, shape, _, _, _, ref = _setup(name)
    model = registry.build_model(ModelConfig(**kw), "cpu",
                                 generator=prng.init_generator(0),
                                 input_shape=shape)
    ours = convert.state_dict_to_flax(model.state_dict(), _heads(kw))
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for (path, a), (_, b) in zip(_leaves(ours), _leaves(ref)):
        assert a.shape == b.shape, path
        if np.all(b == b.flat[0]):              # biases, norms, cls
            assert np.array_equal(a, b), path
        else:
            np.testing.assert_allclose(a.std(), b.std(), rtol=0.25,
                                       err_msg=str(path))


@pytest.mark.parametrize("n,k,s,d,want", [
    (32, 3, 2, 1, (0, 1)),      # ResNet's stride-2 3x3: not (1, 1)
    (32, 1, 2, 1, (0, 0)),      # its 1x1 projection
    (32, 3, 1, 1, (1, 1)),
    (64, 3, 1, 4, (4, 4)),      # TCN, dilation 4
    (28, 4, 4, 1, (0, 0)),      # ViT's 4x4 patches on 28
    (7, 3, 2, 1, (1, 1)),
])
def test_same_padding_is_xla_same(n, k, s, d, want):
    assert layers.same_padding(n, k, s, d) == want
    out = jax.lax.conv_general_dilated(
        jnp.ones((1, n, 1)), jnp.ones((k, 1, 1)), (s,), "SAME",
        rhs_dilation=(d,), dimension_numbers=("NWC", "WIO", "NWC"))
    assert out.shape[1] == -(-n // s)


def test_resnet_stride2_conv_samples_flax_pixels():
    """A stride-2 3×3 ``SAME`` conv on 32 × 32 pads (0, 1): the port's
    ``layers.conv`` equals flax's, and the symmetric padding=1 does not."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    layer = torch.nn.Conv2d(3, 4, 3, bias=False)
    layer.weight.data = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = layers.conv(xt, layer, torch.float32, stride=2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), rtol=RTOL, atol=ATOL)
    sym = torch.nn.functional.conv2d(xt, layer.weight, None, 2, 1)
    assert not np.allclose(sym.permute(0, 2, 3, 1).detach().numpy(),
                           np.asarray(want), rtol=RTOL, atol=ATOL)


def test_space_to_depth_keeps_flax_channel_order():
    x = np.arange(2 * 4 * 6 * 3, dtype=np.float32).reshape(2, 4, 6, 3)
    got = space_to_depth(torch.from_numpy(x), 2).numpy()
    assert got.shape == (2, 2, 3, 12)
    assert np.array_equal(got, np.asarray(jax_space_to_depth(jnp.asarray(x))))
    # Channel (bh, bw, c) = (1, 0, 2) of output pixel (0, 0) is input
    # pixel (1, 0) channel 2.
    assert got[0, 0, 0, 1 * 6 + 0 * 3 + 2] == x[0, 1, 0, 2]


def _moe_pair(D, E, cf, seed):
    """The JAX and the port's MoE layer with the same params."""
    jmoe = JaxMoEFfn(D, E, capacity_factor=cf)
    x0 = jnp.zeros((1, 4, D))
    params = jax.tree.map(np.asarray, jmoe.init(jax.random.PRNGKey(seed),
                                                x0)["params"])
    moe = MoEFfn(D, E, capacity_factor=cf)
    moe.load_state_dict(convert.flax_to_state_dict(params))
    return jmoe, params, moe


def _jax_moe(jmoe, params, x, mask):
    out, upd = jmoe.apply({"params": params}, jnp.asarray(x),
                          token_mask=None if mask is None else jnp.asarray(mask),
                          mutable=["intermediates"])
    return np.asarray(out), float(upd["intermediates"]["moe_aux"][0])


@pytest.mark.parametrize("masked", [False, True])
def test_moe_output_and_aux_match_sown_value(masked):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 16, 32)).astype(np.float32)
    mask = rng.random((3, 16)) > 0.3 if masked else None
    jmoe, params, moe = _moe_pair(32, 4, 1.25, 1)
    jout, jaux = _jax_moe(jmoe, params, x, mask)
    with torch.no_grad():
        out = moe(torch.from_numpy(x),
                  None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), jout, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(moe.aux), jaux, rtol=RTOL, atol=ATOL)


def test_moe_padding_claims_no_capacity():
    """64 tokens of which the last 8 are real, capacity 8 per expert
    (capacity factor 0.25): with the mask, every real token gets its
    routes and every padding row is 0, as in JAX; without it, the padding
    ahead in the count fills the buffers and real tokens are dropped."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 16, 32)).astype(np.float32)
    mask = np.zeros((4, 16), bool)
    mask[3, 8:] = True
    jmoe, params, moe = _moe_pair(32, 4, 0.25, 2)
    jout, jaux = _jax_moe(jmoe, params, x, mask)
    with torch.no_grad():
        out = moe(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
        aux = float(moe.aux)
        unmasked = moe(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, jout, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(aux, jaux, rtol=RTOL, atol=ATOL)
    real = np.abs(out[mask]).max(-1)
    assert (real > 0).all()
    assert np.abs(out[~mask]).max() == 0.0
    assert (np.abs(unmasked[mask]).max(-1) == 0).any()


def test_moe_experts_use_flax_fan_in():
    """flax counts the stacked expert axis as receptive field: fan-in of
    an (E, D, F) bank is D·E, so its std is about 1/sqrt(D·E)."""
    moe = MoEFfn(64, 8)
    moe.reset_experts(torch.Generator().manual_seed(0))
    for bank in (moe.experts_up, moe.experts_down):
        want = 1.0 / np.sqrt(bank.shape[0] * bank.shape[1])
        np.testing.assert_allclose(float(bank.detach().std()), want, rtol=0.05)


def test_moe_bert_places_experts_in_odd_blocks():
    kw = dict(FAMILIES["moe_bert_dense"][0])
    deep = _port(kw, (32,), depth=4)
    kinds = [hasattr(getattr(deep, f"TransformerBlock_{i}"), "MoEFfn_0")
             for i in range(4)]
    assert kinds == [False, True, False, True]
    one = _port(kw, (32,), depth=1)
    assert hasattr(one.TransformerBlock_0, "MoEFfn_0")
    plain = _port(dict(kw, name="bert"), (32,))
    assert not any(isinstance(m, MoEFfn) for m in plain.modules())


def test_conv_families_keep_channels_last_weights():
    for name in ("cnn", "resnet18"):
        kw, _, shape = FAMILIES[name]
        convs = [m for m in _port(kw, shape).modules()
                 if isinstance(m, torch.nn.Conv2d)]
        assert convs and all(m.weight.is_contiguous(
            memory_format=torch.channels_last) for m in convs)


@pytest.mark.parametrize("name", ["mlp", "cnn", "resnet18", "tcn", "vit_b16"])
def test_non_text_families_need_their_input_shape(name):
    with pytest.raises(ValueError, match="input_shape"):
        registry.build_model(ModelConfig(name=name, width=8, depth=1,
                                         num_heads=2, hidden_dim=8), "cpu")


def test_conv_families_build_at_benchmark_width():
    """Configs #1-#3 and the TCN config build at their full widths on the
    CPU (no forward), with the parameter counts their layers imply."""
    from colearn_federated_learning_tpu_torch.data.registry import SPECS
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    counts = {}
    for cfg_name in ("mnist_mlp_fedavg", "cifar10_cnn_fedavg",
                     "cifar100_resnet18_fedprox", "iot_traffic_tcn_fedavg"):
        cfg = get_config(cfg_name)
        model = registry.build_model(
            cfg.model, "cpu", input_shape=SPECS[cfg.data.dataset].input_shape)
        counts[cfg_name] = sum(p.numel() for p in model.parameters())
    assert counts["mnist_mlp_fedavg"] == (784 * 200 + 200 + 200 * 200 + 200
                                          + 200 * 10 + 10)
    assert 11.1e6 < counts["cifar100_resnet18_fedprox"] < 11.3e6
    assert 1.1e6 < counts["cifar10_cnn_fedavg"] < 1.2e6
    assert counts["iot_traffic_tcn_fedavg"] > 0
