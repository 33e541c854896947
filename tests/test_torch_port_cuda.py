"""The flash-attention CUDA kernels (K1-K3) against their plain PyTorch
versions, and every model family's bf16 logits against the same model in
f32 on the CPU, on the card.  Marked ``cuda``: without a CUDA device every
test here skips.  On a machine with the card (no JAX needed):

    python -m pytest tests/test_torch_port_cuda.py --noconftest -p no:cacheprovider -q

Inputs are bf16, the only dtype the kernels take.  Tolerance: both sides
sum in f32 and round to bf16 at the same points, so they differ only where
a different summation order flips a rounding; outputs are held to 2e-2 of
the largest reference magnitude, the lse to 1e-4 of it.  A family's bf16
logits on the card are held to the f32 truth (the same params in f32 on
the CPU): their error may be at most twice that of the same bf16 model on
the CPU plus one bf16 step at the largest magnitude, since cuDNN, cuBLAS
and the kernels round in other places than the CPU's plain ops.
"""

import dataclasses

import pytest
import torch

from colearn_federated_learning_tpu_torch.models import registry
from colearn_federated_learning_tpu_torch.ops import attention as A
from colearn_federated_learning_tpu_torch.utils.config import ModelConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _inputs(device, B, L, H, D, dtype, mask_kind, seed=0, lk=None):
    """q and dO of length L, k and v of length ``lk`` (default L), and a
    (B, lk) key mask."""
    lk = L if lk is None else lk
    g = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(B, n, H, D, generator=g).to(dtype).to(device)
                     for n in (L, lk, lk, L))
    lengths = torch.randint(max(1, lk // 4), lk + 1, (B,), generator=g)
    mask = torch.arange(lk)[None, :] < lengths[:, None]
    if mask_kind == "row":
        mask[0] = False
    elif mask_kind == "lead":
        mask[0, :3] = False
    elif mask_kind == "none":
        mask[:] = True
    return q, k, v, dout, mask.to(device)


def _close(got, ref, tol, atol=0.0):
    got, ref = got.detach().float(), ref.detach().float()
    assert torch.isfinite(got).all()
    bound = max(tol * float(ref.abs().max()), atol)
    err = float((got - ref).abs().max())
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("B,L,Lk,H,D,causal,mask_kind", [
    (16, 128, 128, 12, 64, False, "pad"),
    (4, 100, 100, 4, 64, False, "pad"),
    (4, 128, 128, 4, 64, True, "lead"),
    (3, 96, 96, 2, 64, False, "row"),
    (2, 70, 70, 2, 32, True, "pad"),
    # The head dims of the other instantiations.
    (2, 128, 128, 3, 16, False, "pad"),
    (2, 128, 128, 3, 32, False, "pad"),
    (2, 128, 128, 3, 128, False, "pad"),
    (2, 130, 130, 2, 128, True, "pad"),
    # One row, a partial row group past one tile, a ragged second tile.
    (3, 1, 1, 2, 64, False, "none"),
    (3, 1, 65, 2, 64, False, "pad"),
    (3, 65, 65, 2, 64, False, "pad"),
    (3, 130, 130, 2, 64, False, "row"),
    # Lq != Lk both ways, with and without causal masking.
    (2, 70, 200, 2, 64, False, "pad"),
    (2, 200, 70, 2, 64, False, "pad"),
    (2, 70, 200, 2, 64, True, "none"),
    (2, 200, 70, 2, 32, True, "none"),
    # Causal with ragged L.
    (2, 193, 193, 2, 64, True, "lead"),
    # The evaluation batch.
    (64, 128, 128, 12, 64, False, "pad"),
    # The training grid at the D = 128 instantiation (its own register
    # budget and occupancy).
    (16, 128, 128, 12, 128, True, "pad"),
    # ViT-B/16 on FEMNIST: 49 patches + the class token, no key mask, at
    # the training batch and the evaluation batch.
    (16, 50, 50, 12, 64, False, "none"),
    (64, 50, 50, 12, 64, False, "none"),
])
def test_kernels_match_plain(cuda, B, L, Lk, H, D, causal, mask_kind):
    tol = 2e-2
    q, k, v, dout, mask = _inputs(cuda, B, L, H, D, torch.bfloat16,
                                  mask_kind, lk=Lk)
    bias = A.key_bias(mask, B, Lk, cuda)
    o_ref, lse_ref = A.flash_forward_reference(q, k, v, bias, causal)
    before = dict(A.launches)
    o, lse = A.flash_forward(q, k, v, bias, causal)
    _close(o, o_ref, tol)
    assert torch.equal(lse >= 1e29, lse_ref >= 1e29)
    fin = lse_ref < 1e29
    _close(lse[fin], lse_ref[fin], 1e-4)
    delta = (dout.float() * o_ref.float()).sum(-1)
    # With a single key the softmax is constant, so dQ and dK are 0 up to
    # the f32 rounding of dp - delta (|dO| |V| x 2^-24 x D): an absolute
    # bound, as a relative one has nothing to scale with.
    atol = 1e-5 if Lk == 1 else 0.0
    dq = A.flash_backward_dq(q, k, v, bias, dout, lse_ref, delta, causal)
    _close(dq, A.flash_backward_dq_reference(q, k, v, bias, dout, lse_ref,
                                             delta, causal), tol, atol)
    dk, dv = A.flash_backward_dkv(q, k, v, bias, dout, lse_ref, delta, causal)
    dk_ref, dv_ref = A.flash_backward_dkv_reference(q, k, v, bias, dout,
                                                    lse_ref, delta, causal)
    _close(dk, dk_ref, tol, atol)
    _close(dv, dv_ref, tol)
    torch.cuda.synchronize()
    assert all(A.launches[n] == before[n] + 1 for n in A.launches)
    if mask_kind == "row":
        assert float(o[0].float().abs().max()) == 0.0


@pytest.mark.parametrize("kernel", ["flash_backward_dq",
                                    "flash_backward_dkv"])
def test_dkv_is_bitwise_repeatable(cuda, kernel):
    """Each dQ (K2) and dK/dV (K3) tile has one owner block and no atomics:
    two launches on the same input give the same bits."""
    q, k, v, dout, mask = _inputs(cuda, 16, 128, 12, 64, torch.bfloat16,
                                  "pad", seed=3)
    bias = A.key_bias(mask, 16, 128, cuda)
    o, lse = A.flash_forward(q, k, v, bias)
    delta = (dout.float() * o.float()).sum(-1)
    fn = getattr(A, kernel)
    first = fn(q, k, v, bias, dout, lse, delta)
    second = fn(q, k, v, bias, dout, lse, delta)
    torch.cuda.synchronize()
    if kernel == "flash_backward_dq":
        first, second = (first,), (second,)
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_autograd_matches_dense(cuda):
    q, k, v, dout, mask = _inputs(cuda, 2, 48, 2, 32, torch.bfloat16, "pad",
                                  1)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = A.flash_attention(*ins, mask)
    grads = torch.autograd.grad(out, ins, dout)
    ref_ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = A.dense_attention(*ref_ins, mask)
    ref_grads = torch.autograd.grad(ref, ref_ins, dout)
    _close(out, ref, 2e-2)
    for g, r in zip(grads, ref_grads):
        _close(g, r, 2e-2)


def test_wrapper_rejects_float32_cuda_tensors(cuda):
    q = torch.zeros(1, 8, 1, 32, device=cuda)
    bias = torch.zeros(1, 8, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        A.flash_forward(q, q, q, bias)


def test_wrapper_rejects_misaligned_operands(cuda):
    buf = torch.zeros(1 * 8 * 1 * 32 + 1, device=cuda, dtype=torch.bfloat16)
    q = buf[1:].view(1, 8, 1, 32)              # contiguous, 2 bytes off
    bias = torch.zeros(1, 8, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        A.flash_forward(q, q, q, bias)


def test_wrapper_rejects_unsupported_head_dim(cuda):
    q = torch.zeros(1, 8, 1, 24, device=cuda, dtype=torch.bfloat16)
    bias = torch.zeros(1, 8, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_forward(q, q, q, bias)


# name -> (ModelConfig fields, per-example input shape)
FAMILIES = {
    "mlp": (dict(name="mlp", num_classes=10, hidden_dim=64), (28, 28, 1)),
    "cnn": (dict(name="cnn", num_classes=10, width=16), (32, 32, 3)),
    "cnn_s2d_nonorm": (dict(name="cnn", num_classes=10, width=16,
                            stem="space_to_depth", norm="none"), (32, 32, 3)),
    "resnet18": (dict(name="resnet18", num_classes=10, width=16),
                 (32, 32, 3)),
    "tcn": (dict(name="tcn", num_classes=8, width=16, depth=3), (64, 16)),
    "vit_flash": (dict(name="vit_b16", num_classes=10, width=128, depth=2,
                       num_heads=4, attn_impl="flash"), (28, 28, 1)),
    "moe_bert_flash": (dict(name="moe_bert", num_classes=4, width=128,
                            depth=2, num_heads=4, seq_len=64,
                            vocab_size=1000, num_experts=4,
                            attn_impl="flash"), (64,)),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_bf16_logits_on_card_match_f32(cuda, name):
    kw, shape = FAMILIES[name]
    g = torch.Generator().manual_seed(0)
    if kw["name"] == "moe_bert":
        x = torch.randint(1, 1000, (8,) + shape, generator=g)
        x[:, 48:] = 0
        x[3] = 0                                # an all-padding example
    else:
        x = torch.randn((8,) + shape, generator=g)
    cfg = ModelConfig(**kw)
    f32 = registry.build_model(cfg, "cpu", generator=torch.Generator()
                               .manual_seed(1), input_shape=shape)
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    plain = registry.build_model(bf16, "cpu", input_shape=shape)
    card = registry.build_model(bf16, cuda, input_shape=shape)
    plain.load_state_dict(f32.state_dict())
    card.load_state_dict(f32.state_dict())
    before = dict(A.launches)
    with torch.no_grad():
        truth, ref = f32(x), plain(x)
        got = card(x.to(cuda)).cpu()
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    err = float((got - truth).abs().max())
    bound = (2.0 * float((ref - truth).abs().max())
             + 2.0 ** -8 * float(truth.abs().max()))
    assert err <= bound, (err, bound)
    flash = kw.get("attn_impl") == "flash"
    assert (A.launches["flash_forward"] > before["flash_forward"]) == flash
