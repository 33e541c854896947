"""The flash-attention CUDA kernels (K1-K3) against their plain PyTorch
versions, on the card.  Marked ``cuda``: without a CUDA device every test
here skips.  On a machine with the card (no JAX needed):

    python -m pytest tests/test_torch_port_cuda.py --noconftest -p no:cacheprovider -q

Inputs are bf16, the only dtype the kernels take.  Tolerance: both sides
sum in f32 and round to bf16 at the same points, so they differ only where
a different summation order flips a rounding; outputs are held to 2e-2 of
the largest reference magnitude, the lse to 1e-4 of it.
"""

import pytest
import torch

from colearn_federated_learning_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _inputs(device, B, L, H, D, dtype, mask_kind, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(B, L, H, D, generator=g).to(dtype).to(device)
                     for _ in range(4))
    lengths = torch.randint(L // 4, L + 1, (B,), generator=g)
    mask = torch.arange(L)[None, :] < lengths[:, None]
    if mask_kind == "row":
        mask[0] = False
    elif mask_kind == "lead":
        mask[0, :3] = False
    return q, k, v, dout, mask.to(device)


def _close(got, ref, tol):
    got, ref = got.detach().float(), ref.detach().float()
    assert torch.isfinite(got).all()
    bound = tol * float(ref.abs().max())
    err = float((got - ref).abs().max())
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("B,L,H,D,causal,mask_kind", [
    (16, 128, 12, 64, False, "pad"),
    (4, 100, 4, 64, False, "pad"),
    (4, 128, 4, 64, True, "lead"),
    (3, 96, 2, 64, False, "row"),
    (2, 70, 2, 32, True, "pad"),
])
def test_kernels_match_plain(cuda, B, L, H, D, causal, mask_kind):
    tol = 2e-2
    q, k, v, dout, mask = _inputs(cuda, B, L, H, D, torch.bfloat16,
                                  mask_kind)
    bias = A.key_bias(mask, B, L, cuda)
    o_ref, lse_ref = A.flash_forward_reference(q, k, v, bias, causal)
    before = dict(A.launches)
    o, lse = A.flash_forward(q, k, v, bias, causal)
    _close(o, o_ref, tol)
    assert torch.equal(lse >= 1e29, lse_ref >= 1e29)
    fin = lse_ref < 1e29
    _close(lse[fin], lse_ref[fin], 1e-4)
    delta = (dout.float() * o_ref.float()).sum(-1)
    dq = A.flash_backward_dq(q, k, v, bias, dout, lse_ref, delta, causal)
    _close(dq, A.flash_backward_dq_reference(q, k, v, bias, dout, lse_ref,
                                             delta, causal), tol)
    dk, dv = A.flash_backward_dkv(q, k, v, bias, dout, lse_ref, delta, causal)
    dk_ref, dv_ref = A.flash_backward_dkv_reference(q, k, v, bias, dout,
                                                    lse_ref, delta, causal)
    _close(dk, dk_ref, tol)
    _close(dv, dv_ref, tol)
    torch.cuda.synchronize()
    assert all(A.launches[n] == before[n] + 1 for n in A.launches)
    if mask_kind == "row":
        assert float(o[0].float().abs().max()) == 0.0


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


def test_wrapper_rejects_unsupported_head_dim(cuda):
    q = torch.zeros(1, 8, 1, 24, device=cuda, dtype=torch.bfloat16)
    bias = torch.zeros(1, 8, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_forward(q, q, q, bias)
