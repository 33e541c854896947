"""The port's flash attention (K1-K3 through their plain versions on the
CPU) and dense attention against the JAX package's: forward output, the
per-row logsumexp, and dq/dk/dv against ``jax.grad``.  The JAX flash
kernel runs in Pallas interpret mode, its default off the TPU.

f32 throughout; tolerance rtol 1e-4, atol 2e-5 (the two sides sum in a
different order, nothing else differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.ops.attention import (
    _flash_impl,
    flash_attention as jax_flash,
)
from colearn_federated_learning_tpu.parallel.ring import (
    dense_attention as jax_dense,
)
from colearn_federated_learning_tpu_torch.ops import attention as A

RTOL, ATOL = 1e-4, 2e-5


def _inputs(B, L, H, D, mask_kind, seed):
    rng = np.random.default_rng(seed)
    q, k, v, ct = (rng.standard_normal((B, L, H, D)).astype(np.float32)
                   for _ in range(4))
    mask = rng.random((B, L)) > 0.25
    if mask_kind == "row":
        mask[0] = False                      # every query row of batch 0
    elif mask_kind == "lead":
        mask[0, :5] = False                  # with causal: rows 0-4 see nothing
    return q, k, v, ct, (None if mask_kind == "none" else mask)


def _torch_run(fn, q, k, v, ct, mask, causal):
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    out = fn(*ins, tmask, causal=causal)
    (out * torch.from_numpy(ct)).sum().backward()
    return [t.detach().numpy() for t in [out] + [i.grad for i in ins]]


def _jax_run(fn, q, k, v, ct, mask):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v) * ct)

    out = fn(q, k, v)
    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(a) for a in (out,) + grads]


CASES = [
    # L, block, causal, mask — L=40 with 16-blocks exercises ragged tiles.
    (40, 16, False, "pad"),
    (40, 16, True, "lead"),
    (40, 16, False, "row"),
    (32, 8, True, "none"),
    (48, 128, False, "pad"),
]


@pytest.mark.parametrize("L,block,causal,mask_kind", CASES)
def test_flash_matches_jax_flash(L, block, causal, mask_kind):
    q, k, v, ct, mask = _inputs(2, L, 2, 8, mask_kind, seed=L + block)
    ours = _torch_run(A.flash_attention, q, k, v, ct, mask, causal)
    ref = _jax_run(lambda q, k, v: jax_flash(q, k, v, mask, causal=causal,
                                             block_q=block, block_k=block),
                   q, k, v, ct, mask)
    for name, a, b in zip(("out", "dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    if mask_kind == "row":
        assert np.all(ours[0][0] == 0.0)


@pytest.mark.parametrize("L,block,causal,mask_kind", CASES)
def test_flash_lse_matches_jax(L, block, causal, mask_kind):
    B, H = 2, 2
    q, k, v, _, mask = _inputs(B, L, H, 8, mask_kind, seed=L + block)
    _, lse = _flash_impl(q, k, v, mask, causal, block, block, None,
                         return_lse=True)
    ref = np.asarray(lse)[:, :L, 0].reshape(B, H, L).transpose(0, 2, 1)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    bias = A.key_bias(None if mask is None else torch.from_numpy(mask),
                      B, L, "cpu")
    _, ours = A.flash_forward(tq, tk, tv, bias, causal)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("L,block,causal,mask_kind", CASES)
def test_dense_matches_jax_dense(L, block, causal, mask_kind):
    q, k, v, ct, mask = _inputs(2, L, 2, 8, mask_kind, seed=3 * L + block)
    ours = _torch_run(A.dense_attention, q, k, v, ct, mask, causal)
    ref = _jax_run(lambda q, k, v: jax_dense(q, k, v, mask, causal=causal),
                   q, k, v, ct, mask)
    for name, a, b in zip(("out", "dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


def test_wrappers_count_only_kernel_launches():
    q, k, v, _, mask = _inputs(1, 16, 1, 8, "pad", seed=0)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    A.reset_launches()
    A.flash_forward(tq, tk, tv, A.key_bias(torch.from_numpy(mask), 1, 16,
                                           "cpu"))
    assert A.launches == {n: 0 for n in A.launches}


def test_wrappers_raise_on_non_cpu_non_cuda_tensors():
    """No fallback: a tensor that is not on the CPU goes to the kernel or
    raises, here for a meta tensor."""
    q = torch.empty(1, 8, 1, 16, device="meta")
    bias = torch.empty(1, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        A.flash_forward(q, q, q, bias)
    with pytest.raises(ValueError, match="CUDA tensors"):
        A.flash_backward_dq(q, q, q, bias, q, bias, bias)
    with pytest.raises(ValueError, match="CUDA tensors"):
        A.flash_backward_dkv(q, q, q, bias, q, bias, bias)
