"""Flash attention: three hand-written CUDA kernels and their plain twins.

The kernels (``csrc/flash_attention_kernels.cuh``) replace the JAX
package's Pallas kernels in ``ops/attention.py``:

- K1 ``flash_forward``       (``_flash_kernel``): O and the per-row lse;
- K2 ``flash_backward_dq``   (``_flash_dq_kernel``): dQ;
- K3 ``flash_backward_dkv``  (``_flash_dkv_kernel``): dK and dV.

Each wrapper runs its plain PyTorch version when the tensors lie on the
CPU, and launches its kernel for CUDA tensors or raises — there is no
fallback from one to the other.  ``launches`` counts kernel launches per
wrapper.  :class:`FlashAttention` ties the three together for autograd
(the counterpart of the JAX ``_flash`` custom_vjp); Δ = rowsum(dO ⊙ O)
stays a plain torch op, as it is plain XLA in the reference.

Tensors keep the JAX layout: q, k, v and O are (B, L, H, D); lse and Δ
are (B, Lq, H) float32; the key bias is (B, Lk) float32 with 0 for a valid
key and -1e30 for a masked one.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG = -1e30
_MASKED_BELOW = 0.5 * NEG
_HEAD_DIMS = (16, 32, 64, 128)

launches = {"flash_forward": 0, "flash_backward_dq": 0,
            "flash_backward_dkv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def key_bias(kv_mask: Optional[torch.Tensor], batch: int, lk: int,
             device) -> torch.Tensor:
    """(B, Lk) float32 additive key bias: 0 valid, -1e30 masked."""
    if kv_mask is None:
        return torch.zeros(batch, lk, dtype=torch.float32, device=device)
    return torch.where(kv_mask, 0.0, NEG).to(torch.float32).contiguous()


# ------------------------------------------------------------------ plain
def dense_attention(q, k, v, kv_mask=None, *, causal: bool = False):
    """Single-device reference attention over (B, L, H, D) tensors — the
    semantics of the JAX package's ``parallel/ring.dense_attention``:
    f32 logits and softmax, fully masked query rows return 0."""
    lq, lk = q.shape[1], k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (
        q.shape[-1] ** 0.5)
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, :], logits, NEG)
    if causal:
        keep = _causal_keep(lq, lk, q.device)
        logits = torch.where(keep, logits, NEG)
    p = torch.softmax(logits, dim=-1)
    if kv_mask is not None:
        p = p * kv_mask.any(dim=-1)[:, None, None, None]
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def _causal_keep(lq: int, lk: int, device) -> torch.Tensor:
    qp = torch.arange(lq, device=device)[:, None]
    kp = torch.arange(lk, device=device)[None, :]
    return qp >= kp


def _scores(q, k, bias, causal):
    """(B, H, Lq, Lk) f32 scores s·scale + bias, causal entries at -1e30."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s + bias[:, None, None, :]
    if causal:
        s = torch.where(_causal_keep(q.shape[1], k.shape[1], q.device), s, NEG)
    return s


def flash_forward_reference(q, k, v, bias, causal: bool = False):
    """Plain version of K1: (O, lse) with the kernel's rounding points
    (p rounded to the operand type before p·V, all sums in f32)."""
    s = _scores(q, k, bias, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > _MASKED_BELOW, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).float(), v.float())
    o = (acc / l.clamp_min(1e-20)).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), -NEG)
    return (o.permute(0, 2, 1, 3).contiguous(),
            lse[..., 0].permute(0, 2, 1).contiguous())


def _probs_and_ds(q, k, v, bias, dout, lse, delta, causal):
    s = _scores(q, k, bias, causal)
    lse_b = lse.permute(0, 2, 1)[..., None]                  # (B, H, Lq, 1)
    p = torch.where(s > _MASKED_BELOW, torch.exp(s - lse_b), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    ds = p * (dp - delta.permute(0, 2, 1)[..., None])
    return p, ds.to(q.dtype).float()


def flash_backward_dq_reference(q, k, v, bias, dout, lse, delta,
                                causal: bool = False):
    """Plain version of K2: dQ = scale · Σ_k ds·K."""
    _, ds = _probs_and_ds(q, k, v, bias, dout, lse, delta, causal)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(q.dtype)


def flash_backward_dkv_reference(q, k, v, bias, dout, lse, delta,
                                 causal: bool = False):
    """Plain version of K3: dV = Σ_q pᵀ·dO, dK = scale · Σ_q dsᵀ·q."""
    p, ds = _probs_and_ds(q, k, v, bias, dout, lse, delta, causal)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ kernels
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from colearn_federated_learning_tpu_torch.ops import _build

        lib = _build.load("flash_attention")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        dims = [I, I, I, I, I, F, I, P]         # B Lq Lk H D scale causal stream
        lib.fa_forward.argtypes = [P] * 6 + dims
        lib.fa_backward_dq.argtypes = [P] * 8 + dims
        lib.fa_backward_dkv.argtypes = [P] * 9 + dims
        for fn in (lib.fa_forward, lib.fa_backward_dq, lib.fa_backward_dkv):
            fn.restype = I
        _LIB = lib
    return _LIB


def _check(q, k, v, bias, dout=None, lse=None, delta=None):
    """Raise on anything the kernels do not take; return (B, Lq, Lk, H, D)."""
    tensors = [t for t in (q, k, v, bias, dout, lse, delta) if t is not None]
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(
            "flash attention kernels take CUDA tensors (CPU tensors use the "
            f"plain version); got {[str(t.device) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash attention operands lie on different devices")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"unsupported dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         "the kernels take bfloat16 (CPU tensors of any "
                         "dtype use the plain version)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash attention kernels need contiguous tensors")
    B, lq, H, D = q.shape
    lk = k.shape[1]
    if k.shape != (B, lk, H, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_HEAD_DIMS}")
    if bias.shape != (B, lk) or bias.dtype != torch.float32:
        raise ValueError("key bias must be (B, Lk) float32")
    if dout is not None and (dout.shape != q.shape or dout.dtype != q.dtype):
        raise ValueError("dout must match q in shape and dtype")
    for row in (lse, delta):
        if row is not None and (row.shape != (B, lq, H)
                                or row.dtype != torch.float32):
            raise ValueError("lse and delta must be (B, Lq, H) float32")
    return B, lq, lk, H, D


def _launch(fn, name, pointers, q, dims, causal):
    B, lq, lk, H, D = dims
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*[t.data_ptr() for t in pointers], B, lq, lk, H, D,
                 1.0 / math.sqrt(D), int(causal), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1


def flash_forward(q, k, v, bias, causal: bool = False):
    """K1: (O, lse) for (B, L, H, D) q/k/v and a (B, Lk) key bias."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, bias, causal)
    dims = _check(q, k, v, bias)
    B, lq, _, H, _ = dims
    o = torch.empty_like(q)
    lse = torch.empty(B, lq, H, dtype=torch.float32, device=q.device)
    _launch(_lib().fa_forward, "flash_forward", (q, k, v, bias, o, lse),
            q, dims, causal)
    return o, lse


def flash_backward_dq(q, k, v, bias, dout, lse, delta, causal: bool = False):
    """K2: dQ from the saved lse and Δ = rowsum(dO ⊙ O)."""
    if q.device.type == "cpu":
        return flash_backward_dq_reference(q, k, v, bias, dout, lse, delta,
                                           causal)
    dims = _check(q, k, v, bias, dout, lse, delta)
    dq = torch.empty_like(q)
    _launch(_lib().fa_backward_dq, "flash_backward_dq",
            (q, k, v, bias, dout, lse, delta, dq), q, dims, causal)
    return dq


def flash_backward_dkv(q, k, v, bias, dout, lse, delta,
                       causal: bool = False):
    """K3: (dK, dV) from the saved lse and Δ."""
    if q.device.type == "cpu":
        return flash_backward_dkv_reference(q, k, v, bias, dout, lse, delta,
                                            causal)
    dims = _check(q, k, v, bias, dout, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch(_lib().fa_backward_dkv, "flash_backward_dkv",
            (q, k, v, bias, dout, lse, delta, dk, dv), q, dims, causal)
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """K1 forward, K2 + K3 backward: the (L, L) probabilities are never
    stored; the backward recomputes them tile by tile from the lse."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal):
        o, lse = flash_forward(q, k, v, bias, causal)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * o.float()).sum(dim=-1)       # (B, Lq, H)
        dq = flash_backward_dq(q, k, v, bias, dout, lse, delta, ctx.causal)
        dk, dv = flash_backward_dkv(q, k, v, bias, dout, lse, delta,
                                    ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, kv_mask=None, *, causal: bool = False):
    """Blockwise (flash) attention over ``(B, L, H, D)`` tensors.

    ``kv_mask``: optional ``(B, L_k)`` bool, False = padding key.  Fully
    masked query rows return 0, matching :func:`dense_attention`.
    """
    bias = key_bias(kv_mask, q.shape[0], k.shape[1], q.device)
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), bias, causal)
