"""Ring attention: sequence parallelism over a mesh axis.

The counterpart of the JAX package's ``parallel/ring.py``.  Each rank of
the ``seq`` group holds one contiguous block of the sequence; K/V blocks
rotate around the ring (``collectives.ring_shift``, point-to-point)
while each rank keeps its Q block, and the softmax is accumulated online
(running max ``m``, normaliser ``l`` and weighted-value accumulator
``acc`` in f32), the flash-attention recurrence applied across ranks.
The JAX package computes this with einsums outside any Pallas kernel, so
here it is torch ops, differentiated by autograd (the ring shift's
backward sends the gradient the other way round).

Conventions, as in JAX: the additive mask value is −1e30 (``_NEG``, so
exp() is exactly 0), fully masked query rows come out as 0, causal
masking is by GLOBAL position, and the rotation leads each step, so the
last step pays no discarded transfer.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from colearn_federated_learning_tpu_torch.ops.attention import (  # noqa: F401
    dense_attention,
)
from colearn_federated_learning_tpu_torch.parallel import collectives

_NEG = -1e30


def _block_attn(q, k, v, bias, m, l, acc, scale):
    """One blockwise online-softmax update.  q: (B, Lq, H, D) f32,
    k/v: (B, Lk, H, D), bias: (B, 1|H, Lq, Lk) additive or None; carries
    m, l: (B, H, Lq) and acc: (B, Lq, H, D), all f32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k.float()) * scale
    if bias is not None:
        logits = logits + bias
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    # Fully masked blocks: m_new sits at the _NEG floor, so exp(0) = 1 for
    # masked entries; force those to 0 so padding never contributes.
    p = torch.where(logits > 0.5 * _NEG, p, 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    acc_new = acc * corr.transpose(1, 2)[..., None] + pv
    return m_new, l_new, acc_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: Optional[torch.Tensor] = None, *, group,
                   causal: bool = False) -> torch.Tensor:
    """Attention with the sequence axis sharded over the ranks of
    ``group``, laid out in rank order.

    q, k, v: local blocks (B, L_local, H, D); kv_mask: optional
    (B, L_local) bool, False = padding key; ``causal`` masks by global
    position.  Returns the local output block (B, L_local, H, D) in q's
    dtype; fully masked query rows return 0.
    """
    s = dist.get_world_size(group)
    my = collectives.group_rank(group)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    scale = 1.0 / (D ** 0.5)
    qf = q.float()
    dev = q.device
    q_pos = my * Lq + torch.arange(Lq, device=dev) if causal else None

    def attend(i, m, l, acc, kv, mask_blk):
        # After i rotations this rank holds the block of rank (my − i).
        src = (my - i) % s
        bias = None
        if mask_blk is not None:
            bias = torch.where(mask_blk.bool(), 0.0, _NEG)[:, None, None, :]
        if causal:
            k_pos = src * Lk + torch.arange(Lk, device=dev)
            cbias = (~(q_pos[:, None] >= k_pos[None, :])).float() * _NEG
            bias = cbias[None, None] if bias is None else bias + cbias
        return _block_attn(qf, kv[0], kv[1], bias, m, l, acc, scale)

    m = torch.full((B, H, Lq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Lq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Lq, H, D), dtype=torch.float32, device=dev)
    kv = torch.stack([k, v])                      # one transfer per step
    mask_blk = None if kv_mask is None else kv_mask.to(torch.uint8)
    m, l, acc = attend(0, m, l, acc, kv, mask_blk)          # home block
    for i in range(1, s):
        kv = collectives.ring_shift(kv, group)
        if mask_blk is not None:
            mask_blk = collectives.ring_shift(mask_blk, group)
        m, l, acc = attend(i, m, l, acc, kv, mask_blk)
    out = acc / l.clamp_min(1e-20).transpose(1, 2)[..., None]
    return out.to(q.dtype)
