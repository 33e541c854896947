"""Ulysses-style sequence parallelism: all-to-all over attention heads.

The counterpart of the JAX package's ``parallel/ulysses.py``
(DeepSpeed-Ulysses, pattern only): inputs arrive sequence-sharded
(B, L/S, H, D); ONE all-to-all of the stacked q, k and v re-shards them
head-wise to (B, L, H/S, D), so every rank sees the whole sequence for
its head group; plain dense attention runs locally; a second all-to-all
restores the sequence sharding.  It needs ``H % S == 0``; the ring
(``parallel/ring.py``) has no head constraint.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from colearn_federated_learning_tpu_torch.parallel import collectives
from colearn_federated_learning_tpu_torch.parallel.ring import dense_attention


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_mask: Optional[torch.Tensor] = None, *, group,
                      causal: bool = False,
                      axis_name: str = "seq") -> torch.Tensor:
    """Attention with the sequence axis sharded over the ranks of
    ``group`` (of size S, with ``H % S == 0``); arguments and result as
    :func:`parallel.ring.ring_attention`."""
    s = dist.get_world_size(group)
    H = q.shape[2]
    if H % s != 0:
        raise ValueError(
            f"ulysses attention needs heads ({H}) divisible by the "
            f"{axis_name!r} axis size ({s}); use attn_impl='ring' otherwise")
    qkv = torch.stack([q, k, v])                  # (3, B, L/S, H, D)
    qkv = collectives.all_to_all(qkv, group, split_dim=3, concat_dim=2)
    mask_full = None
    if kv_mask is not None:
        gathered = collectives.all_gather(kv_mask.to(torch.uint8)[None],
                                          group)   # (S, B, L/S)
        mask_full = gathered.permute(1, 0, 2).reshape(kv_mask.shape[0],
                                                      -1).bool()
    out = dense_attention(qkv[0], qkv[1], qkv[2], mask_full, causal=causal)
    return collectives.all_to_all(out, group, split_dim=1, concat_dim=2)
