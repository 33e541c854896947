"""Mixture-of-experts FFN, the counterpart of the JAX package's
``models/moe.py`` (hosted by ``models/bert.py`` when ``num_experts > 0``).

Capacity-based top-2 routing with renormalised gates: each expert takes
at most C = ceil(K·N·1.25 / E) tokens; positions in an expert's buffer are
counted rank-major (every primary route before any secondary one), so
primary routes win capacity; padding tokens are zeroed before the count,
so they claim no capacity, produce zero output and stay out of the
load-balance statistics.  Dispatch and combine are one-hot einsums in the
compute dtype, the router runs in f32.

flax ``sow``s the Switch load-balance loss E·Σ_e f_e·p_e into
``intermediates``; here each forward leaves it on the module as ``aux``,
and the local trainer (``fed/local.py``) reads it from every MoE layer.

Expert parallelism (``tp``, set by ``parallel/tp.py`` when the banks are
sharded over the model axis): routing runs replicated on every rank
(the router is not sharded), each rank runs its own contiguous block of
experts on their dispatched tokens, and the combine over them is summed
over the model group; the expert input and the combine weights get
their gradients all-reduced, so the router's and everything upstream's
are full on every rank.  Under sequence parallelism each shard routes its
local tokens with local capacity, as in JAX.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from colearn_federated_learning_tpu_torch.models.layers import (
    lecun_normal_,
    linear,
)


TOP_K = 2


class MoEFfn(nn.Module):
    TP_KEY = "experts_up"

    def __init__(self, embed_dim: int, num_experts: int, mlp_ratio: int = 4,
                 capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        E, D, Fh = num_experts, embed_dim, embed_dim * mlp_ratio
        self.num_experts, self.top_k = E, min(TOP_K, E)
        self.capacity_factor, self.dtype = capacity_factor, dtype
        self.router = nn.Linear(D, E)
        self.experts_up = nn.Parameter(torch.zeros(E, D, Fh))
        self.experts_up_bias = nn.Parameter(torch.zeros(E, Fh))
        self.experts_down = nn.Parameter(torch.zeros(E, Fh, D))
        self.experts_down_bias = nn.Parameter(torch.zeros(E, D))
        self.aux = None
        self.tp = None

    @torch.no_grad()
    def reset_experts(self, generator: torch.Generator) -> None:
        """flax lecun-normal over the stacked (E, in, out) banks: the
        leading axis counts as receptive field, so fan-in = in · E."""
        for bank in (self.experts_up, self.experts_down):
            lecun_normal_(bank, bank.shape[0] * bank.shape[1], generator)

    def forward(self, x, token_mask=None):
        """``x``: (B, S, D); ``token_mask``: optional (B, S) bool, False =
        padding."""
        B, S, D = x.shape
        E, K, dt = self.num_experts, self.top_k, self.dtype
        N = B * S
        C = max(1, int(-(-K * N * self.capacity_factor // E)))   # ceil

        xf = x.reshape(N, D)
        probs = torch.softmax(linear(xf, self.router, torch.float32), dim=-1)
        gate_vals, expert_idx = torch.topk(probs, K, dim=-1)      # (N, K)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

        onehot = F.one_hot(expert_idx, E)                         # (N, K, E)
        if token_mask is not None:
            mf = token_mask.reshape(N).float()
            onehot = onehot * token_mask.reshape(N, 1, 1).long()
        else:
            mf = torch.ones(N, device=x.device)

        # Rank-major positions in each expert's buffer.
        flat = onehot.transpose(0, 1).reshape(K * N, E)
        pos_f = torch.cumsum(flat, dim=0) - flat
        pos = (pos_f.reshape(K, N, E).transpose(0, 1) * onehot).sum(-1)  # (N, K)

        # (N, K, E, C); a position past the capacity is the zero row.
        slot = (pos[..., None] == torch.arange(C, device=x.device)).to(dt)
        disp = onehot.to(dt)[..., None] * slot[:, :, None, :]
        combine = (disp * gate_vals[..., None, None].to(dt)).sum(1)  # (N, E, C)
        disp = disp.sum(1)

        up, b_up = self.experts_up.to(dt), self.experts_up_bias.to(dt)
        down, b_down = self.experts_down.to(dt), self.experts_down_bias.to(dt)
        xe = xf
        if self.tp is not None:
            from colearn_federated_learning_tpu_torch.parallel import (
                collectives)

            lo = self.tp.index * up.shape[0]
            xe = collectives.copy_to_group(xf, self.tp.group)
            combine = collectives.copy_to_group(combine, self.tp.group)
            disp = disp[:, lo:lo + up.shape[0]]
            combine = combine[:, lo:lo + up.shape[0]]
        xin = torch.einsum("nec,nd->ecd", disp, xe.to(dt))
        h = F.gelu(torch.einsum("ecd,edf->ecf", xin, up) + b_up[:, None, :],
                   approximate="tanh")
        y = torch.einsum("ecf,efd->ecd", h, down) + b_down[:, None, :]
        out = torch.einsum("nec,ecd->nd", combine, y)
        if self.tp is not None:
            out = collectives.reduce_from_group(out, self.tp.group)

        denom = mf.sum().clamp_min(1.0)
        f_e = onehot[:, 0, :].float().sum(0) / denom
        p_e = (probs * mf[:, None]).sum(0) / denom
        self.aux = E * (f_e * p_e).sum()
        return out.reshape(B, S, D)
