"""Server-side aggregation strategies.

The server consumes the aggregated mean delta and applies a server step
(the counterpart of the JAX package's ``fed/strategies.py``):

- fedavg / fedprox : w <- w + server_lr · mean_delta
- fednova          : the same server step; the round normalises each
  client's delta by its local-step coefficient and rescales the mean
  (``fed/programs.py``)
- scaffold         : the same server step, and the global control variate
  moves by ``participation · mean_delta_c``
- fedadam / fedyogi: adaptive server optimizers (Reddi et al.)

The server state is updated in place: it holds one copy of the params and
moments, never two.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from colearn_federated_learning_tpu_torch.utils.config import FedConfig

SCHEDULES = ("constant", "cosine", "warmup_cosine")
STRATEGIES = ("fedavg", "fedprox", "fedadam", "fedyogi", "scaffold",
              "fednova")


@dataclasses.dataclass
class ServerState:
    params: dict            # name -> f32 tensor
    opt_m: Optional[dict]   # first moment (fedadam/fedyogi) or None
    opt_v: Optional[dict]   # second moment or None
    control: Optional[dict] = None  # global control variate c (scaffold)
    round_idx: int = 0


def lr_scale_for_round(cfg: FedConfig, round_idx: int) -> Optional[float]:
    """Client-lr factor for ``round_idx``, computed in f32 like the JAX
    package: ``None`` for a constant schedule (no scaling at all); a
    half-cosine from 1 to ``lr_min_fraction`` over the ``rounds`` horizon;
    ``warmup_cosine`` ramps linearly over ``warmup_rounds`` first.
    ``lr_spike_round >= 0`` multiplies that one round's factor by
    ``lr_spike_multiplier``."""
    if cfg.lr_schedule not in SCHEDULES:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}; "
                         f"use one of {SCHEDULES}")
    f32 = np.float32
    spiked = cfg.lr_spike_round >= 0 and cfg.lr_spike_multiplier != 1.0
    spike = (f32(cfg.lr_spike_multiplier)
             if spiked and round_idx == cfg.lr_spike_round else f32(1.0))
    if cfg.lr_schedule == "constant":
        return float(spike) if spiked else None
    r = f32(round_idx)
    floor = f32(cfg.lr_min_fraction)
    warm = f32(cfg.warmup_rounds if cfg.lr_schedule == "warmup_cosine" else 0)
    horizon = max(f32(cfg.rounds) - warm, f32(1.0))
    prog = np.clip((r - warm) / horizon, f32(0.0), f32(1.0))
    cos = floor + (f32(1.0) - floor) * f32(0.5) * (
        f32(1.0) + np.cos(f32(np.pi) * prog))
    if warm > 0 and r < warm:
        cos = min((r + f32(1.0)) / warm, f32(1.0))
    if spiked:
        cos = cos * spike
    return float(f32(cos))


def init_server_state(params: dict, cfg: FedConfig) -> ServerState:
    adaptive = cfg.strategy in ("fedadam", "fedyogi")

    def zeros():
        return {k: torch.zeros_like(v) for k, v in params.items()}

    return ServerState(params=params, opt_m=zeros() if adaptive else None,
                       opt_v=zeros() if adaptive else None,
                       control=zeros() if cfg.strategy == "scaffold" else None)


@torch.no_grad()
def server_update(state: ServerState, mean_delta: dict, cfg: FedConfig,
                  mean_delta_c: Optional[dict] = None,
                  participation=None) -> ServerState:
    """Apply one server step to the aggregated mean delta, in place.

    ``mean_delta_c`` and ``participation`` (contributors / clients, an f32
    scalar) are SCAFFOLD's: the global variate moves by
    ``participation · mean_delta_c``."""
    names = list(state.params)
    w = [state.params[k] for k in names]
    d = [mean_delta[k] for k in names]
    if cfg.strategy in ("fedavg", "fedprox", "scaffold", "fednova"):
        torch._foreach_add_(w, torch._foreach_mul(d, cfg.server_lr))
        if cfg.strategy == "scaffold" and mean_delta_c is not None:
            frac = 1.0 if participation is None else participation
            c = [state.control[k] for k in names]
            torch._foreach_add_(c, torch._foreach_mul(
                [mean_delta_c[k] for k in names], frac))
    elif cfg.strategy in ("fedadam", "fedyogi"):
        b1, b2, eps = cfg.server_beta1, cfg.server_beta2, cfg.server_eps
        m = [state.opt_m[k] for k in names]
        v = [state.opt_v[k] for k in names]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(d, 1 - b1))
        d2 = torch._foreach_mul(d, d)
        if cfg.strategy == "fedadam":
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, torch._foreach_mul(d2, 1 - b2))
        else:  # fedyogi
            sign = [torch.sign(vi - di) for vi, di in zip(v, d2)]
            torch._foreach_sub_(v, torch._foreach_mul(
                torch._foreach_mul(d2, 1 - b2), sign))
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, eps)
        step = torch._foreach_div(torch._foreach_mul(m, cfg.server_lr), denom)
        torch._foreach_add_(w, step)
    else:
        raise NotImplementedError(f"strategy {cfg.strategy!r} is not ported")
    state.round_idx += 1
    return state
