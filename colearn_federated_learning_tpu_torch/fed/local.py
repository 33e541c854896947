"""Local training: one client's round of optimizer steps.

The counterpart of the JAX package's ``fed/local.py``.  The JAX trainer is
a ``lax.scan`` over a static step count with steps past the client's
``step_budget`` masked to no-ops; here the loop simply stops at the
budget, which leaves params, optimizer state and the loss sum exactly as
the masked steps would.  Optimizer state is built fresh for every client
and round, and the optimizers reproduce optax's update rules (defaults
included) with ``torch._foreach`` ops over the parameter list, updating in
place.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from colearn_federated_learning_tpu_torch.fed import losses


class LocalResult(NamedTuple):
    delta: list            # local params - global params, one f32 tensor per param
    num_examples: int      # true shard size (FedAvg weight)
    completed: bool        # ran >= the minimum required steps
    mean_loss: torch.Tensor  # () f32 over executed steps
    steps_run: float       # executed step count


# optax's defaults for adam / adamw.
ADAM_B1, ADAM_B2, ADAM_EPS, ADAMW_WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4


class Optimizer:
    """optax ``sgd`` (± momentum, no Nesterov), ``adam`` or ``adamw`` with
    optax's defaults, as in-place steps over a list of f32 tensors."""

    def __init__(self, name: str, lr: float, momentum: float = 0.0):
        if name not in ("sgd", "adam", "adamw"):
            raise ValueError(f"unknown local optimizer {name!r} (sgd|adam|adamw)")
        self.name, self.lr, self.momentum = name, lr, momentum

    def init(self, params: list) -> dict:
        if self.name == "sgd":
            if self.momentum > 0:
                return {"trace": [torch.zeros_like(p) for p in params]}
            return {}
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def step(self, params: list, grads: list, state: dict,
             lr_scale: Optional[float] = None) -> None:
        if self.name == "sgd":
            if self.momentum > 0:
                trace = state["trace"]
                torch._foreach_mul_(trace, self.momentum)
                torch._foreach_add_(trace, grads)
                updates = torch._foreach_mul(trace, -self.lr)
            else:
                updates = torch._foreach_mul(grads, -self.lr)
        else:
            mu, nu = state["mu"], state["nu"]
            state["count"] += 1
            t = np.float32(state["count"])
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, grads, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - ADAM_B2)
            bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** t)
            bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** t)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, ADAM_EPS)
            updates = torch._foreach_div(mu, bc1)
            torch._foreach_div_(updates, denom)
            if self.name == "adamw":
                torch._foreach_add_(updates, params, alpha=ADAMW_WEIGHT_DECAY)
            torch._foreach_mul_(updates, -self.lr)
        if lr_scale is not None:
            # Round-level schedule: scaling the update equals running at
            # lr·scale for SGD(+momentum from a zero buffer) and Adam.
            torch._foreach_mul_(updates, lr_scale)
        torch._foreach_add_(params, updates)


def make_optimizer(lr: float, momentum: float, name: str = "sgd") -> Optimizer:
    """Client-side optimizer (see :class:`Optimizer`)."""
    return Optimizer(name, lr, momentum)


def make_local_update(model: torch.nn.Module, optimizer: Optimizer,
                      num_steps: int, prox_mu: float = 0.0,
                      min_steps_fraction: float = 0.25) -> Callable:
    """Build ``local_update(global_params, x, y, count, batch_idx,
    step_budget, lr_scale=None) -> LocalResult``.

    - ``global_params``: list of f32 tensors in ``model.parameters()``
      order; the model's own parameters are overwritten with them and
      trained in place.
    - ``x``, ``y``: the client's padded shard on the model's device;
      ``count`` its true size.
    - ``batch_idx``: (num_steps, batch) integer tensor of example indices in
      [0, count), one row per step (drawn by the caller).
    - Steps at or past ``step_budget`` do not run.
    - With ``prox_mu > 0`` the loss gains FedProx's μ/2 ‖w − w_global‖².
    """
    min_steps = max(1, int(num_steps * min_steps_fraction))
    params = list(model.parameters())

    def loss_fn(global_params, xb, yb):
        loss = losses.softmax_cross_entropy(model(xb), yb)
        if prox_mu > 0.0:
            diffs = torch._foreach_sub(params, global_params)
            sq = torch.stack([(d * d).sum() for d in diffs]).sum()
            loss = loss + 0.5 * prox_mu * sq
        return loss

    def local_update(global_params, x, y, count: int, batch_idx,
                     step_budget: int, lr_scale: Optional[float] = None
                     ) -> LocalResult:
        with torch.no_grad():
            torch._foreach_copy_(params, global_params)
        state = optimizer.init(params)
        executed = min(int(step_budget), num_steps)
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for t in range(executed):
            idx = batch_idx[t]
            loss = loss_fn(global_params, x[idx], y[idx])
            grads = torch.autograd.grad(loss, params)
            optimizer.step(params, grads, state, lr_scale)
            loss_sum += loss.detach()
        with torch.no_grad():
            delta = torch._foreach_sub(params, global_params)
        return LocalResult(
            delta=delta,
            num_examples=int(count),
            completed=int(step_budget) >= min_steps,
            mean_loss=loss_sum / max(float(executed), 1.0),
            steps_run=float(executed),
        )

    return local_update
