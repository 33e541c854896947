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
from colearn_federated_learning_tpu_torch.telemetry import get_registry
from colearn_federated_learning_tpu_torch.models.moe import MoEFfn


class LocalResult(NamedTuple):
    delta: list            # local params - global params, one f32 tensor per param
    num_examples: int      # true shard size (FedAvg weight)
    completed: bool        # ran >= the minimum required steps
    mean_loss: torch.Tensor  # () f32 over executed steps
    steps_run: float       # executed step count


class ScaffoldResult(NamedTuple):
    result: LocalResult
    c_new: list            # this client's refreshed control variate
    delta_c: list          # c_new - c_i (the server variate's update)


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


def check_strategy_optimizer(fed) -> None:
    """Refuse optimizer settings a strategy's algebra does not model, with
    the JAX package's messages (its ``fed/setup.py``)."""
    if fed.strategy == "scaffold" and fed.local_optimizer != "sgd":
        raise ValueError(
            "scaffold's option-II variate refresh assumes plain SGD steps; "
            f"local_optimizer={fed.local_optimizer!r} is unsupported")
    if fed.strategy == "fednova" and fed.local_optimizer != "sgd":
        raise ValueError(
            "fednova's step coefficient a_i models SGD(+momentum) "
            f"dynamics; local_optimizer={fed.local_optimizer!r} does not "
            "follow that geometric series and would be mis-normalized")
    if fed.strategy == "scaffold" and fed.momentum != 0.0:
        raise ValueError(
            "scaffold requires momentum=0.0: the option-II control-variate "
            f"refresh is biased under momentum (got momentum={fed.momentum})")


def check_dense_trainer(fed) -> None:
    """The dense trainer's refusal of LoRA, with the JAX package's words:
    the adapters run on the socket plane only (``comm/worker.py``)."""
    if fed.lora_rank < 0:
        raise ValueError(f"lora_rank must be >= 0, got {fed.lora_rank}")
    if fed.lora_rank > 0:
        raise ValueError(
            "lora_rank > 0 requires the socket federation plane "
            "(coordinate/worker); this in-process trainer would ignore "
            "the adapters and train dense")


def fednova_coefficient(steps_run: float, momentum: float) -> np.float32:
    """FedNova's a_i for ``steps_run`` executed steps of SGD at
    ``momentum`` m: ``(τ − m(1 − m^τ)/(1 − m))/(1 − m)``, or τ without
    momentum; τ = max(steps_run, 1).  In f32, as the JAX round computes it
    (the Python-float constants rounded to f32 once)."""
    tau = np.float32(max(steps_run, 1.0))
    if momentum <= 0.0:
        return tau
    m, one_m = np.float32(momentum), np.float32(1.0 - momentum)
    return (tau - m * (np.float32(1.0) - m ** tau) / one_m) / one_m


def make_local_update(model: torch.nn.Module, optimizer: Optimizer,
                      num_steps: int, prox_mu: float = 0.0,
                      min_steps_fraction: float = 0.25,
                      aux_loss_weight: float = 0.0, scaffold: bool = False,
                      lr: float = 0.0, grad_sync_group=None, tp=None,
                      sharded: Optional[list] = None) -> Callable:
    """Build ``local_update(global_params, x, y, count, batch_idx,
    step_budget, lr_scale=None) -> LocalResult``.

    With ``scaffold=True`` the function takes trailing ``(c_i, c)``
    control variates (lists like ``global_params``) and returns a
    :class:`ScaffoldResult` (SCAFFOLD, Karimireddy et al.): every step's
    gradient gains ``c − c_i``, and the client's variate refreshes by
    option II, ``c_i' = c_i − c − delta / (K · lr_eff)`` over the K
    executed steps, where ``lr_eff`` is ``lr`` (the client learning rate)
    times the round's ``lr_scale``.

    - ``global_params``: list of f32 tensors in ``model.parameters()``
      order; the model's own parameters are overwritten with them and
      trained in place.
    - ``x``, ``y``: the client's padded shard on the model's device;
      ``count`` its true size.
    - ``batch_idx``: (num_steps, batch) integer tensor of example indices in
      [0, count), one row per step (drawn by the caller).
    - Steps at or past ``step_budget`` do not run.
    - With ``prox_mu > 0`` the loss gains FedProx's μ/2 ‖w − w_global‖².
    - With ``aux_loss_weight > 0`` it gains that weight times the mean of
      the load-balance losses the model's MoE layers left on themselves
      (the JAX trainer's sown ``moe_aux``).
    - ``grad_sync_group``: the sequence-parallel group the model's
      activations are sharded over.  Every step's grads are averaged over
      it in one flat all-reduce; with the model's ``psum_for_grad_pmean``
      pooling that is the exact full-sequence gradient on every shard, so
      the params stay replicated through local training.
    - ``tp`` (a ``parallel.mesh.Axis``) and ``sharded`` (one bool per
      parameter): under tensor parallelism the prox term's sum over the
      sharded slices is summed over the model group, so it counts every
      entry once.
    """
    if scaffold and lr <= 0.0:
        raise ValueError("scaffold=True requires the client lr")
    min_steps = max(1, int(num_steps * min_steps_fraction))
    reg = get_registry()
    reg.counter("local.trainers_built").inc()
    reg.gauge("local.steps_per_round").set(num_steps)
    params = list(model.parameters())
    moe_layers = [m for m in model.modules() if isinstance(m, MoEFfn)]

    def loss_fn(global_params, xb, yb):
        loss = losses.softmax_cross_entropy(model(xb), yb)
        if aux_loss_weight > 0.0 and moe_layers:
            aux = sum(m.aux for m in moe_layers) / len(moe_layers)
            loss = loss + aux_loss_weight * aux
        if prox_mu > 0.0:
            diffs = torch._foreach_sub(params, global_params)
            sqs = [(d * d).sum() for d in diffs]
            if tp is None:
                sq = torch.stack(sqs).sum()
            else:
                from colearn_federated_learning_tpu_torch.parallel import (
                    collectives)

                rep = sum(q for q, s in zip(sqs, sharded) if not s)
                shd = sum(q for q, s in zip(sqs, sharded) if s)
                sq = rep + collectives.reduce_from_group(shd, tp.group)
            loss = loss + 0.5 * prox_mu * sq
        return loss

    def run_steps(global_params, x, y, count, batch_idx, step_budget,
                  lr_scale, correction) -> LocalResult:
        with torch.no_grad():
            torch._foreach_copy_(params, global_params)
        state = optimizer.init(params)
        executed = min(int(step_budget), num_steps)
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for t in range(executed):
            idx = batch_idx[t]
            loss = loss_fn(global_params, x[idx], y[idx])
            grads = torch.autograd.grad(loss, params)
            if grad_sync_group is not None:
                from colearn_federated_learning_tpu_torch.parallel import (
                    collectives)

                grads = collectives.mean_grads(grads, grad_sync_group)
            if correction is not None:
                grads = torch._foreach_add(grads, correction)
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

    if not scaffold:
        def local_update(global_params, x, y, count: int, batch_idx,
                         step_budget: int, lr_scale: Optional[float] = None
                         ) -> LocalResult:
            return run_steps(global_params, x, y, count, batch_idx,
                             step_budget, lr_scale, None)

        return local_update

    @torch.no_grad()
    def refresh(result: LocalResult, c_i, c, lr_scale) -> ScaffoldResult:
        # lr_eff folds in the round's schedule factor (f32, as in JAX); it
        # is clamped so a zero-floor cosine past its horizon, where delta
        # is exactly 0, refreshes to 0 and not to 0 · inf = NaN.
        f32 = np.float32
        lr_eff = f32(lr) if lr_scale is None else f32(lr) * f32(lr_scale)
        scale = f32(1.0) / (max(f32(result.steps_run), f32(1.0))
                            * max(lr_eff, f32(1e-12)))
        c_new = torch._foreach_sub(c_i, c)
        torch._foreach_add_(c_new, torch._foreach_mul(result.delta,
                                                      float(-scale)))
        return ScaffoldResult(result=result, c_new=c_new,
                              delta_c=torch._foreach_sub(c_new, c_i))

    def scaffold_update(global_params, x, y, count: int, batch_idx,
                        step_budget: int, c_i, c,
                        lr_scale: Optional[float] = None) -> ScaffoldResult:
        correction = torch._foreach_sub(c, c_i)      # grads − c_i + c
        result = run_steps(global_params, x, y, count, batch_idx,
                           step_budget, lr_scale, correction)
        return refresh(result, c_i, c, lr_scale)

    return scaffold_update


def make_lora_local_update(model: torch.nn.Module, optimizer: Optimizer,
                           num_steps: int, rank: int, alpha: float,
                           num_heads: Optional[int] = None,
                           prox_mu: float = 0.0,
                           min_steps_fraction: float = 0.25,
                           aux_loss_weight: float = 0.0) -> Callable:
    """Build ``lora_update(base_params, factors, x, y, count, batch_idx,
    step_budget, lr_scale=None) -> LocalResult``: the factor-only twin of
    :func:`make_local_update` (the JAX package's
    ``make_lora_local_update``).

    - ``base_params``: the frozen base, f32 tensors in
      ``model.parameters()`` order, copied into the model, which gets no
      gradient.
    - ``factors``: the received factor tree (``fed/lora.py``, flax
      layout).  Every step adds ``(α/r)·reshape(B @ A)`` to each adapted
      weight, maps it to the port's layout with ``convert.leaf_to_torch``
      and runs the model through ``torch.func.functional_call``; the
      gradient is taken with respect to the factors only.
    - The optimizer starts afresh on the factors at every call; FedProx's
      pull (``prox_mu``) acts on the factors; the MoE auxiliary term, the
      ``step_budget`` cut and ``lr_scale`` are :func:`make_local_update`'s.
    - The result's ``delta`` is the trained factors minus the received
      ones, one f32 tensor per factor leaf in the tree's sorted-key order
      (A before B at each adapted leaf).
    """
    from torch.func import functional_call

    from colearn_federated_learning_tpu_torch import convert
    from colearn_federated_learning_tpu_torch.fed import lora
    from colearn_federated_learning_tpu_torch.utils import trees

    min_steps = max(1, int(num_steps * min_steps_fraction))
    reg = get_registry()
    reg.counter("local.trainers_built").inc()
    reg.gauge("local.steps_per_round").set(num_steps)
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(False)         # the base is frozen
    named = dict(model.named_parameters())
    flax_shape = {}                     # flax path -> its leaf's flax shape
    for name, p in named.items():
        path, fshape, _ = convert.flax_layout(name, tuple(p.shape), num_heads)
        flax_shape["/".join(path)] = fshape
    moe_layers = [m for m in model.modules() if isinstance(m, MoEFfn)]

    def targets_of(factors) -> list:
        """(flax path, flax shape, index of A, index of B) per adapted leaf,
        the indices into ``trees.leaves(factors)``."""
        order = {"/".join(p): i for i, (p, _) in
                 enumerate(lora._leaves_with_path(factors))}
        out = []
        for path in sorted(lora.factor_index(factors)):
            if path not in flax_shape:
                raise ValueError(f"factor {path!r} adapts no model weight")
            out.append((tuple(path.split("/")), flax_shape[path],
                        order[f"{path}/{lora.A_KEY}"],
                        order[f"{path}/{lora.B_KEY}"]))
        return out

    def loss_fn(f, f_global, targets, xb, yb):
        eff = {}
        for path, fshape, ia, ib in targets:
            delta = lora.adapter_delta(f[ia], f[ib], fshape, alpha, rank)
            name, delta = convert.leaf_to_torch(path, delta)
            eff[name] = lora.adapt_leaf(named[name], delta)
        loss = losses.softmax_cross_entropy(
            functional_call(model, eff, (xb,)), yb)
        if aux_loss_weight > 0.0 and moe_layers:
            aux = sum(m.aux for m in moe_layers) / len(moe_layers)
            loss = loss + aux_loss_weight * aux
        if prox_mu > 0.0:
            diffs = torch._foreach_sub(f, f_global)
            sq = torch.stack([(d * d).sum() for d in diffs]).sum()
            loss = loss + 0.5 * prox_mu * sq
        return loss

    def lora_update(base_params, factors, x, y, count: int, batch_idx,
                    step_budget: int, lr_scale: Optional[float] = None
                    ) -> LocalResult:
        with torch.no_grad():
            torch._foreach_copy_(params, base_params)
        targets = targets_of(factors)
        f_in = [t.detach().to(x.device, torch.float32)
                for t in trees.leaves(factors)]
        f = [t.clone().requires_grad_(True) for t in f_in]
        state = optimizer.init(f)
        executed = min(int(step_budget), num_steps)
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for t in range(executed):
            idx = batch_idx[t]
            loss = loss_fn(f, f_in, targets, x[idx], y[idx])
            grads = torch.autograd.grad(loss, f)
            optimizer.step(f, grads, state, lr_scale)
            loss_sum += loss.detach()
        with torch.no_grad():
            delta = torch._foreach_sub(f, f_in)
        return LocalResult(
            delta=delta,
            num_examples=int(count),
            completed=int(step_budget) >= min_steps,
            mean_loss=loss_sum / max(float(executed), 1.0),
            steps_run=float(executed),
        )

    return lora_update
