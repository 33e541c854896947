"""Differential privacy on client updates, on the updates' device.

The counterpart of the JAX package's ``privacy/dp.py``: DP-FedAvg with the
central Gaussian mechanism simulated at the clients.  Each client's delta
is clipped to L2 norm ``clip``, then gains Gaussian noise of std
``clip · z / sqrt(cohort)``, so the sum over the cohort carries std
``clip · z``.  The noise arrives as an iterator of standard-normal f32
tensors, one per parameter tensor in order, drawn on the delta's device
(``fed/programs.Draws.dp_noise``); ``clip`` may be a Python float or a
device f32 scalar (adaptive clipping).  Arithmetic is f32 throughout.
"""

from __future__ import annotations

import numpy as np
import torch


def global_norm(delta: list) -> torch.Tensor:
    """L2 norm over every tensor of ``delta`` (f32): one multi-tensor
    norm pass, then the norm of the per-tensor norms."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(delta)))


def clip_by_global_norm(delta: list, clip, norm_fn=global_norm
                        ) -> tuple[list, torch.Tensor]:
    """Scale ``delta`` in place so its global norm (``norm_fn``: over
    every slice of a tensor-parallel delta) is at most ``clip``; returns
    it and its norm before the clip."""
    norm = norm_fn(delta)
    clip = torch.as_tensor(clip, dtype=torch.float32, device=norm.device)
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
    torch._foreach_mul_(delta, scale)
    return delta, norm


def noise_std(clip, noise_multiplier: float, cohort_size: int):
    """Per-client std ``clip · z / sqrt(cohort)`` in f32 (a device scalar
    when ``clip`` is one)."""
    root = np.sqrt(np.float32(max(cohort_size, 1)))
    if isinstance(clip, torch.Tensor):
        return clip * float(np.float32(noise_multiplier)) / float(root)
    return float(np.float32(clip * noise_multiplier) / root)


def add_gaussian_noise(delta: list, std, noise) -> list:
    """``delta[i] += std · next(noise)``, tensor by tensor, in place."""
    for d, n in zip(delta, noise):
        d.add_(n.mul_(std))
    return delta


def clip_and_noise_with_bit(delta: list, clip, noise_multiplier: float,
                            cohort_size: int, noise, norm_fn=global_norm
                            ) -> tuple[list, torch.Tensor]:
    """Clip ``delta`` to ``clip`` and noise it for a central std of
    ``clip · noise_multiplier`` after summing ``cohort_size`` clients;
    also returns adaptive clipping's quantile bit ``1{‖Δ‖ ≤ clip}`` of the
    norm before the clip (Andrew et al., pattern only)."""
    delta, norm = clip_by_global_norm(delta, clip, norm_fn)
    if noise_multiplier > 0.0:
        add_gaussian_noise(
            delta, noise_std(clip, noise_multiplier, cohort_size), noise)
    return delta, (norm <= torch.as_tensor(clip, dtype=torch.float32,
                                           device=norm.device)).float()


def clip_and_noise(delta: list, clip, noise_multiplier: float,
                   cohort_size: int, noise, norm_fn=global_norm) -> list:
    """:func:`clip_and_noise_with_bit` without the bit."""
    return clip_and_noise_with_bit(delta, clip, noise_multiplier,
                                   cohort_size, noise, norm_fn)[0]


def adaptive_noise_multiplier(z: float, bit_noise: float) -> float:
    """Update-noise multiplier z_Δ so that the update and the bit together
    cost the configured multiplier ``z``: z_Δ = (z⁻² − (2σ_b)⁻²)^(−1/2);
    needs z < 2σ_b."""
    if z <= 0.0:
        return 0.0
    if 2.0 * bit_noise <= z:
        raise ValueError(
            f"adaptive clipping needs bit_noise > z/2 (z={z}, "
            f"bit_noise={bit_noise}); raise dp_bit_noise")
    return (z ** -2 - (2.0 * bit_noise) ** -2) ** -0.5


def adaptive_clip_update(clip: torch.Tensor, bit_frac: torch.Tensor,
                         target_quantile: float,
                         clip_lr: float) -> torch.Tensor:
    """Geometric step of the clip toward the target quantile,
    C ← C · exp(−η (b̃ − γ)), as device f32 scalars."""
    return clip * torch.exp(-float(np.float32(clip_lr))
                            * (bit_frac - float(np.float32(target_quantile))))
