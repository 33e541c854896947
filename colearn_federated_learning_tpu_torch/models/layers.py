"""Layers with flax's numerics, shared by every model family.

None of these has a TPU kernel behind it in the JAX package (they are XLA
ops there), so here they are plain torch ops: cuBLAS serves the products
and cuDNN the convolutions.  Parameters are f32 masters cast to the
compute dtype per call, as flax ``dtype=`` does.

- :func:`linear`, :func:`conv`: ``nn.Dense`` and ``nn.Conv`` (``SAME``
  padding computed as XLA does, asymmetric where it must be);
- :func:`mlp`: a transformer block's MLP, tensor-parallel when asked;
- :func:`run_block`: a block, under activation checkpointing with remat;
- :func:`layer_norm`, :func:`group_norm`: flax's statistics in f32 (fast
  variance E[x²] − E[x]² for GroupNorm), eps 1e-6, output in the dtype;
- :func:`lecun_normal_`, :func:`flax_init_`: flax's default init.

Layouts: activations of the convolutional families are channels-first
*views* of channels-last memory (``x.permute(0, 3, 1, 2)`` of an NHWC
batch); with channels-last conv weights that is what cuDNN's NHWC kernels
take without a copy.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

EPS = 1e-6                    # flax LayerNorm / GroupNorm epsilon


def linear(x, layer: nn.Linear, dtype: torch.dtype):
    """``layer`` applied in ``dtype`` (f32 master weights cast per call)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def mlp(x, up: nn.Linear, down: nn.Linear, dtype: torch.dtype, tp=None):
    """A transformer block's ``Dense_0`` -> tanh-GELU -> ``Dense_1``.
    Under tensor parallelism (``tp``, a ``parallel.mesh.Axis``) this rank
    holds ``Dense_0``'s rows and ``Dense_1``'s columns of its hidden units:
    the input's gradient is all-reduced over the model group, the down
    product is all-reduced forward and its bias added once after the sum."""
    if tp is None:
        return linear(F.gelu(linear(x, up, dtype), approximate="tanh"), down,
                      dtype)
    from colearn_federated_learning_tpu_torch.parallel import collectives

    h = F.gelu(linear(collectives.copy_to_group(x, tp.group), up, dtype),
               approximate="tanh")
    y = collectives.reduce_from_group(F.linear(h, down.weight.to(dtype)),
                                      tp.group)
    return y + down.bias.to(dtype)


def run_block(block: nn.Module, remat: bool, *args):
    """``block(*args)``; with ``remat`` (and autograd on) under activation
    checkpointing, so its activations are recomputed in the backward pass
    instead of kept (``use_reentrant=False``: the forward records the
    graph as usual, so side outputs such as an MoE layer's load-balance
    loss keep their gradient).  The blocks draw no random numbers, so no
    RNG state is stashed for the recomputation."""
    if remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        return checkpoint(block, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return block(*args)


def same_padding(n: int, k: int, stride: int, dilation: int) -> tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial dim: (low, high)."""
    total = max((-(-n // stride) - 1) * stride + (k - 1) * dilation + 1 - n, 0)
    return total // 2, total - total // 2


def conv(x, layer: nn.Conv1d | nn.Conv2d, dtype: torch.dtype, stride: int = 1,
         dilation: int = 1):
    """flax ``nn.Conv(padding="SAME")`` on a channels-first ``x`` (N, C,
    *spatial).  A symmetric pad goes to the convolution itself; an
    asymmetric one (a stride-2 3×3 on an even size pads (0, 1)) is an
    explicit pad first.  A strided 1×1 conv reads every stride-th pixel and
    pads nothing, so it is the unstrided conv of that slice (the strided
    form's backward on a channels-last input corrupts the heap on the CPU
    in torch 2.13)."""
    x = x.to(dtype)
    if stride > 1 and all(k == 1 for k in layer.weight.shape[2:]):
        x = x[(..., *[slice(None, None, stride)] * (x.dim() - 2))]
        stride = 1
    pads = [same_padding(n, k, stride, dilation)
            for n, k in zip(x.shape[2:], layer.weight.shape[2:])]
    if all(lo == hi for lo, hi in pads):
        padding = tuple(lo for lo, _ in pads)
    else:
        x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
        padding = 0
    fn = F.conv2d if x.dim() == 4 else F.conv1d
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return fn(x, layer.weight.to(dtype), bias, stride, padding, dilation)


def layer_norm(x, ln: nn.LayerNorm, dtype: torch.dtype):
    """flax ``LayerNorm(dtype=...)``: statistics in f32, output in dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(dtype)


def group_norm(x, gn: nn.GroupNorm, dtype: torch.dtype):
    """flax ``GroupNorm(num_groups, dtype=...)`` on a channels-first ``x``:
    groups of consecutive channels; mean and fast variance in f32 (clipped
    at 0); (x − mean) · (rsqrt(var + eps) · scale) + bias in f32, cast to
    ``dtype`` once."""
    G = gn.num_groups
    C = x.shape[1]
    ones = (1,) * (x.dim() - 2)
    g = x.float().unflatten(1, (G, C // G))           # (N, G, C/G, *spatial)
    dims = tuple(range(2, g.dim()))
    mean = g.mean(dims, keepdim=True)
    var = ((g * g).mean(dims, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + gn.eps) * gn.weight.view(G, C // G, *ones)
    y = (g - mean) * mul + gn.bias.view(G, C // G, *ones)
    return y.flatten(1, 2).to(dtype)


def lecun_normal_(weight, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: variance_scaling(1, fan_in,
    truncated_normal).  The std of a unit normal truncated to [-2, 2] is
    0.8796..., hence the correction."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def flax_init_(model: nn.Module, generator: torch.Generator) -> None:
    """flax's default init for the layers of ``model``: lecun-normal
    (truncated) kernels with fan-in = receptive field × input channels,
    zero biases, unit LayerNorm and GroupNorm scales.  Parameters outside
    these layers (embeddings, class tokens, expert banks) are the
    family's own business."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            w = module.weight
            lecun_normal_(w, w[0].numel(), generator)
            if module.bias is not None:
                nn.init.zeros_(module.bias)
        elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)


def gn(channels: int, groups: int) -> nn.GroupNorm:
    """A GroupNorm layer's parameters with flax's eps (applied by
    :func:`group_norm`)."""
    return nn.GroupNorm(groups, channels, eps=EPS)


def ln(features: int) -> nn.LayerNorm:
    return nn.LayerNorm(features, eps=EPS)
