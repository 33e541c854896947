"""The device an entry point runs on: the card unless the caller asks for
another, and never the CPU by itself."""

from __future__ import annotations

import os
import re

import torch

_HOST_COUNT = re.compile(r"--xla_force_host_platform_device_count=(\d+)")


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return device


def host_device_count() -> int:
    """The host's positions for a placement on the CPU: the forced host
    platform device count in ``XLA_FLAGS`` (the setting the JAX runtime
    reads, and both packages' tests and soaks set), else 1."""
    m = _HOST_COUNT.search(os.environ.get("XLA_FLAGS", ""))
    return int(m.group(1)) if m else 1


def placement_devices(device=None) -> list[torch.device]:
    """The positions a server placement may use on ``device``'s kind (the
    card unless the caller asks for the CPU): every card of the host, or
    :func:`host_device_count` positions on the CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device] * host_device_count()


def server_positions(n: int, device=None) -> list[torch.device]:
    """Positions for an ``n``-wide server placement on ``device``'s kind:
    the distinct cards, or the first card repeated ``n`` times when the
    host has fewer (a placement's positions may repeat a device); on the
    CPU, :func:`host_device_count` positions."""
    devs = placement_devices(device)
    if devs[0].type == "cuda" and len(devs) < n:
        return [devs[0]] * n
    return devs
