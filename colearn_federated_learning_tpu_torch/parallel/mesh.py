"""Named-axis device meshes over the ``torch.distributed`` world.

The counterpart of the JAX package's ``parallel/mesh.py``.  The federated
engine lays clients over a 1-D ``(clients,)`` mesh; sequence parallelism
adds a ``seq`` axis and tensor parallelism a ``model`` axis.  A mesh here
is a :class:`torch.distributed.device_mesh.DeviceMesh` over every rank of
the initialised world, one rank per device, with named dims.

On several hosts ``torchrun`` numbers the ranks host-major (all of host
0's local ranks, then host 1's, ...), so a row-major mesh whose FIRST
axis is the client axis already puts that axis across hosts and the inner
axes inside each host, which is the layout the JAX package builds with
``create_hybrid_device_mesh``: the client axis carries one all-reduce per
round, the inner axes carry the per-layer traffic.

Entry points run on the card (NCCL) unless the caller asks for the CPU
(gloo); a mesh on one device type over a process group of the other is
refused, never rerouted.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def factor_devices(n: int, num_axes: int) -> tuple[int, ...]:
    """Factor ``n`` devices into ``num_axes`` mesh-axis sizes.

    Greedy: trailing axes take the smallest divisor > 1 so the leading
    (client/data) axis keeps the bulk — EXCEPT when the remainder is prime
    (incl. 2): then the whole remainder goes to the trailing axis, e.g.
    ``factor_devices(7, 2) == (1, 7)``, so a ring (``seq``) axis is never
    a useless size-1 axis.  (A copy of the JAX package's.)
    """
    if num_axes <= 0:
        raise ValueError("num_axes must be >= 1")
    sizes = []
    remaining = n
    for _ in range(num_axes - 1):
        d = next(
            (f for f in range(2, remaining) if remaining % f == 0),
            remaining if remaining > 1 else 1,
        )
        sizes.append(d)
        remaining //= d
    sizes.append(remaining)
    return tuple(reversed(sizes))


def init_world(device_type: str = "cuda") -> None:
    """Initialise the default process group for ``device_type`` (NCCL on
    the card, gloo on the CPU) from the environment ``torchrun`` sets, if
    it is not up yet; on the card each rank takes the device of its
    ``LOCAL_RANK``."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available for an NCCL mesh")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if dist.is_initialized():
        check_backend(device_type)
        return
    dist.init_process_group(BACKENDS[device_type])


def check_backend(device_type: str) -> None:
    """Refuse a mesh of ``device_type`` over a process group whose backend
    does not serve that device (gloo on the card, NCCL on the CPU)."""
    if device_type not in BACKENDS:
        raise ValueError(f"unknown device type {device_type!r}; use "
                         f"{sorted(BACKENDS)}")
    backend = str(dist.get_backend())
    if BACKENDS[device_type] not in backend:
        raise RuntimeError(
            f"a {device_type} mesh needs the {BACKENDS[device_type]} "
            f"backend; the process group runs {backend}")


def make_mesh(axis_names: Sequence[str],
              axis_sizes: Optional[Sequence[int]] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A named-axis :class:`DeviceMesh` over every rank of the world.

    - ``axis_sizes=None``: auto-factor the world over the axes (first axis
      largest).  A ``-1`` entry absorbs the remaining ranks.
    - Ranks are laid row-major, so the first axis spans hosts under
      ``torchrun`` (see the module docstring).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.mesh.init_world)")
    check_backend(device_type)
    n = dist.get_world_size()
    if axis_sizes is None:
        sizes = list(factor_devices(n, len(axis_names)))
    else:
        sizes = list(axis_sizes)
        if sizes.count(-1) > 1:
            raise ValueError("at most one axis size may be -1")
        if -1 in sizes:
            known = int(np.prod([s for s in sizes if s != -1]))
            if known == 0 or n % known:
                raise ValueError(f"cannot infer -1 axis: {n} devices over {sizes}")
            sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(
            f"mesh {dict(zip(axis_names, sizes))} needs {int(np.prod(sizes))} "
            f"devices, have {n}")
    return DeviceMesh(device_type, torch.arange(n).reshape(sizes),
                      mesh_dim_names=tuple(axis_names))


class Axis(NamedTuple):
    """One mesh axis as this rank sees it: the process group of the ranks
    that share every other coordinate, its size and this rank's index."""
    group: Optional[dist.ProcessGroup]
    size: int
    index: int


NO_AXIS = Axis(None, 1, 0)


def axis(mesh: Optional[DeviceMesh], name: str) -> Axis:
    """``name`` of ``mesh`` as an :class:`Axis`; a mesh without that axis
    (or no mesh) gives the trivial axis of size 1 and no group."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return NO_AXIS
    dim = mesh.mesh_dim_names.index(name)
    return Axis(mesh.get_group(name), int(mesh.size(dim)),
                int(mesh.get_local_rank(name)))
