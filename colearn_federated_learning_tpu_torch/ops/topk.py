"""N1: the top-k-by-magnitude selector of the uplink compression, a
hand-written CUDA kernel and its plain twin.

The kernel (``csrc/topk.cu``) replaces the JAX package's
``native/src/topk.cpp`` (``cl_topk_abs``, reached through
``native.topk_abs`` from ``fed/compression.py``).  :func:`topk_abs` gives
the ``k`` entries of a flat float32 tensor with the largest magnitude
bits (``bits & 0x7FFFFFFF``: the sign is ignored, so -0.0 equals +0.0,
and NaN ranks above inf), ties to the lower index: their int32 indices
ascending and their values, bit for bit.  On a CUDA tensor it launches the
kernel (a radix select on the card, then one stable compaction in index
order; ``csrc/topk.cu`` has the design) or raises; on a CPU tensor it runs
:func:`topk_abs_reference`, which orders the entries by a 64-bit key
(magnitude bits, then the index reversed), a unique order whose top ``k``
is the same set.  ``launches["topk_abs"]`` counts kernel selections, one
per call on the card, under a lock, as threads may share the card.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

launches = {"topk_abs": 0}
_LAUNCHES_LOCK = threading.Lock()
MAX_N = 2 ** 31 - 1            # int32 indices, as on the wire


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in launches:
            launches[name] = 0


def _count(name: str) -> None:
    with _LAUNCHES_LOCK:
        launches[name] += 1


def _check(flat: torch.Tensor, k: int) -> None:
    if flat.dtype != torch.float32 or flat.dim() != 1:
        raise ValueError(f"topk_abs takes a flat float32 tensor, got "
                         f"{flat.dtype} of shape {tuple(flat.shape)}")
    if not 0 < k <= flat.numel():
        raise ValueError(f"k={k} out of range for size {flat.numel()}")
    if flat.numel() > MAX_N:
        raise ValueError(f"a leaf of {flat.numel()} entries: indices are "
                         f"int32, leaves of at most {MAX_N}")


# ------------------------------------------------------------------ plain
def topk_abs_reference(flat: torch.Tensor, k: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of one selection: the top ``k`` of the unique key
    ``(magnitude bits << 32) | (2^32 - 1 - index)``, sorted by index."""
    n = flat.numel()
    mag = flat.view(torch.int32).to(torch.int64) & 0x7FFFFFFF
    key = (mag << 32) | (0xFFFFFFFF - torch.arange(n, dtype=torch.int64,
                                                   device=flat.device))
    idx = torch.topk(key, k, sorted=False).indices.sort().values
    return idx.to(torch.int32), flat[idx]


# ------------------------------------------------------------------ kernel
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from colearn_federated_learning_tpu_torch.ops import _build

        lib = _build.load("topk")
        P, L = ctypes.c_void_p, ctypes.c_longlong
        lib.topk_abs.argtypes = [P, L, L, P, P, P, P]
        lib.topk_abs.restype = ctypes.c_int
        lib.topk_scratch_bytes.argtypes = [L]
        lib.topk_scratch_bytes.restype = L
        _LIB = lib
    return _LIB


def topk_abs(flat: torch.Tensor, k: int,
             out_idx: Optional[torch.Tensor] = None,
             out_val: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Indices (int32, ascending) and values of the ``k`` largest-|x|
    entries of the flat float32 ``flat``, on its device.  ``out_idx`` and
    ``out_val`` (``k`` int32 and float32 entries on the same device,
    contiguous) receive them when given, so a caller can select every leaf
    of a tree into one buffer."""
    k = int(k)
    _check(flat, k)
    if out_idx is None:
        out_idx = torch.empty(k, dtype=torch.int32, device=flat.device)
    if out_val is None:
        out_val = torch.empty(k, dtype=torch.float32, device=flat.device)
    if (out_idx.dtype != torch.int32 or out_val.dtype != torch.float32
            or out_idx.numel() != k or out_val.numel() != k
            or not (out_idx.is_contiguous() and out_val.is_contiguous())):
        raise ValueError("topk_abs: out_idx and out_val must be k "
                         "contiguous int32 and float32 entries")
    if flat.device.type != "cuda":
        idx, val = topk_abs_reference(flat, k)
        out_idx.copy_(idx)
        out_val.copy_(val)
        return out_idx, out_val
    if out_idx.device != flat.device or out_val.device != flat.device:
        raise ValueError("topk_abs: outputs on another device than the "
                         "input")
    flat = flat.contiguous()
    lib = _lib()
    scratch = torch.empty(int(lib.topk_scratch_bytes(flat.numel())),
                          dtype=torch.uint8, device=flat.device)
    err = lib.topk_abs(flat.data_ptr(), flat.numel(), k, out_idx.data_ptr(),
                       out_val.data_ptr(), scratch.data_ptr(),
                       torch.cuda.current_stream(flat.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"topk_abs kernel launch failed: cudaError {err}")
    _count("topk_abs")
    return out_idx, out_val
