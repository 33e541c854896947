"""N2: the row gather that packs the engine's client shards, a
hand-written CUDA kernel and its plain twin.

The kernel (``csrc/gather.cu``) replaces the JAX package's
``native/src/gather.cpp`` (``cl_gather_rows``, reached through
``native.gather_rows`` from ``data/sharding.py``).  :func:`gather_rows`
gives ``src[idx]`` over the leading axis (rows are the trailing dims, of
any dtype), with every index checked before anything is written: a bad
index raises :class:`IndexError`.  On a CUDA tensor it launches the kernel
(a check, then the copy, which writes nothing if the check failed; the
wrapper reads the check's flag, one sync) or raises; on a CPU tensor it
runs :func:`gather_rows_reference` (``index_select``).
``launches["gather_rows"]`` counts gathers on the card, one per call.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

launches = {"gather_rows": 0}
_LAUNCHES_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in launches:
            launches[name] = 0


def _count(name: str) -> None:
    with _LAUNCHES_LOCK:
        launches[name] += 1


def _bad_index() -> IndexError:
    return IndexError("gather_rows: index out of range")


# ------------------------------------------------------------------ plain
def gather_rows_reference(src: torch.Tensor, idx: torch.Tensor
                          ) -> torch.Tensor:
    """Plain version: every index checked, then ``index_select``."""
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= src.shape[0]):
        raise _bad_index()
    return torch.index_select(src, 0, idx)


# ------------------------------------------------------------------ kernel
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from colearn_federated_learning_tpu_torch.ops import _build

        lib = _build.load("gather")
        P, L = ctypes.c_void_p, ctypes.c_longlong
        lib.gather_rows.argtypes = [P, L, L, P, L, P, P, P]
        lib.gather_rows.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` over the leading axis of ``src`` (``idx`` a 1-D int64
    tensor on ``src``'s device); raises :class:`IndexError` on an index
    outside ``[0, len(src))``, before anything is written."""
    if idx.dtype != torch.int64 or idx.dim() != 1:
        raise ValueError(f"gather_rows takes 1-D int64 indices, got "
                         f"{idx.dtype} of shape {tuple(idx.shape)}")
    if src.dim() < 1:
        raise ValueError("gather_rows needs rows: src has no leading axis")
    if idx.device != src.device:
        raise ValueError(f"gather_rows: indices on {idx.device}, rows on "
                         f"{src.device}")
    if src.device.type != "cuda":
        return gather_rows_reference(src, idx)
    src, idx = src.contiguous(), idx.contiguous()
    out = torch.empty((idx.numel(),) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    bad = torch.empty(1, dtype=torch.int32, device=src.device)
    launch(src, idx, out, bad)
    _count("gather_rows")
    if int(bad.item()):
        raise _bad_index()
    return out


def launch(src: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
           bad: torch.Tensor) -> None:
    """One gather on the card into ``out`` (contiguous, ``len(idx)`` rows
    of ``src``'s), its check's flag into ``bad`` (one int32), with no sync
    and no count: :func:`gather_rows` without its last step, for timing."""
    row_bytes = math.prod(src.shape[1:]) * src.element_size()
    err = _lib().gather_rows(
        src.data_ptr(), src.shape[0], row_bytes, idx.data_ptr(), idx.numel(),
        out.data_ptr(), bad.data_ptr(),
        torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: cudaError "
                           f"{err}")
