"""N1: the top-k-by-magnitude selector of the uplink compression, a
hand-written CUDA kernel and its plain twin.

The kernel (``csrc/topk.cu``) replaces the JAX package's
``native/src/topk.cpp`` (``cl_topk_abs``, reached through
``native.topk_abs`` from ``fed/compression.py``).  A selection gives the
``k`` entries of a flat float32 tensor with the largest magnitude bits
(``bits & 0x7FFFFFFF``: the sign is ignored, so -0.0 equals +0.0, and NaN
ranks above inf), ties to the lower index: their int32 indices ascending
and their values, bit for bit.  :func:`topk_abs_many` makes the
selections of every leaf of a tree in one call, into one buffer at
per-leaf offsets; :func:`topk_abs` is a batch of one.  On CUDA tensors the
call launches the kernels (a fixed handful whatever the number of leaves,
with no host sync; ``csrc/topk.cu`` has the design) or raises; on CPU
tensors it runs :func:`topk_abs_many_reference`, which is
:func:`topk_abs_reference` per leaf: it orders the entries by a 64-bit key
(magnitude bits, then the index reversed), a unique order whose top ``k``
is the same set.  ``launches["topk_abs"]`` counts the selections made on
the card (one per leaf), ``launches["topk_abs_calls"]`` the calls, under
a lock, as threads may share the card.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import Optional, Sequence

import torch

launches = {"topk_abs": 0, "topk_abs_calls": 0}
_LAUNCHES_LOCK = threading.Lock()
MAX_N = 2 ** 31 - 1            # int32 indices, as on the wire
_CACHED_TABLES = 64


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in launches:
            launches[name] = 0


def _count(selections: int) -> None:
    with _LAUNCHES_LOCK:
        launches["topk_abs"] += selections
        launches["topk_abs_calls"] += 1


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


def topk_abs_many_reference(flats: Sequence[torch.Tensor],
                            ks: Sequence[int]
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of a batch: :func:`topk_abs_reference` per leaf, the
    leaves' indices and values one after another."""
    picks = [topk_abs_reference(f, int(k)) for f, k in zip(flats, ks)]
    dev = flats[0].device if len(flats) else torch.device("cpu")
    if not picks:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.float32, device=dev))
    return (torch.cat([i for i, _ in picks]),
            torch.cat([v for _, v in picks]))


# ------------------------------------------------------------------ kernel
_LIB = None
_TABLES: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_CAPTURED: list = []           # tables CUDA graphs read at replay
_TABLES_LOCK = threading.Lock()


def _lib():
    global _LIB
    if _LIB is None:
        from colearn_federated_learning_tpu_torch.ops import _build

        lib = _build.load("topk")
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.topk_abs_many.argtypes = [P, I, I, L, L, L, L, P, P, P, P]
        lib.topk_abs_many.restype = I
        lib.topk_scratch_bytes.argtypes = [L, L, L, L]
        lib.topk_scratch_bytes.restype = L
        lib.topk_constant.argtypes = [I]
        lib.topk_constant.restype = L
        lib.topk_fill_table.argtypes = [P, P, I, P]
        lib.topk_fill_table.restype = I
        _LIB = lib
    return _LIB


def _plan(lib, flats, ks) -> tuple[list, dict]:
    """The kernel's table (large leaves first, then the small ones; a row
    per leaf as in ``csrc/topk.cu``'s ``struct Leaf``) and its totals."""
    small_max, tile, merge_tile = (int(lib.topk_constant(i))
                                   for i in range(3))
    outs, off = [], 0
    for k in ks:
        outs.append(off)
        off += k
    large = [j for j, f in enumerate(flats) if f.numel() > small_max]
    small = [j for j, f in enumerate(flats) if f.numel() <= small_max]
    rows = []
    a = b = tiles = merges = 0
    for j in large:              # B's offsets 16-byte aligned
        n, k = flats[j].numel(), ks[j]
        rows.append((flats[j].data_ptr(), outs[j], n, k, a, b, tiles, merges))
        a, b = a + k, b + -(-n // 4) * 4
        tiles += -(-n // tile)
        merges += -(-k // merge_tile)
    for j in small:
        rows.append((flats[j].data_ptr(), outs[j], flats[j].numel(), ks[j],
                     0, 0, 0, 0))
    return rows, dict(nl=len(large), ns=len(small), tiles=tiles,
                      merges=merges, sum_n=b, sum_k=a)


def _device_table(lib, rows: list, device: torch.device) -> torch.Tensor:
    """The table on the card.  Tables are kept by content (a table is a
    function of the pointers, sizes and offsets alone), so a repeated call
    copies nothing; a new one is copied from pinned memory on the current
    stream.  Inside a CUDA-graph capture a table the cache lacks is written
    by kernels that carry its rows (the graph replays them), and every
    table the graph reads is kept for its replays."""
    key = (device.index, tuple(rows))
    stream = torch.cuda.current_stream(device)
    capturing = torch.cuda.is_current_stream_capturing()
    with _TABLES_LOCK:
        hit = _TABLES.get(key)
        if hit is not None:
            _TABLES.move_to_end(key)
            if capturing:
                _CAPTURED.append(hit[1])
            else:
                hit[1].record_stream(stream)
            return hit[1]
    host = torch.tensor(rows, dtype=torch.int64)
    if capturing:
        table = torch.empty_like(host, device=device)
        err = lib.topk_fill_table(table.data_ptr(), host.data_ptr(),
                                  len(rows), stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"topk_abs table fill failed: cudaError {err}")
        with _TABLES_LOCK:
            _CAPTURED.append(table)
        return table
    host = host.pin_memory()
    table = host.to(device, non_blocking=True)
    with _TABLES_LOCK:
        _TABLES[key] = (host, table)
        if len(_TABLES) > _CACHED_TABLES:
            _TABLES.popitem(last=False)
    return table


def topk_abs_many(flats: Sequence[torch.Tensor], ks: Sequence[int],
                  out_idx: Optional[torch.Tensor] = None,
                  out_val: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The selections of every flat float32 leaf of ``flats`` (``ks[j]`` of
    leaf ``j``), one after another in ``out_idx`` (int32) and ``out_val``
    (float32), ``sum(ks)`` contiguous entries each on the leaves' device
    (allocated when not given).  One call of the kernels for the whole
    batch on the card."""
    flats, ks = list(flats), [int(k) for k in ks]
    if len(flats) != len(ks):
        raise ValueError(f"topk_abs_many: {len(flats)} leaves but "
                         f"{len(ks)} values of k")
    for f, k in zip(flats, ks):
        _check(f, k)
    dev = flats[0].device if flats else torch.device("cpu")
    if any(f.device != dev for f in flats):
        raise ValueError("topk_abs_many: leaves on more than one device")
    total = sum(ks)
    if out_idx is None:
        out_idx = torch.empty(total, dtype=torch.int32, device=dev)
    if out_val is None:
        out_val = torch.empty(total, dtype=torch.float32, device=dev)
    if (out_idx.dtype != torch.int32 or out_val.dtype != torch.float32
            or out_idx.numel() != total or out_val.numel() != total
            or not (out_idx.is_contiguous() and out_val.is_contiguous())):
        raise ValueError("topk_abs: out_idx and out_val must be k "
                         "contiguous int32 and float32 entries")
    if not flats:
        return out_idx, out_val
    if dev.type != "cuda":
        idx, val = topk_abs_many_reference(flats, ks)
        out_idx.copy_(idx)
        out_val.copy_(val)
        return out_idx, out_val
    if out_idx.device != dev or out_val.device != dev:
        raise ValueError("topk_abs: outputs on another device than the "
                         "input")
    flats = [f.contiguous() for f in flats]
    lib = _lib()
    rows, t = _plan(lib, flats, ks)
    table = _device_table(lib, rows, dev)
    scratch = torch.empty(
        int(lib.topk_scratch_bytes(t["nl"], t["tiles"], t["sum_n"],
                                   t["sum_k"])), dtype=torch.uint8, device=dev)
    err = lib.topk_abs_many(
        table.data_ptr(), t["nl"], t["ns"], t["tiles"], t["merges"],
        t["sum_n"], t["sum_k"], out_idx.data_ptr(), out_val.data_ptr(),
        scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"topk_abs kernel launch failed: cudaError {err}")
    _count(len(flats))
    return out_idx, out_val


def topk_abs(flat: torch.Tensor, k: int,
             out_idx: Optional[torch.Tensor] = None,
             out_val: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Indices (int32, ascending) and values of the ``k`` largest-|x|
    entries of the flat float32 ``flat``, on its device: a batch of one of
    :func:`topk_abs_many`.  ``out_idx`` and ``out_val`` (``k`` int32 and
    float32 entries on the same device, contiguous) receive them when
    given."""
    return topk_abs_many([flat], [k], out_idx, out_val)
