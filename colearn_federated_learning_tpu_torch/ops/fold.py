"""B4: the server's batched ingest fold, a hand-written CUDA kernel and its
plain twin.

The kernel (``csrc/fold.cu``) replaces the JAX package's
``ops/fold_kernel.py`` (``FoldKernel.fold_sparse`` and ``fold_dense``, an
XLA ``lax.scan``) and its C++ lowering ``native/src/fold.cpp``.  A
:class:`FoldKernel` folds contributions into one flat float32 accumulator
that holds every SLOT (a leaf of the model) at its offset; the folder
(``comm/aggregation.py``) owns the tree <-> slot mapping.

- ``fold_sparse(acc, batch)``: ``batch`` is a list of ``(weight, slots)``
  stages, ``slots`` one ``(idx int64, raw_vals, scale)`` triple per slot
  (int8 values for topk8, float32 for topk, one dtype per batch).  Each
  value lands as ``(value * scale) * weight``, rounded twice; the first
  contribution of a fold (``acc`` None) is ASSIGNED into fresh zeros and
  the rest are added in batch order, so the result is bitwise the host
  fold's.
- ``fold_dense(acc, batch)``: ``batch`` is a list of per-slot lists of
  flat float32 contributions; the first is adopted when ``acc`` is None
  and the rest are added in order.

A batch is staged host -> device in one copy from a pinned buffer the
kernel keeps and reuses (:meth:`FoldKernel.stage_sparse`,
:meth:`FoldKernel.stage_dense`); the ``*_staged`` methods fold a staged
batch.  The accumulator lives on the kernel's device until
:meth:`FoldKernel.to_host`.  On the CPU (``device="cpu"``) the same
staging feeds the plain versions, :func:`fold_sparse_reference` and
:func:`fold_dense_reference` (``index_put_`` and in-order adds); on a card
the kernel launches or raises, and never falls back.  ``launches`` counts
kernel launches: one per sparse contribution, one per dense batch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from colearn_federated_learning_tpu_torch.utils.device import resolve_device

launches = {"fold_sparse": 0, "fold_dense": 0}
_ALIGN = 16


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


class SparseBatch(NamedTuple):
    """One staged sparse batch on the kernel's device: the contributions'
    indices and raw values packed back to back, ``begin`` (rows · slots +
    1, absolute positions) where each (contribution, slot) run starts,
    ``scales`` (rows · slots) the runs' dequant scales, and the host copies
    of ``begin`` and the float32 weights."""
    idx: torch.Tensor
    vals: torch.Tensor
    begin: torch.Tensor
    scales: torch.Tensor
    begin_host: np.ndarray
    weights: np.ndarray


# ------------------------------------------------------------------ plain
def fold_sparse_reference(acc, idx, vals, begin, scales, slot_off, lo: int,
                          hi: int, w: float, set_mode: bool):
    """Plain version of one sparse launch: the contribution of entries
    ``[lo, hi)``, whose runs start at ``begin`` (its slots + 1 entries,
    absolute positions into ``idx``/``vals``), lands in ``acc`` as
    ``(value * scale) * w``, assigned (``set_mode``) or added.  Indices
    are unique within a contribution, so ``index_put_`` with
    ``accumulate`` adds each once."""
    e = torch.arange(lo, hi, device=acc.device)
    s = torch.searchsorted(begin, e, right=True) - 1
    g = slot_off[s] + idx[lo:hi]
    v = (vals[lo:hi].to(torch.float32) * scales[s]) * w
    return acc.index_put_((g,), v, accumulate=not set_mode)


def fold_dense_reference(acc, x, adopt: bool):
    """Plain version of the dense launch: ``x`` (rows, n) added in row
    order into ``acc``, starting from row 0 when ``adopt``."""
    start = 0
    if adopt:
        acc.copy_(x[0])
        start = 1
    for r in range(start, x.shape[0]):
        acc.add_(x[r])
    return acc


# ------------------------------------------------------------------ kernel
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from colearn_federated_learning_tpu_torch.ops import _build

        lib = _build.load("fold")
        P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
        lib.fold_sparse.argtypes = [P, P, P, I, P, P, P, P, I, L, L, F, I, P]
        lib.fold_dense.argtypes = [P, P, L, I, I, P]
        lib.fold_sparse.restype = lib.fold_dense.restype = I
        _LIB = lib
    return _LIB


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_err(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


class FoldKernel:
    """Batched fold over a fixed slot layout ``sizes`` (per-slot element
    counts) on ``device`` (``None``: the card, raising without one)."""

    def __init__(self, sizes: Sequence[int], device=None):
        self.sizes = tuple(int(s) for s in sizes)
        self.device = resolve_device(device)
        offsets = np.zeros(len(self.sizes) + 1, np.int64)
        offsets[1:] = np.cumsum(self.sizes, dtype=np.int64)
        self.offsets = offsets
        self.total = int(offsets[-1])
        self.slot_off = torch.from_numpy(offsets[:-1].copy()).to(self.device)
        self.slot_size = torch.tensor(self.sizes, dtype=torch.int64,
                                      device=self.device)
        self._pinned: Optional[torch.Tensor] = None
        self._copied: Optional[torch.cuda.Event] = None

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    # ------------------------------------------------------- staging --
    def _staging(self, nbytes: int) -> torch.Tensor:
        """A host byte buffer of at least ``nbytes``: pinned and reused on
        the card (after the previous batch's copy out of it has finished),
        fresh on the CPU, where it is the staged batch itself."""
        if not self.on_card:
            return torch.empty(nbytes, dtype=torch.uint8)
        if self._copied is not None:
            self._copied.synchronize()
        if self._pinned is None or self._pinned.numel() < nbytes:
            self._pinned = torch.empty(max(nbytes, 1 << 20),
                                       dtype=torch.uint8, pin_memory=True)
        return self._pinned

    def _upload(self, buf: torch.Tensor, nbytes: int) -> torch.Tensor:
        """The first ``nbytes`` of ``buf`` on the kernel's device, in one
        copy."""
        if not self.on_card:
            return buf[:nbytes]
        dev = buf[:nbytes].to(self.device, non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record(torch.cuda.current_stream(self.device))
        return dev

    def stage_sparse(self, batch: Sequence) -> SparseBatch:
        """Check and pack one sparse batch and copy it to the device."""
        nslots = len(self.sizes)
        vdt = np.dtype(batch[0][1][0][1].dtype)
        if vdt not in (np.dtype(np.int8), np.dtype(np.float32)):
            raise ValueError(f"sparse values must be int8 or float32, "
                             f"got {vdt}")
        counts = np.zeros(len(batch) * nslots, np.int64)
        for r, (_, slots) in enumerate(batch):
            if len(slots) != nslots:
                raise ValueError(f"contribution {r} has {len(slots)} slots, "
                                 f"the layout {nslots}")
            for s, (idx, vals, _) in enumerate(slots):
                if np.dtype(vals.dtype) != vdt:
                    raise ValueError("one value dtype per sparse batch")
                if idx.size != vals.size:
                    raise ValueError(f"slot {s}: {idx.size} indices for "
                                     f"{vals.size} values")
                if idx.size and (idx.min() < 0 or idx.max() >= self.sizes[s]):
                    raise IndexError(f"fold_sparse: index out of range for "
                                     f"slot {s} of {self.sizes[s]} entries")
                counts[r * nslots + s] = idx.size
        begin = np.zeros(len(counts) + 1, np.int64)
        begin[1:] = np.cumsum(counts)
        k = int(begin[-1])
        sections = [("idx", 8 * k), ("vals", vdt.itemsize * k),
                    ("begin", 8 * begin.size), ("scales", 4 * counts.size)]
        starts, nbytes = {}, 0
        for name, size in sections:
            starts[name] = nbytes
            nbytes += _aligned(size)
        buf = self._staging(nbytes)
        host = buf.numpy()

        def view(name, dtype, n):
            at = starts[name]
            return host[at:at + n * np.dtype(dtype).itemsize].view(dtype)

        hidx, hvals = view("idx", np.int64, k), view("vals", vdt, k)
        view("begin", np.int64, begin.size)[:] = begin
        hscales = view("scales", np.float32, counts.size)
        weights = np.zeros(len(batch), np.float32)
        for r, (w, slots) in enumerate(batch):
            weights[r] = w
            for s, (idx, vals, scale) in enumerate(slots):
                a, b = begin[r * nslots + s], begin[r * nslots + s + 1]
                hidx[a:b] = idx
                hvals[a:b] = vals
                hscales[r * nslots + s] = scale
        dev = self._upload(buf, nbytes)

        def dview(name, dtype, n):
            at = starts[name]
            size = n * torch.empty((), dtype=dtype).element_size()
            return dev[at:at + size].view(dtype)

        tdt = torch.int8 if vdt == np.dtype(np.int8) else torch.float32
        return SparseBatch(
            idx=dview("idx", torch.int64, k), vals=dview("vals", tdt, k),
            begin=dview("begin", torch.int64, begin.size),
            scales=dview("scales", torch.float32, counts.size),
            begin_host=begin, weights=weights)

    def stage_dense(self, batch: Sequence) -> torch.Tensor:
        """Pack one dense batch as (rows, total) float32 and copy it to the
        device."""
        nbytes = 4 * len(batch) * self.total
        buf = self._staging(nbytes)
        host = buf.numpy()[:nbytes].view(np.float32).reshape(len(batch),
                                                             self.total)
        for r, slots in enumerate(batch):
            if len(slots) != len(self.sizes):
                raise ValueError(f"contribution {r} has {len(slots)} slots, "
                                 f"the layout {len(self.sizes)}")
            for s, part in enumerate(slots):
                a, b = self.offsets[s], self.offsets[s + 1]
                if part.size != b - a:
                    raise ValueError(f"slot {s}: {part.size} values for "
                                     f"{b - a} entries")
                host[r, a:b] = part
        return self._upload(buf, nbytes).view(torch.float32).view(
            len(batch), self.total)

    # ---------------------------------------------------------- folds --
    def fold_sparse(self, acc: Optional[torch.Tensor],
                    batch: Sequence) -> Optional[torch.Tensor]:
        if not batch:
            return acc
        return self.fold_sparse_staged(acc, self.stage_sparse(batch))

    def fold_sparse_staged(self, acc: Optional[torch.Tensor],
                           st: SparseBatch) -> torch.Tensor:
        nslots = len(self.sizes)
        for r, w in enumerate(st.weights):
            set_mode = acc is None
            if set_mode:
                acc = torch.zeros(self.total, dtype=torch.float32,
                                  device=self.device)
            table = st.begin[r * nslots:(r + 1) * nslots + 1]
            scales = st.scales[r * nslots:(r + 1) * nslots]
            lo = int(st.begin_host[r * nslots])
            hi = int(st.begin_host[(r + 1) * nslots])
            if not self.on_card:
                fold_sparse_reference(acc, st.idx, st.vals, table, scales,
                                      self.slot_off, lo, hi, float(w),
                                      set_mode)
                continue
            with torch.cuda.device(self.device):
                err = _lib().fold_sparse(
                    acc.data_ptr(), st.idx.data_ptr(), st.vals.data_ptr(),
                    int(st.vals.dtype == torch.int8), table.data_ptr(),
                    scales.data_ptr(), self.slot_off.data_ptr(),
                    self.slot_size.data_ptr(), nslots, lo, hi, float(w),
                    int(set_mode), _stream(self.device))
            _check_err("fold_sparse", err)
            launches["fold_sparse"] += 1
        return acc

    def fold_dense(self, acc: Optional[torch.Tensor],
                   batch: Sequence) -> Optional[torch.Tensor]:
        if not batch:
            return acc
        return self.fold_dense_staged(acc, self.stage_dense(batch))

    def fold_dense_staged(self, acc: Optional[torch.Tensor],
                          x: torch.Tensor) -> torch.Tensor:
        adopt = acc is None
        if adopt:
            acc = torch.empty(self.total, dtype=torch.float32,
                              device=self.device)
        if not self.on_card:
            return fold_dense_reference(acc, x, adopt)
        with torch.cuda.device(self.device):
            err = _lib().fold_dense(acc.data_ptr(), x.data_ptr(), self.total,
                                    x.shape[0], int(adopt),
                                    _stream(self.device))
        _check_err("fold_dense", err)
        launches["fold_dense"] += 1
        return acc

    # ------------------------------------------------------- delivery --
    def to_host(self, acc: Optional[torch.Tensor]) -> Optional[list]:
        """The accumulator's slots as flat host numpy arrays (one device ->
        host copy)."""
        if acc is None:
            return None
        flat = acc.cpu().numpy()
        if not self.on_card:
            flat = flat.copy()          # detach from the accumulator
        return [flat[a:b] for a, b in zip(self.offsets[:-1],
                                          self.offsets[1:])]


_KERNELS: dict[tuple, FoldKernel] = {}
_KERNELS_LOCK = threading.Lock()


def get_kernel(sizes: Sequence[int], device=None) -> FoldKernel:
    """The shared kernel of one model's slot layout on ``device``, cached on
    the shape fingerprint: every folder of the same model (one per round on
    a server) reuses its device tables and staging buffer."""
    dev = resolve_device(device)
    key = (tuple(int(s) for s in sizes), str(dev))
    with _KERNELS_LOCK:
        k = _KERNELS.get(key)
        if k is None:
            k = _KERNELS[key] = FoldKernel(key[0], dev)
        return k


def clear_kernel_cache() -> None:
    with _KERNELS_LOCK:
        _KERNELS.clear()
