"""B4: the server's batched ingest fold, a hand-written CUDA kernel and its
plain twin.

The kernel (``csrc/fold.cu``) replaces the JAX package's
``ops/fold_kernel.py`` (``FoldKernel.fold_sparse`` and ``fold_dense``, an
XLA ``lax.scan``) and its C++ lowering ``native/src/fold.cpp``.  A
:class:`FoldKernel` folds contributions into one flat float32 accumulator
that holds every SLOT (a leaf of the model) at its offset; the folder
(``comm/aggregation.py``) owns the tree <-> slot mapping.

- ``fold_sparse(acc, batch)``: ``batch`` is a list of ``(weight, slots)``
  stages, ``slots`` one ``(idx, raw_vals, scale)`` triple per slot (indices
  of any integer dtype, staged as int32; int8 values for topk8, float32
  for topk, one dtype per batch).  Each value lands as ``(value * scale) *
  weight``, rounded twice; the first contribution of a fold (``acc`` None)
  is ASSIGNED into fresh zeros and the rest are added in batch order, so
  the result is bitwise the host fold's.
- ``fold_dense(acc, batch)``: ``batch`` is a list of per-slot lists of
  flat float32 contributions; the first is adopted when ``acc`` is None
  and the rest are added in order.

Both stage through one pinned host buffer the kernel keeps and reuses.  A
sparse batch is checked whole first (every index in its slot, before
anything is written), then each contribution is packed into its own
16-byte-aligned region of the buffer (int32 indices, raw values, its run
table ``begin``, scales and tile table), copied on the kernel's own copy
stream as soon as it is packed, and folded on the current stream after
that copy: the host packs contribution r + 1 while r's copy and r - 1's
kernel run, and the current stream keeps the launches in batch order.  A
dense batch is packed whole and copied in one piece.
:meth:`FoldKernel.stage_sparse` and :meth:`FoldKernel.stage_dense` stage a
batch alone, ordered on the current stream, and the ``*_staged`` methods
fold a staged batch with no wait across streams (so they can be captured
in a CUDA graph).  The accumulator lives on the kernel's device until
:meth:`FoldKernel.to_host`.  On the CPU (``device="cpu"``) the same
staging feeds the plain versions, :func:`fold_sparse_reference` and
:func:`fold_dense_reference` (``index_put_`` and in-order adds); on a card
the kernel launches or raises, and never falls back.  ``launches`` counts
kernel launches (one per sparse contribution, one per dense batch), under
a lock, as threads may share the card.  Folders on several threads share
one cached kernel (an aggregator tree's tiers in one process, per-type
coordinators): :meth:`FoldKernel.fold_sparse` and
:meth:`FoldKernel.fold_dense` stage and fold one batch at a time, so the
pinned buffer is never written while another batch is staged from it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from colearn_federated_learning_tpu_torch.utils.device import resolve_device

launches = {"fold_sparse": 0, "fold_dense": 0}
_LAUNCHES_LOCK = threading.Lock()
_ALIGN = 16
TILE = 1024                    # entries per tile (csrc/fold.cu kTile)
MAX_SLOT = 2 ** 31 - 1         # int32 indices: the largest slot staged


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in launches:
            launches[name] = 0


def _count(name: str) -> None:
    with _LAUNCHES_LOCK:
        launches[name] += 1


class SparsePart(NamedTuple):
    """One staged sparse contribution on the kernel's device: its ``k``
    int32 indices and raw values packed slot after slot, ``begin`` (slots
    + 1, int64, from 0) where each slot's run starts, ``scales`` the runs'
    dequant scales, ``tiles`` (:func:`tile_table`), the host copy of
    ``begin`` and the float32 weight."""
    idx: torch.Tensor
    vals: torch.Tensor
    begin: torch.Tensor
    scales: torch.Tensor
    tiles: torch.Tensor
    begin_host: np.ndarray
    weight: np.float32


class SparseBatch(NamedTuple):
    """A staged sparse batch: its contributions in fold order."""
    parts: tuple

    @property
    def entries(self) -> int:
        return sum(int(p.begin_host[-1]) for p in self.parts)


def tile_table(begin: np.ndarray) -> np.ndarray:
    """The kernel's tile plan of one contribution whose runs start at
    ``begin``: the slot of each tile's first entry (tile t holds entries
    ``[t * TILE, (t + 1) * TILE)``) and, last, the slot of the last entry
    (0 for an empty contribution), int32.  A tile's entries lie in the
    slots between its own entry and the next one, so a thread finds its
    slot within that range and walks forward from there."""
    k = int(begin[-1])
    ends = np.append(np.arange(0, k, TILE, dtype=np.int64), max(k - 1, 0))
    slots = np.searchsorted(begin, ends, side="right") - 1
    return np.minimum(slots, max(len(begin) - 2, 0)).astype(np.int32)


# ------------------------------------------------------------------ plain
def fold_sparse_reference(acc, idx, vals, begin, scales, slot_off, w: float,
                          set_mode: bool):
    """Plain version of one sparse launch: a staged contribution (int32
    ``idx``, raw ``vals``, its runs starting at ``begin``, one scale per
    slot) lands in ``acc`` as ``(value * scale) * w``, assigned
    (``set_mode``) or added.  Indices are unique within a contribution, so
    ``index_put_`` with ``accumulate`` adds each once."""
    e = torch.arange(idx.numel(), device=acc.device)
    s = torch.searchsorted(begin, e, right=True) - 1
    g = slot_off[s] + idx.to(torch.int64)
    v = (vals.to(torch.float32) * scales[s]) * w
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
        lib.fold_sparse.argtypes = [P, P, P, I, P, P, P, I, P, P, L, F, I, P]
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
        if self.sizes and max(self.sizes) > MAX_SLOT:
            raise ValueError(f"a slot of {max(self.sizes)} entries: the fold "
                             f"stages int32 indices, slots of at most "
                             f"{MAX_SLOT}")
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
        self._copy_stream: Optional[torch.cuda.Stream] = None
        self._lock = threading.Lock()      # one batch staged at a time

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

    def _check_sparse(self, batch: Sequence) -> tuple:
        """Check a whole sparse batch before anything is written; returns
        its value dtype and per-contribution slot counts."""
        nslots = len(self.sizes)
        vdt = np.dtype(batch[0][1][0][1].dtype)
        if vdt not in (np.dtype(np.int8), np.dtype(np.float32)):
            raise ValueError(f"sparse values must be int8 or float32, "
                             f"got {vdt}")
        counts = np.zeros((len(batch), nslots), np.int64)
        for r, (_, slots) in enumerate(batch):
            if len(slots) != nslots:
                raise ValueError(f"contribution {r} has {len(slots)} slots, "
                                 f"the layout {nslots}")
            for s, (idx, vals, _) in enumerate(slots):
                if np.dtype(vals.dtype) != vdt:
                    raise ValueError("one value dtype per sparse batch")
                if idx.dtype.kind not in "iu":
                    raise TypeError(f"slot {s}: indices must be integers, "
                                    f"got {idx.dtype}")
                if idx.size != vals.size:
                    raise ValueError(f"slot {s}: {idx.size} indices for "
                                     f"{vals.size} values")
                # One pass: a negative index is a huge unsigned one.
                if idx.size and int(idx.view(f"u{idx.dtype.itemsize}").max()
                                    ) >= self.sizes[s]:
                    raise IndexError(f"fold_sparse: index out of range for "
                                     f"slot {s} of {self.sizes[s]} entries")
                counts[r, s] = idx.size
        return vdt, counts

    def _stage_parts(self, batch: Sequence):
        """Check ``batch``, then pack each contribution into its own region
        of the staging buffer and copy it to the device on the copy stream
        as soon as it is packed; yields ``(part, copied)`` in order, with
        ``copied`` the copy's event (None on the CPU, where the buffer is
        the staged batch itself)."""
        vdt, counts = self._check_sparse(batch)
        nslots = len(self.sizes)
        sections = []
        nbytes = 0
        for k in counts.sum(axis=1):
            ntiles = -(-int(k) // TILE)
            at = {}
            for name, size in (("idx", 4 * k), ("vals", vdt.itemsize * k),
                               ("begin", 8 * (nslots + 1)),
                               ("scales", 4 * nslots),
                               ("tiles", 4 * (ntiles + 1))):
                at[name] = nbytes
                nbytes += _aligned(int(size))
            sections.append((int(k), ntiles, at))
        host = self._staging(nbytes)
        dev = host
        if self.on_card:
            dev = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            # The device buffer is the current stream's: copy after it.
            self._copy_stream.wait_stream(
                torch.cuda.current_stream(self.device))
        tdt = torch.int8 if vdt == np.dtype(np.int8) else torch.float32
        for r, (w, slots) in enumerate(batch):
            k, ntiles, at = sections[r]
            begin = self._pack_part(host.numpy(), at, k, ntiles, counts[r],
                                    vdt, slots)
            lo, hi = at["idx"], at["tiles"] + 4 * (ntiles + 1)
            copied = (self._upload_part(host, dev, lo, hi) if self.on_card
                      else None)

            def dview(name, dtype, n):
                size = n * torch.empty((), dtype=dtype).element_size()
                return dev[at[name]:at[name] + size].view(dtype)

            yield SparsePart(
                idx=dview("idx", torch.int32, k), vals=dview("vals", tdt, k),
                begin=dview("begin", torch.int64, nslots + 1),
                scales=dview("scales", torch.float32, nslots),
                tiles=dview("tiles", torch.int32, ntiles + 1),
                begin_host=begin, weight=np.float32(w)), copied

    @staticmethod
    def _pack_part(host: np.ndarray, at: dict, k: int, ntiles: int,
                   counts: np.ndarray, vdt: np.dtype, slots) -> np.ndarray:
        """Write one checked contribution into its region of ``host``;
        returns its ``begin``."""
        def view(name, dtype, n):
            return host[at[name]:at[name] + n * np.dtype(dtype).itemsize
                        ].view(dtype)

        begin = view("begin", np.int64, len(counts) + 1)
        begin[0] = 0
        np.cumsum(counts, out=begin[1:])
        # One C call per array: the int32 narrowing is a same-kind cast.
        np.concatenate([np.ravel(idx) for idx, _, _ in slots],
                       out=view("idx", np.int32, k), casting="same_kind")
        np.concatenate([np.ravel(vals) for _, vals, _ in slots],
                       out=view("vals", vdt, k))
        view("scales", np.float32, len(counts))[:] = [
            scale for _, _, scale in slots]
        view("tiles", np.int32, ntiles + 1)[:] = tile_table(begin)
        return begin.copy()

    def _upload_part(self, host: torch.Tensor, dev: torch.Tensor, lo: int,
                     hi: int) -> torch.cuda.Event:
        """Copy bytes ``[lo, hi)`` of the pinned buffer into the device
        buffer on the copy stream; the returned event marks the copy."""
        with torch.cuda.stream(self._copy_stream):
            dev[lo:hi].copy_(host[lo:hi], non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record(self._copy_stream)
        return self._copied

    def stage_sparse(self, batch: Sequence) -> SparseBatch:
        """Check, pack and copy one sparse batch to the device, ordered on
        the current stream (its ``*_staged`` folds wait on no event)."""
        parts, copied = [], None
        for part, copied in self._stage_parts(batch):
            parts.append(part)
        if copied is not None:
            torch.cuda.current_stream(self.device).wait_event(copied)
        return SparseBatch(tuple(parts))

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
        """Fold one sparse batch, each contribution's copy overlapping the
        packing of the next and the kernel of the last."""
        if not batch:
            return acc
        with self._lock:
            stream = (torch.cuda.current_stream(self.device) if self.on_card
                      else None)
            for part, copied in self._stage_parts(batch):
                if copied is not None:
                    stream.wait_event(copied)
                acc = self._fold_part(acc, part)
            return acc

    def fold_sparse_staged(self, acc: Optional[torch.Tensor],
                           st: SparseBatch) -> torch.Tensor:
        for part in st.parts:
            acc = self._fold_part(acc, part)
        return acc

    def _fold_part(self, acc: Optional[torch.Tensor],
                   part: SparsePart) -> torch.Tensor:
        """One launch: ``part`` assigned into fresh zeros (``acc`` None) or
        added into ``acc``."""
        set_mode = acc is None
        if set_mode:
            acc = torch.zeros(self.total, dtype=torch.float32,
                              device=self.device)
        if not self.on_card:
            return fold_sparse_reference(acc, part.idx, part.vals, part.begin,
                                         part.scales, self.slot_off,
                                         float(part.weight), set_mode)
        with torch.cuda.device(self.device):
            err = _lib().fold_sparse(
                acc.data_ptr(), part.idx.data_ptr(), part.vals.data_ptr(),
                int(part.vals.dtype == torch.int8), part.begin.data_ptr(),
                part.scales.data_ptr(), part.tiles.data_ptr(), TILE,
                self.slot_off.data_ptr(), self.slot_size.data_ptr(),
                int(part.begin_host[-1]), float(part.weight), int(set_mode),
                _stream(self.device))
        _check_err("fold_sparse", err)
        _count("fold_sparse")
        return acc

    def fold_dense(self, acc: Optional[torch.Tensor],
                   batch: Sequence) -> Optional[torch.Tensor]:
        if not batch:
            return acc
        with self._lock:
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
        _count("fold_dense")
        return acc

    # ------------------------------------------------------- delivery --
    def to_host(self, acc: Optional[torch.Tensor]) -> Optional[list]:
        """The accumulator's slots as flat host numpy arrays (one device ->
        host copy).  From the card the copy lands in pinned memory from
        torch's caching host allocator: a fresh pageable buffer of the
        accumulator's size (434 MB at BERT-base) would fault in every page
        on each fold and copy through a staging buffer.  The arrays hold
        the block until the caller drops them."""
        if acc is None:
            return None
        if self.on_card:
            host = torch.empty(acc.shape, dtype=acc.dtype, pin_memory=True)
            flat = host.copy_(acc).numpy()
        else:
            flat = acc.numpy().copy()   # detach from the accumulator
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
