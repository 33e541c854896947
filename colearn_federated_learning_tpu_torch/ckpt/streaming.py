"""Crash-consistent streaming checkpoint, in the JAX package's on-disk
format (its ``ckpt/streaming.py``), so a generation written by either
package restores in the other.

- SAVE streams one shard file at a time: ``shard_<j>.npz`` holds the
  ``j``-th distinct shard of every leaf that has one (a sharded server's
  ``parallel.partition.ShardedTensor``; a replicated leaf is one slice in
  ``shard_00000.npz``), each slice read to the host only while its own
  entry is written, so the host never holds a second copy of the whole
  state, and the gather a replicated layout would need is counted in
  ``comm.gather_bytes_avoided_total``.  Files are committed by the
  same-dir temp file, fsync and ``os.replace``.
- A generation ``manifest.json`` (format 1: the CRC32 and size of every
  file, and per leaf its ``path``, ``shape``, ``dtype`` and ``slices``)
  is written and fsynced LAST: it is the commit marker.  A kill at any
  byte leaves the previous complete generation restorable.
- RESTORE walks generations newest first and falls back a generation on
  a missing or torn manifest, a missing or torn shard, or a CRC
  mismatch, counting each in ``ckpt.generations_discarded_total{reason}``
  (and in :attr:`StreamingCheckpointer.generations_discarded`).  Leaves
  are assembled one at a time from their saved slices and re-cut onto the
  template leaf's layout: a tensor on its device, or a sharded leaf's
  shards each on its own position's device, so a generation saved at any
  tp restores at any other (``ckpt.resharded_resumes_total`` when the
  saved slice count differs from the template's shard count, JAX's
  rule).  :attr:`StreamingCheckpointer.last_restore_digest` is the sha256
  over each leaf's ``(dtype name, shape)`` and C-order bytes, in flatten
  order, as JAX's.

State trees follow ``jax.tree_util``'s flatten order and paths
(:func:`flatten_state`): tuples and lists by index, dataclasses (the
port's ``ServerState``) and NamedTuples by field with ``None`` fields
dropped, dicts by sorted key.  Leaves are tensors (read where they live:
a view is made contiguous leaf by leaf), sharded leaves, numpy arrays or
Python scalars.
Callers hand the state in JAX's layout: flax-layout views of their
tensors (``convert.leaf_to_flax``), ``round_idx`` as an int32 ``()``
array.  bf16 leaves round-trip bitwise without ``ml_dtypes``: their
dtype entry is JAX's (``{"d": "<V2", "n": "bfloat16"}``) and their bytes
move as 16-bit words.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import tempfile
import time
import zipfile
import zlib
from collections.abc import Mapping
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from colearn_federated_learning_tpu_torch.parallel.partition import (
    ShardedTensor, host_leaf, leaf_gather_avoided)
from colearn_federated_learning_tpu_torch.telemetry import registry as _metrics
from colearn_federated_learning_tpu_torch.utils.serialization import (
    _dtype_entry, _resolve_dtype)

MANIFEST = "manifest.json"
HISTORY = "history.json"
_GEN_RE = re.compile(r"^gen_(\d{8})$")

# Recovery-matrix discard reasons (ckpt.generations_discarded_total labels).
R_MISSING_MANIFEST = "missing_manifest"
R_TORN_MANIFEST = "torn_manifest"
R_MISSING_SHARD = "missing_shard"
R_TORN_SHARD = "torn_shard"
R_CRC_MISMATCH = "crc_mismatch"

_BF16_ENTRY = {"d": "<V2", "n": "bfloat16"}


# ------------------------------------------------------------ state walk --

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, ShardedTensor, np.ndarray,
                          np.generic, int, float, bool))


def flatten_state(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree_util``'s flatten order, the
    path ``/``-joined as JAX's ``_path_str`` joins it."""
    def join(key) -> str:
        return f"{prefix}/{key}" if prefix else str(key)

    if tree is None:
        return []
    if _is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, Mapping):
        return [pair for k in sorted(tree)
                for pair in flatten_state(tree[k], join(k))]
    if _is_namedtuple(tree):
        return [pair for name in tree._fields
                for pair in flatten_state(getattr(tree, name), join(name))]
    if dataclasses.is_dataclass(tree):
        return [pair for f in dataclasses.fields(tree)
                for pair in flatten_state(getattr(tree, f.name),
                                          join(f.name))]
    if isinstance(tree, (tuple, list)):
        return [pair for i, sub in enumerate(tree)
                for pair in flatten_state(sub, join(i))]
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                    f"{prefix or '/'!r}")


def unflatten_state(tree: Any, leaves: Iterator) -> Any:
    """``tree``'s structure with its leaves replaced, in flatten order, by
    the next items of ``leaves``."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return next(leaves)
    if isinstance(tree, Mapping):
        out = {k: unflatten_state(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(unflatten_state(getattr(tree, n), leaves)
                            for n in tree._fields))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: unflatten_state(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree)})
    return type(tree)(unflatten_state(sub, leaves) for sub in tree)


def copy_leaves(dst: Any, src: Any) -> None:
    """Copy every tensor leaf of a restored tree ``src`` into the matching
    leaf of ``dst``, a template whose tensor leaves (and sharded leaves'
    shards) are views of live tensors: the restore lands in the live
    storage."""
    for (_, d), (_, s) in zip(flatten_state(dst), flatten_state(src)):
        if isinstance(d, torch.Tensor):
            d.copy_(s)
        elif isinstance(d, ShardedTensor):
            for dp, sp in zip(d.parts, s.parts):
                dp.copy_(sp)


# ------------------------------------------------------------ leaf bytes --

def _leaf_meta(leaf) -> tuple[tuple, dict, str]:
    """``(shape, dtype entry, dtype name)`` of a leaf, in JAX's terms."""
    if isinstance(leaf, ShardedTensor):
        _, entry, name = _leaf_meta(leaf.parts[0])
        return leaf.shape, entry, name
    if isinstance(leaf, torch.Tensor):
        shape = tuple(int(d) for d in leaf.shape)
        if leaf.dtype == torch.bfloat16:
            return shape, dict(_BF16_ENTRY), "bfloat16"
        dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
        return shape, _dtype_entry(dtype), dtype.name
    arr = np.asarray(leaf)
    return (tuple(int(d) for d in arr.shape), _dtype_entry(arr.dtype),
            arr.dtype.name)


def _host_bytes(leaf) -> np.ndarray:
    """One leaf's C-order bytes on the host, as a flat uint8 array (the
    only host copy of it; a device view is made contiguous first, a
    sharded leaf read shard by shard into one buffer)."""
    if isinstance(leaf, ShardedTensor):
        leaf = host_leaf(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.contiguous().cpu().numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(leaf))
    return arr.reshape(-1).view(np.uint8)


def _storage(entry: dict) -> tuple[np.dtype, Optional[torch.dtype], str]:
    """A dtype entry's ``(host storage dtype, torch view dtype or None,
    dtype name)``: bf16 is stored as 16-bit words and viewed back as a
    torch bf16 tensor, without ``ml_dtypes``."""
    if entry.get("n") == "bfloat16":
        return np.dtype(np.uint16), torch.bfloat16, "bfloat16"
    dtype = _resolve_dtype(entry)
    return dtype, None, dtype.name


def _digest_update(h, name: str, shape: tuple, buf: np.ndarray) -> None:
    h.update(repr((name, shape)).encode())
    h.update(np.ascontiguousarray(buf).tobytes())


def _as_tensor(buf: np.ndarray, view: Optional[torch.dtype]) -> torch.Tensor:
    # ascontiguousarray makes a () array (1,): keep the leaf's shape.
    t = torch.from_numpy(np.ascontiguousarray(buf).reshape(buf.shape))
    return t.view(view) if view is not None else t


def _leaf_shards(leaf) -> list:
    """A leaf's distinct shards as ``(starts, stops, leaf)``: each shard of
    a sharded leaf, or the whole of any other leaf."""
    if isinstance(leaf, ShardedTensor):
        out = []
        for part, idx in zip(leaf.parts, leaf.index):
            starts = [0 if s.start is None else int(s.start) for s in idx]
            stops = [d if s.stop is None else int(s.stop)
                     for d, s in zip(leaf.shape, idx)]
            out.append((starts, stops, part))
        return out
    shape = _leaf_meta(leaf)[0]
    return [([0] * len(shape), list(shape), leaf)]


def _place(tmpl: Any, buf: np.ndarray, view: Optional[torch.dtype]) -> Any:
    """One assembled host leaf in the template leaf's kind: a tensor on the
    template's device, a sharded leaf re-cut onto the template's shards
    (each on its own device), a numpy array, or the template's Python
    scalar type."""
    if isinstance(tmpl, ShardedTensor):
        return tmpl.map_parts(lambda part, idx: _as_tensor(
            buf[idx], view).to(part.device))
    if isinstance(tmpl, torch.Tensor):
        return _as_tensor(buf, view).to(tmpl.device)
    if isinstance(tmpl, (np.ndarray, np.generic)):
        return buf if view is None else buf.view(_resolve_dtype(_BF16_ENTRY))
    return type(tmpl)(buf.reshape(()).item())


# ------------------------------------------------------------ file I/O ----

def _file_crc(path: str) -> tuple[int, int]:
    """(crc32, size) of a file, streamed in chunks."""
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return crc, size


def _atomic_write(path: str, write_fn: Callable,
                  stats: Optional[dict] = None) -> tuple[int, int]:
    """Atomic durable write (same-dir temp file, fsync BEFORE
    ``os.replace``).  ``write_fn(fileobj)`` produces the bytes; returns
    the committed file's ``(crc32, size)``.  ``stats["crc_s"]``
    accumulates the CRC pass's time."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-", suffix=".part")
    try:
        with os.fdopen(fd, "w+b") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        t0 = time.perf_counter()
        crc, size = _file_crc(tmp)
        if stats is not None:
            stats["crc_s"] = stats.get("crc_s", 0.0) + (
                time.perf_counter() - t0)
        os.replace(tmp, path)
        return crc, size
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def write_npz_streaming(f, entries) -> int:
    """Write an ``.npz`` (numpy's own zip layout, uncompressed) from
    ``entries``, an iterable of ``(key, producer)`` whose ``producer()``
    returns the entry's array only when its turn comes, so one entry's
    bytes are resident at a time.  Returns the entries' payload bytes."""
    total = 0
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, producer in entries:
            arr = producer()
            total += arr.nbytes
            with zf.open(f"{key}.npy", "w", force_zip64=True) as out:
                np.lib.format.write_array(out, arr, allow_pickle=False)
            del arr
    return total


def fsync_dir(path: str) -> None:
    """Make a directory's entries (a rename into it) durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class StreamingCheckpointer:
    """Shard-wise crash-consistent checkpoint under ``directory``.

    Layout: one ``gen_<step>`` directory per generation holding
    ``shard_<j>.npz`` files (raw uint8 slice buffers keyed ``l<leaf>``),
    ``history.json``, and the commit-marker ``manifest.json`` written
    LAST.  A directory without a valid manifest is an uncommitted
    generation and is invisible to restore.

    ``last_save_stats`` and ``last_restore_stats`` describe the last save
    and restore: seconds, payload bytes, shard files and (save) the CRC
    pass's seconds."""

    @classmethod
    def for_run(cls, run_config) -> "StreamingCheckpointer":
        if not run_config.checkpoint_dir:
            raise ValueError("config.run.checkpoint_dir is not set")
        return cls(run_config.checkpoint_dir)

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.last_restore_digest: Optional[str] = None
        # reason -> count for THIS process (the resume event surfaces it;
        # the registry counter carries the labelled totals).
        self.generations_discarded: dict[str, int] = {}
        self.last_save_stats: dict = {}
        self.last_restore_stats: dict = {}

    # ------------------------------------------------------------- save --
    def _gen_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"gen_{step:08d}")

    def _generations(self) -> list[tuple[int, str]]:
        """All ``gen_*`` dirs as ``(step, path)``, newest first."""
        out = []
        try:
            entries = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        for name in entries:
            m = _GEN_RE.match(name)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.directory, name)))
        out.sort(reverse=True)
        return out

    def save(self, step: int, server_state: Any, history: list[dict]) -> None:
        """Stream ``server_state`` shard file by shard file into generation
        ``step``;
        the manifest commit is the LAST durable write.  A save the fault
        plane aborts (``stale_manifest``) leaves the generation
        uncommitted and counts ``ckpt.save_aborted_total``."""
        from colearn_federated_learning_tpu_torch.faults import fileplane

        t0 = time.perf_counter()
        reg = _metrics.get_registry()
        gen = self._gen_dir(step)
        if os.path.isdir(gen):       # re-save of a step: start clean
            shutil.rmtree(gen)
        os.makedirs(gen)

        flat = flatten_state(server_state)
        leaves: list[dict] = []
        plans: list[list] = []       # per leaf: its distinct shards
        avoided = 0
        for path, leaf in flat:
            shape, entry, _ = _leaf_meta(leaf)
            leaves.append({"path": path, "shape": list(shape),
                           "dtype": entry, "slices": []})
            plans.append(_leaf_shards(leaf))
            avoided += leaf_gather_avoided(leaf)
        if avoided:
            reg.counter("comm.gather_bytes_avoided_total").inc(avoided)
        n_shards = max([1] + [len(p) for p in plans])
        stats: dict = {"crc_s": 0.0}
        files: dict[str, dict] = {}
        nbytes = 0
        for j in range(n_shards):
            fname = f"shard_{j:05d}.npz"
            fpath = os.path.join(gen, fname)
            fileplane.ckpt_slow_io(j, step, "shard")
            entries = []
            for i, shards in enumerate(plans):
                if j >= len(shards):
                    continue
                starts, stops, part = shards[j]
                key = f"l{i:05d}"
                leaves[i]["slices"].append({"file": fname, "key": key,
                                            "start": starts, "stop": stops})
                entries.append((key, lambda part=part: _host_bytes(part)))

            def write(f, entries=entries):
                nonlocal nbytes
                nbytes += write_npz_streaming(f, entries)

            crc, size = _atomic_write(fpath, write, stats)
            fileplane.ckpt_torn_shard(fpath, j, step)
            files[fname] = {"crc": crc, "size": size}
            reg.counter("ckpt.shards_written_total").inc()

        fileplane.ckpt_slow_io(-1, step, "history")
        hist_bytes = json.dumps(history).encode()
        crc, size = _atomic_write(
            os.path.join(gen, HISTORY), lambda f: f.write(hist_bytes), stats)
        files[HISTORY] = {"crc": crc, "size": size}

        if fileplane.ckpt_stale_manifest(step):
            # The shard files exist but the generation never commits: what
            # a kill between the last shard fsync and the manifest replace
            # leaves.
            reg.counter("ckpt.save_aborted_total").inc()
            return
        fileplane.ckpt_slow_io(-1, step, "manifest")
        manifest = {"format": 1, "step": int(step),
                    "saved_shards": int(n_shards),
                    "leaves": leaves, "files": files}
        man_bytes = json.dumps(manifest, separators=(",", ":")).encode()
        _atomic_write(os.path.join(gen, MANIFEST),
                      lambda f: f.write(man_bytes), stats)
        self._prune(step)
        dt = time.perf_counter() - t0
        self.last_save_stats = {"save_s": dt, "bytes": nbytes,
                                "shards": n_shards,
                                "crc_s": stats["crc_s"]}
        reg.counter("ckpt.saves_total").inc()
        reg.histogram("ckpt.save_s").observe(dt)

    def _prune(self, committed_step: int) -> None:
        """Keep the newest ``max_to_keep`` committed generations; drop
        everything else BELOW the fresh commit (an uncommitted dir above
        it would be a concurrent writer's: leave it alone)."""
        kept = 0
        for step, path in self._generations():
            if step > committed_step:
                continue
            committed = os.path.exists(os.path.join(path, MANIFEST))
            if committed and kept < self.max_to_keep:
                kept += 1
                continue
            shutil.rmtree(path, ignore_errors=True)

    # ---------------------------------------------------------- restore --
    def _validate(self, gen: str) -> tuple[Optional[dict], Optional[str]]:
        """(manifest, None) for a complete generation, else (None, reason)."""
        mpath = os.path.join(gen, MANIFEST)
        if not os.path.exists(mpath):
            return None, R_MISSING_MANIFEST
        try:
            with open(mpath, encoding="utf-8") as f:
                manifest = json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError, OSError):
            return None, R_TORN_MANIFEST
        if not isinstance(manifest, dict) or "files" not in manifest:
            return None, R_TORN_MANIFEST
        for fname, rec in manifest["files"].items():
            fpath = os.path.join(gen, fname)
            if not os.path.exists(fpath):
                return None, R_MISSING_SHARD
            crc, size = _file_crc(fpath)
            if size != rec["size"]:
                return None, R_TORN_SHARD
            if crc != rec["crc"]:
                return None, R_CRC_MISMATCH
        return manifest, None

    def _latest_valid(self, step: Optional[int] = None
                      ) -> tuple[int, str, dict]:
        """Newest fully committed generation (``step`` when given),
        discarding, with labelled counts, every torn one on the way."""
        reg = _metrics.get_registry()
        for gstep, gen in self._generations():
            if step is not None and gstep != step:
                continue
            manifest, reason = self._validate(gen)
            if manifest is not None:
                return gstep, gen, manifest
            reg.counter("ckpt.generations_discarded_total",
                        labels={"reason": reason}).inc()
            self.generations_discarded[reason] = (
                self.generations_discarded.get(reason, 0) + 1)
        raise FileNotFoundError(
            f"no restorable checkpoint generation under {self.directory}")

    def latest_step(self) -> Optional[int]:
        try:
            step, _, _ = self._latest_valid()
        except FileNotFoundError:
            return None
        return step

    def restore(self, target_state: Any, step: Optional[int] = None):
        """Restore into the structure of ``target_state``, each leaf on its
        template leaf's device.  Returns ``(server_state, history,
        step)``."""
        t0 = time.perf_counter()
        reg = _metrics.get_registry()
        gstep, gen, manifest = self._latest_valid(step)

        with open(os.path.join(gen, HISTORY), encoding="utf-8") as f:
            history = json.load(f)

        flat = flatten_state(target_state)
        if len(flat) != len(manifest["leaves"]):
            raise ValueError(
                f"checkpoint generation {gstep} holds "
                f"{len(manifest['leaves'])} leaves; restore template has "
                f"{len(flat)}")
        digest = hashlib.sha256()
        resharded = False
        nbytes = 0
        out = []
        with _Readers(gen) as readers:
            for (_, tmpl), rec in zip(flat, manifest["leaves"]):
                shape = tuple(rec["shape"])
                tshape = _leaf_meta(tmpl)[0]
                if shape != tshape:
                    raise ValueError(
                        f"leaf {rec['path']!r}: saved shape {shape} != "
                        f"template shape {tshape}")
                buf, view, name = readers.assemble(rec)
                _digest_update(digest, name, shape, buf)
                nbytes += buf.nbytes
                out.append(_place(tmpl, buf, view))
                saved_n = len(rec["slices"])
                tmpl_n = (len(tmpl.parts) if isinstance(tmpl, ShardedTensor)
                          else 1)
                if saved_n != tmpl_n and (saved_n > 1 or tmpl_n > 1):
                    resharded = True
        if resharded:
            reg.counter("ckpt.resharded_resumes_total").inc()
        self.last_restore_digest = digest.hexdigest()
        dt = time.perf_counter() - t0
        self.last_restore_stats = {"restore_s": dt, "bytes": nbytes,
                                   "shards": len(manifest["files"]) - 1}
        reg.counter("ckpt.restores_total").inc()
        reg.histogram("ckpt.restore_s").observe(dt)
        return unflatten_state(target_state, iter(out)), history, gstep

    def close(self) -> None:
        pass


class _Readers:
    """The generation's shard files, opened once each, and the assembly
    of one leaf from its saved slices."""

    def __init__(self, gen: str):
        self.gen = gen
        self.files: dict[str, Any] = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for r in self.files.values():
            r.close()

    def assemble(self, rec: dict) -> tuple[np.ndarray, Any, str]:
        """One leaf's full host buffer (storage dtype), its torch view
        dtype and its dtype name."""
        shape = tuple(rec["shape"])
        dtype, view, name = _storage(rec["dtype"])
        buf = np.empty(shape, dtype)
        for sl in rec["slices"]:
            if sl["file"] not in self.files:
                self.files[sl["file"]] = np.load(
                    os.path.join(self.gen, sl["file"]))
            raw = self.files[sl["file"]][sl["key"]]
            sub = tuple(slice(a, b) for a, b in zip(sl["start"], sl["stop"]))
            sub_shape = tuple(b - a for a, b in zip(sl["start"], sl["stop"]))
            buf[sub] = raw.view(dtype).reshape(sub_shape)
        return buf, view, name


# ----------------------------------------------------- harness-side loads --

def load_generation_host(directory: str, step: Optional[int] = None
                         ) -> tuple[dict, int, str]:
    """Template-free load of the newest committed generation: ``(leaf
    path -> full CPU tensor, step, digest)``, one leaf assembled at a
    time.  The digest is :attr:`StreamingCheckpointer.last_restore_digest`
    for the same generation (and JAX's ``load_generation_host``'s)."""
    ckpt = StreamingCheckpointer(directory)
    gstep, gen, manifest = ckpt._latest_valid(step)
    digest = hashlib.sha256()
    out: dict[str, torch.Tensor] = {}
    with _Readers(gen) as readers:
        for rec in manifest["leaves"]:
            buf, view, name = readers.assemble(rec)
            _digest_update(digest, name, tuple(rec["shape"]), buf)
            out[rec["path"]] = _as_tensor(buf, view)
    return out, gstep, digest.hexdigest()
