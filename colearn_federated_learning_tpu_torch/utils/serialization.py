"""Pytree serialization for the cross-silo file/wire planes.

A copy of the JAX package's ``utils/serialization.py`` (numpy only), so a
file or frame written by either package is read by the other
(``tests/test_torch_port_guards.py`` holds the two to the same bytes).

The reference moves model state between processes as pickled PySyft tensors
over websockets (SURVEY.md §1 "Communication").  The rebuild uses two
self-describing formats with one decoder:

- FILES (``colearn init/train --role client/aggregate``): plain ``.npz`` —
  each leaf under its ``/``-joined tree path plus ``__meta__`` JSON.
  mmap-friendly, loadable by anything that reads npz.
- WIRE (comm/transport.py): ``CLW1`` flat frames — JSON leaf directory +
  concatenated raw buffers + crc32.  No zip container overhead, single
  contiguous payload, integrity-checked.

``bytes_to_pytree`` auto-detects the format, so a silo can hand a wire
payload to the file flow (or vice versa) without caring which produced it.
"""

from __future__ import annotations

import io
import json
import os
import struct
import tempfile
import zlib
from typing import Any

import numpy as np

_META = "__meta__"
_WIRE_MAGIC = b"CLW1"
_WIRE_HLEN = struct.Struct(">I")
_WIRE_PAY = struct.Struct(">QI")      # payload length, crc32


def _dtype_entry(dtype: np.dtype) -> dict:
    """Leaf-directory dtype slots.  ``dtype.str`` is authoritative for
    every builtin dtype, but ml_dtypes extension types (bfloat16,
    float8_*) all stringify as raw void bytes (``'<V2'``) — decoding that
    silently reinterprets the payload.  Those get an explicit dtype-NAME
    slot (``"n"``) the decoder resolves by name instead."""
    entry = {"d": dtype.str}
    if np.dtype(dtype.str) != dtype:
        entry["n"] = dtype.name
    return entry


def _resolve_dtype(entry: dict) -> np.dtype:
    name = entry.get("n")
    if name is None:
        return np.dtype(entry["d"])
    try:
        return np.dtype(name)
    except TypeError:
        # Extension dtypes register with numpy on import; a decoder
        # process that never touched jax/ml_dtypes needs the import first.
        import ml_dtypes  # noqa: F401

        return np.dtype(name)


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            if "/" in str(k):
                raise ValueError(f"key {k!r} contains the path separator '/'")
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        # np.asarray would silently STACK a list of leaves into one array and
        # the round trip would change tree structure; refuse loudly instead.
        # (The wire format is dict-of-arrays; index lists/tuples by position.)
        raise TypeError(
            f"cannot serialize {type(tree).__name__} node at {prefix or '/'!r}: "
            "convert to a dict with string keys first"
        )
    out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> Any:
    tree: dict = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


_NPZ_DTYPES = "__dtypes__"


def save_pytree_npz(path_or_file, tree: Any, meta: dict | None = None) -> None:
    flat = _flatten(tree)
    # npz stores extension dtypes (bfloat16, ...) as raw void bytes with no
    # way back; ship those leaves as flat byte views plus a (name, shape)
    # map the loader re-views through (same pitfall as the CLW1 "n" slot).
    views = {}
    names = {}
    for p, a in flat.items():
        if np.dtype(a.dtype.str) != a.dtype:
            names[p] = [a.dtype.name, list(a.shape)]
            views[p] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        else:
            views[p] = a
    views[_META] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8
    ).copy()
    if names:
        views[_NPZ_DTYPES] = np.frombuffer(
            json.dumps(names).encode(), dtype=np.uint8
        ).copy()
    np.savez(path_or_file, **views)


def atomic_save_pytree_npz(path: str, tree: Any,
                           meta: dict | None = None) -> None:
    """Crash-safe :func:`save_pytree_npz`: write to a same-directory temp
    file, fsync, then ``os.replace`` — a reader never observes a torn
    npz, only the old file or the new one.  The temp file is opened as a
    file OBJECT because ``np.savez`` silently appends ``.npz`` to bare
    paths, which would break the replace."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-", suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            save_pytree_npz(f, tree, meta)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_pytree_npz(path_or_file) -> tuple[Any, dict]:
    z = np.load(path_or_file)
    meta = json.loads(bytes(z[_META]).decode()) if _META in z.files else {}
    names = (json.loads(bytes(z[_NPZ_DTYPES]).decode())
             if _NPZ_DTYPES in z.files else {})
    flat = {}
    for k in z.files:
        if k in (_META, _NPZ_DTYPES):
            continue
        arr = z[k]
        if k in names:
            name, shape = names[k]
            arr = arr.view(_resolve_dtype({"n": name})).reshape(shape)
        flat[k] = arr
    return _unflatten(flat), meta


def pytree_to_bytes(tree: Any, meta: dict | None = None) -> bytearray:
    """Encode as a ``CLW1`` wire frame (the transport's format)."""
    flat = {p: np.ascontiguousarray(a) for p, a in _flatten(tree).items()}
    entries = [{"p": p, "s": list(a.shape), **_dtype_entry(a.dtype)}
               for p, a in flat.items()]
    header = json.dumps({"leaves": entries, "meta": meta or {}},
                        separators=(",", ":")).encode()
    plen = sum(a.nbytes for a in flat.values())
    # Single allocation, single copy: frame assembled in place, each leaf
    # copied straight into its payload slot.
    out = bytearray(len(_WIRE_MAGIC) + _WIRE_HLEN.size + len(header)
                    + _WIRE_PAY.size + plen)
    off = 0
    out[off:off + len(_WIRE_MAGIC)] = _WIRE_MAGIC
    off += len(_WIRE_MAGIC)
    _WIRE_HLEN.pack_into(out, off, len(header))
    off += _WIRE_HLEN.size
    out[off:off + len(header)] = header
    off += len(header)
    pay_hdr_off = off
    off += _WIRE_PAY.size
    pay_start = off
    for a in flat.values():
        n = a.nbytes
        if n:
            np.frombuffer(out, dtype=a.dtype, count=a.size, offset=off)[
                :
            ] = a.reshape(-1)
        off += n
    crc = zlib.crc32(memoryview(out)[pay_start:])
    _WIRE_PAY.pack_into(out, pay_hdr_off, plen, crc)
    return out                        # bytes-like; avoids a full-frame copy


def wire_frame_length(tree: Any, meta: dict | None = None) -> int:
    """Exact length of the ``CLW1`` frame :func:`pytree_to_bytes` would
    produce, WITHOUT building it — header JSON only, no payload copy.
    Lets the downlink compressor report true bytes-saved (frame vs frame,
    not raw-leaf-bytes vs frame) at negligible cost."""
    flat = _flatten(tree)
    entries = [{"p": p, "s": list(a.shape) or [1], **_dtype_entry(a.dtype)}
               for p, a in flat.items()]   # `or [1]`: 0-d leaves encode (1,)
    header = json.dumps({"leaves": entries, "meta": meta or {}},
                        separators=(",", ":")).encode()
    return (len(_WIRE_MAGIC) + _WIRE_HLEN.size + len(header)
            + _WIRE_PAY.size + sum(a.nbytes for a in flat.values()))


def _wire_to_pytree(data: bytes) -> tuple[Any, dict]:
    off = len(_WIRE_MAGIC)
    (hlen,) = _WIRE_HLEN.unpack_from(data, off)
    off += _WIRE_HLEN.size
    header = json.loads(data[off:off + hlen].decode())
    off += hlen
    plen, crc = _WIRE_PAY.unpack_from(data, off)
    off += _WIRE_PAY.size
    payload = memoryview(data)[off:off + plen]
    if zlib.crc32(payload) != crc:
        raise ValueError("wire payload failed crc32 integrity check")
    flat: dict[str, np.ndarray] = {}
    pos = 0
    for e in header["leaves"]:
        dtype = _resolve_dtype(e)
        shape = tuple(e["s"])
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        # copy() detaches each leaf from the big frame buffer (and makes it
        # writable); leaves are consumed as independent arrays downstream.
        flat[e["p"]] = np.frombuffer(
            payload[pos:pos + n], dtype=dtype
        ).reshape(shape).copy()
        pos += n
    if pos != plen:
        raise ValueError(f"wire payload size mismatch: {pos} != {plen}")
    return _unflatten(flat), header.get("meta", {})


def bytes_to_pytree(data: bytes) -> tuple[Any, dict]:
    """Decode either format (CLW1 wire frame or npz), auto-detected."""
    if data[: len(_WIRE_MAGIC)] == _WIRE_MAGIC:
        return _wire_to_pytree(data)
    return load_pytree_npz(io.BytesIO(data))
