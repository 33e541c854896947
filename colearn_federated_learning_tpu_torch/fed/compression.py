"""Update compression for the file and wire planes.

The counterpart of the JAX package's ``fed/compression.py``: the same
codecs, producing the same frames byte for byte, over the port's trees
(nested dicts of numpy arrays in the flax layout, ``utils/trees.py``).
Deltas are compressed, not params.

- ``int8``: per-leaf symmetric linear quantization, each leaf replaced by
  ``{"q": int8[...], "s": float32 scale}``.
- ``topk``: per-leaf magnitude sparsification, the largest
  ``topk_fraction`` of the entries (at least one) as ``{"i": int32
  indices (ascending), "v": float32 values, "n": int64 size}``.
- ``topk8``: a topk frame with int8 values and the per-leaf dequant scale
  (``{"i", "v": int8[k], "n", "s"}``).
- ``none``: passthrough.

Topk frames are the server fold's sparse-native format
(``comm/aggregation.py``); :func:`topk_leaf_raw` hands the fold kernel
topk8 values undecoded.  :func:`feedback_compress` carries what the codec
dropped into the next round (error feedback, EF-SGD).

The device of the leaves decides the route.  Numpy leaves are selected on
the host.  Tensor leaves under a topk scheme are selected on their device
by ``ops/topk.py`` (N1: the kernel on a card, with no fallback; its plain
version on the CPU), every leaf into one buffer in one call per delta, so
only the ``k`` indices and values of the tree cross to the host, in one
copy each; the topk8 levels are computed there, over the ``k`` values.  Under feedback the
compensated delta, its decode and the new residual stay on the device.
The other schemes take tensor leaves to the host first.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from colearn_federated_learning_tpu_torch.ops import topk as topk_op
from colearn_federated_learning_tpu_torch.utils import trees

SCHEMES = ("none", "int8", "topk", "topk8")
_Q, _S = "q", "s"
_I, _V, _N = "i", "v", "n"
TOPK_FRACTION = 0.05
TOPK_SCHEMES = ("topk", "topk8")


def _is_qleaf(node: Any) -> bool:
    return isinstance(node, dict) and set(node) == {_Q, _S}


def _is_kleaf(node: Any) -> bool:
    return isinstance(node, dict) and set(node) == {_I, _V, _N}


def _is_k8leaf(node: Any) -> bool:
    return isinstance(node, dict) and set(node) == {_I, _V, _N, _S}


def _is_tensor_tree(tree: Any) -> bool:
    return any(isinstance(l, torch.Tensor) for l in trees.leaves(tree))


def host_tree(tree: Any) -> Any:
    """``tree`` with its tensor leaves as float32 host arrays (numpy leaves
    as they are)."""
    return trees.map_leaves(
        lambda l: (l.detach().to(torch.float32).cpu().numpy()
                   if isinstance(l, torch.Tensor) else l), tree)


def topk_abs(flat, k: int) -> tuple:
    """Indices (ascending, int32) and values of the ``k`` largest-|x|
    entries of a 1-D float32 array or tensor, on its device (a tensor goes
    to ``ops/topk.py``).  Ties go to the lower index, as in the JAX
    package's native selector: the order is that of the key (magnitude
    bits, then the index reversed), which is unique."""
    if isinstance(flat, torch.Tensor):
        return topk_op.topk_abs(flat.detach().reshape(-1).to(torch.float32),
                                k)
    flat = np.ascontiguousarray(flat, dtype=np.float32).ravel()
    k = int(k)
    if not 0 < k <= flat.size:
        raise ValueError(f"k={k} out of range for size {flat.size}")
    mag = (flat.view(np.uint32) & np.uint32(0x7FFFFFFF)).astype(np.uint64)
    key = (mag << np.uint64(32)) | (np.uint64(0xFFFFFFFF)
                                   - np.arange(flat.size, dtype=np.uint64))
    idx = np.sort(np.argpartition(key, flat.size - k)[flat.size - k:])
    idx = idx.astype(np.int32)
    return idx, flat[idx]


def _quantize(arr: np.ndarray) -> tuple[np.ndarray, float]:
    """Symmetric int8 levels of ``arr`` and their scale max|x| / 127."""
    scale = float(np.max(np.abs(arr))) / 127.0 if arr.size else 0.0
    if scale == 0.0:
        return np.zeros(arr.shape, np.int8), scale
    return np.clip(np.rint(arr / scale), -127, 127).astype(np.int8), scale


def topk_leaf_arrays(node: Any) -> tuple[np.ndarray, np.ndarray, int]:
    """One topk/topk8 wire leaf as ``(indices, float32 values, size)``;
    topk8 values are decoded here (int8 times the per-leaf scale)."""
    if _is_k8leaf(node):
        n = int(np.asarray(node[_N]).ravel()[0])
        vals = (np.asarray(node[_V], np.float32)
                * np.float32(np.asarray(node[_S]).ravel()[0]))
        return np.asarray(node[_I]), vals, n
    if not _is_kleaf(node):
        raise TypeError(f"unexpected node {type(node).__name__} in topk tree")
    n = int(np.asarray(node[_N]).ravel()[0])
    return np.asarray(node[_I]), np.asarray(node[_V], np.float32), n


def topk_leaf_raw(node: Any) -> tuple[np.ndarray, np.ndarray, np.float32, int]:
    """One topk/topk8 wire leaf as ``(indices, RAW values, scale, size)``
    for the fold kernel: topk8 values stay int8, so the kernel applies
    ``(value * scale) * weight`` itself; topk values come with scale 1.0."""
    if _is_k8leaf(node):
        n = int(np.asarray(node[_N]).ravel()[0])
        return (np.asarray(node[_I]), np.asarray(node[_V], np.int8),
                np.float32(np.asarray(node[_S]).ravel()[0]), n)
    if not _is_kleaf(node):
        raise TypeError(f"unexpected node {type(node).__name__} in topk tree")
    n = int(np.asarray(node[_N]).ravel()[0])
    return (np.asarray(node[_I]), np.asarray(node[_V], np.float32),
            np.float32(1.0), n)


def _keep(n: int, frac: float) -> int:
    """Entries a topk frame keeps of a leaf of ``n``: at least one, so tiny
    biases and scalars survive."""
    return max(1, int(math.ceil(n * frac)))


def _topk_frame(idx: np.ndarray, val: np.ndarray, n: int,
                quantize: bool) -> dict:
    if not quantize:
        return {_I: idx, _V: val, _N: np.int64(n)}
    q, scale = _quantize(val)
    return {_I: idx, _V: q, _N: np.int64(n), _S: np.float32(scale)}


def compress_delta(
    delta: Any, scheme: str, *, topk_fraction: float | None = None
) -> tuple[Any, dict]:
    """``(wire_tree, meta_fields)`` for ``delta`` under ``scheme``;
    ``topk_fraction`` overrides the topk schemes' keep density.  The wire
    tree holds host arrays, whatever the leaves' device."""
    if _is_tensor_tree(delta):
        if scheme in TOPK_SCHEMES:
            return _compress_tensors(delta, scheme, topk_fraction)[:2]
        delta = host_tree(delta)
    if scheme == "none":
        return delta, {"compress": "none"}
    if scheme == "int8":
        def q(leaf):
            qa, scale = _quantize(np.asarray(leaf, dtype=np.float32))
            return {_Q: qa, _S: np.float32(scale)}

        return trees.map_leaves(q, delta), {"compress": "int8"}
    if scheme in TOPK_SCHEMES:
        frac = TOPK_FRACTION if topk_fraction is None else float(topk_fraction)
        quantize = scheme == "topk8"

        def k_of(leaf):
            flat = np.asarray(leaf, np.float32).ravel()
            idx, val = topk_abs(flat, _keep(flat.size, frac))
            return _topk_frame(idx, val, flat.size, quantize)

        return trees.map_leaves(k_of, delta), {"compress": scheme}
    raise ValueError(f"unknown compression {scheme!r} (use {SCHEMES})")


def _compress_tensors(delta: Any, scheme: str,
                      topk_fraction: float | None) -> tuple:
    """A topk scheme over a tree of tensors: every leaf selected on its
    device into one buffer by one call of the selector, whose ``k``
    indices and values come to the host in one copy each.  ``(wire_tree,
    meta_fields, (ks, device idx, device values))``, the values decoded
    (topk8's levels times their float32 scale, as the host decodes
    them)."""
    frac = TOPK_FRACTION if topk_fraction is None else float(topk_fraction)
    quantize = scheme == "topk8"
    flats = [l.detach().reshape(-1).to(torch.float32)
             for l in trees.leaves(delta)]
    ks = [_keep(f.numel(), frac) for f in flats]
    dev = flats[0].device
    idx, val = topk_op.topk_abs_many(flats, ks)
    idx_h, val_h = idx.cpu().numpy(), val.cpu().numpy()
    bounds = np.cumsum([0] + ks)
    frames = [_topk_frame(idx_h[a:b], val_h[a:b], f.numel(), quantize)
              for f, a, b in zip(flats, bounds[:-1], bounds[1:])]
    if quantize:
        q = torch.from_numpy(np.concatenate([fr[_V] for fr in frames])).to(
            dev)
        scales = torch.from_numpy(np.array([fr[_S] for fr in frames],
                                           np.float32)).to(dev)
        val = q.to(torch.float32) * torch.repeat_interleave(
            scales, torch.tensor(ks, device=dev), output_size=len(q))
    return (trees.unflatten(delta, frames), {"compress": scheme},
            (ks, idx, val))


def compress_decode(delta: Any, scheme: str, *,
                    topk_fraction: float | None = None) -> tuple:
    """:func:`compress_delta` of a tree of tensors under a topk scheme,
    with the wire's decode (what :func:`decompress_delta` gives of it) as
    tensors on the leaves' device: ``(wire_tree, meta_fields, decoded)``."""
    wire, meta, (ks, idx, val) = _compress_tensors(delta, scheme,
                                                   topk_fraction)
    out, off = [], 0
    for leaf, k in zip(trees.leaves(delta), ks):
        dense = torch.zeros(leaf.numel(), dtype=torch.float32,
                            device=leaf.device)
        dense[idx[off:off + k].to(torch.int64)] = val[off:off + k]
        out.append(dense.view(leaf.shape))
        off += k
    return wire, meta, trees.unflatten(delta, out)


def decompress_delta(wire_tree: Any, meta: dict, shapes: Any = None) -> Any:
    """Inverse of :func:`compress_delta`.  ``shapes``, a tree of arrays
    such as the global params, is needed to restore topk leaves' shapes."""
    scheme = meta.get("compress", "none")
    if scheme == "none":
        return wire_tree
    if scheme == "int8":
        def walk(node):
            if _is_qleaf(node):
                return np.asarray(node[_Q], np.float32) * np.float32(node[_S])
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            raise TypeError(
                f"unexpected node {type(node).__name__} in int8 tree")

        return walk(wire_tree)
    if scheme in TOPK_SCHEMES:
        if shapes is None:
            raise ValueError("topk decompression needs the `shapes` pytree")

        def unk(node, ref):
            idx, vals, n = topk_leaf_arrays(node)
            flat = np.zeros(n, np.float32)
            flat[idx] = vals
            return flat.reshape(np.asarray(ref).shape)

        nodes = trees.flatten_up_to(shapes, wire_tree)
        return trees.unflatten(
            shapes, [unk(n, r) for n, r in zip(nodes, trees.leaves(shapes))])
    raise ValueError(f"unknown compression {scheme!r}")


def feedback_compress(
    delta: Any,
    residual: Any,
    scheme: str,
    *,
    topk_fraction: float | None = None,
) -> tuple[Any, dict, Any]:
    """Error-feedback compression: add the carried ``residual`` to
    ``delta``, compress, and return ``(wire_tree, meta_fields,
    new_residual)`` where the new residual is what the codec dropped
    (``None`` for the lossless ``none``).  Tensor leaves under a topk
    scheme keep the compensated delta, its decode and the new residual on
    their device (the residual a tree of tensors there, ``residual`` a
    tree of tensors or arrays); otherwise the work is on the host."""
    if _is_tensor_tree(delta) and scheme in TOPK_SCHEMES:
        return _feedback_tensors(delta, residual, scheme, topk_fraction)
    if _is_tensor_tree(delta):
        delta = host_tree(delta)
    if residual is not None and _is_tensor_tree(residual):
        residual = host_tree(residual)
    delta = trees.map_leaves(lambda l: np.asarray(l, np.float32), delta)
    if residual is not None:
        delta = trees.map_leaves(np.add, delta, residual)
    wire, meta = compress_delta(delta, scheme, topk_fraction=topk_fraction)
    if scheme == "none":
        return wire, meta, None
    recon = decompress_delta(wire, meta, shapes=delta)
    return wire, meta, trees.map_leaves(np.subtract, delta, recon)


def _feedback_tensors(delta: Any, residual: Any, scheme: str,
                      topk_fraction: float | None) -> tuple:
    """:func:`feedback_compress` on the leaves' device: the same float32
    sums and differences as the host's."""
    comp = trees.map_leaves(lambda l: l.detach().to(torch.float32), delta)
    if residual is not None:
        def add(d, r):
            r = torch.as_tensor(r, dtype=torch.float32, device=d.device)
            try:
                return d + r
            except RuntimeError as e:   # numpy's error for unfit shapes
                raise ValueError(f"residual does not fit the delta: {e}"
                                 ) from None

        comp = trees.map_leaves(add, comp, residual)
    wire, meta, decoded = compress_decode(comp, scheme,
                                          topk_fraction=topk_fraction)
    return wire, meta, trees.map_leaves(torch.sub, comp, decoded)
