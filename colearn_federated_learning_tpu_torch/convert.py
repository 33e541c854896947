"""Exact conversion between flax BERT params and the port's ``state_dict``.

Flax params are a nested dict of numpy arrays, as ``jax.device_get`` gives
them for the JAX package's ``BertClassifier``; the port's are a flat
``state_dict`` of ``BertClassifier``.  Both directions only transpose and
reshape, so a round trip is bit-exact:

- ``Dense`` kernels (in, out) <-> ``weight`` (out, in);
- ``DenseGeneral`` query/key/value kernels (D, H, hd) and biases (H, hd)
  <-> (H·hd, D) and (H·hd,); the ``out`` kernel (H, hd, D) <-> (D, H·hd);
- ``Embed.embedding`` <-> ``embed.weight``; ``pos_embed`` (1, max_len, D)
  as it is; ``LayerNorm.scale`` <-> ``weight``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _layer_map(depth: int) -> list[tuple[tuple[str, ...], str, str]]:
    """(flax path, torch prefix, kind) for every parameterised layer."""
    rows = [(("Embed_0",), "embed", "embed"),
            (("LayerNorm_0",), "ln_embed", "norm"),
            (("Dense_0",), "head", "dense")]
    for i in range(depth):
        blk, pre = f"TransformerBlock_{i}", f"blocks.{i}"
        mha = (blk, "MultiHeadAttention_0")
        rows += [(mha + (n,), f"{pre}.attn.{n}", "qkv")
                 for n in ("query", "key", "value")]
        rows += [(mha + ("out",), f"{pre}.attn.out", "attn_out"),
                 ((blk, "LayerNorm_0"), f"{pre}.ln1", "norm"),
                 ((blk, "Dense_0"), f"{pre}.mlp_in", "dense"),
                 ((blk, "Dense_1"), f"{pre}.mlp_out", "dense"),
                 ((blk, "LayerNorm_1"), f"{pre}.ln2", "norm")]
    return rows


def _depth(flax_params) -> int:
    return sum(1 for k in flax_params if k.startswith("TransformerBlock_"))


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def flax_to_state_dict(flax_params: Any) -> dict[str, torch.Tensor]:
    """flax BERT params -> the port's ``state_dict`` (CPU tensors)."""
    sd = {"pos_embed": np.asarray(flax_params["pos_embed"])}
    for path, pre, kind in _layer_map(_depth(flax_params)):
        layer = {k: np.asarray(v) for k, v in _get(flax_params, path).items()}
        if kind == "embed":
            sd[f"{pre}.weight"] = layer["embedding"]
        elif kind == "norm":
            sd[f"{pre}.weight"], sd[f"{pre}.bias"] = layer["scale"], layer["bias"]
        elif kind == "dense":
            sd[f"{pre}.weight"], sd[f"{pre}.bias"] = layer["kernel"].T, layer["bias"]
        elif kind == "qkv":
            D = layer["kernel"].shape[0]
            sd[f"{pre}.weight"] = layer["kernel"].reshape(D, -1).T
            sd[f"{pre}.bias"] = layer["bias"].reshape(-1)
        else:  # attn_out
            D = layer["kernel"].shape[-1]
            sd[f"{pre}.weight"] = layer["kernel"].reshape(-1, D).T
            sd[f"{pre}.bias"] = layer["bias"]
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def state_dict_to_flax(state_dict: dict[str, torch.Tensor],
                       num_heads: int) -> dict:
    """The port's ``state_dict`` -> flax BERT params (numpy arrays)."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    depth = 1 + max((int(k.split(".")[1]) for k in sd if k.startswith("blocks.")),
                    default=-1)
    out: dict = {"pos_embed": sd["pos_embed"]}
    for path, pre, kind in _layer_map(depth):
        w = sd[f"{pre}.weight"]
        if kind == "embed":
            layer = {"embedding": w}
        elif kind == "norm":
            layer = {"scale": w, "bias": sd[f"{pre}.bias"]}
        elif kind == "dense":
            layer = {"kernel": w.T, "bias": sd[f"{pre}.bias"]}
        elif kind == "qkv":
            D = w.shape[1]
            layer = {"kernel": w.T.reshape(D, num_heads, -1),
                     "bias": sd[f"{pre}.bias"].reshape(num_heads, -1)}
        else:  # attn_out
            D = w.shape[0]
            layer = {"kernel": w.T.reshape(num_heads, -1, D),
                     "bias": sd[f"{pre}.bias"]}
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = {k: np.ascontiguousarray(v) for k, v in layer.items()}
    return out
