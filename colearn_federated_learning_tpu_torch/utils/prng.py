"""Deterministic per-purpose ``torch.Generator`` derivation.

Every random draw of the port comes from a generator seeded by a hash of
(experiment seed, purpose tag, ids...), with the same purpose tags as the
JAX package's ``utils/prng.py``.  A client's draws in a round therefore do
not depend on which other clients ran or in what order.  The bits are not
JAX's: tests that compare the two packages hand both the same draws.
"""

from __future__ import annotations

import hashlib

import torch

# Stable tags so different purposes can never collide even for the same
# (client, round) pair.
TAG_LOCAL = 0x1
TAG_SAMPLE = 0x2
TAG_DP = 0x3
TAG_MASK = 0x4
TAG_STRAGGLER = 0x5
TAG_INIT = 0x6
TAG_DATA = 0x7
TAG_MASK_RING = 0x8
TAG_CLIP_BIT = 0x9
# The LoRA A-factor init (the JAX package's ``fed/setup._LORA_INIT_TAG``).
TAG_LORA_INIT = 0x10AA


def derive_seed(seed: int, tag: int, *ids: int) -> int:
    """63-bit seed for (seed, tag, ids...) — a stable hash, identical on
    every platform and Python version."""
    text = ",".join(str(int(v)) for v in (seed, tag, *ids))
    digest = hashlib.blake2b(text.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def generator(seed: int, tag: int, *ids: int, device=None) -> torch.Generator:
    """A generator for (seed, tag, ids...) on ``device`` (the host by
    default).  Noise and masks for a card's tensors are drawn by a
    generator on that card, never on the host and copied over."""
    g = torch.Generator(device=device or "cpu")
    g.manual_seed(derive_seed(seed, tag, *ids))
    return g


def init_generator(seed: int) -> torch.Generator:
    """Model-initialization draws."""
    return generator(seed, TAG_INIT)


def lora_init_generator(seed: int) -> torch.Generator:
    """The LoRA A factors' init draws (on the host, so every device type
    starts from the same factors)."""
    return generator(seed, TAG_LORA_INIT)


def client_round_generator(seed: int, client_id: int,
                           round_idx: int) -> torch.Generator:
    """One client's local-training draws (batch indices) in one round."""
    return generator(seed, TAG_LOCAL, client_id, round_idx)


def sampling_generator(seed: int, round_idx: int) -> torch.Generator:
    """The coordinator's cohort sampling in one round."""
    return generator(seed, TAG_SAMPLE, round_idx)


def device_sampling_generator(seed: int, round_idx: int,
                              dev: int) -> torch.Generator:
    """The cohort sampling of one client-mesh device in one round (the
    JAX mesh round's ``fold_in(sampling_key, dev)``)."""
    return generator(seed, TAG_SAMPLE, round_idx, dev)


def straggler_generator(seed: int, round_idx: int,
                        client_id: int) -> torch.Generator:
    """One client's simulated straggler budget in one round."""
    return generator(seed, TAG_STRAGGLER, round_idx, client_id)


def dp_generator(seed: int, client_id: int, round_idx: int,
                 device=None) -> torch.Generator:
    """One client's DP noise in one round, drawn tensor by tensor in the
    model's parameter order."""
    return generator(seed, TAG_DP, client_id, round_idx, device=device)


def pair_mask_generator(seed: int, a: int, b: int, round_idx: int,
                        device=None, stream: int = 0) -> torch.Generator:
    """The secure-aggregation mask that clients ``a`` and ``b`` share in
    one round, symmetric in ``(a, b)`` so both members of the pair expand
    the identical stream.  ``stream`` 1 is the adaptive-clipping bit's own
    mask, apart from the update's (stream 0)."""
    lo, hi = min(int(a), int(b)), max(int(a), int(b))
    return generator(seed, TAG_MASK, lo, hi, round_idx, stream,
                     device=device)


def ring_generator(seed: int, round_idx: int) -> torch.Generator:
    """The secure-aggregation ring permutation of one round (on the host:
    one score per cohort member)."""
    return generator(seed, TAG_MASK_RING, round_idx)


def clip_bit_generator(seed: int, round_idx: int,
                       device=None) -> torch.Generator:
    """The noise on the adaptive-clipping bit sum in one round."""
    return generator(seed, TAG_CLIP_BIT, round_idx, device=device)
