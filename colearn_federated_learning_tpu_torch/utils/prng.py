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


def derive_seed(seed: int, tag: int, *ids: int) -> int:
    """63-bit seed for (seed, tag, ids...) — a stable hash, identical on
    every platform and Python version."""
    text = ",".join(str(int(v)) for v in (seed, tag, *ids))
    digest = hashlib.blake2b(text.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def generator(seed: int, tag: int, *ids: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(derive_seed(seed, tag, *ids))
    return g


def init_generator(seed: int) -> torch.Generator:
    """Model-initialization draws."""
    return generator(seed, TAG_INIT)


def client_round_generator(seed: int, client_id: int,
                           round_idx: int) -> torch.Generator:
    """One client's local-training draws (batch indices) in one round."""
    return generator(seed, TAG_LOCAL, client_id, round_idx)


def sampling_generator(seed: int, round_idx: int) -> torch.Generator:
    """The coordinator's cohort sampling in one round."""
    return generator(seed, TAG_SAMPLE, round_idx)


def straggler_generator(seed: int, round_idx: int,
                        client_id: int) -> torch.Generator:
    """One client's simulated straggler budget in one round."""
    return generator(seed, TAG_STRAGGLER, round_idx, client_id)
