"""Dropout-tolerant secure aggregation: the mask-recovery algebra of the
JAX package's ``privacy/dropout.py`` (Bonawitz et al., pattern only),
byte-equal to it for the same inputs, and the analytic cost of the masks.

The pairwise masks cancel only when every cohort member's masked update
reaches the sum; one dropped client leaves its partners' mask halves
orphaned.  The wire plane (``comm/coordinator.py``, ``comm/worker.py``)
recovers them each secure round with:

- Shamir t-of-n sharing over GF(2^521 − 1), so the coordinator can
  reconstruct a dead client's session secret, and with it every orphaned
  pair mask, from any ``t`` surviving shareholders;
- the double mask: a client's wire update is ``delta + pair masks +
  PRG(b_u)`` with a fresh self-mask seed ``b_u`` per round, so a
  coordinator that falsely reports a folded client dead still cannot
  unmask it; survivors reveal ``b_u`` shares for folded clients and
  session-secret shares for dead ones, never both for one (client, round);
- share encryption under a keystream from the pair's DH secret
  (``comm/keyexchange.py``), direction- and round-separated, so the
  coordinator relays bytes it cannot read;
- a commitment to each ``b_u``, so a corrupted reconstruction is caught.

Threshold: a client shares into ``n = |recovery set|`` shares and
recovery needs ``t = max(1, ceil(secure_agg_threshold · n))``; fewer is a
hard failure and the round is discarded.

This defeats a passive coordinator and tolerates crashes at any step.
Session DH keys mean reconstructing a dead client's session secret also
reveals its past pair keys; per-round key rotation is out of scope.
"""

from __future__ import annotations

import hashlib
import secrets

# 13th Mersenne prime: 2^521 − 1.  Big enough for the 512-bit DH
# exponents (comm/keyexchange.py) as single shares — no limb splitting.
PRIME = (1 << 521) - 1
SECRET_BYTES = 66                  # ceil(521 / 8): one field element
_SHARE_CONTEXT = b"colearn-sharewrap-v1"
_SELF_CONTEXT = b"colearn-selfmask-v1"

# One encrypted share payload: session-secret share ‖ self-mask share.
SHARE_PAYLOAD_BYTES = 2 * SECRET_BYTES


class RecoveryError(Exception):
    """Mask recovery cannot complete (insufficient or inconsistent
    shares); the round's aggregate must be discarded."""


def random_secret() -> int:
    """A fresh per-round self-mask seed b_u, uniform in the field."""
    while True:
        b = secrets.randbits(521)
        if 0 < b < PRIME:
            return b


def threshold_count(n_shares: int, fraction: float) -> int:
    """Shares required to reconstruct: ``max(1, ceil(fraction · n))``.
    ``0`` when there is nothing to share (a solo cohort has no recovery
    set — and, symmetrically, applies no self-mask)."""
    if n_shares <= 0:
        return 0
    if not 0.0 < fraction <= 1.0:
        raise ValueError(
            f"secure_agg_threshold must be in (0, 1], got {fraction}"
        )
    return max(1, -(-int(n_shares * fraction * 1e9) // 1_000_000_000))


def split_secret(secret: int, xs: list, t: int) -> dict:
    """Shamir split: ``{x: f(x)}`` for a uniform degree-``t−1`` polynomial
    with ``f(0) = secret``.  ``xs`` must be distinct and nonzero (callers
    use ``client_id + 1``)."""
    if not 0 <= secret < PRIME:
        raise ValueError("secret out of field range")
    if t < 1 or t > len(xs):
        raise ValueError(f"threshold {t} out of range for {len(xs)} shares")
    if len(set(xs)) != len(xs) or any(x == 0 for x in xs):
        raise ValueError("share x-coordinates must be distinct and nonzero")
    coeffs = [secret] + [secrets.randbelow(PRIME) for _ in range(t - 1)]
    out = {}
    for x in xs:
        acc = 0
        for c in reversed(coeffs):         # Horner
            acc = (acc * x + c) % PRIME
        out[int(x)] = acc
    return out


def reconstruct(shares: dict, t: int) -> int:
    """Lagrange interpolation at 0 from any ``t`` of the shares.
    Raises :class:`RecoveryError` below threshold."""
    if len(shares) < t or t < 1:
        raise RecoveryError(
            f"need {t} shares to reconstruct, have {len(shares)}"
        )
    pts = sorted(shares.items())[:t]
    total = 0
    for i, (xi, yi) in enumerate(pts):
        num, den = 1, 1
        for j, (xj, _) in enumerate(pts):
            if i == j:
                continue
            num = (num * (-xj)) % PRIME
            den = (den * (xi - xj)) % PRIME
        total = (total + yi * num * pow(den, -1, PRIME)) % PRIME
    return total


# ------------------------------------------------- share transport ------
def _stream(pair_secret: bytes, origin: int, dest: int, round_idx: int,
            n: int) -> bytes:
    """Keystream for one directed (origin → dest, round) share payload.
    Direction and round are baked into the key so the two directions of a
    pair — and every round — use independent streams."""
    key = hashlib.sha256(
        _SHARE_CONTEXT + pair_secret
        + int(origin).to_bytes(8, "big") + int(dest).to_bytes(8, "big")
        + int(round_idx).to_bytes(8, "big")
    ).digest()
    out = b""
    ctr = 0
    while len(out) < n:
        out += hashlib.sha256(key + ctr.to_bytes(4, "big")).digest()
        ctr += 1
    return out[:n]


def encrypt_share(pair_secret: bytes, origin: int, dest: int,
                  round_idx: int, s_share: int, b_share: int) -> str:
    """Hex ciphertext carrying (session-secret share, self-mask share)
    from ``origin`` to ``dest``, opaque to the relaying coordinator."""
    payload = (s_share.to_bytes(SECRET_BYTES, "big")
               + b_share.to_bytes(SECRET_BYTES, "big"))
    ks = _stream(pair_secret, origin, dest, round_idx, len(payload))
    return bytes(a ^ b for a, b in zip(payload, ks)).hex()


def decrypt_share(pair_secret: bytes, origin: int, dest: int,
                  round_idx: int, ciphertext: str) -> tuple:
    """(s_share, b_share) ints from :func:`encrypt_share` output."""
    raw = bytes.fromhex(ciphertext)
    if len(raw) != SHARE_PAYLOAD_BYTES:
        raise ValueError(
            f"share payload must be {SHARE_PAYLOAD_BYTES} bytes, "
            f"got {len(raw)}"
        )
    ks = _stream(pair_secret, origin, dest, round_idx, len(raw))
    payload = bytes(a ^ b for a, b in zip(raw, ks))
    return (int.from_bytes(payload[:SECRET_BYTES], "big"),
            int.from_bytes(payload[SECRET_BYTES:], "big"))


def commitment(secret: int) -> str:
    """Binding commitment to a self-mask seed, published alongside the
    shares so the coordinator can detect a corrupted reconstruction
    (wrong shares interpolate to SOME field element; the hash won't
    match) instead of silently subtracting a garbage self-mask."""
    return hashlib.sha256(
        _SELF_CONTEXT + secret.to_bytes(SECRET_BYTES, "big")
    ).hexdigest()


def self_mask_key(secret: int) -> int:
    """The 63-bit seed of a client's self-mask stream: the JAX package's
    uint32[2] key (the digest's first 8 bytes) without its lowest bit, as
    ``comm/keyexchange.pair_prng_key``.  Expanded by
    ``privacy/secure_agg.pairwise_mask_with_keys`` with sign +1."""
    digest = hashlib.sha256(
        _SELF_CONTEXT + b"key" + secret.to_bytes(SECRET_BYTES, "big")
    ).digest()
    return int.from_bytes(digest[:8], "big") >> 1


# ------------------------------------------------- cost model -----------
# Threefry-style counter PRG: ~16 integer ops per generated float32
# (conservative; the exact figure varies by backend).
PRG_FLOPS_PER_ELEM = 16


def mask_cost(cohort: int, param_count: int, neighbors: int = 0,
              group_size: int = 0) -> dict:
    """Analytic per-device masking cost under the DisAgg-style layering.

    ``group_size == 0`` is the flat cohort (masks span everyone);
    ``group_size = g`` is group-local secure aggregation on
    ``fed/hierarchical.py`` groups: each device's masks span only its
    group, so per-device work is O(group + neighbors) and the global cost
    is linear in the cohort, never O(cohort²).

    Returns per-device mask-PRG FLOPs (+1 stream for the self-mask),
    recovery-share bytes, and the flat-cohort quadratic total for the
    same cohort.
    """
    if cohort < 1 or param_count < 1:
        raise ValueError("cohort and param_count must be >= 1")
    local = min(group_size, cohort) if group_size > 0 else cohort
    degree = local - 1 if neighbors <= 0 else min(neighbors, local - 1)
    streams = degree + 1                  # pair masks + the self-mask
    flat_degree = cohort - 1 if neighbors <= 0 else min(neighbors,
                                                        cohort - 1)
    return {
        "mask_flops_per_device": float(streams * param_count
                                       * PRG_FLOPS_PER_ELEM),
        "share_bytes_per_device": float(degree * SHARE_PAYLOAD_BYTES),
        "pairs_per_device": int(degree),
        # What a flat all-cohort graph pays in total: the O(cohort²) term
        # group-local masking removes (reported for the ratio, not paid).
        "flat_pairs_total": int(cohort * flat_degree // 2),
        "grouped_pairs_total": int(cohort * degree // 2),
    }
