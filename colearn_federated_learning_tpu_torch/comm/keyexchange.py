"""Diffie-Hellman key agreement for the wire plane's secure aggregation
(the counterpart of the JAX package's ``comm/keyexchange.py``: the same
group, validation and ``shared_secret`` bytes).

Every worker generates an ephemeral keypair, publishes the public half on
its retained enrollment record (``comm/enrollment.py``), and derives each
pairwise mask's seed from the DH shared secret, which only the two pair
members can compute.  The coordinator sees public keys and masked updates
only.

Construction: finite-field DH over the RFC 3526 group-14 2048-bit MODP
prime (``pow(g, x, p)`` and SHA-256), 512-bit exponents.  The prime is
safe, so the only small-subgroup elements are {0, 1, p-1};
:func:`validate_public` rejects each by name, and the range.  Pair key:
SHA-256(secret ‖ context tag ‖ sorted pair ids); the JAX package reads
its first 8 bytes as a PRNG key, the port as the seed of the pair's
``torch.Generator`` stream (``privacy/secure_agg.pair_stream``), with the
round index derived in per round, so one exchange covers every round.

Trust model: this defeats a passive (honest-but-curious) coordinator.  An
attacker who controls the broker could substitute public keys (DH
man-in-the-middle); defeating that needs authenticated enrollment.
"""

from __future__ import annotations

import hashlib
import secrets

# RFC 3526 §3, group 14: 2048-bit MODP prime, generator 2.
GROUP14_P = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF",
    16,
)
GROUP14_G = 2

_CONTEXT = b"colearn-pairmask-v1"


def generate_keypair() -> tuple[int, int]:
    """(private, public) for one worker session; a 512-bit exponent with
    its top bit set."""
    priv = secrets.randbits(512) | (1 << 511)
    return priv, pow(GROUP14_G, priv, GROUP14_P)


class InvalidPublicKeyError(ValueError):
    """A peer published a degenerate or out-of-range DH public value;
    ``reason`` names which."""

    def __init__(self, reason: str):
        self.reason = reason
        super().__init__(f"invalid DH public key ({reason})")


def _reject(reason: str) -> InvalidPublicKeyError:
    from colearn_federated_learning_tpu_torch import telemetry

    telemetry.get_registry().counter(
        "comm.keyexchange_rejected_total", labels={"reason": reason}).inc()
    return InvalidPublicKeyError(reason)


def validate_public(pub: int) -> int:
    """Reject the small-subgroup elements {0, 1, p-1} by name, and any
    value out of range: a peer publishing one would force the pair's
    secret into a guessable set.  Each refusal counts in
    ``comm.keyexchange_rejected_total`` by reason."""
    pub = int(pub)
    if pub == 0:
        raise _reject("zero")
    if pub == 1:
        raise _reject("identity")
    if pub == GROUP14_P - 1:
        raise _reject("order_two")
    if not 1 < pub < GROUP14_P - 1:
        raise _reject("out_of_range")
    return pub


def shared_secret(priv: int, pub_other: int) -> bytes:
    """32-byte shared secret of one pair (the hash fixes the length and
    breaks the algebraic structure of the raw DH value)."""
    validate_public(pub_other)
    z = pow(pub_other, priv, GROUP14_P)
    return hashlib.sha256(z.to_bytes(256, "big")).digest()


def pair_digest(secret: bytes, id_a: int, id_b: int) -> bytes:
    """SHA-256 of the pair's context; symmetric in (id_a, id_b).  Its
    first 8 bytes are the JAX package's uint32[2] pair key."""
    lo, hi = sorted((int(id_a), int(id_b)))
    return hashlib.sha256(
        _CONTEXT + secret + lo.to_bytes(8, "big") + hi.to_bytes(8, "big")
    ).digest()


def pair_prng_key(secret: bytes, id_a: int, id_b: int) -> int:
    """The 63-bit seed of one pair's mask stream: the JAX key's 64 bits
    (its two big-endian words) without the lowest.  Both members derive
    the same seed, which is what makes the masks cancel."""
    return int.from_bytes(pair_digest(secret, id_a, id_b)[:8], "big") >> 1


def encode_public(pub: int) -> str:
    return format(pub, "x")


def decode_public(text: str) -> int:
    return validate_public(int(text, 16))
