"""Secure-aggregation pairwise masks on the updates' device (the engine
plane).

The counterpart of the engine half of the JAX package's
``privacy/secure_agg.py`` (Bonawitz et al., pattern only): each pair
(i, j) of cohort members shares a mask stream; client i adds +mask for
every partner j > i and −mask for every j < i, so summed over the cohort
the masks cancel and the aggregate is the plain sum up to f32 rounding.
Here the pair streams come from the experiment seed
(``utils/prng.pair_mask_generator``, through ``fed/programs.Draws``): one
process holds every client, so this shows the algebra, not the trust
model.  Masks are always f32 and drawn on the update's device, tensor by
tensor: a client adds its partners' masks to one parameter tensor at a
time, so no full-model mask is ever held.

Two pairing graphs: the complete graph (``neighbors`` 0), or a
``neighbors``-regular random ring over the cohort (Bell et al., pattern
only), whose per-round order every member derives alike.

The wire plane (``comm/worker.py``) masks with explicit keys instead
(:func:`pairwise_mask_with_keys`): each pair's stream is seeded from the
pair's Diffie-Hellman secret and drawn in one call over the flat wire
tree; the port's masks are its own draws, not the JAX package's bits.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from colearn_federated_learning_tpu_torch.utils import prng, trees

# draw(a, b) -> iterator of standard-normal f32 tensors, one per parameter
# tensor in order, of the stream clients a and b share.
PairDraw = Callable[[int, int], "object"]


def ring_partner_table(ring: np.ndarray, member_ids: np.ndarray,
                       neighbors: int) -> Optional[np.ndarray]:
    """(M, neighbors) ring partners of each member, the ring being the
    round's order of the cohort ids; None when the cohort is too small
    for a ``neighbors``-regular ring without a double pair (the complete
    graph is then the cheaper one).  ``neighbors`` must be even: ring
    offsets come in ± pairs."""
    if neighbors % 2 or neighbors < 2:
        raise ValueError(
            f"secure_agg_neighbors must be an even integer >= 2, got "
            f"{neighbors} (ring partners come in +/- offset pairs)")
    ring = np.asarray(ring)
    size, k2 = len(ring), neighbors // 2
    if k2 > (size - 1) // 2:
        return None
    pos = np.argmax(ring[None, :] == np.asarray(member_ids)[:, None], axis=1)
    offs = np.concatenate([np.arange(1, k2 + 1), -np.arange(1, k2 + 1)])
    return ring[(pos[:, None] + offs[None, :]) % size]


def partner_table(member_ids: np.ndarray, cohort_ids: np.ndarray,
                  neighbors: int = 0,
                  ring: Optional[np.ndarray] = None) -> np.ndarray:
    """(M, P) partner ids per member: the random ring when ``neighbors`` is
    set and the cohort supports it, else the whole cohort (complete graph;
    the member itself among them, with sign 0)."""
    if neighbors > 0:
        table = ring_partner_table(ring, member_ids, neighbors)
        if table is not None:
            return table
    return np.broadcast_to(np.asarray(cohort_ids)[None, :],
                           (len(member_ids), len(cohort_ids)))


def _masks(template: list, client_id: int, partner_ids, draw: PairDraw,
           std: float):
    """Yield Σ_j sign(j − i) · std · stream(i, j) for each tensor of
    ``template`` in turn, partners in table order (the self-pair skipped:
    its sign is 0)."""
    streams = [(float(np.sign(int(p) - int(client_id))),
                draw(int(client_id), int(p)))
               for p in partner_ids if int(p) != int(client_id)]
    for t in template:
        acc = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
        for sign, stream in streams:
            acc.add_(next(stream), alpha=sign * std)
        yield acc


def mask_update(update: list, client_id: int, partner_ids, draw: PairDraw,
                std: float = 1.0) -> list:
    """Add this client's pairwise mask to its (pre-weighted) update in
    place, one parameter tensor at a time."""
    for u, m in zip(update, _masks(update, client_id, partner_ids, draw,
                                   std)):
        u.add_(m)
    return update


def mask_scalar(value: torch.Tensor, client_id: int, partner_ids,
                draw: PairDraw, std: float = 1.0) -> torch.Tensor:
    """Pairwise-mask one scalar side payload (the adaptive-clipping bit)
    with the same algebra; ``draw`` must give its own pair streams, apart
    from the update's."""
    (mask,) = _masks([value], client_id, partner_ids, draw, std)
    return value + mask


# ------------------------------------------------------------ wire plane --
def flat_wire(tree: Any, device) -> torch.Tensor:
    """The tree's leaves (sorted-key order) as one flat f32 tensor on
    ``device``: the layout the wire plane's masks cover."""
    return torch.cat([torch.from_numpy(
        np.ascontiguousarray(l, np.float32)).reshape(-1)
        for l in trees.leaves(tree)]).to(device)


def unflat_wire(ref: Any, flat: torch.Tensor) -> Any:
    """Inverse of :func:`flat_wire`: host numpy leaves shaped as ``ref``'s,
    in one device-to-host copy."""
    host = flat.cpu().numpy()
    out, at = [], 0
    for leaf in trees.leaves(ref):
        n = int(np.prod(np.shape(leaf), dtype=np.int64))
        out.append(host[at:at + n].reshape(np.shape(leaf)))
        at += n
    return trees.unflatten(ref, out)


def pair_stream(key: int, round_idx: int, n: int, device) -> torch.Tensor:
    """The ``n`` standard-normal f32 draws of the stream ``key`` (a pair's
    ``comm/keyexchange.pair_prng_key`` seed, or a self-mask's
    ``privacy/dropout.self_mask_key``) in round ``round_idx``, drawn on
    ``device`` in one call.  A CUDA and a CPU generator give different
    draws, so every party to one secure round masks on one device type."""
    gen = torch.Generator(device=device)
    gen.manual_seed(prng.derive_seed(int(key), prng.TAG_MASK,
                                     int(round_idx)))
    return torch.randn(n, generator=gen, device=device, dtype=torch.float32)


def pairwise_mask_with_keys(n: int, pair_keys, signs, round_idx: int,
                            device, std: float = 1.0) -> torch.Tensor:
    """The flat mask ``Σ_j sign_j · std · stream(key_j, round)`` over ``n``
    entries, keys in order: the wire plane's, whose pair keys come from
    Diffie-Hellman secrets the coordinator cannot derive.

    ``signs``: +1 where this client's id is below the partner's, −1 above,
    0 for the self-pair (skipped), as :func:`partner_table`'s complete
    graph pairs them, so summed over the cohort the masks cancel.  The
    flat layout is the wire tree's leaves (``utils/trees``) concatenated,
    the same on every party."""
    acc = torch.zeros(n, dtype=torch.float32, device=device)
    for key, sign in zip(pair_keys, signs):
        if sign:
            acc.add_(pair_stream(key, round_idx, n, device),
                     alpha=float(sign) * std)
    return acc


def mask_update_with_keys(flat: torch.Tensor, pair_keys, signs,
                          round_idx: int, std: float = 1.0) -> torch.Tensor:
    """``flat + pairwise_mask_with_keys(...)``: the mask is summed first and
    then added, as the JAX package orders it."""
    return flat + pairwise_mask_with_keys(flat.numel(), pair_keys, signs,
                                          round_idx, flat.device, std)
