"""The analytic cost of secure aggregation's masks under group-local
layering: a copy of ``mask_cost`` and the two constants it reads from the
JAX package's ``privacy/dropout.py`` (numpy free, pure arithmetic).  The
rest of that module, the dropout-recovery protocol, belongs to the socket
planes and is not ported yet (ROADMAP.md Queue A item 8)."""

from __future__ import annotations

# Threefry-style counter PRG: ~16 integer ops per generated float32
# (conservative; the exact figure varies by backend).
PRG_FLOPS_PER_ELEM = 16
# One Shamir share on the wire: two 66-byte elements of GF(2^521 - 1).
SHARE_PAYLOAD_BYTES = 2 * 66


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
