"""Byzantine-robust aggregation: coordinate-wise median, trimmed mean and
Multi-Krum.

The counterpart of the JAX package's ``fed/robust.py``.  The JAX round
stacks the whole cohort and pushes non-contributors to the end of each
sort as NaN rows; here the round knows its contributors on the host and
stacks only theirs, so every row of the input is a contributor.  Each
statistic runs leaf by leaf (a sort over the client axis of one
parameter tensor at a time), and Krum's pairwise distances are a sum of
per-leaf Gram products, so no (clients, all params) matrix is ever built.
"""

from __future__ import annotations

import numpy as np
import torch

AGGREGATORS = ("mean", "median", "trimmed_mean", "krum")


def _trim_count(fraction: float, n: int) -> int:
    """floor(fraction · n + 1e-4) in f32, and at least 1 once the caller
    asked for any trimming and 3 or more rows remain.  The epsilon keeps
    f32 products that are integral in exact arithmetic (0.45 · 20) from
    rounding a trim down; the floor of 1 keeps a cohort shrunk by
    stragglers from silently degrading to the plain mean."""
    k = int(np.floor(np.float32(fraction) * np.float32(n) + np.float32(1e-4)))
    if fraction > 0.0 and n >= 3:
        k = max(k, 1)
    return k


def _median_leaf(xs: torch.Tensor) -> torch.Tensor:
    """Median over the leading axis of the sorted rows ``xs``."""
    n = xs.shape[0]
    hi, lo = max(n, 1) // 2, max(n - 1, 0) // 2
    return 0.5 * (xs[lo] + xs[hi])


def _trimmed_leaf(xs: torch.Tensor, k: int) -> torch.Tensor:
    """Mean of the sorted rows [k, n − k); NaN entries count as 0."""
    n = xs.shape[0]
    kept = xs[k:max(n - k, k)]
    kept = torch.where(torch.isnan(kept), 0.0, kept)
    return kept.sum(dim=0) / max(kept.shape[0], 1)


def _gram_terms(stacked: list, n: int, dev) -> torch.Tensor:
    """(n, n + 2) f32: the rows' Gram matrix, their squared norms and
    their count of non-finite entries, summed over ``stacked``."""
    out = torch.zeros(n, n + 2, dtype=torch.float32, device=dev)
    for leaf in stacked:
        x = leaf.reshape(n, -1).float()
        finite = torch.isfinite(x)
        out[:, n + 1] += (~finite).sum(dim=1)
        x = torch.where(finite, x, 0.0)
        out[:, :n] += x @ x.T
        out[:, n] += (x * x).sum(dim=1)
    return out


def krum_select(stacked: list, byz_fraction: float, sharded=None,
                group=None) -> torch.Tensor:
    """Multi-Krum's selection (Blanchard et al., pattern only): score each
    row by the sum of its ``n − f − 2`` smallest squared distances to the
    other rows, keep the ``n − f`` best; ``f`` as :func:`_trim_count`.
    Rows with any non-finite entry are excluded everywhere: never
    selected, and never anyone's neighbour.  Returns the (n,) bool
    selection.  Under tensor parallelism (``sharded``: one bool per leaf,
    ``group``: the model group) the sharded leaves' terms are summed over
    the group in one all-reduce and the replicated ones counted once."""
    n = stacked[0].shape[0]
    dev = stacked[0].device
    if group is None:
        terms = _gram_terms(stacked, n, dev)
    else:
        from colearn_federated_learning_tpu_torch.parallel import collectives

        part = collectives.all_reduce(_gram_terms(
            [s for s, on in zip(stacked, sharded) if on], n, dev), group)
        terms = part + _gram_terms(
            [s for s, on in zip(stacked, sharded) if not on], n, dev)
    gram, sq, bad = terms[:, :n], terms[:, n], terms[:, n + 1] > 0
    ok = ~bad
    d2 = sq[:, None] + sq[None, :] - 2.0 * gram
    invalid = ~(ok[:, None] & ok[None, :]) | torch.eye(n, dtype=torch.bool,
                                                      device=dev)
    d2 = torch.where(invalid, 3e38, d2).clamp_min(0.0)    # Gram round-off
    f = _trim_count(byz_fraction, n)
    k_nb = max(n - f - 2, 1)
    # Clamp huge distances: an attacker whose entries overflow f32 must
    # score astronomically, not 0.
    scores = d2.sort(dim=1).values[:, :k_nb].clamp_max(1e30).sum(dim=1)
    scores = torch.where(ok & ~torch.isnan(scores), scores, torch.inf)
    rank = torch.argsort(torch.argsort(scores, stable=True), stable=True)
    return (rank < max(n - f, 1)) & torch.isfinite(scores)


def robust_aggregate(stacked: list, method: str,
                     trim_fraction: float = 0.1, sharded=None,
                     group=None) -> tuple:
    """Aggregate the contributors' deltas robustly.

    ``stacked``: one tensor per parameter with the contributors on axis 0
    (possibly none).  ``method``: "median" | "trimmed_mean" | "krum".
    ``trim_fraction``: the per-side trim of "trimmed_mean", the assumed
    Byzantine fraction of "krum" (both checked by the engine's
    ``check_fed_options`` before any round runs).  ``sharded``/``group``:
    tensor parallelism, as :func:`krum_select`.  Returns ``(aggregate, selected)``: one
    f32 tensor per parameter, all zero when nobody contributed, and Krum's
    (n,) bool selection (None for the coordinate-wise statistics).
    """
    n = stacked[0].shape[0]
    if n == 0:
        return [torch.zeros(s.shape[1:], dtype=torch.float32, device=s.device)
                for s in stacked], None
    if method == "krum":
        with torch.profiler.record_function("robust.krum_select"):
            sel = krum_select(stacked, trim_fraction, sharded, group)
        w = sel.float()
        denom = w.sum().clamp_min(1.0)
        return [torch.where(torch.isfinite(s), s.float(), 0.0)
                .reshape(n, -1).T.matmul(w).reshape(s.shape[1:]) / denom
                for s in stacked], sel
    k = _trim_count(trim_fraction, n)
    out = []
    for s in stacked:
        xs = torch.sort(s.float(), dim=0).values          # NaN sorts last
        out.append(_median_leaf(xs) if method == "median"
                   else _trimmed_leaf(xs, k))
        del xs
    return out, None
