"""One federated round: cohort sampling, local training, aggregation.

The counterpart of the JAX package's ``fed/programs.py`` on its single-
device path (``rank_cohort``, ``cohort_step``, ``finish_round``).  Where
the JAX program vmaps the local trainer over the cohort and then sums the
stacked deltas, this loops over the cohort and keeps a running weighted
delta sum in f32, so memory holds one client's delta at a time, never a
cohort of them.

The round's random draws (cohort, per-step batch indices, straggler
budgets) come from a :class:`Draws` object; the default one uses the
package's ``utils/prng`` generators, and a caller may substitute another
(tests replay the JAX round's own draws this way).
"""

from __future__ import annotations

import numpy as np
import torch

from colearn_federated_learning_tpu_torch.fed import strategies
from colearn_federated_learning_tpu_torch.utils import prng


def rank_cohort(gen: torch.Generator, counts: np.ndarray, k: int) -> np.ndarray:
    """Uniform sample of ``k`` clients WITHOUT replacement among real
    clients: ghosts (count 0) are ranked last and only picked if the cohort
    exceeds the real clients."""
    scores = torch.rand(len(counts), generator=gen, dtype=torch.float32)
    scores = scores + torch.from_numpy(np.asarray(counts) == 0).float() * 1e3
    return torch.argsort(scores, stable=True)[:k].numpy()


class Draws:
    """The round's random draws from per-purpose ``torch.Generator``s."""

    def __init__(self, seed: int):
        self.seed = seed

    def cohort(self, round_idx: int, counts: np.ndarray, k: int) -> np.ndarray:
        """Array slots of the ``k`` sampled clients."""
        return rank_cohort(prng.sampling_generator(self.seed, round_idx),
                           counts, k)

    def batch_indices(self, round_idx: int, client_id: int, count: int,
                      num_steps: int, batch_size: int) -> np.ndarray:
        """(num_steps, batch_size) indices drawn uniformly in [0, count)."""
        gen = prng.client_round_generator(self.seed, client_id, round_idx)
        return torch.randint(0, max(int(count), 1), (num_steps, batch_size),
                             generator=gen).numpy()

    def step_budgets(self, round_idx: int, client_ids: np.ndarray,
                     num_steps: int, straggler_prob: float) -> np.ndarray:
        """Per-client step budgets: a straggler (probability
        ``straggler_prob``) runs a uniform fraction of ``num_steps``."""
        out = []
        for cid in client_ids:
            gen = prng.straggler_generator(self.seed, round_idx, int(cid))
            slow, frac = torch.rand(2, generator=gen).tolist()
            out.append(int(frac * num_steps) if slow < straggler_prob
                       else num_steps)
        return np.asarray(out, np.int64)


def cohort_step(ln, params: list, sel: np.ndarray, round_idx: int):
    """Train every sampled client from ``params`` and fold its delta into a
    running weighted sum.  Returns ``(wsum, total_w, stats)`` with
    ``stats = (loss_sum, n_completed, norm_sum, norm_max)``; the weight of
    a client is ``num_examples · (completed ∧ non-ghost)``."""
    c = ln.config.fed
    gids = ln.client_ids[sel]
    if c.straggler_prob > 0.0:
        budgets = ln.draws.step_budgets(round_idx, gids, ln.num_steps,
                                        c.straggler_prob)
    else:
        budgets = np.full(len(sel), ln.num_steps, np.int64)
    lr_scale = strategies.lr_scale_for_round(c, round_idx)

    dev = ln.device
    wsum = [torch.zeros_like(p) for p in params]
    total_w = 0.0
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    norm_sum = torch.zeros((), dtype=torch.float32, device=dev)
    norm_max = torch.zeros((), dtype=torch.float32, device=dev)
    n_completed = 0
    for slot, gid, budget in zip(sel, gids, budgets):
        count = int(ln.counts[slot])
        idx = ln.draws.batch_indices(round_idx, int(gid), count, ln.num_steps,
                                     c.batch_size)
        idx = torch.as_tensor(idx, dtype=torch.long).to(dev, non_blocking=True)
        res = ln.local_update(params, ln.x[slot], ln.y[slot], count, idx,
                              int(budget), lr_scale)
        contrib = res.completed and res.num_examples > 0
        weight = float(res.num_examples) if contrib else 0.0
        if contrib:
            torch._foreach_add_(wsum, torch._foreach_mul(res.delta, weight))
            n_completed += 1
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(res.delta)))
            norm_sum += norm
            norm_max = torch.maximum(norm_max, norm)
        total_w += weight
        loss_sum += res.mean_loss * weight
        del res
    return wsum, total_w, (loss_sum, n_completed, norm_sum, norm_max)


def finish_round(ln, wsum: list, total_w: float, loss_sum, n_completed: int,
                 norm_sum, norm_max) -> dict:
    """Mean delta, server update, metrics (device scalars).  No
    contributor at all (every client a straggler) leaves the params as
    they are."""
    denom = np.float32(total_w) if total_w > 0 else np.float32(1.0)
    scale = float(np.float32(1.0) / denom) if total_w > 0 else 0.0
    torch._foreach_mul_(wsum, scale)
    names = list(ln.server_state.params)
    strategies.server_update(ln.server_state, dict(zip(names, wsum)),
                             ln.config.fed)
    return {
        "train_loss": loss_sum / float(denom),
        "completed": n_completed,
        "total_weight": total_w,
        "delta_norm_mean": norm_sum / max(float(n_completed), 1.0),
        "delta_norm_max": norm_max,
    }


def run_round(ln, round_idx: int) -> dict:
    """Sample the cohort, train it, aggregate, update the server."""
    if ln.cohort_size < ln.num_clients:
        sel = np.asarray(ln.draws.cohort(round_idx, ln.counts,
                                         ln.cohort_size), np.int64)
    else:
        sel = np.arange(ln.num_clients)
    params = list(ln.server_state.params.values())
    wsum, total_w, stats = cohort_step(ln, params, sel, round_idx)
    return finish_round(ln, wsum, total_w, *stats)
