"""One federated round: cohort sampling, local training, aggregation.

The counterpart of the JAX package's ``fed/programs.py`` on its single-
device path (``rank_cohort``, ``cohort_step``, ``finish_round``), with
every branch of the JAX round in its order: straggler budgets,
SCAFFOLD's corrected local update, FedNova's normalisation, update-norm
telemetry, uniform weights under DP, secure aggregation, SCAFFOLD or a
robust aggregator, DP clip and noise (fixed, or adaptive with the
quantile bit), secure-aggregation masks, the robust aggregate, SCAFFOLD's
variate refresh and the adaptive clip's epilogue.

Where the JAX program vmaps the local trainer over the cohort and then
sums the stacked deltas, this loops over the cohort and keeps a running
f32 sum, so memory holds one client's delta at a time.  A robust
aggregator needs the individual deltas: on that path the contributors'
deltas are stacked (contributors only; the host knows who they are).

On a client mesh (``ln.mesh``, the JAX ``_build_mesh_round``) every rank
runs this same round over its own block of clients: the cohort is drawn
per device among the block's clients (``Draws.device_cohort``, JAX's
``fold_in(sampling_key, dev)``), the weighted sums are all-reduced over
the ``clients`` group (the delta sum in one flat bucket, the round's
scalars in another, ``norm_max`` by a MAX), a robust aggregator
all-gathers the stacked deltas, and secure aggregation all-gathers the
cohort ids for its partner table.  Under tensor parallelism each rank
holds slices of the sharded parameters: norms sum the slices over the
model group, and DP noise and masks are drawn on the full parameter
shapes and sliced, so a round equals the unsharded round with the same
draws.

The round's random draws (cohort, batch indices, straggler budgets, DP
noise, mask streams, the ring order, the clip bit's noise) come from a
:class:`Draws` object; the default one uses the package's ``utils/prng``
generators, and a caller may substitute another (tests replay the JAX
round's own draws this way).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from colearn_federated_learning_tpu_torch.fed import local, robust
from colearn_federated_learning_tpu_torch.fed import strategies
from colearn_federated_learning_tpu_torch.parallel import collectives
from colearn_federated_learning_tpu_torch.parallel import partition
from colearn_federated_learning_tpu_torch.privacy import dp as dp_lib
from colearn_federated_learning_tpu_torch.privacy import secure_agg
from colearn_federated_learning_tpu_torch.utils import prng

# Std of the masks on the adaptive-clipping bit: a unit-scale mask on a
# {0, 1} payload would leak the bit; at 1e3 the f32 cancellation residual
# stays far below the cohort-sized bit sum.
BIT_MASK_STD = 1e3


def rank_cohort(gen: torch.Generator, counts: np.ndarray, k: int) -> np.ndarray:
    """Uniform sample of ``k`` clients WITHOUT replacement among real
    clients: ghosts (count 0) are ranked last and only picked if the cohort
    exceeds the real clients."""
    scores = torch.rand(len(counts), generator=gen, dtype=torch.float32)
    scores = scores + torch.from_numpy(np.asarray(counts) == 0).float() * 1e3
    return torch.argsort(scores, stable=True)[:k].numpy()


def _normal_stream(gen: torch.Generator, shapes, device):
    for shape in shapes:
        yield torch.randn(shape, generator=gen, device=device,
                          dtype=torch.float32)


class Draws:
    """The round's random draws from per-purpose ``torch.Generator``s.
    Noise and masks are drawn on ``device`` (the params' device), one
    parameter tensor at a time as the caller consumes the iterator."""

    def __init__(self, seed: int):
        self.seed = seed

    def cohort(self, round_idx: int, counts: np.ndarray, k: int) -> np.ndarray:
        """Array slots of the ``k`` sampled clients."""
        return rank_cohort(prng.sampling_generator(self.seed, round_idx),
                           counts, k)

    def device_cohort(self, round_idx: int, dev: int, counts: np.ndarray,
                      k: int) -> np.ndarray:
        """Block slots of the ``k`` clients that client-mesh device
        ``dev`` samples among its block (``counts``) in one round."""
        return rank_cohort(
            prng.device_sampling_generator(self.seed, round_idx, dev),
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

    def dp_noise(self, round_idx: int, client_id: int, shapes, device):
        """Standard-normal f32 tensors of ``shapes``: one client's DP noise
        in one round."""
        return _normal_stream(
            prng.dp_generator(self.seed, client_id, round_idx, device),
            shapes, device)

    def pair_mask(self, round_idx: int, a: int, b: int, shapes, device,
                  stream: int = 0):
        """Standard-normal f32 tensors of ``shapes``: the mask stream that
        clients ``a`` and ``b`` share in one round (the same for (b, a));
        ``stream`` 1 is the adaptive-clipping bit's."""
        return _normal_stream(
            prng.pair_mask_generator(self.seed, a, b, round_idx, device,
                                     stream), shapes, device)

    def ring_order(self, round_idx: int, cohort_ids: np.ndarray) -> np.ndarray:
        """The round's secure-aggregation ring: the cohort ids in an order
        every member derives alike."""
        ids = np.sort(np.asarray(cohort_ids))
        scores = torch.rand(len(ids),
                            generator=prng.ring_generator(self.seed, round_idx))
        return ids[torch.argsort(scores, stable=True).numpy()]

    def clip_bit_noise(self, round_idx: int, device) -> torch.Tensor:
        """A standard-normal f32 scalar: the noise on the round's
        adaptive-clipping bit sum."""
        gen = prng.clip_bit_generator(self.seed, round_idx, device)
        return torch.randn((), generator=gen, device=device,
                           dtype=torch.float32)


def global_norm(ln, delta: list) -> torch.Tensor:
    """L2 norm of a whole update; under tensor parallelism the sharded
    slices' squares are summed over the model group (one all-reduce) and
    the replicated tensors counted once."""
    if ln.tp_dims is None:
        return dp_lib.global_norm(delta)
    def sq(sharded: bool) -> torch.Tensor:
        ts = [d for d, dim in zip(delta, ln.tp_dims)
              if (dim is not None) == sharded]
        return (torch.stack(torch._foreach_norm(ts)).square().sum() if ts
                else torch.zeros((), device=ln.device))

    return torch.sqrt(sq(False) + collectives.all_reduce(sq(True),
                                                         ln.tp.group))


def _local(ln, draws):
    """This rank's slices of full-shape draws (noise, masks)."""
    if ln.tp_dims is None:
        return draws
    return (partition.shard(t, d, ln.tp.size, ln.tp.index)
            for t, d in zip(draws, ln.tp_dims))


def _flat_zeros(ln, params: list, rows: int = 0) -> tuple:
    """One zeroed f32 buffer and its per-parameter views (with ``rows``,
    a leading axis of that size), so a sum or a stack crosses the mesh as
    one collective."""
    shape = (rows,) if rows else ()
    flat = torch.zeros(shape + (sum(p.numel() for p in params),),
                       dtype=torch.float32, device=ln.device)
    views, at = [], 0
    for p in params:
        views.append(flat[..., at:at + p.numel()].unflatten(-1, p.shape))
        at += p.numel()
    return flat, views


def cohort_step(ln, params: list, sel: np.ndarray, round_idx: int) -> tuple:
    """Train every sampled client from ``params`` and fold its update.

    Returns ``(agg, total_w, stats, extras)``: ``agg`` is the running
    weighted delta sum (on a robust path, the robust aggregate); ``stats``
    holds the device scalars ``loss_sum``, ``bit_sum``, ``norm_sum``,
    ``norm_max`` and the host numbers ``n_completed`` and ``nova_sum``;
    ``extras`` is SCAFFOLD's ``dc_sum`` (or None).  A client contributes
    when it completed and holds examples; its weight is its example count,
    or 1 under uniform weighting, and 0 when it does not contribute.
    The adaptive clip is ``ln.dp_clip`` (a device scalar).
    """
    c = ln.config.fed
    gids = ln.block_ids[sel]
    mesh = ln.mesh is not None
    if c.straggler_prob > 0.0:
        budgets = ln.draws.step_budgets(round_idx, gids, ln.num_steps,
                                        c.straggler_prob)
    else:
        budgets = np.full(len(sel), ln.num_steps, np.int64)
    lr_scale = strategies.lr_scale_for_round(c, round_idx)

    dev = ln.device
    dp = c.dp_clip > 0.0
    # Exact update norms are an unaccounted release under DP and exactly
    # what the masks hide under secure aggregation: report them only
    # without either.
    track_norms = not (dp or c.secure_agg)
    uniform = dp or c.secure_agg or ln.scaffold or ln.robust
    shapes = ln.full_shapes
    norm_fn = functools.partial(global_norm, ln)
    partners = None
    if c.secure_agg:
        # Masks pair against the whole round's cohort, on a mesh the
        # all-gather of every device's cohort ids.
        cohort_ids = (collectives.all_gather(
            torch.as_tensor(gids, dtype=torch.int64, device=dev),
            ln.clients.group).cpu().numpy() if mesh else gids)
        ring = (ln.draws.ring_order(round_idx, cohort_ids)
                if c.secure_agg_neighbors > 0 else None)
        partners = secure_agg.partner_table(gids, cohort_ids,
                                            c.secure_agg_neighbors, ring)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if ln.scaffold:                     # SCAFFOLD's variate sum rides along
        flat, views = _flat_zeros(ln, params * 2)
        agg, dc_sum = views[:len(params)], views[len(params):]
    else:
        flat, agg = _flat_zeros(ln, params, len(sel) if ln.robust else 0)
        dc_sum = None
    control = (list(ln.server_state.control.values()) if ln.scaffold
               else None)
    total_w = 0.0
    loss_sum, bit_sum = zero.clone(), zero.clone()
    norm_sum, norm_max = zero.clone(), zero.clone()
    nova_sum = np.float32(0.0)
    n_completed = 0
    steps_run, contributed, nova_a = [], [], []
    for k, (slot, gid, budget) in enumerate(zip(sel, gids, budgets)):
        count = int(ln.block_counts[slot])
        idx = ln.draws.batch_indices(round_idx, int(gid), count, ln.num_steps,
                                     c.batch_size)
        idx = torch.as_tensor(idx, dtype=torch.long).to(dev, non_blocking=True)
        if ln.scaffold:
            sres = ln.local_update(params, ln.x[slot], ln.y[slot], count, idx,
                                   int(budget), ln.variates.gather(slot),
                                   control, lr_scale)
            res = sres.result
        else:
            res = ln.local_update(params, ln.x[slot], ln.y[slot], count, idx,
                                  int(budget), lr_scale)
        contrib = res.completed and res.num_examples > 0
        weight = (1.0 if uniform else float(res.num_examples)) if contrib \
            else 0.0
        delta = res.delta
        steps_run.append(res.steps_run)
        contributed.append(contrib)
        if ln.fednova:
            # Normalise by the client's step coefficient a_i, so unequal
            # step counts (stragglers) stop biasing the objective; the
            # epilogue rescales the mean by the weighted mean of a_i.
            a = local.fednova_coefficient(res.steps_run, c.momentum)
            torch._foreach_mul_(delta, float(np.float32(1.0) / a))
            nova_sum = nova_sum + np.float32(weight) * a
            nova_a.append(float(a))
        if track_norms and contrib:
            norm = norm_fn(delta)
            norm_sum += norm
            norm_max = torch.maximum(norm_max, norm)
        bit = None
        if dp and contrib:
            noise = _local(ln, ln.draws.dp_noise(round_idx, int(gid), shapes,
                                                 dev))
            if ln.adaptive_clip:
                delta, bit = dp_lib.clip_and_noise_with_bit(
                    delta, ln.dp_clip, ln.dp_z, ln.dp_cohort, noise, norm_fn)
            else:
                delta = dp_lib.clip_and_noise(
                    delta, c.dp_clip, c.dp_noise_multiplier,
                    ln.dp_cohort, noise, norm_fn)
        if c.secure_agg:
            # Every cohort member masks its weight-scaled update (weight 1
            # or 0 here); the masks cancel in the plain sum.
            masked = delta if contrib else [torch.zeros_like(p)
                                            for p in params]
            with torch.profiler.record_function("secure_agg.mask_update"):
                secure_agg.mask_update(
                    masked, int(gid), partners[k],
                    lambda a, b: _local(ln, ln.draws.pair_mask(
                        round_idx, a, b, shapes, dev)))
            torch._foreach_add_(agg, masked)
            if ln.adaptive_clip:
                # The bit is a second payload, masked on its own streams.
                bit_sum += secure_agg.mask_scalar(
                    bit if bit is not None else zero, int(gid), partners[k],
                    lambda a, b: ln.draws.pair_mask(round_idx, a, b, [()],
                                                    dev, stream=1),
                    std=BIT_MASK_STD)
        elif contrib:
            if ln.robust:
                torch._foreach_copy_([s[n_completed] for s in agg], delta)
            else:
                torch._foreach_add_(agg, torch._foreach_mul(delta, weight))
            if bit is not None:
                bit_sum += bit
        if ln.scaffold and contrib:
            # Contributors' variates only are refreshed, each as it
            # finishes (JAX scatters the cohort's after the round).
            torch._foreach_add_(dc_sum, sres.delta_c)
            with ln.tracer.span("scatter_variates", round=round_idx):
                ln.variates.scatter(slot, sres.c_new)
        total_w += weight
        loss_sum += res.mean_loss * weight
        n_completed += int(contrib)
        del res, delta
    detail = {"clients": gids.copy(), "steps_run": np.asarray(steps_run),
              "contributed": np.asarray(contributed)}
    if ln.fednova:
        detail["nova_a"] = np.asarray(nova_a, np.float32)
    if partners is not None:
        detail["partners"] = np.asarray(partners)
    if ln.robust:
        # Contributors' rows come first in each device's stack; on a mesh
        # the stacks, and who contributed where, are all-gathered.
        ids = gids[np.asarray(contributed, bool)]
        rows = flat[:n_completed]
        if mesh:
            meta = torch.as_tensor(
                np.concatenate([gids, np.asarray(contributed, np.int64)]),
                dtype=torch.int64, device=dev)
            meta = collectives.all_gather(meta[None], ln.clients.group)
            meta = meta.cpu().numpy().reshape(ln.clients.size, 2, len(sel))
            stacks = collectives.all_gather(flat, ln.clients.group)
            keep = np.concatenate([
                d * len(sel) + np.arange(int(m[1].sum()))
                for d, m in enumerate(meta)])
            ids = np.concatenate([m[0][m[1].astype(bool)] for m in meta])
            rows = stacks[torch.as_tensor(keep, device=dev)]
        views = [rows[:, at - p.numel():at].unflatten(1, p.shape)
                 for p, at in zip(params, np.cumsum([p.numel()
                                                     for p in params]))]
        sharded = (None if ln.tp_dims is None
                   else [d is not None for d in ln.tp_dims])
        with torch.profiler.record_function("robust.aggregate"):
            agg, chosen = robust.robust_aggregate(
                views, c.aggregator, c.trim_fraction, sharded,
                None if sharded is None else ln.tp.group)
        if chosen is not None:
            detail["selected"] = ids[chosen.cpu().numpy()]
    ln.last_cohort = detail
    stats = (loss_sum, n_completed, bit_sum, norm_sum, norm_max, nova_sum)
    if mesh:
        stats, total_w = _reduce_round(ln, flat, stats, total_w,
                                       track_norms)
    return agg, total_w, stats, dc_sum


def _reduce_round(ln, flat, stats, total_w, track_norms) -> tuple:
    """The mesh round's sums over the ``clients`` group: the delta sum
    (with SCAFFOLD's variate sum) in one flat all-reduce — a robust
    aggregate is already global —, the round's scalars in another, and
    ``norm_max`` by a MAX when norms are reported."""
    g = ln.clients.group
    loss_sum, n_completed, bit_sum, norm_sum, norm_max, nova_sum = stats
    if not ln.robust:
        collectives.all_reduce(flat, g)
    host = torch.tensor([total_w, n_completed, nova_sum],
                        dtype=torch.float32, device=ln.device)
    vec = torch.stack([host[0], loss_sum, host[1], bit_sum, norm_sum,
                       host[2]])
    total_w, loss_sum, n_completed, bit_sum, norm_sum, nova_sum = \
        collectives.all_reduce(vec, g).unbind(0)
    if track_norms:
        norm_max = collectives.all_reduce(norm_max.clone(), g, op="max")
    stats = (loss_sum, int(round(float(n_completed))), bit_sum, norm_sum,
             norm_max, np.float32(float(nova_sum)))
    return stats, float(total_w)


def finish_round(ln, agg: list, total_w: float, stats: tuple, dc_sum,
                 round_idx: int) -> dict:
    """Mean delta, server update, metrics (device scalars).  No
    contributor at all (every client a straggler) leaves the params as
    they are; the explicit gate matters under secure aggregation, where
    the sum is not exactly zero but the masks' f32 residual."""
    c = ln.config.fed
    loss_sum, n_completed, bit_sum, norm_sum, norm_max, nova_sum = stats
    denom = np.float32(total_w) if total_w > 0 else np.float32(1.0)
    if not ln.robust:                   # a robust aggregate is the mean
        scale = float(np.float32(1.0) / denom) if total_w > 0 else 0.0
        torch._foreach_mul_(agg, scale)
    if ln.fednova:
        torch._foreach_mul_(agg, float(np.float32(nova_sum) / denom))
    names = list(ln.server_state.params)
    mean_dc = participation = None
    if ln.scaffold:
        n = np.float32(n_completed)
        torch._foreach_mul_(dc_sum, float(np.float32(1.0) / n)
                            if n_completed > 0 else 0.0)
        mean_dc = dict(zip(names, dc_sum))
        participation = float(n / np.float32(ln.real_num_clients))
    strategies.server_update(ln.server_state, dict(zip(names, agg)), c,
                             mean_delta_c=mean_dc,
                             participation=participation)
    metrics = {
        "train_loss": loss_sum / float(denom),
        "completed": n_completed,
        "total_weight": total_w,
    }
    if not (c.dp_clip > 0.0 or c.secure_agg):
        metrics["delta_norm_mean"] = norm_sum / max(float(n_completed), 1.0)
        metrics["delta_norm_max"] = norm_max
    if ln.adaptive_clip:
        # Noised quantile fraction -> geometric clip step.
        noised = bit_sum
        if ln.dp_bit_noise > 0.0:
            noised = bit_sum + float(np.float32(ln.dp_bit_noise)) * \
                ln.draws.clip_bit_noise(round_idx, ln.device)
        frac = torch.clamp(noised / max(float(n_completed), 1.0), 0.0, 1.0)
        new_clip = dp_lib.adaptive_clip_update(
            ln.dp_clip, frac, c.dp_target_quantile, c.dp_clip_lr)
        # A zero-contributor round carries no norm evidence: the clip
        # stays, as the params do.
        if n_completed == 0:
            new_clip = ln.dp_clip
        metrics["dp_clip"] = torch.clamp(new_clip, min=1e-6)
        metrics["dp_bit_frac"] = frac
    return metrics


def sample_cohort(ln, round_idx: int) -> np.ndarray:
    """Block slots of this rank's share of the round's cohort: on one
    device the whole cohort (every client when it is the whole
    population); on a client mesh ``cohort_per_device`` clients drawn
    among the device's own block."""
    if ln.mesh is not None:
        cpd, block = ln.cohort_per_device, len(ln.block_ids)
        if cpd < block:
            return np.asarray(ln.draws.device_cohort(
                round_idx, ln.clients.index, ln.block_counts, cpd), np.int64)
        return np.arange(block)
    if ln.cohort_size < ln.num_clients:
        return np.asarray(ln.draws.cohort(round_idx, ln.counts,
                                          ln.cohort_size), np.int64)
    return np.arange(ln.num_clients)


def run_round(ln, round_idx: int, sel: np.ndarray) -> dict:
    """Train the cohort ``sel``, aggregate, update the server."""
    params = list(ln.server_state.params.values())
    agg, total_w, stats, dc_sum = cohort_step(ln, params, sel, round_idx)
    return finish_round(ln, agg, total_w, stats, dc_sum, round_idx)


# ---------------------------------------------------------------------
# per-client programs (evaluation, personalization, update similarity)
# ---------------------------------------------------------------------
# The round indices the similarity's and the personalized fine-tune's
# batch draws are keyed on: past any training round, each its own
# purpose, as in the JAX package.
SIMILARITY_ROUND = 1 << 23
PERSONALIZE_ROUND = 1 << 24


def build_client_eval_fn(ln):
    """``fn(params) -> (loss, acc)``: numpy f32 arrays of every client's
    mean loss and accuracy under ``params`` on its own shard, in array-slot
    order, in chunks of ``max(batch_size, 64)`` rows; only rows below the
    client's count score, and chunks wholly past it do not run.  On a
    client mesh each rank scores its block and the results are
    all-gathered over the ``clients`` group.  One host sync."""
    batch = max(ln.config.fed.batch_size, 64)
    model_params = list(ln.model.parameters())
    counts = [int(c) for c in ln.block_counts]

    @torch.no_grad()
    def eval_fn(params):
        torch._foreach_copy_(model_params, list(params))
        out = torch.zeros((len(counts), 2), dtype=torch.float64,
                          device=ln.device)
        for slot, count in enumerate(counts):
            for b in range(0, count, batch):
                x = ln.x[slot, b:min(b + batch, count)]
                y = ln.y[slot, b:min(b + batch, count)]
                logits = ln.model(x)
                nll = -torch.nn.functional.log_softmax(
                    logits.float(), dim=-1).gather(1, y[:, None])[:, 0]
                out[slot, 0] += nll.sum()
                out[slot, 1] += (logits.argmax(dim=-1) == y).sum()
        out /= torch.tensor(counts, dtype=torch.float64,
                            device=ln.device).clamp(min=1.0)[:, None]
        out = out.float()
        if ln.mesh is not None:
            out = collectives.all_gather(out, ln.clients.group)
        out = out.cpu().numpy()
        return out[:, 0], out[:, 1]

    return eval_fn


def build_personalized_eval_fn(ln, steps: int, lr: float):
    """``fn(params) -> (g_acc, p_acc, n_eval)``: numpy arrays in array-slot
    order (the JAX ``build_personalized_eval_fn``'s outputs).  Each client
    fine-tunes ``params`` for ``steps`` steps on the first half of its
    shard (``count // 2`` rows) with the config's own local trainer (its
    optimizer, momentum, MoE aux loss and FedProx term; ``strategy``,
    ``local_steps``, ``lr`` and ``straggler_prob`` overridden as in JAX),
    on batches drawn at ``PERSONALIZE_ROUND``; then the global and the
    personalized params score the second half, in chunks of
    ``max(batch_size, 64)`` rows.  A client with fewer than 2 examples has
    no holdout half: it neither trains nor scores (accuracies 0,
    ``n_eval`` 0), as its JAX lanes count nothing.  On a client mesh each
    rank fine-tunes and scores its own block, and the results are
    all-gathered over the ``clients`` group.  One host sync."""
    import dataclasses

    c = ln.config
    fed = dataclasses.replace(
        c.fed,
        strategy=c.fed.strategy if c.fed.strategy == "fedprox" else "fedavg",
        local_steps=steps, lr=lr, straggler_prob=0.0)
    local.check_dense_trainer(fed)
    local.check_strategy_optimizer(fed)
    update = local.make_local_update(
        ln.model, local.make_optimizer(lr, fed.momentum, fed.local_optimizer),
        steps,
        prox_mu=fed.prox_mu if fed.strategy == "fedprox" else 0.0,
        min_steps_fraction=fed.straggler_min_fraction,
        aux_loss_weight=(c.model.moe_aux_weight
                         if c.model.name.startswith("moe") else 0.0),
        grad_sync_group=ln.seq.group if ln.sp else None,
        tp=ln.tp if ln.tp_dims is not None else None,
        sharded=(None if ln.tp_dims is None
                 else [d is not None for d in ln.tp_dims]))
    batch = max(fed.batch_size, 64)
    model_params = list(ln.model.parameters())

    @torch.no_grad()
    def score(params, slot: int, lo: int, hi: int) -> torch.Tensor:
        torch._foreach_copy_(model_params, params)
        correct = torch.zeros((), dtype=torch.float32, device=ln.device)
        for b in range(lo, hi, batch):
            logits = ln.model(ln.x[slot, b:min(b + batch, hi)])
            correct += (logits.argmax(dim=-1)
                        == ln.y[slot, b:min(b + batch, hi)]).sum()
        return correct / float(max(hi - lo, 1))

    def eval_fn(params):
        params = list(params)
        out = torch.zeros((len(ln.block_ids), 3), dtype=torch.float32,
                          device=ln.device)
        for slot, gid in enumerate(ln.block_ids):
            count = int(ln.block_counts[slot])
            if count < 2:
                continue
            n_ft = count // 2
            idx = ln.draws.batch_indices(PERSONALIZE_ROUND, int(gid), n_ft,
                                         steps, fed.batch_size)
            idx = torch.as_tensor(idx, dtype=torch.long).to(
                ln.device, non_blocking=True)
            res = update(params, ln.x[slot], ln.y[slot], n_ft, idx, steps)
            pers = torch._foreach_add(params, res.delta)
            del res
            out[slot, 0] = score(params, slot, n_ft, count)
            out[slot, 1] = score(pers, slot, n_ft, count)
            out[slot, 2] = count - n_ft
            del pers
        if ln.mesh is not None:
            out = collectives.all_gather(out, ln.clients.group)
        out = out.cpu().numpy()
        return out[:, 0], out[:, 1], out[:, 2].astype(np.int32)

    return eval_fn


def build_similarity_fn(ln, steps: int):
    """``fn(params) -> (N, N)`` numpy cosine similarity of every client's
    local update, in array-slot order: each client runs ``min(steps,
    num_steps)`` steps of the plain local trainer from ``params`` on
    batches drawn at ``SIMILARITY_ROUND``; the flat f32 updates are
    row-normalised by ``max(norm, 1e-12)``, stacked (N, P) and multiplied
    once.  On a client mesh each rank trains its block, the normalised
    rows are all-gathered over the ``clients`` group and every rank forms
    the whole matrix; under tensor parallelism the norms and the products
    sum the slices over the model group."""
    budget = min(steps, ln.num_steps)
    c = ln.config.fed

    def sim_fn(params):
        size = sum(p.numel() for p in params)
        xn = torch.empty((len(ln.block_ids), size), dtype=torch.float32,
                         device=ln.device)
        for slot, gid in enumerate(ln.block_ids):
            count = int(ln.block_counts[slot])
            idx = ln.draws.batch_indices(SIMILARITY_ROUND, int(gid), count,
                                         ln.num_steps, c.batch_size)
            idx = torch.as_tensor(idx, dtype=torch.long).to(
                ln.device, non_blocking=True)
            res = ln.local_update(params, ln.x[slot], ln.y[slot], count,
                                  idx, budget)
            row, at = xn[slot], 0
            for d in res.delta:
                row[at:at + d.numel()].copy_(d.reshape(-1))
                at += d.numel()
            norm = (torch.linalg.vector_norm(row) if ln.tp_dims is None
                    else global_norm(ln, res.delta))
            row /= torch.clamp(norm, min=1e-12)
            del res
        if ln.mesh is not None:
            xn = collectives.all_gather(xn, ln.clients.group)
        if ln.tp_dims is None:
            return (xn @ xn.T).cpu().numpy()
        sharded = torch.cat([torch.full((p.numel(),), d is not None,
                                        device=ln.device)
                             for p, d in zip(params, ln.tp_dims)])
        rep, shd = xn[:, ~sharded], xn[:, sharded]
        gram = collectives.all_reduce(shd @ shd.T, ln.tp.group)
        return (gram + rep @ rep.T).cpu().numpy()

    return sim_fn
