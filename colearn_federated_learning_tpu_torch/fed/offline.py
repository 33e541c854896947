"""Cross-silo federation over files: ``init``, ``train --role client``,
``aggregate`` and ``eval`` (the counterpart of the JAX package's
``fed/offline.py``).

Each silo trains against a global-model file and writes a weighted update
file; the aggregator folds any number of update files into the next
global model with the configured server strategy.  Files are
``utils/serialization.py`` npz in the flax layout, so a file written by
either package is read by the other; update files carry
``fed/compression.py``'s frames.  Training and evaluation run on the card
unless the caller passes ``device="cpu"``.

Not ported yet: the fault-injection hooks of the JAX package's
``faults/fileplane`` (identities without a fault plan, which the port's
command line refuses) and the ``fed.offline_*`` counters (ROADMAP.md
Queue A items 8 and 10); ``detection=True`` raises, naming item 10.
"""

from __future__ import annotations

import math
import zipfile
from typing import Optional

import numpy as np
import torch

from colearn_federated_learning_tpu_torch.data import registry as data_registry
from colearn_federated_learning_tpu_torch.data.sharding import pack_client_shards
from colearn_federated_learning_tpu_torch.fed import compression, evaluation
from colearn_federated_learning_tpu_torch.fed import programs, strategies
from colearn_federated_learning_tpu_torch.fed import setup as setup_lib
from colearn_federated_learning_tpu_torch.fed.engine import partition_for_config
from colearn_federated_learning_tpu_torch.models import registry as model_registry
from colearn_federated_learning_tpu_torch.utils import trees
from colearn_federated_learning_tpu_torch.utils.config import ExperimentConfig
from colearn_federated_learning_tpu_torch.utils.device import resolve_device
from colearn_federated_learning_tpu_torch.utils.serialization import (
    atomic_save_pytree_npz, load_pytree_npz)

# Everything a half-written, replayed or foreign update file can raise on
# load and decode: the aggregator skips these instead of crashing.
_BAD_UPDATE_ERRORS = (OSError, EOFError, KeyError, ValueError,
                      zipfile.BadZipFile)


def init_global_model(config: ExperimentConfig, path: str,
                      device=None) -> None:
    """Initialize the global params from the experiment seed and write
    them (round 0)."""
    params = setup_lib.init_global_params(config, device)
    atomic_save_pytree_npz(path, params,
                           meta={"round": 0, "config": config.run.name})


def _load_residual(residual_path: str, round_idx: int):
    """The carried error-feedback residual for ``round_idx``, or None: a
    residual counts only if it was written in the round just before (a
    gap means the silo's last update was rejected or rounds were
    skipped), and a torn file resets it."""
    try:
        prev, rmeta = load_pytree_npz(residual_path)
    except FileNotFoundError:
        return None
    except _BAD_UPDATE_ERRORS:
        return None
    if int(rmeta.get("round", -1)) != round_idx - 1:
        return None
    return prev


def client_update(
    config: ExperimentConfig,
    client_id: int,
    global_path: str,
    out_path: str,
    round_idx: int = 0,
    dataset: Optional[data_registry.Dataset] = None,
    residual_path: Optional[str] = None,
    device=None,
    draws=None,
) -> dict:
    """One silo's local round: load the global params, train the silo's
    partition with the port's local trainer, write a weighted delta update
    file.  Returns summary stats.

    ``residual_path`` carries uplink error feedback across rounds
    (``fed.compress_feedback``).  ``draws`` supplies the batch indices and
    DP noise (:class:`fed.programs.Draws`, the default); tests pass the
    JAX package's own draws."""
    c = config
    if c.fed.secure_agg and c.fed.compress_feedback:
        raise ValueError(
            "secure_agg cannot carry uplink error feedback: masked "
            "updates leave no plaintext compression residual to feed back")
    setup_lib.require_stateless_strategy(c, "the file-based client flow")
    device = resolve_device(device)
    params, meta = load_pytree_npz(global_path)
    round_idx = int(meta.get("round", round_idx))

    ds = dataset or data_registry.get_dataset(c.data.dataset, seed=c.run.seed)
    labels = np.asarray(ds.y_train)
    parts = partition_for_config(c, labels)
    if not 0 <= client_id < len(parts):
        raise ValueError(f"client_id {client_id} out of range [0, {len(parts)})")
    shards = pack_client_shards(np.asarray(ds.x_train), labels,
                                [parts[client_id]],
                                capacity=c.data.max_examples_per_client)

    model = model_registry.build_model(
        setup_lib.local_model_config(c.model), device,
        input_shape=shards.x.shape[2:])
    local_update, num_steps = setup_lib.local_trainer_for_config(
        c, model, shards.capacity)
    global_params = setup_lib.flax_to_params(model, params, device)
    draws = draws if draws is not None else programs.Draws(c.run.seed)
    count = int(shards.counts[0])
    idx = draws.batch_indices(round_idx, client_id, count, num_steps,
                              c.fed.batch_size)
    result = local_update(
        global_params,
        torch.from_numpy(shards.x[0]).to(device),
        torch.from_numpy(shards.y[0].astype(np.int64)).to(device),
        count, torch.as_tensor(idx, dtype=torch.long).to(device), num_steps,
        strategies.lr_scale_for_round(c.fed, round_idx))
    delta, weight = setup_lib.finalize_client_delta(c, result, client_id,
                                                    round_idx, draws)
    delta_np = setup_lib.params_to_flax(model, delta, c)
    mean_loss = float(result.mean_loss)

    feedback = (c.fed.compress_feedback and residual_path is not None
                and c.fed.compress != "none")
    if feedback:
        residual = _load_residual(residual_path, round_idx)
        try:
            wire, cmeta, new_residual = compression.feedback_compress(
                delta_np, residual, c.fed.compress,
                topk_fraction=c.fed.topk_fraction)
        except ValueError:
            # The carried tree no longer fits the model (the config
            # changed between rounds): reset and compress uncompensated.
            wire, cmeta, new_residual = compression.feedback_compress(
                delta_np, None, c.fed.compress,
                topk_fraction=c.fed.topk_fraction)
        if new_residual is not None:
            atomic_save_pytree_npz(
                residual_path, new_residual,
                meta={"round": round_idx, "client_id": client_id})
    else:
        wire, cmeta = compression.compress_delta(
            delta_np, c.fed.compress, topk_fraction=c.fed.topk_fraction)
    atomic_save_pytree_npz(
        out_path, wire,
        meta={"round": round_idx, "weight": weight, "client_id": client_id,
              "num_examples": int(result.num_examples),
              "mean_loss": mean_loss, **cmeta})
    return {"client_id": client_id, "round": round_idx, "weight": weight,
            "mean_loss": mean_loss}


def mean_update(config: ExperimentConfig, params, round_idx: int,
                update_paths: list[str], device=None) -> dict:
    """Decode and fold update files against the global ``params`` (a flax
    tree) at ``round_idx``: ``{"mean_delta": flax tree of float32 tensors
    on ``device`` or None, "accepted", "total_weight", "rejected"}``.
    Torn, stale, undecodable and non-positive-weight files are skipped,
    each with its reason."""
    device = resolve_device(device)
    wsum = None
    total_w = 0.0
    accepted = 0
    rejected: list[str] = []
    for p in update_paths:
        try:
            delta, umeta = load_pytree_npz(p)
        except _BAD_UPDATE_ERRORS as e:
            rejected.append(f"bad update {p}: {type(e).__name__}: {e}")
            continue
        # An update computed against another global round must not be
        # folded in.
        if "round" in umeta and int(umeta["round"]) != round_idx:
            rejected.append(f"stale update {p}: computed at round "
                            f"{umeta['round']}, global model is at round "
                            f"{round_idx}")
            continue
        try:
            delta = compression.decompress_delta(delta, umeta, shapes=params)
            leaves = trees.flatten_up_to(params, delta)
        except _BAD_UPDATE_ERRORS as e:
            rejected.append(f"bad update {p}: {type(e).__name__}: {e}")
            continue
        w = float(umeta.get("weight", 1.0))
        if w <= 0:
            rejected.append(f"bad update {p}: non-positive weight {w}")
            continue
        contrib = [torch.from_numpy(np.asarray(l)).to(device) * w
                   for l in leaves]
        if wsum is None:
            wsum = contrib
        else:
            torch._foreach_add_(wsum, contrib)
        total_w += w
        accepted += 1
    mean = None
    if wsum is not None:
        torch._foreach_mul_(wsum, 1.0 / total_w)
        mean = trees.unflatten(params, wsum)
    return {"mean_delta": mean, "accepted": accepted,
            "total_weight": total_w, "rejected": rejected}


def aggregate_updates(
    config: ExperimentConfig,
    global_path: str,
    update_paths: list[str],
    out_path: str,
    device=None,
) -> dict:
    """``aggregate``: fold silo update files into a new global model with
    the configured server strategy.  A torn, stale or undecodable file is
    skipped (its reason in the returned ``rejected`` list); the round
    commits only when the accepted count reaches the quorum
    ``ceil(fed.min_cohort_fraction · files)`` (at least 1), else it raises
    with every skip reason."""
    if not update_paths:
        raise ValueError("aggregate_updates: no update files given")
    setup_lib.require_mean_aggregator(config, "the file-based aggregator")
    device = resolve_device(device)
    params, meta = load_pytree_npz(global_path)
    round_idx = int(meta.get("round", 0))
    folded = mean_update(config, params, round_idx, update_paths, device)
    accepted, rejected = folded["accepted"], folded["rejected"]
    quorum = max(1, math.ceil(config.fed.min_cohort_fraction
                              * len(update_paths)))
    if accepted < quorum:
        raise ValueError(
            f"aggregate_updates: only {accepted}/{len(update_paths)} updates "
            f"usable (quorum {quorum}); " + "; ".join(rejected))
    names = [str(i) for i in range(len(trees.leaves(params)))]
    state = strategies.init_server_state(
        {n: torch.from_numpy(np.asarray(l, np.float32)).to(device)
         for n, l in zip(names, trees.leaves(params))}, config.fed)
    state = strategies.server_update(
        state, dict(zip(names, trees.leaves(folded["mean_delta"]))),
        config.fed)
    new_params = trees.unflatten(
        params, [state.params[n].cpu().numpy() for n in names])
    total_w = folded["total_weight"]
    atomic_save_pytree_npz(out_path, new_params,
                           meta={"round": round_idx + 1,
                                 "config": config.run.name,
                                 "num_updates": accepted,
                                 "total_weight": total_w})
    out = {"round": round_idx + 1, "num_updates": accepted,
           "num_rejected": len(rejected), "total_weight": total_w}
    if rejected:
        out["rejected"] = rejected
    return out


def evaluate_global(config: ExperimentConfig, global_path: str,
                    dataset: Optional[data_registry.Dataset] = None,
                    detection: bool = False, device=None) -> dict:
    """Score a global-model file on the test set: ``{"round",
    "eval_loss", "eval_acc"}``."""
    if detection:
        raise NotImplementedError(
            "the detection report is not ported yet; see ROADMAP.md Queue A "
            "item 10 (telemetry, tracing and evaluation extras)")
    device = resolve_device(device)
    params, meta = load_pytree_npz(global_path)
    ds = dataset or data_registry.get_dataset(config.data.dataset,
                                              seed=config.run.seed)
    model = model_registry.build_model(
        setup_lib.local_model_config(config.model), device,
        input_shape=np.asarray(ds.x_test).shape[1:])
    eval_fn = evaluation.make_eval_fn(
        model, ds.x_test, ds.y_test, batch=max(config.fed.batch_size, 64),
        device=device)
    loss, acc = eval_fn(setup_lib.flax_to_params(model, params, device))
    return {"round": int(meta.get("round", 0)), "eval_loss": float(loss),
            "eval_acc": float(acc)}
