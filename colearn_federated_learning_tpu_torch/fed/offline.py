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

Under an installed FaultPlan (``faults/``), ``client_update`` calls the
file plane's fault hooks (``faults/fileplane.py``, hop ``update``): a
dropped silo writes no file, a stale one stamps the previous round, a
torn one is cut to half its bytes.  A residual that cannot be carried
counts in ``fed.offline_residual_resets_total`` and a skipped update file
in ``fed.offline_updates_rejected_total``, each by reason, as in JAX.
``evaluate_global(detection=True)`` adds JAX's detection report.
"""

from __future__ import annotations

import math
import zipfile
from typing import Optional

import numpy as np
import torch

from colearn_federated_learning_tpu_torch.data import registry as data_registry
from colearn_federated_learning_tpu_torch.data.sharding import pack_client_shards
from colearn_federated_learning_tpu_torch.faults import fileplane
from colearn_federated_learning_tpu_torch.fed import compression, evaluation
from colearn_federated_learning_tpu_torch.fed import programs, strategies
from colearn_federated_learning_tpu_torch.fed import setup as setup_lib
from colearn_federated_learning_tpu_torch.fed.engine import partition_for_config
from colearn_federated_learning_tpu_torch.models import registry as model_registry
from colearn_federated_learning_tpu_torch.telemetry import get_registry
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
    skipped), and a torn file resets it.  Resets count in
    ``fed.offline_residual_resets_total`` by reason."""
    reg = get_registry()
    try:
        prev, rmeta = load_pytree_npz(residual_path)
    except FileNotFoundError:
        return None
    except _BAD_UPDATE_ERRORS:
        reg.counter("fed.offline_residual_resets_total",
                    labels={"reason": "torn"}).inc()
        return None
    if int(rmeta.get("round", -1)) != round_idx - 1:
        reg.counter("fed.offline_residual_resets_total",
                    labels={"reason": "stale"}).inc()
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

    silo = str(client_id)
    if fileplane.should_drop(silo, round_idx, fileplane.HOP_UPDATE):
        # An injected silo dropout: no update file this round.
        return {"client_id": client_id, "round": round_idx, "weight": 0.0,
                "dropped": True}

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
    # A topk delta is selected where it was trained (N1 on a card): only
    # the kept entries come to the host.
    delta_np = (setup_lib.params_to_flax_tensors(model, delta, c)
                if c.fed.compress in compression.TOPK_SCHEMES
                else setup_lib.params_to_flax(model, delta, c))
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
            get_registry().counter("fed.offline_residual_resets_total",
                                   labels={"reason": "shape"}).inc()
            wire, cmeta, new_residual = compression.feedback_compress(
                delta_np, None, c.fed.compress,
                topk_fraction=c.fed.topk_fraction)
        if new_residual is not None:
            atomic_save_pytree_npz(
                residual_path, compression.host_tree(new_residual),
                meta={"round": round_idx, "client_id": client_id})
    else:
        wire, cmeta = compression.compress_delta(
            delta_np, c.fed.compress, topk_fraction=c.fed.topk_fraction)
    umeta = fileplane.stale_meta(
        {"round": round_idx, "weight": weight, "client_id": client_id,
         "num_examples": int(result.num_examples), "mean_loss": mean_loss,
         **cmeta}, silo, round_idx, fileplane.HOP_UPDATE)
    atomic_save_pytree_npz(out_path, wire, meta=umeta)
    fileplane.maybe_truncate(out_path, silo, round_idx, fileplane.HOP_UPDATE)
    return {"client_id": client_id, "round": round_idx, "weight": weight,
            "mean_loss": mean_loss}


def mean_update(config: ExperimentConfig, params, round_idx: int,
                update_paths: list[str], device=None) -> dict:
    """Decode and fold update files against the global ``params`` (a flax
    tree) at ``round_idx``: ``{"mean_delta": flax tree of float32 tensors
    on ``device`` or None, "accepted", "total_weight", "rejected"}``.
    Torn, stale, undecodable and non-positive-weight files are skipped,
    each with its reason, and counted in
    ``fed.offline_updates_rejected_total`` by reason."""
    device = resolve_device(device)
    reg = get_registry()
    wsum = None
    total_w = 0.0
    accepted = 0
    rejected: list[str] = []

    def reject(why: str, reason: str) -> None:
        reg.counter("fed.offline_updates_rejected_total",
                    labels={"reason": reason}).inc()
        rejected.append(why)

    for p in update_paths:
        try:
            delta, umeta = load_pytree_npz(p)
        except _BAD_UPDATE_ERRORS as e:
            reject(f"bad update {p}: {type(e).__name__}: {e}", "torn")
            continue
        # An update computed against another global round must not be
        # folded in.
        if "round" in umeta and int(umeta["round"]) != round_idx:
            reject(f"stale update {p}: computed at round {umeta['round']}, "
                   f"global model is at round {round_idx}", "stale")
            continue
        try:
            delta = compression.decompress_delta(delta, umeta, shapes=params)
            leaves = trees.flatten_up_to(params, delta)
        except _BAD_UPDATE_ERRORS as e:
            reject(f"bad update {p}: {type(e).__name__}: {e}", "decode")
            continue
        w = float(umeta.get("weight", 1.0))
        if w <= 0:
            reject(f"bad update {p}: non-positive weight {w}", "weight")
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
    "eval_loss", "eval_acc"}``; ``detection=True`` adds the detection
    view (``evaluation.detection_report``, class 0 benign) without its
    ``accuracy``, as JAX's does (``eval_acc`` is canonical)."""
    device = resolve_device(device)
    params, meta = load_pytree_npz(global_path)
    ds = dataset or data_registry.get_dataset(config.data.dataset,
                                              seed=config.run.seed)
    model = model_registry.build_model(
        setup_lib.local_model_config(config.model), device,
        input_shape=np.asarray(ds.x_test).shape[1:])
    batch = max(config.fed.batch_size, 64)
    eval_fn = evaluation.make_eval_fn(
        model, ds.x_test, ds.y_test, batch=batch, device=device)
    params = setup_lib.flax_to_params(model, params, device)
    loss, acc = eval_fn(params)
    out = {"round": int(meta.get("round", 0)), "eval_loss": float(loss),
           "eval_acc": float(acc)}
    if detection:
        conf_fn = evaluation.make_confusion_eval_fn(
            model, ds.x_test, ds.y_test, batch=batch,
            num_classes=config.model.num_classes, device=device)
        rep = evaluation.detection_report(conf_fn(params))
        rep.pop("accuracy", None)
        out.update(evaluation.sanitize_report(rep))
    return out
