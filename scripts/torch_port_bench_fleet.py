#!/usr/bin/env python3
"""Fleet-scale round bench of the port: chunked rounds from 1k to 1M clients.

The counterpart of the JAX package's ``scripts/bench_fleet.py``: the same
functions, flags, row schemas and output format, through the port's
``fleetsim``, ``comm`` and ``privacy`` modules.  It sweeps cohort size
over the fleet simulator (one ``FleetSim`` per sweep point, devices ==
cohort, so every round trains the full requested cohort) and records per
point:

- ``rounds_per_sec`` / ``clients_per_sec``: the chunk loop's throughput
  (round 0 is the warm-up and is not timed);
- ``bytes_up_per_round`` / ``bytes_down_per_round``: the wire codec's
  frame estimates (``utils.serialization.wire_frame_length`` x cohort);
- the mean round time to a device sync.

``--mask-sweep`` adds ``fleet_mask_cost`` rows (the analytic per-device
cost of dropout-tolerant secure aggregation, ``privacy/dropout.mask_cost``,
at ``--mask-devices`` under group-local masking, swept over the neighbor
count k); ``--uplink-sweep`` adds ``fleet_uplink_bytes`` rows (analytic
uplink frame bytes per ``fed.compress`` scheme at ``--uplink-devices``);
``--ingest-sweep`` adds ``fleet_ingest_scaling`` rows (the aggregator
tree's ingest bytes, ``comm/aggregator.expected_ingest``, and its fold
critical path priced from the host ``StreamingFolder``'s measured cost
per update); ``--async-sweep`` adds analytic ``fleet_async`` rows and one
measured ``fleet_async_prune`` and ``fleet_async_autok`` row each
(``FleetSim.fit_async``); ``--tree-async-sweep`` adds ``fleet_tree_async``
rows (measured through the two-tier ``fit_async`` up to 2,000 devices,
analytic above); ``--drift-sweep`` adds one measured ``fleet_learn_drift``
row (the observatory's ``conv_cohort_skew`` on a non-IID and an IID fleet).
The analytic rows equal the JAX script's row for row, but for their
wall-clock fields.

The simulated fleets train on the card unless ``--backend cpu`` is given;
without a card the script exits non-zero and writes no row.  Rows go to
``results/torch_port/fleet_bench.jsonl`` unless ``--out`` says otherwise.

    python3 scripts/torch_port_bench_fleet.py --cohorts 1000 --mask-sweep \\
        --uplink-sweep --ingest-sweep --async-sweep --tree-async-sweep \\
        --drift-sweep --check-schema
    python3 scripts/torch_port_bench_fleet.py --backend cpu --cohorts 32 \\
        --rounds 1 --chunk 16 --check-schema
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# Schema contract for every row this bench writes (the JAX script's
# ``SCHEMAS``, kept here as the port's own copy); --check-schema asserts it
# over the output file.  Rows carry a ``bench`` tag and are validated
# against the schema for that tag.
ROW_SCHEMA = {
    "bench": str,
    "devices": int,
    "cohort": int,
    "chunk": int,
    "rounds": int,
    "clients_trained": int,
    "rounds_per_sec": float,
    "clients_per_sec": float,
    "bytes_up_per_round": int,
    "bytes_down_per_round": int,
    "round_time_s_mean": float,
    "round_time_s_warmup": float,
    "train_loss": float,
    "param_count": int,
    "bench_wall_s": float,
}

MASK_ROW_SCHEMA = {
    "bench": str,
    "devices": int,
    "neighbors": int,
    "group_size": int,
    "param_count": int,
    "mask_flops_per_device": float,
    "share_bytes_per_device": float,
    "pairs_per_device": int,
    "flat_pairs_total": int,
    "grouped_pairs_total": int,
    "quadratic_ratio": float,
    "bench_wall_s": float,
}

UPLINK_ROW_SCHEMA = {
    "bench": str,
    "devices": int,
    "scheme": str,
    "topk_fraction": float,
    "param_count": int,
    "up_frame_bytes": int,
    "up_dense_bytes": int,
    "bytes_up_est_total": int,
    "bytes_up_saved_est_total": int,
    "uplink_reduction_x": float,
    "bench_wall_s": float,
}

INGEST_ROW_SCHEMA = {
    "bench": str,
    "devices": int,
    "aggregators": int,
    "param_count": int,
    "update_bytes": int,
    "partial_bytes": int,
    "agg_ingest_bytes": int,
    "root_ingest_bytes": int,
    "flat_root_ingest_bytes": int,
    "root_ingest_reduction_x": float,
    "ingest_scale_x": float,
    "fold_s_per_update": float,
    "agg_fold_s_est": float,
    "root_fold_s_est": float,
    "critical_path_fold_s_est": float,
    "flat_fold_s_est": float,
    "fold_speedup_x": float,
    "bench_wall_s": float,
}

ASYNC_ROW_SCHEMA = {
    "bench": str,
    "devices": int,
    "buffer_size": int,
    "max_staleness": int,
    "rate_per_device_hr": float,
    "service_mean_min": float,
    "straggler_fraction": float,
    "straggler_multiplier": float,
    "arrival_rate_per_min": float,
    "agg_rate_per_min": float,
    "staleness_mean_est": float,
    "waste_fraction": float,
    "arrival_tracking": float,
    "async_updates_per_min": float,
    "sync_quantile": float,
    "sync_round_min": float,
    "sync_updates_per_min": float,
    "async_speedup_x": float,
    "bench_wall_s": float,
}

ASYNC_PRUNE_ROW_SCHEMA = {
    "bench": str,
    "devices": int,
    "buffer_size": int,
    "aggregations": int,
    "max_staleness": int,
    "prune_after": int,
    "probation": int,
    "wasted_updates_unpruned": int,
    "wasted_updates_pruned": int,
    "waste_reduction_x": float,
    "pruned_total": int,
    "final_loss_unpruned": float,
    "final_loss_pruned": float,
    "loss_gap": float,
    "bench_wall_s": float,
}

ASYNC_AUTOK_ROW_SCHEMA = {
    "bench": str,
    "devices": int,
    "aggregations": int,
    "max_staleness": int,
    "target_interval_min": float,
    "fixed_ks": str,
    "best_fixed_k": int,
    "tracking_auto": float,
    "tracking_best_fixed": float,
    "tracking_margin": float,
    "final_loss_auto": float,
    "final_loss_best_fixed": float,
    "loss_gap": float,
    "buffer_k_min_auto": int,
    "buffer_k_max_auto": int,
    "arrival_rate_per_min": float,
    "bench_wall_s": float,
}

DRIFT_ROW_SCHEMA = {
    "bench": str,
    "devices": int,
    "rounds": int,
    "label_skew_noniid": float,
    "label_skew_iid": float,
    "cohort_skew_noniid_mean": float,
    "cohort_skew_noniid_max": float,
    "cohort_skew_iid_mean": float,
    "cohort_skew_iid_max": float,
    "skew_separation": float,
    "update_norm_final_noniid": float,
    "update_norm_final_iid": float,
    "bench_wall_s": float,
}

TREE_ASYNC_ROW_SCHEMA = {
    "bench": str,
    "mode": str,                  # "measured" | "analytic"
    "devices": int,
    "aggregators": int,
    "target_interval_min": float,
    "max_staleness": int,
    "arrival_rate_per_min": float,
    "agg_rate_per_min": float,
    "buffer_k_mean": float,
    "fold_tracking_min": float,
    "staleness_mean": float,
    "waste_fraction": float,
    "rehome_slice_frac": float,
    "bench_wall_s": float,
}

SCHEMAS = {
    "fleet_round": ROW_SCHEMA,
    "fleet_learn_drift": DRIFT_ROW_SCHEMA,
    "fleet_mask_cost": MASK_ROW_SCHEMA,
    "fleet_uplink_bytes": UPLINK_ROW_SCHEMA,
    "fleet_ingest_scaling": INGEST_ROW_SCHEMA,
    "fleet_async": ASYNC_ROW_SCHEMA,
    "fleet_async_prune": ASYNC_PRUNE_ROW_SCHEMA,
    "fleet_async_autok": ASYNC_AUTOK_ROW_SCHEMA,
    "fleet_tree_async": TREE_ASYNC_ROW_SCHEMA,
}


def bench_config(feature_dim: int, num_classes: int):
    """A deliberately small model: the bench measures the per-client
    dispatch machinery, so the model just has to be non-trivial (two
    dense layers), not accurate."""
    from colearn_federated_learning_tpu_torch.utils.config import (
        ExperimentConfig, FedConfig, ModelConfig, RunConfig)

    return ExperimentConfig(
        model=ModelConfig(name="mlp", num_classes=num_classes,
                          hidden_dim=32, depth=1),
        fed=FedConfig(strategy="fedavg", local_steps=2, batch_size=8,
                      lr=0.05, momentum=0.0),
        run=RunConfig(name="bench_fleet", seed=0),
    )


def _mlp_config(name: str, seed: int, learn_observe: bool = False):
    """The asynchronous and drift points' model: JAX's MLP 32-64-64-10."""
    from colearn_federated_learning_tpu_torch.utils.config import (
        ExperimentConfig, FedConfig, ModelConfig, RunConfig)

    return ExperimentConfig(
        model=ModelConfig(name="mlp", num_classes=10, hidden_dim=64,
                          depth=2),
        fed=FedConfig(strategy="fedavg", local_steps=2, batch_size=16,
                      lr=0.05),
        run=RunConfig(name=name, seed=seed, learn_observe=learn_observe))


def _skewed_population(devices: int, seed: int, label_skew: float = 0.7):
    from colearn_federated_learning_tpu_torch import fleetsim

    spec = fleetsim.PopulationSpec(num_devices=devices, num_classes=10,
                                   feature_dim=32, shard_capacity=16,
                                   label_skew=label_skew, seed=seed)
    return spec, fleetsim.DevicePopulation(spec)


def run_point(cohort: int, rounds: int, chunk: int, seed: int, *,
              device=None, draws=None, flax_params=None) -> dict:
    """One ``fleet_round`` row: ``rounds`` timed rounds after one warm-up
    round of a fleet of ``cohort`` devices on ``device`` (None: the card).
    ``draws`` and ``flax_params`` replace the port's own draws and initial
    params (the tests replay the JAX package's)."""
    from colearn_federated_learning_tpu_torch import fleetsim

    spec = fleetsim.PopulationSpec(
        num_devices=cohort, num_classes=10, feature_dim=16,
        shard_capacity=16, min_examples=4, seed=seed)
    population = fleetsim.DevicePopulation(spec)
    # High base rate -> ~every device available: the sweep measures
    # throughput at the REQUESTED cohort, not the traffic model.
    traffic = fleetsim.TrafficModel(
        fleetsim.TrafficSpec(base_rate=2000.0, diurnal_amplitude=0.0,
                             seed=seed),
        spec.num_devices)
    config = bench_config(spec.feature_dim, spec.num_classes)
    sim = fleetsim.FleetSim.from_population(
        config, population, traffic, cohort_size=cohort, chunk_size=chunk,
        device=device, draws=draws)
    if flax_params is not None:
        sim.load_flax_params(flax_params)

    t0 = time.time()
    history = sim.fit(rounds + 1)          # round 0 is the warm-up
    wall = time.time() - t0
    measured = history[1:]
    times = [r["round_time_s"] for r in measured]
    clients = sum(r["clients_trained"] for r in measured)
    span = sum(times) or 1e-9
    return {
        "bench": "fleet_round",
        "devices": spec.num_devices,
        "cohort": cohort,
        "chunk": sim.chunk_size,
        "rounds": len(measured),
        "clients_trained": int(clients),
        "rounds_per_sec": round(len(measured) / span, 4),
        "clients_per_sec": round(clients / span, 1),
        "bytes_up_per_round": int(statistics.mean(
            r["bytes_up_est"] for r in measured)),
        "bytes_down_per_round": int(statistics.mean(
            r["bytes_down_est"] for r in measured)),
        "round_time_s_mean": round(statistics.mean(times), 4),
        "round_time_s_warmup": round(history[0]["round_time_s"], 4),
        "train_loss": float(measured[-1]["train_loss"]),
        "param_count": int(sum(p.numel() for p in
                               sim.server_state.params.values())),
        "bench_wall_s": round(wall, 1),
    }


def bench_params(seed: int) -> dict:
    """The bench model's parameters in the flax layout (host arrays),
    drawn once on the CPU (the model does not depend on the fleet's size,
    so the 1M-cohort mask and uplink sweeps never materialize a fleet)."""
    from colearn_federated_learning_tpu_torch.fed import setup as setup_lib
    from colearn_federated_learning_tpu_torch.models import (
        registry as model_registry)
    from colearn_federated_learning_tpu_torch.utils import prng

    config = bench_config(16, 10)
    model = model_registry.build_model(
        setup_lib.local_model_config(config.model), "cpu",
        generator=prng.init_generator(seed), input_shape=(16,))
    return setup_lib.params_to_flax(model, None, config)


def _param_count(params) -> int:
    import numpy as np

    from colearn_federated_learning_tpu_torch.utils import trees

    return int(sum(np.asarray(p).size for p in trees.leaves(params)))


def bench_param_count(seed: int) -> int:
    return _param_count(bench_params(seed))


def _zeros(params):
    import numpy as np

    from colearn_federated_learning_tpu_torch.utils import trees

    return trees.map_leaves(
        lambda p: np.zeros(np.shape(p), np.float32), params)


def uplink_point(devices: int, scheme: str, topk_fraction: float,
                 params) -> dict:
    """One uplink wire-cost row: per-device train-reply frame bytes under
    ``scheme`` against the dense frame, scaled to ``devices`` reporting
    clients.  Shape-only (frame lengths depend on leaf shapes and dtypes,
    not values): ``fleetsim``'s ``up_frame_bytes``/``up_saved_bytes``
    pricing."""
    from colearn_federated_learning_tpu_torch.fed import compression
    from colearn_federated_learning_tpu_torch.utils.serialization import (
        wire_frame_length)

    t0 = time.time()
    zeros = _zeros(params)
    dense = int(wire_frame_length(
        zeros, {"round": 0, "op": "train", "compress": "none"}))
    if scheme == "none":
        up = dense
    else:
        wire, meta = compression.compress_delta(
            zeros, scheme, topk_fraction=topk_fraction)
        up = int(wire_frame_length(wire, {"round": 0, "op": "train", **meta}))
    saved = max(0, dense - up)
    return {
        "bench": "fleet_uplink_bytes",
        "devices": devices,
        "scheme": scheme,
        "topk_fraction": float(topk_fraction),
        "param_count": _param_count(params),
        "up_frame_bytes": up,
        "up_dense_bytes": dense,
        "bytes_up_est_total": devices * up,
        "bytes_up_saved_est_total": devices * saved,
        "uplink_reduction_x": round(dense / up, 2),
        "bench_wall_s": round(time.time() - t0, 4),
    }


def measured_fold_s_per_update(params, folds: int = 64) -> float:
    """The host ``StreamingFolder``'s cost per update (dense add and
    finalize, amortized) on this host.  The tree changes where the fold
    runs, not the work per update, so one measured constant prices every
    ingest row."""
    import numpy as np

    from colearn_federated_learning_tpu_torch.comm.aggregation import (
        StreamingFolder)
    from colearn_federated_learning_tpu_torch.utils import trees

    shapes = trees.map_leaves(np.asarray, params)
    update = trees.map_leaves(
        lambda p: np.ones(np.shape(p), np.float32), params)
    folder = StreamingFolder(shapes)
    t0 = time.perf_counter()
    for i in range(folds):
        folder.add({"client_id": str(i), "weight": 1.0, "train_loss": 0.0},
                   update)
    folder.finalize()
    return (time.perf_counter() - t0) / folds


def ingest_point(devices: int, n_aggregators: int, params,
                 fold_s_per_update: float) -> dict:
    """One aggregator-tree ingest row at ``devices`` cohort and
    ``n_aggregators`` fan-in: analytic wire bytes per tier and the fold
    critical path from the measured cost per update."""
    from colearn_federated_learning_tpu_torch.comm import aggregator
    from colearn_federated_learning_tpu_torch.utils.serialization import (
        wire_frame_length)

    t0 = time.time()
    zeros = _zeros(params)
    update_bytes = int(wire_frame_length(
        zeros, {"round": 0, "op": "train", "compress": "none"}))
    # A partial sum is one dense tree whatever the slice's size: the
    # root ingests N frames, not C.
    partial_bytes = int(wire_frame_length(
        zeros, {"round": 0, "op": "fold", "agg_id": 0}))
    bill = aggregator.expected_ingest(devices, n_aggregators,
                                      update_bytes, partial_bytes)
    per_agg = math.ceil(devices / max(1, n_aggregators))
    agg_fold = per_agg * fold_s_per_update
    root_fold = n_aggregators * fold_s_per_update
    flat_fold = devices * fold_s_per_update
    critical = agg_fold + root_fold
    return {
        "bench": "fleet_ingest_scaling",
        "devices": devices,
        "aggregators": n_aggregators,
        "param_count": _param_count(params),
        "update_bytes": update_bytes,
        "partial_bytes": partial_bytes,
        "agg_ingest_bytes": bill["agg_ingest_bytes"],
        "root_ingest_bytes": bill["root_ingest_bytes"],
        "flat_root_ingest_bytes": bill["flat_root_ingest_bytes"],
        "root_ingest_reduction_x": round(
            bill["flat_root_ingest_bytes"]
            / max(1, bill["root_ingest_bytes"]), 2),
        "ingest_scale_x": round(
            bill["flat_root_ingest_bytes"]
            / max(1, bill["agg_ingest_bytes"]), 2),
        "fold_s_per_update": round(fold_s_per_update, 9),
        "agg_fold_s_est": round(agg_fold, 4),
        "root_fold_s_est": round(root_fold, 4),
        "critical_path_fold_s_est": round(critical, 4),
        "flat_fold_s_est": round(flat_fold, 4),
        "fold_speedup_x": round(flat_fold / critical, 2),
        "bench_wall_s": round(time.time() - t0, 4),
    }


def mask_point(devices: int, neighbors: int, group_size: int,
               param_count: int) -> dict:
    """One masked-uplink cost row: per-device PRG FLOPs and recovery-share
    bytes under group-local secure aggregation at ``devices`` cohort, and
    the flat graph's quadratic total that the layering avoids
    (``quadratic_ratio``)."""
    from colearn_federated_learning_tpu_torch.privacy import dropout

    t0 = time.time()
    cost = dropout.mask_cost(cohort=devices, param_count=param_count,
                             neighbors=neighbors, group_size=group_size)
    return {
        "bench": "fleet_mask_cost",
        "devices": devices,
        "neighbors": neighbors,
        "group_size": group_size,
        "param_count": param_count,
        "mask_flops_per_device": cost["mask_flops_per_device"],
        "share_bytes_per_device": cost["share_bytes_per_device"],
        "pairs_per_device": cost["pairs_per_device"],
        "flat_pairs_total": cost["flat_pairs_total"],
        "grouped_pairs_total": cost["grouped_pairs_total"],
        "quadratic_ratio": round(
            cost["flat_pairs_total"] / max(1, cost["grouped_pairs_total"]),
            2),
        "bench_wall_s": round(time.time() - t0, 4),
    }


def _completion_windows(seed: int, samples: int, rate_per_min: float,
                        service_mean_min: float, straggler_fraction: float,
                        straggler_multiplier: float):
    """Per-device completion windows (arrival wait plus service time) of
    ``samples`` devices: ``fit_async``'s service model, drawn in the JAX
    script's order from the same seed."""
    import numpy as np

    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xA51C]))
    wait = rng.exponential(1.0 / rate_per_min, size=samples)
    service = service_mean_min * rng.lognormal(0.0, 0.5, size=samples)
    n_slow = int(round(straggler_fraction * samples))
    slow = rng.permutation(samples)[:n_slow]
    service[slow] *= straggler_multiplier
    return wait + service


def async_point(devices: int, *, rate_per_device_hr: float = 2.0,
                service_mean_min: float = 10.0,
                straggler_fraction: float = 0.05,
                straggler_multiplier: float = 20.0,
                buffer_divisor: int = 16, max_staleness: int = 32,
                sync_quantile: float = 0.98, seed: int = 0,
                samples: int = 65536) -> dict:
    """One buffered-asynchronous throughput row at ``devices`` fleet
    scale, analytic over a ``samples``-device draw of ``fit_async``'s
    service model.  The asynchronous server folds arrivals as they land
    (aggregation rate = surviving arrival rate / buffer size; an update's
    staleness is its window times that rate; past ``max_staleness`` it is
    discarded; waste and rate from a fixed point), while a synchronous
    round waits for the cohort's ``sync_quantile`` completion time, which
    the chronic stragglers' tail sets."""
    import numpy as np

    t0 = time.time()
    rate_per_min = rate_per_device_hr / 60.0
    window = _completion_windows(seed, samples, rate_per_min,
                                 service_mean_min, straggler_fraction,
                                 straggler_multiplier)

    buffer_size = max(32, devices // buffer_divisor)
    arrival_rate = devices * rate_per_min
    waste = 0.0
    agg_rate = arrival_rate / buffer_size
    for _ in range(32):
        waste = float(np.mean(window * agg_rate > max_staleness))
        agg_rate = arrival_rate * (1.0 - waste) / buffer_size
    staleness_mean = float(np.mean(
        np.minimum(window * agg_rate, max_staleness)))
    async_updates_per_min = arrival_rate * (1.0 - waste)

    sync_round_min = float(np.quantile(window, sync_quantile))
    sync_updates_per_min = devices * sync_quantile / sync_round_min

    return {
        "bench": "fleet_async",
        "devices": devices,
        "buffer_size": buffer_size,
        "max_staleness": max_staleness,
        "rate_per_device_hr": rate_per_device_hr,
        "service_mean_min": service_mean_min,
        "straggler_fraction": straggler_fraction,
        "straggler_multiplier": straggler_multiplier,
        "arrival_rate_per_min": round(arrival_rate, 4),
        "agg_rate_per_min": round(agg_rate, 6),
        "staleness_mean_est": round(staleness_mean, 3),
        "waste_fraction": round(waste, 4),
        "arrival_tracking": round(1.0 - waste, 4),
        "async_updates_per_min": round(async_updates_per_min, 4),
        "sync_quantile": sync_quantile,
        "sync_round_min": round(sync_round_min, 3),
        "sync_updates_per_min": round(sync_updates_per_min, 4),
        "async_speedup_x": round(
            async_updates_per_min / sync_updates_per_min, 3),
        "bench_wall_s": round(time.time() - t0, 4),
    }


def _tail_loss(history) -> float:
    losses = [r["train_loss"] for r in history[-5:]]
    return sum(losses) / max(1, len(losses))


def async_prune_point(*, devices: int = 64, aggregations: int = 40,
                      buffer_size: int = 8, max_staleness: int = 6,
                      prune_after: int = 1, probation: int = 40,
                      seed: int = 0, device=None) -> dict:
    """One measured straggler-pruning row: ``fit_async`` twice on the same
    seeded fleet, pruning off and on, with the wasted (too stale,
    discarded) updates and the tail loss of each."""
    from colearn_federated_learning_tpu_torch import fleetsim

    t0 = time.time()
    spec, population = _skewed_population(devices, seed)
    config = _mlp_config("bench-async-prune", seed)

    results = {}
    for label, pa in (("unpruned", 0), ("pruned", prune_after)):
        traffic = fleetsim.TrafficModel(fleetsim.TrafficSpec(seed=seed),
                                        spec.num_devices)
        sim = fleetsim.FleetSim.from_population(
            config, population, traffic, cohort_size=8, chunk_size=16,
            device=device)
        hist = sim.fit_async(aggregations, buffer_size=buffer_size,
                             max_staleness=max_staleness, prune_after=pa,
                             probation=probation)
        results[label] = {
            "wasted": int(hist[-1]["wasted_updates_total"]),
            "loss": _tail_loss(hist),
            "pruned_total": int(hist[-1].get("pruned_total", 0)),
        }
    wasted_un = results["unpruned"]["wasted"]
    wasted_pr = results["pruned"]["wasted"]
    return {
        "bench": "fleet_async_prune",
        "devices": devices,
        "buffer_size": buffer_size,
        "aggregations": aggregations,
        "max_staleness": max_staleness,
        "prune_after": prune_after,
        "probation": probation,
        "wasted_updates_unpruned": wasted_un,
        "wasted_updates_pruned": wasted_pr,
        "waste_reduction_x": round(wasted_un / max(1, wasted_pr), 3),
        "pruned_total": results["pruned"]["pruned_total"],
        "final_loss_unpruned": round(results["unpruned"]["loss"], 5),
        "final_loss_pruned": round(results["pruned"]["loss"], 5),
        "loss_gap": round(
            abs(results["pruned"]["loss"] - results["unpruned"]["loss"]),
            5),
        "bench_wall_s": round(time.time() - t0, 4),
    }


def async_autok_point(*, devices: int = 64, aggregations: int = 120,
                      max_staleness: int = 6, fixed_ks=(4, 8, 16, 32),
                      target_interval_min: float = 10.0,
                      seed: int = 0, device=None) -> dict:
    """One measured adaptive-buffering row: ``fit_async`` over a fixed-K
    sweep and once with ``buffer_size="auto"`` on the same seeded fleet.
    Tracking is the share of fold intervals inside [target/2, 2 x
    target]; 120 aggregations span most of a diurnal cycle, so the
    arrival rate's swing carries every fixed K out of the band for part of
    the run while auto-K follows the measured rate."""
    from colearn_federated_learning_tpu_torch import fleetsim

    t0 = time.time()
    spec, population = _skewed_population(devices, seed)
    config = _mlp_config("bench-async-autok", seed)

    def tracking(history):
        times = [0.0] + [r["sim_time_min"] for r in history]
        ivs = [b - a for a, b in zip(times, times[1:])]
        in_band = sum(1 for iv in ivs
                      if target_interval_min / 2.0 <= iv
                      <= target_interval_min * 2.0)
        return in_band / max(1, len(ivs))

    def run(buffer_size):
        traffic = fleetsim.TrafficModel(fleetsim.TrafficSpec(seed=seed),
                                        spec.num_devices)
        sim = fleetsim.FleetSim.from_population(
            config, population, traffic, cohort_size=32, chunk_size=32,
            device=device)
        return sim.fit_async(aggregations, buffer_size=buffer_size,
                             max_staleness=max_staleness,
                             auto_interval_min=target_interval_min)

    fixed = {}
    for k in fixed_ks:
        hist = run(k)
        fixed[k] = {"tracking": tracking(hist), "loss": _tail_loss(hist)}
    best_k = max(fixed, key=lambda k: fixed[k]["tracking"])
    auto_hist = run("auto")
    auto_tracking = tracking(auto_hist)
    auto_loss = _tail_loss(auto_hist)
    auto_ks = [r["buffer_size"] for r in auto_hist]
    return {
        "bench": "fleet_async_autok",
        "devices": devices,
        "aggregations": aggregations,
        "max_staleness": max_staleness,
        "target_interval_min": target_interval_min,
        "fixed_ks": ",".join(str(k) for k in fixed_ks),
        "best_fixed_k": int(best_k),
        "tracking_auto": round(auto_tracking, 4),
        "tracking_best_fixed": round(fixed[best_k]["tracking"], 4),
        "tracking_margin": round(
            auto_tracking - fixed[best_k]["tracking"], 4),
        "final_loss_auto": round(auto_loss, 5),
        "final_loss_best_fixed": round(fixed[best_k]["loss"], 5),
        "loss_gap": round(abs(auto_loss - fixed[best_k]["loss"]), 5),
        "buffer_k_min_auto": int(min(auto_ks)),
        "buffer_k_max_auto": int(max(auto_ks)),
        "arrival_rate_per_min": round(
            auto_hist[-1]["arrival_rate_per_min"], 4),
        "bench_wall_s": round(time.time() - t0, 4),
    }


def tree_async_measured_point(*, devices: int = 1000, aggregators: int = 2,
                              aggregations: int = 24,
                              max_staleness: int = 50,
                              prune_after: int = 2,
                              target_interval_min: float = 10.0,
                              chunk: int = 256, seed: int = 0,
                              device=None) -> dict:
    """One measured tree-async row: the two-tier ``fit_async`` on a seeded
    fleet (service-time-sorted slices, per-slice auto-K buffers, partials
    discounted at the root against their oldest constituent), with pruning
    armed so that chronic stragglers stop being re-dispatched."""
    from colearn_federated_learning_tpu_torch import fleetsim

    t0 = time.time()
    spec, population = _skewed_population(devices, seed)
    traffic = fleetsim.TrafficModel(fleetsim.TrafficSpec(seed=seed),
                                    spec.num_devices)
    config = _mlp_config("bench-tree-async", seed)
    sim = fleetsim.FleetSim.from_population(
        config, population, traffic, cohort_size=chunk, chunk_size=chunk,
        device=device)
    hist = sim.fit_async(aggregations, buffer_size="auto",
                         max_staleness=max_staleness,
                         prune_after=prune_after,
                         auto_interval_min=target_interval_min,
                         aggregators=aggregators)
    last = hist[-1]
    arrived = last["arrival_rate_per_min"] * last["sim_time_min"]
    return {
        "bench": "fleet_tree_async",
        "mode": "measured",
        "devices": devices,
        "aggregators": aggregators,
        "target_interval_min": target_interval_min,
        "max_staleness": max_staleness,
        "arrival_rate_per_min": round(last["arrival_rate_per_min"], 4),
        "agg_rate_per_min": round(last["agg_rate_per_min"], 6),
        "buffer_k_mean": round(
            sum(r["agg_buffer_k"] for r in hist) / len(hist), 3),
        "fold_tracking_min": round(last["agg_fold_tracking_min"], 4),
        "staleness_mean": round(
            sum(r["staleness_mean"] for r in hist) / len(hist), 3),
        "waste_fraction": round(
            last["wasted_updates_total"] / max(arrived, 1e-9), 4),
        "rehome_slice_frac": round(1.0 / aggregators, 4),
        "bench_wall_s": round(time.time() - t0, 4),
    }


def tree_async_analytic_point(devices: int, aggregators: int, *,
                              rate_per_device_hr: float = 2.0,
                              service_mean_min: float = 10.0,
                              straggler_fraction: float = 0.05,
                              straggler_multiplier: float = 20.0,
                              target_interval_min: float = 10.0,
                              max_staleness: int = 32,
                              chunk: int = 4096, seed: int = 0,
                              samples: int = 65536) -> dict:
    """One analytic tree-async row at fleet scale: :func:`async_point`'s
    arrival and service model sliced across ``aggregators`` per-slice
    buffers.  Each slice's integer K = clip(rate x target, 1, chunk) sets
    its fold cadence, whose tracking is measured against the slice's
    achievable band; the root applies one partial per ship, so the version
    rate is the summed ship rate, and the waste comes from the same fixed
    point as on the flat plane."""
    import numpy as np

    t0 = time.time()
    rate_per_min = rate_per_device_hr / 60.0
    window = _completion_windows(seed, samples, rate_per_min,
                                 service_mean_min, straggler_fraction,
                                 straggler_multiplier)

    arrival_rate = devices * rate_per_min
    rate_slice = arrival_rate / aggregators
    k = int(np.clip(round(rate_slice * target_interval_min), 1, chunk))
    t_real = k / rate_slice
    t_eff = float(np.clip(target_interval_min, 1.0 / rate_slice,
                          chunk / rate_slice))
    r = t_real / max(t_eff, 1e-9)
    tracking = min(r, 1.0 / r) if r > 0 else 0.0
    version_rate = aggregators / t_real
    waste = 0.0
    for _ in range(32):
        waste = float(np.mean(window * version_rate > max_staleness))
        version_rate = (aggregators / t_real) * (1.0 - waste)
    staleness_mean = float(np.mean(
        np.minimum(window * version_rate, max_staleness)))
    return {
        "bench": "fleet_tree_async",
        "mode": "analytic",
        "devices": devices,
        "aggregators": aggregators,
        "target_interval_min": target_interval_min,
        "max_staleness": max_staleness,
        "arrival_rate_per_min": round(arrival_rate, 4),
        "agg_rate_per_min": round(version_rate, 6),
        "buffer_k_mean": float(k),
        "fold_tracking_min": round(tracking, 4),
        "staleness_mean": round(staleness_mean, 3),
        "waste_fraction": round(waste, 4),
        "rehome_slice_frac": round(1.0 / aggregators, 4),
        "bench_wall_s": round(time.time() - t0, 4),
    }


def tree_aggregators(devices: int) -> int:
    """The tree sweep's fan-in: 2 aggregators at 1k, doubling per decade
    to 16 at 1M (the ingest sweep's sizing)."""
    return int(min(16, max(2, 2 ** (int(math.log10(max(devices, 10))) - 2))))


def drift_point(*, devices: int = 64, rounds: int = 10,
                label_skew_noniid: float = 0.9,
                label_skew_iid: float = 0.0, seed: int = 0,
                device=None) -> dict:
    """One measured cohort-drift row: two observed fleet runs at matched
    seeds that differ only in the population's label skew.
    ``conv_cohort_skew`` must separate the non-IID fleet from the IID one.
    The first two rounds (init transients on both fleets) are left out of
    the means."""
    from colearn_federated_learning_tpu_torch import fleetsim

    t0 = time.time()

    def run(label_skew: float) -> list:
        spec, population = _skewed_population(devices, seed, label_skew)
        traffic = fleetsim.TrafficModel(
            fleetsim.TrafficSpec(base_rate=2000.0, diurnal_amplitude=0.0,
                                 seed=seed),
            spec.num_devices)
        config = _mlp_config("bench-learn-drift", seed, learn_observe=True)
        sim = fleetsim.FleetSim.from_population(
            config, population, traffic, cohort_size=32, chunk_size=32,
            device=device)
        return sim.fit(rounds)

    def skew_stats(history) -> tuple:
        vals = [r["conv_cohort_skew"] for r in history[2:]
                if "conv_cohort_skew" in r]
        if not vals:
            raise AssertionError(
                "no conv_cohort_skew in the observed round records")
        return (sum(vals) / len(vals), max(vals))

    noniid = run(label_skew_noniid)
    iid = run(label_skew_iid)
    nm, nx = skew_stats(noniid)
    im, ix = skew_stats(iid)
    return {
        "bench": "fleet_learn_drift",
        "devices": devices,
        "rounds": rounds,
        "label_skew_noniid": label_skew_noniid,
        "label_skew_iid": label_skew_iid,
        "cohort_skew_noniid_mean": round(nm, 4),
        "cohort_skew_noniid_max": round(nx, 4),
        "cohort_skew_iid_mean": round(im, 4),
        "cohort_skew_iid_max": round(ix, 4),
        "skew_separation": round(nm - im, 4),
        "update_norm_final_noniid": round(
            noniid[-1]["conv_update_norm"], 5),
        "update_norm_final_iid": round(iid[-1]["conv_update_norm"], 5),
        "bench_wall_s": round(time.time() - t0, 4),
    }


def check_schema(path: str) -> int:
    """Validate every row of a bench JSONL against the schema for its
    ``bench`` tag."""
    bad = 0
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    if not rows:
        print(f"FAIL: {path} is empty", file=sys.stderr)
        return 1
    for i, row in enumerate(rows):
        schema = SCHEMAS.get(row.get("bench"), ROW_SCHEMA)
        for key, typ in schema.items():
            if key not in row:
                print(f"FAIL: row {i} missing {key!r}", file=sys.stderr)
                bad += 1
            elif typ is float and not isinstance(row[key], (int, float)):
                print(f"FAIL: row {i} {key!r} not numeric", file=sys.stderr)
                bad += 1
            elif typ is not float and not isinstance(row[key], typ):
                print(f"FAIL: row {i} {key!r} not {typ.__name__}",
                      file=sys.stderr)
                bad += 1
        if schema is ROW_SCHEMA and row.get("clients_trained", 0) <= 0:
            print(f"FAIL: row {i} trained no clients", file=sys.stderr)
            bad += 1
    if not bad:
        print(f"schema ok: {len(rows)} row(s) in {path}")
    return 1 if bad else 0


def resolve_backend(backend: str):
    """The device the fleets train on: ``None`` (the card) for ``gpu``,
    which needs one, or the CPU when the caller asked for it."""
    if backend == "cpu":
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device (pass --backend cpu to run on the CPU)",
              file=sys.stderr)
        raise SystemExit(1)
    return None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=["gpu", "cpu"], default="gpu",
                    help="the card (default; exits non-zero without one) "
                         "or the CPU")
    ap.add_argument("--cohorts", default="1000,10000,100000,1000000",
                    help="comma-separated cohort sizes (devices == cohort)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="measured rounds per point (after 1 warmup)")
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(
        REPO, "results", "torch_port", "fleet_bench.jsonl"))
    ap.add_argument("--check-schema", action="store_true",
                    help="after the sweep, validate the output JSONL "
                         "against the per-bench schemas and fail on any "
                         "mismatch")
    ap.add_argument("--mask-sweep", action="store_true",
                    help="append fleet_mask_cost rows: the analytic "
                         "secure-agg masked-uplink cost per device at "
                         "--mask-devices, swept over --mask-neighbors")
    ap.add_argument("--mask-devices", type=int, default=1_000_000,
                    help="cohort size for the mask-cost sweep")
    ap.add_argument("--mask-neighbors", default="0,2,4,8,16",
                    help="comma-separated neighbor counts k to sweep "
                         "(0 = complete graph WITHIN the group)")
    ap.add_argument("--mask-group-size", type=int, default=1024,
                    help="group-local masking group size (0 = flat "
                         "all-cohort graph)")
    ap.add_argument("--uplink-sweep", action="store_true",
                    help="append fleet_uplink_bytes rows: analytic "
                         "per-scheme uplink frame bytes at "
                         "--uplink-devices")
    ap.add_argument("--uplink-devices", type=int, default=1_000_000,
                    help="reporting-device count for the uplink sweep")
    ap.add_argument("--uplink-schemes", default="none,int8,topk",
                    help="comma-separated fed.compress schemes to sweep")
    ap.add_argument("--uplink-topk-fraction", type=float, default=0.05,
                    help="topk density for the uplink sweep")
    ap.add_argument("--ingest-sweep", action="store_true",
                    help="append fleet_ingest_scaling rows: root ingest "
                         "bytes and fold critical path at --ingest-devices "
                         "swept over --ingest-aggregators")
    ap.add_argument("--ingest-devices", type=int, default=1_000_000,
                    help="cohort size for the ingest-scaling sweep")
    ap.add_argument("--ingest-aggregators", default="1,2,4",
                    help="comma-separated aggregator counts N to sweep")
    ap.add_argument("--async-sweep", action="store_true",
                    help="append fleet_async rows over --async-devices "
                         "(analytic) plus one measured fleet_async_prune "
                         "and one fleet_async_autok row")
    ap.add_argument("--async-devices", default="1000,10000,100000,1000000",
                    help="comma-separated fleet sizes for the async "
                         "throughput sweep")
    ap.add_argument("--tree-async-sweep", action="store_true",
                    help="append fleet_tree_async rows over "
                         "--tree-async-devices (measured up to 2000 "
                         "devices, analytic above)")
    ap.add_argument("--tree-async-devices",
                    default="1000,10000,100000,1000000",
                    help="comma-separated fleet sizes for the tree-"
                         "async sweep (<= 2000 devices run measured)")
    ap.add_argument("--drift-sweep", action="store_true",
                    help="append ONE measured fleet_learn_drift row: "
                         "conv_cohort_skew on non-IID (label_skew 0.9) "
                         "vs IID (0.0) populations")
    ap.add_argument("--append", action="store_true",
                    help="append rows to --out instead of rewriting it")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_backend(args.backend)

    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for cohort in (int(c) for c in args.cohorts.split(",") if c):
        emit(run_point(cohort, args.rounds, args.chunk, args.seed,
                       device=device))
    if args.mask_sweep:
        param_count = bench_param_count(args.seed)
        for k in (int(x) for x in args.mask_neighbors.split(",") if x):
            emit(mask_point(args.mask_devices, k, args.mask_group_size,
                            param_count))
    if args.uplink_sweep:
        params = bench_params(args.seed)
        for scheme in (s for s in args.uplink_schemes.split(",") if s):
            emit(uplink_point(args.uplink_devices, scheme,
                              args.uplink_topk_fraction, params))
    if args.ingest_sweep:
        params = bench_params(args.seed)
        fold_s = measured_fold_s_per_update(params)
        for n in (int(x) for x in args.ingest_aggregators.split(",") if x):
            emit(ingest_point(args.ingest_devices, n, params, fold_s))
    if args.async_sweep:
        for n in (int(x) for x in args.async_devices.split(",") if x):
            emit(async_point(n, seed=args.seed))
        emit(async_prune_point(seed=args.seed, device=device))
        emit(async_autok_point(seed=args.seed, device=device))
    if args.tree_async_sweep:
        for n in (int(x) for x in args.tree_async_devices.split(",") if x):
            aggs = tree_aggregators(n)
            if n <= 2000:
                emit(tree_async_measured_point(
                    devices=n, aggregators=aggs, seed=args.seed,
                    device=device))
            else:
                emit(tree_async_analytic_point(n, aggs, seed=args.seed))
    if args.drift_sweep:
        emit(drift_point(seed=args.seed, device=device))

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a" if args.append else "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    print(f"wrote {len(rows)} rows to {args.out}")
    if args.check_schema:
        return check_schema(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
