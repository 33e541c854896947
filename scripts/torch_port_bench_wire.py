#!/usr/bin/env python3
"""Wire-plane bench of the port: broadcast, downlink delta, uplink, fold.

The counterpart of the JAX package's ``scripts/bench_wire.py``: the same
functions, flags, row schemas and output format, through the port's
``comm`` plane.  It runs an in-process federation (``MessageBroker``,
``DeviceWorker``s and a ``FederatedCoordinator`` as threads) over the bench
CNN shape and measures, per round:

- the ``comm.broadcast_encode_total`` delta, which MUST be exactly 1
  whatever the cohort (the replaced path encoded the full model once per
  request, ``cohort`` times, recorded beside it);
- the ``comm.bytes_sent`` / ``comm.bytes_saved_downlink`` deltas and the
  downlink frame's reduction under ``--down-schemes``;
- the uplink sweep (``--schemes`` x ``--feedback``): the
  ``comm.bytes_received`` / ``comm.bytes_saved_uplink`` /
  ``comm.uplink_densify_avoided_total`` deltas per scheme and the
  streaming fold's overlap (``phase_fold_overlap_s``);
- the round's latency;
- the LoRA sweep (``--lora-ranks``): rank-r factor frames priced against
  the dense update frame at BERT-base (``agnews_bert_fedavg``) from the
  shapes alone, and one real 2-worker factor-uplink federation at a tiny
  BERT shape;
- the fold sweep (``--fold-frames`` x host/device x batch 1/cohort): the
  server's ingest (updates/s) at BERT-base's shapes through
  ``StreamingFolder``, the host fold (the parity oracle) against the
  device fold (``ops/fold.py``: ``fold_sparse_kernel`` and
  ``fold_dense_kernel`` of ``csrc/fold.cu`` on the card, their plain
  versions with ``--backend cpu``), one ``wire_fold`` row per path with
  its measured bitwise parity against the host fold; the run FAILS if a
  device row breaks parity or the batched topk8 device fold is slower
  than the host's;
- the checkpoint sweep (``--ckpt-tp``): a save and a restore of
  BERT-base's weights, one ``wire_ckpt`` row per path: the shard-wise
  ``StreamingCheckpointer`` (CRC-checked files per shard, the manifest
  last, no host gather; the ``ckpt-save-no-gather`` rule reads its
  measured ``gather_avoided``) against the port's ``RoundCheckpointer``
  after a host gather, both restores checked bitwise against the saved
  weights.

With ``--fold-device`` the federation's rounds fold through the device
kernel (``fold_device_folds_per_round`` must equal the cohort, or the run
fails).  ``--check-schema`` validates every row against the row schemas
after the run; ``--check-only`` validates an existing ``--out`` file and
exits.

The federation, the folds and the placed checkpoints run on the card
unless ``--backend cpu`` is given; without a card the script exits
non-zero and writes no row.  A sharded server (``--tp-sizes`` above 1)
takes the host's cards as positions, or the first card repeated when
there are fewer; with ``--backend cpu`` the CPU's forced host positions
(``XLA_FLAGS``, set to 8 when absent).  Rows go to
``results/torch_port/wire_bench.jsonl`` unless ``--out`` says otherwise.

    python3 scripts/torch_port_bench_wire.py
    python3 scripts/torch_port_bench_wire.py --backend cpu --cohorts 2 \\
        --schemes topk --feedback off --down-schemes int8 --tp-sizes 1 \\
        --rounds 2 --lora-ranks '' --fold-frames '' --ckpt-tp 0
    python3 scripts/torch_port_bench_wire.py --check-only \\
        --out results/torch_port/wire_bench.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# Counters sampled as per-round deltas.
_COUNTERS = (
    "comm.broadcast_encode_total",
    "comm.bytes_sent",
    "comm.bytes_received",
    "comm.bytes_saved_downlink",
    "comm.bytes_saved_uplink",
    "comm.uplink_densify_avoided_total",
    "comm.fold_device_total",
    "comm.resync_total",
    "comm.gather_bytes_avoided_total",
)

# Schema contract for every row this bench writes (the JAX script's
# ``SCHEMAS``, kept here as the port's own copy); --check-schema and
# --check-only validate against these.
ROW_SCHEMA = {
    "bench": str,
    "model": str,
    "dataset": str,
    "cohort": int,
    "scheme_down": str,
    "scheme_up": str,
    "feedback": bool,
    "tp_size": int,
    "fold_device": bool,
    "fold_device_folds_per_round": int,
    "rounds": int,
    "encodes_per_round": int,
    "full_frame_bytes": int,
    "downlink_frame_bytes": int,
    "downlink_reduction_x": float,
    "uplink_frame_bytes": int,
    "uplink_dense_bytes": int,
    "uplink_bytes_ratio": float,
    "uplink_reduction_x": float,
    "round_time_s_mean": float,
    "bench_wall_s": float,
}

LORA_ROW_SCHEMA = {
    "bench": str,
    "model": str,
    "cohort": int,
    "rounds": int,
    "lora_rank": int,
    "dense_params": int,
    "factor_params": int,
    "encodes_per_round": int,
    "uplink_frame_bytes": int,
    "uplink_dense_bytes": int,
    "uplink_bytes_ratio": float,
    "uplink_reduction_x": float,
    "lora_merges": int,
    "round_time_s_mean": float,
    "bench_wall_s": float,
}

FOLD_ROW_SCHEMA = {
    "bench": str,
    "model": str,
    "frame": str,
    "path": str,
    "batch": int,
    "cohort": int,
    "repeats": int,
    "param_count": int,
    "staged_values": int,
    "kernel_backend": str,
    "updates_per_s": float,
    "fold_wall_s": float,
    "speedup_vs_host": float,
    "parity_bitwise": bool,
    "bench_wall_s": float,
}

CKPT_ROW_SCHEMA = {
    "bench": str,
    "model": str,
    "path": str,
    "tp_size": int,
    "repeats": int,
    "param_count": int,
    "param_bytes": int,
    "save_s": float,
    "restore_s": float,
    "gather_avoided": int,
    "shards_per_gen": int,
    "restore_bitwise": bool,
    "bench_wall_s": float,
}

SCHEMAS = {
    "wire_round": ROW_SCHEMA,
    "wire_lora": LORA_ROW_SCHEMA,
    "wire_fold": FOLD_ROW_SCHEMA,
    "wire_ckpt": CKPT_ROW_SCHEMA,
}


def bench_config(n_workers: int, scheme_down: str, tp_size: int = 1,
                 scheme_up: str = "none", feedback: bool = False,
                 fold_device: bool = False):
    """The bench CNN shape: a width-16 conv net on mnist_tiny, big enough
    (~100 kB of float32 params) that frame encode and copy costs show,
    small enough to train in seconds."""
    from colearn_federated_learning_tpu_torch.utils.config import (
        DataConfig, ExperimentConfig, FedConfig, ModelConfig, RunConfig)

    return ExperimentConfig(
        data=DataConfig(dataset="mnist_tiny", num_clients=n_workers,
                        partition="iid"),
        model=ModelConfig(name="cnn", num_classes=10, width=16),
        fed=FedConfig(strategy="fedavg", rounds=1, cohort_size=0,
                      local_steps=2, batch_size=16, lr=0.05, momentum=0.0,
                      compress=scheme_up, compress_feedback=feedback,
                      compress_down=scheme_down),
        run=RunConfig(name="bench_wire", seed=0, tp_size=tp_size,
                      fold_device=fold_device),
    )


def _rounds(coord, rounds: int, round_timeout: float) -> list:
    """One warm-up round, then ``rounds`` rounds with their record and the
    counters' deltas."""
    from colearn_federated_learning_tpu_torch import telemetry

    reg = telemetry.get_registry()
    coord.run_round()                 # warm-up: first use and delta base
    coord.round_timeout = round_timeout
    out = []
    for _ in range(rounds):
        _settle_sends(reg)
        before = {c: reg.counter(c).value for c in _COUNTERS}
        rec = coord.run_round()
        _settle_sends(reg)
        out.append((rec, {c: reg.counter(c).value - before[c]
                          for c in _COUNTERS}))
    return out


def _settle_sends(reg, timeout: float = 10.0) -> None:
    """Wait until every message received in this process has been counted
    as sent.  A sender counts a message after its send returns, so the
    coordinator may fold a trainer's reply, end the round and read the
    counters before the trainer's thread counts it (under load, it then
    lands in the next round's delta or in none).  Every party of the
    federation runs in this process, so at rest the sent count is at least
    the received count."""
    sent = reg.counter("comm.messages_sent")
    received = reg.counter("comm.messages_received")
    deadline = time.monotonic() + timeout
    while sent.value < received.value and time.monotonic() < deadline:
        time.sleep(0.001)


def _start(config, n_workers: int, warmup_timeout: float, device):
    """(broker, workers, coordinator) of ``n_workers`` on ``device`` (None:
    the card), enrolled, the trainers in id order; the caller stops
    them."""
    from colearn_federated_learning_tpu_torch.comm.broker import MessageBroker
    from colearn_federated_learning_tpu_torch.comm.coordinator import (
        FederatedCoordinator)
    from colearn_federated_learning_tpu_torch.comm.worker import DeviceWorker
    from colearn_federated_learning_tpu_torch.utils.device import (
        server_positions)

    tp = config.run.tp_size
    broker = MessageBroker().start()
    workers, coord = [], None
    try:
        workers = [DeviceWorker(config, i, broker.host, broker.port,
                                device=device).start()
                   for i in range(n_workers)]
        coord = FederatedCoordinator(
            config, broker.host, broker.port, round_timeout=warmup_timeout,
            want_evaluator=False, device=device,
            positions=server_positions(tp, device) if tp > 1 else None)
        coord.enroll(min_devices=n_workers, timeout=30.0)
        coord.trainers.sort(key=lambda d: int(d.device_id))
        for w in workers:
            w.await_role(timeout=10.0)
    except BaseException:
        _stop(broker, workers, coord)
        raise
    return broker, workers, coord


def _stop(broker, workers, coord) -> None:
    for w in workers:
        w.stop()
    broker.stop()
    if coord is not None:
        coord.close()


def run_bench(n_workers: int, scheme_down: str, scheme_up: str,
              feedback: bool, tp_size: int, rounds: int,
              warmup_timeout: float, round_timeout: float,
              fold_device: bool = False, device=None) -> dict:
    """One ``wire_round`` row: ``rounds`` rounds (after a warm-up) of the
    in-process federation on ``device`` (None: the card)."""
    import numpy as np

    from colearn_federated_learning_tpu_torch.fed import compression
    from colearn_federated_learning_tpu_torch.parallel import partition
    from colearn_federated_learning_tpu_torch.utils import trees
    from colearn_federated_learning_tpu_torch.utils.serialization import (
        wire_frame_length)

    config = bench_config(n_workers, scheme_down, tp_size,
                          scheme_up=scheme_up, feedback=feedback,
                          fold_device=fold_device)
    per_round: list[dict] = []
    broker, workers, coord = _start(config, n_workers, warmup_timeout,
                                    device)
    try:
        # A full-params broadcast's frame length depends only on the
        # leaves' shapes and dtypes (and a round digit or two of header),
        # so one sample stands for every round; so does the uplink frame's
        # under the configured scheme.
        server_bytes_per_chip = int(
            partition.bytes_per_chip(coord._checkpoint_server_state()))
        params_np = partition.host_tree(coord.params_tree())
        full_len = wire_frame_length(params_np, {"round": 1, "down": "full"})
        zeros = trees.map_leaves(np.zeros_like, params_np)
        wire_up, meta_up = compression.compress_delta(
            zeros, config.fed.compress,
            topk_fraction=config.fed.topk_fraction)
        uplink_len = wire_frame_length(
            wire_up, {"round": 1, "op": "train", **meta_up})
        uplink_dense_len = wire_frame_length(
            zeros, {"round": 1, "op": "train", "compress": "none"})

        for rec, delta in _rounds(coord, rounds, round_timeout):
            per_round.append({
                "encodes": int(delta["comm.broadcast_encode_total"]),
                "bytes_sent": int(delta["comm.bytes_sent"]),
                "bytes_received": int(delta["comm.bytes_received"]),
                "bytes_saved": int(delta["comm.bytes_saved_downlink"]),
                "bytes_saved_uplink": int(
                    delta["comm.bytes_saved_uplink"]),
                "densify_avoided": int(
                    delta["comm.uplink_densify_avoided_total"]),
                "fold_device_folds": int(delta["comm.fold_device_total"]),
                "resyncs": int(delta["comm.resync_total"]),
                "gather_avoided": int(
                    delta["comm.gather_bytes_avoided_total"]),
                "sends": int(rec.get("completed", 0)),
                "round_time_s": rec["round_time_s"],
                "fold_overlap_s": rec.get("phase_fold_overlap_s", 0.0),
            })
    finally:
        _stop(broker, workers, coord)

    encodes = [r["encodes"] for r in per_round]
    saved_per_send = (
        per_round[-1]["bytes_saved"] / max(1, per_round[-1]["sends"])
        if scheme_down != "none" else 0.0
    )
    downlink_frame = full_len - saved_per_send
    return {
        "bench": "wire_round",
        "model": "cnn-w16",
        "dataset": "mnist_tiny",
        "cohort": n_workers,
        "scheme_down": scheme_down,
        "scheme_up": scheme_up,
        "feedback": feedback,
        "tp_size": tp_size,
        "fold_device": fold_device,
        "fold_device_folds_per_round": int(min(
            r["fold_device_folds"] for r in per_round)),
        "rounds": rounds,
        "server_bytes_per_chip": server_bytes_per_chip,
        "gather_bytes_avoided_per_round": int(statistics.mean(
            r["gather_avoided"] for r in per_round)),
        "encodes_per_round": max(encodes),
        "encodes_per_round_before": n_workers,
        "full_frame_bytes": int(full_len),
        "downlink_frame_bytes": int(downlink_frame),
        "downlink_reduction_x": round(full_len / downlink_frame, 2),
        "uplink_frame_bytes": int(uplink_len),
        "uplink_dense_bytes": int(uplink_dense_len),
        "uplink_bytes_ratio": round(uplink_len / uplink_dense_len, 4),
        "uplink_reduction_x": round(uplink_dense_len / uplink_len, 2),
        "uplink_bytes_per_round": int(uplink_len * statistics.mean(
            r["sends"] for r in per_round)),
        "bytes_sent_per_round": int(statistics.mean(
            r["bytes_sent"] for r in per_round)),
        "bytes_received_per_round": int(statistics.mean(
            r["bytes_received"] for r in per_round)),
        "bytes_saved_per_round": int(statistics.mean(
            r["bytes_saved"] for r in per_round)),
        "bytes_saved_uplink_per_round": int(statistics.mean(
            r["bytes_saved_uplink"] for r in per_round)),
        "uplink_densify_avoided_per_round": int(min(
            r["densify_avoided"] for r in per_round)),
        "resyncs_total": sum(r["resyncs"] for r in per_round),
        "round_time_s_mean": round(statistics.mean(
            r["round_time_s"] for r in per_round), 4),
        "fold_overlap_s_mean": round(statistics.mean(
            r["fold_overlap_s"] for r in per_round), 4),
        "per_round": per_round,
    }


def lora_bench_config(n_workers: int, rank: int):
    """Tiny BERT on the synthetic agnews_tiny split: small enough to run a
    real 2-worker factor-uplink federation in seconds, transformer enough
    that the rules' targeting (attention, MLP, embeddings) is exercised."""
    from colearn_federated_learning_tpu_torch.utils.config import (
        DataConfig, ExperimentConfig, FedConfig, ModelConfig, RunConfig)

    return ExperimentConfig(
        data=DataConfig(dataset="agnews_tiny", num_clients=n_workers,
                        partition="iid"),
        model=ModelConfig(name="bert", num_classes=4, width=32, depth=2,
                          num_heads=2, seq_len=64, vocab_size=2000),
        fed=FedConfig(strategy="fedavg", rounds=1, cohort_size=0,
                      local_steps=2, batch_size=16, lr=0.05, momentum=0.0,
                      lora_rank=rank, lora_alpha=16.0, lora_merge_every=2),
        run=RunConfig(name="bench_wire_lora", seed=0),
    )


def bench_model_config():
    """The model the LoRA pricing, the fold rows and the checkpoint rows
    run at by default: ``agnews_bert_fedavg``'s, BERT-base."""
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    return get_config("agnews_bert_fedavg").model


def param_views(model_cfg) -> dict:
    """``model_cfg``'s params in the flax layout as zero-stride float32
    views (shapes only): the module is built on the meta device and each
    leaf converted alone, so no more than one leaf is ever allocated."""
    import numpy as np
    import torch

    from colearn_federated_learning_tpu_torch import convert
    from colearn_federated_learning_tpu_torch.models import registry

    with torch.device("meta"):
        model = registry.build_model(model_cfg, "meta")
    out: dict = {}

    def merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict):
                merge(dst.setdefault(k, {}), v)
            else:
                dst[k] = np.broadcast_to(np.float32(0), v.shape)

    for name, p in model.named_parameters():
        merge(out, convert.state_dict_to_flax(
            {name: torch.zeros(p.shape)}, num_heads=model_cfg.num_heads))
    return out


def _sparse_nodes(tree) -> list:
    """The ``{"i", "v", ...}`` nodes of a topk wire tree."""
    if isinstance(tree, dict) and "v" in tree:
        return [tree]
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _sparse_nodes(tree[k])]
    return []


def run_lora_bench(rank: int, rounds: int, warmup_timeout: float,
                   round_timeout: float, device=None) -> dict:
    """One ``wire_lora`` row: rank-``rank`` factor frames priced against
    the dense frame at BERT-base from the shapes alone, and one real
    2-worker factor-uplink federation at the tiny BERT shape on
    ``device`` (None: the card)."""
    import numpy as np

    from colearn_federated_learning_tpu_torch.fed import lora as lora_lib
    from colearn_federated_learning_tpu_torch.parallel import partition
    from colearn_federated_learning_tpu_torch.utils import trees
    from colearn_federated_learning_tpu_torch.utils.serialization import (
        wire_frame_length)

    bert_cfg = bench_model_config()
    params_view = param_views(bert_cfg)
    dense_params = sum(int(np.prod(l.shape))
                       for l in trees.leaves(params_view))
    # No generator: zero factors, the shapes a worker's factor reply has.
    factors_view = partition.host_tree(lora_lib.init_factors(
        params_view, rank, model_name=bert_cfg.name, device="cpu"))
    factor_params = lora_lib.count_factor_params(factors_view)
    meta = {"round": 1, "op": "train", "compress": "none"}
    dense_len = wire_frame_length(params_view, meta)
    factor_len = wire_frame_length(factors_view, meta)

    n_workers = 2
    config = lora_bench_config(n_workers, rank)
    per_round: list[dict] = []
    broker, workers, coord = _start(config, n_workers, warmup_timeout,
                                    device)
    try:
        for rec, delta in _rounds(coord, rounds, round_timeout):
            per_round.append({
                "encodes": int(delta["comm.broadcast_encode_total"]),
                "bytes_sent": int(delta["comm.bytes_sent"]),
                "bytes_received": int(delta["comm.bytes_received"]),
                "bytes_saved_uplink": int(
                    delta["comm.bytes_saved_uplink"]),
                "resyncs": int(delta["comm.resync_total"]),
                "gather_avoided": int(
                    delta["comm.gather_bytes_avoided_total"]),
                "sends": int(rec.get("completed", 0)),
                "lora_merged": bool(rec.get("lora_merged", False)),
                "round_time_s": rec["round_time_s"],
            })
    finally:
        _stop(broker, workers, coord)

    encodes = [r["encodes"] for r in per_round]
    return {
        "bench": "wire_lora",
        # The priced model (the headline ratio) and the smoke model the
        # real federation ran on.
        "model": "bert-base",
        "dataset": "agnews",
        "smoke_model": "bert-tiny",
        "smoke_dataset": "agnews_tiny",
        "cohort": n_workers,
        "scheme_down": "none",
        "scheme_up": "none",
        "feedback": False,
        "tp_size": 1,
        "rounds": rounds,
        "lora_rank": rank,
        "lora_alpha": 16.0,
        "dense_params": int(dense_params),
        "factor_params": int(factor_params),
        "encodes_per_round": max(encodes),
        "encodes_per_round_before": n_workers,
        "uplink_frame_bytes": int(factor_len),
        "uplink_dense_bytes": int(dense_len),
        "uplink_bytes_ratio": round(factor_len / dense_len, 4),
        "uplink_reduction_x": round(dense_len / factor_len, 2),
        "bytes_sent_per_round": int(statistics.mean(
            r["bytes_sent"] for r in per_round)),
        "bytes_received_per_round": int(statistics.mean(
            r["bytes_received"] for r in per_round)),
        "bytes_saved_uplink_per_round": int(statistics.mean(
            r["bytes_saved_uplink"] for r in per_round)),
        "lora_merges": sum(1 for r in per_round if r["lora_merged"]),
        "resyncs_total": sum(r["resyncs"] for r in per_round),
        "round_time_s_mean": round(statistics.mean(
            r["round_time_s"] for r in per_round), 4),
        "per_round": per_round,
    }


def run_fold_rows(frame: str, cohort: int, repeats: int,
                  topk_fraction: float = 0.01, *, model=None,
                  device=None) -> list[dict]:
    """Fold-throughput rows at ``model``'s shapes (default BERT-base):
    updates/s folded through ``StreamingFolder`` for one frame type, the
    host fold (the parity oracle) against the device fold on ``device``
    (None: the card's kernels; the CPU: their plain versions), the device
    at batch 1 and at batch ``cohort``.  One synthetic wire tree per frame
    is reused; only the fold is timed.  Every device row carries its
    measured ``parity_bitwise`` against the host fold of the same
    cohort."""
    import numpy as np
    import torch

    from colearn_federated_learning_tpu_torch.comm.aggregation import (
        StreamingFolder)
    from colearn_federated_learning_tpu_torch.fed import compression
    from colearn_federated_learning_tpu_torch.fed import lora as lora_lib
    from colearn_federated_learning_tpu_torch.parallel import partition
    from colearn_federated_learning_tpu_torch.utils import trees
    from colearn_federated_learning_tpu_torch.utils.device import (
        resolve_device)

    t0 = time.time()
    model = model if model is not None else bench_model_config()
    params_view = param_views(model)
    rng = np.random.default_rng(19)

    def rand_tree(view):
        return trees.map_leaves(
            lambda l: rng.standard_normal(l.shape, dtype=np.float32), view)

    if frame == "dense":
        fold_shapes = params_view
        wire, cmeta = rand_tree(params_view), {"compress": "none"}
    elif frame == "topk8":
        fold_shapes = params_view
        wire, cmeta = compression.compress_delta(
            rand_tree(params_view), "topk8", topk_fraction=topk_fraction)
    elif frame.startswith("lora_r"):
        rank = int(frame[len("lora_r"):])
        fold_shapes = trees.map_leaves(
            lambda l: np.broadcast_to(np.float32(0), l.shape),
            partition.host_tree(lora_lib.init_factors(
                params_view, rank, model_name=model.name, device="cpu")))
        wire, cmeta = rand_tree(fold_shapes), {"compress": "none"}
    else:
        raise SystemExit(f"unknown fold frame {frame!r}")

    param_count = sum(int(np.prod(l.shape))
                      for l in trees.leaves(params_view))
    staged_values = (
        sum(int(np.asarray(n["v"]).size) for n in _sparse_nodes(wire))
        if frame == "topk8"
        else sum(int(np.prod(l.shape)) for l in trees.leaves(wire)))
    updates = [({"client_id": str(i), "weight": 1.0 + 0.25 * i,
                 "mean_loss": 0.5, **cmeta}, wire)
               for i in range(cohort)]
    dev = resolve_device(device)

    def fold_once(on_device, batch_max):
        f = StreamingFolder(fold_shapes,
                            order=[m["client_id"] for m, _ in updates],
                            device_fold=on_device, device=dev)
        f._fold_batch_max = batch_max
        for meta, w in updates:
            f.add(dict(meta), w)
        f.finalize()
        return f

    def timed(on_device, batch_max):
        fold_once(on_device, batch_max)     # warm-up: the kernel's build
        t = time.perf_counter()
        for _ in range(repeats):
            folder = fold_once(on_device, batch_max)
        wall = time.perf_counter() - t
        return folder, wall

    host_folder, host_wall = timed(False, None)
    host_bytes = [np.asarray(l).tobytes()
                  for l in trees.leaves(host_folder.wsum)]
    host_ups = cohort * repeats / host_wall
    backend = "cuda" if dev.type == "cuda" else "plain"
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    def row(path, batch, folder, wall):
        ups = cohort * repeats / wall
        parity = ([np.asarray(l).tobytes()
                   for l in trees.leaves(folder.wsum)] == host_bytes)
        return {
            "bench": "wire_fold",
            "model": "bert-base" if model.width == 768 else "bert-tiny",
            "frame": frame,
            "path": path,
            "batch": batch,
            "cohort": cohort,
            "repeats": repeats,
            "param_count": param_count,
            "staged_values": int(staged_values),
            "kernel_backend": backend if path == "device" else "host",
            "updates_per_s": round(ups, 2),
            "fold_wall_s": round(wall, 4),
            "speedup_vs_host": round(ups / host_ups, 3),
            "parity_bitwise": bool(parity),
            "bench_wall_s": round(time.time() - t0, 1),
        }

    rows = [row("host", 1, host_folder, host_wall)]
    for batch in (1, cohort):
        folder, wall = timed(True, batch)
        rows.append(row("device", batch, folder, wall))
    return rows


def run_ckpt_rows(tp_size: int, repeats: int, *, model=None,
                  device=None) -> list[dict]:
    """Save and restore seconds at ``model``'s shapes (default BERT-base)
    with random weights: the shard-wise ``StreamingCheckpointer`` of the
    weights placed over ``tp_size`` positions on ``device``'s kind (None:
    the card), each shard its own CRC-checked file, the manifest last, no
    host gather, against the port's ``RoundCheckpointer`` of the gathered
    host tree (the port's own format, where JAX writes orbax).  Both
    restores are checked bitwise against the saved weights by the
    streaming digest."""
    import hashlib
    import shutil
    import tempfile

    import numpy as np

    from colearn_federated_learning_tpu_torch import telemetry
    from colearn_federated_learning_tpu_torch.ckpt import (
        RoundCheckpointer, StreamingCheckpointer)
    from colearn_federated_learning_tpu_torch.ckpt.streaming import (
        _digest_update)
    from colearn_federated_learning_tpu_torch.parallel import partition
    from colearn_federated_learning_tpu_torch.utils import trees
    from colearn_federated_learning_tpu_torch.utils.device import (
        server_positions)

    t0 = time.time()
    model = model if model is not None else bench_model_config()
    rng = np.random.default_rng(23)
    params = trees.map_leaves(
        lambda l: rng.standard_normal(l.shape).astype(l.dtype),
        param_views(model))
    leaves = trees.leaves(params)
    param_count = sum(int(np.prod(l.shape)) for l in leaves)
    param_bytes = sum(l.size * l.dtype.itemsize for l in leaves)

    def digest_of(tree):
        h = hashlib.sha256()
        for leaf in trees.leaves(tree):
            arr = partition.host_leaf(leaf)
            _digest_update(h, arr.dtype.name, tuple(arr.shape), arr)
        return h.hexdigest()

    expected = digest_of(params)
    reg = telemetry.get_registry()

    placement = partition.make_server_placement(
        params, tp_size, "model", model.name,
        devices=server_positions(tp_size, device))
    if placement is None:
        raise SystemExit(
            f"FAIL: no server placement at tp_size={tp_size} "
            "(ckpt bench needs a sharded tree to price)")
    sharded = placement.shard(params)
    template = trees.map_leaves(np.zeros_like, params)
    name = "bert-base" if model.width == 768 else "bert-tiny"

    def row(path, save_s, restore_s, gather_avoided, shards, restored):
        return {
            "bench": "wire_ckpt",
            "model": name,
            "path": path,
            "tp_size": tp_size if path == "sharded" else 1,
            "repeats": repeats,
            "param_count": param_count,
            "param_bytes": int(param_bytes),
            "save_s": round(save_s, 4),
            "restore_s": round(restore_s, 4),
            "gather_avoided": int(gather_avoided),
            "shards_per_gen": shards,
            "restore_bitwise": digest_of(restored) == expected,
            "bench_wall_s": round(time.time() - t0, 1),
        }

    rows = []
    stream_dir = tempfile.mkdtemp(prefix="bench_ckpt_stream_")
    flat_dir = tempfile.mkdtemp(prefix="bench_ckpt_flat_")
    try:
        stream = StreamingCheckpointer(stream_dir, max_to_keep=1)
        before = reg.counter("comm.gather_bytes_avoided_total").value
        t = time.perf_counter()
        for r in range(repeats):
            stream.save(r + 1, sharded, [])
        save_s = (time.perf_counter() - t) / repeats
        avoided = (reg.counter("comm.gather_bytes_avoided_total").value
                   - before) / repeats
        gen = os.path.join(stream_dir, f"gen_{repeats:08d}")
        shards = sum(1 for n in os.listdir(gen) if n.startswith("shard_"))
        t = time.perf_counter()
        restored, _, _ = StreamingCheckpointer(stream_dir).restore(template)
        restore_s = time.perf_counter() - t
        rows.append(row("sharded", save_s, restore_s, avoided, shards,
                        restored))

        flat = RoundCheckpointer(flat_dir, max_to_keep=1)
        t = time.perf_counter()
        for r in range(repeats):
            # The gather is part of the priced cost: the flat path must
            # hold the whole tree on the host before it can save.
            flat.save(r + 1, partition.host_tree(sharded), [])
        save_s = (time.perf_counter() - t) / repeats
        t = time.perf_counter()
        restored, _, _ = flat.restore(template)
        restore_s = time.perf_counter() - t
        flat.close()
        rows.append(row("gathered", save_s, restore_s, 0, 0, restored))
    finally:
        shutil.rmtree(stream_dir, ignore_errors=True)
        shutil.rmtree(flat_dir, ignore_errors=True)
    return rows


def check_schema(path: str) -> int:
    """Validate every row of the bench JSONL against the schema for its
    ``bench`` tag: the fields present, numerics numeric, and every device
    fold row bitwise."""
    bad = 0
    try:
        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    except OSError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    if not rows:
        print(f"FAIL: {path} is empty", file=sys.stderr)
        return 1
    for i, row in enumerate(rows):
        schema = SCHEMAS.get(row.get("bench"))
        if schema is None:
            print(f"FAIL: row {i} unknown bench {row.get('bench')!r}",
                  file=sys.stderr)
            bad += 1
            continue
        for key, typ in schema.items():
            if key not in row:
                print(f"FAIL: row {i} ({row['bench']}) missing {key!r}",
                      file=sys.stderr)
                bad += 1
            elif typ is float and not isinstance(row[key], (int, float)):
                print(f"FAIL: row {i} {key!r} not numeric", file=sys.stderr)
                bad += 1
            elif typ is not float and not isinstance(row[key], typ):
                print(f"FAIL: row {i} {key!r} not {typ.__name__}",
                      file=sys.stderr)
                bad += 1
        if (row.get("bench") == "wire_fold" and row.get("path") == "device"
                and row.get("parity_bitwise") is not True):
            print(f"FAIL: row {i} device fold row without bitwise parity",
                  file=sys.stderr)
            bad += 1
    if not bad:
        print(f"schema ok: {len(rows)} row(s) in {path}")
    return 1 if bad else 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=["gpu", "cpu"], default="gpu",
                    help="the card (default; exits non-zero without one) "
                         "or the CPU")
    ap.add_argument("--rounds", type=int, default=5,
                    help="measured rounds per configuration (after 1 warmup)")
    ap.add_argument("--cohorts", default="2,4",
                    help="comma-separated cohort sizes")
    ap.add_argument("--schemes", default="int8,topk,topk8",
                    help="comma-separated UPLINK compress schemes, swept "
                         "at the largest cohort")
    ap.add_argument("--feedback", default="off,on",
                    help="comma-separated error-feedback settings for the "
                         "uplink sweep (off/on)")
    ap.add_argument("--down-schemes", default="none,int8",
                    help="comma-separated compress_down schemes")
    ap.add_argument("--tp-sizes", default="1,2",
                    help="comma-separated server tp_size values; sizes > 1 "
                         "shard the global model over a (model,) placement "
                         "and are swept on the 'none' scheme only")
    ap.add_argument("--lora-ranks", default="4,8",
                    help="comma-separated LoRA ranks priced at BERT-base "
                         "(and one real tiny-BERT factor-uplink federation "
                         "per rank); empty string skips the sweep")
    ap.add_argument("--lora-only", action="store_true",
                    help="run only the --lora-ranks sweep")
    ap.add_argument("--fold-device", action="store_true",
                    help="run the federation rows with the device fold "
                         "(RunConfig.fold_device)")
    ap.add_argument("--fold-frames", default="dense,topk8,lora_r4",
                    help="comma-separated frame types for the fold-"
                         "throughput sweep at BERT-base (host vs device, "
                         "batch 1 vs K); empty string skips the sweep")
    ap.add_argument("--fold-cohort", type=int, default=4,
                    help="contributions per fold (the K in batch 1 vs K)")
    ap.add_argument("--fold-repeats", type=int, default=3,
                    help="timed folds per fold-throughput row")
    ap.add_argument("--fold-only", action="store_true",
                    help="run only the --fold-frames sweep")
    ap.add_argument("--ckpt-tp", type=int, default=2,
                    help="server tp_size for the wire_ckpt save/restore "
                         "rows; 0 skips the sweep")
    ap.add_argument("--ckpt-repeats", type=int, default=2,
                    help="timed saves per wire_ckpt row")
    ap.add_argument("--ckpt-only", action="store_true",
                    help="run only the wire_ckpt rows")
    ap.add_argument("--check-schema", action="store_true",
                    help="after the sweep, validate the output JSONL "
                         "against the per-bench row schemas and fail on "
                         "any mismatch")
    ap.add_argument("--check-only", action="store_true",
                    help="validate the existing --out JSONL against the "
                         "row schemas and exit (no benches run)")
    ap.add_argument("--out", default=os.path.join(
        REPO, "results", "torch_port", "wire_bench.jsonl"))
    ap.add_argument("--warmup-timeout", type=float, default=300.0)
    ap.add_argument("--round-timeout", type=float, default=60.0)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.check_only:
        return check_schema(args.out)

    if args.backend == "cpu":
        device = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
    else:
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device (pass --backend cpu to run on the CPU)",
                  file=sys.stderr)
            return 1
        device = None

    tp_sizes = [int(t) for t in args.tp_sizes.split(",") if t]
    cohorts = [int(c) for c in args.cohorts.split(",") if c]
    rows = []

    def summary(row):
        print(json.dumps({k: v for k, v in row.items() if k != "per_round"}),
              flush=True)

    def bench_row(n, scheme_down, scheme_up, fb, tp):
        t0 = time.time()
        row = run_bench(n, scheme_down, scheme_up, fb, tp, args.rounds,
                        args.warmup_timeout, args.round_timeout,
                        fold_device=args.fold_device, device=device)
        row["bench_wall_s"] = round(time.time() - t0, 1)
        rows.append(row)
        summary(row)
        if row["encodes_per_round"] != 1:
            raise SystemExit(
                f"FAIL: {row['encodes_per_round']} broadcast encodes per "
                f"round at cohort {n} (want exactly 1)")
        if args.fold_device and row["fold_device_folds_per_round"] < n:
            raise SystemExit(
                f"FAIL: --fold-device round folded "
                f"{row['fold_device_folds_per_round']} of {n} "
                "contributions through the device kernel")
        if tp > 1 and row["gather_bytes_avoided_per_round"] <= 0:
            raise SystemExit(
                f"FAIL: tp_size={tp} row avoided no gather bytes "
                "(sharded downlink not engaged)")
        if scheme_up in ("topk", "topk8"):
            if row["uplink_densify_avoided_per_round"] < n:
                raise SystemExit(
                    f"FAIL: {scheme_up} uplink row folded "
                    f"{row['uplink_densify_avoided_per_round']} of {n} "
                    "contributions sparse (sparse-native fold not engaged)")
            # topk ships 8 bytes per kept entry, the topk8 hybrid (int8
            # values and a scale per leaf) about 5: it must price below
            # plain topk at the same density.
            floor = 6.0 if scheme_up == "topk" else 9.0
            if row["uplink_reduction_x"] < floor:
                raise SystemExit(
                    f"FAIL: {scheme_up} uplink reduction "
                    f"{row['uplink_reduction_x']}x < {floor}x vs the "
                    "dense frame")
        return row

    def lora_row(rank):
        t0 = time.time()
        row = run_lora_bench(rank, args.rounds, args.warmup_timeout,
                             args.round_timeout, device=device)
        row["bench_wall_s"] = round(time.time() - t0, 1)
        rows.append(row)
        summary(row)
        if row["encodes_per_round"] != 1:
            raise SystemExit(
                f"FAIL: {row['encodes_per_round']} broadcast encodes per "
                f"round at lora rank {rank} (want exactly 1)")
        if row["uplink_reduction_x"] < 25.0:
            raise SystemExit(
                f"FAIL: rank-{rank} factor uplink reduction "
                f"{row['uplink_reduction_x']}x < 25x vs the dense "
                "BERT-base frame")
        if row["bytes_saved_uplink_per_round"] <= 0:
            raise SystemExit(
                f"FAIL: rank-{rank} smoke run saved no uplink bytes "
                "(factor replies not engaged)")
        if row["lora_merges"] < 1:
            raise SystemExit(
                f"FAIL: rank-{rank} smoke run never merged factors into "
                "the base model (lora_merge_every not engaged)")
        return row

    def fold_rows(frame):
        for row in run_fold_rows(frame, args.fold_cohort, args.fold_repeats,
                                 device=device):
            rows.append(row)
            print(json.dumps(row), flush=True)
            if row["path"] == "device" and not row["parity_bitwise"]:
                raise SystemExit(
                    f"FAIL: device fold of {frame} frames diverged from "
                    "the host oracle (bitwise parity broken)")
            if (row["frame"] == "topk8" and row["path"] == "device"
                    and row["batch"] > 1
                    and row["speedup_vs_host"] < 1.0):
                raise SystemExit(
                    f"FAIL: batched device fold of topk8 frames is "
                    f"SLOWER than the host fold "
                    f"({row['speedup_vs_host']}x)")

    def ckpt_rows():
        for row in run_ckpt_rows(args.ckpt_tp, args.ckpt_repeats,
                                 device=device):
            rows.append(row)
            print(json.dumps(row), flush=True)
            if not row["restore_bitwise"]:
                raise SystemExit(
                    f"FAIL: {row['path']} ckpt restore diverged bitwise "
                    "from the saved weights")
            if row["path"] == "sharded" and row["gather_avoided"] < 1:
                raise SystemExit(
                    "FAIL: sharded streaming save avoided no gather bytes "
                    "(the full tree was host-materialized)")
            if row["path"] == "sharded" and row["shards_per_gen"] < 2:
                raise SystemExit(
                    f"FAIL: streaming save wrote "
                    f"{row['shards_per_gen']} shard file(s) at "
                    f"tp_size={args.ckpt_tp} (shard-wise layout not "
                    "engaged)")

    def write_out():
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        print(f"wrote {len(rows)} rows to {args.out}")
        return check_schema(args.out) if args.check_schema else 0

    if args.ckpt_only:
        ckpt_rows()
        return write_out()

    if args.fold_only:
        for frame in (s.strip() for s in args.fold_frames.split(",") if s):
            fold_rows(frame)
        return write_out()

    if not args.lora_only:
        # The downlink matrix: cohorts x down-schemes x tp; the sharded
        # rows ride on the uncompressed scheme.
        for n in cohorts:
            for scheme_down in (s.strip()
                                for s in args.down_schemes.split(",") if s):
                for tp in (tp_sizes if scheme_down == "none" else [1]):
                    bench_row(n, scheme_down, "none", False, tp)

        # The uplink sweep at the largest cohort: scheme x feedback
        # ("none" appears only as the baseline rows above).
        n_up = max(cohorts)
        for scheme_up in (s.strip() for s in args.schemes.split(",") if s):
            if scheme_up == "none":
                continue
            for fb_s in (s.strip() for s in args.feedback.split(",") if s):
                bench_row(n_up, "none", scheme_up, fb_s == "on", 1)

    for rank_s in (s.strip() for s in args.lora_ranks.split(",") if s):
        lora_row(int(rank_s))

    if not args.lora_only:
        for frame in (s.strip() for s in args.fold_frames.split(",") if s):
            fold_rows(frame)

    if not args.lora_only and args.ckpt_tp > 0:
        ckpt_rows()

    return write_out()


if __name__ == "__main__":
    raise SystemExit(main())
