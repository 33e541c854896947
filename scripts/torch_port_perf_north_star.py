#!/usr/bin/env python3
"""North-star perf run of the port (BASELINE.json: 1000-client FedAvg CIFAR-10).

The counterpart of the JAX package's ``scripts/perf_north_star.py``: the
port's engine on the card, 1000 clients of 64 examples, cohort 64, the
width-64 bf16 CNN, 8 local SGD steps of 32, FedAvg.  Reports rounds/sec,
client-samples/sec/chip, the card's memory and a model-FLOPs utilization:
``flops_per_round`` (``FederatedLearner.round_cost_analysis``: one local
step counted under ``FlopCounterMode``, times the cohort and the steps)
times rounds/sec over one card's dense bf16 peak (``PEAK_BF16_FLOPS``,
keyed by ``torch.cuda.get_device_name``; ``null`` on a card the table
does not hold).  ``--profile-dir`` also writes a ``torch.profiler`` trace
of rounds 1..2.

Every run writes a record file ``results/torch_port/perf_<shape>.jsonl``
(``--out``): one ``meta`` line (the card, the shape, the FLOP count, the
build seconds, the memory), one line per timed round (dispatch seconds in
the pipelined mode, the round's seconds to a sync with
``--sync-per-round``), and a closing ``summary`` line, which is also
printed.  The pipelined mode queues the rounds on the card and syncs once
after the last: only the total is a latency.

The run is on the card unless ``--backend cpu`` is given; without a card
it exits non-zero and writes no record.  The port compiles nothing, so
``compile_s`` is 0.

    python3 scripts/torch_port_perf_north_star.py [--rounds 20] [--cohort 64]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# One card's dense (no sparsity) bf16 tensor-core peak in FLOP/s.  H100
# SXM5: 989.4 TFLOPS, NVIDIA H100 Tensor Core GPU datasheet (its 1,979
# TFLOPS figure is with 2:4 sparsity).
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989.4e12}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backend", choices=["gpu", "cpu"], default="gpu",
                   help="the card (default; exits non-zero without one) "
                        "or the CPU")
    p.add_argument("--num-clients", type=int, default=1000)
    p.add_argument("--cohort", type=int, default=64)
    p.add_argument("--local-steps", type=int, default=8)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--examples-per-client", type=int, default=64)
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--tp-size", type=int, default=1,
                   help="model-axis size: under torchrun, shard the model "
                        "over a (clients, model) mesh")
    p.add_argument("--stem", default="conv",
                   choices=["conv", "space_to_depth"],
                   help="the CNN's stem (models/cnn.py)")
    p.add_argument("--norm", default="group", choices=["group", "none"],
                   help="the CNN's norm")
    p.add_argument("--profile-dir", default=None)
    p.add_argument("--sync-per-round", action="store_true",
                   help="sync on every round for the rounds' own latencies "
                        "(the headline number queues them instead)")
    p.add_argument("--out", default=None,
                   help="record path (default: results/torch_port/"
                        "perf_c<cohort>_w<width>_n<clients>....jsonl)")
    return p


def north_star_config(args):
    """The run's ``ExperimentConfig``: config #2's CNN and FedAvg at the
    north star's shape."""
    from colearn_federated_learning_tpu_torch.utils.config import (
        DataConfig, ExperimentConfig, FedConfig, ModelConfig, RunConfig)

    return ExperimentConfig(
        data=DataConfig(dataset="cifar10", num_clients=args.num_clients,
                        partition="dirichlet", dirichlet_alpha=0.5,
                        max_examples_per_client=args.examples_per_client),
        model=ModelConfig(name="cnn", num_classes=10, width=args.width,
                          dtype="bfloat16", stem=args.stem, norm=args.norm),
        fed=FedConfig(strategy="fedavg", cohort_size=args.cohort,
                      local_steps=args.local_steps, batch_size=args.batch,
                      lr=0.05, momentum=0.9),
        run=RunConfig(name="north_star", tp_size=args.tp_size,
                      profile_dir=args.profile_dir),
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    if args.backend == "cpu":
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        print("no CUDA device (pass --backend cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    else:
        device = torch.device("cuda", torch.cuda.current_device())

    from colearn_federated_learning_tpu_torch.data import (
        registry as data_registry)
    from colearn_federated_learning_tpu_torch.fed.engine import (
        FederatedLearner)
    from colearn_federated_learning_tpu_torch.parallel import partition
    from colearn_federated_learning_tpu_torch.telemetry import runtime

    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    platform = "gpu" if on_card else "cpu"
    n_devices = torch.cuda.device_count() if on_card else 1
    print(f"[perf] device: {kind} ({platform}) x{n_devices}",
          file=sys.stderr)

    config = north_star_config(args)
    dataset = data_registry.get_dataset(
        "cifar10", seed=0,
        max_train=args.num_clients * args.examples_per_client, max_test=512,
    )
    if on_card:
        # The run's own peak, also when a caller's process ran other work.
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    learner = FederatedLearner.from_config(config, dataset=dataset,
                                           device=device)
    build_s = time.perf_counter() - t0

    flops_per_round = float(learner.round_cost_analysis()["flops_per_round"])

    if args.profile_dir:
        learner.fit(rounds=3)                       # profiles rounds 1..2
    for _ in range(args.warmup):
        learner.run_round()
    learner.finalize_history()

    mesh_devices = (learner.mesh.size() if learner.mesh is not None else 1)
    mem = runtime.sample_device_memory(device=device)
    # The server state's bytes per card, its round index a 4-byte int32
    # array as the JAX package keeps it.
    server_bytes_per_chip = partition.bytes_per_chip(dataclasses.replace(
        learner.server_state,
        round_idx=np.asarray(learner.server_state.round_idx, np.int32)))
    gather_avoided = partition.tree_gather_avoided(
        learner.server_state.params)
    tag = (f"perf_c{learner.cohort_size}_w{args.width}_n{args.num_clients}"
           f"_k{learner.num_steps}_b{args.batch}_e{args.examples_per_client}"
           f"{'_s2d' if args.stem == 'space_to_depth' else ''}"
           f"{'_nonorm' if args.norm == 'none' else ''}"
           f"{f'_tp{args.tp_size}' if args.tp_size > 1 else ''}"
           f"{'_sync' if args.sync_per_round else ''}")
    out_path = args.out or os.path.join(REPO, "results", "torch_port",
                                        f"{tag}.jsonl")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as rec_f:
        def rec(obj):
            rec_f.write(json.dumps(obj) + "\n")

        rec({
            "kind": "meta",
            "recorded_unix": int(time.time()),
            "device": kind,
            "platform": platform,
            "n_devices": n_devices,
            "mesh_devices": mesh_devices,
            "tp_size": learner.tp_size,
            "num_clients": args.num_clients,
            "cohort": learner.cohort_size,
            "local_steps": learner.num_steps,
            "batch": args.batch,
            "width": args.width,
            "stem": args.stem,
            "norm": args.norm,
            "examples_per_client": args.examples_per_client,
            "build_s": round(build_s, 2),
            "compile_s": 0.0,
            "cost_analysis_flops_per_round": flops_per_round,
            "hbm_used_gb": round(mem.get("bytes_in_use", 0) / 2**30, 3),
            "hbm_peak_per_chip_gb": round(
                mem.get("peak_bytes_in_use", 0) / 2**30, 3),
            "hbm_limit_gb": round(mem.get("bytes_limit", 0) / 2**30, 3),
            "server_bytes_per_chip": int(server_bytes_per_chip),
            "gather_bytes_avoided": int(gather_avoided),
            "timing_mode": ("sync_per_round" if args.sync_per_round
                            else "pipelined"),
        })

        # Pipelined (default): the rounds queue on the card and the
        # closing sync is the barrier, so each round's stamp is its
        # dispatch time and only the total is a latency.
        # --sync-per-round waits on every round instead.
        t0 = time.perf_counter()
        for i in range(args.rounds):
            r0 = time.perf_counter()
            learner.run_round(sync=args.sync_per_round)
            rec({"kind": "round", "round": i,
                 ("round_s" if args.sync_per_round else "dispatch_s"):
                 round(time.perf_counter() - r0, 6)})
        learner.finalize_history()
        if on_card:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        rps = args.rounds / dt

        samples_per_round = (learner.cohort_size * learner.num_steps
                             * args.batch)
        peak = PEAK_BF16_FLOPS.get(kind)
        mfu = (round(flops_per_round * rps / peak, 4) if peak else None)
        out = {
            "kind": "summary",
            "device": kind,
            "platform": platform,
            "num_clients": args.num_clients,
            "cohort": learner.cohort_size,
            "local_steps": learner.num_steps,
            "batch": args.batch,
            "width": args.width,
            "tp_size": learner.tp_size,
            "rounds_timed": args.rounds,
            "total_s": round(dt, 4),
            "rounds_per_sec": round(rps, 4),
            "server_bytes_per_chip": int(server_bytes_per_chip),
            "gather_bytes_avoided": int(gather_avoided),
            "client_samples_per_sec_per_chip": round(
                rps * samples_per_round, 1),
            "flops_per_round": flops_per_round,
            "model_flops_utilization": mfu,
        }
        rec(out)
    print(f"[perf] raw record -> {out_path}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
