#!/usr/bin/env python3
"""Mesh smoke of the port: the sharded against the replicated server.

The counterpart of the JAX package's ``scripts/mesh_smoke.py``: build the
global model of a small BERT configuration and measure the server plane
both ways over a ``(model,)`` placement of ``--tp-size`` positions
(``parallel/partition.ServerPlacement``):

- ``replicated``: every position holds the whole params and optimizer
  state;
- ``sharded``: params, optimizer state and the fold are partitioned over
  the positions.

Self-checking: the sharded ``StreamingFolder`` fold must be BITWISE the
replicated fold, the sharded ``DownlinkEncoder`` frame byte for byte the
gathered frame, and the bytes per position strictly lower sharded than
replicated.  One JSON row per mode and a ``compare`` row with
``hbm_ratio_sharded_over_replicated`` go to
``results/torch_port/mesh_bench.jsonl`` (``--out``); the sentinel rules of
``pyproject.toml`` pin the ratio below 1 and the gather bytes avoided
above 0.

The positions are the host's cards, or ``cuda:0`` repeated when the host
has fewer cards than ``--tp-size`` (a placement's positions may repeat a
device); with ``--backend cpu`` they are the CPU's forced host positions
(``--xla_force_host_platform_device_count`` in ``XLA_FLAGS``, set to 8
when absent).  Without a card and without ``--backend cpu`` the script
exits non-zero and writes no row.  The JAX script's ``--check-multichip``
(a schema check of the JAX package's committed TPU-pod records) has no
counterpart here.

    python3 scripts/torch_port_mesh_smoke.py [--tp-size 4]
    python3 scripts/torch_port_mesh_smoke.py --backend cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def bert_config(tp_size: int):
    from colearn_federated_learning_tpu_torch.utils.config import (
        DataConfig, ExperimentConfig, FedConfig, ModelConfig, RunConfig)

    return ExperimentConfig(
        data=DataConfig(dataset="agnews_tiny", num_clients=8,
                        partition="iid", max_examples_per_client=8),
        model=ModelConfig(name="bert", num_classes=4, width=32, depth=2,
                          num_heads=4, seq_len=64, vocab_size=2000),
        fed=FedConfig(strategy="fedavg", rounds=1, cohort_size=0,
                      local_steps=1, batch_size=4, lr=0.05, momentum=0.9),
        run=RunConfig(name="mesh_smoke", seed=0, tp_size=tp_size),
    )


def server_state(placement, tree, fed):
    """The server state of a placed ``tree`` as the coordinator keeps it:
    the strategy's state over the placement's flat dict, viewed back as
    placed trees, ``round_idx`` an int32 ``()`` array."""
    import numpy as np

    from colearn_federated_learning_tpu_torch.fed import strategies

    state = strategies.init_server_state(placement.flatten(tree), fed)

    def view(d):
        return None if d is None else placement.unflatten(d)

    return strategies.ServerState(
        params=view(state.params), opt_m=view(state.opt_m),
        opt_v=view(state.opt_v), control=view(state.control),
        round_idx=np.asarray(state.round_idx, np.int32))


def run_smoke(tp_size: int, out_path: str, device=None) -> int:
    """The three rows and the self-checks on ``device``'s kind (None: the
    card); a process exit code."""
    import numpy as np

    from colearn_federated_learning_tpu_torch.comm.aggregation import (
        StreamingFolder)
    from colearn_federated_learning_tpu_torch.comm.downlink import (
        DownlinkEncoder)
    from colearn_federated_learning_tpu_torch.fed import setup as setup_lib
    from colearn_federated_learning_tpu_torch.parallel import partition
    from colearn_federated_learning_tpu_torch.utils import trees
    from colearn_federated_learning_tpu_torch.utils.device import (
        server_positions)

    devices = server_positions(tp_size, device)
    if len(devices) < tp_size:
        print(f"FAIL: need {tp_size} positions, have {len(devices)}",
              file=sys.stderr)
        return 1

    config = bert_config(tp_size)
    params = setup_lib.init_global_params(config, devices[0])
    placement = partition.make_server_placement(
        params, tp_size, config.run.tp_axis, config.model.name,
        devices=devices)
    if placement is None:
        print("FAIL: make_server_placement fell back to replicated",
              file=sys.stderr)
        return 1

    rows = []

    # The replicated layout: the whole server state on every position of
    # the same positions.
    whole = partition.ServerPlacement.from_params(
        params, placement.devices, config.run.tp_axis, ((r"", None),))
    replicated = whole.shard(params)
    rep_bytes = partition.bytes_per_chip(
        server_state(whole, replicated, config.fed))
    rows.append({
        "bench": "mesh_smoke", "mode": "replicated", "model": "bert",
        "tp_size": 1, "n_devices": len(devices),
        "server_bytes_per_chip": int(rep_bytes),
        "gather_bytes_avoided": 0, "sharded_fraction": 0.0,
    })

    sharded = placement.shard(params)
    shd_bytes = partition.bytes_per_chip(
        server_state(placement, sharded, config.fed))
    avoided = partition.tree_gather_avoided(sharded)
    rows.append({
        "bench": "mesh_smoke", "mode": "sharded", "model": "bert",
        "tp_size": tp_size, "n_devices": len(devices),
        "server_bytes_per_chip": int(shd_bytes),
        "gather_bytes_avoided": int(avoided),
        "sharded_fraction": round(placement.sharded_fraction(), 4),
    })

    # Self-check 1: the sharded fold is the replicated fold, bitwise.
    shapes = placement.shapes_tree()
    order = [str(i) for i in range(4)]
    rep_fold = StreamingFolder(shapes, order=order)
    shd_fold = StreamingFolder(shapes, order=order, placement=placement)
    for i in order:
        rng = np.random.default_rng(40 + int(i))
        delta = trees.map_leaves(
            lambda w: rng.standard_normal(np.shape(w)).astype(w.dtype),
            shapes)
        meta = {"client_id": i, "weight": 1.0 + 0.5 * int(i),
                "mean_loss": 0.1}
        rep_fold.add(dict(meta), delta)
        shd_fold.add(dict(meta), delta)
    m_rep, w_rep, _ = rep_fold.mean()
    m_shd, w_shd, _ = shd_fold.mean()
    host_shd = partition.host_tree(m_shd)
    fold_ok = w_rep == w_shd and all(
        np.asarray(a).tobytes() == np.asarray(b).tobytes()
        for a, b in zip(trees.leaves(m_rep), trees.leaves(host_shd)))

    # Self-check 2: the sharded downlink frame is the gathered frame.
    host = partition.host_tree(sharded)
    body_rep, _, _ = DownlinkEncoder("none").encode_round(1, host)
    body_shd, _, _ = DownlinkEncoder("none").encode_round(1, sharded)
    frame_ok = bytes(body_rep) == bytes(body_shd)

    ratio = shd_bytes / max(rep_bytes, 1)
    rows.append({
        "bench": "mesh_smoke", "mode": "compare", "model": "bert",
        "tp_size": tp_size, "n_devices": len(devices),
        "hbm_ratio_sharded_over_replicated": round(ratio, 4),
        "gather_bytes_avoided": int(avoided),
        "fold_bitwise_ok": bool(fold_ok),
        "frame_bytes_ok": bool(frame_ok),
    })

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        for row in rows:
            print(json.dumps(row))
            f.write(json.dumps(row) + "\n")
    print(f"wrote {len(rows)} rows to {out_path}")

    if not fold_ok:
        print("FAIL: sharded fold is not bitwise identical to replicated",
              file=sys.stderr)
        return 1
    if not frame_ok:
        print("FAIL: sharded downlink frame differs from gathered frame",
              file=sys.stderr)
        return 1
    if not shd_bytes < rep_bytes:
        print(f"FAIL: sharded per-position bytes {shd_bytes} not below "
              f"replicated {rep_bytes}", file=sys.stderr)
        return 1
    if avoided <= 0:
        print("FAIL: sharded layout avoided no gather bytes",
              file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=["gpu", "cpu"], default="gpu",
                    help="the card (default; exits non-zero without one) "
                         "or the CPU's forced host positions")
    ap.add_argument("--tp-size", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(
        REPO, "results", "torch_port", "mesh_bench.jsonl"))
    args = ap.parse_args(argv)
    if args.backend == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        return run_smoke(args.tp_size, args.out, "cpu")
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device (pass --backend cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    return run_smoke(args.tp_size, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
