#!/usr/bin/env python3
"""The trainers' uplink compression and the engine's shard pack from two
checkouts of the port, in turns, on the card.

    python3 scripts/torch_port_ab_compress.py --parent DIR [--runs 2]

``DIR`` is the root of another revision's checkout (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  Each turn is a fresh process that imports
``colearn_federated_learning_tpu_torch`` from one root and runs:

- chip_smoke's 11a federation as 13b reads it: a broker, 3 trainer
  threads and the synchronous coordinator on the card, config #4
  (BERT-base at 6 of its 12 blocks, flash, 4 local steps) with topk8
  uplinks, error feedback and the device fold, for ``--rounds`` rounds;
  per round its ``round_time_s`` and each trainer's ``compress_delta``
  span (the coordinator adopts the workers' spans);
- ``FederatedLearner`` of config #2 as it is and of config #5 at phase 6's
  cut (cohort 16, 6 of its 12 blocks, flash): the build's seconds to a
  sync and the ``h2d_transfer`` span (``engine.h2d_transfer_s``), which
  wraps the upload alone on the parent (its pack ran on the host before
  it) and the upload and the gather on the card here.

The turns run parent, this tree, this tree, parent, ... (``--runs`` of
each).  Prints one JSON line per turn, then the medians per side beside
the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH = 6


def federation_turn(rounds: int) -> dict:
    import torch

    from colearn_federated_learning_tpu_torch.comm.broker import MessageBroker
    from colearn_federated_learning_tpu_torch.comm.coordinator import (
        FederatedCoordinator)
    from colearn_federated_learning_tpu_torch.comm.worker import DeviceWorker
    from colearn_federated_learning_tpu_torch.data import registry
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    base = get_config("agnews_bert_fedavg")
    cfg = base.replace(
        model=dataclasses.replace(base.model, attn_impl="flash", depth=DEPTH),
        fed=dataclasses.replace(base.fed, local_steps=4, compress="topk8",
                                compress_feedback=True),
        run=dataclasses.replace(base.run, fold_device=True))
    dataset = registry.get_dataset(cfg.data.dataset, seed=cfg.run.seed)
    broker = MessageBroker().start()
    workers = [DeviceWorker(cfg, i, broker.host, broker.port,
                            dataset=dataset).start() for i in range(3)]
    coord = FederatedCoordinator(cfg, broker.host, broker.port,
                                 round_timeout=300.0, want_evaluator=False)
    try:
        coord.enroll(min_devices=3, timeout=120.0)
        records = [coord.run_round() for _ in range(rounds)]
        torch.cuda.synchronize()
        spans = coord.tracer.snapshot()
    finally:
        coord.close()
        for w in workers:
            w.stop()
        broker.stop()
    per_round = []
    for rnd in sorted((sp for sp in spans if sp.name == "round"),
                      key=lambda sp: sp.t_wall):
        trains = {sp.span_id for sp in spans if sp.name == "worker.train"
                  and _under(spans, sp, rnd.span_id)}
        per_round.append(sorted(sp.duration_s for sp in spans
                                if sp.name == "compress_delta"
                                and sp.parent_id in trains))
    return {"round_s": [r["round_time_s"] for r in records],
            "compress_delta_s": per_round}


def _under(spans, sp, root_id) -> bool:
    by_id = {s.span_id: s for s in spans}
    while sp is not None:
        if sp.parent_id == root_id:
            return True
        sp = by_id.get(sp.parent_id)
    return False


def engine_turn() -> dict:
    import torch

    from colearn_federated_learning_tpu_torch import telemetry
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    vit = get_config("femnist_vit_cross_silo")
    configs = {
        "cnn": get_config("cifar10_cnn_fedavg"),
        "vit": vit.replace(
            model=dataclasses.replace(vit.model, attn_impl="flash",
                                      depth=DEPTH),
            fed=dataclasses.replace(vit.fed, cohort_size=16))}
    out = {}
    for name, cfg in configs.items():
        t0 = time.perf_counter()
        learner = FederatedLearner(cfg)
        torch.cuda.synchronize()
        out[name] = {
            "build_s": time.perf_counter() - t0,
            "h2d_transfer_s": telemetry.get_registry().gauge(
                "engine.h2d_transfer_s").value,
            "x_MB": learner.x.numel() * learner.x.element_size() / 1e6}
        del learner
        torch.cuda.empty_cache()
    return out


def child(root: str, rounds: int) -> None:
    sys.path.insert(0, root)
    out = {"root": root, **federation_turn(rounds), "engine": engine_turn()}
    try:
        from colearn_federated_learning_tpu_torch.ops import topk

        out["topk_abs_launches"] = topk.launches["topk_abs"]
    except ImportError:
        out["topk_abs_launches"] = None
    print("TURN " + json.dumps(out), flush=True)


def _card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="root of the other revision's checkout")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child, args.rounds)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_port_ab_compress: no CUDA device", file=sys.stderr)
        return 1
    roots = {"parent": os.path.abspath(args.parent), "change": HERE}
    order = (["parent", "change", "change", "parent"] * args.runs)[
        :2 * args.runs]
    turns = {"parent": [], "change": []}
    for side in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--parent",
             args.parent, "--rounds", str(args.rounds), "--child",
             roots[side]], capture_output=True, text=True, cwd=roots[side])
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return proc.returncode
        line = next(l for l in proc.stdout.splitlines()
                    if l.startswith("TURN "))
        turn = json.loads(line[5:])
        turns[side].append(turn)
        print(json.dumps({"side": side, **turn}), flush=True)
    summary = {}
    for side, runs in turns.items():
        warm = [max(r["compress_delta_s"][i]) for r in runs
                for i in range(1, len(r["compress_delta_s"]))]
        summary[side] = {
            "round_s_warm_median": statistics.median(
                s for r in runs for s in r["round_s"][1:]),
            "compress_delta_s_slowest_warm_median": statistics.median(warm),
            "compress_delta_s_all_warm_median": statistics.median(
                s for r in runs for rnd in r["compress_delta_s"][1:]
                for s in rnd),
            **{f"{name}_{k}_median": statistics.median(
                r["engine"][name][k] for r in runs)
               for name in ("cnn", "vit") for k in ("build_s",
                                                    "h2d_transfer_s")}}
    print(json.dumps({"summary": summary, "card": _card()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
