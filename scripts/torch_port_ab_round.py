#!/usr/bin/env python3
"""Seconds per round of one config from two checkouts of the port, in turns.

    python3 scripts/torch_port_ab_round.py --parent DIR
    python3 scripts/torch_port_ab_round.py --parent DIR \\
        --config cifar10_cnn_fedavg --rounds 2 --runs 3

``DIR`` is the root of another revision's checkout (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  Each turn is a fresh process that imports
``colearn_federated_learning_tpu_torch`` from one root, builds
``FederatedLearner(get_config(NAME))`` on the card as it is, and times
``--rounds`` rounds and one evaluation by the host clock with the card
synchronised after each; the turns run parent, this tree, this tree,
parent, ... (``--runs`` of each), so a drift of the host during the call
falls on both sides alike.  Prints one JSON line per turn, then the
median of each round index and of the evaluation per side, beside the
card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(root: str, name: str, rounds: int) -> None:
    """One turn: build the learner from ``root``'s package and time it."""
    sys.path.insert(0, root)
    import torch

    from colearn_federated_learning_tpu_torch.fed import FederatedLearner
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    t0 = time.perf_counter()
    learner = FederatedLearner(get_config(name))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    round_s, losses = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        rec = learner.run_round()
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        losses.append(float(rec["train_loss"]))
    t0 = time.perf_counter()
    learner.evaluate()
    torch.cuda.synchronize()
    print(json.dumps({"root": root, "build_s": build_s, "round_s": round_s,
                      "eval_s": time.perf_counter() - t0,
                      "train_loss": losses}), flush=True)


def card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of the other revision's checkout")
    ap.add_argument("--config", default="cifar10_cnn_fedavg")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.config, args.rounds)
        return 0
    sides = {"parent": os.path.abspath(args.parent), "change": HERE}
    order = [("parent", "change", "change", "parent")[i % 4]
             for i in range(2 * args.runs)]
    turns = {"parent": [], "change": []}
    for side in order:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--parent",
             args.parent, "--config", args.config, "--rounds",
             str(args.rounds), "--child", sides[side]],
            cwd=sides[side], capture_output=True, text=True)
        if out.returncode != 0:
            sys.stderr.write(out.stderr)
            raise SystemExit(f"{side} turn failed: rc {out.returncode}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        rec["side"] = side
        print(json.dumps(rec), flush=True)
        turns[side].append(rec)
    summary = {"config": args.config, "card": card()}
    for side, recs in turns.items():
        summary[side] = {
            "runs": len(recs),
            "median_round_s": [statistics.median(r["round_s"][i] for r in recs)
                               for i in range(args.rounds)],
            "median_eval_s": statistics.median(r["eval_s"] for r in recs),
            "train_loss": recs[0]["train_loss"],
        }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
