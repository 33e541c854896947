#!/usr/bin/env python
"""Literature-anchored accuracy validation of the port (the counterpart of
the JAX package's ``scripts/validate_literature.py``: its protocol, config,
anchors, record and exit codes).

Reproduces the canonical FedAvg MNIST experiment of McMahan et al. 2017,
"Communication-Efficient Learning of Deep Networks from Decentralized
Data" (AISTATS), §3 + Table 1:

- model: the paper's "2NN", an MLP with two hidden layers of 200 units
  (``ModelConfig(name="mlp", hidden_dim=200, depth=2)``);
- 100 clients, client fraction C=0.1 (cohort 10), local batch B=10,
  local epochs E=1, SGD;
- partitions: IID and "pathological non-IID" (sort by digit, 200 shards
  of 300, 2 shards per client).

Paper targets (Table 1, 2NN, C=0.1, B=10, E=1): 97 % test accuracy in
~87 rounds IID and ~664 rounds pathological non-IID.  The protocol accepts
2x the paper's rounds (one fixed lr where the paper tuned per cell) and
asserts the SHAPE anchors: IID reaches 97 % within 174 rounds, non-IID
within 1328, and non-IID needs MORE rounds than IID.

Requires REAL MNIST on disk (``scripts/fetch_data.py`` ->
``$COLEARN_DATA_DIR/mnist.npz``); a synthetic stand-in would validate
nothing about the literature, so the script exits 3 with a message when
it is absent.  Writes ``results/torch_port/literature_mnist.json``
(``--out``).  On the card unless the caller asks for the CPU:

    python scripts/torch_port_validate_literature.py [--only iid] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "results", "torch_port", "literature_mnist.json")

# Table 1 round counts (2NN, C=0.1, E=1, B=10): the anchors.
PAPER_ROUNDS_TO_97 = {"iid": 87, "pathological": 664}
TARGET_ACC = 0.97
BUDGET_FACTOR = 2.0  # accept <= 2x the paper (single fixed lr vs per-cell tuning)
NO_MNIST = ("literature validation needs REAL MNIST on disk: run "
            "scripts/fetch_data.py and set COLEARN_DATA_DIR")


def mcmahan_2nn_config(partition: str, rounds: int, lr: float, seed: int = 0):
    from colearn_federated_learning_tpu_torch.utils.config import (
        DataConfig, ExperimentConfig, FedConfig, ModelConfig, RunConfig)

    return ExperimentConfig(
        data=DataConfig(dataset="mnist", num_clients=100, partition=partition),
        model=ModelConfig(name="mlp", num_classes=10, hidden_dim=200, depth=2),
        fed=FedConfig(strategy="fedavg", rounds=rounds, cohort_size=10,
                      local_epochs=1, batch_size=10, lr=lr, momentum=0.0),
        run=RunConfig(name=f"mcmahan_2nn_{partition}", seed=seed,
                      backend="auto"),
    )


def run_curve(partition: str, rounds: int, lr: float, eval_every: int,
              target: float = TARGET_ACC, seed: int = 0,
              device=None) -> dict:
    """Train until ``target`` test accuracy or ``rounds``; returns the
    curve and the first round (1-based) at which the target was met (None
    if never).  Exits 3 without real MNIST on disk."""
    from colearn_federated_learning_tpu_torch.data import registry
    from colearn_federated_learning_tpu_torch.fed.engine import FederatedLearner

    cfg = mcmahan_2nn_config(partition, rounds, lr, seed)
    dataset = registry.get_dataset("mnist", seed=seed)
    if dataset.source != "disk":
        print(NO_MNIST, file=sys.stderr)
        sys.exit(3)
    learner = FederatedLearner.from_config(cfg, dataset=dataset,
                                           device=device)
    curve, reached = [], None
    t0 = time.perf_counter()
    for r in range(1, rounds + 1):
        learner.run_round(sync=False)
        if r % eval_every == 0 or r == rounds:
            _, acc = learner.evaluate()
            acc = float(acc)
            curve.append({"round": r, "test_acc": round(acc, 4)})
            if reached is None and acc >= target:
                reached = r
                break
    return {
        "partition": partition,
        "rounds_to_target": reached,
        "target_acc": target,
        "paper_rounds": PAPER_ROUNDS_TO_97[partition],
        "budget_rounds": int(PAPER_ROUNDS_TO_97[partition] * BUDGET_FACTOR),
        "curve": curve,
        "wall_seconds": round(time.perf_counter() - t0, 1),
        "platform": "gpu" if learner.device.type == "cuda" else "cpu",
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lr", type=float, default=0.1,
                   help="client SGD lr (paper tuned per cell; 0.1 is the "
                        "standard reproduction value for the 2NN)")
    p.add_argument("--eval-every", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--only", choices=["iid", "pathological"], default=None)
    p.add_argument("--out", default=OUT)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the card (default), or the CPU when asked")
    args = p.parse_args(argv)
    device = None if args.device == "cuda" else "cpu"

    parts = [args.only] if args.only else ["iid", "pathological"]
    out = {"protocol": "McMahan et al. 2017 Table 1 (2NN, C=0.1, B=10, E=1)",
           "lr": args.lr, "seed": args.seed, "recorded_unix": int(time.time()),
           "runs": []}
    ok = True
    for part in parts:
        budget = int(PAPER_ROUNDS_TO_97[part] * BUDGET_FACTOR)
        rec = run_curve(part, budget, args.lr, args.eval_every,
                        seed=args.seed, device=device)
        rec["ok"] = rec["rounds_to_target"] is not None
        ok &= rec["ok"]
        print(json.dumps({k: rec[k] for k in
                          ("partition", "rounds_to_target", "paper_rounds",
                           "budget_rounds", "ok", "wall_seconds")}))
        out["runs"].append(rec)

    by_part = {r["partition"]: r for r in out["runs"]}
    if {"iid", "pathological"} <= by_part.keys() and ok:
        # The paper's core observation: label skew slows FedAvg.
        slower = (by_part["pathological"]["rounds_to_target"]
                  > by_part["iid"]["rounds_to_target"])
        out["noniid_slower_than_iid"] = bool(slower)
        ok &= slower

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out}; ok={ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
