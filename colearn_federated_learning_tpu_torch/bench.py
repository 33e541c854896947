"""Headline benchmark of the port: FedAvg rounds/sec on the card.

    python -m colearn_federated_learning_tpu_torch.cli bench [--rounds N]

The counterpart of the JAX package's ``bench.py``, measuring the same
work: config #2's shape (CIFAR-10 CNN width 64, bf16, 64 Dirichlet
clients of 256 examples, cohort 16, 8 local steps x batch 32, SGD with
momentum), a federated round of cohort sampling, local training, the
weighted fold and the server step.  The learner is laid out as the JAX
bench lays its own (``FederatedLearner.from_config``): under ``torchrun``
a ``(clients,)`` mesh over the world, whose size is ``n_devices``; the
cohort is cut to a multiple of it, and the per-chip rate is divided by
it.  The rate is the timed rounds over the host seconds of the timed
window, after ``--warmup`` rounds; the card is
synchronised at the window's end and not between rounds.  One process
measures once: repeat calls to see the spread.  Each round's
``round_time_s`` (the host's time between round starts) and their median
go to stderr.

``vs_baseline`` compares with ``run_reference_style``, a copy of the JAX
package's stand-in for the reference architecture (sequential per-client
PyTorch training on the CPU and a host-side weighted average of state
dicts) on the same shapes.

Prints ONE JSON line with the JAX bench's keys, the card's name and its
power limit (``nvidia-smi``).  Without a card it exits non-zero and
prints no result: there is no silent CPU fallback.  ``--backend cpu``
runs the JAX bench's CPU workload (config #1's MLP shape) because the
caller asked, and says so in ``note``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Optional

# The card's workload: CIFAR-10 CNN FedAvg at config #2's shape.
TPU_WORKLOAD = dict(model="cnn", dataset="cifar10", cohort=16, local_steps=8,
                    batch=32, width=64, num_clients=64,
                    examples_per_client=256, dtype="bfloat16")

# The CPU workload: config #1's shape (MNIST MLP, 10 clients), with 20
# local steps so a round amortizes its fixed costs; both sides run it.
CPU_WORKLOAD = dict(model="mlp", dataset="mnist", cohort=10, local_steps=20,
                    batch=32, hidden=200, depth=2, num_clients=10,
                    examples_per_client=640, dtype="float32")

# Flags of the JAX bench that belong to its platform probe and CPU
# fallback, which the port does not have.
_REFUSED = {
    "probe_timeout": "--probe-timeout",
    "probe_budget": "--probe-budget",
    "force_cpu": "--force-cpu",
}


def _make_config(w: dict):
    from colearn_federated_learning_tpu_torch.utils.config import (
        DataConfig, ExperimentConfig, FedConfig, ModelConfig, RunConfig)

    if w["model"] == "cnn":
        model = ModelConfig(name="cnn", num_classes=10, width=w["width"],
                            dtype=w["dtype"])
        data = DataConfig(dataset=w["dataset"], num_clients=w["num_clients"],
                          partition="dirichlet", dirichlet_alpha=0.5,
                          max_examples_per_client=w["examples_per_client"])
    else:
        model = ModelConfig(name="mlp", num_classes=10,
                            hidden_dim=w["hidden"], depth=w["depth"],
                            dtype=w["dtype"])
        data = DataConfig(dataset=w["dataset"], num_clients=w["num_clients"],
                          partition="iid",
                          max_examples_per_client=w["examples_per_client"])
    return ExperimentConfig(
        data=data, model=model,
        fed=FedConfig(strategy="fedavg", cohort_size=w["cohort"],
                      local_steps=w["local_steps"], batch_size=w["batch"],
                      lr=0.05, momentum=0.9),
        run=RunConfig(name="bench", backend="auto"))


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def _agreed(learner, value: float) -> float:
    """``value`` as every rank of the learner's mesh sees it (their
    largest), so that ranks in lockstep take the same decisions."""
    if learner.mesh is None:
        return value
    import torch
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.float64, device=learner.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def run_port(rounds: int, warmup: int, workload: Optional[dict] = None,
             min_time_s: float = 0.0, device=None) -> dict:
    """Time ``rounds`` federated rounds of the port after ``warmup``
    rounds; with ``min_time_s`` > 0, keep timing more rounds until the
    window holds at least that many seconds.  ``device`` None is the
    card.  The learner is laid out by ``FederatedLearner.from_config``, as
    the JAX bench lays its own: under ``torchrun`` a ``(clients,)`` mesh
    over the world, whose size is ``n_devices`` and divides the
    per-chip rate; the cohort is the learner's own, mesh-adjusted one."""
    import torch

    from colearn_federated_learning_tpu_torch.data import registry as data_registry
    from colearn_federated_learning_tpu_torch.fed.engine import FederatedLearner

    w = workload or TPU_WORKLOAD
    config = _make_config(w)
    dataset = data_registry.get_dataset(
        w["dataset"], seed=0,
        max_train=w["num_clients"] * w["examples_per_client"], max_test=512)
    learner = FederatedLearner.from_config(config, dataset=dataset,
                                           device=device)
    n_devices = learner.mesh.size() if learner.mesh is not None else 1
    # The round's actual work (the cohort may be adjusted to the mesh).
    samples_per_round = learner.cohort_size * learner.num_steps * w["batch"]

    def wait():
        if learner.device.type == "cuda":
            torch.cuda.synchronize(learner.device)

    for _ in range(warmup):
        learner.run_round()
    wait()

    total_rounds, chunk = 0, rounds
    starts = []
    t0 = time.perf_counter()
    while True:
        for _ in range(chunk):
            starts.append(time.perf_counter())
            learner.run_round(sync=False)
        wait()
        dt = _agreed(learner, time.perf_counter() - t0)
        total_rounds += chunk
        if dt >= min_time_s:
            break
        rate = total_rounds / max(dt, 1e-9)
        chunk = max(1, int(rate * (min_time_s - dt) + 1))
    ends = starts[1:] + [t0 + dt]
    round_times = [b - a for a, b in zip(starts, ends)]
    records = learner.finalize_history()
    if not all(math.isfinite(r["train_loss"]) for r in records):
        raise RuntimeError("bench: a round's train_loss is not finite")
    rps = total_rounds / dt
    return {
        "rounds_per_sec": rps,
        "client_samples_per_sec_per_chip": rps * samples_per_round / n_devices,
        "n_devices": n_devices,
        "cohort": learner.cohort_size,
        "samples_per_round": samples_per_round,
        "rounds_timed": total_rounds,
        "seconds_timed": round(dt, 3),
        "round_time_s": round_times,
        "platform": "gpu" if learner.device.type == "cuda" else "cpu",
    }


def run_reference_style(rounds: int, workload: dict | None = None) -> dict:
    """Reference architecture stand-in: sequential per-client torch-CPU SGD +
    host-side numpy weighted averaging of state_dicts (SURVEY.md §3a/§3c).
    ``workload`` must match the measured run's (same model family and
    shapes) for ``vs_baseline`` to be a like-for-like ratio."""
    import numpy as np
    import torch
    import torch.nn as tnn

    w = workload or TPU_WORKLOAD
    cohort, local_steps = w["cohort"], w["local_steps"]
    batch = w["batch"]
    torch.manual_seed(0)

    if w["model"] == "cnn":
        width = w["width"]

        class TorchModel(tnn.Module):
            # Same op graph as colearn_federated_learning_tpu/models/cnn.py.
            def __init__(self, width=width, num_classes=10):
                super().__init__()
                layers, in_ch = [], 3
                for mult in (1, 2, 4):
                    ch = width * mult
                    layers += [
                        tnn.Conv2d(in_ch, ch, 3, padding=1),
                        tnn.GroupNorm(min(32, ch), ch), tnn.ReLU(),
                        tnn.Conv2d(ch, ch, 3, padding=1),
                        tnn.GroupNorm(min(32, ch), ch), tnn.ReLU(),
                        tnn.MaxPool2d(2),
                    ]
                    in_ch = ch
                self.features = tnn.Sequential(*layers)
                self.head = tnn.Linear(in_ch, num_classes)

            def forward(self, x):
                h = self.features(x)
                return self.head(h.mean(dim=(2, 3)))

        xshape = (3, 32, 32)
    else:
        hidden, depth = w["hidden"], w["depth"]

        class TorchModel(tnn.Module):
            # Same op graph as colearn_federated_learning_tpu/models/mlp.py.
            def __init__(self, hidden=hidden, depth=depth, num_classes=10):
                super().__init__()
                layers, d_in = [], 28 * 28
                for _ in range(depth):
                    layers += [tnn.Linear(d_in, hidden), tnn.ReLU()]
                    d_in = hidden
                layers.append(tnn.Linear(d_in, num_classes))
                self.net = tnn.Sequential(*layers)

            def forward(self, x):
                return self.net(x.reshape(x.shape[0], -1))

        xshape = (28, 28)

    rng = np.random.default_rng(0)
    data = [
        (torch.randn(local_steps, batch, *xshape),
         torch.from_numpy(rng.integers(0, 10, (local_steps, batch))).long())
        for _ in range(cohort)
    ]
    global_model = TorchModel()
    global_sd = {k: v.clone() for k, v in global_model.state_dict().items()}
    loss_fn = tnn.CrossEntropyLoss()

    t0 = time.perf_counter()
    for _ in range(rounds):
        updates, weights = [], []
        for cx, cy in data:  # sequential workers, as in the reference
            model = TorchModel()
            model.load_state_dict(global_sd)  # "broadcast"
            opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
            for s in range(local_steps):
                opt.zero_grad()
                loss_fn(model(cx[s]), cy[s]).backward()
                opt.step()
            # "websocket return": state_dict to host numpy
            updates.append({k: v.detach().numpy() for k, v in model.state_dict().items()})
            weights.append(local_steps * batch)
        # host-side fed_avg(weights, sizes)
        total = float(sum(weights))
        global_sd = {
            k: torch.from_numpy(
                sum(w * u[k] for w, u in zip(weights, updates)) / total
            )
            for k in updates[0]
        }
    dt = time.perf_counter() - t0
    return {"rounds_per_sec": rounds / dt}


def _metric_name(w: dict) -> str:
    return f"fedavg_{w['dataset']}_{w['model']}_rounds_per_sec"


def build_parser(add_help: bool = True) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="colearn bench", add_help=add_help)
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--baseline-rounds", type=int, default=1)
    p.add_argument("--skip-baseline", action="store_true")
    p.add_argument("--backend", choices=["gpu", "cpu"], default="gpu",
                   help="the card (default; exits non-zero without one), or "
                        "the CPU workload on the CPU")
    p.add_argument("--min-time", type=float, default=15.0,
                   help="--backend cpu only: minimum seconds of timed "
                        "rounds (rounds_timed is chosen to meet it)")
    for dest, flag in _REFUSED.items():
        p.add_argument(flag, dest=dest, default=None,
                       help="the JAX bench's probe and CPU fallback; "
                            "refused", **({"action": "store_true"}
                                          if dest == "force_cpu"
                                          else {"type": float}))
    return p


def main(argv: list[str] | None = None) -> dict:
    """Parse ``argv`` (``sys.argv`` when None) and :func:`run` the bench."""
    return run(build_parser().parse_args(argv))


def run(args: argparse.Namespace) -> dict:
    """Run the bench and print its JSON line; returns it.  Exits with
    status 2 for a refused flag and 1 without a card, printing no
    result.  Under ``torchrun`` rank 0 alone prints the line (and runs
    the baseline); the other ranks return their ``run_port`` summary."""
    refused = [flag for dest, flag in _REFUSED.items()
               if getattr(args, dest) not in (None, False)]
    if refused:
        for flag in refused:
            print(f"{flag} is refused: the port's bench has no platform "
                  "probe and no CPU fallback (use --backend cpu to ask for "
                  "the CPU workload)", file=sys.stderr)
        raise SystemExit(2)
    on_cpu = args.backend == "cpu"
    if not on_cpu:
        import torch

        if not torch.cuda.is_available():
            print("bench: no CUDA device (use --backend cpu for the CPU "
                  "workload)", file=sys.stderr)
            raise SystemExit(1)
    workload = CPU_WORKLOAD if on_cpu else TPU_WORKLOAD
    rounds, floor = ((min(args.rounds, 10), args.min_time) if on_cpu
                     else (args.rounds, 0.0))
    ours = run_port(rounds, args.warmup, workload, min_time_s=floor,
                    device="cpu" if on_cpu else None)
    times = ours.pop("round_time_s")
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_rank() != 0:
        return ours                 # one line per world, from rank 0
    print(f"[bench] round_time_s {json.dumps(times)}; median "
          f"{statistics.median(times)}", file=sys.stderr)
    print(f"[bench] port: {ours}", file=sys.stderr)

    vs = 0.0
    if not args.skip_baseline:
        base = run_reference_style(args.baseline_rounds, workload)
        print(f"[bench] reference-style torch-cpu: {base}", file=sys.stderr)
        vs = ours["rounds_per_sec"] / base["rounds_per_sec"]
    out = {
        "metric": _metric_name(workload),
        "value": round(ours["rounds_per_sec"], 4),
        "unit": "rounds/sec",
        "vs_baseline": round(vs, 4),
        "platform": ours["platform"],
        "n_devices": ours["n_devices"],
        "rounds_timed": ours["rounds_timed"],
        "seconds_timed": ours["seconds_timed"],
        "client_samples_per_sec_per_chip": round(
            ours["client_samples_per_sec_per_chip"], 1),
    }
    if on_cpu:
        out["note"] = (
            "--backend cpu: config #1's workload (MNIST MLP, 10 clients) on "
            "the CPU, as the caller asked; both sides run the identical "
            "shape on the same host CPU")
    else:
        import torch

        out["device"] = torch.cuda.get_device_name(0)
        out["card"] = card()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
