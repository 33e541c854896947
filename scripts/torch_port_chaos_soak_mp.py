#!/usr/bin/env python
"""Multi-process chaos soak of the port: prove the federation survives real
SIGKILLs (the counterpart of the JAX package's ``scripts/chaos_soak_mp.py``,
with its kill schedule, its gate and its ``--tol``).

Runs TWO subprocess federations (``faults/procsoak.py``) with identical
configs and seeds, one kill-free baseline and one under the canned kill
schedule (a worker dies and restarts; the COORDINATOR dies mid-round and
must come back with ``--resume``), then asserts:

- both runs produce a record for every scheduled round (the resumed
  coordinator re-ran the uncommitted round instead of losing it);
- the faulted run actually resumed (``rounds_resumed >= 1``);
- every scheduled kill was delivered;
- the faulted model's final own-shard accuracy lands within ``--tol`` of
  the baseline's on the clients both runs evaluated.

Exit 0 iff every assertion holds; the summary JSON goes to stdout either
way.  The processes run on the card unless the caller asks for the CPU:

    python scripts/torch_port_chaos_soak_mp.py [--rounds 6] [--num-workers 3]
                                               [--tol 0.1] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def check_proc_soak(base: dict, faulted: dict, rounds: int, tol: float,
                    kills: list) -> list[str]:
    """Every acceptance violation, as human-readable strings (empty =
    pass): the JAX script's gate, word for word."""
    problems = []
    for name, s in (("baseline", base), ("faulted", faulted)):
        if s["exit_code"] != 0:
            problems.append(f"{name}: coordinator exited "
                            f"{s['exit_code']}, not 0")
        if s["rounds_run"] != rounds:
            problems.append(
                f"{name}: {s['rounds_run']}/{rounds} round records — "
                "rounds were lost across the kills")
    if base["rounds_resumed"]:
        problems.append("baseline resumed with no kills delivered")
    expect_resume = any(k.target == "coordinator" for k in kills)
    if expect_resume and faulted["rounds_resumed"] < 1:
        problems.append("coordinator was SIGKILLed but never resumed "
                        "(rounds_resumed == 0)")
    if len(faulted["kills"]) != len(kills):
        problems.append(
            f"only {len(faulted['kills'])}/{len(kills)} scheduled kills "
            "were delivered")
    if base["weighted_acc"] is None or faulted["weighted_acc"] is None:
        problems.append("missing final accuracy")
    else:
        # Compare on the clients BOTH runs evaluated: eviction can shrink
        # the faulted run's eval set while its worker restarts.
        common = sorted(set(base.get("per_client_acc", {}))
                        & set(faulted.get("per_client_acc", {})))
        if common:
            b = sum(base["per_client_acc"][c] for c in common) / len(common)
            f = sum(faulted["per_client_acc"][c]
                    for c in common) / len(common)
        else:
            b, f = base["weighted_acc"], faulted["weighted_acc"]
        if abs(b - f) > tol:
            problems.append(
                f"final accuracy drifted: baseline {b:.3f} vs faulted "
                f"{f:.3f} over {len(common) or 'all'} common clients "
                f"(tol {tol})")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--num-workers", type=int, default=3)
    ap.add_argument("--round-timeout", type=float, default=120.0)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="per-run wall-clock backstop in seconds")
    ap.add_argument("--tol", type=float, default=0.1,
                    help="allowed |baseline - faulted| final-accuracy gap")
    ap.add_argument("--workdir", default=None,
                    help="scratch root (default: fresh temp dirs)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the card (default), or the CPU when asked")
    args = ap.parse_args(argv)

    from colearn_federated_learning_tpu_torch.faults import procsoak

    log = lambda rec: print(json.dumps(rec), file=sys.stderr)  # noqa: E731
    kills = procsoak.canned_kill_schedule(args.rounds, args.num_workers)

    def run(tag, kill_list):
        wd = (os.path.join(args.workdir, tag) if args.workdir else None)
        return procsoak.run_proc_soak(
            rounds=args.rounds, n_workers=args.num_workers,
            kills=kill_list, workdir=wd,
            round_timeout=args.round_timeout, timeout_s=args.timeout,
            log_fn=log, backend="gpu" if args.device == "cuda" else "cpu")

    print("# kill-free baseline", file=sys.stderr)
    base = run("baseline", [])
    print(f"# kill schedule: {[k.target for k in kills]}", file=sys.stderr)
    faulted = run("faulted", kills)

    problems = check_proc_soak(base, faulted, args.rounds, args.tol, kills)
    print(json.dumps({"baseline": base, "faulted": faulted,
                      "problems": problems}))
    for p in problems:
        print(f"FAIL: {p}", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
