#!/usr/bin/env python
"""Chaos soak of the port: prove the socket plane's robustness machinery
under faults (the counterpart of the JAX package's ``scripts/chaos_soak.py``,
with its plan, its gate and its ``--tol``).

Runs TWO in-process federations (``faults/soak.py``) with identical
configs and seeds, one fault-free baseline and one under the canned
acceptance plan (drops, delays, one corrupt frame and one mid-run crash),
then asserts:

- every scheduled round produced a round record (zero lost records);
- the only skipped rounds are the explicit sub-quorum no-ops;
- the retry/fault counters actually moved (the plan really fired);
- the faulted model's final own-shard accuracy lands within ``--tol`` of
  the fault-free baseline's.

Exit 0 iff every assertion holds; the summary JSON goes to stdout either
way.  The trainers and the coordinator run on the card unless the caller
asks for the CPU:

    python scripts/torch_port_chaos_soak.py [--rounds 6] [--tol 0.1] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def check_soak(base: dict, faulted: dict, rounds: int,
               tol: float) -> list[str]:
    """Every acceptance violation, as human-readable strings (empty =
    pass): the JAX script's gate, word for word."""
    problems = []
    for name, s in (("baseline", base), ("faulted", faulted)):
        if s["rounds_run"] != rounds:
            problems.append(
                f"{name}: {s['rounds_run']}/{rounds} round records — "
                "records were lost")
    if base["skipped_rounds"]:
        problems.append(
            f"baseline skipped rounds {base['skipped_rounds']} with no "
            "faults injected")
    allowed_skips = {2}          # the canned plan's 3-drop sub-quorum round
    extra = set(faulted["skipped_rounds"]) - allowed_skips
    if extra:
        problems.append(f"faulted run skipped unexpected rounds {extra}")
    if not faulted["skipped_rounds"]:
        problems.append("the 3-drop round was NOT skipped: quorum "
                        "enforcement did not engage")
    if faulted["counters"]["fault.injected_total"] <= 0:
        problems.append("fault.injected_total is zero: the plan never "
                        "fired")
    if faulted["counters"]["comm.retry_total"] <= 0:
        problems.append("comm.retry_total is zero: no transient failure "
                        "was retried")
    if faulted["counters"]["comm.corrupt_frames_total"] <= 0:
        problems.append("comm.corrupt_frames_total is zero: the corrupt "
                        "frame was never detected")
    if "3" not in faulted["evicted"]:
        problems.append("crashed worker 3 was never evicted")
    if base["weighted_acc"] is None or faulted["weighted_acc"] is None:
        problems.append("missing final accuracy")
    else:
        # Compare on the devices BOTH runs evaluated: eviction removes the
        # crashed worker's shard from the faulted run's eval set.
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
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--num-workers", type=int, default=4)
    ap.add_argument("--round-timeout", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=7,
                    help="fault-plan seed (the experiment seed is the "
                         "config's)")
    ap.add_argument("--tol", type=float, default=0.1,
                    help="allowed |baseline - faulted| final-accuracy gap")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the card (default), or the CPU when asked")
    args = ap.parse_args(argv)

    from colearn_federated_learning_tpu_torch import faults

    backend = "gpu" if args.device == "cuda" else "cpu"
    log = lambda rec: print(json.dumps(rec), file=sys.stderr)  # noqa: E731
    print("# fault-free baseline", file=sys.stderr)
    base = faults.run_soak(rounds=args.rounds, n_workers=args.num_workers,
                           round_timeout=args.round_timeout, log_fn=log,
                           backend=backend)
    print("# canned fault plan", file=sys.stderr)
    faulted = faults.run_soak(rounds=args.rounds,
                              n_workers=args.num_workers,
                              plan=faults.canned_plan(seed=args.seed),
                              round_timeout=args.round_timeout, log_fn=log,
                              backend=backend)

    problems = check_soak(base, faulted, args.rounds, args.tol)
    print(json.dumps({"baseline": base, "faulted": faulted,
                      "problems": problems}))
    for p in problems:
        print(f"FAIL: {p}", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
