#!/usr/bin/env python3
"""N1, the uplink's top-k selector, from two checkouts of the port, in
turns, on the card; with ``--profile`` each kernel's device time.

    python3 scripts/torch_port_ab_topk.py [--parent DIR] [--runs 1] [--profile]

``DIR`` is the root of another revision's checkout (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  Each turn is a fresh process in one root that
builds that root's kernels and times its selector (``ops/topk.py``) at
5 % density on BERT-base's uplink leaves (``BERT_LEAVES``, 198 of them,
108,598,276 entries, drawn on the card from a seed):

- each distinct leaf size alone, by ``chip_smoke.device_ms`` (CUDA-graph
  replay; over 4 leaves where those exceed twice the L2 cache, so the
  large ones are read from HBM);
- the whole delta as one call (``topk_abs_many``) where the root has it,
  else one ``topk_abs`` per leaf, captured in one graph alike;
- with ``--profile``, ``torch.profiler``'s device time per kernel and
  launches per call (3 eager calls each) for every size and the delta.

The turns run parent, tree, tree, parent (``--runs`` pairs), so a drift
of the card during the call falls on both sides alike.  Prints one JSON
line per turn, then the card's name and power limit.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRACTION = 0.05
SETS = 4                       # leaves per timed size above the L2 cut
L2_BYTES = 50e6
# BERT-base's uplink leaves: the embeddings and their LayerNorm, 12 blocks
# (q, k, v, o with biases, two LayerNorms, the FFN), the head.
BERT_LEAVES = ([23_440_896, 98_304, 768, 768]
               + 12 * ([589_824, 768] * 4 + [768, 768, 2_359_296, 3072,
                                             2_359_296, 768, 768, 768])
               + [3072, 4])


def _selector(T):
    """``select(flats, ks, out_idx, out_val)`` on this root: one batched
    call, or one call per leaf on a root without the batch."""
    if hasattr(T, "topk_abs_many"):
        return T.topk_abs_many

    def per_leaf(flats, ks, out_idx, out_val):
        off = 0
        for f, k in zip(flats, ks):
            T.topk_abs(f, k, out_idx[off:off + k], out_val[off:off + k])
            off += k
    return per_leaf


def _kernel_times(fn, calls: int = 3) -> dict:
    """Device microseconds and launches per call of each kernel ``fn``
    runs, from ``torch.profiler`` over ``calls`` eager calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us:
            name = ev.key if len(ev.key) <= 60 else ev.key[:57] + "..."
            out[name] = {"us": us / calls, "launches": ev.count / calls}
    return out


def turn(root: str, profile: bool) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as S
    from colearn_federated_learning_tpu_torch.ops import _build
    from colearn_federated_learning_tpu_torch.ops import topk as T

    _build.build_all()
    select = _selector(T)
    g = torch.Generator(device="cuda").manual_seed(25)
    rows = []
    for n in sorted(set(BERT_LEAVES)):
        k = math.ceil(FRACTION * n)
        sets = SETS if 4 * n * SETS > 2 * L2_BYTES else 1
        xs = [1e-3 * torch.randn(n, generator=g, device="cuda")
              for _ in range(sets)]
        oi = torch.empty(k, dtype=torch.int32, device="cuda")
        ov = torch.empty(k, dtype=torch.float32, device="cuda")
        row = {"n": n, "k": k, "sets": sets,
               "us": 1e3 * S.device_ms(lambda x: select([x], [k], oi, ov),
                                       xs)}
        if profile:
            row["kernels"] = _kernel_times(
                lambda: select([xs[0]], [k], oi, ov))
        rows.append(row)
        del xs
    flats = [1e-3 * torch.randn(n, generator=g, device="cuda")
             for n in BERT_LEAVES]
    ks = [math.ceil(FRACTION * n) for n in BERT_LEAVES]
    oi = torch.empty(sum(ks), dtype=torch.int32, device="cuda")
    ov = torch.empty(sum(ks), dtype=torch.float32, device="cuda")
    whole = {"leaves": len(flats), "entries": sum(BERT_LEAVES),
             "batched": hasattr(T, "topk_abs_many"),
             "us": 1e3 * S.device_ms(lambda fl: select(fl, ks, oi, ov),
                                     [flats])}
    if profile:
        whole["kernels"] = _kernel_times(lambda: select(flats, ks, oi, ov))
    return {"root": root, "sizes": rows, "delta": whole}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the other revision's checkout")
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        print("TURN " + json.dumps(turn(args.turn, args.profile)),
              flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_port_ab_topk: no CUDA device", file=sys.stderr)
        return 1
    roots = [HERE]
    if args.parent:
        parent = os.path.abspath(args.parent)
        roots = [parent, HERE, HERE, parent]
    for _ in range(args.runs):
        for root in roots:
            cmd = [sys.executable, os.path.abspath(__file__), "--turn", root]
            if args.profile:
                cmd.append("--profile")
            subprocess.run(cmd, check=True, cwd=root)
    sys.path.insert(0, HERE)
    from chip_smoke import card

    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
