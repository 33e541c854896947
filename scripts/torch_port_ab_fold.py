#!/usr/bin/env python3
"""The server fold's phase 9a from two checkouts of the port, in turns.

    python3 scripts/torch_port_ab_fold.py --parent DIR [--tree DIR] [--runs 2]

``DIR`` is the root of a checkout (for example the parent commit unpacked
with ``git archive`` into a directory that ``.gitignore`` lists; ``--tree``
defaults to this checkout).  Each turn is a fresh process in one root that
builds that root's kernels (``chip_smoke.build_phase``) and runs its
``chip_smoke.fold_check_phase`` (phase 9a: the fold kernel bitwise against
its plain version at BERT-base's slot layout, then its device time, copy,
plain version, ``index_add_`` and bound per topk8 contribution), then
times that root's ``FoldKernel.fold_sparse`` call on 9a's topk8 batch onto
a standing accumulator, per contribution: the whole call by the host clock
from a sync to a sync (median of 5), and in 5 more calls the host's pack,
the staging copy's and the kernels' device spans (CUDA events).  A root
whose kernel packs a whole batch before one copy (no ``_pack_part``) has
its pack timed between its staging buffer and its copy.  The turns run
parent, tree, tree, parent (``--runs`` pairs), so a drift of the card or
the host during the call falls on both sides alike.  Prints one JSON line
per turn and the median of each number per side, beside the card's name
and power limit.  Needs a CUDA device.
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
KEYS = ("ms", "bound_ms", "h2d_ms", "library_ms", "plain_ms", "call_ms",
        "pack_ms", "copy_ms", "kernel_ms")


def call_times(F, kernel, acc, batch, calls: int = 5) -> dict:
    """The whole ``fold_sparse`` call per contribution (median of
    ``calls``), then pack, copy and kernel spans per contribution (means
    over ``calls`` more), on any revision of ``FoldKernel``."""
    import torch

    n = len(batch)
    whole = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernel.fold_sparse(acc, batch)
        torch.cuda.synchronize()
        whole.append((time.perf_counter() - t0) / n)
    K = F.FoldKernel
    spans = {"copy": [], "kernel": []}
    pack = []
    marks = {}

    def events(fn, kind, stream_of):
        def run(self, *args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(stream_of(self))
            out = fn(self, *args)
            b.record(stream_of(self))
            spans[kind].append((a, b))
            return out
        return run

    current = lambda self: torch.cuda.current_stream()
    saved = {name: K.__dict__[name] for name in
             ("_staging", "_upload", "_upload_part", "_pack_part",
              "_fold_part", "fold_sparse_staged") if name in K.__dict__}
    if "_pack_part" in saved:
        inner = saved["_pack_part"].__func__

        def timed_pack(*args):
            t0 = time.perf_counter()
            out = inner(*args)
            pack.append(time.perf_counter() - t0)
            return out
        K._pack_part = staticmethod(timed_pack)
        K._upload_part = events(saved["_upload_part"], "copy",
                                lambda self: self._copy_stream)
        K._fold_part = events(saved["_fold_part"], "kernel", current)
    else:
        def staging(self, nbytes):
            out = saved["_staging"](self, nbytes)
            marks["t0"] = time.perf_counter()
            return out

        def upload(self, buf, nbytes):
            pack.append(time.perf_counter() - marks.pop("t0"))
            return saved["_upload"](self, buf, nbytes)
        K._staging = staging
        K._upload = events(upload, "copy", current)
        K.fold_sparse_staged = events(saved["fold_sparse_staged"], "kernel",
                                      current)
    try:
        for _ in range(calls):
            kernel.fold_sparse(acc, batch)
        torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(K, name, fn)
    per = n * calls
    return {"call_ms": statistics.median(whole) * 1e3,
            "pack_ms": 1e3 * sum(pack) / per,
            "copy_ms": sum(a.elapsed_time(b) for a, b in spans["copy"]) / per,
            "kernel_ms": sum(a.elapsed_time(b)
                             for a, b in spans["kernel"]) / per}


def child(root: str) -> None:
    """One turn in ``root``: build, phase 9a, the call's times."""
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as S
    from colearn_federated_learning_tpu_torch.fed import setup
    from colearn_federated_learning_tpu_torch.ops import _build
    from colearn_federated_learning_tpu_torch.ops import fold as F
    from colearn_federated_learning_tpu_torch.utils import trees

    S.build_phase(_build)
    rows = S.fold_check_phase(F)
    shapes = setup.init_global_params(S.main_path_config(), "cuda")
    sizes = [int(np.asarray(l).size) for l in trees.leaves(shapes)]
    del shapes
    kernel = F.get_kernel(sizes)
    batch = S.sparse_batch(sizes, S.FOLD_ROWS, True, 91)   # 9a's topk8
    acc = torch.zeros(kernel.total, dtype=torch.float32, device="cuda")
    row = {k: rows["fold_sparse"].get(k) for k in KEYS}
    row.update(call_times(F, kernel, acc, batch))
    print("AB " + json.dumps({"root": root, "card": S.card(), **row}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return 0
    roots = {"parent": os.path.abspath(args.parent),
             "tree": os.path.abspath(args.tree)}
    order = ["parent", "tree", "tree", "parent"] * max(1, args.runs // 2)
    if args.runs % 2:
        order += ["parent", "tree"]
    turns = {"parent": [], "tree": []}
    for side in order:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--parent",
             args.parent, "--child", roots[side]],
            capture_output=True, text=True, timeout=900)
        lines = [l for l in proc.stdout.splitlines() if l.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            sys.stdout.write(proc.stdout[-4000:])
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"{side} turn failed ({proc.returncode})")
        rec = {"side": side, "turn_s": time.perf_counter() - t0,
               **json.loads(lines[-1][3:])}
        turns[side].append(rec)
        print(json.dumps(rec), flush=True)
        for line in proc.stdout.splitlines():
            if "fold_sparse" in line or "BERT-base layout" in line:
                print(f"  [{side}] {line.strip()}", flush=True)
    summary = {side: {k: statistics.median(r[k] for r in recs)
                      for k in KEYS if all(r.get(k) is not None
                                           for r in recs)}
               for side, recs in turns.items()}
    print(json.dumps({"median": summary,
                      "card": turns["tree"][0]["card"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
