"""Run the port's ``dryrun.dryrun_multichip(N)`` in a subprocess per N and
record the outcome (the counterpart of the JAX package's
``scripts/record_dryrun.py``, with its record keys).

Usage:
    python scripts/torch_port_record_dryrun.py [N ...]            # card; default 1
    python scripts/torch_port_record_dryrun.py --device cpu [N ...]  # default 8 32

Writes ``results/torch_port/dryrun_multichip.json`` (``--out``): one
record per N with ok/rc/wall seconds.  On the card every rank takes a card
of its own (NCCL), so N may not exceed the host's cards; ``--device cpu``
runs N gloo ranks on the CPU.  Exits 1 if any N failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "results", "torch_port", "dryrun_multichip.json")


def meshes(n: int) -> str:
    """The meshes a world of ``n`` runs (JAX's words)."""
    return ("1-D clients + 3-D (clients, seq, model) MoE-BERT"
            if n % 4 == 0 else "1-D clients (+2-D if even)")


def run_one(n: int, device: str, timeout: float = 1800.0) -> dict:
    arg = "" if device == "cuda" else ", device='cpu'"
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c",
         "from colearn_federated_learning_tpu_torch import dryrun as g; "
         f"g.dryrun_multichip({n}{arg}); print('OK')"],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p)))
    wall = time.perf_counter() - t0
    ok = r.returncode == 0 and "OK" in r.stdout
    rec = {"n_devices": n, "ok": ok, "rc": r.returncode,
           "wall_seconds": round(wall, 1), "meshes": meshes(n)}
    if not ok:
        rec["tail"] = (r.stdout + r.stderr)[-1000:]
    print(json.dumps(rec), flush=True)
    return rec


def platform(device: str) -> str:
    if device == "cpu":
        return "cpu (gloo ranks; torch.distributed)"
    import torch

    return f"gpu ({torch.cuda.get_device_name(0)}; NCCL, one rank per card)"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ns", type=int, nargs="*",
                   help="world sizes (default: 1 on the card, 8 32 on the "
                        "CPU)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("record_dryrun: no CUDA device (use --device cpu for gloo "
                  "ranks on the CPU)", file=sys.stderr)
            return 1
    ns = args.ns or ([1] if args.device == "cuda" else [8, 32])
    records = [run_one(n, args.device) for n in ns]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    payload = {"recorded_unix": int(time.time()),
               "platform": platform(args.device), "runs": records}
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out}")
    return 0 if all(r["ok"] for r in records) else 1


if __name__ == "__main__":
    raise SystemExit(main())
