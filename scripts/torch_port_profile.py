#!/usr/bin/env python3
"""Where a round of the PyTorch port's main path spends its time.

    python3 scripts/torch_port_profile.py

Builds the ``chip_smoke.py`` main path (``agnews_bert_fedavg`` with
``attn_impl="flash"``, 4 local steps, on one CUDA card), runs one warm-up
round, times one round and one evaluation, then profiles one round and one
evaluation with ``torch.profiler``
and prints, per phase: wall seconds, device-busy seconds (union of kernel
intervals), the idle share, and device time grouped by kernel family
(flash-attention kernels, matmuls, optimizer ``_foreach`` passes, other)
and the kernels that take the most device time.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FAMILIES = (
    ("flash_attention", ("fa::flash_fwd", "fa::flash_dq", "fa::flash_dkv")),
    ("matmul", ("gemm", "cutlass", "sm90_xmma", "nvjet", "cublas")),
    ("optimizer_foreach", ("multi_tensor_apply", "foreach")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k.lower() in low for k in keys):
            return fam
    return "other"


def device_busy_us(events) -> float:
    """Union length of the device kernels' [start, end) intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def summarize(prof, wall_s: float, phase: str) -> dict:
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_family: dict[str, float] = {}
    for e in kernels:
        by_family[family(e.name)] = (by_family.get(family(e.name), 0.0)
                                     + e.time_range.elapsed_us())
    busy = device_busy_us(kernels)
    per_name: dict[str, float] = {}
    for e in kernels:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:12]
    out = {
        "phase": phase, "wall_s": wall_s, "device_busy_s": busy / 1e6,
        "device_idle_share": 1.0 - busy / 1e6 / wall_s,
        "kernels": len(kernels),
        "device_s_by_family": {k: v / 1e6 for k, v in sorted(by_family.items())},
        "top_kernels_s": [[name[:90], us / 1e6] for name, us in top],
    }
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_port_profile: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import main_path_config
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner

    learner = FederatedLearner(main_path_config())
    learner.run_round()                                  # warm-up
    learner.evaluate()
    # The profiler's own host overhead inflates wall time and idle share;
    # an unprofiled round and evaluation give the figures to read them
    # against.
    for phase, fn in (("round", learner.run_round),
                      ("evaluate", learner.evaluate)):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        print(json.dumps({"phase": f"{phase}_unprofiled",
                          "wall_s": time.perf_counter() - t0}), flush=True)
    for phase, fn in (("round", learner.run_round),
                      ("evaluate", learner.evaluate)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        summarize(prof, wall, phase)
    return 0


if __name__ == "__main__":
    sys.exit(main())
