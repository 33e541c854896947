#!/usr/bin/env python3
"""Where a round of the PyTorch port's main path spends its time.

    python3 scripts/torch_port_profile.py
    python3 scripts/torch_port_profile.py --config cifar10_cnn_fedavg
    python3 scripts/torch_port_profile.py --parent-csrc DIR

Builds the ``chip_smoke.py`` BERT path (``agnews_bert_fedavg`` with
``attn_impl="flash"``, 4 local steps, on one CUDA card) or, with
``--config NAME``, that registry config as it is; runs one warm-up round,
times one round and one evaluation, then profiles one round and one
evaluation with ``torch.profiler``
and prints, per phase: wall seconds, device-busy seconds (union of kernel
intervals), the idle share, and device time grouped by kernel family
(flash-attention kernels, convolutions, matmuls, optimizer ``_foreach``
passes, GroupNorm/pooling/elementwise, other) and the kernels that take
the most device time.  Needs a CUDA device.

With ``--parent-csrc DIR`` (another revision's ``csrc/``, with the same C
entry points) it compares the two builds in one process, in turns parent,
this tree, this tree, parent: each turn times K1-K3 by device time at the
training shapes and K1 at the evaluation batch (``chip_smoke.device_ms``,
cold L2) and by the host loop of wrapper calls (``chip_smoke.time_ms``),
then runs one unprofiled and one profiled round and evaluation of the
main path, on the same learner.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# First match wins: cuDNN's convolution kernels are xmma/cutlass GEMMs too.
FAMILIES = (
    ("flash_attention", ("fa::flash_fwd", "fa::flash_dq", "fa::flash_dkv")),
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit_gemm",
              "nchwtonhwc", "nhwctonchw")),
    ("matmul", ("gemm", "cutlass", "sm90_xmma", "nvjet", "cublas")),
    ("optimizer_foreach", ("multi_tensor_apply", "foreach")),
    ("norm_pool_elementwise", ("elementwise", "reduce", "pool", "norm",
                               "catarray", "index")),
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


def profile_main_path(learner) -> dict:
    """Unprofiled wall seconds of one round and one evaluation, then the
    profiled summary of each."""
    out = {}
    # The profiler's own host overhead inflates wall time and idle share;
    # an unprofiled round and evaluation give the figures to read them
    # against.
    for phase, fn in (("round", learner.run_round),
                      ("evaluate", learner.evaluate)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[f"{phase}_unprofiled_s"] = time.perf_counter() - t0
        print(json.dumps({"phase": f"{phase}_unprofiled",
                          "wall_s": out[f"{phase}_unprofiled_s"]}),
              flush=True)
    for phase, fn in (("round", learner.run_round),
                      ("evaluate", learner.evaluate)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[phase] = summarize(prof, wall, phase)
    return out


def kernel_times(A) -> tuple[dict, dict]:
    """K1-K3 device us at the training shapes and K1's at B=64; the
    wrapper-loop us of K1-K3 at the training shapes."""
    from chip_smoke import device_ms, input_sets, padding_mask, time_ms

    B, L, H, D = 16, 128, 12, 64
    sets = input_sets(A, B, L, H, D, padding_mask(B, L, 1), 21)
    calls = {
        "flash_forward": lambda s: A.flash_forward(s.q, s.k, s.v, s.bias),
        "flash_backward_dq": lambda s: A.flash_backward_dq(
            s.q, s.k, s.v, s.bias, s.dout, s.lse, s.delta),
        "flash_backward_dkv": lambda s: A.flash_backward_dkv(
            s.q, s.k, s.v, s.bias, s.dout, s.lse, s.delta),
    }
    device, wrapper = {}, {}
    for name, fn in calls.items():
        device[name] = 1e3 * device_ms(fn, sets)
        wrapper[name] = 1e3 * time_ms(lambda: fn(sets[0]))
    del sets
    sets = input_sets(A, 64, L, H, D, padding_mask(64, L, 5), 22)
    device["flash_forward_b64"] = 1e3 * device_ms(calls["flash_forward"],
                                                  sets)
    return device, wrapper


def compare(parent_csrc: str) -> None:
    from chip_smoke import main_path_config
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner
    from colearn_federated_learning_tpu_torch.ops import _build
    from colearn_federated_learning_tpu_torch.ops import attention as A

    libs = {"parent": _build.load("flash_attention", parent_csrc),
            "tree": _build.load("flash_attention")}
    learner = FederatedLearner(main_path_config())
    learner.run_round()                                  # warm-up
    learner.evaluate()
    for turn, name in enumerate(("parent", "tree", "tree", "parent")):
        A.use_library(libs[name])
        device, wrapper = kernel_times(A)
        print(json.dumps({"turn": turn, "build": name, "device_us": device,
                          "wrapper_loop_us": wrapper}), flush=True)
        e2e = profile_main_path(learner)
        print(json.dumps({
            "turn": turn, "build": name,
            "round_unprofiled_s": e2e["round_unprofiled_s"],
            "evaluate_unprofiled_s": e2e["evaluate_unprofiled_s"],
            "round_device_busy_s": e2e["round"]["device_busy_s"],
            "evaluate_device_busy_s": e2e["evaluate"]["device_busy_s"],
            "flash_round_s": e2e["round"]["device_s_by_family"].get(
                "flash_attention", 0.0),
            "flash_evaluate_s": e2e["evaluate"]["device_s_by_family"].get(
                "flash_attention", 0.0)}), flush=True)
    A.use_library(None)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent-csrc", default=None,
                        help="compare with the kernels built from this "
                             "csrc/ directory, in turns")
    parser.add_argument("--config", default=None,
                        help="a registry config to profile as it is "
                             "(default: chip_smoke's BERT path)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_profile: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card

    print(card(), flush=True)
    if args.parent_csrc:
        compare(args.parent_csrc)
        return 0
    from chip_smoke import main_path_config
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    cfg = get_config(args.config) if args.config else main_path_config()
    learner = FederatedLearner(cfg)
    print(json.dumps({"config": cfg.run.name, "clients": learner.num_clients,
                      "cohort": learner.cohort_size,
                      "steps": learner.num_steps}), flush=True)
    learner.run_round()                                  # warm-up
    learner.evaluate()
    profile_main_path(learner)
    return 0


if __name__ == "__main__":
    sys.exit(main())
