#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is caught):

1. the card's name and power limit, torch and CUDA versions;
2. build the CUDA kernels from ``colearn_federated_learning_tpu_torch/csrc``;
   print each head-dim-64 kernel's registers, spills and blocks per SM,
   and fail if any instantiation spills;
3. each flash-attention kernel (K1 forward, K2 dQ, K3 dK/dV) against its
   plain PyTorch version in bf16 — at the BERT-base training shapes and
   the evaluation batch of 64 with a realistic padding mask, a ragged
   L=100, a causal case and a case with a fully masked row — then its
   device time at the training shapes (and K1's at the evaluation batch)
   beside the plain version's, its bound, and torch's SDPA as a yardstick;
   the same at ViT-B/16's shape (16, 50, 12, 64) with no key mask, and
   K1's at ViT's evaluation batch (64, 50, 12, 64).
   Device time is that of calls captured in a CUDA graph and replayed back
   to back, over input sets that together exceed twice the 50 MB L2 cache,
   so each call reads its inputs from HBM as the bound assumes; the host
   loop of wrapper calls on one warm set is reported beside it as
   ``wrapper_ms``, and the graph's own cost per call as its floor;
4. a small-input check (flash vs dense cores of a small BERT on the card),
   then the BERT path: ``FederatedLearner`` on ``agnews_bert_fedavg`` with
   ``attn_impl="flash"`` and 4 local steps (full BERT-base width and
   depth, cohort 10, batch 16, seq 128, bf16) for 2 rounds and an
   evaluation, with the kernels' launch counts read around it;
5. this slice's path: ``cifar10_cnn_fedavg`` (BASELINE config #2) as it
   is — the width-64 CNN in bf16, 100 Dirichlet clients, cohort 20,
   batch 32, its own 34-step budget — for 2 rounds and an evaluation;
6. one round and one evaluation of each other family at full width, each
   cut listed in its line: config #1 (MLP), config #3 (ResNet-18,
   FedProx), ``iot_traffic_tcn_fedavg`` (TCN), config #5 (ViT-B/16 with
   ``attn_impl="flash"``, cohort cut to 32) and MoE-BERT (BERT-base width,
   4 experts, flash, cohort 4, 2 local steps).  Every path resets the
   launch counts before it and checks them after: depth × (steps +
   evaluation batches) for K1 and depth × steps for K2 and K3 on a flash
   path, none elsewhere;
7. the federated round's other branches through the port's command line
   (``cli.main``) at full width: 7a SCAFFOLD on config #2 (2 rounds; the
   server variate moves and exactly the contributors' variate rows
   change), 7b FedNova on config #2 with stragglers (the clients' step
   counts, and so their a_i, differ), 7c DP with adaptive clipping and
   secure aggregation on BERT-base (2 rounds; the clip moves, ε equals
   the JAX accountant's value for 7c's q, z and δ, which a CPU test ties
   to JAX; no update norm in the record) and 7c' its round
   0 without the masks (the params agree to 1e-5: the masks cancel on the
   card), 7d Krum on BERT-base (8 of 10 kept), 7e ring masks of degree 4
   with DP on config #2 — each with exact launch counts, its seconds per
   round, evaluation seconds and peak memory;
8. the hierarchical and clustered learners and per-client evaluation at
   full width: 8a ``train --edge-groups 2 --edge-sync-period 2 --rounds
   3`` on BERT-base through ``cli.main`` (2 groups of 25 clients, cohort
   10 each; after every sync each group holds the cloud model bit for
   bit, the cloud model is the float64 example-weighted mean of the
   groups' to 1e-6 of its largest entry, the groups part after round 0,
   and the launches are exact over the groups' rounds and the two cloud
   evaluations); 8b ``ClusteredLearner`` on config #2 with a second
   concept planted on clients 50-99 (y -> 9 - y): 2 warm-up rounds, the
   (100, 100) update similarity after 3 steps (symmetric to 1e-5, unit
   diagonal to 1e-4), k-means into two clusters that partition the
   clients, one round of each cluster and their per-client report (the
   labels' agreement with the planted concept is printed, not gated);
   8c ``train --per-client-eval`` on BERT-base for one round, the report
   finite and K1's launches exact with the per-client chunks;
9. the server's fold kernel (B4, ``csrc/fold.cu``) and the file plane:
   9a the kernel against its plain version BIT FOR BIT (int32 views) at
   BERT-base's slot layout (198 slots, 108.6 M float32 entries): 10
   topk8 and 10 topk contributions at 5 % density drawn from a seed,
   folded from zeros and onto an accumulator, one contribution alone,
   10 dense contributions, and a -0.0 that must survive; then its device
   time per launch (CUDA-graph replay), the staging copy's, the plain
   version's, ``index_add_``'s (the yardstick the port never calls) and
   the bytes bound, counting the 32-byte sectors a scatter touches; 9b
   ``init``, 4 silos of ``train --role client --compress topk8``,
   ``aggregate`` and ``eval`` on BERT-base (flash, 4 local steps)
   through ``cli.main``, then the 4 update files through
   ``StreamingFolder(device_fold=True)``, flat and as a two-aggregator
   tree, each bitwise equal to its host fold, the mean within 1e-6 of
   ``aggregate``'s mean delta and the new global model the old plus it,
   with K1-K3's and the fold's launches exact; 9c ``bench`` with its
   defaults, its JSON line printed;
10. one JSON line of per-kernel results (launches summed over the paths),
   then the result line.

Needs a CUDA device and the repository beside it; it exits non-zero and
prints no result otherwise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
L2_BYTES = 50e6                # H100 L2 cache
BF16_TOL = 2e-2                # kernel vs plain, of the largest |plain|
BF16_ULP = 2.0 ** -8           # one bf16 step at the largest magnitude
KERNELS = {
    "flash_forward": ("colearn_federated_learning_tpu/ops/attention.py:85",
                      4),
    "flash_backward_dq": (
        "colearn_federated_learning_tpu/ops/attention.py:215", 6),
    "flash_backward_dkv": (
        "colearn_federated_learning_tpu/ops/attention.py:259", 8),
}
SOURCE = "colearn_federated_learning_tpu_torch/csrc/flash_attention_kernels.cuh"
VIT_L = 50                     # ViT-B/16 on 28 x 28 FEMNIST: 7 x 7 patches + cls


def log(*args):
    print(*args, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def fresh_peak() -> None:
    """Free what earlier paths left unreachable (a learner held only in a
    reference cycle, such as a wrapped method, waits for the collector)
    and restart the peak-memory count, so a path's peak is its own."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def time_ms(fn, iters: int = 50) -> float:
    """Mean time of ``fn`` over ``iters`` calls in a host loop, after
    warm-up, by events around the loop: the wrapper's host cost where it
    exceeds the kernel's, on inputs that stay in L2."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, sets, passes: int = 4, replays: int = 5) -> float:
    """Mean device time of one call ``fn(s)``: ``passes`` passes through
    ``sets`` captured in one CUDA graph, whose replays are timed by events,
    so the host's cost of a call is not counted and the card runs the
    calls back to back.  Where the sets together exceed the L2 cache
    (``input_sets``), every call finds its inputs in HBM."""
    for s in sets:
        fn(s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # "relaxed": a build that sets a kernel attribute at each launch is
    # still capturable.
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(passes):
            for s in sets:
                fn(s)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * passes * len(sets))


def input_sets(A, B, L, H, D, mask, seed):
    """Input sets of the kernels at one shape, enough of them that together
    they exceed twice the L2 cache: q, k, v, dO and the key bias, the lse
    and Δ of the forward kernel, and SDPA's (B, H, L, D) copies."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    n = max(5, math.ceil(2 * L2_BYTES / bound_bytes("flash_forward",
                                                     B, L, H, D)))
    sets = []
    for _ in range(n):
        q, k, v, dout = (torch.randn(B, L, H, D, generator=g)
                         .to(torch.bfloat16).to(dev) for _ in range(4))
        bias = A.key_bias(mask.to(dev), B, L, dev)
        o, lse = A.flash_forward(q, k, v, bias)
        delta = (dout.float() * o.float()).sum(-1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sets.append(SimpleNamespace(
            q=q, k=k, v=v, dout=dout, bias=bias, lse=lse, delta=delta,
            qt=qt, kt=kt, vt=vt,
            amask=None if mask.all() else mask.to(dev)[:, None, None, :]))
    return sets


def padding_mask(B: int, L: int, seed: int) -> torch.Tensor:
    """Token-id padding of the synthetic AG-News corpus (id 0 = pad)."""
    from colearn_federated_learning_tpu_torch.data import synthetic

    ids, _ = synthetic.synthetic_text_classification(B, L, 30522, 4, seed=seed)
    return torch.from_numpy(ids != 0)


def check_close(what, got, ref, truth):
    """Hold a bf16 kernel output to its bf16 plain version ``ref`` and to
    the f32 ``truth``: the kernel must lie within BF16_TOL of ``ref``
    (scaled by its largest magnitude), and its error against ``truth`` must
    stay within twice the plain version's error plus one bf16 step at the
    largest magnitude.  Returns the max abs error against ``ref``."""
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    top = float(truth.abs().max())
    err = float((got - ref).abs().max())
    bound = BF16_TOL * float(ref.abs().max())
    err_truth = float((got - truth).abs().max())
    bound_truth = 2.0 * float((ref - truth).abs().max()) + BF16_ULP * top
    if err > bound or err_truth > bound_truth:
        raise AssertionError(
            f"{what}: max abs err {err} (bound {bound}), against f32 "
            f"{err_truth} (bound {bound_truth})")
    return err


def kernel_case(A, name, B, L, H, D, causal, mask, seed):
    """Run K1-K3 and their plain versions on one input; return the max abs
    error of each kernel against its plain version after checking it."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(B, L, H, D, generator=g)
                     .to(torch.bfloat16).to(dev) for _ in range(4))
    bias = A.key_bias(mask.to(dev), B, L, dev)
    o_ref, lse_ref = A.flash_forward_reference(q, k, v, bias, causal)
    o, lse = A.flash_forward(q, k, v, bias, causal)
    delta = (dout.float() * o_ref.float()).sum(-1)
    dq = A.flash_backward_dq(q, k, v, bias, dout, lse_ref, delta, causal)
    dq_ref = A.flash_backward_dq_reference(q, k, v, bias, dout, lse_ref,
                                           delta, causal)
    dk, dv = A.flash_backward_dkv(q, k, v, bias, dout, lse_ref, delta, causal)
    dk_ref, dv_ref = A.flash_backward_dkv_reference(q, k, v, bias, dout,
                                                    lse_ref, delta, causal)
    # The same functions on the same values in f32, rounding nowhere.
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    o_f32, _ = A.flash_forward_reference(qf, kf, vf, bias, causal)
    dq_f32 = A.flash_backward_dq_reference(qf, kf, vf, bias, dof, lse_ref,
                                           delta, causal)
    dk_f32, dv_f32 = A.flash_backward_dkv_reference(qf, kf, vf, bias, dof,
                                                    lse_ref, delta, causal)
    torch.cuda.synchronize()
    if not torch.equal(lse >= 1e29, lse_ref >= 1e29):
        raise AssertionError(f"{name}: fully masked rows differ")
    fin = lse_ref < 1e29
    lse_err = float((lse[fin] - lse_ref[fin]).abs().max()) if fin.any() else 0.0
    if lse_err > 1e-3:
        raise AssertionError(f"{name}: lse max abs err {lse_err}")
    errs = {
        "flash_forward": check_close(f"{name}/O", o, o_ref, o_f32),
        "flash_backward_dq": check_close(f"{name}/dQ", dq, dq_ref, dq_f32),
        "flash_backward_dkv": max(
            check_close(f"{name}/dK", dk, dk_ref, dk_f32),
            check_close(f"{name}/dV", dv, dv_ref, dv_f32)),
    }
    if not bool(mask.any(dim=1).all()):
        rows = ~mask.any(dim=1)
        if float(o[rows.to(dev)].float().abs().max()) != 0.0:
            raise AssertionError(f"{name}: fully masked rows are not 0")
    log(f"  case {name:10s} B={B} L={L} H={H} D={D} causal={causal}: "
        + ", ".join(f"{k} err {e:.3e}" for k, e in errs.items())
        + f", lse err {lse_err:.2e} (bounds: {BF16_TOL} x max|plain|; "
        f"2 x plain's err + {BF16_ULP} x max|f32| against f32)")
    return errs


def bound_bytes(kname, B, L, H, D) -> int:
    """Bytes the function must move: each input read once, each output
    written once."""
    act, bias, rowf = B * L * H * D * 2, B * L * 4, B * L * H * 4
    return {
        "flash_forward": 3 * act + bias + act + rowf,
        "flash_backward_dq": 4 * act + bias + 2 * rowf + act,
        "flash_backward_dkv": 4 * act + bias + 2 * rowf + 2 * act,
    }[kname]


def bound_ms(kname, B, L, H, D) -> tuple[float, str]:
    """Least time for the same work: its bytes over HBM bandwidth, or the
    products at the bf16 peak."""
    flops = KERNELS[kname][1] * B * H * L * L * D
    t_bytes = bound_bytes(kname, B, L, H, D) / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_phase(A):
    from torch.nn import functional as F

    B, L, H, D = 16, 128, 12, 64
    errs = {k: 0.0 for k in KERNELS}
    cases = [
        ("slice", B, L, H, D, False, padding_mask(B, L, 1), 11),
        ("eval", 64, L, H, D, False, padding_mask(64, L, 5), 15),
        ("ragged", B, 100, H, D, False, padding_mask(B, 100, 2), 12),
        ("causal", 4, L, H, D, True, padding_mask(4, L, 3), 13),
    ]
    row_mask = padding_mask(4, L, 4)
    row_mask[1] = False
    cases.append(("masked_row", 4, L, H, D, False, row_mask, 14))
    # ViT-B/16 on FEMNIST: 49 patches + the class token, no key mask, at
    # the training batch and the evaluation batch.
    cases.append(("vit", B, VIT_L, H, D, False,
                  torch.ones(B, VIT_L, dtype=torch.bool), 16))
    cases.append(("vit_eval", 64, VIT_L, H, D, False,
                  torch.ones(64, VIT_L, dtype=torch.bool), 17))
    for case in cases:
        e = kernel_case(A, *case)
        errs = {k: max(errs[k], e[k]) for k in errs}

    rows = time_kernels(A, B, L, H, D, cases[0][6], errs)
    eval_forward(A, "BERT", 64, L, H, D, cases[1][6])
    log(f"  at the ViT shape ({B}, {VIT_L}, {H}, {D}), no key mask:")
    vit = time_kernels(A, B, VIT_L, H, D, cases[-2][6], errs)
    log("  vit shape rows " + json.dumps(vit))
    eval_forward(A, "ViT", 64, VIT_L, H, D, cases[-1][6])
    return rows


def eval_forward(A, label, B, L, H, D, mask):
    """Device time of K1 at an evaluation batch beside its bound and SDPA."""
    from torch.nn import functional as F

    sets = input_sets(A, B, L, H, D, mask, 22)
    bms, bby = bound_ms("flash_forward", B, L, H, D)
    k1 = device_ms(lambda s: A.flash_forward(s.q, s.k, s.v, s.bias), sets)
    sdpa = device_ms(lambda s: F.scaled_dot_product_attention(
        s.qt, s.kt, s.vt, attn_mask=s.amask), sets)
    log(f"  flash_forward at the {label} evaluation batch ({B}, {L}, {H}, "
        f"{D}): {k1 * 1e3:.2f} us device ({bms / k1:.1%} of bound "
        f"{bms * 1e3:.2f} us, {bby}); sdpa {sdpa * 1e3:.2f} us")


def time_kernels(A, B, L, H, D, mask, errs):
    """Device time of K1-K3 at one shape beside their plain versions, the
    bound and SDPA; returns the per-kernel rows."""
    from torch.nn import functional as F

    sets = input_sets(A, B, L, H, D, mask, 21)
    fns = {
        "flash_forward": (
            lambda s: A.flash_forward(s.q, s.k, s.v, s.bias),
            lambda s: A.flash_forward_reference(s.q, s.k, s.v, s.bias),
            lambda s: F.scaled_dot_product_attention(s.qt, s.kt, s.vt,
                                                     attn_mask=s.amask)),
        "flash_backward_dq": (
            lambda s: A.flash_backward_dq(s.q, s.k, s.v, s.bias, s.dout,
                                          s.lse, s.delta),
            lambda s: A.flash_backward_dq_reference(
                s.q, s.k, s.v, s.bias, s.dout, s.lse, s.delta), None),
        "flash_backward_dkv": (
            lambda s: A.flash_backward_dkv(s.q, s.k, s.v, s.bias, s.dout,
                                           s.lse, s.delta),
            lambda s: A.flash_backward_dkv_reference(
                s.q, s.k, s.v, s.bias, s.dout, s.lse, s.delta), None),
    }
    tiny = torch.zeros(1, device="cuda")
    log(f"  device times over {len(sets)} input sets of "
        f"{bound_bytes('flash_forward', B, L, H, D) / 1e6:.1f}+ MB each; "
        "graph floor per call (one 1-element add) "
        f"{device_ms(lambda s: tiny.add_(1), sets) * 1e3:.2f} us")
    rows = {}
    for kname, (kern, plain, lib) in fns.items():
        bms, bby = bound_ms(kname, B, L, H, D)
        rows[kname] = {
            "ms": device_ms(kern, sets),
            "wrapper_ms": time_ms(lambda: kern(sets[0])),
            "plain_ms": device_ms(plain, sets),
            "library_ms": device_ms(lib, sets) if lib is not None else None,
            "bound_ms": bms, "bound_by": bby, "max_abs_err": errs[kname],
        }
        r = rows[kname]
        warm = device_ms(kern, sets[:1])
        log(f"  {kname:19s} {r['ms'] * 1e3:8.2f} us device "
            f"({bms / r['ms']:.1%} of bound {bms * 1e3:.2f} us, {bby}); "
            f"{warm * 1e3:.2f} us on one set left in L2; "
            f"wrapper loop {r['wrapper_ms'] * 1e3:.2f} us; plain "
            f"{r['plain_ms'] * 1e3:.2f} us; sdpa "
            + (f"{r['library_ms'] * 1e3:.2f} us" if lib is not None
               else "none"))
    # Yardstick only: SDPA's backward computes dQ, dK and dV in one call.
    # It is captured with its forward (autograd runs a backward on its
    # forward's stream), whose time is then taken off.
    for s in sets:
        s.ins = [t.clone().requires_grad_(True) for t in (s.qt, s.kt, s.vt)]
        s.dot = s.dout.transpose(1, 2).contiguous()
    sdpa_fb = device_ms(lambda s: torch.autograd.grad(
        F.scaled_dot_product_attention(*s.ins, attn_mask=s.amask), s.ins,
        s.dot), sets)
    sdpa_bwd = sdpa_fb - rows["flash_forward"]["library_ms"]
    ours = rows["flash_backward_dq"]["ms"] + rows["flash_backward_dkv"]["ms"]
    log(f"  sdpa backward (dQ, dK, dV together): {sdpa_bwd * 1e3:.2f} us "
        f"device; flash_backward_dq + flash_backward_dkv {ours * 1e3:.2f} us")
    return rows


def small_model_check():
    """Flash and dense cores of one small BERT agree on the card."""
    from colearn_federated_learning_tpu_torch.models import registry
    from colearn_federated_learning_tpu_torch.utils import prng
    from colearn_federated_learning_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig(name="bert", num_classes=4, width=128, depth=2,
                      num_heads=2, seq_len=64, vocab_size=1000,
                      dtype="bfloat16")
    dense = registry.build_model(cfg, "cuda", generator=prng.init_generator(0))
    flash = registry.build_model(dataclasses.replace(cfg, attn_impl="flash"),
                                 "cuda")
    flash.load_state_dict(dense.state_dict())
    ids = torch.randint(1, 1000, (8, 64), generator=torch.Generator()
                        .manual_seed(5))
    ids[:, 40:] = 0
    ids[3] = 0                       # an all-padding example
    ids = ids.cuda()
    with torch.no_grad():
        ld, lf = dense(ids), flash(ids)
    err = float((ld - lf).abs().max())
    bound = 5e-2 * max(1.0, float(ld.abs().max()))
    if not (torch.isfinite(lf).all() and err <= bound):
        raise AssertionError(f"small BERT flash vs dense: {err} > {bound}")
    log(f"  small BERT logits, flash vs dense core: max abs err {err:.3e} "
        f"(bound {bound:.3e})")


def main_path_config():
    """BASELINE config #4 (BERT-base on AG-News, FedAvg) with the flash
    attention core, cut to 4 local steps per client."""
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    base = get_config("agnews_bert_fedavg")
    return base.replace(
        model=dataclasses.replace(base.model, attn_impl="flash"),
        fed=dataclasses.replace(base.fed, local_steps=4))


def main_path(A):
    """The BERT path (``main_path_config``): 2 rounds and an evaluation."""
    return drive_path(A, "bert", main_path_config(), 2, "local_steps 4")


def drive_path(A, label, cfg, rounds, cuts):
    """Build ``FederatedLearner(cfg)`` on the card, run ``rounds`` rounds
    and one evaluation, check that the output is finite, that every
    sampled client completed and that the params moved, and that the
    flash kernels launched exactly depth × (steps + evaluation batches)
    (K1) and depth × steps (K2, K3) times on a flash path, and never
    elsewhere.  Returns the launch counts."""
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner

    t_path = time.perf_counter()
    t0 = time.perf_counter()
    learner = FederatedLearner(cfg)
    n_params = sum(p.numel() for p in learner.params.values())
    width = cfg.model.hidden_dim if cfg.model.name == "mlp" else cfg.model.width
    log(f"  [{label}] {cfg.run.name}: {cfg.model.name} width {width} "
        f"{cfg.model.dtype}, {n_params / 1e6:.2f} M params; "
        f"{learner.num_clients} clients, cohort {learner.cohort_size}, "
        f"{learner.num_steps} steps x batch {cfg.fed.batch_size}; cuts: "
        f"{cuts}; built in {time.perf_counter() - t0:.2f} s")
    before = [p.clone() for p in learner.params.values()]
    fresh_peak()
    A.reset_launches()
    round_s = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        rec = learner.run_round()
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        log(f"  [{label}] round {rec['round']}: train_loss "
            f"{rec['train_loss']:.6f} completed {rec['completed']:.0f} "
            f"delta_norm_mean {rec['delta_norm_mean']:.6f} "
            f"in {round_s[-1]:.3f} s")
        if not (math.isfinite(rec["train_loss"])
                and math.isfinite(rec["delta_norm_mean"])
                and rec["completed"] == learner.cohort_size):
            raise AssertionError(f"{label}: bad round record {rec}")
    t0 = time.perf_counter()
    eval_loss, eval_acc = learner.evaluate()
    eval_s = time.perf_counter() - t0
    launches = dict(A.launches)
    changed = sum(float((p - b).abs().sum())
                  for p, b in zip(learner.params.values(), before))
    finite = all(bool(torch.isfinite(p).all())
                 for p in learner.params.values())
    log(f"  [{label}] evaluate: loss {eval_loss:.6f} acc {eval_acc:.4f} in "
        f"{eval_s:.3f} s; launches {launches}; params moved (sum |diff|) "
        f"{changed:.6e}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if not (finite and math.isfinite(eval_loss) and 0.0 <= eval_acc <= 1.0
            and changed > 0):
        raise AssertionError(f"{label}: output is not finite or did not train")
    flash = cfg.model.attn_impl == "flash"
    steps = rounds * learner.cohort_size * learner.num_steps
    eval_batches = math.ceil(len(learner.dataset.x_test)
                             / max(cfg.fed.batch_size, 64))
    depth = cfg.model.depth if flash else 0
    want = {"flash_forward": depth * (steps + eval_batches),
            "flash_backward_dq": depth * steps,
            "flash_backward_dkv": depth * steps}
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, "
                             f"expected {want}")
    log(f"  [{label}] seconds per round: {round_s}; path "
        f"{time.perf_counter() - t_path:.2f} s")
    return launches


def family_paths():
    """(label, config, cuts) of one round of each other family."""
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    vit = get_config("femnist_vit_cross_silo")
    moe = get_config("agnews_bert_fedavg")
    return [
        ("mlp", get_config("mnist_mlp_fedavg"), "none"),
        ("resnet18", get_config("cifar100_resnet18_fedprox"), "none"),
        ("tcn", get_config("iot_traffic_tcn_fedavg"), "none"),
        ("vit", vit.replace(
            model=dataclasses.replace(vit.model, attn_impl="flash"),
            fed=dataclasses.replace(vit.fed, cohort_size=32)),
         "cohort_size 256 -> 32"),
        ("moe_bert", moe.replace(
            model=dataclasses.replace(moe.model, name="moe_bert",
                                      num_experts=4, attn_impl="flash"),
            fed=dataclasses.replace(moe.fed, cohort_size=4, local_steps=2),
            run=dataclasses.replace(moe.run, name="moe_bert_agnews")),
         "cohort_size 10 -> 4, local_steps 150 -> 2"),
    ]


# ε of 7c's 2 rounds (q = cohort 10 of 50 clients, z = 1.0, δ = 1e-5) by
# the JAX package's RDP accountant; tests/test_torch_port_guards.py holds
# this constant to it.  The relative tolerance allows for another numpy.
EPS_7C = 4.1187131819595315
EPS_RTOL = 1e-9
BERT_DP = ["--config", "agnews_bert_fedavg", "--attn-impl", "flash",
           "--local-steps", "4", "--dp-clip", "1.0",
           "--dp-noise-multiplier", "1.0", "--dp-adaptive-clip"]


def cli_path(A, label, argv, watch=None, extra_batches=None):
    """Run ``cli.main(["train", *argv])`` on the card, with the kernels'
    launch counts and the peak memory reset once the learner is built;
    ``watch(learner, record)`` sees the learner before the first round
    (record None) and after each round.  Checks that every round's loss
    and the params are finite and that the flash kernels launched exactly
    depth × (steps run + evaluation batches) (K1) and depth × steps (K2,
    K3) on a flash path, and never elsewhere; ``extra_batches(learner)``
    counts forward batches beyond those (a per-client evaluation's).
    Returns (records, launches, learner)."""
    from colearn_federated_learning_tpu_torch import cli

    state = {"records": [], "steps": 0}

    def on_round(learner, rec):
        if rec is None:
            state["learner"] = learner
            fresh_peak()
            A.reset_launches()
        else:
            state["records"].append(rec)
            state["steps"] += int(learner.last_cohort["steps_run"].sum())
            extra = {k: rec[k] for k in ("dp_clip", "dp_bit_frac",
                                         "dp_epsilon", "eval_acc")
                     if k in rec}
            log(f"  [{label}] round {rec['round']}: train_loss "
                f"{rec['train_loss']:.6f} completed {rec['completed']:.0f}; "
                + json.dumps(extra))
        if watch is not None:
            watch(learner, rec)

    t0 = time.perf_counter()
    log(f"  [{label}] train " + " ".join(argv))
    cli.main(["train", *argv], on_round=on_round)
    torch.cuda.synchronize()
    launches = dict(A.launches)
    learner, records = state["learner"], state["records"]
    cfg = learner.config
    finite = all(bool(torch.isfinite(p).all())
                 for p in learner.params.values())
    if not (finite and records
            and all(math.isfinite(r["train_loss"]) for r in records)):
        raise AssertionError(f"{label}: output is not finite")
    evals = sum("eval_loss" in r for r in records)
    eval_batches = math.ceil(len(learner.dataset.x_test)
                             / max(cfg.fed.batch_size, 64))
    depth = cfg.model.depth if cfg.model.attn_impl == "flash" else 0
    extra = extra_batches(learner) if extra_batches is not None else 0
    want = {"flash_forward": depth * (state["steps"] + evals * eval_batches
                                      + extra),
            "flash_backward_dq": depth * state["steps"],
            "flash_backward_dkv": depth * state["steps"]}
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, "
                             f"expected {want}")
    log(f"  [{label}] s/round "
        f"{[round(r['phase_update_s'], 3) for r in records]}; eval s "
        f"{[round(r['phase_eval_s'], 3) for r in records if 'eval_loss' in r]}"
        f"; peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
        f"launches {launches} (exact); path "
        f"{time.perf_counter() - t0:.2f} s; {card()}")
    return records, launches, learner


def scaffold_path(A):
    """7a: the server variate moves in round 0 and exactly the
    contributors' rows of the variate store change."""
    seen = {}

    def watch(learner, rec):
        if rec is None:
            seen["rows"] = [r.clone() for r in learner.variates.rows]
        elif rec["round"] == 0:
            cohort = learner.last_cohort
            want = set(cohort["clients"][cohort["contributed"]].tolist())
            changed = set()
            for old, new in zip(seen["rows"], learner.variates.rows):
                diff = (old != new).reshape(len(old), -1).any(dim=1)
                changed |= set(torch.nonzero(diff).flatten().tolist())
            c_norm = math.sqrt(sum(float(c.float().square().sum()) for c in
                                   learner.server_state.control.values()))
            log(f"  [7a] after round 0: |c| = {c_norm:.6e}; variate rows "
                f"changed {len(changed)}, contributors {len(want)}")
            if not (c_norm > 0 and changed == want):
                raise AssertionError(f"7a: |c| {c_norm}, rows changed "
                                     f"{sorted(changed)} != {sorted(want)}")
            del seen["rows"]

    return cli_path(A, "7a", ["--config", "cifar10_cnn_fedavg", "--strategy",
                              "scaffold", "--momentum", "0", "--rounds", "2"],
                    watch)[1]


def fednova_path(A):
    """7b: under stragglers the clients' executed steps, and so their
    a_i, differ."""
    def watch(learner, rec):
        if rec is None:
            return
        cohort = learner.last_cohort
        log(f"  [7b] steps run {cohort['steps_run'].astype(int).tolist()}; "
            f"a_i {[round(float(a), 4) for a in cohort['nova_a']]}")
        if len(set(cohort["nova_a"].tolist())) < 2:
            raise AssertionError("7b: every client's a_i is the same")

    return cli_path(A, "7b", ["--config", "cifar10_cnn_fedavg", "--strategy",
                              "fednova", "--straggler-prob", "0.5",
                              "--rounds", "1"], watch)[1]


def private_paths(A):
    """7c: DP with adaptive clipping and secure aggregation on BERT-base,
    and 7c': its round 0 without the masks, whose params must agree with
    7c's to 1e-5 (the masks cancel on the card)."""
    snap = {}

    def watch(learner, rec):
        if rec is not None and rec["round"] == 0:
            snap["params"] = [p.clone() for p in learner.params.values()]

    records, launches, learner = cli_path(
        A, "7c", BERT_DP + ["--rounds", "2", "--secure-agg"], watch)
    leaked = [k for r in records for k in r if k.startswith("delta_norm")]
    eps = records[-1]["dp_epsilon"]
    log(f"  [7c] dp_clip {records[0]['dp_clip']:.6f} after round 0 (from "
        f"1.0); dp_epsilon {eps!r}, the JAX accountant's {EPS_7C!r} (q = "
        f"10/50, z = 1.0, delta 1e-5, 2 rounds; rel tol {EPS_RTOL})")
    if not (records[0]["dp_clip"] != 1.0 and not leaked
            and abs(eps - EPS_7C) <= EPS_RTOL * EPS_7C):
        raise AssertionError(f"7c: clip {records[0]['dp_clip']}, epsilon "
                             f"{eps}, keys {leaked}")
    del learner
    _, launches2, plain = cli_path(A, "7c'", BERT_DP + ["--rounds", "1"])
    err = max(float((p - q).abs().max())
              for p, q in zip(plain.params.values(), snap["params"]))
    log(f"  [7c'] params after round 0, masked vs unmasked: max abs diff "
        f"{err:.3e} (bound 1e-5)")
    if not err <= 1e-5:
        raise AssertionError(f"7c': masks did not cancel: {err}")
    return launches, launches2


def krum_path(A):
    """7d: Krum on BERT-base keeps n − f = 8 of the 10 clients."""
    records, launches, learner = cli_path(
        A, "7d", ["--config", "agnews_bert_fedavg", "--attn-impl", "flash",
                  "--local-steps", "4", "--rounds", "1", "--aggregator",
                  "krum", "--trim-fraction", "0.2"])
    chosen = learner.last_cohort["selected"]
    log(f"  [7d] Krum kept {len(chosen)} of {learner.cohort_size}: "
        f"{sorted(chosen.tolist())}")
    if len(chosen) != 8:
        raise AssertionError(f"7d: Krum kept {len(chosen)}, expected 8")
    return launches


def ring_path(A):
    """7e: ring masks of degree 4 with DP on config #2."""
    records, launches, learner = cli_path(
        A, "7e", ["--config", "cifar10_cnn_fedavg", "--secure-agg",
                  "--secure-agg-neighbors", "4", "--dp-clip", "0.5",
                  "--dp-noise-multiplier", "0.5", "--rounds", "1"])
    cohort = learner.last_cohort
    table = cohort["partners"]
    ok = all(len(set(row.tolist())) == 4 and cid not in row
             for cid, row in zip(cohort["clients"], table))
    log(f"  [7e] partner table {table.shape}, 4 distinct partners each: {ok}")
    if not (ok and table.shape == (learner.cohort_size, 4)):
        raise AssertionError(f"7e: partner table {table}")
    return launches


def cli_phase(A):
    """Phase 7: the round's other branches through the command line."""
    paths = {}
    for label, fn in (("scaffold", scaffold_path), ("fednova", fednova_path),
                      ("krum", krum_path), ("ring_dp", ring_path)):
        t0 = time.perf_counter()
        paths[label] = fn(A)
        log(f"  {label} in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    paths["dp_secure_agg"], paths["dp"] = private_paths(A)
    log(f"  dp_secure_agg and dp in {time.perf_counter() - t0:.2f} s")
    return paths


HIER = ["--config", "agnews_bert_fedavg", "--attn-impl", "flash",
        "--local-steps", "4", "--edge-groups", "2", "--edge-sync-period", "2",
        "--rounds", "3"]
SYNC_RTOL = 1e-6               # cloud model vs its float64 recomputation


def hierarchical_path(A):
    """8a: hierarchical BERT-base through ``cli.main``.  Each cloud sync
    is checked as it happens: the cloud model against the float64
    example-weighted mean of the groups' params (to ``SYNC_RTOL`` of each
    tensor's largest entry), and every group against the cloud model bit
    for bit.  After round 0 (no sync) the groups' params differ.  The
    flash kernels' launches are exact over both groups' rounds and the
    cloud evaluations."""
    from colearn_federated_learning_tpu_torch import cli

    state = {"steps": 0, "syncs": [], "eval_s": [], "round_s": [],
             "check_s": 0.0}

    def checked_sync(h, sync):
        def run():
            t0 = time.perf_counter()
            before = [[p.clone() for p in g.params.values()]
                      for g in h.groups]
            w = [x / sum(h.group_examples) for x in h.group_examples]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sync()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            worst = 0.0
            for i, cloud in enumerate(h.global_params.values()):
                ref = sum(wg * b[i].double() for wg, b in zip(w, before))
                top = float(ref.abs().max())
                err = float((cloud.double() - ref).abs().max())
                worst = max(worst, err / top if top > 0 else err)
            bitwise = all(torch.equal(p, c) for g in h.groups
                          for p, c in zip(g.params.values(),
                                          h.global_params.values()))
            state["syncs"].append(worst)
            state["check_s"] += time.perf_counter() - t0 - (t2 - t1)
            log(f"  [8a] cloud sync in {t2 - t1:.4f} s: max err against the "
                f"float64 mean {worst:.3e} of each tensor's largest entry "
                f"(bound {SYNC_RTOL}); every group equals the cloud bit for "
                f"bit: {bitwise}")
            if not (worst <= SYNC_RTOL and bitwise):
                raise AssertionError(f"8a: sync err {worst}, bitwise {bitwise}")
        return run

    def timed_eval(evaluate):
        def run():
            t0 = time.perf_counter()
            out = evaluate()
            torch.cuda.synchronize()
            state["eval_s"].append(time.perf_counter() - t0)
            return out
        return run

    def on_round(h, rec):
        if rec is None:
            state["h"] = h
            h._cloud_sync = checked_sync(h, h._cloud_sync)
            h.evaluate = timed_eval(h.evaluate)
            fresh_peak()
            A.reset_launches()
            state["t"] = time.perf_counter()
            return
        torch.cuda.synchronize()
        now = time.perf_counter()
        evals = state["eval_s"][-1] if "eval_loss" in rec else 0.0
        # The round's own time: the checks above are not the learner's.
        state["round_s"].append(now - state["t"] - evals - state["check_s"])
        state["t"], state["check_s"] = now, 0.0
        state["steps"] += sum(int(g.last_cohort["steps_run"].sum())
                              for g in h.groups)
        log(f"  [8a] round {rec['round']}: synced {rec['synced']} "
            f"group losses {[round(x, 6) for x in rec['group_losses']]} "
            f"in {state['round_s'][-1]:.3f} s"
            + (f"; cloud eval loss {rec['eval_loss']:.6f} acc "
               f"{rec['eval_acc']:.4f} in {evals:.3f} s"
               if "eval_loss" in rec else ""))
        if rec["round"] == 0:
            differ = any(not torch.equal(p, q) for p, q in zip(
                h.groups[0].params.values(), h.groups[1].params.values()))
            if rec["synced"] or not differ:
                raise AssertionError("8a: the groups did not part in round 0")

    t0 = time.perf_counter()
    log("  [8a] train " + " ".join(HIER))
    summary = cli.main(["train", *HIER], on_round=on_round)
    torch.cuda.synchronize()
    launches = dict(A.launches)
    h = state["h"]
    cfg = h.config
    finite = all(bool(torch.isfinite(p).all())
                 for p in h.global_params.values())
    evals = sum("eval_loss" in r for r in h.history)
    eval_batches = math.ceil(len(h.dataset.x_test)
                             / max(cfg.fed.batch_size, 64))
    depth = cfg.model.depth
    want = {"flash_forward": depth * (state["steps"] + evals * eval_batches),
            "flash_backward_dq": depth * state["steps"],
            "flash_backward_dkv": depth * state["steps"]}
    ok = (finite and summary["rounds"] == 3 and len(state["syncs"]) == 2
          and evals == 2 and math.isfinite(summary["final_loss"])
          and [r["synced"] for r in h.history] == [False, True, True])
    if not ok:
        raise AssertionError(f"8a: summary {summary}, syncs {state['syncs']}")
    if launches != want:
        raise AssertionError(f"8a: kernel launches {launches}, "
                             f"expected {want}")
    log(f"  [8a] {len(h.groups)} groups x {h.groups[0].num_clients} clients, "
        f"cohort {h.groups[0].cohort_size} each; s/round "
        f"{[round(x, 3) for x in state['round_s']]}; cloud eval s "
        f"{[round(x, 3) for x in state['eval_s']]}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
        f"{launches} (exact); summary {json.dumps(summary)}; path "
        f"{time.perf_counter() - t0:.2f} s; {card()}")
    log("  [8a] mask_cost_summary " + json.dumps(h.mask_cost_summary()))
    return launches


def clustered_path(A):
    """8b: clustered FL on config #2 with a second concept planted on
    clients 50-99 (y -> 9 - y): 2 warm-up rounds, the update similarity
    after 3 steps, two clusters, one round each, per-client report."""
    from colearn_federated_learning_tpu_torch.fed import (
        ClusteredLearner, FederatedLearner)
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    t_path = time.perf_counter()
    base = FederatedLearner(get_config("cifar10_cnn_fedavg"))
    n = base.num_clients
    planted = np.arange(n) >= n // 2
    base.y[n // 2:] = 9 - base.y[n // 2:]
    seen, times = {}, {}
    similarity = base.client_update_similarity

    def captured(steps):
        t0 = time.perf_counter()
        seen["sim"] = similarity(steps=steps)
        times["similarity"] = time.perf_counter() - t0
        return seen["sim"]

    base.client_update_similarity = captured
    clustered = ClusteredLearner(base, num_clusters=2)
    fresh_peak()
    A.reset_launches()
    t0 = time.perf_counter()
    labels = clustered.cluster_and_specialize(warmup_rounds=2, sim_steps=3)
    times["cluster_and_specialize"] = time.perf_counter() - t0
    sim = seen["sim"]
    asym = float(np.abs(sim - sim.T).max())
    diag = float(np.abs(np.diag(sim) - 1.0).max())
    members = np.sort(np.concatenate(clustered.members))
    agree = float(max(np.mean(labels == planted), np.mean(labels != planted)))
    log(f"  [8b] similarity {sim.shape} in {times['similarity']:.3f} s: "
        f"max |S - S^T| {asym:.2e} (bound 1e-5), max |diag - 1| {diag:.2e} "
        f"(bound 1e-4); mean within the planted concepts "
        f"{sim[np.ix_(planted, planted)].mean():.4f} / "
        f"{sim[np.ix_(~planted, ~planted)].mean():.4f}, across "
        f"{sim[np.ix_(planted, ~planted)].mean():.4f}")
    log(f"  [8b] cluster sizes {[int(m.size) for m in clustered.members]}; "
        f"labels agree with the planted concept on {agree:.2%} of clients "
        f"(reported, not gated)")
    if not (sim.shape == (n, n) and asym <= 1e-5 and diag <= 1e-4
            and np.array_equal(members, np.arange(n))):
        raise AssertionError(f"8b: similarity {sim.shape}, asym {asym}, "
                             f"diag {diag}, members {members}")
    t0 = time.perf_counter()
    clustered.fit(rounds=1)
    times["fit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = clustered.evaluate_per_client()
    times["evaluate_per_client"] = time.perf_counter() - t0
    launches = dict(A.launches)
    finite = all(bool(torch.isfinite(p).all()) for c in clustered.clusters
                 if c is not None for p in c.params.values())
    scalars = [v for k, v in rep.items() if isinstance(v, float)]
    log(f"  [8b] report {json.dumps(rep)}; cluster records "
        + json.dumps([c.history[-1] for c in clustered.clusters
                      if c is not None]))
    if not (finite and all(math.isfinite(v) for v in scalars)
            and sum(rep["cluster_sizes"]) == n):
        raise AssertionError(f"8b: output is not finite: {rep}")
    if any(launches.values()):
        raise AssertionError(f"8b: flash kernels launched on the CNN path: "
                             f"{launches}")
    log(f"  [8b] seconds {json.dumps({k: round(v, 3) for k, v in times.items()})}; "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; path "
        f"{time.perf_counter() - t_path:.2f} s; {card()}")
    return launches


def per_client_eval_path(A):
    """8c: one BERT-base round and ``--per-client-eval``: the report is
    finite and K1 launched once per layer for every per-client chunk."""
    seen = {}

    def watch(learner, rec):
        if rec is None:
            evaluate = learner.evaluate_per_client

            def captured():
                t0 = time.perf_counter()
                seen["rep"] = evaluate()
                seen["s"] = time.perf_counter() - t0
                return seen["rep"]

            learner.evaluate_per_client = captured

    def chunks(learner):
        batch = max(learner.config.fed.batch_size, 64)
        return sum(math.ceil(int(c) / batch) for c in learner.counts)

    _, launches, learner = cli_path(
        A, "8c", ["--config", "agnews_bert_fedavg", "--attn-impl", "flash",
                  "--local-steps", "4", "--rounds", "1",
                  "--per-client-eval"], watch, extra_batches=chunks)
    rep = seen["rep"]
    values = [rep[k] for k in ("weighted_loss", "weighted_acc", "acc_p10",
                               "acc_p50", "acc_p90")]
    log(f"  [8c] per-client evaluation of {len(rep['per_client_acc'])} "
        f"clients ({chunks(learner)} chunks) in {seen['s']:.3f} s: "
        + json.dumps({k: rep[k] for k in ("weighted_loss", "weighted_acc",
                                          "acc_p10", "acc_p50", "acc_p90")}))
    if not (all(math.isfinite(v) for v in values)
            and np.isfinite(rep["per_client_loss"]).all()
            and len(rep["per_client_acc"]) == learner.num_clients):
        raise AssertionError(f"8c: report is not finite: {rep}")
    return launches


def slice_phase(A):
    """Phase 8: the hierarchical and clustered learners and per-client
    evaluation."""
    paths = {}
    for label, fn in (("hierarchical", hierarchical_path),
                      ("clustered", clustered_path),
                      ("per_client_eval", per_client_eval_path)):
        t0 = time.perf_counter()
        paths[label] = fn(A)
        log(f"  {label} in {time.perf_counter() - t0:.2f} s")
    return paths


# ------------------------------------------------------------ phase 9 (B4)
FOLD_KERNELS = {
    "fold_sparse": "colearn_federated_learning_tpu/ops/fold_kernel.py:239",
    "fold_dense": "colearn_federated_learning_tpu/ops/fold_kernel.py:269",
}
FOLD_SOURCE = "colearn_federated_learning_tpu_torch/csrc/fold.cu"
FOLD_ROWS = 10                 # contributions per 9a batch
TOPK_FRACTION = 0.05           # the JAX package's default keep density
SECTOR = 32                    # bytes the card moves per scattered access
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
FILE_PLANE = ["--config", "agnews_bert_fedavg", "--attn-impl", "flash",
              "--local-steps", "4"]
SILOS = 4


def sparse_batch(sizes, rows, int8, seed):
    """``rows`` topk-like contributions over the slot layout ``sizes``:
    each entry kept with probability TOPK_FRACTION (unique, sorted
    indices), int8 values with a per-slot scale or float32 values, a
    float32 weight.  Drawn on the card from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    batch = []
    for _ in range(rows):
        keep = torch.rand(int(offs[-1]), generator=g, device="cuda")
        gidx = torch.nonzero(keep < TOPK_FRACTION).flatten()
        if int8:
            vals = torch.randint(-127, 128, gidx.shape, generator=g,
                                 device="cuda").to(torch.int8)
        else:
            vals = torch.randn(gidx.shape, generator=g, device="cuda")
        gidx, vals = gidx.cpu().numpy(), vals.cpu().numpy()
        cut = np.searchsorted(gidx, offs)
        slots = [(gidx[cut[s]:cut[s + 1]] - offs[s], vals[cut[s]:cut[s + 1]],
                  np.float32(rng.uniform(1e-4, 1e-2)) if int8
                  else np.float32(1.0)) for s in range(len(sizes))]
        batch.append((np.float32(rng.uniform(1.0, 300.0)), slots))
    return batch


def plain_sparse(F, kernel, st, acc):
    """The plain version over a staged batch, contribution by contribution
    as the kernel's launches go."""
    n = len(kernel.sizes)
    for r, w in enumerate(st.weights):
        set_mode = acc is None
        if set_mode:
            acc = torch.zeros(kernel.total, dtype=torch.float32,
                              device="cuda")
        F.fold_sparse_reference(
            acc, st.idx, st.vals, st.begin[r * n:(r + 1) * n + 1],
            st.scales[r * n:(r + 1) * n], kernel.slot_off,
            int(st.begin_host[r * n]), int(st.begin_host[(r + 1) * n]),
            float(w), set_mode)
    return acc


def global_entries(kernel, st, r):
    """Contribution ``r``'s flat accumulator indices and per-entry scales."""
    n = len(kernel.sizes)
    lo, hi = int(st.begin_host[r * n]), int(st.begin_host[(r + 1) * n])
    e = torch.arange(lo, hi, device="cuda")
    s = torch.searchsorted(st.begin[r * n:(r + 1) * n + 1], e, right=True) - 1
    return kernel.slot_off[s] + st.idx[lo:hi], st.scales[r * n:][s], lo, hi


def bits_equal(what, got, want):
    """Hold ``got`` to ``want`` bit for bit (int32 views); returns the max
    abs difference (0.0)."""
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        raise AssertionError(f"{what}: {bad} entries differ from the plain "
                             "version")
    return float((got - want).abs().max())


def fold_check_phase(F):
    """9a: the fold kernel against its plain version at BERT-base's slot
    layout, bitwise; then its device time, the staging copy's, the plain
    version's, ``index_add_``'s and the bound."""
    from colearn_federated_learning_tpu_torch.fed import setup
    from colearn_federated_learning_tpu_torch.utils import trees

    shapes = setup.init_global_params(main_path_config(), "cuda")
    sizes = [int(np.asarray(l).size) for l in trees.leaves(shapes)]
    kernel = F.get_kernel(sizes)
    log(f"  BERT-base layout: {len(sizes)} slots, {kernel.total} f32 entries")
    errs = {"fold_sparse": 0.0, "fold_dense": 0.0}
    rows = {}
    staged = {}
    for int8, label in ((True, "topk8"), (False, "topk")):
        t0 = time.perf_counter()
        batch = sparse_batch(sizes, FOLD_ROWS, int8, 90 + int(int8))
        t_draw = time.perf_counter() - t0
        t0 = time.perf_counter()
        st = kernel.stage_sparse(batch)
        torch.cuda.synchronize()
        t_stage = time.perf_counter() - t0
        k = int(st.begin_host[-1])
        got = kernel.fold_sparse_staged(None, st)
        want = plain_sparse(F, kernel, st, None)
        errs["fold_sparse"] = max(errs["fold_sparse"], bits_equal(
            f"9a {label} x {FOLD_ROWS}", got, want))
        # Folding on into the accumulator adds, in order.
        errs["fold_sparse"] = max(errs["fold_sparse"], bits_equal(
            f"9a {label} onto an accumulator",
            kernel.fold_sparse_staged(got, st), plain_sparse(F, kernel, st,
                                                             want)))
        first = kernel.stage_sparse(batch[:1])
        bits_equal(f"9a {label} first contribution",
                   kernel.fold_sparse_staged(None, first),
                   plain_sparse(F, kernel, first, None))
        staged[label] = (st, batch)
        log(f"  {label}: {FOLD_ROWS} contributions of {k / FOLD_ROWS:.0f} "
            f"entries on average bitwise equal to the plain version (from "
            f"zeros, onto an accumulator, a first contribution alone); "
            f"drawn in {t_draw:.2f} s, staged in {t_stage:.2f} s")
    # A -0.0 assigned first and touched by nothing later survives.
    empty = [(np.zeros(0, np.int64), np.zeros(0, np.float32),
              np.float32(1.0))] * len(sizes)
    zero_first = list(empty)
    zero_first[0] = (np.array([3], np.int64), np.array([-0.0], np.float32),
                     np.float32(1.0))
    later = list(empty)
    later[0] = (np.array([1], np.int64), np.array([1.5], np.float32),
                np.float32(1.0))
    later[5] = (np.array([0, 7], np.int64), np.array([-2.0, 0.25],
                                                     np.float32),
                np.float32(1.0))
    nz = [(np.float32(1.0), zero_first), (np.float32(2.0), later)]
    st = kernel.stage_sparse(nz)
    got = kernel.fold_sparse_staged(None, st)
    bits_equal("9a -0.0", got, plain_sparse(F, kernel, st, None))
    if not (float(got[3]) == 0.0 and math.copysign(1.0, float(got[3])) < 0):
        raise AssertionError("9a: the staged -0.0 did not survive")
    log("  a -0.0 assigned by the first contribution survives the rest")

    # Dense: 10 full-width contributions, adopted then added in order.
    g = torch.Generator(device="cuda").manual_seed(93)
    offs = kernel.offsets
    dense = []
    for _ in range(FOLD_ROWS):
        flat = torch.randn(kernel.total, generator=g, device="cuda")
        flat = flat.cpu().numpy()
        dense.append([flat[a:b] for a, b in zip(offs[:-1], offs[1:])])
    t0 = time.perf_counter()
    x = kernel.stage_dense(dense)
    torch.cuda.synchronize()
    t_stage = time.perf_counter() - t0
    got = kernel.fold_dense_staged(None, x)
    want = F.fold_dense_reference(torch.empty_like(got), x, True)
    errs["fold_dense"] = bits_equal(f"9a dense x {FOLD_ROWS}", got, want)
    bits_equal("9a dense onto an accumulator",
               kernel.fold_dense_staged(got, x[:2]),
               F.fold_dense_reference(want, x[:2], False))
    log(f"  dense: {FOLD_ROWS} contributions of {kernel.total} entries "
        f"bitwise equal to the plain version (adopted, then onto an "
        f"accumulator); staged in {t_stage:.2f} s")
    del dense, got, want

    # Timing.  The kernel by CUDA-graph replay (``device_ms``); the plain
    # version and ``index_add_`` by events around a host loop (they are
    # not captured: the plain version's index_put_ sorts).  Sparse times
    # are per contribution (one launch), onto a standing accumulator.
    for label in ("topk8", "topk"):
        st, batch = staged[label]
        acc = torch.zeros(kernel.total, dtype=torch.float32, device="cuda")
        ms = device_ms(lambda s: kernel.fold_sparse_staged(acc, s),
                       [st]) / FOLD_ROWS
        wrapper = time_ms(lambda: kernel.fold_sparse_staged(acc, st),
                          iters=5) / FOLD_ROWS
        plain = time_ms(lambda: plain_sparse(F, kernel, st, acc),
                        iters=3) / FOLD_ROWS
        entries = [global_entries(kernel, st, r) for r in range(FOLD_ROWS)]
        vals = st.vals

        def yardstick():
            for (gi, sc, lo, hi), w in zip(entries, st.weights):
                acc.index_add_(0, gi, (vals[lo:hi].float() * sc) * float(w))

        library = time_ms(yardstick, iters=3) / FOLD_ROWS
        nbytes = int(st.begin_host[-1]) * (8 + vals.element_size())
        nbytes += sum(SECTOR * 2 * int(torch.unique_consecutive(
            gi // (SECTOR // 4)).numel()) for gi, *_ in entries)
        nbytes /= FOLD_ROWS
        flops = 3 * int(st.begin_host[-1]) / FOLD_ROWS
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
        h2d_bytes = (st.idx.numel() * 8 + vals.numel() * vals.element_size()
                     + st.begin.numel() * 8 + st.scales.numel() * 4)
        h2d = time_ms(lambda: kernel._pinned[:h2d_bytes].to(
            "cuda", non_blocking=True), iters=5) / FOLD_ROWS
        row = {"ms": ms, "wrapper_ms": wrapper, "plain_ms": plain,
               "library_ms": library, "h2d_ms": h2d,
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "max_abs_err": errs["fold_sparse"]}
        log(f"  fold_sparse {label} per contribution: {ms * 1e3:.2f} us "
            f"device ({row['bound_ms'] / ms:.1%} of bound "
            f"{row['bound_ms'] * 1e3:.2f} us, {row['bound_by']}: "
            f"{nbytes / 1e6:.1f} MB with 32-byte sectors); wrapper loop "
            f"{wrapper * 1e3:.2f} us; H2D staging copy {h2d * 1e3:.2f} us; "
            f"plain {plain * 1e3:.2f} us; index_add_ {library * 1e3:.2f} us")
        if label == "topk8":
            rows["fold_sparse"] = row
        del entries
    dense_bytes = x.numel() * 4 + kernel.total * 4
    ms = device_ms(lambda s: kernel.fold_dense_staged(None, s), [x])
    out = torch.empty(kernel.total, dtype=torch.float32, device="cuda")
    plain = time_ms(lambda: F.fold_dense_reference(out, x, True), iters=3)
    library = device_ms(lambda s: torch.sum(s, dim=0), [x])
    pinned = kernel._pinned
    h2d = time_ms(lambda: pinned[:x.numel() * 4].to("cuda", non_blocking=True),
                  iters=3)
    t_bytes = dense_bytes / HBM_BYTES_PER_S
    t_ops = x.numel() / F32_FLOP_PER_S
    rows["fold_dense"] = {
        "ms": ms, "wrapper_ms": time_ms(
            lambda: kernel.fold_dense_staged(None, x), iters=3),
        "plain_ms": plain, "library_ms": library, "h2d_ms": h2d,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "max_abs_err": errs["fold_dense"]}
    r = rows["fold_dense"]
    log(f"  fold_dense, {FOLD_ROWS} rows of {kernel.total}: {ms * 1e3:.2f} us "
        f"device ({r['bound_ms'] / ms:.1%} of bound "
        f"{r['bound_ms'] * 1e3:.2f} us, {r['bound_by']}); H2D staging copy "
        f"{h2d * 1e3:.2f} us; plain {plain * 1e3:.2f} us; torch.sum "
        f"{library * 1e3:.2f} us; {card()}")
    return rows


def file_plane_path(A, F, workdir):
    """9b: the file plane at BERT-base width through ``cli.main``: init,
    SILOS silos of ``train --role client --compress topk8``, aggregate,
    eval; then the same update files through ``StreamingFolder(device_fold
    =True)``, flat and as a two-aggregator tree, each bitwise equal to its
    host fold, the flat mean within 1e-6 of aggregate's mean delta (of its
    largest entry) and the new global model exactly the old plus that
    mean.  K1-K3's and the fold's launches are exact."""
    import os

    from colearn_federated_learning_tpu_torch import cli
    from colearn_federated_learning_tpu_torch.comm.aggregation import (
        StreamingFolder)
    from colearn_federated_learning_tpu_torch.fed import offline
    from colearn_federated_learning_tpu_torch.utils import trees
    from colearn_federated_learning_tpu_torch.utils.serialization import (
        load_pytree_npz)

    g0, g1 = f"{workdir}/global0.npz", f"{workdir}/global1.npz"
    ups = [f"{workdir}/update{c}.npz" for c in range(SILOS)]
    fresh_peak()
    A.reset_launches()
    F.reset_launches()
    t0 = time.perf_counter()
    log("  [file plane] " + " ".join(["init", *FILE_PLANE]))
    cli.main(["init", *FILE_PLANE, "--out", g0])
    client_s = []
    for cid, out in enumerate(ups):
        t1 = time.perf_counter()
        stats = cli.main(["train", *FILE_PLANE, "--role", "client",
                          "--client-id", str(cid), "--global-model", g0,
                          "--out", out, "--compress", "topk8"])
        client_s.append(time.perf_counter() - t1)
        if not (math.isfinite(stats["mean_loss"]) and stats["weight"] > 0):
            raise AssertionError(f"9b: bad client stats {stats}")
    t1 = time.perf_counter()
    agg = cli.main(["aggregate", *FILE_PLANE, "--global-model", g0,
                    "--updates", *ups, "--out", g1])
    agg_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    ev = cli.main(["eval", *FILE_PLANE, "--global-model", g1])
    eval_s = time.perf_counter() - t1
    if not (agg["round"] == 1 and agg["num_updates"] == SILOS
            and math.isfinite(ev["eval_loss"]) and 0 <= ev["eval_acc"] <= 1):
        raise AssertionError(f"9b: aggregate {agg}, eval {ev}")
    torch.cuda.synchronize()
    launches = dict(A.launches)
    config = cli.config_from_args(cli.build_parser().parse_args(
        ["train", *FILE_PLANE]))
    from colearn_federated_learning_tpu_torch.data import registry
    n_test = len(registry.get_dataset(config.data.dataset,
                                      seed=config.run.seed).x_test)
    depth, steps = config.model.depth, SILOS * config.fed.local_steps
    eval_batches = math.ceil(n_test / max(config.fed.batch_size, 64))
    want = {"flash_forward": depth * (steps + eval_batches),
            "flash_backward_dq": depth * steps,
            "flash_backward_dkv": depth * steps}
    if launches != want:
        raise AssertionError(f"9b: kernel launches {launches}, expected "
                             f"{want}")
    size_mb = sum(os.path.getsize(u) for u in ups) / SILOS / 1e6
    log(f"  [file plane] clients {[round(t, 2) for t in client_s]} s "
        f"(update files {size_mb:.1f} MB each); aggregate {agg_s:.2f} s; "
        f"eval {eval_s:.2f} s: loss {ev['eval_loss']:.6f} acc "
        f"{ev['eval_acc']:.4f}; launches {launches} (exact)")

    # The same files through the folders, host and on the card.
    params, _ = load_pytree_npz(g0)
    files = [load_pytree_npz(u) for u in ups]
    order = [str(c) for c in range(SILOS)]

    def folder(device_fold, subset=None, **kw):
        f = StreamingFolder(params, order=order, device_fold=device_fold,
                            **kw)
        for wire, meta in (files if subset is None
                           else [files[c] for c in subset]):
            f.add(dict(meta), wire)
        f.finalize()
        return f

    def same(what, a, b):
        if not (a.total_w == b.total_w and a.loss_sum == b.loss_sum
                and all(x.tobytes() == y.tobytes() for x, y in
                        zip(trees.leaves(a.wsum), trees.leaves(b.wsum)))):
            raise AssertionError(f"9b: {what} differs from the host fold")

    t1 = time.perf_counter()
    host = folder(False)
    host_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    dev = folder(True)
    dev_s = time.perf_counter() - t1
    same("the device fold", dev, host)
    mean, total_w, _ = dev.mean()
    ref = offline.mean_update(config, params, 0, ups)
    if ref["accepted"] != SILOS or ref["total_weight"] != total_w:
        raise AssertionError(f"9b: aggregate's fold {ref['accepted']} / "
                             f"{ref['total_weight']}")
    ref_mean = [t.cpu().numpy() for t in trees.leaves(ref["mean_delta"])]
    top = max(float(np.abs(m).max()) for m in ref_mean)
    err = max(float(np.abs(a - b).max())
              for a, b in zip(trees.leaves(mean), ref_mean))
    if err > 1e-6 * top:
        raise AssertionError(f"9b: folder mean vs aggregate's mean delta "
                             f"{err} > 1e-6 x {top}")
    new, _ = load_pytree_npz(g1)
    lr = np.float32(config.fed.server_lr)
    if not all(np.array_equal(n, p + m * lr)
               for n, p, m in zip(trees.leaves(new), trees.leaves(params),
                                  ref_mean)):
        raise AssertionError("9b: the new global model is not the old plus "
                             "the mean delta")
    # Two aggregators fold two files each; the root folds their partials.
    halves = [list(range(SILOS // 2)), list(range(SILOS // 2, SILOS))]
    root = StreamingFolder(params, order=["agg:0", "agg:1"],
                           device_fold=True)
    for i, half in enumerate(halves):
        leaf = folder(True, half)
        root.add_partial(f"agg:{i}", leaf.total_w, leaf.wsum, leaf.loss_sum,
                         count=len(half))
    root.finalize()
    same("the two-aggregator tree", root,
         folder(False, slices=[[str(c) for c in h] for h in halves]))
    torch.cuda.synchronize()
    fold_launches = dict(F.launches)
    want = {"fold_sparse": 2 * SILOS, "fold_dense": 1}
    if fold_launches != want:
        raise AssertionError(f"9b: fold launches {fold_launches}, expected "
                             f"{want}")
    log(f"  [file plane] StreamingFolder: host {host_s:.2f} s, device "
        f"{dev_s:.2f} s, bitwise equal; mean vs aggregate's {err:.3e} "
        f"(bound 1e-6 x {top:.3e}); tree bitwise equal to the sliced host "
        f"fold; fold launches {fold_launches} (exact); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; path "
        f"{time.perf_counter() - t0:.2f} s; cuts: local_steps 150 -> 4, "
        f"{SILOS} silos")
    return {**launches, **fold_launches}


def bench_path():
    """9c: the port's ``bench`` with its defaults on the card."""
    from colearn_federated_learning_tpu_torch import cli

    out = cli.main(["bench"])
    if not (out["platform"] == "gpu" and out["value"] > 0
            and out["metric"] == "fedavg_cifar10_cnn_rounds_per_sec"
            and out["vs_baseline"] > 0 and out.get("card")):
        raise AssertionError(f"9c: bad bench line {out}")
    return out


def build_phase(_build):
    """Build the kernels; report each head-dim-64 instantiation's registers,
    spills and blocks per SM, and fail if any instantiation spills."""
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"  built in {time.perf_counter() - t0:.2f} s")
    props = {}                     # mangled name -> ptxas lines
    for text in logs.values():
        func = ""
        for line in text.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                func = m.group(1)
            elif func and ("spill stores" in line or "Used" in line):
                props.setdefault(func, []).append(
                    line.split(":", 1)[-1].strip())
    spills = [f for f, lines in props.items()
              if re.search(r"[1-9]\d* bytes spill stores", " ".join(lines))]
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")
    if not props:
        raise AssertionError("no ptxas report for the kernels")
    lib = _build.load("flash_attention")
    lib.fa_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)]
    lib.fa_blocks_per_sm.restype = ctypes.c_int
    for kind, name in enumerate(("fwd", "dq", "dkv")):
        blocks = ctypes.c_int(0)
        err = lib.fa_blocks_per_sm(kind, 64, ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f"occupancy query failed: cudaError {err}")
        func = next((f for f in props if f"flash_{name}_" in f
                     and "Li64E" in f), None)
        log(f"  {name} D=64: {blocks.value} blocks/SM; "
            + ("; ".join(props[func]) if func else "no ptxas report"))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from colearn_federated_learning_tpu_torch.ops import _build
    from colearn_federated_learning_tpu_torch.ops import attention as A
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    log("phase 1: device")
    log(card())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    log("phase 2: build")
    build_phase(_build)

    log("phase 3: kernels vs plain versions (bf16)")
    rows = kernel_phase(A)

    paths = {}
    log("phase 4: small-input check and the BERT path")
    t0 = time.perf_counter()
    small_model_check()
    paths["bert"] = main_path(A)
    log(f"  phase 4 in {time.perf_counter() - t0:.2f} s")

    log("phase 5: the CIFAR-10 CNN round (config #2)")
    t0 = time.perf_counter()
    paths["cnn"] = drive_path(A, "cnn", get_config("cifar10_cnn_fedavg"),
                              2, "none")
    log(f"  phase 5 in {time.perf_counter() - t0:.2f} s")

    log("phase 6: one round of each other family at full width")
    t0 = time.perf_counter()
    for label, cfg, cuts in family_paths():
        paths[label] = drive_path(A, label, cfg, 1, cuts)
    log(f"  phase 6 in {time.perf_counter() - t0:.2f} s")

    log("phase 7: the round's other branches through the command line")
    t0 = time.perf_counter()
    paths.update(cli_phase(A))
    log(f"  phase 7 in {time.perf_counter() - t0:.2f} s")

    log("phase 8: hierarchical, clustered and per-client evaluation")
    t0 = time.perf_counter()
    paths.update(slice_phase(A))
    log(f"  phase 8 in {time.perf_counter() - t0:.2f} s")
    log("phase 9: the fold kernel and the file plane")
    from colearn_federated_learning_tpu_torch.ops import fold as F

    t0 = time.perf_counter()
    rows.update(fold_check_phase(F))
    log(f"  9a in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    # The global models and update files (~1.1 GB) go to a temporary
    # directory inside the gitignored build directory, removed afterwards.
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        paths["file_plane"] = file_plane_path(A, F, workdir)
    log(f"  9b in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    bench_path()
    log(f"  9c in {time.perf_counter() - t0:.2f} s")
    log("launches per path " + json.dumps(paths))

    sources = {**{name: (SOURCE, rep) for name, (rep, _) in KERNELS.items()},
               **{name: (FOLD_SOURCE, rep)
                  for name, rep in FOLD_KERNELS.items()}}
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=sum(p.get(name, 0) for p in paths.values()),
                    status="ok", **rows[name])
               for name, (src, rep) in sources.items()]
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on their paths: {idle}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
