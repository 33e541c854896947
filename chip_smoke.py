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
7. one JSON line of per-kernel results (launches summed over the paths),
   then the result line.

Needs a CUDA device and the repository beside it; it exits non-zero and
prints no result otherwise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from types import SimpleNamespace

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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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

    log("phase 1: device")
    log(card())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    log("phase 2: build")
    build_phase(_build)

    log("phase 3: kernels vs plain versions (bf16)")
    rows = kernel_phase(A)

    log("phase 4: small-input check and the BERT path")
    t0 = time.perf_counter()
    small_model_check()
    paths = {"bert": main_path(A)}
    log(f"  phase 4 in {time.perf_counter() - t0:.2f} s")

    log("phase 5: this slice's path, the CIFAR-10 CNN round (config #2)")
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    t0 = time.perf_counter()
    paths["cnn"] = drive_path(A, "cnn", get_config("cifar10_cnn_fedavg"), 2,
                              "none")
    log(f"  phase 5 in {time.perf_counter() - t0:.2f} s")

    log("phase 6: one round of each other family at full width")
    t0 = time.perf_counter()
    for label, cfg, cuts in family_paths():
        paths[label] = drive_path(A, label, cfg, 1, cuts)
    log(f"  phase 6 in {time.perf_counter() - t0:.2f} s")
    log("launches per path " + json.dumps(paths))

    kernels = [dict(name=name, route="cuda", source=SOURCE, replaces=rep,
                    launches=sum(p[name] for p in paths.values()),
                    status="ok", **rows[name])
               for name, (rep, _) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
