#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is caught):

1. the card's name and power limit, torch and CUDA versions;
2. build the CUDA kernels from ``colearn_federated_learning_tpu_torch/csrc``;
3. each flash-attention kernel (K1 forward, K2 dQ, K3 dK/dV) against its
   plain PyTorch version in bf16 — at the BERT-base training shapes and
   the evaluation batch of 64 with a realistic padding mask, a ragged
   L=100, a causal case and a case with a fully masked row — then its time
   at the training shapes beside the plain version's, its bound, and
   torch's SDPA as a yardstick;
4. a small-input check (flash vs dense cores of a small BERT on the card),
   then the main path: ``FederatedLearner`` on ``agnews_bert_fedavg`` with
   ``attn_impl="flash"`` and 4 local steps (full BERT-base width and
   depth, cohort 10, batch 16, seq 128, bf16) for 2 rounds and an
   evaluation, with the kernels' launch counts read around it;
5. one JSON line of per-kernel results, then the result line.

Needs a CUDA device and the repository beside it; it exits non-zero and
prints no result otherwise.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
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


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after warm-up."""
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
    return errs, (q, k, v, dout, bias, o_ref, lse_ref, delta, mask.to(dev))


def bound_ms(kname, B, L, H, D) -> tuple[float, str]:
    """Least time for the same work: inputs read once and outputs written
    once over HBM bandwidth, or the products at the bf16 peak."""
    act, bias, rowf = B * L * H * D * 2, B * L * 4, B * L * H * 4
    nbytes = {
        "flash_forward": 3 * act + bias + act + rowf,
        "flash_backward_dq": 4 * act + bias + 2 * rowf + act,
        "flash_backward_dkv": 4 * act + bias + 2 * rowf + 2 * act,
    }[kname]
    flops = KERNELS[kname][1] * B * H * L * L * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
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
    slice_inputs = None
    for case in cases:
        e, inputs = kernel_case(A, *case)
        errs = {k: max(errs[k], e[k]) for k in errs}
        slice_inputs = slice_inputs or inputs

    q, k, v, dout, bias, o, lse, delta, mask = slice_inputs
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, dout))
    amask = mask[:, None, None, :]
    timings = {
        "flash_forward": (
            lambda: A.flash_forward(q, k, v, bias),
            lambda: A.flash_forward_reference(q, k, v, bias),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask)),
        "flash_backward_dq": (
            lambda: A.flash_backward_dq(q, k, v, bias, dout, lse, delta),
            lambda: A.flash_backward_dq_reference(q, k, v, bias, dout, lse,
                                                  delta), None),
        "flash_backward_dkv": (
            lambda: A.flash_backward_dkv(q, k, v, bias, dout, lse, delta),
            lambda: A.flash_backward_dkv_reference(q, k, v, bias, dout, lse,
                                                   delta), None),
    }
    rows = {}
    for kname, (kern, plain, lib) in timings.items():
        bms, bby = bound_ms(kname, B, L, H, D)
        rows[kname] = {
            "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "library_ms": time_ms(lib) if lib is not None else None,
            "bound_ms": bms, "bound_by": bby, "max_abs_err": errs[kname],
        }
        log(f"  {kname:19s} {rows[kname]['ms']:.4f} ms  plain "
            f"{rows[kname]['plain_ms']:.4f} ms  bound {bms:.4f} ms ({bby})  "
            f"sdpa {rows[kname]['library_ms']}")
    # Yardstick only: SDPA's backward computes dQ, dK and dV in one call.
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=amask)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), dot,
                                                   retain_graph=True))
    log(f"  sdpa backward (dQ, dK, dV together): {sdpa_bwd:.4f} ms")
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
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner

    cfg = main_path_config()
    t0 = time.perf_counter()
    learner = FederatedLearner(cfg)
    log(f"  learner built in {time.perf_counter() - t0:.2f} s "
        f"({learner.num_clients} clients, cohort {learner.cohort_size}, "
        f"{learner.num_steps} steps x batch {cfg.fed.batch_size})")
    before = [p.clone() for p in learner.params.values()]
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    round_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        rec = learner.run_round()
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        log(f"  round {rec['round']}: train_loss {rec['train_loss']:.6f} "
            f"completed {rec['completed']:.0f} "
            f"delta_norm_mean {rec['delta_norm_mean']:.6f} "
            f"in {round_s[-1]:.3f} s")
        if not (math.isfinite(rec["train_loss"]) and rec["completed"] == 10):
            raise AssertionError(f"bad round record {rec}")
    t0 = time.perf_counter()
    eval_loss, eval_acc = learner.evaluate()
    eval_s = time.perf_counter() - t0
    launches = dict(A.launches)
    changed = sum(float((p - b).abs().sum())
                  for p, b in zip(learner.params.values(), before))
    log(f"  evaluate: loss {eval_loss:.6f} acc {eval_acc:.4f} in "
        f"{eval_s:.3f} s; launches {launches}; params moved (sum |diff|) "
        f"{changed:.6e}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if not (math.isfinite(eval_loss) and 0.0 <= eval_acc <= 1.0 and changed > 0):
        raise AssertionError("main path output is not finite or did not train")
    steps = 2 * learner.cohort_size * learner.num_steps
    eval_batches = math.ceil(len(learner.dataset.x_test) / 64)
    depth = cfg.model.depth
    want = {"flash_forward": depth * (steps + eval_batches),
            "flash_backward_dq": depth * steps,
            "flash_backward_dkv": depth * steps}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    log(f"  seconds per round: {round_s}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from colearn_federated_learning_tpu_torch.ops import _build
    from colearn_federated_learning_tpu_torch.ops import attention as A

    log("phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    log("phase 2: build")
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"  built in {time.perf_counter() - t0:.2f} s")
    # Register use of the head-dim-64 instantiations (the training path).
    for text in logs.values():
        func = ""
        for line in text.splitlines():
            if "Function properties for" in line:
                func = line.rsplit(" ", 1)[-1]
            elif "Used" in line and "Li64E" in func:
                log(f"  {func}: {line.split(':', 1)[1].strip()}")

    log("phase 3: kernels vs plain versions (bf16)")
    rows = kernel_phase(A)

    log("phase 4: small-input check and main path")
    small_model_check()
    launches = main_path(A)

    kernels = [dict(name=name, route="cuda", source=SOURCE, replaces=rep,
                    launches=launches[name], status="ok", **rows[name])
               for name, (rep, _) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
