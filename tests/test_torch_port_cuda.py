"""The flash-attention CUDA kernels (K1-K3) and the fold kernel (B4)
against their plain PyTorch versions (the fold bit for bit), every model family's bf16 logits against the same model in
f32 on the CPU, the hierarchical sync, update similarity and
per-client evaluation against the CPU, remat's grads and K1 launches
against the plain run, the client-mesh round at world size 1 on NCCL
against the single-device round, socket-plane rounds with the device
fold (flat, through a two-aggregator tree, and one asynchronous
aggregation) against the host fold, a traced engine round's spans
against its record, a LoRA factor-only update against the CPU, the
fold at the factor layout and at the sharded server's tp = 2 slot layout
against its plain version, checkpoints of card tensors and an engine
resume bit for bit, the memory gauges, the profiler window's kernel
events, the FLOP count and the personalized evaluation against the CPU,
the native kernels N1 (top-k) and N2 (row gather) against their plain
versions bit for bit, feedback compression of card tensors against the
CPU's and the engine's pack on the card against the CPU's,
on the card.  Marked
``cuda``: without a CUDA device every
test here skips.  On a machine with the card (no JAX needed):

    python -m pytest tests/test_torch_port_cuda.py --noconftest -p no:cacheprovider -q

Inputs are bf16, the only dtype the kernels take.  Tolerance: both sides
sum in f32 and round to bf16 at the same points, so they differ only where
a different summation order flips a rounding; outputs are held to 2e-2 of
the largest reference magnitude, the lse to 1e-4 of it.  A family's bf16
logits on the card are held to the f32 truth (the same params in f32 on
the CPU): their error may be at most twice that of the same bf16 model on
the CPU plus one bf16 step at the largest magnitude, since cuDNN, cuBLAS
and the kernels round in other places than the CPU's plain ops.
"""

import dataclasses

import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu_torch.models import registry
from colearn_federated_learning_tpu_torch.ops import attention as A
from colearn_federated_learning_tpu_torch.ops import fold
from colearn_federated_learning_tpu_torch.utils.config import ModelConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _inputs(device, B, L, H, D, dtype, mask_kind, seed=0, lk=None):
    """q and dO of length L, k and v of length ``lk`` (default L), and a
    (B, lk) key mask."""
    lk = L if lk is None else lk
    g = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(B, n, H, D, generator=g).to(dtype).to(device)
                     for n in (L, lk, lk, L))
    lengths = torch.randint(max(1, lk // 4), lk + 1, (B,), generator=g)
    mask = torch.arange(lk)[None, :] < lengths[:, None]
    if mask_kind == "row":
        mask[0] = False
    elif mask_kind == "lead":
        mask[0, :3] = False
    elif mask_kind == "none":
        mask[:] = True
    return q, k, v, dout, mask.to(device)


def _close(got, ref, tol, atol=0.0):
    got, ref = got.detach().float(), ref.detach().float()
    assert torch.isfinite(got).all()
    bound = max(tol * float(ref.abs().max()), atol)
    err = float((got - ref).abs().max())
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("B,L,Lk,H,D,causal,mask_kind", [
    (16, 128, 128, 12, 64, False, "pad"),
    (4, 100, 100, 4, 64, False, "pad"),
    (4, 128, 128, 4, 64, True, "lead"),
    (3, 96, 96, 2, 64, False, "row"),
    (2, 70, 70, 2, 32, True, "pad"),
    # The head dims of the other instantiations.
    (2, 128, 128, 3, 16, False, "pad"),
    (2, 128, 128, 3, 32, False, "pad"),
    (2, 128, 128, 3, 128, False, "pad"),
    (2, 130, 130, 2, 128, True, "pad"),
    # One row, a partial row group past one tile, a ragged second tile.
    (3, 1, 1, 2, 64, False, "none"),
    (3, 1, 65, 2, 64, False, "pad"),
    (3, 65, 65, 2, 64, False, "pad"),
    (3, 130, 130, 2, 64, False, "row"),
    # Lq != Lk both ways, with and without causal masking.
    (2, 70, 200, 2, 64, False, "pad"),
    (2, 200, 70, 2, 64, False, "pad"),
    (2, 70, 200, 2, 64, True, "none"),
    (2, 200, 70, 2, 32, True, "none"),
    # Causal with ragged L.
    (2, 193, 193, 2, 64, True, "lead"),
    # The evaluation batch.
    (64, 128, 128, 12, 64, False, "pad"),
    # The training grid at the D = 128 instantiation (its own register
    # budget and occupancy).
    (16, 128, 128, 12, 128, True, "pad"),
    # ViT-B/16 on FEMNIST: 49 patches + the class token, no key mask, at
    # the training batch and the evaluation batch.
    (16, 50, 50, 12, 64, False, "none"),
    (64, 50, 50, 12, 64, False, "none"),
])
def test_kernels_match_plain(cuda, B, L, Lk, H, D, causal, mask_kind):
    tol = 2e-2
    q, k, v, dout, mask = _inputs(cuda, B, L, H, D, torch.bfloat16,
                                  mask_kind, lk=Lk)
    bias = A.key_bias(mask, B, Lk, cuda)
    o_ref, lse_ref = A.flash_forward_reference(q, k, v, bias, causal)
    before = dict(A.launches)
    o, lse = A.flash_forward(q, k, v, bias, causal)
    _close(o, o_ref, tol)
    assert torch.equal(lse >= 1e29, lse_ref >= 1e29)
    fin = lse_ref < 1e29
    _close(lse[fin], lse_ref[fin], 1e-4)
    delta = (dout.float() * o_ref.float()).sum(-1)
    # With a single key the softmax is constant, so dQ and dK are 0 up to
    # the f32 rounding of dp - delta (|dO| |V| x 2^-24 x D): an absolute
    # bound, as a relative one has nothing to scale with.
    atol = 1e-5 if Lk == 1 else 0.0
    dq = A.flash_backward_dq(q, k, v, bias, dout, lse_ref, delta, causal)
    _close(dq, A.flash_backward_dq_reference(q, k, v, bias, dout, lse_ref,
                                             delta, causal), tol, atol)
    dk, dv = A.flash_backward_dkv(q, k, v, bias, dout, lse_ref, delta, causal)
    dk_ref, dv_ref = A.flash_backward_dkv_reference(q, k, v, bias, dout,
                                                    lse_ref, delta, causal)
    _close(dk, dk_ref, tol, atol)
    _close(dv, dv_ref, tol)
    torch.cuda.synchronize()
    assert all(A.launches[n] == before[n] + 1 for n in A.launches)
    if mask_kind == "row":
        assert float(o[0].float().abs().max()) == 0.0


@pytest.mark.parametrize("kernel", ["flash_backward_dq",
                                    "flash_backward_dkv"])
def test_dkv_is_bitwise_repeatable(cuda, kernel):
    """Each dQ (K2) and dK/dV (K3) tile has one owner block and no atomics:
    two launches on the same input give the same bits."""
    q, k, v, dout, mask = _inputs(cuda, 16, 128, 12, 64, torch.bfloat16,
                                  "pad", seed=3)
    bias = A.key_bias(mask, 16, 128, cuda)
    o, lse = A.flash_forward(q, k, v, bias)
    delta = (dout.float() * o.float()).sum(-1)
    fn = getattr(A, kernel)
    first = fn(q, k, v, bias, dout, lse, delta)
    second = fn(q, k, v, bias, dout, lse, delta)
    torch.cuda.synchronize()
    if kernel == "flash_backward_dq":
        first, second = (first,), (second,)
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_autograd_matches_dense(cuda):
    q, k, v, dout, mask = _inputs(cuda, 2, 48, 2, 32, torch.bfloat16, "pad",
                                  1)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = A.flash_attention(*ins, mask)
    grads = torch.autograd.grad(out, ins, dout)
    ref_ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = A.dense_attention(*ref_ins, mask)
    ref_grads = torch.autograd.grad(ref, ref_ins, dout)
    _close(out, ref, 2e-2)
    for g, r in zip(grads, ref_grads):
        _close(g, r, 2e-2)


def test_wrapper_rejects_float32_cuda_tensors(cuda):
    q = torch.zeros(1, 8, 1, 32, device=cuda)
    bias = torch.zeros(1, 8, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        A.flash_forward(q, q, q, bias)


def test_wrapper_rejects_misaligned_operands(cuda):
    buf = torch.zeros(1 * 8 * 1 * 32 + 1, device=cuda, dtype=torch.bfloat16)
    q = buf[1:].view(1, 8, 1, 32)              # contiguous, 2 bytes off
    bias = torch.zeros(1, 8, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        A.flash_forward(q, q, q, bias)


def test_wrapper_rejects_unsupported_head_dim(cuda):
    q = torch.zeros(1, 8, 1, 24, device=cuda, dtype=torch.bfloat16)
    bias = torch.zeros(1, 8, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_forward(q, q, q, bias)


# name -> (ModelConfig fields, per-example input shape)
FAMILIES = {
    "mlp": (dict(name="mlp", num_classes=10, hidden_dim=64), (28, 28, 1)),
    "cnn": (dict(name="cnn", num_classes=10, width=16), (32, 32, 3)),
    "cnn_s2d_nonorm": (dict(name="cnn", num_classes=10, width=16,
                            stem="space_to_depth", norm="none"), (32, 32, 3)),
    "resnet18": (dict(name="resnet18", num_classes=10, width=16),
                 (32, 32, 3)),
    "tcn": (dict(name="tcn", num_classes=8, width=16, depth=3), (64, 16)),
    "vit_flash": (dict(name="vit_b16", num_classes=10, width=128, depth=2,
                       num_heads=4, attn_impl="flash"), (28, 28, 1)),
    "moe_bert_flash": (dict(name="moe_bert", num_classes=4, width=128,
                            depth=2, num_heads=4, seq_len=64,
                            vocab_size=1000, num_experts=4,
                            attn_impl="flash"), (64,)),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_bf16_logits_on_card_match_f32(cuda, name):
    kw, shape = FAMILIES[name]
    g = torch.Generator().manual_seed(0)
    if kw["name"] == "moe_bert":
        x = torch.randint(1, 1000, (8,) + shape, generator=g)
        x[:, 48:] = 0
        x[3] = 0                                # an all-padding example
    else:
        x = torch.randn((8,) + shape, generator=g)
    cfg = ModelConfig(**kw)
    f32 = registry.build_model(cfg, "cpu", generator=torch.Generator()
                               .manual_seed(1), input_shape=shape)
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    plain = registry.build_model(bf16, "cpu", input_shape=shape)
    card = registry.build_model(bf16, cuda, input_shape=shape)
    plain.load_state_dict(f32.state_dict())
    card.load_state_dict(f32.state_dict())
    before = dict(A.launches)
    with torch.no_grad():
        truth, ref = f32(x), plain(x)
        got = card(x.to(cuda)).cpu()
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    err = float((got - truth).abs().max())
    bound = (2.0 * float((ref - truth).abs().max())
             + 2.0 ** -8 * float(truth.abs().max()))
    assert err <= bound, (err, bound)
    flash = kw.get("attn_impl") == "flash"
    assert (A.launches["flash_forward"] > before["flash_forward"]) == flash


def test_noise_and_masks_are_drawn_on_the_card(cuda):
    """DP noise, pair masks and the clip bit's noise come from generators
    on the card (never drawn on the host and copied), and a pair's two
    members expand the same stream there, so the masks cancel in f32."""
    import numpy as np

    from colearn_federated_learning_tpu_torch.fed.programs import Draws
    from colearn_federated_learning_tpu_torch.privacy import secure_agg

    draws, shapes = Draws(5), [(300, 7), (11,)]
    noise = list(draws.dp_noise(0, 3, shapes, cuda))
    assert all(t.device.type == "cuda" for t in noise)
    assert draws.clip_bit_noise(0, cuda).device.type == "cuda"
    a, b = (list(draws.pair_mask(2, i, j, shapes, cuda))
            for i, j in ((4, 9), (9, 4)))
    assert all(torch.equal(x, y) and x.device.type == "cuda"
               for x, y in zip(a, b))
    ids = np.array([1, 4, 9, 12])
    updates = [[torch.randn(s, device=cuda) for s in shapes] for _ in ids]
    plain = [sum(u[k] for u in updates) for k in range(len(shapes))]
    table = secure_agg.partner_table(ids, ids)
    masked = [secure_agg.mask_update(
        [t.clone() for t in u], int(i), row,
        lambda p, q: draws.pair_mask(2, p, q, shapes, cuda))
        for u, i, row in zip(updates, ids, table)]
    for k in range(len(shapes)):
        total = sum(m[k] for m in masked)
        assert float((total - plain[k]).abs().max()) <= 1e-5


def test_krum_on_the_card_matches_the_cpu(cuda):
    """Krum's Gram products stay f32 on the card (no TF32): its selection
    and aggregate equal the CPU's."""
    from colearn_federated_learning_tpu_torch.fed import robust

    g = torch.Generator().manual_seed(3)
    stacked = [torch.randn(10, 64, 300, generator=g) * 1e-2,
               torch.randn(10, 5, generator=g)]
    stacked[0][7] += 0.5                          # a far outlier
    cpu, cpu_sel = robust.robust_aggregate(stacked, "krum", 0.2)
    dev, dev_sel = robust.robust_aggregate([s.to(cuda) for s in stacked],
                                           "krum", 0.2)
    assert torch.equal(cpu_sel, dev_sel.cpu()) and not bool(cpu_sel[7])
    for x, y in zip(cpu, dev):
        _close(y.cpu(), x, 1e-5)


def _mlp_config(num_clients=8, **fed_kw):
    from colearn_federated_learning_tpu_torch.utils import config

    fed = dict(strategy="fedavg", rounds=3, cohort_size=0, local_steps=3,
               batch_size=16, lr=0.1, momentum=0.9)
    fed.update(fed_kw)
    return config.ExperimentConfig(
        data=config.DataConfig(dataset="mnist_tiny", num_clients=num_clients,
                               partition="iid", max_examples_per_client=64),
        model=config.ModelConfig(name="mlp", num_classes=10, hidden_dim=32,
                                 depth=2),
        fed=config.FedConfig(**fed), run=config.RunConfig(name="card"))


def test_hierarchical_sync_on_the_card_matches_the_cpu(cuda):
    """The f32 MLP in 2 groups, a sync after every round: each group holds
    the cloud model bit for bit after a sync, the cloud model is the
    float64 weighted mean of the groups' to 1e-6 of its largest entry, and
    the card's cloud model after 2 rounds is the CPU's (same init, same
    draws) to rtol 1e-4 / atol 2e-5."""
    from colearn_federated_learning_tpu_torch.fed import HierarchicalLearner

    cfg = _mlp_config()
    card = HierarchicalLearner(cfg, sync_period=1, device=cuda)
    cpu = HierarchicalLearner(cfg, sync_period=1, device="cpu")
    card.run_round()
    for g in card.groups:
        g.run_round()
    before = [[p.double() for p in g.params.values()] for g in card.groups]
    w = [x / sum(card.group_examples) for x in card.group_examples]
    card._cloud_sync()
    for i, cloud in enumerate(card.global_params.values()):
        ref = sum(wg * b[i] for wg, b in zip(w, before))
        assert float((cloud.double() - ref).abs().max()) <= \
            1e-6 * float(ref.abs().max())
    for g in card.groups:
        assert all(torch.equal(p, c) for p, c in zip(
            g.params.values(), card.global_params.values()))
    cpu.run_round()
    for g in cpu.groups:
        g.run_round()
    cpu._cloud_sync()
    for name, t in card.global_params.items():
        torch.testing.assert_close(t.cpu(), cpu.global_params[name],
                                   rtol=1e-4, atol=2e-5)


def test_similarity_and_per_client_eval_on_the_card_match_the_cpu(cuda):
    """Clients 4-7 in a permuted-label concept: the card's update
    similarity (f32 Gram product, no TF32) and per-client scores are the
    CPU's, the similarity is symmetric with a unit diagonal, and the
    clustered learner recovers the two concepts."""
    import numpy as np

    from colearn_federated_learning_tpu_torch.fed import (
        ClusteredLearner, FederatedLearner)

    learners = []
    for device in (cuda, "cpu"):
        ln = FederatedLearner(_mlp_config(), device=device)
        ln.y[4:] = 9 - ln.y[4:]
        ln.run_round()
        learners.append(ln)
    card, cpu = learners
    sim = card.client_update_similarity(steps=2)
    np.testing.assert_allclose(sim, cpu.client_update_similarity(steps=2),
                               rtol=1e-4, atol=2e-5)
    assert np.abs(sim - sim.T).max() <= 1e-5
    assert np.abs(np.diag(sim) - 1.0).max() <= 1e-4
    rep, ref = card.evaluate_per_client(), cpu.evaluate_per_client()
    for key in ("per_client_loss", "per_client_acc", "weighted_acc"):
        np.testing.assert_allclose(rep[key], ref[key], rtol=1e-4, atol=2e-5)
    clustered = ClusteredLearner(card)
    labels = clustered.cluster_and_specialize(warmup_rounds=1, sim_steps=2)
    assert len(set(labels[:4])) == 1 and len(set(labels[4:])) == 1
    assert labels[0] != labels[4]
    clustered.fit(rounds=1)
    assert all(c.device.type == "cuda" for c in clustered.clusters)
    assert np.isfinite(clustered.evaluate_per_client()["weighted_loss"])


def test_fit_records_on_the_card_carry_memory_and_eval_time(cuda):
    """On the card a record carries ``hbm_used_gb`` (the memory allocated
    after the round) and, on evaluated rounds, ``phase_eval_s``."""
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner

    hist = FederatedLearner(_mlp_config(rounds=2), device=cuda).fit()
    for rec in hist:
        assert rec["hbm_used_gb"] >= 0.0 and rec["phase_eval_s"] > 0.0
        assert rec["phase_update_s"] <= rec["round_time_s"]


def test_traced_round_on_the_card_times_the_card(cuda, tmp_path):
    """A traced engine round on the card: the trace holds the round's
    spans, ``client_update`` is ``phase_update_s`` to the trace's
    microsecond, and the traced records carry the untraced keys and
    ``flops_per_round``, with the same losses (tracing adds no work to
    the round)."""
    from colearn_federated_learning_tpu_torch import telemetry
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner

    cfg = _mlp_config(rounds=2)
    plain = FederatedLearner(cfg, device=cuda).fit()
    traced_cfg = cfg.replace(run=dataclasses.replace(
        cfg.run, trace_dir=str(tmp_path), trace_rounds=1))
    learner = FederatedLearner(traced_cfg, device=cuda)
    hist = learner.fit()
    spans = telemetry.trace_spans(telemetry.load_trace(
        learner.last_trace_path))
    assert sorted(s.name for s in spans) == [
        "client_update", "evaluate", "round", "sync_metrics"]
    update = next(s for s in spans if s.name == "client_update")
    assert abs(update.duration_s - hist[0]["phase_update_s"]) < 1e-6
    # Traced records carry the round's FLOPs too, as JAX's do.
    assert [sorted(set(r) - {"flops_per_round"}) for r in hist] == [
        sorted(r) for r in plain]
    assert all(r["flops_per_round"] > 0 for r in hist)
    assert [r["train_loss"] for r in hist] == [r["train_loss"]
                                               for r in plain]


# ---------------------------------------------------------------- fold (B4)
FOLD_SIZES = [4096, 37, 1, 12345, 768, 6]


def _fold_batch(rng, sizes, rows, vdt, frac=0.2):
    """``rows`` sparse contributions over ``sizes``: unique sorted indices,
    int8 or float32 values, per-slot scales, float32 weights."""
    batch = []
    for _ in range(rows):
        slots = []
        for n in sizes:
            k = max(1, int(n * frac))
            idx = np.sort(rng.choice(n, k, replace=False)).astype(np.int64)
            if vdt == np.int8:
                vals = rng.integers(-127, 128, k).astype(np.int8)
                scale = np.float32(rng.uniform(1e-4, 1e-2))
            else:
                vals = rng.standard_normal(k).astype(np.float32)
                scale = np.float32(1.0)
            slots.append((idx, vals, scale))
        batch.append((np.float32(rng.uniform(1.0, 300.0)), slots))
    return batch


def _bits(t):
    return t.detach().cpu().contiguous().view(torch.int32)


@pytest.mark.parametrize("vdt", [np.int8, np.float32])
def test_fold_sparse_kernel_is_bitwise_its_plain_version(cuda, vdt):
    rng = np.random.default_rng(5)
    batch = _fold_batch(rng, FOLD_SIZES, 5, vdt)
    # A -0.0 assigned by the first contribution at an index no later one
    # touches must survive.
    if vdt == np.float32:
        batch[0][1][0][1][0] = -0.0
        for _, slots in batch[1:]:
            idx, vals, s = slots[0]
            keep = idx != batch[0][1][0][0][0]
            slots[0] = (idx[keep], vals[keep], s)
    card, host = fold.FoldKernel(FOLD_SIZES, cuda), fold.FoldKernel(
        FOLD_SIZES, "cpu")
    fold.reset_launches()
    got = card.fold_sparse(None, batch)
    torch.cuda.synchronize()
    assert fold.launches["fold_sparse"] == len(batch)
    want = host.fold_sparse(None, batch)
    assert torch.equal(_bits(got), _bits(want))
    # Folding on into a given accumulator adds, in order.
    more = _fold_batch(rng, FOLD_SIZES, 3, vdt)
    assert torch.equal(_bits(card.fold_sparse(got, more)),
                       _bits(host.fold_sparse(want, more)))


# The tile plan's edge cases (tests/test_torch_port_fold.py PLAN_CASES):
# entries per slot of each contribution over EDGE_SIZES.
EDGE_SIZES = [5000, 0, 3, 2049, 1, 70, 70, 9000, 2048]
EDGE_CASES = {
    "unaligned_runs": [[1234, 0, 3, 2049, 1, 17, 70, 4001, 2048]],
    "empty_slots": [[5000, 0, 0, 1, 0, 0, 70, 0, 1]],
    "empty_contribution": [[0] * 9, [3, 0, 1, 5, 0, 0, 0, 9, 0], [0] * 9],
    "one_entry": [[0, 0, 0, 0, 1, 0, 0, 0, 0]],
    "whole_tiles": [[2048, 0, 0, 2048, 0, 0, 0, 2048, 2048]],
}


def _edge_batch(rng, counts, vdt):
    batch = []
    for row in counts:
        slots = []
        for n, c in zip(EDGE_SIZES, row):
            idx = np.sort(rng.choice(n, c, replace=False)).astype(np.int32)
            vals = (rng.integers(-127, 128, c).astype(np.int8)
                    if vdt == np.int8
                    else rng.standard_normal(c).astype(np.float32))
            slots.append((idx, vals, np.float32(rng.uniform(1e-4, 1e-2))))
        batch.append((np.float32(rng.uniform(1.0, 300.0)), slots))
    return batch


@pytest.mark.parametrize("vdt", [np.int8, np.float32])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_fold_sparse_kernel_edge_cases_are_bitwise(cuda, vdt, case):
    """Empty slots, empty contributions, a one-entry contribution, runs
    starting anywhere in a tile: from zeros and onto an accumulator, one
    launch per contribution, bitwise the plain version."""
    rng = np.random.default_rng(7)
    batch = _edge_batch(rng, EDGE_CASES[case] * 2, vdt)
    card = fold.FoldKernel(EDGE_SIZES, cuda)
    host = fold.FoldKernel(EDGE_SIZES, "cpu")
    fold.reset_launches()
    got = card.fold_sparse(None, batch)
    got = card.fold_sparse(got, batch[:1])
    torch.cuda.synchronize()
    assert fold.launches["fold_sparse"] == len(batch) + 1
    want = host.fold_sparse(host.fold_sparse(None, batch), batch[:1])
    assert torch.equal(_bits(got), _bits(want))
    # A staged batch folds the same, with no wait across streams.
    st = card.stage_sparse(batch)
    assert torch.equal(_bits(card.fold_sparse_staged(None, st)),
                       _bits(host.fold_sparse(None, batch)))


def test_fold_sparse_shared_kernel_on_two_threads_is_bitwise(cuda):
    """Two threads folding their own batches through one cached kernel
    (an aggregator tree's tiers in one process): each result is bitwise
    its plain version and every contribution launched once."""
    import threading

    rng = np.random.default_rng(8)
    batches = [_fold_batch(rng, FOLD_SIZES, 6, vdt)
               for vdt in (np.int8, np.float32)]
    card = fold.get_kernel(FOLD_SIZES, cuda)
    host = fold.FoldKernel(FOLD_SIZES, "cpu")
    fold.reset_launches()
    out = [None, None]

    def work(i):
        acc = None
        for _ in range(3):
            acc = card.fold_sparse(acc, batches[i])
        torch.cuda.current_stream().synchronize()
        out[i] = acc

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    torch.cuda.synchronize()
    assert fold.launches["fold_sparse"] == 2 * 3 * 6
    for i, batch in enumerate(batches):
        want = None
        for _ in range(3):
            want = host.fold_sparse(want, batch)
        assert torch.equal(_bits(out[i]), _bits(want))
    fold.clear_kernel_cache()


@pytest.mark.parametrize("sizes", [FOLD_SIZES, [4096, 8, 12]])
def test_fold_dense_kernel_is_bitwise_its_plain_version(cuda, sizes):
    rng = np.random.default_rng(6)
    batch = [[rng.standard_normal(n).astype(np.float32) for n in sizes]
             for _ in range(4)]
    card, host = fold.FoldKernel(sizes, cuda), fold.FoldKernel(sizes, "cpu")
    fold.reset_launches()
    got = card.fold_dense(None, batch)
    got = card.fold_dense(got, batch[:2])
    torch.cuda.synchronize()
    assert fold.launches["fold_dense"] == 2
    want = host.fold_dense(host.fold_dense(None, batch), batch[:2])
    assert torch.equal(_bits(got), _bits(want))


def test_streaming_folder_on_the_card_is_bitwise_the_host_fold(cuda):
    from colearn_federated_learning_tpu_torch.comm.aggregation import (
        StreamingFolder)
    from colearn_federated_learning_tpu_torch.fed import compression
    from colearn_federated_learning_tpu_torch.utils import trees

    shapes = {"a": {"kernel": np.zeros((64, 32), np.float32),
                    "bias": np.zeros(32, np.float32)},
              "b": {"scale": np.zeros(7, np.float32)}}
    folds = []
    for device_fold in (False, True):
        f = StreamingFolder(shapes, order=[str(i) for i in range(5)],
                            device_fold=device_fold, device=cuda)
        for i, scheme in enumerate(["topk8", "topk", "none", "topk8",
                                    "int8"]):
            d = trees.map_leaves(lambda w: np.random.default_rng(
                40 + i).standard_normal(w.shape).astype(np.float32), shapes)
            wire, meta = compression.compress_delta(d, scheme,
                                                    topk_fraction=0.1)
            f.add({"client_id": str(i), "weight": 1.0 + i, **meta}, wire)
        f.finalize()
        folds.append(f)
    host, dev = folds
    assert host.total_w == dev.total_w
    assert ([l.tobytes() for l in trees.leaves(host.wsum)]
            == [l.tobytes() for l in trees.leaves(dev.wsum)])


@pytest.mark.parametrize("schemes", [("topk8", "topk8", "topk8"),
                                     ("none", "none", "none")],
                         ids=["fold_sparse", "fold_dense"])
def test_fold_kernels_at_a_tp2_slot_layout_are_bitwise(cuda, schemes):
    """The sharded server's slot layout (one slot per shard, two positions
    on the one card): each B4 kernel at that layout is bitwise its plain
    version there, and the placed mean is the replicated card fold's."""
    from colearn_federated_learning_tpu_torch.comm.aggregation import (
        StreamingFolder)
    from colearn_federated_learning_tpu_torch.fed import compression
    from colearn_federated_learning_tpu_torch.parallel import partition
    from colearn_federated_learning_tpu_torch.utils import trees

    shapes = {"TransformerBlock_0": {
        "Dense_0": {"kernel": np.zeros((64, 256), np.float32),
                    "bias": np.zeros(256, np.float32)},
        "Dense_1": {"kernel": np.zeros((256, 64), np.float32)},
        "LayerNorm_0": {"scale": np.zeros(64, np.float32)}}}
    placement = partition.make_server_placement(
        shapes, 2, "model", "bert", devices=[cuda, cuda])
    assert placement is not None
    updates = []
    for i, scheme in enumerate(schemes):
        d = trees.map_leaves(lambda w: np.random.default_rng(
            60 + i).standard_normal(w.shape).astype(np.float32), shapes)
        wire, meta = compression.compress_delta(d, scheme, topk_fraction=0.1)
        updates.append(({"client_id": str(i), "weight": 1.0 + i, **meta},
                        wire))
    means = []
    for pl, dev in ((placement, cuda), (placement, "cpu"), (None, cuda)):
        f = StreamingFolder(shapes, order=["0", "1", "2"], placement=pl,
                            device_fold=True, device=dev)
        for meta, wire in updates:
            f.add(dict(meta), wire)
        fold.reset_launches()
        means.append(partition.host_tree(f.mean()[0]))
        if dev == "cpu":
            assert sum(fold.launches.values()) == 0
        else:
            torch.cuda.synchronize()
            assert fold.launches == (
                {"fold_sparse": 3, "fold_dense": 0}
                if schemes[0] == "topk8" else
                {"fold_sparse": 0, "fold_dense": 1})
    for other in means[1:]:
        assert [l.tobytes() for l in trees.leaves(other)] == [
            l.tobytes() for l in trees.leaves(means[0])]


def test_fold_rejects_an_index_outside_its_slot(cuda):
    k = fold.FoldKernel([8, 4], cuda)
    bad = [(np.float32(1.0), [(np.array([1], np.int64),
                               np.ones(1, np.float32), np.float32(1.0)),
                              (np.array([4], np.int64),
                               np.ones(1, np.float32), np.float32(1.0))])]
    with pytest.raises(IndexError, match="slot 1"):
        k.fold_sparse(None, bad)


def _bert_small(remat, attn_impl="flash"):
    return ModelConfig(name="bert", num_classes=4, width=128, depth=2,
                       num_heads=2, seq_len=64, vocab_size=500,
                       dtype="bfloat16", attn_impl=attn_impl, remat=remat)


def test_remat_on_the_card_gives_the_same_grads_and_recomputes_k1(cuda):
    """A bf16 BERT with the flash core: remat's grads are the plain run's
    (the recomputed forward runs the same kernels on the same inputs), and
    K1 launches once per block in the forward and once more per block in
    the backward's recomputation; K2 and K3 once per block."""
    from colearn_federated_learning_tpu_torch.fed import losses
    from colearn_federated_learning_tpu_torch.utils import prng

    g = torch.Generator().manual_seed(0)
    ids = torch.randint(1, 500, (8, 64), generator=g)
    ids[0, 40:] = 0
    ids, y = ids.to(cuda), torch.randint(0, 4, (8,), generator=g).to(cuda)
    out = {}
    for remat in (False, True):
        model = registry.build_model(_bert_small(remat), cuda,
                                     generator=prng.init_generator(0))
        A.reset_launches()
        loss = losses.softmax_cross_entropy(model(ids), y)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        out[remat] = (float(loss.detach()), grads, dict(A.launches))
    assert out[False][0] == out[True][0]
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)
    assert out[False][2] == {"flash_forward": 2, "flash_backward_dq": 2,
                             "flash_backward_dkv": 2}
    assert out[True][2] == {"flash_forward": 4, "flash_backward_dq": 2,
                            "flash_backward_dkv": 2}


def test_world1_nccl_mesh_round_equals_the_single_device_round(cuda,
                                                                tmp_path):
    """The client-mesh round at world size 1 on NCCL (a FileStore in the
    test's directory): its all-reduces run, and the round equals the
    single-device round on the same config and draws."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from colearn_federated_learning_tpu_torch.fed import FederatedLearner
    from colearn_federated_learning_tpu_torch.parallel import collectives

    cfg = _mlp_config(cohort_size=4)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("clients",))
        meshed = FederatedLearner(cfg, mesh=mesh)
        plain = FederatedLearner(cfg, device=cuda)
        # One device of the mesh samples its cohort with its own stream;
        # hand both learners that cohort.
        plain.draws.cohort = lambda r, counts, k: \
            meshed.draws.device_cohort(r, 0, counts, k)
        collectives.reset_counts()
        a, b = meshed.run_round(), plain.run_round()
        assert dict(collectives.counts) == {"all_reduce": 3}
        assert a["train_loss"] == pytest.approx(b["train_loss"], rel=1e-6)
        for k, v in meshed.params.items():
            _close(v.cpu(), plain.params[k].cpu(), 1e-6)
    finally:
        dist.destroy_process_group()


def test_socket_round_with_the_device_fold_on_the_card(cuda, monkeypatch):
    """A broker, 3 workers and a coordinator with ``fold_device`` (topk8
    uplinks), all on the card: the round completes, the fold kernel
    launches once per contribution, and the new params are the old plus
    the host fold's mean of the same updates, bit for bit."""
    from colearn_federated_learning_tpu_torch.comm import aggregation
    from colearn_federated_learning_tpu_torch.comm import coordinator
    from colearn_federated_learning_tpu_torch.comm.broker import MessageBroker
    from colearn_federated_learning_tpu_torch.comm.downlink import host_params
    from colearn_federated_learning_tpu_torch.comm.worker import DeviceWorker
    from colearn_federated_learning_tpu_torch.utils import config, trees

    cfg = config.ExperimentConfig(
        data=config.DataConfig(dataset="mnist_tiny", num_clients=3),
        model=config.ModelConfig(name="mlp", num_classes=10, hidden_dim=32,
                                 depth=2),
        fed=config.FedConfig(rounds=1, local_steps=2, batch_size=16, lr=0.1,
                             compress="topk8"),
        run=config.RunConfig(fold_device=True))
    staged = []

    class Recording(aggregation.StreamingFolder):
        def add(self, meta, delta, weight=None):
            staged.append((dict(meta), delta))
            return super().add(meta, delta, weight)

    monkeypatch.setattr(coordinator, "StreamingFolder", Recording)
    with MessageBroker() as b:
        workers = [DeviceWorker(cfg, i, b.host, b.port).start()
                   for i in range(3)]
        try:
            with coordinator.FederatedCoordinator(
                    cfg, b.host, b.port, want_evaluator=False) as coord:
                coord.enroll(3, timeout=60.0)
                before = host_params(coord.params_tree())
                fold.reset_launches()
                rec = coord.run_round()
                after = host_params(coord.params_tree())
        finally:
            for w in workers:
                w.stop()
    assert fold.launches["fold_sparse"] == 3
    assert rec["completed"] == 3 and not rec["dropped"]
    host = aggregation.StreamingFolder(before, order=["0", "1", "2"])
    for meta, delta in staged:
        host.add(meta, delta)
    mean, _, _ = host.mean()
    for b0, m, a in zip(trees.leaves(before), trees.leaves(mean),
                        trees.leaves(after)):
        assert np.array_equal((b0 + m).astype(np.float32), a)


def test_tree_round_with_the_device_fold_on_the_card(cuda, monkeypatch):
    """A broker, 4 workers, 2 aggregators and a coordinator, every fold on
    the card (topk8 uplinks): ``fold_sparse`` launches once per
    contribution on the aggregators, ``fold_dense`` once on the root over
    the 2 partials, and the new params are the old plus the mean of the
    host's slice-blocked fold of the same updates, bit for bit."""
    from colearn_federated_learning_tpu_torch.comm import aggregation
    from colearn_federated_learning_tpu_torch.comm import aggregator
    from colearn_federated_learning_tpu_torch.comm import coordinator
    from colearn_federated_learning_tpu_torch.comm.broker import MessageBroker
    from colearn_federated_learning_tpu_torch.comm.downlink import host_params
    from colearn_federated_learning_tpu_torch.comm.worker import DeviceWorker
    from colearn_federated_learning_tpu_torch.utils import config, trees

    cfg = config.ExperimentConfig(
        data=config.DataConfig(dataset="mnist_tiny", num_clients=4),
        model=config.ModelConfig(name="mlp", num_classes=10, hidden_dim=32,
                                 depth=2),
        fed=config.FedConfig(rounds=1, local_steps=2, batch_size=16, lr=0.1,
                             compress="topk8"),
        run=config.RunConfig(fold_device=True, num_aggregators=2))
    staged = []

    class Recording(aggregation.StreamingFolder):
        def add(self, meta, delta, weight=None):
            staged.append((dict(meta), delta))
            return super().add(meta, delta, weight)

    monkeypatch.setattr(aggregator, "StreamingFolder", Recording)
    with MessageBroker() as b:
        workers = [DeviceWorker(cfg, i, b.host, b.port).start()
                   for i in range(4)]
        aggs = [aggregator.AggregatorServer(cfg, a, b.host, b.port).start()
                for a in range(2)]
        try:
            with coordinator.FederatedCoordinator(
                    cfg, b.host, b.port, want_evaluator=False) as coord:
                coord.enroll(4, timeout=60.0)
                coord.enroll_aggregators(timeout=60.0)
                order = [d.device_id for d in coord.trainers]
                before = host_params(coord.params_tree())
                fold.reset_launches()
                rec = coord.run_round()
                after = host_params(coord.params_tree())
        finally:
            for a in aggs:
                a.stop()
            for w in workers:
                w.stop()
    assert fold.launches == {"fold_sparse": 4, "fold_dense": 1}
    assert rec["completed"] == 4 and rec["aggregators"] == 2
    assert not rec["dropped"]
    host = aggregation.StreamingFolder(
        before, order=order, slices=aggregator.slice_cohort(order, 2))
    for meta, delta in staged:
        host.add(meta, delta)
    mean, _, _ = host.mean()
    for b0, m, a in zip(trees.leaves(before), trees.leaves(mean),
                        trees.leaves(after)):
        assert np.array_equal((b0 + m).astype(np.float32), a)


def test_async_aggregation_with_the_device_fold_on_the_card(cuda,
                                                            monkeypatch):
    """A broker, 3 workers and the asynchronous coordinator with
    ``fold_device`` (topk8 uplinks, K = 3 = trainers), all on the card: one
    aggregation folds one fresh update per trainer, ``fold_sparse``
    launches once per update, and the new params are the old plus the host
    fold's mean of the same updates (arrival-keyed), bit for bit."""
    from colearn_federated_learning_tpu_torch.comm import aggregation
    from colearn_federated_learning_tpu_torch.comm import async_coordinator
    from colearn_federated_learning_tpu_torch.comm.broker import MessageBroker
    from colearn_federated_learning_tpu_torch.comm.downlink import host_params
    from colearn_federated_learning_tpu_torch.comm.worker import DeviceWorker
    from colearn_federated_learning_tpu_torch.utils import config, trees

    cfg = config.ExperimentConfig(
        data=config.DataConfig(dataset="mnist_tiny", num_clients=3),
        model=config.ModelConfig(name="mlp", num_classes=10, hidden_dim=32,
                                 depth=2),
        fed=config.FedConfig(rounds=1, local_steps=2, batch_size=16, lr=0.1,
                             compress="topk8"),
        run=config.RunConfig(fold_device=True))
    staged = []

    class Recording(aggregation.StreamingFolder):
        def add(self, meta, delta, weight=None):
            staged.append((dict(meta), delta, weight))
            return super().add(meta, delta, weight)

    monkeypatch.setattr(async_coordinator, "StreamingFolder", Recording)
    with MessageBroker() as b:
        workers = [DeviceWorker(cfg, i, b.host, b.port).start()
                   for i in range(3)]
        try:
            with async_coordinator.AsyncFederatedCoordinator(
                    cfg, b.host, b.port, buffer_size=3,
                    want_evaluator=False) as coord:
                coord.enroll(3, timeout=60.0)
                before = host_params(coord.params_tree())
                fold.reset_launches()
                rec = coord.run_aggregation()
                after = host_params(coord.params_tree())
                launches = dict(fold.launches)
        finally:
            for w in workers:
                w.stop()
    assert launches == {"fold_sparse": 3, "fold_dense": 0}
    assert sorted(rec["contributors"]) == ["0", "1", "2"]
    assert rec["staleness_max"] == 0
    host = aggregation.StreamingFolder(before)
    for meta, delta, weight in staged:
        host.add(meta, delta, weight)
    mean, _, _ = host.mean()
    for b0, m, a in zip(trees.leaves(before), trees.leaves(mean),
                        trees.leaves(after)):
        assert np.array_equal((b0 + m).astype(np.float32), a)


# ----------------------------------------------------------------- LoRA
def _lora_update(model, device, base, factors, x, y, idx):
    """One factor-only local update (SGD, 3 steps, rank 4, alpha 16) of
    ``model`` on ``device``."""
    from colearn_federated_learning_tpu_torch.fed import local
    from colearn_federated_learning_tpu_torch.utils import trees

    update = local.make_lora_local_update(
        model, local.make_optimizer(0.05, 0.0, "sgd"), 3, rank=4,
        alpha=16.0, num_heads=2)
    res = update([t.to(device) for t in base],
                 trees.map_leaves(lambda t: t.to(device), factors),
                 x.to(device), y.to(device), x.shape[0], idx.to(device), 3)
    return [d.cpu() for d in res.delta], float(res.mean_loss)


def test_lora_local_update_on_the_card_matches_the_cpu(cuda):
    """The factor-only trainer on the card (K1-K3 in bf16, their gradients
    flowing into the query/key/value/out factors) against the same update
    on the CPU (the plain attention): the deltas within 5 % of their norm
    and the losses within 2e-2, bf16 rounding at other points on each
    side."""
    from colearn_federated_learning_tpu_torch import convert
    from colearn_federated_learning_tpu_torch.fed import lora

    cfg = _bert_small(remat=False)
    host = registry.build_model(cfg, "cpu",
                                generator=torch.Generator().manual_seed(1))
    card = registry.build_model(cfg, cuda)
    card.load_state_dict(host.state_dict())
    base = [p.detach().clone() for p in host.parameters()]
    flax = convert.state_dict_to_flax(
        {n: p.detach() for n, p in host.named_parameters()}, num_heads=2)
    factors = lora.init_factors(flax, 4, generator=torch.Generator()
                                .manual_seed(2), model_name="bert")
    g = torch.Generator().manual_seed(3)
    for _, b in lora.factor_index(factors).values():
        b.copy_(0.05 * torch.randn(b.shape, generator=g))
    x = torch.randint(0, cfg.vocab_size, (24, cfg.seq_len), generator=g,
                      dtype=torch.int32)
    y = torch.randint(0, cfg.num_classes, (24,), generator=g)
    idx = torch.randint(0, 24, (3, 8), generator=g)
    A.reset_launches()
    got, got_loss = _lora_update(card, cuda, base, factors, x, y, idx)
    torch.cuda.synchronize()
    assert A.launches == {"flash_forward": 2 * 3, "flash_backward_dq": 2 * 3,
                          "flash_backward_dkv": 2 * 3}
    want, want_loss = _lora_update(host, "cpu", base, factors, x, y, idx)
    assert abs(got_loss - want_loss) <= 2e-2
    num = sum(float((a - b).square().sum()) for a, b in zip(got, want))
    den = sum(float(b.square().sum()) for b in want)
    assert den > 0 and num <= 0.05 ** 2 * den


def test_fold_at_the_lora_factor_layout_is_bitwise_its_plain_version(cuda):
    """``fold_dense`` of 3 factor updates and of 2 partials and
    ``fold_sparse`` of topk8 factor updates at a BERT factor layout (rank
    8: (m, 8) and (8, n) slots), card against CPU bit for bit."""
    from colearn_federated_learning_tpu_torch import convert
    from colearn_federated_learning_tpu_torch.fed import lora
    from colearn_federated_learning_tpu_torch.utils import trees

    cfg = _bert_small(remat=False)
    model = registry.build_model(cfg, "cpu",
                                 generator=torch.Generator().manual_seed(1))
    flax = convert.state_dict_to_flax(
        {n: p.detach() for n, p in model.named_parameters()}, num_heads=2)
    sizes = [l.numel() for l in trees.leaves(
        lora.init_factors(flax, 8, model_name="bert"))]
    card, host = fold.FoldKernel(sizes, cuda), fold.FoldKernel(sizes, "cpu")
    rng = np.random.default_rng(8)
    fold.reset_launches()
    for rows in (3, 2):
        batch = [[rng.standard_normal(n).astype(np.float32) for n in sizes]
                 for _ in range(rows)]
        assert torch.equal(_bits(card.fold_dense(None, batch)),
                           _bits(host.fold_dense(None, batch)))
    batch = _fold_batch(rng, sizes, 4, np.int8, frac=0.05)
    assert torch.equal(_bits(card.fold_sparse(None, batch)),
                       _bits(host.fold_sparse(None, batch)))
    torch.cuda.synchronize()
    assert fold.launches == {"fold_sparse": 4, "fold_dense": 2}


def test_checkpoints_of_card_tensors_round_trip_bitwise(cuda, tmp_path):
    """Both checkpointers read card tensors (a bf16 one, and a transposed
    view as the flax layout gives them) leaf by leaf and restore each
    leaf onto the card bit for bit; the streaming restore's digest is
    ``load_generation_host``'s."""
    from colearn_federated_learning_tpu_torch.ckpt import (
        RoundCheckpointer, StreamingCheckpointer, load_generation_host)

    g = torch.Generator().manual_seed(5)
    w = torch.randn(48, 32, generator=g).to(cuda)
    state = ({"Dense_0": {"kernel": w.T, "bias": torch.randn(
        48, generator=g).to(cuda)},
        "Embed_0": {"embedding": torch.randn(
            64, 16, generator=g).to(torch.bfloat16).to(cuda)}},
        np.zeros(3), 4)
    zeros = ({k: {n: torch.zeros_like(t) for n, t in v.items()}
              for k, v in state[0].items()}, np.ones(3), 0)
    for ck in (StreamingCheckpointer(str(tmp_path / "s")),
               RoundCheckpointer(str(tmp_path / "r"))):
        ck.save(2, state, [{"round": 0}, {"round": 1}])
        got, hist, step = ck.restore(zeros)
        assert step == 2 and len(hist) == 2 and got[2] == 4
        for k, v in state[0].items():
            for n, t in v.items():
                r = got[0][k][n]
                assert r.device.type == "cuda" and r.dtype == t.dtype
                assert torch.equal(r.view(torch.int16) if r.dtype
                                   == torch.bfloat16 else r,
                                   t.contiguous().view(torch.int16)
                                   if t.dtype == torch.bfloat16 else t)
    ck = StreamingCheckpointer(str(tmp_path / "s"))
    ck.restore(zeros)
    _, _, digest = load_generation_host(str(tmp_path / "s"))
    assert ck.last_restore_digest == digest


def test_engine_resume_on_the_card_is_bitwise(cuda, tmp_path):
    """The f32 MLP on the card, 3 rounds straight against 1 round, a
    checkpoint, a fresh learner's restore and 2 more: the same params
    bit for bit."""
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner

    cfg = _mlp_config()
    ck = cfg.replace(run=dataclasses.replace(
        cfg.run, checkpoint_dir=str(tmp_path)))
    straight = FederatedLearner(cfg, device=cuda)
    straight.fit()
    first = FederatedLearner(ck, device=cuda)
    first.fit(rounds=1)
    resumed = FederatedLearner(ck, device=cuda)
    assert resumed.restore_checkpoint() == 1
    resumed.fit()
    assert len(resumed.history) == 3
    for name, t in straight.params.items():
        assert torch.equal(t, resumed.params[name]), name


def test_memory_gauges_read_the_cards_allocator(cuda):
    """``sample_device_memory`` on the card: the allocator's bytes in use
    (at least a fresh 64 MiB tensor's), its peak and the card's total,
    set as the ``runtime.hbm_*`` gauges; without a device argument it
    reads the current card once CUDA is initialised."""
    from colearn_federated_learning_tpu_torch.telemetry import runtime
    from colearn_federated_learning_tpu_torch.telemetry.registry import (
        MetricsRegistry)

    x = torch.empty(16 * 2**20, dtype=torch.float32, device=cuda)
    reg = MetricsRegistry()
    stats = runtime.sample_device_memory(registry=reg, device=cuda)
    assert stats["bytes_in_use"] >= x.numel() * 4
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"]
    assert stats["bytes_limit"] == torch.cuda.mem_get_info(cuda)[1]
    snap = reg.snapshot()
    assert snap["runtime.hbm_bytes_in_use"] == stats["bytes_in_use"]
    assert snap["runtime.hbm_bytes_limit"] == stats["bytes_limit"]
    assert snap["runtime.hbm_peak_bytes_in_use"] == \
        stats["peak_bytes_in_use"]
    assert runtime.sample_device_memory(registry=MetricsRegistry())[
        "bytes_limit"] == stats["bytes_limit"]
    assert runtime.sample_device_memory(device="cpu") == {}
    del x


def _bert_engine_config(**run_kw):
    from colearn_federated_learning_tpu_torch.utils import config

    return config.ExperimentConfig(
        data=config.DataConfig(dataset="agnews_tiny", num_clients=4,
                               partition="iid"),
        model=dataclasses.replace(_bert_small(False), vocab_size=2000),
        fed=config.FedConfig(strategy="fedavg", rounds=3, cohort_size=2,
                             local_steps=2, batch_size=8, lr=1e-3,
                             momentum=0.0, local_optimizer="adam"),
        run=config.RunConfig(name="card_bert", **run_kw))


def test_profiler_window_holds_the_cards_flash_kernels(cuda, tmp_path):
    """``profile_dir`` on the card: one Chrome trace of rounds 1..2 whose
    CUDA kernel events hold K1, K2 and K3 once per block and step of
    those rounds, as the launch counters do."""
    import json
    import math
    import os

    from colearn_federated_learning_tpu_torch.fed import FederatedLearner

    cfg = _bert_engine_config(profile_dir=str(tmp_path), eval_every=10)
    ln = FederatedLearner(cfg, device=cuda)
    ln.fit(rounds=1)                    # round 0: outside the window
    A.reset_launches()
    ln.fit(rounds=2)                    # rounds 1 and 2
    files = os.listdir(tmp_path)
    assert len(files) == 1 and "_profile_rounds1-2_" in files[0]
    with open(os.path.join(tmp_path, files[0])) as f:
        events = json.load(f)["traceEvents"]
    count = {}
    for ev in events:
        if ev.get("cat") != "kernel":
            continue
        for name in ("flash_fwd_bf16_kernel", "flash_dq_bf16_kernel",
                     "flash_dkv_bf16_kernel"):
            if name in ev.get("name", ""):
                count[name] = count.get(name, 0) + 1
    steps = 2 * ln.cohort_size * ln.num_steps
    depth = cfg.model.depth
    # The window closes after round 2's device work, before its
    # evaluation (JAX's order): K1 holds the training steps alone, and
    # the evaluation's launches are the counters' difference.
    assert count == {"flash_fwd_bf16_kernel": depth * steps,
                     "flash_dq_bf16_kernel": depth * steps,
                     "flash_dkv_bf16_kernel": depth * steps}
    evals = math.ceil(len(ln.dataset.x_test) / 64)
    assert A.launches["flash_forward"] == depth * (steps + evals)
    assert count["flash_dq_bf16_kernel"] == A.launches["flash_backward_dq"]


def test_flops_per_round_on_the_card_equal_the_cpus(cuda):
    """The FLOP count is the counter's on the matmuls plus the flash
    kernels' formula: the same on the card as on the CPU."""
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner

    cfg = _bert_engine_config()
    got = FederatedLearner(cfg, device=cuda).round_cost_analysis()
    want = FederatedLearner(cfg, device="cpu").round_cost_analysis()
    assert got == want


def test_personalized_evaluation_on_the_card_matches_the_cpu(cuda):
    """The f32 MLP: one round, then the fine-tune-then-score probe on the
    card and on the CPU with the same draws.  The per-client accuracies
    are equal, or off by one example on at most one client (cuBLAS and
    the CPU round the f32 products differently, which can move a
    boundary example); the example counts are equal."""
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner

    reps = []
    for device in (cuda, "cpu"):
        ln = FederatedLearner(_mlp_config(), device=device)
        ln.run_round()
        reps.append(ln.evaluate_personalized(steps=3))
    card, cpu = reps
    n = cpu["num_eval_examples"]
    np.testing.assert_array_equal(card["num_eval_examples"], n)
    assert card["num_clients_evaluated"] == cpu["num_clients_evaluated"] == 8
    for key in ("per_client_global_acc", "per_client_personalized_acc"):
        off = np.rint(np.abs(card[key] - cpu[key]) * n).astype(int)
        assert off.max() <= 1 and (off > 0).sum() <= 1, (key, off)


# ------------------------------------------------ N1 (top-k) and N2 (gather)
def _topk_leaf(name: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if name.startswith("normal"):
        return rng.standard_normal(int(name[6:])).astype(np.float32)
    if name == "ties":
        return rng.integers(-3, 4, 100_000).astype(np.float32)
    if name == "zeros":
        return np.zeros(70_000, np.float32)
    if name == "constant":
        return np.full(70_000, -2.5, np.float32)
    if name == "signed_zeros":
        return np.where(rng.random(5_000) < 0.5, np.float32(0.0),
                        np.float32(-0.0)).astype(np.float32)
    x = rng.standard_normal(40_000).astype(np.float32)
    x[::7] = np.float32(1e-40)
    x[3::11] = -np.float32(1e-42)
    x[5], x[9], x[11], x[12] = np.inf, -np.inf, np.nan, -np.float32(np.nan)
    return x


@pytest.mark.parametrize("frac", [None, 0.05, "n-1", 1.0])
@pytest.mark.parametrize("name", ["normal1", "normal7", "normal65539",
                                  "normal1000000", "normal23440896", "ties",
                                  "zeros", "constant", "signed_zeros",
                                  "specials"])
def test_topk_kernel_is_bitwise_its_plain_version(cuda, name, frac):
    from colearn_federated_learning_tpu_torch.ops import topk

    x = torch.from_numpy(_topk_leaf(name))
    n = x.numel()
    k = {None: 1, "n-1": max(n - 1, 1)}.get(frac) or max(
        1, int(np.ceil(n * frac)))
    want_i, want_v = topk.topk_abs_reference(x, k)
    before = topk.launches["topk_abs"]
    got_i, got_v = topk.topk_abs(x.to(cuda), k)
    torch.cuda.synchronize()
    assert topk.launches["topk_abs"] == before + 1
    assert got_i.dtype == torch.int32 and got_v.dtype == torch.float32
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_v.cpu().view(torch.int32), want_v.view(torch.int32))


@pytest.mark.parametrize("scheme", ["topk", "topk8"])
def test_feedback_compression_on_the_card_equals_the_cpu(cuda, scheme):
    """Three rounds of feedback over a tree of card tensors: frames
    byte-equal and residuals bit-equal to the same tree on the CPU."""
    from colearn_federated_learning_tpu_torch.fed import compression
    from colearn_federated_learning_tpu_torch.utils import serialization
    from colearn_federated_learning_tpu_torch.utils import trees

    rng = np.random.default_rng(2)
    shapes = {"a": {"kernel": (300, 40), "bias": (40,)}, "b": (7,),
              "c": {"embedding": (2000, 32)}}
    res_card = res_cpu = None
    for r in range(3):
        tree = trees.map_leaves(lambda s: torch.from_numpy(
            (0.01 * rng.standard_normal(s)).astype(np.float32)), shapes)
        card = trees.map_leaves(lambda t: t.to(cuda), tree)
        wc, mc, res_card = compression.feedback_compress(
            card, res_card, scheme, topk_fraction=0.05)
        wp, mp, res_cpu = compression.feedback_compress(
            tree, res_cpu, scheme, topk_fraction=0.05)
        assert (bytes(serialization.pytree_to_bytes(wc, mc))
                == bytes(serialization.pytree_to_bytes(wp, mp)))
        for a, b in zip(trees.leaves(res_card), trees.leaves(res_cpu)):
            assert a.is_cuda
            assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("dtype,row", [
    (np.uint8, (32, 32, 3)), (np.float32, (28, 28, 1)), (np.int32, (7,)),
    (np.uint8, (3,)), (np.int64, ())])
def test_gather_kernel_is_bitwise_index_select(cuda, dtype, row):
    from colearn_federated_learning_tpu_torch.ops import gather

    rng = np.random.default_rng(4)
    src = torch.from_numpy((rng.integers(0, 120, (5000,) + row)
                            ).astype(dtype))
    idx = torch.from_numpy(rng.integers(0, 5000, 20_000).astype(np.int64))
    before = gather.launches["gather_rows"]
    got = gather.gather_rows(src.to(cuda), idx.to(cuda))
    assert gather.launches["gather_rows"] == before + 1
    assert torch.equal(got.cpu(), gather.gather_rows_reference(src, idx))


def test_gather_kernel_raises_and_writes_nothing_on_a_bad_index(cuda):
    from colearn_federated_learning_tpu_torch.ops import gather

    src = torch.arange(48, dtype=torch.float32, device=cuda).view(12, 4)
    for bad in (-1, 12):
        idx = torch.tensor([0, 3, bad, 5], device=cuda)
        with pytest.raises(IndexError, match="out of range"):
            gather.gather_rows(src, idx)
        out = torch.full((4, 4), 7.0, device=cuda)
        flag = torch.zeros(1, dtype=torch.int32, device=cuda)
        gather.launch(src, idx, out, flag)
        assert int(flag.item()) == 1
        assert torch.equal(out, torch.full((4, 4), 7.0, device=cuda))


def test_engine_pack_on_the_card_equals_the_cpu(cuda):
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner
    from colearn_federated_learning_tpu_torch.ops import gather
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    cfg = get_config("cifar10_cnn_fedavg")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                               dataset="cifar10_tiny",
                                               num_clients=10))
    gather.reset_launches()
    card = FederatedLearner(cfg)
    assert gather.launches["gather_rows"] == 2
    cpu = FederatedLearner(cfg, device="cpu")
    assert torch.equal(card.x.cpu(), cpu.x) and torch.equal(card.y.cpu(),
                                                            cpu.y)
