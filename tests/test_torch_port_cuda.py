"""The flash-attention CUDA kernels (K1-K3) and the fold kernel (B4)
against their plain PyTorch versions (the fold bit for bit), every model family's bf16 logits against the same model in
f32 on the CPU, and the hierarchical sync, update similarity and
per-client evaluation against the CPU, on the card.  Marked ``cuda``: without a CUDA device every
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


def test_fold_rejects_an_index_outside_its_slot(cuda):
    k = fold.FoldKernel([8, 4], cuda)
    bad = [(np.float32(1.0), [(np.array([1], np.int64),
                               np.ones(1, np.float32), np.float32(1.0)),
                              (np.array([4], np.int64),
                               np.ones(1, np.float32), np.float32(1.0))])]
    with pytest.raises(IndexError, match="slot 1"):
        k.fold_sparse(None, bad)
