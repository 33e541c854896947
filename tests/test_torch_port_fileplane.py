"""The port's file plane (``fed/offline.py``, ``fed/compression.py``,
``utils/serialization.py``) against the JAX package's.

- Compression frames are byte-equal to JAX's for every scheme (CLW1 wire
  bytes, ties in the topk selection included), and error feedback
  carries the same residual over rounds.
- Files cross both ways: the port trains, aggregates and evaluates on a
  JAX-written global model, and JAX aggregates and evaluates the port's
  updates and global models.
- ``client_update`` of an MLP (SGD + momentum) and a small BERT (Adam) on
  the same global file and JAX's own batch draws gives JAX's delta at f32
  rtol 1e-4 / atol 2e-5.  BERT's Adam entries are held like the round
  test's (``tests/test_torch_port_round.py``): at least 99.9 % of every
  tensor's entries within that tolerance and every entry within Adam's
  step bound (3 · lr · steps), because Adam's first steps are ±lr whatever
  the gradient's size, so an entry whose gradient sits at Adam's eps (a
  rare token's embedding) moves on roundoff on either side; the
  key-projection biases, whose true gradient is exactly zero, are held to
  the step bound alone.
- ``aggregate_updates`` gives JAX's new global model bit for bit
  (FedAvg: the same f32 products and sums in the same order) and within
  1e-6 (FedAdam: the same arithmetic, checked to roundoff), rejects stale,
  torn and non-positive-weight files with JAX's reasons, and holds the
  same ``min_cohort_fraction`` quorum.
- ``evaluate_global`` gives JAX's loss to 1e-5 and its accuracy.

Everything runs on the CPU at small sizes (the kernels' plain versions).
"""

import dataclasses

import jax
import numpy as np
import pytest

from colearn_federated_learning_tpu.fed import compression as jax_compression
from colearn_federated_learning_tpu.fed import offline as jax_offline
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu.utils import serialization as jax_ser
from colearn_federated_learning_tpu_torch import cli
from colearn_federated_learning_tpu_torch.fed import compression, offline
from colearn_federated_learning_tpu_torch.utils import config, serialization
from colearn_federated_learning_tpu_torch.utils import trees
from tests.test_torch_port_round import JaxDraws

SCHEMES = ["none", "int8", "topk", "topk8"]
RTOL, ATOL, LOSS_TOL, AGREE = 1e-4, 2e-5, 1e-5, 0.999

MODELS = {
    "mlp": (dict(dataset="mnist_tiny", num_clients=4, partition="iid"),
            dict(name="mlp", num_classes=10, hidden_dim=32, depth=2),
            dict(lr=0.05, momentum=0.9, local_optimizer="sgd")),
    "bert": (dict(dataset="agnews_tiny", num_clients=4, partition="iid"),
             dict(name="bert", num_classes=4, width=32, depth=2, num_heads=4,
                  seq_len=64, vocab_size=2000),
             dict(lr=1e-3, momentum=0.0, local_optimizer="adam")),
}


def _configs(model="mlp", **fed):
    data, mdl, base = MODELS[model]
    kw = dict(data=data, model=mdl,
              fed=dict(base, local_steps=3, batch_size=8, cohort_size=2,
                       **fed),
              run=dict(seed=3, name="fileplane"))
    return [mod.ExperimentConfig(
        data=mod.DataConfig(**kw["data"]), model=mod.ModelConfig(**kw["model"]),
        fed=mod.FedConfig(**kw["fed"]), run=mod.RunConfig(**kw["run"]))
        for mod in (jax_config, config)]


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    t = {"Dense_0": {"kernel": rng.standard_normal((40, 24)).astype(np.float32),
                     "bias": rng.standard_normal(24).astype(np.float32)},
         "LayerNorm_0": {"scale": rng.standard_normal(5).astype(np.float32)},
         "pos_embed": rng.standard_normal((1, 3, 4)).astype(np.float32)}
    # Ties in magnitude across the keep boundary: the lower index wins.
    t["Dense_0"]["kernel"][0, :9] = 0.75
    t["Dense_0"]["kernel"][7, :9] = -0.75
    return t


def _bytes(tree):
    return [np.asarray(l).tobytes() for l in trees.leaves(tree)]


def _load(path):
    return serialization.load_pytree_npz(path)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("fraction", [0.01, 0.05, 0.3])
def test_frames_are_byte_equal_to_jax(scheme, fraction):
    tree = _tree()
    ours, ometa = compression.compress_delta(tree, scheme,
                                             topk_fraction=fraction)
    theirs, tmeta = jax_compression.compress_delta(tree, scheme,
                                                   topk_fraction=fraction)
    assert ometa == tmeta
    assert (bytes(serialization.pytree_to_bytes(ours, {"round": 1, **ometa}))
            == bytes(jax_ser.pytree_to_bytes(theirs, {"round": 1, **tmeta})))
    assert _bytes(compression.decompress_delta(ours, ometa, shapes=tree)) \
        == _bytes(jax_compression.decompress_delta(theirs, tmeta,
                                                   shapes=tree))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_feedback_residual_is_jax_residual(scheme):
    ours_res = theirs_res = None
    for r in range(3):
        delta = _tree(seed=10 + r)
        ow, om, ours_res = compression.feedback_compress(
            delta, ours_res, scheme, topk_fraction=0.1)
        tw, tm, theirs_res = jax_compression.feedback_compress(
            delta, theirs_res, scheme, topk_fraction=0.1)
        assert (bytes(serialization.pytree_to_bytes(ow, om))
                == bytes(jax_ser.pytree_to_bytes(tw, tm)))
        if scheme == "none":
            assert ours_res is None and theirs_res is None
        else:
            assert _bytes(ours_res) == _bytes(jax.tree.map(np.asarray,
                                                           theirs_res))


def test_topk_selection_keeps_the_largest_and_breaks_ties_low():
    flat = np.array([0.5, -2.0, 0.5, 1.0, -0.5, 3.0], np.float32)
    idx, val = compression.topk_abs(flat, 4)
    assert idx.dtype == np.int32 and idx.tolist() == [0, 1, 3, 5]
    assert val.tolist() == [0.5, -2.0, 1.0, 3.0]
    with pytest.raises(ValueError, match="out of range"):
        compression.topk_abs(flat, 7)


def _jax_params(path):
    params, meta = jax_ser.load_pytree_npz(path)
    return params, meta


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        f"{prefix}/{k}")]
    return [prefix]


def _assert_delta_close(ours, theirs, step_bound=None):
    for path, a, b in zip(_paths(theirs), trees.leaves(ours),
                          trees.leaves(theirs)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        err = np.abs(a - b)
        ok = err <= ATOL + RTOL * np.abs(b)
        if step_bound is None:
            assert ok.all(), (path, err.max())
            continue
        assert err.max() <= step_bound, path
        if path.endswith("key/bias"):
            # Zero true gradient (a constant added to every key's score
            # cancels in the softmax): Adam trains it on roundoff.
            continue
        assert ok.mean() >= AGREE, (path, ok.mean())


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("model", ["mlp", "bert"])
def test_client_update_matches_jax(model, tmp_path):
    jcfg, tcfg = _configs(model)
    g0 = str(tmp_path / "g0.npz")
    jax_offline.init_global_model(jcfg, g0)
    ju, tu = str(tmp_path / "ju.npz"), str(tmp_path / "tu.npz")
    js = jax_offline.client_update(jcfg, 1, g0, ju)
    ts = offline.client_update(tcfg, 1, g0, tu, device="cpu",
                               draws=JaxDraws(tcfg.run.seed))
    assert ts["weight"] == js["weight"] and ts["round"] == js["round"] == 0
    assert ts["mean_loss"] == pytest.approx(js["mean_loss"], rel=LOSS_TOL,
                                            abs=LOSS_TOL)
    (od, om), (jd, jm) = _load(tu), _jax_params(ju)
    assert om == {**jm, "mean_loss": om["mean_loss"]}
    bound = (3 * tcfg.fed.lr * tcfg.fed.local_steps if model == "bert"
             else None)
    _assert_delta_close(od, jd, bound)


def test_files_cross_between_the_packages(tmp_path):
    """JAX's global model -> the port's topk8 updates -> JAX's aggregate
    and eval; the port's global model -> JAX's client -> the port's
    aggregate and eval."""
    jcfg, tcfg = _configs(compress="topk8", topk_fraction=0.2)
    g0 = str(tmp_path / "g0.npz")
    jax_offline.init_global_model(jcfg, g0)
    ups = []
    for cid in range(2):
        ups.append(str(tmp_path / f"t{cid}.npz"))
        offline.client_update(tcfg, cid, g0, ups[-1], device="cpu")
    g1 = str(tmp_path / "g1.npz")
    agg = jax_offline.aggregate_updates(jcfg, g0, ups, g1)
    assert agg == {"round": 1, "num_updates": 2, "num_rejected": 0,
                   "total_weight": agg["total_weight"]}
    assert np.isfinite(jax_offline.evaluate_global(jcfg, g1)["eval_loss"])

    p0 = str(tmp_path / "p0.npz")
    offline.init_global_model(tcfg, p0, device="cpu")
    params, meta = jax_ser.load_pytree_npz(p0)
    ref, _ = jax_ser.load_pytree_npz(g0)
    assert meta == {"round": 0, "config": "fileplane"}
    assert jax.tree.structure(params) == jax.tree.structure(ref)
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in
               zip(jax.tree.leaves(params), jax.tree.leaves(ref)))
    ju = str(tmp_path / "ju.npz")
    jax_offline.client_update(jcfg, 0, p0, ju)
    p1 = str(tmp_path / "p1.npz")
    assert offline.aggregate_updates(tcfg, p0, [ju], p1,
                                     device="cpu")["num_updates"] == 1
    ours = offline.evaluate_global(tcfg, p1, device="cpu")
    theirs = jax_offline.evaluate_global(jcfg, p1)
    assert ours["round"] == theirs["round"] == 1
    assert ours["eval_loss"] == pytest.approx(theirs["eval_loss"],
                                              rel=LOSS_TOL, abs=LOSS_TOL)
    assert ours["eval_acc"] == pytest.approx(theirs["eval_acc"], abs=1e-6)


@pytest.mark.parametrize("strategy,scheme", [
    ("fedavg", "none"), ("fedavg", "topk8"), ("fedavg", "int8"),
    ("fedadam", "topk")])
def test_aggregate_matches_jax(strategy, scheme, tmp_path):
    jcfg, tcfg = _configs(strategy=strategy, compress=scheme,
                          topk_fraction=0.2, server_lr=0.5)
    g0 = str(tmp_path / "g0.npz")
    jax_offline.init_global_model(jcfg, g0)
    ups = []
    for cid in range(3):
        ups.append(str(tmp_path / f"u{cid}.npz"))
        jax_offline.client_update(jcfg, cid, g0, ups[-1])
    jg, tg = str(tmp_path / "jg.npz"), str(tmp_path / "tg.npz")
    assert (offline.aggregate_updates(tcfg, g0, ups, tg, device="cpu")
            == jax_offline.aggregate_updates(jcfg, g0, ups, jg))
    (ours, om), (theirs, tm) = _load(tg), _jax_params(jg)
    assert om == tm
    if strategy == "fedavg":
        assert _bytes(ours) == _bytes(theirs)
    else:
        for a, b in zip(trees.leaves(ours), trees.leaves(theirs)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_stale_torn_and_weightless_files_are_rejected_as_jax(tmp_path):
    jcfg, tcfg = _configs()
    g0 = str(tmp_path / "g0.npz")
    jax_offline.init_global_model(jcfg, g0)
    good = str(tmp_path / "good.npz")
    jax_offline.client_update(jcfg, 0, g0, good)
    wire, meta = jax_ser.load_pytree_npz(good)
    stale = str(tmp_path / "stale.npz")
    jax_ser.save_pytree_npz(stale, wire, {**meta, "round": 5})
    weightless = str(tmp_path / "weightless.npz")
    jax_ser.save_pytree_npz(weightless, wire, {**meta, "weight": 0.0})
    torn = str(tmp_path / "torn.npz")
    with open(good, "rb") as f:
        data = f.read()
    with open(torn, "wb") as f:
        f.write(data[: len(data) // 2])
    files = [good, stale, torn, weightless]
    jg, tg = str(tmp_path / "jg.npz"), str(tmp_path / "tg.npz")
    ours = offline.aggregate_updates(tcfg, g0, files, tg, device="cpu")
    theirs = jax_offline.aggregate_updates(jcfg, g0, files, jg)
    assert ours == theirs and ours["num_rejected"] == 3
    # The quorum: 1 usable of 4 at min_cohort_fraction 0.5 needs 2.
    jq = jcfg.replace(fed=dataclasses.replace(jcfg.fed,
                                              min_cohort_fraction=0.5))
    tq = tcfg.replace(fed=dataclasses.replace(tcfg.fed,
                                              min_cohort_fraction=0.5))
    with pytest.raises(ValueError) as ours_err:
        offline.aggregate_updates(tq, g0, files, tg, device="cpu")
    with pytest.raises(ValueError) as theirs_err:
        jax_offline.aggregate_updates(jq, g0, files, jg)
    assert str(ours_err.value) == str(theirs_err.value)
    assert "quorum 2" in str(ours_err.value)
    with pytest.raises(ValueError, match="no update files"):
        offline.aggregate_updates(tcfg, g0, [], tg, device="cpu")


def test_feedback_through_files_carries_jax_residual(tmp_path):
    jcfg, tcfg = _configs(compress="topk", compress_feedback=True,
                          topk_fraction=0.1)
    g0 = str(tmp_path / "g0.npz")
    jax_offline.init_global_model(jcfg, g0)
    ju, tu = str(tmp_path / "ju.npz"), str(tmp_path / "tu.npz")
    jr, tr = str(tmp_path / "jr.npz"), str(tmp_path / "tr.npz")
    jax_offline.client_update(jcfg, 2, g0, ju, residual_path=jr)
    offline.client_update(tcfg, 2, g0, tu, residual_path=tr, device="cpu",
                          draws=JaxDraws(tcfg.run.seed))
    (ow, om), (tw, tm) = _load(tu), _jax_params(ju)
    dense = compression.decompress_delta(ow, om, shapes=_load(g0)[0])
    ref = jax_compression.decompress_delta(tw, tm, shapes=_load(g0)[0])
    (ores, orm), (jres, jrm) = _load(tr), _jax_params(jr)
    assert orm == jrm == {"round": 0, "client_id": 2}
    # wire + residual is the delta, on both sides (EF-SGD's invariant).
    _assert_delta_close(trees.map_leaves(np.add, dense, ores),
                        trees.map_leaves(np.add, ref, jres))


def test_refusals_match_jax(tmp_path):
    jcfg, tcfg = _configs(strategy="scaffold", momentum=0.0)
    g0 = str(tmp_path / "g0.npz")
    jax_offline.init_global_model(_configs()[0], g0)
    with pytest.raises(NotImplementedError) as ours:
        offline.client_update(tcfg, 0, g0, str(tmp_path / "u.npz"),
                              device="cpu")
    with pytest.raises(NotImplementedError) as theirs:
        jax_offline.client_update(jcfg, 0, g0, str(tmp_path / "u.npz"))
    assert str(ours.value) == str(theirs.value)
    _, tcfg = _configs(secure_agg=True, compress="topk",
                       compress_feedback=True)
    with pytest.raises(ValueError, match="secure_agg cannot carry"):
        offline.client_update(tcfg, 0, g0, str(tmp_path / "u.npz"),
                              device="cpu")
    _, tcfg = _configs(dp_clip=1.0, dp_adaptive_clip=True)
    with pytest.raises(NotImplementedError, match="engine-only"):
        offline.client_update(tcfg, 0, g0, str(tmp_path / "u.npz"),
                              device="cpu")
    _, tcfg = _configs()
    tcfg = tcfg.replace(fed=dataclasses.replace(tcfg.fed, aggregator="median"))
    with pytest.raises(NotImplementedError, match="engine-only"):
        offline.aggregate_updates(tcfg, g0, [g0], str(tmp_path / "g1.npz"),
                                  device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        offline.evaluate_global(tcfg, g0, detection=True, device="cpu")


def test_fixed_clip_dp_update_is_clipped_noised_and_uniform(tmp_path):
    _, tcfg = _configs(dp_clip=0.05, dp_noise_multiplier=0.0)
    g0 = str(tmp_path / "g0.npz")
    offline.init_global_model(tcfg, g0, device="cpu")
    stats = offline.client_update(tcfg, 0, g0, str(tmp_path / "u.npz"),
                                  device="cpu")
    assert stats["weight"] == 1.0
    delta, _ = _load(str(tmp_path / "u.npz"))
    norm = np.sqrt(sum(float((l.astype(np.float64) ** 2).sum())
                       for l in trees.leaves(delta)))
    assert norm == pytest.approx(0.05, rel=1e-5)


TINY = ["--backend", "cpu", "--config", "mnist_mlp_fedavg", "--dataset",
        "mnist_tiny", "--num-clients", "4", "--local-steps", "2"]


def test_cli_file_flow(tmp_path, capsys):
    """init -> two clients (topk8) -> aggregate -> eval through the port's
    command line, each printing one JSON line."""
    g0, g1 = str(tmp_path / "g0.npz"), str(tmp_path / "g1.npz")
    assert cli.main(["init", *TINY, "--out", g0]) == {"out": g0, "round": 0}
    ups = []
    for cid in range(2):
        ups.append(str(tmp_path / f"u{cid}.npz"))
        stats = cli.main(["train", *TINY, "--role", "client", "--client-id",
                          str(cid), "--global-model", g0, "--out", ups[-1],
                          "--compress", "topk8", "--topk-fraction", "0.1"])
        assert stats["client_id"] == cid and np.isfinite(stats["mean_loss"])
    assert _load(ups[0])[1]["compress"] == "topk8"
    agg = cli.main(["aggregate", *TINY, "--global-model", g0, "--updates",
                    *ups, "--out", g1])
    assert agg["round"] == 1 and agg["num_updates"] == 2
    ev = cli.main(["eval", *TINY, "--global-model", g1])
    assert ev["round"] == 1 and 0.0 <= ev["eval_acc"] <= 1.0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 5


def test_cli_client_role_needs_its_files(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["train", *TINY, "--role", "client", "--client-id", "0"])
    assert exc.value.code == 2
    assert "requires --client-id, --global-model, --out" in (
        capsys.readouterr().err)
