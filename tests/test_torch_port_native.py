"""The port's counterparts of the JAX package's native kernels (N1, the
top-k selector, ``ops/topk.py``; N2, the row gather, ``ops/gather.py``)
and the paths that reach them, on the CPU, against the JAX package.

On the CPU the wrappers run their plain versions (the card's kernels are
held to those bit for bit by ``tests/test_torch_port_cuda.py`` and
``chip_smoke.py``).  The comparison is with the JAX package's native
library itself, built for this module in the worker's own temporary
directory (``torch_port_native_lib.native_lib``: it must build, since the
numpy fallback breaks ties in another order), on inputs drawn with numpy
from a seed:

- the selection, indices and value bits, over random leaves of 1 to 10^6
  entries at k = 1, 2, 5 %, n - 1 and n, and over ties of both signs, all
  zeros, a constant leaf, mixed ±0.0, denormals, ±inf and NaN;
- ``compress_delta`` and three rounds of ``feedback_compress`` over a
  tree of tensors in the flax layout (tiny BERT and the CNN, topk and
  topk8): frames byte-equal to JAX's and residuals bit-equal; the
  downlink's device route gives JAX's frames and rebuilt params;
- the socket worker's reply frames over two rounds with feedback equal
  JAX's worker's for the same delta (its residual norm, summed in another
  order, to float32 rounding);
- the engine's packed shards through the device route equal JAX's
  ``pack_client_shards`` (one device, a 4-rank mesh order with ghost
  clients, the sequence-parallel split), and the gather raises on a bad
  index before it writes.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu import native
from colearn_federated_learning_tpu.comm import downlink as jax_downlink
from colearn_federated_learning_tpu.comm import worker as jax_worker
from colearn_federated_learning_tpu.data import sharding as jax_sharding
from colearn_federated_learning_tpu.fed import compression as jax_compression
from colearn_federated_learning_tpu.fed import local as jax_local
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu.utils import pytrees as jax_pytrees
from colearn_federated_learning_tpu.utils import (
    serialization as jax_serialization)
from colearn_federated_learning_tpu_torch import convert
from colearn_federated_learning_tpu_torch.comm import downlink
from colearn_federated_learning_tpu_torch.comm.worker import (
    DeviceWorker, tree_global_norm)
from colearn_federated_learning_tpu_torch.data import registry
from colearn_federated_learning_tpu_torch.data import sharding
from colearn_federated_learning_tpu_torch.fed import FederatedLearner
from colearn_federated_learning_tpu_torch.fed import compression, setup
from colearn_federated_learning_tpu_torch.fed.local import LocalResult
from colearn_federated_learning_tpu_torch.models import registry as models
from colearn_federated_learning_tpu_torch.ops import gather, topk
from colearn_federated_learning_tpu_torch.utils import config, serialization
from colearn_federated_learning_tpu_torch.utils import trees
from test_torch_port_round import FAMILIES
from torch_port_native_lib import native_lib  # noqa: F401  (autouse)

# The residual norm is a float32 sum of squares over the whole tree: the
# port sums each leaf, then the leaves, on the tensors' device; numpy sums
# leaf by leaf in its own pairwise order.  Both round in float32.
NORM_RTOL = 1e-5


def bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


def assert_same_selection(x: np.ndarray, k: int) -> None:
    want_i, want_v = native.topk_abs(x, k)
    got_i, got_v = compression.topk_abs(torch.from_numpy(x.copy()), k)
    assert got_i.dtype == torch.int32 and got_v.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(bits(got_v.numpy()), bits(want_v))
    host_i, host_v = compression.topk_abs(x, k)
    np.testing.assert_array_equal(host_i, want_i)
    np.testing.assert_array_equal(bits(host_v), bits(want_v))


def _normal_cases():
    for n in (1, 7, 65_539, 1_000_000):
        for k in sorted({1, 2, math.ceil(0.05 * n), n - 1, n}):
            if 1 <= k <= n:
                yield n, k


@pytest.mark.parametrize("n,k", list(_normal_cases()))
def test_topk_equals_the_native_selector_on_normal_leaves(n, k):
    x = np.random.default_rng(n + k).standard_normal(n).astype(np.float32)
    assert_same_selection(x, k)


def _special(name: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if name == "ties":          # many equal magnitudes of both signs
        return rng.integers(-3, 4, 100_000).astype(np.float32)
    if name == "zeros":
        return np.zeros(70_000, np.float32)
    if name == "constant":
        return np.full(70_000, -2.5, np.float32)
    if name == "signed_zeros":
        return np.where(rng.random(5_000) < 0.5, np.float32(0.0),
                        np.float32(-0.0)).astype(np.float32)
    x = rng.standard_normal(40_000).astype(np.float32)
    x[::7] = np.float32(1e-40)                  # denormals
    x[3::11] = -np.float32(1e-42)
    x[5], x[9], x[11] = np.inf, -np.inf, np.nan
    x[12] = -np.float32(np.nan)
    x[13::17] = np.inf
    return x


@pytest.mark.parametrize("name", ["ties", "zeros", "constant",
                                  "signed_zeros", "specials"])
@pytest.mark.parametrize("frac", [None, 0.05, 0.5, 1.0])
def test_topk_equals_the_native_selector_on_degenerate_leaves(name, frac):
    x = _special(name)
    k = 1 if frac is None else max(1, math.ceil(frac * x.size))
    assert_same_selection(x, k)


def test_topk_refuses_what_the_native_selector_refuses():
    x = torch.ones(5)
    for k in (0, 6):
        with pytest.raises(ValueError, match="out of range"):
            topk.topk_abs(x, k)
    with pytest.raises(ValueError, match="flat float32"):
        topk.topk_abs(torch.ones(5, dtype=torch.float64), 2)


# ------------------------------------------------------------ compression --
def _model(family):
    data, model, fed = FAMILIES[family]
    cfg = config.ExperimentConfig(
        data=config.DataConfig(**data, num_clients=2),
        model=config.ModelConfig(**model), fed=config.FedConfig(**fed),
        run=config.RunConfig(name="native_test"))
    shape = (None if family == "bert"
             else registry.get_dataset(data["dataset"]).x_train.shape[1:])
    return cfg, models.build_model(cfg.model, "cpu", input_shape=shape)


def _deltas(cfg, model, seed):
    """A random delta in the model's parameter order, and its flax trees:
    tensors (the device route) and numpy (the host's)."""
    rng = np.random.default_rng(seed)
    values = [torch.from_numpy(
        (0.01 * rng.standard_normal(tuple(p.shape))).astype(np.float32))
        for p in model.parameters()]
    return (values, setup.params_to_flax_tensors(model, values, cfg),
            setup.params_to_flax(model, values, cfg))


def _frame(wire, meta, codec=serialization):
    return bytes(codec.pytree_to_bytes(wire, meta))


@pytest.mark.parametrize("scheme", ["topk", "topk8"])
@pytest.mark.parametrize("family", ["bert", "cnn"])
def test_tensor_compression_gives_jax_frames_and_residuals(family, scheme):
    cfg, model = _model(family)
    residual = jax_residual = None
    for r in range(4):
        _, tensors, arrays = _deltas(cfg, model, seed=r)
        assert all(np.array_equal(t.numpy(), a) for t, a in
                   zip(trees.leaves(tensors), trees.leaves(arrays)))
        if r == 0:
            wire, meta = compression.compress_delta(tensors, scheme,
                                                    topk_fraction=0.1)
            want, wmeta = jax_compression.compress_delta(arrays, scheme,
                                                         topk_fraction=0.1)
            assert _frame(wire, meta) == _frame(want, wmeta,
                                                jax_serialization)
            continue
        wire, meta, residual = compression.feedback_compress(
            tensors, residual, scheme, topk_fraction=0.1)
        want, wmeta, jax_residual = jax_compression.feedback_compress(
            arrays, jax_residual, scheme, topk_fraction=0.1)
        assert _frame(wire, meta) == _frame(want, wmeta, jax_serialization)
        got = trees.leaves(residual)
        assert all(isinstance(t, torch.Tensor) for t in got)
        for t, a in zip(got, trees.leaves(jax_residual)):
            assert tuple(t.shape) == a.shape
            np.testing.assert_array_equal(bits(t.numpy()), bits(a))


def test_tensor_feedback_refuses_a_residual_of_another_shape():
    delta = {"w": torch.ones(4, 3)}
    with pytest.raises(ValueError):
        compression.feedback_compress(delta, {"w": np.ones((5, 3),
                                                          np.float32)},
                                      "topk")
    with pytest.raises(ValueError):
        compression.feedback_compress(delta, {"v": np.ones((4, 3),
                                                          np.float32)},
                                      "topk")


@pytest.mark.parametrize("scheme", ["topk", "topk8"])
def test_downlink_device_route_gives_jax_frames(scheme):
    ours = downlink.DownlinkEncoder(scheme)
    theirs = jax_downlink.DownlinkEncoder(scheme)
    cache, jcache = downlink.WorkerParamCache(), jax_downlink.WorkerParamCache()
    rng = np.random.default_rng(3)
    params = {"Dense_0": {"kernel": rng.standard_normal((40, 8)).astype(
        np.float32), "bias": np.zeros(8, np.float32)}}
    params["Dense_0"]["bias"][::2] = -0.0
    for r in range(4):
        params = {"Dense_0": {k: v + 0.01 * rng.standard_normal(
            v.shape).astype(np.float32) for k, v in params["Dense_0"].items()}}
        live = trees.map_leaves(torch.from_numpy, params)
        a, ra, sa = ours.encode_round(r, live)
        b, rb, sb = theirs.encode_round(r, params)
        assert bytes(a) == bytes(b) and sa == sb
        assert bytes(ra()) == bytes(rb())
        if r:
            assert all(isinstance(t, torch.Tensor)
                       for t in trees.leaves(ours._base[1]))
        tree, meta = serialization.bytes_to_pytree(bytes(a))
        got, want = cache.resolve(r, meta, tree), jcache.resolve(r, meta,
                                                                 tree)
        for g, w in zip(trees.leaves(got), trees.leaves(want)):
            np.testing.assert_array_equal(bits(g), bits(w))


# ------------------------------------------------------------------ worker --
def test_worker_reply_frames_with_feedback_equal_jax_worker():
    """Both packages' workers (topk8, feedback, adaptive density) given
    the same delta for two rounds reply the same frames; the port's
    residual stays tensors, bit-equal to JAX's."""
    fed = dict(strategy="fedavg", rounds=2, cohort_size=0, local_steps=2,
               batch_size=8, lr=0.05, compress="topk8",
               compress_feedback=True, topk_fraction=0.05,
               topk_adaptive=True, topk_min_fraction=0.02,
               topk_max_fraction=0.2)
    data = dict(dataset="mnist_tiny", partition="iid", num_clients=2)
    model = dict(name="mlp", num_classes=10, hidden_dim=32, depth=2)
    jcfg, tcfg = [mod.ExperimentConfig(
        data=mod.DataConfig(**data), model=mod.ModelConfig(**model),
        fed=mod.FedConfig(**fed), run=mod.RunConfig(name="native_worker"))
        for mod in (jax_config, config)]
    ours = DeviceWorker(tcfg, 0, device="cpu")
    theirs = jax_worker.DeviceWorker(jcfg, 0)
    try:
        params = setup.params_to_flax(ours._model, None, tcfg)
        names = [n for n, _ in ours._model.named_parameters()]
        for r in range(2):
            values, _, arrays = _deltas(tcfg, ours._model, seed=10 + r)
            loss = np.float32(0.25 * (r + 1))
            ours._update_fn = lambda *a, v=values, l=loss: LocalResult(
                delta=v, num_examples=ours.num_examples, completed=True,
                mean_loss=torch.tensor(l), steps_run=2.0)
            theirs._update_fn = lambda *a, t=arrays, l=loss: \
                jax_local.LocalResult(
                    delta=jax.tree.map(jnp.asarray, t),
                    num_examples=jnp.int32(ours.num_examples),
                    completed=jnp.bool_(True), mean_loss=jnp.float32(l),
                    steps_run=jnp.float32(2.0))
            got, gwire = ours._train(r, params)
            want, wwire = theirs._train(r, params)
            assert got["meta"] == want["meta"]
            assert (_frame(gwire, got["meta"])
                    == _frame(wwire, want["meta"], jax_serialization))
            assert ours._topk_fraction == theirs._topk_fraction
            res = trees.leaves(ours._uplink_residual)
            assert all(isinstance(t, torch.Tensor) for t in res)
            for t, a in zip(res, trees.leaves(theirs._uplink_residual)):
                np.testing.assert_array_equal(bits(t.numpy()), bits(a))
            np.testing.assert_allclose(
                tree_global_norm(ours._uplink_residual),
                float(jax_pytrees.tree_global_norm(theirs._uplink_residual)),
                rtol=NORM_RTOL)
        assert names == [n for n, _ in ours._model.named_parameters()]
    finally:
        ours.stop()
        theirs.stop()


def test_residual_norm_of_tensors_is_the_host_norm():
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((300, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal(1000).astype(np.float32)}}
    host = tree_global_norm(tree)
    assert host == float(jax_pytrees.tree_global_norm(tree))
    np.testing.assert_allclose(
        tree_global_norm(trees.map_leaves(torch.from_numpy, tree)), host,
        rtol=NORM_RTOL)


# ------------------------------------------------------------------ gather --
def _jax_block(x, y, parts, cap, devices, index, seq=None):
    """JAX's pack, ghost padding, mesh order, block and SP split, as the
    JAX engine lays them out (native present)."""
    shards = jax_sharding.pack_client_shards(x, y, parts, capacity=cap)
    if devices > 1:
        shards = jax_sharding.pad_clients_to_multiple(shards, devices)
        L = shards.num_clients // devices
        order = np.array([j * devices + d for d in range(devices)
                          for j in range(L)], np.int64)
        shards = jax_sharding.ClientShards(
            x=shards.x[order], y=shards.y[order], counts=shards.counts[order])
    L = shards.num_clients // devices
    xs = shards.x[index * L:(index + 1) * L]
    if seq is not None:
        xs = np.array_split(xs, seq[0], axis=-1)[seq[1]]
    return xs, shards.y[index * L:(index + 1) * L], shards.counts


@pytest.mark.parametrize("dataset,clients,devices,index,seq", [
    ("cifar10_tiny", 7, 1, 0, None),
    ("cifar10_tiny", 10, 4, 0, None),
    ("cifar10_tiny", 10, 4, 3, None),
    ("agnews_tiny", 6, 1, 0, (2, 1)),
    ("agnews_tiny", 5, 4, 2, (2, 0)),
])
def test_device_pack_equals_jax_pack(dataset, clients, devices, index, seq):
    ds = registry.get_dataset(dataset)
    x, y = np.asarray(ds.x_train), np.asarray(ds.y_train)
    rng = np.random.default_rng(clients)
    parts = [np.sort(rng.choice(len(y), rng.integers(3, 40), replace=False))
             for _ in range(clients)]
    cap = 25
    rows, counts = sharding.client_rows(parts, cap)
    if devices > 1:
        rows, counts = sharding.pad_rows_to_multiple(rows, counts, devices)
        L = len(counts) // devices
        order = np.array([j * devices + d for d in range(devices)
                          for j in range(L)], np.int64)
        rows, counts = rows[order], counts[order]
    L = len(counts) // devices
    got_x, got_y = sharding.gather_block(
        x, y, rows[index * L:(index + 1) * L], "cpu", seq_split=seq)
    want_x, want_y, want_counts = _jax_block(x, y, parts, cap, devices,
                                             index, seq)
    assert got_x.dtype == torch.from_numpy(want_x).dtype
    np.testing.assert_array_equal(got_x.numpy(), want_x)
    assert got_y.dtype == torch.int64
    np.testing.assert_array_equal(got_y.numpy(), want_y.astype(np.int64))
    np.testing.assert_array_equal(counts, want_counts)


def test_engine_packs_jax_shards_through_the_device_route():
    _, model, fed = FAMILIES["cnn"]
    cfg = config.ExperimentConfig(
        data=config.DataConfig(dataset="cifar10_tiny", num_clients=5,
                               partition="dirichlet",
                               max_examples_per_client=30),
        model=config.ModelConfig(**model), fed=config.FedConfig(**fed),
        run=config.RunConfig(name="native_pack"))
    gather.reset_launches()
    learner = FederatedLearner(cfg, device="cpu")
    assert gather.launches["gather_rows"] == 0        # the plain route
    ds = learner.dataset
    parts = [np.asarray(p) for p in learner_parts(learner, cfg)]
    want = jax_sharding.pack_client_shards(np.asarray(ds.x_train),
                                           np.asarray(ds.y_train), parts,
                                           capacity=30)
    np.testing.assert_array_equal(learner.x.numpy(), want.x)
    np.testing.assert_array_equal(learner.y.numpy(),
                                  want.y.astype(np.int64))
    np.testing.assert_array_equal(learner.counts, want.counts)


def learner_parts(learner, cfg):
    from colearn_federated_learning_tpu_torch.fed.engine import (
        partition_for_config)

    return partition_for_config(cfg, np.asarray(learner.dataset.y_train))


@pytest.mark.parametrize("bad", [-1, 12])
def test_gather_rows_raises_on_a_bad_index(bad):
    src = torch.arange(24, dtype=torch.float32).view(12, 2)
    with pytest.raises(IndexError, match="out of range"):
        gather.gather_rows(src, torch.tensor([0, 3, bad, 5]))
    with pytest.raises(IndexError):
        native.gather_rows(src.numpy(), np.array([0, 3, bad, 5]))
    got = gather.gather_rows(src, torch.tensor([11, 0, 0, 4]))
    np.testing.assert_array_equal(got.numpy(), native.gather_rows(
        src.numpy(), np.array([11, 0, 0, 4])))


def test_flax_tensor_layout_is_the_host_layout():
    cfg, model = _model("bert")
    values, tensors, arrays = _deltas(cfg, model, seed=1)
    for (t, a) in zip(trees.leaves(tensors), trees.leaves(arrays)):
        assert t.is_contiguous() and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.numpy(), a)
    flax_sd = convert.flax_to_state_dict(arrays)
    for (name, _), v in zip(model.named_parameters(), values):
        np.testing.assert_array_equal(flax_sd[name].numpy(), v.numpy())
