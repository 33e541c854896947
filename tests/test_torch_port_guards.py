"""Guards of the PyTorch port: its data copies give the JAX package's
arrays exactly (ghost padding and the mesh factoring too; its copy of the RDP accountant the same ε, its copy of
the mask-cost model the same costs, its copies of the serialization and
compression the same bytes, its bench the same baseline), neither it
nor its card scripts import anything of JAX or the JAX package, it never
moves to the CPU on its own, and it refuses what it does not run yet."""

import ast
import dataclasses
import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu import bench as jax_bench
from colearn_federated_learning_tpu.data import partition as jax_partition
from colearn_federated_learning_tpu.data import registry as jax_registry
from colearn_federated_learning_tpu.data import sharding as jax_sharding
from colearn_federated_learning_tpu.privacy import accountant as jax_accountant
from colearn_federated_learning_tpu.privacy import dropout as jax_dropout
from colearn_federated_learning_tpu.fed import compression as jax_compression
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu.utils import (
    serialization as jax_serialization)
from colearn_federated_learning_tpu_torch import bench
from colearn_federated_learning_tpu_torch.data import partition, registry
from colearn_federated_learning_tpu_torch.data import sharding
from colearn_federated_learning_tpu_torch.fed import FederatedLearner
from colearn_federated_learning_tpu_torch.fed import compression
from colearn_federated_learning_tpu_torch.models import registry as model_registry
from colearn_federated_learning_tpu_torch.privacy import accountant, dropout
from colearn_federated_learning_tpu_torch.utils import config, serialization

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "colearn_federated_learning_tpu")


@pytest.mark.parametrize("name", ["agnews_tiny", "mnist_tiny",
                                  "iot_traffic_tiny"])
def test_datasets_identical_to_jax(name):
    a = jax_registry.get_dataset(name, seed=3)
    b = registry.get_dataset(name, seed=3)
    for field in ("x_train", "y_train", "x_test", "y_test"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field


@pytest.mark.parametrize("kind", ["iid", "dirichlet", "pathological"])
def test_partitions_and_shards_identical_to_jax(kind):
    ds = registry.get_dataset("agnews_tiny", seed=1)
    labels = ds.y_train
    args = {"iid": (len(labels), 7), "dirichlet": (labels, 7, 0.5),
            "pathological": (labels, 7)}[kind]
    fn = f"{kind}_partition"
    ours = getattr(partition, fn)(*args, seed=2)
    ref = getattr(jax_partition, fn)(*args, seed=2)
    assert all(np.array_equal(a, b) for a, b in zip(ours, ref))
    for cap in (0, 50):
        s = sharding.pack_client_shards(ds.x_train, labels, ours, capacity=cap)
        r = jax_sharding.pack_client_shards(ds.x_train, labels, ref,
                                            capacity=cap)
        for field in ("x", "y", "counts"):
            assert np.array_equal(getattr(s, field), getattr(r, field))


@pytest.mark.parametrize("multiple", [1, 3, 4, 8])
def test_ghost_padding_identical_to_jax(multiple):
    ds = registry.get_dataset("mnist_tiny", seed=1)
    parts = partition.iid_partition(len(ds.y_train), 6, seed=2)
    s = sharding.pad_clients_to_multiple(sharding.pack_client_shards(
        ds.x_train, ds.y_train, parts), multiple)
    r = jax_sharding.pad_clients_to_multiple(jax_sharding.pack_client_shards(
        ds.x_train, ds.y_train, parts), multiple)
    for field in ("x", "y", "counts"):
        a, b = getattr(s, field), getattr(r, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def test_mesh_factoring_is_the_jax_copy():
    from colearn_federated_learning_tpu.parallel import mesh as jax_mesh
    from colearn_federated_learning_tpu_torch.parallel import mesh

    for n in range(1, 17):
        for axes in (1, 2, 3):
            assert mesh.factor_devices(n, axes) == \
                jax_mesh.factor_devices(n, axes), (n, axes)


@pytest.mark.parametrize("seed", [0, 5])
def test_fleet_population_and_traffic_copies_identical_to_jax(seed):
    """``fleetsim/population.py`` and ``traffic.py`` are numpy copies of
    JAX's: the same shards, classes, budgets, availability and cohorts."""
    from colearn_federated_learning_tpu import fleetsim as jax_fleetsim
    from colearn_federated_learning_tpu_torch import fleetsim

    arrays = []
    for mod in (fleetsim, jax_fleetsim):
        spec = mod.PopulationSpec(num_devices=3000, feature_dim=6,
                                  shard_capacity=5, min_examples=2,
                                  seed=seed)
        pop = mod.DevicePopulation(spec)
        tm = mod.TrafficModel(mod.TrafficSpec(base_rate=3.0, seed=seed),
                              3000)
        ids = np.arange(0, 3000, 7)
        arrays.append([*pop.materialize(ids), pop.counts(ids),
                       pop.home_classes(ids), pop.speed_class_index(ids),
                       pop.step_budgets(ids, 9), pop.example_batch(7),
                       mod.population.hash_u01(seed, 3, ids),
                       tm.availability_probability(4, ids),
                       tm.available_mask(4), tm.sample_cohort(4, 100),
                       np.float64(tm.expected_available(2))])
    for a, b in zip(*arrays):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_configs_identical_to_jax():
    assert sorted(config.CONFIGS) == sorted(jax_config.CONFIGS)
    for name, cfg in config.CONFIGS.items():
        assert (dataclasses.asdict(cfg)
                == dataclasses.asdict(jax_config.CONFIGS[name])), name


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


NEW_MODULES = ["bench.py", "comm/aggregation.py", "fed/compression.py",
               "fed/offline.py", "fed/setup.py", "ops/fold.py",
               "utils/serialization.py", "utils/trees.py",
               "parallel/__init__.py", "parallel/collectives.py",
               "parallel/mesh.py", "parallel/partition.py", "parallel/ring.py",
               "parallel/sp.py", "parallel/tp.py", "parallel/ulysses.py",
               "comm/__init__.py", "comm/aggregator.py",
               "comm/async_coordinator.py", "comm/broker.py",
               "comm/coordinator.py", "comm/per_type.py",
               "comm/downlink.py", "comm/enrollment.py",
               "comm/keyexchange.py", "comm/mud.py", "comm/protocol.py",
               "comm/transport.py", "comm/worker.py", "faults/__init__.py",
               "faults/fileplane.py", "faults/inject.py", "faults/plan.py",
               "privacy/dropout.py", "privacy/secure_agg.py",
               "analysis/__init__.py", "analysis/metric_catalog.py",
               "analysis/engine.py", "analysis/findings.py",
               "analysis/lock_regions.py", "analysis/reporters.py",
               "analysis/rules.py", "analysis/sentinel.py",
               "metrics.py", "telemetry/__init__.py", "telemetry/arrival.py",
               "telemetry/export.py", "telemetry/health.py",
               "telemetry/lifecycle.py", "telemetry/registry.py",
               "telemetry/tracer.py", "ckpt/__init__.py", "ckpt/manager.py",
               "ckpt/streaming.py", "ckpt/wal.py", "telemetry/flight.py",
               "faults/soak.py", "faults/procsoak.py",
               "faults/lockwitness.py", "fleetsim/__init__.py",
               "fleetsim/population.py", "fleetsim/traffic.py",
               "fleetsim/sim.py", "dryrun.py"]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((ROOT / "colearn_federated_learning_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    pkg = ROOT / "colearn_federated_learning_tpu_torch"
    assert {pkg / m for m in NEW_MODULES} <= set(files)
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"


@pytest.mark.parametrize("module", ["analysis/metric_catalog.py",
                                    "telemetry/arrival.py",
                                    "analysis/findings.py"])
def test_telemetry_copies_are_their_sources_verbatim(module):
    """The metric catalog (which the registry's strict mode reads), the
    arrival estimator and the lint's finding model need nothing of JAX:
    the port keeps them as exact copies of the JAX package's files."""
    ours = (ROOT / "colearn_federated_learning_tpu_torch" / module).read_text()
    theirs = (ROOT / "colearn_federated_learning_tpu" / module).read_text()
    assert ours == theirs


CARD_SCRIPTS = ["chip_smoke.py"] + sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "scripts").glob(
        "torch_port_*.py"))


@pytest.mark.parametrize("script", CARD_SCRIPTS)
def test_card_scripts_import_no_jax_and_nothing_of_the_jax_package(script):
    for mod in _imports(ROOT / script):
        assert mod.split(".")[0] not in FORBIDDEN, f"{script} imports {mod}"


def _wire_tree():
    rng = np.random.default_rng(4)
    return {"a": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                  "i": np.arange(4, dtype=np.int32)},
            "b": np.float32(2.5), "c": np.int64(7)}


def test_serialization_copy_gives_the_jax_bytes(tmp_path):
    tree, meta = _wire_tree(), {"round": 3, "weight": 1.5}
    ours = bytes(serialization.pytree_to_bytes(tree, meta))
    assert ours == bytes(jax_serialization.pytree_to_bytes(tree, meta))
    assert (serialization.wire_frame_length(tree, meta)
            == jax_serialization.wire_frame_length(tree, meta) == len(ours))
    for codec in (serialization, jax_serialization):
        path = str(tmp_path / f"{codec.__name__}.npz")
        codec.atomic_save_pytree_npz(path, tree, meta)
        for reader in (serialization, jax_serialization):
            got, got_meta = reader.load_pytree_npz(path)
            assert got_meta == meta
            assert (bytes(serialization.pytree_to_bytes(got, meta))
                    == ours)
        got, _ = serialization.bytes_to_pytree(ours)
        assert bytes(jax_serialization.pytree_to_bytes(got, meta)) == ours
    with pytest.raises(TypeError, match="convert to a dict"):
        serialization.pytree_to_bytes({"l": [np.zeros(2)]})


@pytest.mark.parametrize("scheme", ["none", "int8", "topk", "topk8"])
def test_compression_copy_gives_the_jax_frames(scheme):
    tree = {k: v for k, v in _wire_tree()["a"].items() if k == "w"}
    ours, ometa = compression.compress_delta(tree, scheme, topk_fraction=0.2)
    theirs, tmeta = jax_compression.compress_delta(tree, scheme,
                                                   topk_fraction=0.2)
    assert (bytes(serialization.pytree_to_bytes(ours, ometa))
            == bytes(jax_serialization.pytree_to_bytes(theirs, tmeta)))
    assert compression.SCHEMES == jax_compression.SCHEMES
    assert compression.TOPK_FRACTION == jax_compression.TOPK_FRACTION


def test_bench_baseline_is_the_jax_copy():
    """``run_reference_style`` and the workloads are verbatim copies, so
    ``vs_baseline`` divides by the same stand-in in both packages."""
    assert (inspect.getsource(bench.run_reference_style)
            == inspect.getsource(jax_bench.run_reference_style))
    assert bench.TPU_WORKLOAD == jax_bench.TPU_WORKLOAD
    assert bench.CPU_WORKLOAD == jax_bench.CPU_WORKLOAD


@pytest.mark.parametrize("q", [0.01, 0.2, 1.0])
def test_accountant_copy_gives_the_jax_epsilon(q):
    for z in (0.5, 1.0, 2.5):
        for delta in (1e-5, 1e-3):
            ours = accountant.RdpAccountant(z, q, delta)
            theirs = jax_accountant.RdpAccountant(z, q, delta)
            for rounds in (1, 10, 500):
                ours.steps, theirs.steps = rounds, rounds
                assert ours.epsilon() == theirs.epsilon(), (z, delta, rounds)
            ours.step(3, sampling_rate=q / 2, noise_multiplier=z * 2)
            theirs.step(3, sampling_rate=q / 2, noise_multiplier=z * 2)
            assert ours.epsilon(1e-6) == theirs.epsilon(1e-6)


@pytest.mark.parametrize("group_size", [0, 1, 5, 50])
def test_mask_cost_copy_gives_the_jax_costs(group_size):
    assert dropout.PRG_FLOPS_PER_ELEM == jax_dropout.PRG_FLOPS_PER_ELEM
    assert dropout.SHARE_PAYLOAD_BYTES == jax_dropout.SHARE_PAYLOAD_BYTES
    for cohort in (1, 10, 100):
        for neighbors in (0, 2, 8):
            kw = dict(cohort=cohort, param_count=1234567,
                      neighbors=neighbors, group_size=group_size)
            assert dropout.mask_cost(**kw) == jax_dropout.mask_cost(**kw)
    with pytest.raises(ValueError, match="must be >= 1"):
        dropout.mask_cost(cohort=0, param_count=1)


def test_chip_smoke_epsilon_is_the_jax_accountants():
    """chip_smoke.py's 7c holds the card run's ε to a constant; it must be
    what JAX's accountant gives for 7c's sampling rate, noise and δ."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    argv = smoke.BERT_DP
    cfg = config.get_config(argv[argv.index("--config") + 1])
    z = float(argv[argv.index("--dp-noise-multiplier") + 1])
    jax_acc = jax_accountant.RdpAccountant(
        z, cfg.fed.cohort_size / cfg.data.num_clients, cfg.fed.dp_delta)
    jax_acc.step(2)
    assert smoke.EPS_7C == jax_acc.epsilon()


def test_learner_without_cuda_raises_instead_of_using_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.get_config("agnews_bert_fedavg")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedLearner(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedLearner(cfg, device="cuda")


def test_build_model_without_cuda_raises_instead_of_using_the_cpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model_cfg = config.get_config("agnews_bert_fedavg").model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_registry.build_model(model_cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_registry.build_model(model_cfg, "cuda")


@pytest.mark.parametrize("fed_kw", [
    dict(lora_rank=4), dict(lora_rank=4, edge_groups=2),
    dict(lora_rank=2, tp_size=2), dict(lora_rank=8, edge_groups=4)])
def test_lora_in_process_raises_jax_s_value_error(fed_kw):
    """LoRA runs on the socket plane only: the in-process learner raises
    the JAX learner's ``ValueError``, word for word."""
    from colearn_federated_learning_tpu.fed import (
        FederatedLearner as JaxLearner)

    run_kw = {k: v for k, v in fed_kw.items() if k == "tp_size"}
    fed_kw = {k: v for k, v in fed_kw.items() if k != "tp_size"}
    errors = []
    for mod, make in ((jax_config, JaxLearner),
                      (config, lambda c: FederatedLearner(c, device="cpu"))):
        base = mod.get_config("mnist_mlp_fedavg")
        cfg = base.replace(
            data=dataclasses.replace(base.data, dataset="mnist_tiny"),
            fed=dataclasses.replace(base.fed, **fed_kw),
            run=dataclasses.replace(base.run, **run_kw))
        with pytest.raises(ValueError) as exc:
            make(cfg)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]
    assert "requires the socket federation plane" in errors[1]


@pytest.mark.parametrize("fed_kw", [dict(strategy="fedsgd")])
def test_unported_features_raise(fed_kw):
    base = config.get_config("agnews_bert_fedavg")
    run_kw = {k: v for k, v in fed_kw.items() if k == "tp_size"}
    fed_kw = {k: v for k, v in fed_kw.items() if k != "tp_size"}
    cfg = base.replace(
        data=dataclasses.replace(base.data, dataset="agnews_tiny"),
        fed=dataclasses.replace(base.fed, **fed_kw),
        run=dataclasses.replace(base.run, **run_kw))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FederatedLearner(cfg, device="cpu")


def _tiny_mlp(**run_kw):
    base = config.get_config("mnist_mlp_fedavg")
    return base.replace(
        data=dataclasses.replace(base.data, dataset="mnist_tiny"),
        fed=dataclasses.replace(base.fed, rounds=1, local_steps=1),
        run=dataclasses.replace(base.run, **run_kw))


@pytest.mark.parametrize("run_kw,item", [
    (dict(checkpoint_dir="ckpt"), None),
    (dict(checkpoint_every=2), None),
    (dict(profile_dir="prof"), None)])
def test_checkpoint_and_trace_options_are_refused(run_kw, item, tmp_path,
                                                  monkeypatch):
    """The JAX learner's ``fit`` writes checkpoints and a profiler window.
    The checkpoint options, refused until the checkpoint plane was
    ported, and the profiler window, refused until item 10b was ported,
    are taken by the port's learners, and nothing is written before
    ``fit`` saves or profiles (``tests/test_torch_port_profile.py``).
    (The span-trace window is ported: see the test below.)"""
    from colearn_federated_learning_tpu_torch.fed import HierarchicalLearner

    monkeypatch.chdir(tmp_path)
    run_kw = {k: (str(tmp_path / v) if isinstance(v, str) else v)
              for k, v in run_kw.items()}
    cfg = _tiny_mlp(**run_kw)
    name = next(iter(run_kw))
    for build in (lambda: FederatedLearner(cfg, device="cpu"),
                  lambda: HierarchicalLearner(cfg, 2, 1, device="cpu")):
        if item is None:
            build()
            continue
        with pytest.raises(NotImplementedError,
                           match=f"run.{name}.*ROADMAP.md Queue A {item} "):
            build()
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("run_kw,traced", [
    (dict(trace_dir="trace"), True), (dict(trace_rounds=3), False)])
def test_trace_options_open_a_trace_window(run_kw, traced, tmp_path,
                                           monkeypatch):
    """``trace_dir`` and ``trace_rounds`` were refused until the telemetry
    core was ported; now the learners take them, and ``fit`` writes the
    trace file only with a ``trace_dir`` (``trace_rounds`` alone traces
    nothing, as in JAX)."""
    from colearn_federated_learning_tpu_torch.fed import HierarchicalLearner

    monkeypatch.chdir(tmp_path)
    run_kw = {k: (str(tmp_path / v) if isinstance(v, str) else v)
              for k, v in run_kw.items()}
    cfg = _tiny_mlp(**run_kw)
    HierarchicalLearner(cfg, 2, 1, device="cpu")
    learner = FederatedLearner(cfg, device="cpu")
    learner.fit(rounds=1)
    written = sorted(p.name for p in tmp_path.rglob("*") if p.is_file())
    if traced:
        assert written == ["mnist_mlp_fedavg_trace.json"]
        assert learner.last_trace_path == str(
            tmp_path / "trace" / "mnist_mlp_fedavg_trace.json")
    else:
        assert written == [] and learner.last_trace_path is None


def test_the_default_run_options_are_accepted():
    cfg = _tiny_mlp()
    assert not (cfg.run.checkpoint_dir or cfg.run.checkpoint_every
                or cfg.run.trace_dir or cfg.run.trace_rounds
                or cfg.run.profile_dir)
    learner = FederatedLearner(cfg, device="cpu")
    learner.fit(rounds=1)
    assert len(learner.history) == 1
