"""The port's measurement drivers against the JAX package's scripts.

``scripts/torch_port_{bench_fleet,mesh_smoke,bench_wire,perf_north_star}.py``
are held to ``scripts/{bench_fleet,mesh_smoke,bench_wire,perf_north_star}.py``
(each loaded with ``importlib``) on the CPU, with the same seeds:

- the row schemas (the port keeps its own copies) equal JAX's;
- ``bench_fleet``: the analytic rows (mask cost, uplink bytes, ingest
  scaling at one fold cost per update, the asynchronous and the analytic
  tree rows) equal JAX's field for field but for the wall-clock fields;
  ``run_point(32, 1, 16, 0)`` on JAX's initial params with JAX's draws
  gives JAX's clients and byte fields and its ``train_loss`` within f32
  rtol 1e-4 / atol 2e-5 (``tests/test_torch_port_fleetsim.py``'s bound);
  the measured asynchronous points' event fields equal JAX's (the
  schedule is host numpy drawn in JAX's order); the script writes
  schema-valid rows, as JAX's ``test_bench_fleet_writes_schema_valid_jsonl``
  checks of JAX's;
- ``mesh_smoke`` (8 forced host positions, tp 4): every row equals JAX's,
  the self-checks included;
- ``bench_wire``: ``run_bench`` (2 workers, topk up, int8 down, feedback
  off, tp 1, 2 rounds) and ``run_lora_bench`` (rank 4) give JAX's byte
  and count deltas; the fold and checkpoint rows at the tiny BERT are
  bitwise, with JAX's row keys; the shape-only views equal JAX's
  ``eval_shape``;
- ``perf_north_star`` at a tiny shape: JAX's line keys and server bytes
  (the FLOP count is not compared: the port counts FLOPs, JAX compiles
  them; ROADMAP Queue C).

Every script exits non-zero without a card unless ``--backend cpu`` is
given, and writes no row.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu import fleetsim as jfs
from colearn_federated_learning_tpu import telemetry as jtel
from colearn_federated_learning_tpu_torch import telemetry
from colearn_federated_learning_tpu_torch.utils import trees
from test_torch_port_round import JaxDraws

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 2e-5
# Fields of a fleet row that depend on a clock: the wall-clock fields and
# those derived from a measured time.
FLEET_TIMED = {"bench_wall_s", "rounds_per_sec", "clients_per_sec",
               "round_time_s_mean", "round_time_s_warmup",
               "fold_s_per_update", "agg_fold_s_est", "root_fold_s_est",
               "critical_path_fold_s_est", "flat_fold_s_est",
               "fold_speedup_x"}
# Fields of a wire round that depend on a clock.
WIRE_TIMED = {"round_time_s", "fold_overlap_s", "round_time_s_mean",
              "fold_overlap_s_mean", "bench_wall_s"}


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_measure_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    names = ("bench_fleet", "mesh_smoke", "bench_wire", "perf_north_star")
    return {n: (_load(n), _load(f"torch_port_{n}")) for n in names}


@pytest.fixture(autouse=True)
def _fresh_registries():
    telemetry.get_registry().reset()
    jtel.get_registry().reset()
    yield


def _untimed(row: dict, timed) -> dict:
    return {k: v for k, v in row.items() if k not in timed}


# ------------------------------------------------------------- schemas --
@pytest.mark.parametrize("name", ["bench_fleet", "bench_wire"])
def test_row_schemas_are_jax_s(scripts, name):
    theirs, ours = scripts[name]
    assert ours.SCHEMAS == theirs.SCHEMAS
    assert ours.ROW_SCHEMA == theirs.ROW_SCHEMA


def test_wire_counters_are_jax_s(scripts):
    theirs, ours = scripts["bench_wire"]
    assert ours._COUNTERS == theirs._COUNTERS


# --------------------------------------------------------- bench_fleet --
def test_fleet_bench_params_count_equals_jax(scripts):
    theirs, ours = scripts["bench_fleet"]
    assert ours.bench_param_count(0) == theirs.bench_param_count(0) == 874


@pytest.mark.parametrize("neighbors", [0, 2, 16])
def test_fleet_mask_rows_equal_jax(scripts, neighbors):
    theirs, ours = scripts["bench_fleet"]
    want = theirs.mask_point(1_000_000, neighbors, 1024, 874)
    got = ours.mask_point(1_000_000, neighbors, 1024, 874)
    assert _untimed(got, FLEET_TIMED) == _untimed(
        want, FLEET_TIMED)


@pytest.mark.parametrize("scheme", ["none", "int8", "topk", "topk8"])
def test_fleet_uplink_rows_equal_jax(scripts, scheme):
    theirs, ours = scripts["bench_fleet"]
    want = theirs.uplink_point(1_000_000, scheme, 0.05, theirs.bench_params(0))
    got = ours.uplink_point(1_000_000, scheme, 0.05, ours.bench_params(0))
    assert _untimed(got, FLEET_TIMED) == _untimed(
        want, FLEET_TIMED)


@pytest.mark.parametrize("aggregators", [1, 2, 4])
def test_fleet_ingest_rows_equal_jax(scripts, aggregators):
    """At one fold cost per update (a measured time on each side) the
    ingest rows are equal whole, the priced fold seconds included."""
    theirs, ours = scripts["bench_fleet"]
    fold_s = 3.5e-5
    want = theirs.ingest_point(1_000_000, aggregators,
                               theirs.bench_params(0), fold_s)
    got = ours.ingest_point(1_000_000, aggregators, ours.bench_params(0),
                            fold_s)
    assert _untimed(got, {"bench_wall_s"}) == _untimed(want, {"bench_wall_s"})
    assert ours.measured_fold_s_per_update(ours.bench_params(0), 4) > 0


@pytest.mark.parametrize("devices", [1000, 10000, 1_000_000])
def test_fleet_async_rows_equal_jax(scripts, devices):
    theirs, ours = scripts["bench_fleet"]
    assert _untimed(ours.async_point(devices), FLEET_TIMED) == _untimed(
        theirs.async_point(devices), FLEET_TIMED)


@pytest.mark.parametrize("devices", [10000, 100000, 1_000_000])
def test_fleet_tree_async_analytic_rows_equal_jax(scripts, devices):
    theirs, ours = scripts["bench_fleet"]
    aggs = ours.tree_aggregators(devices)
    assert aggs == {10000: 4, 100000: 8, 1_000_000: 16}[devices]
    got = ours.tree_async_analytic_point(devices, aggs)
    want = theirs.tree_async_analytic_point(devices, aggs)
    assert _untimed(got, FLEET_TIMED) == _untimed(
        want, FLEET_TIMED)


def test_fleet_run_point_matches_jax(scripts):
    """``run_point(32, 1, 16, 0)`` on JAX's initial params with JAX's
    draws: JAX's clients, chunk and byte fields exactly, its loss within
    f32 bounds."""
    theirs, ours = scripts["bench_fleet"]
    want = theirs.run_point(32, 1, 16, 0)
    spec = jfs.PopulationSpec(num_devices=32, num_classes=10, feature_dim=16,
                              shard_capacity=16, min_examples=4, seed=0)
    jsim = jfs.FleetSim.from_population(
        theirs.bench_config(16, 10), jfs.DevicePopulation(spec),
        jfs.TrafficModel(jfs.TrafficSpec(base_rate=2000.0,
                                         diurnal_amplitude=0.0, seed=0), 32),
        cohort_size=32, chunk_size=16)
    got = ours.run_point(32, 1, 16, 0, device="cpu", draws=JaxDraws(0),
                         flax_params=jax.device_get(jsim.server_state.params))
    assert set(got) == set(want) == set(ours.ROW_SCHEMA)
    for key in ("bench", "devices", "cohort", "chunk", "rounds",
                "clients_trained", "bytes_up_per_round",
                "bytes_down_per_round", "param_count"):
        assert got[key] == want[key], key
    assert got["clients_trained"] == 32
    assert got["train_loss"] == pytest.approx(want["train_loss"], rel=RTOL,
                                              abs=ATOL)


def test_fleet_measured_async_points_follow_jax_schedule(scripts):
    """The measured pruning and tree rows: every field the event schedule
    decides equals JAX's (the port draws JAX's schedule); the losses come
    from each package's own initial params."""
    theirs, ours = scripts["bench_fleet"]
    kw = dict(aggregations=12, seed=0)
    got = ours.async_prune_point(device="cpu", **kw)
    want = theirs.async_prune_point(**kw)
    for key in ("wasted_updates_unpruned", "wasted_updates_pruned",
                "waste_reduction_x", "pruned_total", "buffer_size",
                "aggregations", "max_staleness", "prune_after",
                "probation", "devices"):
        assert got[key] == want[key], key
    kw = dict(devices=200, aggregators=2, aggregations=6, chunk=64, seed=0)
    got = ours.tree_async_measured_point(device="cpu", **kw)
    want = theirs.tree_async_measured_point(**kw)
    assert _untimed(got, FLEET_TIMED) == _untimed(
        want, FLEET_TIMED)


def test_fleet_autok_and_drift_points_gate_as_jax_s(scripts):
    """The adaptive-buffering row's tracking follows JAX's schedule; the
    drift row separates the non-IID fleet from the IID one."""
    theirs, ours = scripts["bench_fleet"]
    kw = dict(aggregations=30, fixed_ks=(4, 16), seed=0)
    got = ours.async_autok_point(device="cpu", **kw)
    want = theirs.async_autok_point(**kw)
    for key in ("best_fixed_k", "tracking_auto", "tracking_best_fixed",
                "tracking_margin", "buffer_k_min_auto", "buffer_k_max_auto",
                "arrival_rate_per_min", "fixed_ks"):
        assert got[key] == want[key], key
    drift = ours.drift_point(rounds=4, device="cpu")
    assert set(drift) == set(ours.DRIFT_ROW_SCHEMA)
    assert drift["cohort_skew_noniid_mean"] > drift["cohort_skew_iid_mean"]


def test_bench_fleet_writes_schema_valid_jsonl(tmp_path):
    out = tmp_path / "fleet_bench.jsonl"
    proc = subprocess.run(
        [sys.executable, "scripts/torch_port_bench_fleet.py", "--backend",
         "cpu", "--cohorts", "32", "--rounds", "1", "--chunk", "16",
         "--mask-sweep", "--uplink-sweep", "--ingest-sweep",
         "--check-schema", "--out", str(out)],
        capture_output=True, text=True, timeout=240, cwd=str(ROOT),
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["bench"] for r in rows] == (
        ["fleet_round"] + ["fleet_mask_cost"] * 5
        + ["fleet_uplink_bytes"] * 3 + ["fleet_ingest_scaling"] * 3)
    assert rows[0]["cohort"] == 32 and rows[0]["clients_per_sec"] > 0
    assert rows[0]["bytes_up_per_round"] > 0
    assert "schema ok: 12 row(s)" in proc.stdout


# ---------------------------------------------------------- mesh_smoke --
def test_mesh_smoke_rows_equal_jax(scripts, tmp_path):
    theirs, ours = scripts["mesh_smoke"]
    assert theirs.run_smoke(4, str(tmp_path / "jax.jsonl")) == 0
    assert ours.run_smoke(4, str(tmp_path / "port.jsonl"), "cpu") == 0
    want = [json.loads(l) for l in (tmp_path / "jax.jsonl").open()]
    got = [json.loads(l) for l in (tmp_path / "port.jsonl").open()]
    assert got == want
    compare = got[-1]
    assert compare["mode"] == "compare"
    assert compare["fold_bitwise_ok"] and compare["frame_bytes_ok"]
    assert compare["hbm_ratio_sharded_over_replicated"] < 0.9
    assert compare["gather_bytes_avoided"] > 0


# ---------------------------------------------------------- bench_wire --
# The measured wire bytes carry each train reply's header, whose loss is a
# JSON float: the port's workers train from the port's own initial
# params, so a loss's repr may differ from JAX's by a few characters (the
# shortest round-trip repr of an f32-rounded double).  Those two counters
# are held within 8 bytes per reply; every other byte and count exactly.
HEADER_FLOAT_BYTES = 8
MESSAGE_BYTES = {"bytes_sent", "bytes_received", "bytes_sent_per_round",
                 "bytes_received_per_round"}
# A sender counts a message's bytes after its send returns, so JAX's bench
# may read its counters after the coordinator folded a trainer's last
# reply and before that trainer's thread counted it: under load, JAX's
# sent bytes of a round miss a reply (or carry the previous round's).
# Every message of the in-process federation is received in the same
# process and counted before the round can end, so the received bytes are
# the same messages counted without that race.  The port's bench waits
# for every send to be counted, so its sent bytes equal its received
# bytes, and both are held to JAX's received bytes.
SENT_AS_RECEIVED = {"bytes_sent": "bytes_received",
                    "bytes_sent_per_round": "bytes_received_per_round"}


def _check_wire_equal(got: dict, want: dict) -> None:
    replies = got["cohort"]

    def split(row):
        exact = {k: v for k, v in row.items()
                 if k not in WIRE_TIMED | MESSAGE_BYTES and k != "per_round"}
        return exact, {k: row[k] for k in MESSAGE_BYTES if k in row}

    for g, w in [(got, want)] + list(zip(got["per_round"],
                                         want["per_round"])):
        (g_exact, g_bytes), (w_exact, w_bytes) = split(g), split(w)
        assert g_exact == w_exact
        assert set(g_bytes) == set(w_bytes) and g_bytes
        for k in g_bytes:
            received = SENT_AS_RECEIVED.get(k, k)
            if received != k:
                assert g_bytes[k] == g_bytes[received], (k, g_bytes)
            assert abs(g_bytes[k] - w_bytes[received]) <= (
                HEADER_FLOAT_BYTES * replies), (k, g_bytes[k],
                                                w_bytes[received])
    assert len(got["per_round"]) == len(want["per_round"])


def test_wire_run_bench_deltas_equal_jax(scripts):
    """2 workers, topk up, int8 down, feedback off, tp 1, 2 rounds: every
    byte and count delta, round by round, and the row's fields equal
    JAX's (the measured message bytes within the header's floats)."""
    theirs, ours = scripts["bench_wire"]
    args = (2, "int8", "topk", False, 1, 2, 300.0, 60.0)
    want = theirs.run_bench(*args)
    got = ours.run_bench(*args, device="cpu")
    _check_wire_equal(got, want)
    assert got["encodes_per_round"] == 1
    assert got["uplink_densify_avoided_per_round"] == 2
    assert got["bytes_saved_per_round"] > 0


def test_wire_run_lora_bench_equals_jax(scripts):
    theirs, ours = scripts["bench_wire"]
    want = theirs.run_lora_bench(4, 2, 300.0, 60.0)
    got = ours.run_lora_bench(4, 2, 300.0, 60.0, device="cpu")
    _check_wire_equal(got, want)
    assert got["dense_params"] == 108_598_276
    assert got["lora_merges"] >= 1 and got["uplink_reduction_x"] >= 25.0


def test_wire_param_views_are_jax_s_shapes(scripts):
    """The port's shape-only views of the tiny BERT equal JAX's
    ``eval_shape`` tree, leaf for leaf."""
    from colearn_federated_learning_tpu.models import registry as jmodels

    theirs, ours = scripts["bench_wire"]
    cfg = theirs.lora_bench_config(2, 4).model
    model = jmodels.build_model(cfg)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, cfg.seq_len), jnp.int32),
                             train=False),
        jax.random.PRNGKey(0))["params"]
    want = jax.tree_util.tree_flatten_with_path(shapes)[0]
    got = ours.param_views(ours.lora_bench_config(2, 4).model)
    got_leaves = trees.leaves(got)
    assert len(got_leaves) == len(want)
    for (path, w), g in zip(want, got_leaves):
        assert tuple(g.shape) == tuple(w.shape), path
        assert g.dtype == np.float32 and g.strides == (0,) * g.ndim


@pytest.mark.parametrize("frame", ["dense", "topk8", "lora_r4"])
def test_wire_fold_rows_are_bitwise_with_jax_keys(scripts, frame):
    theirs, ours = scripts["bench_wire"]
    model = ours.lora_bench_config(2, 4).model
    rows = ours.run_fold_rows(frame, 4, 1, model=model, device="cpu")
    assert [(r["path"], r["batch"]) for r in rows] == [
        ("host", 1), ("device", 1), ("device", 4)]
    for r in rows:
        assert set(r) == set(theirs.FOLD_ROW_SCHEMA)
        assert r["parity_bitwise"] is True
    assert [r["kernel_backend"] for r in rows] == ["host", "plain", "plain"]


def test_wire_ckpt_rows_restore_bitwise_with_jax_keys(scripts):
    theirs, ours = scripts["bench_wire"]
    model = ours.lora_bench_config(2, 4).model
    rows = ours.run_ckpt_rows(2, 1, model=model, device="cpu")
    assert [r["path"] for r in rows] == ["sharded", "gathered"]
    for r in rows:
        assert set(r) == set(theirs.CKPT_ROW_SCHEMA)
        assert r["restore_bitwise"] is True
    assert rows[0]["gather_avoided"] > 0 and rows[0]["shards_per_gen"] == 2


# ------------------------------------------------------ perf_north_star --
# 8 clients, all in the cohort: JAX's learner lays them over the 8 forced
# host devices (one each), the port's runs them on one device.
TINY = ["--num-clients", "8", "--cohort", "8", "--local-steps", "1",
        "--batch", "4", "--width", "8", "--examples-per-client", "8",
        "--rounds", "2", "--warmup", "1"]


def test_perf_north_star_lines_have_jax_s_keys(scripts, tmp_path,
                                                monkeypatch, capsys):
    theirs, ours = scripts["perf_north_star"]
    monkeypatch.setattr(sys, "argv", ["perf_north_star.py", *TINY,
                                      "--out", str(tmp_path / "jax.jsonl")])
    theirs.main()
    assert ours.main([*TINY, "--backend", "cpu",
                      "--out", str(tmp_path / "port.jsonl")]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = [json.loads(l) for l in (tmp_path / "jax.jsonl").open()]
    got = [json.loads(l) for l in (tmp_path / "port.jsonl").open()]
    assert [r["kind"] for r in got] == [r["kind"] for r in want] == [
        "meta", "round", "round", "summary"]
    for g, w in zip(got, want):
        assert set(g) == set(w)
    assert summary == got[-1]
    for key in ("server_bytes_per_chip", "cohort", "local_steps",
                "num_clients", "tp_size", "gather_bytes_avoided"):
        assert got[-1][key] == want[-1][key], key
    assert got[-1]["flops_per_round"] > 0
    assert got[-1]["model_flops_utilization"] is None   # no peak for a CPU


# ------------------------------------------------------------ no card --
@pytest.mark.parametrize("name,argv", [
    ("bench_fleet", ["--cohorts", "32", "--mask-sweep"]),
    ("mesh_smoke", []),
    ("bench_wire", ["--lora-only"]),
    ("perf_north_star", []),
])
def test_scripts_exit_nonzero_without_a_card(scripts, name, argv, tmp_path,
                                             monkeypatch, capsys):
    _, ours = scripts[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "rows.jsonl"
    try:
        rc = ours.main([*argv, "--out", str(out)])
    except SystemExit as e:
        rc = e.code
    assert rc == 1
    assert not out.exists()
    assert "no CUDA device" in capsys.readouterr().err
