"""The port's SLO sentinel (``analysis/sentinel.py``) against the JAX
package's: every case of ``tests/test_sentinel.py`` (static and window
rules, reordering, torn tails, missing files, duplicate ids, the command
line) run through both modules, whose verdicts agree apart from
``root``; the repo's rules over the committed ``results/``; and the live
sentinels judging rows the port's ``FleetSim`` wrote (on the CPU here;
``chip_smoke.py`` 21b and 21c on the card)."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from colearn_federated_learning_tpu import cli as jax_cli
from colearn_federated_learning_tpu.analysis import sentinel as jax_sentinel
from colearn_federated_learning_tpu_torch import cli
from colearn_federated_learning_tpu_torch.analysis import sentinel

ROOT = Path(__file__).resolve().parents[1]
MODULES = {"jax": jax_sentinel, "port": sentinel}

FLEET_ROWS = [
    {"bench": "fleet_round", "devices": 1000, "rounds_per_sec": 27.7},
    {"bench": "fleet_round", "devices": 1000000, "rounds_per_sec": 0.022},
    {"bench": "fleet_round", "devices": 1000000, "rounds_per_sec": 0.031},
]


def write_rows(path, rows):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))


def write_rules(root, rules_toml):
    (root / "pyproject.toml").write_text("[tool.colearn.slo]\n" + rules_toml)


def _outcome(fn):
    """``fn()``'s value, or its error as (type name, message)."""
    try:
        return fn()
    except (ValueError, KeyError) as e:
        return (type(e).__name__, str(e))


def _both(fn):
    """``fn(module)`` for the JAX module and the port's; asserts the two
    agree (a verdict's ``root`` aside) and returns the port's."""
    out = {}
    for name, mod in MODULES.items():
        got = _outcome(lambda: fn(mod))
        if isinstance(got, dict) and "root" in got:
            got = {k: v for k, v in got.items() if k != "root"}
        out[name] = got
    assert out["port"] == out["jax"]
    return out["port"]


def _port_exit(argv) -> int:
    try:
        cli.main(argv)
    except SystemExit as e:
        return e.code
    return 0


def _cli_both(argv, capsys):
    """(exit, stdout, stderr) of JAX's ``colearn sentinel`` and the
    port's; asserts they agree and returns the port's."""
    rc = jax_cli.main(argv)
    theirs = capsys.readouterr()
    ours_rc = _port_exit(argv)
    ours = capsys.readouterr()
    assert (ours_rc, ours.out, ours.err) == (rc, theirs.out, theirs.err)
    return ours_rc, ours.out, ours.err


# ----------------------------------------------------------- rule shape --
@pytest.mark.parametrize("kw,match", [
    (dict(id="r", file="f", field="x", agg="last", min=0),
     "order-independent"),
    (dict(id="r", file="f", field="x", agg="min"), "min and/or max"),
    (dict(id="r", file="f", agg="mean", min=0), "needs a field")])
def test_rule_validation_rejects_bad_tables(kw, match):
    got = _both(lambda m: m.SloRule(**kw))
    assert got[0] == "ValueError" and match in got[1]


def test_unknown_keys_rejected():
    got = _both(lambda m: m.SloRule.from_table(
        {"id": "r", "file": "f", "field": "x", "min": 0, "threshold": 1}))
    assert "unknown keys" in got[1]


def test_duplicate_rule_ids_rejected(tmp_path):
    write_rules(tmp_path, """
[[tool.colearn.slo.rules]]
id = "dup"
file = "results/a.jsonl"
field = "x"
min = 0

[[tool.colearn.slo.rules]]
id = "dup"
file = "results/b.jsonl"
field = "x"
min = 0
""")
    got = _both(lambda m: m.load_rules(str(tmp_path)))
    assert got[0] == "ValueError" and "duplicate" in got[1]


# ----------------------------------------------------------- evaluation --
def test_where_filter_and_min_bound(tmp_path):
    write_rows(tmp_path / "results" / "fleet.jsonl", FLEET_ROWS)
    res = _both(lambda m: m.SloRule(
        id="r", file="results/fleet.jsonl", field="rounds_per_sec",
        agg="min", where={"devices": 1000000}, min=0.01).evaluate(
        str(tmp_path)))
    assert res["ok"] and res["rows"] == 2 and res["value"] == 0.022


def test_violation_reports_reason(tmp_path):
    write_rows(tmp_path / "results" / "fleet.jsonl", FLEET_ROWS)
    res = _both(lambda m: m.SloRule(
        id="r", file="results/fleet.jsonl", field="rounds_per_sec",
        agg="min", where={"devices": 1000000}, min=5.0).evaluate(
        str(tmp_path)))
    assert not res["ok"] and res["reason"].startswith("below_min:")


def test_max_bound_and_count_agg(tmp_path):
    write_rows(tmp_path / "results" / "fleet.jsonl", FLEET_ROWS)
    over = _both(lambda m: m.SloRule(
        id="hi", file="results/fleet.jsonl", field="rounds_per_sec",
        agg="max", max=10.0).evaluate(str(tmp_path)))
    assert not over["ok"]
    count = _both(lambda m: m.SloRule(
        id="n", file="results/fleet.jsonl", agg="count",
        where={"devices": 1000000}, min=2).evaluate(str(tmp_path)))
    assert count["ok"]


@pytest.mark.parametrize("allow", [False, True])
def test_missing_file_and_rows(allow, tmp_path):
    res = _both(lambda m: m.SloRule(
        id="r", file="results/nope.jsonl", field="x", min=0,
        allow_missing=allow).evaluate(str(tmp_path)))
    assert res["ok"] == allow
    assert res["reason"] == ("missing_allowed" if allow else "file_missing")
    write_rows(tmp_path / "results" / "fleet.jsonl", FLEET_ROWS)
    res = _both(lambda m: m.SloRule(
        id="r", file="results/fleet.jsonl", field="rounds_per_sec",
        where={"devices": 7}, min=0, allow_missing=allow).evaluate(
        str(tmp_path)))
    assert res["reason"] == ("no_rows_allowed" if allow
                             else "no_matching_rows")


def test_empty_rule_set_is_not_a_green_verdict(tmp_path):
    verdict = _both(lambda m: m.evaluate_slo(str(tmp_path)))
    assert verdict["rules"] == 0 and not verdict["ok"]
    assert verdict["schema"] == "colearn-slo-verdict-v1"


def test_verdict_is_stable_under_row_reordering(tmp_path):
    def rules(m):
        return [
            m.SloRule(id="lo", file="results/f.jsonl",
                      field="rounds_per_sec", agg="min",
                      where={"devices": 1000000}, min=0.01),
            m.SloRule(id="mean", file="results/f.jsonl",
                      field="rounds_per_sec", agg="mean", max=50.0),
            m.SloRule(id="n", file="results/f.jsonl", agg="count", min=3)]

    write_rows(tmp_path / "results" / "f.jsonl", FLEET_ROWS)
    forward = _both(lambda m: m.evaluate_slo(str(tmp_path), rules=rules(m)))
    write_rows(tmp_path / "results" / "f.jsonl", FLEET_ROWS[::-1])
    backward = _both(lambda m: m.evaluate_slo(str(tmp_path), rules=rules(m)))
    assert forward["results"] == backward["results"]
    assert forward["ok"] and backward["ok"]


# -------------------------------------------------------------- loading --
@pytest.mark.parametrize("text,want", [
    ('{"a": 1}\n{"a": 2}\n{"a": 3, "tru', [1, 2]),
    ('{"a": 1}\n{"a": 2, "tru\n{"a": 3}\n', "corrupt JSONL"),
    ('{"a": 1}\n\n[1, 2]\n{"a": 4}\n', [1, 4])])
def test_jsonl_loader_tolerates_torn_tail_only(text, want, tmp_path):
    p = tmp_path / "rows.jsonl"
    p.write_text(text)
    got = _both(lambda m: [r["a"] for r in m.load_jsonl_rows(str(p))])
    if isinstance(want, str):
        assert got[0] == "ValueError" and want in got[1]
    else:
        assert got == want


def test_load_rules_from_pyproject(tmp_path):
    write_rules(tmp_path, """
[[tool.colearn.slo.rules]]
id = "fleet"
file = "results/f.jsonl"
where = { devices = 1000000 }
field = "rounds_per_sec"
agg = "min"
min = 0.01
""")
    got = _both(lambda m: [(type(r).__name__, r.id, r.where, r.field, r.agg,
                            r.min) for r in m.load_rules(str(tmp_path))])
    assert got == [("SloRule", "fleet", {"devices": 1000000},
                    "rounds_per_sec", "min", 0.01)]


# ------------------------------------------------------------ CLI gate --
def test_cli_sentinel_fails_on_injected_regression(tmp_path, capsys):
    write_rules(tmp_path, """
[[tool.colearn.slo.rules]]
id = "fleet-1m-round-rate"
file = "results/fleet_bench.jsonl"
where = { devices = 1000000 }
field = "rounds_per_sec"
agg = "min"
min = 0.01
""")
    write_rows(tmp_path / "results" / "fleet_bench.jsonl",
               [{"devices": 1000000, "rounds_per_sec": 0.002}])
    argv = ["sentinel", "--root", str(tmp_path)]
    rc, out, _ = _cli_both(argv, capsys)
    assert rc == 1 and "below_min" in out and "VIOLATION" in out
    write_rows(tmp_path / "results" / "fleet_bench.jsonl",
               [{"devices": 1000000, "rounds_per_sec": 0.03}])
    rc, out, _ = _cli_both(argv, capsys)
    assert rc == 0 and "sentinel verdict: OK" in out


def test_cli_sentinel_json_verdict(tmp_path, capsys):
    write_rules(tmp_path, """
[[tool.colearn.slo.rules]]
id = "n"
file = "results/f.jsonl"
agg = "count"
min = 1
""")
    write_rows(tmp_path / "results" / "f.jsonl", [{"x": 1}])
    rc, out, _ = _cli_both(["sentinel", "--root", str(tmp_path), "--format",
                            "json"], capsys)
    doc = json.loads(out)
    assert rc == 0 and doc["schema"] == "colearn-slo-verdict-v1"
    assert doc["ok"] and doc["rules"] == 1


def test_cli_sentinel_malformed_table_exits_2(tmp_path, capsys):
    write_rules(tmp_path, """
[[tool.colearn.slo.rules]]
id = "bad"
file = "results/f.jsonl"
field = "x"
agg = "last"
min = 0
""")
    rc, _, err = _cli_both(["sentinel", "--root", str(tmp_path)], capsys)
    assert rc == 2 and err.startswith("colearn sentinel: slo rule 'bad'")


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_repo_slo_rules_hold_against_committed_results(fmt, capsys):
    """The repo's 32 rules over the committed ``results/``: the same
    verdict from both modules and both commands, ``ok``."""
    verdict = _both(lambda m: m.evaluate_slo(str(ROOT)))
    assert verdict["ok"] and verdict["rules"] == 32
    assert verdict["violations"] == 0
    rc, out, _ = _cli_both(["sentinel", "--root", str(ROOT), "--format",
                            fmt], capsys)
    assert rc == 0
    if fmt == "json":
        assert json.loads(out)["results"] == verdict["results"]


# ------------------------------------------------------- window rules --
def _round_rows(values):
    return [{"round": r, "phase_agg_fold_s": v} for r, v in enumerate(values)]


def _window(m, **kw):
    args = dict(id="fold-p99", file="results/rounds.jsonl",
                field="phase_agg_fold_s", window=5, baseline=20,
                agg="p99", baseline_agg="median", max_ratio=1.5)
    args.update(kw)
    return m.WindowRule(**args)


def test_window_rule_fires_on_injected_latency_regression(tmp_path, capsys):
    write_rows(tmp_path / "results" / "rounds.jsonl",
               _round_rows([0.10] * 20 + [0.25] * 5))
    res = _both(lambda m: _window(m).evaluate(str(tmp_path)))
    assert not res["ok"] and res["value"] == pytest.approx(2.5)
    assert res["reason"].startswith("above_max_ratio:2.5")
    assert res["window_value"] == pytest.approx(0.25)
    assert res["baseline_value"] == pytest.approx(0.10)
    write_rules(tmp_path, """
[[tool.colearn.slo.rules]]
id = "fold-p99"
file = "results/rounds.jsonl"
field = "phase_agg_fold_s"
window = 5
baseline = 20
max_ratio = 1.5
""")
    rc, out, _ = _cli_both(["sentinel", "--root", str(tmp_path)], capsys)
    assert rc == 1 and "above_max_ratio" in out and "VIOLATION" in out


def test_window_rule_steady_state_stays_green(tmp_path):
    write_rows(tmp_path / "results" / "rounds.jsonl",
               _round_rows([0.10 + (r % 4) * 0.002 for r in range(25)]))
    res = _both(lambda m: _window(m).evaluate(str(tmp_path)))
    assert res["ok"] and res["reason"] is None
    assert res["value"] == pytest.approx(0.106 / 0.104)


def test_window_rule_is_stable_under_row_reordering(tmp_path):
    rows = _round_rows([0.10] * 20 + [0.25] * 5)
    write_rows(tmp_path / "results" / "rounds.jsonl", rows)
    forward = _both(lambda m: _window(m).evaluate(str(tmp_path)))
    write_rows(tmp_path / "results" / "rounds.jsonl",
               rows[1::2] + rows[0::2][::-1])
    assert _both(lambda m: _window(m).evaluate(str(tmp_path))) == forward


@pytest.mark.parametrize("allow", [False, True])
def test_window_rule_insufficient_history(allow, tmp_path):
    write_rows(tmp_path / "results" / "rounds.jsonl", _round_rows([0.1] * 10))
    res = _both(lambda m: _window(m, allow_missing=allow).evaluate(
        str(tmp_path)))
    assert res["ok"] == allow and res["reason"] == "insufficient_rows:10<25"


@pytest.mark.parametrize("values,reason", [
    ([0.0] * 25, "baseline_not_positive:0"),
    ([1.0] * 20 + [0.1] * 5, "below_min_ratio:0.1<0.5")])
def test_window_rule_baseline_and_floor(values, reason, tmp_path):
    write_rows(tmp_path / "results" / "rounds.jsonl", _round_rows(values))
    res = _both(lambda m: _window(m, max_ratio=None, min_ratio=0.5,
                                  agg="median").evaluate(str(tmp_path)))
    assert not res["ok"] and res["reason"] == reason


@pytest.mark.parametrize("table,kind", [
    ({"id": "w", "file": "f", "field": "x", "window": 5, "max_ratio": 1.5},
     "WindowRule"),
    ({"id": "s", "file": "f", "field": "x", "agg": "mean", "min": 0},
     "SloRule"),
    ({"id": "w", "file": "f", "field": "x", "window": 5},
     "max_ratio and/or min_ratio"),
    ({"id": "w", "file": "f", "field": "x", "window": 5, "agg": "last",
      "max_ratio": 1.5}, "not in"),
    ({"id": "w", "file": "f", "field": "x", "window": 5, "max_ratio": 1.5,
      "threshold": 2}, "unknown keys")])
def test_window_rule_validation_and_dispatch(table, kind):
    got = _both(lambda m: type(m.rule_from_table(table)).__name__)
    if isinstance(got, tuple):
        assert got[0] == "ValueError" and kind in got[1]
    else:
        assert got == kind


def test_render_verdict_is_jax_s(tmp_path):
    write_rows(tmp_path / "results" / "rounds.jsonl",
               _round_rows([0.10] * 20 + [0.25] * 5))
    write_rows(tmp_path / "results" / "fleet.jsonl", FLEET_ROWS)

    def render(m):
        rules = [_window(m),
                 m.SloRule(id="r", file="results/fleet.jsonl",
                           field="rounds_per_sec", min=0.01),
                 m.SloRule(id="n", file="results/none.jsonl", agg="count",
                           min=1, allow_missing=True)]
        return m.render_verdict(m.evaluate_slo(str(tmp_path), rules))

    assert "VIOLATION" in _both(render)
    assert _both(lambda m: m.render_verdict(m.evaluate_slo(str(tmp_path)))
                 ).startswith("no SLO rules configured")


# ---------------------------------------- the live sentinels, port rows --
def _jsonable(obj):
    if hasattr(obj, "item") and not isinstance(obj, (list, dict)):
        return obj.item()
    return obj.tolist()


def _events_root(tmp_path, name, file, recs):
    root = tmp_path / name
    (root / "results").mkdir(parents=True)
    shutil.copy(ROOT / "pyproject.toml", root / "pyproject.toml")
    (root / "results" / file).write_text("".join(
        json.dumps({"event": "round", **r}, default=_jsonable) + "\n"
        for r in recs))
    return str(root)


def _live(root, part):
    """Both modules' verdicts on the repo's rules over ``part`` files, by
    rule id (asserted equal)."""
    verdict = _both(lambda m: m.evaluate_slo(
        root, [r for r in m.load_rules(root) if part in r.file]))
    return {r["id"]: r for r in verdict["results"]}


def _learn_fleet(**fed_kw):
    """The JAX package's ``scripts/learn_smoke.py`` configuration through
    the port's FleetSim on the CPU (``chip_smoke.py`` 21b on the card)."""
    from colearn_federated_learning_tpu_torch import fleetsim
    from colearn_federated_learning_tpu_torch.utils.config import (
        ExperimentConfig, FedConfig, ModelConfig, RunConfig)

    cfg = ExperimentConfig(
        model=ModelConfig(name="mlp", num_classes=10, hidden_dim=32,
                          depth=1),
        fed=FedConfig(strategy="fedavg", local_steps=2, batch_size=8,
                      lr=0.05, momentum=0.0, **fed_kw),
        run=RunConfig(name="learn_smoke", seed=0, learn_observe=True))
    spec = fleetsim.PopulationSpec(num_devices=64, feature_dim=16,
                                   shard_capacity=16, min_examples=4, seed=0)
    traffic = fleetsim.TrafficModel(
        fleetsim.TrafficSpec(base_rate=2000.0, diurnal_amplitude=0.0,
                             seed=0), spec.num_devices)
    return fleetsim.FleetSim.from_population(
        cfg, fleetsim.DevicePopulation(spec), traffic, cohort_size=16,
        chunk_size=16, device="cpu")


def test_learn_smoke_rows_of_the_port_trip_the_divergence_sentinel(
        tmp_path):
    clean = _learn_fleet().fit(12)
    ok = _live(_events_root(tmp_path, "clean", "learn_events.jsonl", clean),
               "learn_events")
    assert sorted(ok) == ["fleet-learn-cohort-skew-ceiling",
                          "live-learn-divergence", "live-learn-plateau"]
    assert all(r["ok"] for r in ok.values())
    for rid in ("live-learn-divergence", "live-learn-plateau"):
        assert ok[rid]["rows"] == 12 and ok[rid]["value"] is not None
    spiked = _learn_fleet(lr_spike_round=9, lr_spike_multiplier=10.0).fit(12)
    assert (round(spiked[8]["conv_update_norm"], 6)
            == round(clean[8]["conv_update_norm"], 6))
    red = _live(_events_root(tmp_path, "spike", "learn_events.jsonl",
                             spiked[:12]), "learn_events")
    div = red["live-learn-divergence"]
    assert not div["ok"] and div["reason"].startswith("above_max_ratio")


def test_async_rows_of_the_port_are_judged_by_the_staleness_sentinel(
        tmp_path):
    """The asynchronous FleetSim with observe on (1,000 devices here,
    10,000 in ``chip_smoke.py`` 21c) for 30 aggregations: the staleness
    tail rule judges its rows; the arrival-rate floor finds none, since
    it reads the coordinator's ``arrival_rate_per_s``."""
    from colearn_federated_learning_tpu_torch import fleetsim
    from colearn_federated_learning_tpu_torch.utils.config import (
        ExperimentConfig, FedConfig, ModelConfig, RunConfig)

    spec = fleetsim.PopulationSpec(num_devices=1000, seed=0)
    sim = fleetsim.FleetSim.from_population(
        ExperimentConfig(model=ModelConfig(name="mlp", num_classes=10,
                                           hidden_dim=16, depth=1),
                         fed=FedConfig(local_steps=1, batch_size=8),
                         run=RunConfig(name="async", seed=0)),
        fleetsim.DevicePopulation(spec),
        fleetsim.TrafficModel(fleetsim.TrafficSpec(seed=0),
                              spec.num_devices),
        cohort_size=32, chunk_size=32, device="cpu")
    recs = sim.fit_async(30, buffer_size=8, observe=True)
    assert len(recs) == 30 and all(np.isfinite(r["staleness_p99"])
                                   for r in recs)
    got = _live(_events_root(tmp_path, "async", "async_events_port.jsonl",
                             recs), "async_events")
    tail = got["live-async-staleness-tail-drift"]
    assert tail["rows"] == 30 and tail["value"] is not None and tail["ok"]
    rate = got["live-async-arrival-rate-floor"]
    assert rate["ok"] and rate["reason"] == "insufficient_rows:0<25"
