"""The port's fault plane (``faults/``) against the JAX package's, on the
CPU at small sizes.

- The same plan file and seed give the same decisions: the specs that fire
  for each ``(device, round, op, hop, site)`` event, probability gates and
  firing budgets included, and the same ledger.
- The injector acts at the same transport seams with the same outcome:
  a flap is retried, a dropped request times out and the next one passes,
  a corrupt reply is retried, a crashed server stays dead.
- A federation under one plan records the same ``dropped`` and the same
  retries as JAX's under that plan; straggler drop, eviction after
  ``evict_after`` failed rounds, elastic admission and the quorum no-op
  give JAX's records.
- The file plane's hooks (a dropped silo, a stale round stamp, a torn
  file) give the JAX package's outcomes, and the hierarchical sync's lost
  uplinks (the mean renormalized over the surviving groups) and lost
  downlinks (a group keeps its stale model) give JAX's params at f32
  rtol 1e-4 / atol 2e-5.
- ``validate_robustness`` raises JAX's errors.
"""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu import faults as jax_faults
from colearn_federated_learning_tpu.comm import transport as jax_transport
from colearn_federated_learning_tpu.fed import offline as jax_offline
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu_torch import faults
from colearn_federated_learning_tpu_torch.comm import protocol, transport
from colearn_federated_learning_tpu_torch.fed import offline
from colearn_federated_learning_tpu_torch.utils import config
from test_torch_port_hierarchical import (
    _configs as hier_configs, _fit_with_snapshots, _pair)
from test_torch_port_round import JaxDraws
from test_torch_port_socket import (
    WAIT, Federation, assert_records_match, configs, params_of)

RTOL, ATOL = 1e-4, 2e-5

PLAN = {"seed": 7, "faults": [
    {"kind": "delay", "device_id": "1", "round": 2, "op": "train", "ms": 5},
    {"kind": "drop_request", "probability": 0.4, "count": 0},
    {"kind": "corrupt_payload", "device_id": "2", "count": 2},
    {"kind": "flap_reconnect", "site": "client", "op": "train",
     "probability": 0.5, "count": 3},
    {"kind": "drop_silo", "device_id": "g1", "hop": "sync",
     "probability": 0.7, "count": 0},
    {"kind": "stale_round", "round": 3, "hop": "update"},
    {"kind": "crash_worker", "device_id": "3", "round": 4}]}


@pytest.fixture(autouse=True)
def _clean():
    """One torch thread; no plan left installed by a test."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    faults.uninstall()
    jax_faults.uninstall()


def test_plan_decisions_are_jax_decisions():
    text = json.dumps(PLAN)
    ours = faults.FaultPlan.from_json(text, seed=11)
    theirs = jax_faults.FaultPlan.from_json(text, seed=11)
    assert json.loads(ours.to_json()) == json.loads(theirs.to_json())
    events = [(str(d), r, op, hop, site)
              for d in range(5) for r in (None, 0, 2, 3, 4)
              for op in ("train", "unmask", "")
              for hop in (faults.ANY, "update", "sync")
              for site in ("server", "client")]
    for dev, r, op, hop, site in events * 2:
        got = ours.match(dev, r, op, site=site, hop=hop)
        want = theirs.match(dev, r, op, site=site, hop=hop)
        assert [dataclasses.asdict(f) for f in got] == \
            [dataclasses.asdict(f) for f in want], (dev, r, op, hop, site)
    assert ours.fired == theirs.fired and ours.total_fired() > 10
    assert faults.KINDS == jax_faults.KINDS
    assert faults.FILE_KINDS == jax_faults.FILE_KINDS


@pytest.mark.parametrize("bad", [dict(kind="explode"),
                                 dict(kind="delay", site="middle"),
                                 dict(kind="delay", probability=1.5),
                                 dict(kind="delay", ms=-1)])
def test_spec_validation_is_jax_validation(bad):
    with pytest.raises(ValueError) as ours:
        faults.FaultSpec(**bad)
    with pytest.raises(ValueError) as theirs:
        jax_faults.FaultSpec(**bad)
    assert str(ours.value) == str(theirs.value)


def _transport_outcomes(side, doc):
    """Four requests to one server under ``doc``: each one's outcome."""
    mod, fmod = ((transport, faults) if side == "port"
                 else (jax_transport, jax_faults))
    fmod.install(fmod.FaultPlan.from_json(json.dumps(doc)))
    out = []
    with mod.TensorServer(lambda h, t: ({"meta": {"n": h["round"]}}, None),
                          ident="1") as srv:
        cli = mod.TensorClient(srv.host, srv.port, ident="1")
        retry = mod.RetryPolicy(max_retries=2, backoff_base=0.01)
        for r in range(4):
            try:
                h, _ = cli.request({"op": "train", "round": r}, None,
                                   timeout=0.5, retry=retry)
                out.append(("ok", h["meta"]["n"]))
            except TimeoutError:
                out.append(("timeout", r))
                cli.close()
                cli = mod.TensorClient(srv.host, srv.port, ident="1")
            except (OSError, protocol.ConnectionClosed,
                    jax_transport.protocol.ConnectionClosed):
                out.append(("dead", r))
        cli.close()
    fmod.uninstall()
    return out


@pytest.mark.parametrize("faults_doc", [
    [{"kind": "flap_reconnect", "device_id": "1", "round": 0}],
    [{"kind": "drop_request", "device_id": "1", "round": 1}],
    [{"kind": "corrupt_payload", "device_id": "1", "round": 2}],
    [{"kind": "crash_worker", "device_id": "1", "round": 2}],
    [{"kind": "delay", "device_id": "1", "round": 0, "ms": 50},
     {"kind": "flap_reconnect", "device_id": "1", "site": "client",
      "round": 3}]])
def test_injected_faults_act_as_in_jax(faults_doc):
    doc = {"seed": 0, "faults": faults_doc}
    ours = _transport_outcomes("port", doc)
    assert ours == _transport_outcomes("jax", doc)
    assert ours[0][0] == "ok"


FED_PLAN = {"seed": 3, "faults": [
    {"kind": "delay", "device_id": "1", "round": 1, "op": "train",
     "ms": 4000},
    {"kind": "corrupt_payload", "device_id": "2", "round": 2,
     "op": "train"}]}


def _faulted_federation(side):
    cfgs = configs(num_clients=3)
    mod = faults if side == "port" else jax_faults
    with Federation(cfgs, 3, coord=side, workers=side, want_evaluator=False,
                    round_timeout=2.0) as f:
        mod.install(mod.FaultPlan.from_json(json.dumps(FED_PLAN)))
        f.coord.round_timeout = 30.0
        recs = [f.coord.run_round()]
        f.coord.round_timeout = 2.0
        recs.append(f.coord.run_round())
        time.sleep(2.5)              # let the delayed worker drain
        f.coord.round_timeout = 30.0
        recs.append(f.coord.run_round())
        mod.uninstall()
        return recs


def test_federation_under_a_plan_records_jax_drops():
    ours, theirs = _faulted_federation("port"), _faulted_federation("jax")
    assert [r["dropped"] for r in ours] == [[], ["1"], []]
    assert [r["completed"] for r in ours] == [3, 2, 3]
    assert ours[2].get("retries") == theirs[2].get("retries") == 1
    assert_records_match(ours, theirs)


def _hang(worker, seconds, done):
    orig = worker._train

    def hang(*args, **kw):
        time.sleep(seconds)
        done.set()
        return orig(*args, **kw)

    worker._train = hang
    return orig


def _straggler(side):
    cfgs = configs(num_clients=3)
    with Federation(cfgs, 3, coord=side, workers=side,
                    want_evaluator=False) as f:
        recs = [f.coord.run_round()]
        done = threading.Event()
        orig = _hang(f.workers[1], 4.0, done)
        f.coord.round_timeout = 2.0
        recs.append(f.coord.run_round())
        f.workers[1]._train = orig
        done.wait(WAIT)
        f.coord.round_timeout = 30.0
        recs.append(f.coord.run_round())
        return recs


def test_straggler_drop_gives_jax_records():
    ours, theirs = _straggler("port"), _straggler("jax")
    assert [r["completed"] for r in ours] == [3, 2, 3]
    assert ours[1]["dropped"] == ["1"] and not ours[2]["dropped"]
    assert_records_match(ours, theirs)


def _elastic(side):
    cfgs = configs(num_clients=4)
    with Federation(cfgs, 2, coord=side, workers=side,
                    want_evaluator=False) as f:
        recs = [f.coord.run_round()]
        late = f.add_worker(2)
        admitted = []
        deadline = time.monotonic() + WAIT
        while not admitted and time.monotonic() < deadline:
            admitted = f.coord.refresh_membership(poll=0.1)
        recs.append(f.coord.run_round())
        late.stop()
        f.coord.round_timeout = 2.0
        evicted = []
        for _ in range(f.coord.evict_after + 1):
            rec = f.coord.run_round()
            recs.append(rec)
            evicted += rec["evicted"]
            if evicted:
                break
        f.coord.round_timeout = 30.0
        recs.append(f.coord.run_round())
        return admitted, evicted, [t.device_id for t in f.coord.trainers], recs


def test_elastic_admission_and_eviction_give_jax_records():
    ours, theirs = _elastic("port"), _elastic("jax")
    assert ours[:3] == (["2"], ["2"], ["0", "1"])
    assert ours[:3] == theirs[:3]
    assert [r["completed"] for r in ours[3]] == [2, 3, 2, 2, 2, 2]
    assert [r["evicted"] for r in ours[3]] == [[], [], [], [], ["2"], []]
    assert_records_match(ours[3], theirs[3])


def test_quorum_round_is_a_noop_as_in_jax():
    out = {}
    for side in ("port", "jax"):
        cfgs = configs(num_clients=3, min_cohort_fraction=0.9)
        with Federation(cfgs, 3, coord=side, workers=side,
                        want_evaluator=False) as f:
            f.coord.run_round()          # warm-up: JAX's workers compile
            before = params_of(f.coord)
            f.workers[2].stop()
            f.coord.round_timeout = 2.0
            rec = f.coord.run_round()
            out[side] = (rec, before, params_of(f.coord))
    rec, before, after = out["port"]
    assert rec["skipped_quorum"] and rec["completed"] == 2
    assert np.isnan(rec["train_loss"])
    assert all(np.array_equal(before[k], after[k]) for k in before)
    assert_records_match([rec], [out["jax"][0]])


FILE_PLAN = {"seed": 1, "faults": [
    {"kind": "drop_silo", "device_id": "0", "hop": "update"},
    {"kind": "stale_round", "device_id": "1", "hop": "update"},
    {"kind": "truncate_file", "device_id": "2", "hop": "update"}]}


def _file_plane(side, cfg, tmp_path):
    mod, fmod = ((offline, faults) if side == "port"
                 else (jax_offline, jax_faults))
    g0 = str(tmp_path / f"{side}_g0.npz")
    kw = {"device": "cpu"} if side == "port" else {}
    mod.init_global_model(cfg, g0, **kw)
    fmod.install(fmod.FaultPlan.from_json(json.dumps(FILE_PLAN)))
    outs, paths = [], []
    for cid in range(4):
        path = str(tmp_path / f"{side}_u{cid}.npz")
        extra = dict(kw, draws=JaxDraws(cfg.run.seed)) if kw else {}
        outs.append(mod.client_update(cfg, cid, g0, path, **extra))
        if os.path.exists(path):
            paths.append(path)
    fmod.uninstall()
    agg = mod.aggregate_updates(cfg, g0, paths, str(tmp_path / f"{side}_g1"),
                                **kw)
    return outs, agg


def test_file_plane_hooks_give_jax_outcomes(tmp_path):
    jcfg, tcfg = configs(num_clients=4)
    ours = _file_plane("port", tcfg, tmp_path)
    theirs = _file_plane("jax", jcfg, tmp_path)
    assert ours[0][0] == theirs[0][0] == {
        "client_id": 0, "round": 0, "weight": 0.0, "dropped": True}
    assert [o.get("dropped", False) for o in ours[0]] == \
        [o.get("dropped", False) for o in theirs[0]]
    assert ours[1]["num_updates"] == theirs[1]["num_updates"] == 1
    assert ours[1]["num_rejected"] == theirs[1]["num_rejected"] == 2
    reasons = [r.split(" ")[0:2] for r in ours[1]["rejected"]]
    assert reasons == [r.split(" ")[0:2] for r in theirs[1]["rejected"]]
    assert [r[0] for r in reasons] == ["stale", "bad"]


@pytest.mark.parametrize("plan_faults", [
    [{"kind": "drop_silo", "device_id": "g1", "round": 1, "hop": "sync"}],
    [{"kind": "drop_silo", "device_id": "g0", "round": 1, "hop": "seed"}],
    [{"kind": "drop_silo", "device_id": "g0", "round": 1, "hop": "sync"},
     {"kind": "drop_silo", "device_id": "g1", "round": 1, "hop": "sync"}]])
def test_hierarchical_sync_under_a_plan_matches_jax(plan_faults):
    """Lost uplinks renormalize the cloud mean over the survivors (all
    lost: the cloud stays stale); a lost downlink keeps the group's own
    model; every group and the cloud agree with JAX after every round."""
    doc = json.dumps({"seed": 2, "faults": plan_faults})
    jcfg, tcfg = hier_configs(fed_kw=dict(rounds=3))
    jh, th = _pair(jcfg, tcfg)
    jax_faults.install(jax_faults.FaultPlan.from_json(doc))
    jsnaps = _fit_with_snapshots(jh, 3, port=False)
    jax_faults.uninstall()
    faults.install(faults.FaultPlan.from_json(doc))
    tsnaps = _fit_with_snapshots(th, 3, port=True)
    faults.uninstall()
    for (trec, tgroups, tcloud), (jrec, jgroups, jcloud) in zip(tsnaps,
                                                                jsnaps):
        assert trec.get("groups_dropped") == jrec.get("groups_dropped")
        assert trec["synced"] == jrec["synced"]
        for tg, jg in zip(tgroups + [tcloud], jgroups + [jcloud]):
            for name in tg:
                np.testing.assert_allclose(tg[name], jg[name], rtol=RTOL,
                                           atol=ATOL, err_msg=name)
    if plan_faults[0]["hop"] == "sync":
        assert tsnaps[1][0]["groups_dropped"] == [
            f["device_id"] for f in plan_faults]


@pytest.mark.parametrize("fed,run", [
    ({}, dict(evict_after=0)), (dict(min_cohort_fraction=1.5), {}),
    ({}, dict(comm_retries=-1)), ({}, dict(comm_backoff_max=-1.0)),
    (dict(lr_spike_round=-2), {}), (dict(lr_spike_multiplier=0.0), {}),
    ({}, dict(worker_enroll_timeout=0)), (dict(compress="gzip"), {}),
    (dict(compress_down="gzip"), {}), (dict(topk_fraction=0.0), {}),
    (dict(secure_agg=True, compress_feedback=True), {}),
    (dict(topk_adaptive=True, compress="int8"), {}),
    (dict(topk_adaptive=True, compress="topk", compress_feedback=True,
          topk_min_fraction=0.5, topk_max_fraction=0.2), {}),
    ({}, {})])
def test_validate_robustness_raises_jax_errors(fed, run):
    errors = []
    for mod in (config, jax_config):
        cfg = mod.get_config("mnist_mlp_fedavg")
        cfg = cfg.replace(fed=dataclasses.replace(cfg.fed, **fed),
                          run=dataclasses.replace(cfg.run, **run))
        try:
            mod.validate_robustness(cfg)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]
    assert (errors[0] is None) == (not fed and not run)
