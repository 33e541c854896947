"""The port's per-type federation (``comm/per_type.py``) and the MUD type
restriction of its enrollment against the JAX package's, on the CPU at
small sizes: the camera / bulb / thermostat fleet of
``tests/test_mud.py`` (the tiny MLP, 5 workers).

- ``PerTypeFederation`` gives JAX's ``histories`` keys and ``skipped``;
  each type federates exactly its own devices, and fed JAX's draws and
  init each type's params are JAX's per-type run's (f32 rtol 1e-4 / atol
  2e-5), with JAX's records; the two type models differ.
- An ``EnrollmentManager`` restricted to one type lists the devices JAX's
  lists and rejects none, whatever the other devices' types, also with
  the broker's retained replay held back (the managers subscribe once
  every announcement is retained).
- ``coordinate --per-type`` prints JAX's summary keys and exits 1 when a
  type's federation fails (the others run on) or when no type runs.

Every wait has its own timeout in code (no pytest-timeout here).
"""

import contextlib
import json
import threading
import time

import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.comm import broker as jax_broker
from colearn_federated_learning_tpu.comm import enrollment as jax_enrollment
from colearn_federated_learning_tpu.comm import per_type as jax_per_type
from colearn_federated_learning_tpu.comm import worker as jax_worker
from colearn_federated_learning_tpu_torch import cli
from colearn_federated_learning_tpu_torch.comm import broker, enrollment
from colearn_federated_learning_tpu_torch.comm import per_type
from colearn_federated_learning_tpu_torch.comm.worker import DeviceWorker
from colearn_federated_learning_tpu_torch.fed import setup as setup_lib
from test_torch_port_round import JaxDraws
from test_torch_port_socket import (
    ATOL, RTOL, WAIT, assert_records_match, configs, jax_init, params_of)

FLEET = ((0, "camera"), (1, "camera"), (2, "bulb"), (3, "bulb"),
         (4, "thermostat"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def profile(device_type):
    """A MUD profile of ``device_type`` (``tests/test_mud.py``'s)."""
    return json.dumps({"ietf-mud:mud": {
        "mud-version": 1, "mud-url": "https://m.example/p",
        "is-supported": True, "systeminfo": "test device",
        "mfg-name": "acme", "model-name": "cam-3",
        "colearn:device-type": device_type, "cache-validity": 24}})


def per_type_run(side, cfgs):
    """Both sides' ``PerTypeFederation`` over the fleet for 2 rounds; the
    port's workers replay JAX's batch draws and its coordinators start
    from JAX's init.  Returns (federation, {type: params},
    {type: trainer ids})."""
    jcfg, tcfg = cfgs
    with contextlib.ExitStack() as stack:
        b = (broker.MessageBroker() if side == "port"
             else jax_broker.MessageBroker()).start()
        stack.callback(b.stop)
        for i, t in FLEET:
            if side == "port":
                w = DeviceWorker(tcfg, i, b.host, b.port, device="cpu",
                                 mud_profile=profile(t),
                                 draws=JaxDraws(tcfg.run.seed))
            else:
                w = jax_worker.DeviceWorker(jcfg, i, b.host, b.port,
                                            mud_profile=profile(t))
            stack.callback(w.start().stop)
        if side == "port":
            fed = per_type.PerTypeFederation(tcfg, b.host, b.port,
                                             round_timeout=30.0,
                                             min_devices_per_type=2,
                                             device="cpu")
        else:
            fed = jax_per_type.PerTypeFederation(jcfg, b.host, b.port,
                                                 round_timeout=30.0,
                                                 min_devices_per_type=2)
        stack.callback(fed.close)
        fed.run(min_devices=len(FLEET), enroll_timeout=WAIT)
        return (fed, {t: params_of(c) for t, c in fed.coordinators.items()},
                {t: sorted(d.device_id for d in c.trainers)
                 for t, c in fed.coordinators.items()})


def test_per_type_federations_match_jax(monkeypatch):
    cfgs = configs(num_clients=len(FLEET))
    monkeypatch.setattr(setup_lib, "init_global_params",
                        lambda config, device=None: jax_init(cfgs[0]))
    ours, op, ot = per_type_run("port", cfgs)
    theirs, tp, tt = per_type_run("jax", cfgs)
    assert not ours.errors and not theirs.errors, (ours.errors,
                                                   theirs.errors)
    assert sorted(ours.histories) == sorted(theirs.histories) == [
        "bulb", "camera"]
    assert ours.skipped == theirs.skipped == {"thermostat": 1}
    assert ot == tt == {"camera": ["0", "1"], "bulb": ["2", "3"]}
    for t in ours.histories:
        assert [r["completed"] for r in ours.histories[t]] == [2, 2]
        assert_records_match(ours.histories[t], theirs.histories[t])
        assert list(op[t]) == list(tp[t])
        for k in op[t]:
            np.testing.assert_allclose(op[t][k], tp[t][k], rtol=RTOL,
                                       atol=ATOL, err_msg=(t, k))
    assert any(not np.array_equal(op["camera"][k], op["bulb"][k])
               for k in op["camera"])


ANNOUNCED = FLEET + ((5, ""), (6, "camera"))


def _until(client, done, what: str) -> None:
    """Reads ``client``'s messages until ``done(header)``, within WAIT."""
    deadline = time.monotonic() + WAIT
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(f"no {what} within {WAIT} s")
        header, _ = client.recv(timeout=remaining)
        if done(header):
            return


def announce_retained(b, pub) -> None:
    """Announces ``ANNOUNCED`` and returns once the broker has retained
    every announcement.  A manager that subscribes while one is still in
    flight gets it live, possibly before the replay of the earlier ones
    (both brokers replay outside their lock), and lists it out of
    announcement order."""
    watcher = broker.BrokerClient(b.host, b.port, timeout=WAIT)
    watcher.subscribe(enrollment.ENROLL_TOPIC + "#", ack=True)
    _until(watcher, lambda h: h.get("op") == "suback", "suback")
    for i, t in ANNOUNCED:
        enrollment.announce(pub, enrollment.DeviceInfo(
            device_id=str(i), host="127.0.0.1", port=1000 + i,
            mud=profile(t) if t else ""))
    seen = set()

    def every(header):
        seen.add(header.get("topic"))
        return len(seen & {enrollment.ENROLL_TOPIC + str(i)
                           for i, _ in ANNOUNCED}) == len(ANNOUNCED)

    _until(watcher, every, "announcement of every device")
    watcher.close()


def check_restricted_managers(device_type) -> None:
    """Both packages' managers restricted to ``device_type`` list its
    devices in announcement order and reject none."""
    with broker.MessageBroker() as b:
        pub = broker.BrokerClient(b.host, b.port, timeout=WAIT)
        announce_retained(b, pub)
        want = [str(i) for i, t in ANNOUNCED if t == device_type]
        ours = enrollment.EnrollmentManager(
            broker.BrokerClient(b.host, b.port, timeout=WAIT),
            device_type=device_type)
        theirs = jax_enrollment.EnrollmentManager(
            jax_broker.BrokerClient(b.host, b.port, timeout=WAIT),
            device_type=device_type)
        for manager in (ours, theirs):
            manager.wait_for(len(want), WAIT)
            manager.poll(0.3)            # the other types' announcements
        got = [[d.device_id for d in m.devices()] for m in (ours, theirs)]
        assert got[0] == got[1] == want
        assert ours.rejected == theirs.rejected == {}
        assert ours.profile_of(want[0]).device_type == device_type
        for client in (pub, ours._client, theirs._client):
            client.close()


@pytest.mark.parametrize("device_type", ["camera", "bulb", "thermostat"])
def test_manager_restricted_to_one_type_ignores_the_others(device_type):
    """Announcements of every type (and one without a profile) reach a
    manager of each package restricted to ``device_type``: both list the
    same devices, in the same order, and reject none."""
    check_restricted_managers(device_type)


@pytest.mark.parametrize("device_type", ["camera", "bulb"])
def test_restricted_managers_keep_order_under_a_slow_replay(
        monkeypatch, device_type):
    """The port's broker with each subscription's replay held back and
    device 6's announcement delayed: a manager subscribing while 6 is in
    flight could get it live before the replay of the others.  Announced
    through ``announce_retained``, both managers still list in
    announcement order."""
    served = threading.local()
    serve, send, publish = (broker.MessageBroker._serve_conn,
                            broker.MessageBroker._send,
                            broker.MessageBroker._publish)

    def marked_serve(self, conn):
        served.conn, served.held = conn, False
        return serve(self, conn)

    def held_send(self, conn, header, body):
        # A message to the connection this thread serves is a replay.
        if (getattr(served, "conn", None) is conn and not served.held
                and header.get("op") == "msg"):
            served.held = True
            time.sleep(0.5)
        return send(self, conn, header, body)

    def late_publish(self, header, body):
        if header.get("topic") == enrollment.ENROLL_TOPIC + "6":
            time.sleep(0.3)
        return publish(self, header, body)

    monkeypatch.setattr(broker.MessageBroker, "_serve_conn", marked_serve)
    monkeypatch.setattr(broker.MessageBroker, "_send", held_send)
    monkeypatch.setattr(broker.MessageBroker, "_publish", late_publish)
    check_restricted_managers(device_type)


TINY = ["--config", "mnist_mlp_fedavg", "--dataset", "mnist_tiny",
        "--num-clients", "5", "--local-steps", "2", "--rounds", "2",
        "--backend", "cpu"]
# The camera evaluator's eval request is lost: the camera federation fails
# its final evaluation; the bulbs run on.
LOSE_CAMERA_EVAL = {"seed": 1, "faults": [
    {"kind": "drop_request", "device_id": "1", "op": "eval", "count": 0}]}


def _coordinate(fleet, extra, capsys):
    """``coordinate --per-type`` in this process over port worker threads;
    returns (its result or exit code, its stdout, its stderr lines)."""
    wcfg = cli.config_from_args(cli.build_parser().parse_args(
        ["worker", *TINY, "--broker-port", "1", "--client-id", "0"]))
    with contextlib.ExitStack() as stack:
        b = stack.enter_context(broker.MessageBroker())
        for i, t in fleet:
            stack.callback(DeviceWorker(wcfg, i, b.host, b.port, device="cpu",
                                        mud_profile=profile(t)).start().stop)
        argv = ["coordinate", "--per-type", *TINY, "--broker-port",
                str(b.port), "--min-devices", str(len(fleet)),
                "--enroll-timeout", str(WAIT), "--round-timeout", "3",
                *extra]
        try:
            result = cli.main(argv)
        except SystemExit as e:
            result = e.code
        finally:
            from colearn_federated_learning_tpu_torch import faults

            faults.uninstall()
    out = capsys.readouterr()
    return result, out.out, [json.loads(line) for line in
                             out.err.splitlines() if line.startswith("{")]


def test_cli_per_type_prints_the_jax_summary(capsys):
    result, out, records = _coordinate(FLEET, ["--no-evaluator"], capsys)
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(
        json.dumps(result))
    assert sorted(result) == ["errors", "skipped", "types"]
    assert sorted(result["types"]) == ["bulb", "camera"]
    assert result["skipped"] == {"thermostat": 1} and result["errors"] == {}
    assert all(result["types"][t]["completed"] == 2 for t in ("bulb",
                                                             "camera"))
    assert sorted({r["type"] for r in records}) == ["bulb", "camera"]


@pytest.mark.parametrize("case", ["a_type_fails", "no_type_runs"])
def test_cli_per_type_exits_1_on_failure(case, tmp_path, capsys):
    if case == "a_type_fails":
        plan = tmp_path / "plan.json"
        plan.write_text(json.dumps(LOSE_CAMERA_EVAL))
        fleet, extra = FLEET[:4], ["--fault-plan", str(plan)]
    else:
        fleet, extra = ((0, "camera"), (4, "thermostat")), []
    code, out, _ = _coordinate(fleet, extra, capsys)
    assert code == 1
    summary = json.loads(out.strip().splitlines()[-1])
    assert sorted(summary) == ["errors", "skipped", "types"]
    if case == "a_type_fails":
        assert list(summary["errors"]) == ["camera"]
        assert "TimeoutError" in summary["errors"]["camera"]
        assert list(summary["types"]) == ["bulb"]
        assert summary["types"]["bulb"]["round"] == 1
    else:
        assert summary == {"types": {}, "skipped": {"camera": 1,
                                                    "thermostat": 1},
                           "errors": {}}
