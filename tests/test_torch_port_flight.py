"""The port's crash flight recorder (``telemetry/flight.py``) and its
``postmortem`` command, against the JAX package's, on the CPU.

- JAX's ``tests/test_flight.py`` run against the port: atomic dump
  rewrites, bounded rings, the tracer tail, the watchdog, a real SIGKILL
  leaving a parseable dump, the corrupt-dump contract, the postmortem's
  committed/in-flight split and its round trip, the per-process
  singleton.
- The two packages read each other's dumps, and ``postmortem_report`` and
  ``render_postmortem`` give the same report and text over one directory
  of dumps and one WAL, whichever package wrote the dumps; the port's
  ``postmortem`` command prints what JAX's prints, with its exit codes.
- A ``broker`` process of the port's command line with ``--flight-dir``
  dumps with trigger ``sigterm`` on SIGTERM and still exits 0 (its
  recorder chains to the clean exit).
"""

import json
import os
import select
import signal
import subprocess
import sys
import time

import pytest

from colearn_federated_learning_tpu import cli as jax_cli
from colearn_federated_learning_tpu.ckpt.wal import RoundWal as JaxRoundWal
from colearn_federated_learning_tpu.telemetry import flight as jax_flight
from colearn_federated_learning_tpu_torch import cli
from colearn_federated_learning_tpu_torch.ckpt.wal import RoundWal
from colearn_federated_learning_tpu_torch.telemetry import flight
from colearn_federated_learning_tpu_torch.telemetry.tracer import Tracer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 30.0          # seconds a child process may take to start here


def make_recorder(tmp_path, **kw) -> flight.FlightRecorder:
    # No install(): no signal handlers, no thread; dump() by hand.
    kw.setdefault("heartbeat_s", 60.0)
    return flight.FlightRecorder(str(tmp_path), role="test", **kw)


# ------------------------------------------------------------- dumping ---
def test_dump_writes_parseable_schema(tmp_path):
    rec = make_recorder(tmp_path)
    rec.record("round", round=2)
    path = rec.dump("install")
    doc = json.loads(open(path).read())
    assert doc["schema"] == "colearn-flight-v1"
    assert doc["pid"] == os.getpid()
    assert doc["role"] == "test"
    assert doc["trigger"] == "install"
    assert doc["events"][-1]["kind"] == "round"
    assert "metrics" in doc and "argv" in doc


def test_dump_keys_are_jax_s(tmp_path):
    ours = json.loads(open(make_recorder(tmp_path / "a").dump("x")).read())
    theirs = json.loads(open(jax_flight.FlightRecorder(
        str(tmp_path / "b"), role="test", heartbeat_s=60.0).dump("x")).read())
    assert sorted(ours) == sorted(theirs)


def test_dump_rewrites_atomically_and_never_raises(tmp_path):
    rec = make_recorder(tmp_path)
    first = rec.dump("install")
    rec.record("round", round=1)
    second = rec.dump("heartbeat")
    assert first == second
    docs = flight.load_flight_dumps(str(tmp_path))
    assert len(docs) == 1
    assert docs[0]["trigger"] == "heartbeat"
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    rec.path = os.path.join(str(tmp_path), "nope", "deep", "f.json")
    rec.dump("heartbeat")              # no raise


def test_event_ring_is_bounded(tmp_path):
    rec = make_recorder(tmp_path)
    for i in range(2 * flight._EVENT_RING):
        rec.record("round", round=i)
    doc = json.loads(open(rec.dump("heartbeat")).read())
    assert len(doc["events"]) == flight._EVENT_RING == jax_flight._EVENT_RING
    assert doc["events"][-1]["round"] == 2 * flight._EVENT_RING - 1


def test_attached_tracer_tail_rides_in_dump(tmp_path):
    tracer = Tracer(process="coordinator")
    tracer.enabled = True
    with tracer.span("round", round=1):
        with tracer.span("aggregate"):
            pass
    rec = make_recorder(tmp_path)
    rec.attach_tracer(tracer)
    rec.attach_tracer(tracer)          # once only
    doc = json.loads(open(rec.dump("heartbeat")).read())
    assert sorted(s["name"] for s in doc["spans"]) == ["aggregate", "round"]


def test_exception_payload_recorded(tmp_path):
    rec = make_recorder(tmp_path)
    rec.dump("fatal_exception", exc="Traceback ...\nValueError: boom")
    doc = flight.load_flight_dumps(str(tmp_path))[0]
    assert doc["trigger"] == "fatal_exception"
    assert "ValueError: boom" in doc["exception"]


def test_watchdog_declares_stall(tmp_path):
    rec = make_recorder(tmp_path, heartbeat_s=0.05, watchdog_s=0.1)
    triggers = []
    orig_dump = rec.dump

    def spying_dump(trigger, exc=None):
        triggers.append(trigger)
        return orig_dump(trigger, exc)

    rec.dump = spying_dump
    before = signal.getsignal(signal.SIGTERM)
    rec.install()
    try:
        assert signal.getsignal(signal.SIGTERM) == rec._on_sigterm
        rec.mark_progress()
        deadline = time.monotonic() + 5.0
        while ("watchdog_stall" not in triggers
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert "watchdog_stall" in triggers
        time.sleep(0.2)
    finally:
        rec.close()
    assert triggers.count("watchdog_stall") == 1
    assert flight.load_flight_dumps(
        str(tmp_path))[0]["trigger"] == "shutdown"
    # close() puts back the SIGTERM handler it replaced.
    assert signal.getsignal(signal.SIGTERM) == before


# -------------------------------------------------------- survivability --
def _first_line(p) -> str:
    ready, _, _ = select.select([p.stdout], [], [], WAIT)
    assert ready, "the child printed nothing"
    return p.stdout.readline().strip()


def test_sigkill_leaves_parseable_dump_that_jax_reads(tmp_path):
    """SIGKILL is uncatchable: the last heartbeat rewrite is the black
    box, and the JAX package's loader parses it."""
    code = (
        "import time\n"
        "from colearn_federated_learning_tpu_torch.telemetry import flight\n"
        f"rec = flight.install_flight_recorder({str(tmp_path)!r},\n"
        "    role='victim', heartbeat_s=0.2)\n"
        "rec.record('round', round=3)\n"
        "print('ready', flush=True)\n"
        "time.sleep(60)\n")
    p = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                         stdout=subprocess.PIPE, text=True)
    try:
        assert _first_line(p) == "ready"
        time.sleep(1.0)                # a few heartbeats
        p.kill()
    finally:
        p.wait(WAIT)
    for loader in (flight.load_flight_dumps, jax_flight.load_flight_dumps):
        dumps = [d for d in loader(str(tmp_path)) if "error" not in d]
        assert [d["pid"] for d in dumps] == [p.pid]
        assert dumps[0]["role"] == "victim"
        assert any(e.get("round") == 3 for e in dumps[0]["events"])


def test_jax_dump_reads_in_the_port(tmp_path):
    rec = jax_flight.FlightRecorder(str(tmp_path), role="jax-worker",
                                    heartbeat_s=60.0)
    rec.record("round", round=4)
    rec.dump("sigterm")
    docs = flight.load_flight_dumps(str(tmp_path))
    assert [(d["role"], d["trigger"]) for d in docs] == [("jax-worker",
                                                          "sigterm")]
    assert docs[0]["events"][-1]["round"] == 4


def test_broker_process_dumps_on_sigterm_and_exits_0(tmp_path):
    """The recorder is installed after the served command's own SIGTERM
    handler: it dumps with trigger ``sigterm`` and chains to the clean
    exit (0), and no heartbeat overwrites the trigger."""
    p = subprocess.Popen(
        [sys.executable, "-m", "colearn_federated_learning_tpu_torch.cli",
         "broker", "--flight-dir", str(tmp_path), "--flight-heartbeat",
         "0.05"], cwd=ROOT, stdout=subprocess.PIPE, text=True)
    try:
        port = json.loads(_first_line(p))["port"]
        time.sleep(0.3)                # a few heartbeats
        p.send_signal(signal.SIGTERM)
        code = p.wait(WAIT)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(WAIT)
    assert code == 0
    time.sleep(0.2)
    (doc,) = jax_flight.load_flight_dumps(str(tmp_path))
    assert doc["pid"] == p.pid and doc["role"] == "broker"
    assert doc["trigger"] == "sigterm"
    assert {"kind": "broker_listening", "port": port}.items() <= \
        doc["events"][-1].items()


def test_unparseable_dump_is_a_finding_not_a_skip(tmp_path):
    (tmp_path / "flight_123.json").write_text('{"pid": 123, "tru')
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "flight_456.json").write_text(
        json.dumps({"schema": "colearn-flight-v1", "pid": 456, "ts": 1.0}))
    docs = flight.load_flight_dumps(str(tmp_path))
    good = [d for d in docs if "error" not in d]
    bad = [d for d in docs if "error" in d]
    assert [d["pid"] for d in good] == [456]
    assert len(bad) == 1 and bad[0]["_path"].endswith("flight_123.json")


# ----------------------------------------------------------- postmortem --
def _dump_for(tmp_path, pid, rounds, trigger="heartbeat", role="worker"):
    doc = {"schema": "colearn-flight-v1", "pid": pid, "role": role,
           "trigger": trigger, "ts": float(pid), "argv": [],
           "events": [{"ts": 0.0, "kind": "round", "round": r}
                      for r in rounds],
           "metrics": {"comm.retry_total": 2.0, "other.x": 1.0},
           "spans": [{"name": f"s{i}"} for i in range(10)]}
    (tmp_path / f"flight_{pid}.json").write_text(json.dumps(doc))


def test_postmortem_splits_committed_vs_in_flight_exactly():
    wal = [{"round": r, "accepted": 2, "completed": 2,
            "total_weight": 10.0} for r in (1, 2, 3, 4)]
    report = flight.postmortem_report([], wal_entries=wal, checkpoint_step=3)
    assert report["last_committed_round"] == 3
    assert report["committed_rounds"] == 3
    assert report["rounds_in_flight"] == [4]


def test_postmortem_infers_in_flight_from_dumps(tmp_path):
    _dump_for(tmp_path, 100, rounds=[1, 2, 3])
    dumps = flight.load_flight_dumps(str(tmp_path))
    report = flight.postmortem_report(dumps, wal_entries=[{"round": 1},
                                                          {"round": 2}])
    assert report["last_committed_round"] == 2
    assert report["rounds_in_flight"] == [3]
    proc = report["processes"][0]
    assert proc["pid"] == 100 and proc["last_round_seen"] == 3
    assert proc["metrics_of_note"] == {"comm.retry_total": 2.0}


def test_postmortem_roundtrip_through_files(tmp_path):
    rec = flight.FlightRecorder(str(tmp_path), role="coordinator",
                                heartbeat_s=60.0)
    rec.record("round", round=5)
    rec.dump("sigterm")
    _dump_for(tmp_path, 7, rounds=[4], trigger="watchdog_stall")
    dumps = flight.load_flight_dumps(str(tmp_path))
    report = flight.postmortem_report(
        dumps, wal_entries=[{"round": 4}], checkpoint_step=1)
    report2 = json.loads(json.dumps(report))
    assert report2["schema"] == "colearn-postmortem-v1"
    assert report2["process_count"] == 2
    assert sorted(report2["crash_triggers"]) == ["sigterm", "watchdog_stall"]
    rendered = flight.render_postmortem(report2)
    assert str(os.getpid()) in rendered and "sigterm" in rendered


def test_render_postmortem_reports_unparseable(tmp_path):
    (tmp_path / "flight_9.json").write_text("not json")
    report = flight.postmortem_report(flight.load_flight_dumps(str(tmp_path)))
    assert "error" in report["processes"][0]
    assert "[unparseable]" in flight.render_postmortem(report)


def test_install_is_idempotent_per_process(tmp_path):
    prev = flight._recorder
    flight._recorder = None
    try:
        a = flight.install_flight_recorder(str(tmp_path), role="worker",
                                           heartbeat_s=60.0)
        b = flight.install_flight_recorder(str(tmp_path / "other"))
        assert a is b
        assert flight.get_flight_recorder() is a
        a.close()
    finally:
        flight._recorder = prev


# ------------------------------------------------- against the JAX package --
def _mixed_dumps(tmp_path, writer):
    """A directory of dumps written by ``writer`` (either package's
    module): a coordinator with an exception and spans, a worker with
    rounds past the WAL, an unparseable file; and a WAL of 3 rounds."""
    d = tmp_path / "flight"
    rec = writer.FlightRecorder(str(d), role="coordinator", heartbeat_s=60.0)
    for r in (0, 1, 2, 3):
        rec.record("round", round=r)
    rec.dump("fatal_exception", exc="Traceback\nRuntimeError: lost")
    _dump_for(d, 11, rounds=[2, 3, 4], role="worker1")
    (d / "flight_12.json").write_text('{"torn')
    wal = tmp_path / "ckpt"
    w = RoundWal(str(wal))
    for r in range(3):
        w.append({"round": r, "accepted": [0, 1], "completed": 2,
                  "total_weight": 8.0})
    w.close()
    return d, wal


@pytest.mark.parametrize("writer", [flight, jax_flight],
                         ids=["port_dumps", "jax_dumps"])
@pytest.mark.parametrize("step", [None, 2])
def test_postmortem_report_and_text_are_jax_s(tmp_path, writer, step):
    d, wal = _mixed_dumps(tmp_path, writer)
    entries = RoundWal(str(wal)).load()
    assert entries == JaxRoundWal(str(wal)).load()
    ours = flight.postmortem_report(flight.load_flight_dumps(str(d)),
                                    wal_entries=entries,
                                    checkpoint_step=step)
    theirs = jax_flight.postmortem_report(
        jax_flight.load_flight_dumps(str(d)), wal_entries=entries,
        checkpoint_step=step)
    assert ours == theirs
    assert flight.render_postmortem(ours) == \
        jax_flight.render_postmortem(theirs)
    assert ours["process_count"] == 3
    assert ours["rounds_in_flight"] == ([3, 4] if step is None else [2])


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_postmortem_command_prints_jax_s_output(tmp_path, capsys, fmt):
    d, wal = _mixed_dumps(tmp_path, flight)
    for wal_arg in (str(wal), str(wal / "round_wal.jsonl")):
        argv = ["postmortem", str(d), "--wal-dir", wal_arg,
                "--checkpoint-step", "2", "--format", fmt]
        assert jax_cli.main(argv) == 0
        theirs = capsys.readouterr().out
        assert cli.main(argv) is None
        ours = capsys.readouterr().out
        if fmt == "json":
            # Each package prints the dumps' own _path; the rest is equal.
            assert json.loads(ours) == json.loads(theirs)
        assert ours == theirs


def test_postmortem_command_without_dumps_exits_1(tmp_path, capsys):
    assert jax_cli.main(["postmortem", str(tmp_path)]) == 1
    theirs = capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        cli.main(["postmortem", str(tmp_path)])
    assert exc.value.code == 1
    assert capsys.readouterr().out == theirs
