"""Multi-process chaos soak: real subprocesses, real ports, real SIGKILL
(the counterpart of the first half of the JAX package's
``faults/procsoak.py``: ``chaos --mp`` and ``chaos --agg``).

The in-process soak (``faults/soak.py``) exercises the robustness machinery
through a transport interposer: everything a Python exception can express.
This harness exercises what it cannot: fd leaks, half-written frames, torn
files and lost process state.  It spawns the broker, N ``worker``
processes (and, for the tree, ``aggregator`` processes) and a
``coordinate`` process of the port's command line on real sockets, then
delivers SIGKILL on a schedule keyed by round: to the coordinator
mid-round, which comes back with ``--resume`` and finishes the round
budget from its checkpoint and round WAL, and to the broker, which is
respawned on its original port and healed into by the survivors (the
workers' re-enrollment watchdog, the coordinator's ``_rebuild_broker``).

The schedule is event-driven, not timer-driven: a :class:`KillSpec` fires
the moment the coordinator's stderr emits the round record for
``after_round``, so the signal lands while the next round is in flight.

JAX's children run on the CPU (``JAX_PLATFORMS=cpu``, ``--backend cpu``);
here they run on the card unless the caller passes ``backend="cpu"``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import select
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Optional

_CLI = "colearn_federated_learning_tpu_torch.cli"
# The directory holding the package: the children import it from there.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclasses.dataclass(frozen=True)
class KillSpec:
    """One scheduled SIGKILL.

    ``target`` is ``"coordinator"``, ``"async-coordinator"``,
    ``"broker"``, ``"worker:<client_id>"`` or ``"aggregator:<n>"``.  The
    signal is sent as soon as the round record for ``after_round``
    appears, so it lands mid-round ``after_round + 1``.  ``restart``
    respawns the victim: a worker re-announces on a fresh port, the
    coordinator comes back with ``--resume``, and the broker rebinds its
    original port.  An aggregator is the one role that may stay dead
    (``restart=False``): the root re-homes its slice onto a sibling or
    quorum-drops it."""

    target: str
    after_round: int
    restart: bool = True

    def __post_init__(self):
        singletons = ("coordinator", "async-coordinator", "broker")
        if self.target not in singletons and not (
                self.target.split(":", 1)[0] in ("worker", "aggregator")
                and ":" in self.target
                and self.target.split(":", 1)[1].isdigit()):
            raise ValueError(
                f"target must be 'coordinator', 'async-coordinator', "
                f"'broker', 'worker:<id>' or 'aggregator:<n>', "
                f"got {self.target!r}")
        if self.after_round < 0:
            raise ValueError(
                f"after_round must be >= 0, got {self.after_round}")
        if self.target in singletons and not self.restart:
            raise ValueError(
                f"killing the {self.target} without restart ends the "
                "federation; use restart=True")


def canned_kill_schedule(rounds: int, n_workers: int) -> list[KillSpec]:
    """The acceptance schedule, scaled to the run length:

    - a worker dies mid-round 2 and restarts (eviction and elastic
      re-admission on a fresh port), when the run is long enough;
    - the coordinator dies mid-round ``rounds // 2 + 1``, after the
      round-``rounds // 2`` checkpoint committed, and resumes;
    - the broker dies one round after the coordinator resumed and rebinds
      its original port, when at least one full round follows.
    """
    kills = []
    if rounds >= 5 and n_workers >= 3:
        kills.append(KillSpec("worker:1", after_round=1))
    kills.append(KillSpec("coordinator",
                          after_round=max(0, rounds // 2 - 1)))
    if rounds >= 4:
        kills.append(KillSpec("broker", after_round=rounds // 2))
    return kills


def _config_flags(rounds: int, n_workers: int, seed: int,
                  checkpoint_dir: Optional[str] = None,
                  backend: str = "gpu") -> list[str]:
    """Command-line overrides reproducing ``soak.default_soak_config``'s
    federation (config #1's MLP on ``mnist_tiny``) on ``backend``."""
    flags = [
        "--config", "mnist_mlp_fedavg", "--backend", backend,
        "--dataset", "mnist_tiny", "--partition", "iid",
        "--num-clients", str(n_workers), "--rounds", str(rounds),
        "--cohort-size", "0", "--local-steps", "4", "--batch-size", "16",
        "--lr", "0.05", "--momentum", "0.0", "--strategy", "fedavg",
        "--min-cohort-fraction", "0.5", "--evict-after", "2",
        "--comm-retries", "2", "--seed", str(seed),
    ]
    if checkpoint_dir:
        flags += ["--checkpoint-dir", checkpoint_dir,
                  "--checkpoint-every", "1"]
    return flags


def _parse_json(line: str) -> Optional[dict]:
    try:
        doc = json.loads(line)
    except json.JSONDecodeError:
        return None            # ordinary log lines on the same stream
    return doc if isinstance(doc, dict) else None


class _Fleet:
    """Process bookkeeping for one soak run (spawn, kill, clean-up)."""

    def __init__(self, workdir: str, env: dict):
        self.workdir = workdir
        self.env = env
        self.broker: Optional[subprocess.Popen] = None
        self.workers: dict[int, subprocess.Popen] = {}
        self.aggregators: dict[int, subprocess.Popen] = {}
        self.coord: Optional[subprocess.Popen] = None
        self._logs: list = []
        self._broker_extra: list[str] = []
        self._broker_addr: Optional[tuple[str, int]] = None

    def _log_file(self, name: str):
        f = open(os.path.join(self.workdir, name), "ab")
        self._logs.append(f)
        return f

    def spawn(self, args: list[str], **kw) -> subprocess.Popen:
        return subprocess.Popen([sys.executable, "-m", _CLI, *args],
                                env=self.env, **kw)

    def start_broker(self, timeout: float,
                     extra: list[str] = ()) -> tuple[str, int]:
        self._broker_extra = list(extra)
        self.broker = self.spawn(
            ["broker", *self._broker_extra], stdout=subprocess.PIPE,
            stderr=self._log_file("broker.log"), text=True)
        ready, _, _ = select.select([self.broker.stdout], [], [], timeout)
        if not ready:
            raise RuntimeError("broker never announced its port")
        doc = _parse_json(self.broker.stdout.readline())
        if not doc:
            raise RuntimeError("broker printed no address line")
        self._broker_addr = (doc["host"], int(doc["port"]))
        return self._broker_addr

    def restart_broker(self, timeout: float = 15.0,
                       attempts: int = 20) -> None:
        """Respawn the broker bound to its original host:port.  The kernel
        may hold the port briefly through lingering connections, so the
        rebind retries after a short sleep."""
        host, port = self._broker_addr
        for _ in range(attempts):
            self.broker = self.spawn(
                ["broker", "--host", host, "--port", str(port),
                 *self._broker_extra],
                stdout=subprocess.PIPE,
                stderr=self._log_file("broker.log"), text=True)
            ready, _, _ = select.select([self.broker.stdout], [], [],
                                        timeout)
            if ready:
                doc = _parse_json(self.broker.stdout.readline())
                if doc and int(doc["port"]) == port:
                    return
            if self.broker.poll() is None:
                self.broker.kill()
            self.broker.wait()
            time.sleep(0.25)
        raise RuntimeError(f"broker failed to rebind {host}:{port} "
                           f"after {attempts} attempts")

    def start_worker(self, client_id: int, cfg: list[str], host: str,
                     port: int) -> None:
        log = self._log_file(f"worker{client_id}.log")
        self.workers[client_id] = self.spawn(
            ["worker", *cfg, "--client-id", str(client_id),
             "--broker-host", host, "--broker-port", str(port)],
            stdout=log, stderr=log)

    def start_aggregator(self, agg_id: int, cfg: list[str], host: str,
                         port: int) -> None:
        log = self._log_file(f"aggregator{agg_id}.log")
        self.aggregators[agg_id] = self.spawn(
            ["aggregator", *cfg, "--agg-id", str(agg_id),
             "--broker-host", host, "--broker-port", str(port)],
            stdout=log, stderr=log)

    def start_coordinator(self, cfg: list[str], host: str, port: int,
                          n_workers: int, round_timeout: float,
                          enroll_timeout: float,
                          resume: bool) -> subprocess.Popen:
        args = ["coordinate", *cfg, "--broker-host", host,
                "--broker-port", str(port),
                "--min-devices", str(n_workers),
                "--round-timeout", str(round_timeout),
                "--enroll-timeout", str(enroll_timeout),
                "--no-evaluator", "--per-client-eval", "--elastic"]
        if resume:
            args.append("--resume")
        self.coord = self.spawn(
            args, stdout=self._log_file("coordinator.out"),
            stderr=subprocess.PIPE, text=True)
        return self.coord

    def _all_procs(self) -> list:
        return ([self.coord, self.broker] + list(self.workers.values())
                + list(self.aggregators.values()))

    def kill_all(self) -> None:
        for p in self._all_procs():
            if p is not None and p.poll() is None:
                p.kill()

    def close(self) -> None:
        self.kill_all()
        for p in self._all_procs():
            if p is not None:
                p.wait()
        for f in self._logs:
            f.close()


def _child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONUNBUFFERED"] = "1"      # round records must stream
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    return env


def run_proc_soak(
    rounds: int = 6,
    n_workers: int = 3,
    kills: Optional[list[KillSpec]] = None,
    workdir: Optional[str] = None,
    round_timeout: float = 120.0,
    enroll_timeout: float = 90.0,
    timeout_s: float = 600.0,
    seed: int = 0,
    n_aggregators: int = 0,
    health: bool = False,
    log_fn: Optional[Callable[[dict], None]] = None,
    backend: str = "gpu",
) -> dict:
    """Run one multi-process soak and return its summary.

    The summary mirrors ``soak.run_soak`` where the two overlap
    (``records``, deduplicated by round with the last record winning, so a
    resumed re-run of an uncommitted round replaces the lost one;
    ``skipped_rounds``, ``evicted``, ``per_client_acc``) and adds the
    process ledger: the ``kills`` delivered, ``rounds_resumed`` (the
    coordinator's ``resumed`` event lines), ``coordinator_incarnations``,
    the final ``exit_code``, and the flight ledger: ``flight_dumps``
    (parseable black boxes found) and ``flight_missing`` (SIGKILLed pids
    that left no parseable dump; must be empty)."""
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    kills = list(kills or [])
    for k in kills:
        if k.target.startswith("worker:"):
            wid = int(k.target.split(":", 1)[1])
            if not 0 <= wid < n_workers:
                raise ValueError(f"{k.target} out of range "
                                 f"[0, {n_workers})")
        elif k.target.startswith("aggregator:"):
            aid = int(k.target.split(":", 1)[1])
            if not 0 <= aid < n_aggregators:
                raise ValueError(f"{k.target} out of range "
                                 f"[0, {n_aggregators})")
    workdir = workdir or tempfile.mkdtemp(prefix="colearn_mpsoak_")
    os.makedirs(workdir, exist_ok=True)
    ckpt_dir = os.path.join(workdir, "ckpt")
    flight_dir = os.path.join(workdir, "flight")

    fleet = _Fleet(workdir, _child_env())
    # A hung federation (the fault class this harness hunts) fails the
    # run instead of hanging its caller.
    watchdog = threading.Timer(timeout_s, fleet.kill_all)
    watchdog.daemon = True

    records: dict[int, dict] = {}
    events: list[dict] = []
    per_client: dict = {}
    resumed = 0
    incarnations = 1
    delivered: list[dict] = []
    pending = sorted(kills, key=lambda k: (k.after_round, k.target))
    rc: Optional[int] = None

    try:
        watchdog.start()
        # Every process flies the black box on a fast heartbeat: a SIGKILL
        # is uncatchable, so the victim's dump is its last heartbeat.
        flight_flags = ["--flight-dir", flight_dir,
                        "--flight-heartbeat", "0.5"]
        health_flags = (["--health-dir", os.path.join(workdir, "health")]
                        if health else [])
        host, port = fleet.start_broker(timeout=30.0, extra=flight_flags)
        worker_cfg = (_config_flags(rounds, n_workers, seed, backend=backend)
                      + flight_flags + health_flags)
        for i in range(n_workers):
            fleet.start_worker(i, worker_cfg, host, port)
        # The aggregators start before the coordinator, so their retained
        # announcements are on the broker when the root subscribes.
        agg_cfg = worker_cfg
        for a in range(n_aggregators):
            fleet.start_aggregator(a, agg_cfg, host, port)
        coord_cfg = (_config_flags(rounds, n_workers, seed,
                                   checkpoint_dir=ckpt_dir, backend=backend)
                     + flight_flags + health_flags)
        if n_aggregators:
            coord_cfg += ["--num-aggregators", str(n_aggregators)]

        def launch(resume: bool) -> subprocess.Popen:
            return fleet.start_coordinator(
                coord_cfg, host, port, n_workers, round_timeout,
                enroll_timeout, resume=resume)

        coord = launch(resume=False)
        restart_pending = False
        # The coordinator's stderr goes to a log as well: a traceback is
        # not JSON and would otherwise vanish with the pipe.
        err_log = fleet._log_file("coordinator.err")
        while True:
            line = coord.stderr.readline()
            if line:
                err_log.write(line.encode())
                err_log.flush()
            if not line:
                coord.wait()
                if restart_pending:
                    restart_pending = False
                    incarnations += 1
                    coord = launch(resume=True)
                    continue
                rc = coord.returncode
                break
            doc = _parse_json(line.strip())
            if doc is None:
                continue
            if "event" in doc:
                events.append(doc)
                if doc["event"] == "resumed":
                    resumed += 1
                continue
            if "num_clients_evaluated" in doc:
                per_client = doc
                continue
            if "round" not in doc:
                continue
            r = int(doc["round"])
            records[r] = doc           # the last record per round wins
            if log_fn is not None:
                log_fn(doc)
            while pending and pending[0].after_round <= r:
                spec = pending.pop(0)
                kill_rec = {**dataclasses.asdict(spec),
                            "fired_after_round": r}
                if spec.target == "coordinator":
                    kill_rec["pid"] = coord.pid
                    coord.send_signal(signal.SIGKILL)
                    restart_pending = True
                elif spec.target == "broker":
                    victim = fleet.broker
                    if victim is not None and victim.poll() is None:
                        kill_rec["pid"] = victim.pid
                        victim.send_signal(signal.SIGKILL)
                        victim.wait()
                    fleet.restart_broker()
                elif spec.target.startswith("aggregator:"):
                    aid = int(spec.target.split(":", 1)[1])
                    victim = fleet.aggregators.get(aid)
                    if victim is not None and victim.poll() is None:
                        kill_rec["pid"] = victim.pid
                        victim.send_signal(signal.SIGKILL)
                        victim.wait()
                    if spec.restart:
                        fleet.start_aggregator(aid, agg_cfg, host, port)
                else:
                    wid = int(spec.target.split(":", 1)[1])
                    victim = fleet.workers.get(wid)
                    if victim is not None and victim.poll() is None:
                        kill_rec["pid"] = victim.pid
                        victim.send_signal(signal.SIGKILL)
                        victim.wait()
                    if spec.restart:
                        fleet.start_worker(wid, worker_cfg, host, port)
                delivered.append(kill_rec)
    finally:
        watchdog.cancel()
        fleet.close()

    if rc is None:
        raise RuntimeError(
            f"coordinator never exited cleanly within {timeout_s}s "
            f"(records for rounds {sorted(records)})")

    # Every SIGKILLed pid must have left a parseable black box; a dump that
    # exists but does not parse counts as missing.
    from colearn_federated_learning_tpu_torch.telemetry import flight

    dumps = flight.load_flight_dumps(flight_dir)
    dumped_pids = {d.get("pid") for d in dumps if "error" not in d}
    flight_missing = sorted({k["pid"] for k in delivered if "pid" in k}
                            - dumped_pids)

    recs = [records[r] for r in sorted(records)]
    return {
        "rounds_run": len(recs),
        "records": recs,
        "completed_rounds": [r["round"] for r in recs
                             if r["completed"] > 0
                             and not r.get("skipped_quorum")],
        "skipped_rounds": [r["round"] for r in recs
                           if r.get("skipped_quorum")],
        "evicted": sorted({d for r in recs for d in r.get("evicted", [])}),
        "weighted_acc": per_client.get("weighted_acc"),
        "weighted_loss": per_client.get("weighted_loss"),
        "per_client_acc": per_client.get("per_client", {}),
        "rounds_resumed": resumed,
        "coordinator_incarnations": incarnations,
        "agg_failovers": sum(int(r.get("agg_failovers", 0)) for r in recs),
        "kills": delivered,
        "flight_dumps": len(dumped_pids),
        "flight_missing": flight_missing,
        "events": events,
        "exit_code": rc,
        "workdir": workdir,
    }


def _final_checkpoint_state(ckpt_dir: str):
    """The server state of the latest checkpoint under ``ckpt_dir``, read
    without a template, as ``[(leaf path, CPU tensor), ...]`` in flatten
    order, and its step; ``(None, None)`` when there is none."""
    from colearn_federated_learning_tpu_torch.ckpt import RoundCheckpointer

    mgr = RoundCheckpointer(os.path.abspath(ckpt_dir))
    step = mgr.latest_step()
    if step is None:
        return None, None
    return list(mgr.load_leaves(step)), step


def _max_param_diff(state_a, state_b) -> float:
    """The largest absolute elementwise difference across two states of
    :func:`_final_checkpoint_state` (path-aligned; a structure mismatch is
    itself a failure and gives ``inf``)."""
    if [p for p, _ in state_a] != [p for p, _ in state_b]:
        return float("inf")
    worst = 0.0
    for (_, a), (_, b) in zip(state_a, state_b):
        if a.shape != b.shape:
            return float("inf")
        if a.numel():
            worst = max(worst, float((a.double() - b.double()).abs().max()))
    return worst


def run_agg_soak(
    rounds: int = 4,
    n_workers: int = 3,
    workdir: Optional[str] = None,
    round_timeout: float = 120.0,
    enroll_timeout: float = 90.0,
    timeout_s: float = 600.0,
    kill: bool = True,
    seed: int = 0,
    tol: float = 2e-4,
    log_fn: Optional[Callable[[dict], None]] = None,
    backend: str = "gpu",
) -> dict:
    """The aggregator tree's chaos gate: a tree soak under a real
    aggregator SIGKILL, against a flat (no-tree) oracle.

    Two subprocess federations with one config and seed:

    - **tree**: 2 aggregator processes own the device slices; with
      ``kill=True`` aggregator 0 is SIGKILLed mid-round and stays dead, so
      the root re-homes its slice onto aggregator 1 or quorum-drops it
      (``agg_failovers >= 1``);
    - **oracle**: the same federation folding flat at the root, no kills.

    The gate compares the final checkpointed server states: re-homing
    loses no contribution, so the tree's params stay within ``tol`` of the
    oracle's (the slack covers the fold order).  The killed aggregator
    must have left a parseable flight dump whose postmortem names the
    aggregator role, and the tree's ``--health-dir`` ledgers must survive
    the kill (parseable and not empty)."""
    workdir = workdir or tempfile.mkdtemp(prefix="colearn_aggsoak_")
    os.makedirs(workdir, exist_ok=True)
    kills = ([KillSpec("aggregator:0",
                       after_round=max(0, rounds // 2 - 1),
                       restart=False)]
             if kill else [])

    tree = run_proc_soak(
        rounds=rounds, n_workers=n_workers, kills=kills,
        workdir=os.path.join(workdir, "tree"),
        round_timeout=round_timeout, enroll_timeout=enroll_timeout,
        timeout_s=timeout_s, seed=seed, n_aggregators=2, health=True,
        log_fn=log_fn, backend=backend)
    # The oracle keeps health ledgers too: their fsyncs shift arrival
    # timing, and the flat fold follows arrival order.
    oracle = run_proc_soak(
        rounds=rounds, n_workers=n_workers, kills=[],
        workdir=os.path.join(workdir, "flat"),
        round_timeout=round_timeout, enroll_timeout=enroll_timeout,
        timeout_s=timeout_s, seed=seed, n_aggregators=0, health=True,
        log_fn=log_fn, backend=backend)

    state_t, step_t = _final_checkpoint_state(
        os.path.join(workdir, "tree", "ckpt"))
    state_o, step_o = _final_checkpoint_state(
        os.path.join(workdir, "flat", "ckpt"))
    if state_t is None or state_o is None or step_t != step_o:
        max_diff = float("inf")
    else:
        max_diff = _max_param_diff(state_t, state_o)
    oracle_ok = max_diff <= tol

    # The killed aggregator's black box must be in the tree's flight
    # ledger, and the merged report must name the victim an aggregator.
    from colearn_federated_learning_tpu_torch.telemetry import flight

    killed_pids = {k["pid"] for k in tree["kills"] if "pid" in k}
    if killed_pids:
        dumps = flight.load_flight_dumps(
            os.path.join(workdir, "tree", "flight"))
        report = flight.postmortem_report(dumps)
        attributed = any(
            p.get("pid") in killed_pids
            and str(p.get("role", "")).startswith("aggregator")
            for p in report.get("processes", []))
    else:
        attributed = not kill

    # The SIGKILLed aggregator's per-device records must still parse (a
    # torn final line is tolerated) and must not be empty.
    from colearn_federated_learning_tpu_torch.telemetry import health

    try:
        devices = health.load_health(os.path.join(workdir, "tree",
                                                  "health"))
    except ValueError:
        devices = {}
    health_ok = bool(devices)

    return {
        "exit_code": tree["exit_code"],
        "oracle_exit_code": oracle["exit_code"],
        "rounds_run": tree["rounds_run"],
        "oracle_rounds_run": oracle["rounds_run"],
        "oracle_ok": oracle_ok,
        "max_param_diff": max_diff,
        "checkpoint_step": step_t,
        "agg_failovers": tree["agg_failovers"],
        "postmortem_attributed": attributed,
        "health_ledger_ok": health_ok,
        "health_devices": len(devices),
        "flight_missing": tree["flight_missing"],
        "kills": tree["kills"],
        "records": tree["records"],
        "workdir": workdir,
    }
