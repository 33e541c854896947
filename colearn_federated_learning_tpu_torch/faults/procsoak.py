"""Multi-process chaos soak: real subprocesses, real ports, real SIGKILL
(the counterpart of the JAX package's ``faults/procsoak.py``: ``chaos
--mp``, ``--agg``, ``--async``, ``--tree-async`` and ``--ckpt``).

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
The asynchronous soaks (:func:`run_async_soak`, :func:`run_tree_async_soak`)
key the same loop on aggregation records; with ``lock_witness`` every
process of their fleets runs under ``faults/lockwitness.py`` and its
per-pid reports are merged into the summary.

The checkpoint soak (:func:`run_ckpt_soak`) keys its kill on the
filesystem instead: a watcher SIGKILLs the ``--ckpt-stream`` coordinator
while a save is in flight, and the relaunch with ``--resume`` at another
``tp_size`` must restore the last committed generation bitwise.

JAX's children run on the CPU (``JAX_PLATFORMS=cpu``, ``--backend cpu``);
here they run on the card unless the caller passes ``backend="cpu"``.
One exception: the checkpoint soak's coordinator always runs on the CPU
(``--backend cpu``) with 8 forced host positions in ``XLA_FLAGS``, as
JAX's soak gives its whole fleet.  Its sharded server must place tp = 2
positions, and the card machine has one card; the soak's broker and
workers run on ``backend``.  A coordinator that ended up replicated never
reports a resharded resume, so ``reshard_ok`` fails its gate.
"""

from __future__ import annotations

import dataclasses
import json
import math
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

    def start_async_coordinator(self, cfg: list[str], host: str, port: int,
                                n_workers: int, round_timeout: float,
                                enroll_timeout: float, buffer_size: int,
                                resume: bool) -> subprocess.Popen:
        """The buffered-asynchronous flavour of :meth:`start_coordinator`:
        ``--async-buffer`` runs ``comm/async_coordinator.py``, which has no
        per-client evaluation, so the gates compare train-loss tails."""
        args = ["coordinate", *cfg, "--broker-host", host,
                "--broker-port", str(port),
                "--min-devices", str(n_workers),
                "--round-timeout", str(round_timeout),
                "--enroll-timeout", str(enroll_timeout),
                "--async-buffer", str(buffer_size),
                "--no-evaluator", "--elastic"]
        if resume:
            args.append("--resume")
        self.coord = self.spawn(
            args, stdout=self._log_file("coordinator.out"),
            stderr=subprocess.PIPE, text=True)
        return self.coord

    def deliver(self, spec: KillSpec, fired_after: int, host: str, port: int,
                worker_cfg: list[str],
                agg_cfg: list[str]) -> tuple[dict, bool]:
        """SIGKILL ``spec``'s victim as the record of ``fired_after``
        arrives, and respawn it when ``spec.restart`` asks (the broker on
        its port; a coordinator's relaunch with ``--resume`` is the
        caller's).  Returns the kill's record and whether the coordinator
        was the victim."""
        kill_rec = {**dataclasses.asdict(spec),
                    "fired_after_round": fired_after}
        if spec.target in ("coordinator", "async-coordinator"):
            kill_rec["pid"] = self.coord.pid
            self.coord.send_signal(signal.SIGKILL)
            return kill_rec, True
        if spec.target == "broker":
            victim = self.broker
        else:
            role, n = spec.target.split(":", 1)
            victim = (self.aggregators if role == "aggregator"
                      else self.workers).get(int(n))
        if victim is not None and victim.poll() is None:
            kill_rec["pid"] = victim.pid
            victim.send_signal(signal.SIGKILL)
            victim.wait()
        if spec.target == "broker":
            self.restart_broker()
        elif spec.restart and role == "aggregator":
            self.start_aggregator(int(n), agg_cfg, host, port)
        elif spec.restart:
            self.start_worker(int(n), worker_cfg, host, port)
        return kill_rec, False

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


def _child_env(backend: str) -> dict:
    """The children's environment: streamed output, the checkout on the
    path, and on the CPU one intra-op thread per process unless the
    caller set ``OMP_NUM_THREADS`` (a fleet of 6-7 processes each with a
    thread per core turns a 45 ms MLP update into a second or more, and
    the kill schedules are timed against the updates)."""
    env = dict(os.environ)
    env["PYTHONUNBUFFERED"] = "1"      # round records must stream
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    if backend == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
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

    fleet = _Fleet(workdir, _child_env(backend))
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
                kill_rec, coord_died = fleet.deliver(
                    pending.pop(0), r, host, port, worker_cfg, agg_cfg)
                restart_pending = restart_pending or coord_died
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


def _killed_role_named(workdir: str, kills: list[dict], kill: bool,
                       role_ok: Callable[[str], bool]) -> bool:
    """True when a killed pid left a flight dump whose postmortem names a
    role ``role_ok`` accepts (without kills: ``not kill``)."""
    from colearn_federated_learning_tpu_torch.telemetry import flight

    killed_pids = {k["pid"] for k in kills if "pid" in k}
    if not killed_pids:
        return not kill
    report = flight.postmortem_report(
        flight.load_flight_dumps(os.path.join(workdir, "flight")))
    return any(p.get("pid") in killed_pids
               and role_ok(str(p.get("role", "")))
               for p in report.get("processes", []))


def _fleet_health(workdir: str) -> dict:
    """A fleet's merged health ledgers ({} when they do not parse: the
    gates' durability check)."""
    from colearn_federated_learning_tpu_torch.telemetry import health

    try:
        return health.load_health(os.path.join(workdir, "health"))
    except ValueError:
        return {}


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
    # ledger, and the merged report must name the victim an aggregator;
    # the tree's per-device records must still parse (a torn final line
    # is tolerated) and must not be empty.
    tree_dir = os.path.join(workdir, "tree")
    attributed = _killed_role_named(
        tree_dir, tree["kills"], kill,
        lambda role: role.startswith("aggregator"))
    devices = _fleet_health(tree_dir)
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


_ASYNC_DP_DELTA = 1e-5
_ASYNC_DP_NOISE = 0.02


def _async_config_flags(aggregations: int, n_workers: int, seed: int,
                        checkpoint_dir: Optional[str] = None,
                        backend: str = "gpu") -> list[str]:
    """The asynchronous soaks' federation: the process soak's config with
    a fixed-clip DP mechanism, so every aggregation record carries the
    realized ``dp_z_eff`` and ``dp_epsilon`` that the replay gate
    re-derives.  ``--evict-after`` is 4 (the synchronous soak's 2 would
    turn the injected pump flaps into evictions of healthy workers; the
    gate wants them attributed as retries).  The noise multiplier is
    tiny: the replay needs every aggregation charged, and the loss gate
    needs both runs to converge."""
    flags = _config_flags(aggregations, n_workers, seed,
                          checkpoint_dir=checkpoint_dir, backend=backend)
    flags += ["--evict-after", "4",
              "--dp-clip", "1.0",
              "--dp-noise-multiplier", str(_ASYNC_DP_NOISE),
              "--dp-delta", str(_ASYNC_DP_DELTA)]
    return flags


def _async_fault_plan() -> dict:
    """Client-site transport faults of the faulted asynchronous run,
    installed in the coordinator process (``--fault-plan``): they fire in
    the pumps' ``TensorClient.request`` calls, flaps as pump failures the
    health ledger attributes as retries, delays in the per-device latency.
    Count-bounded, so the run still converges."""
    return {"seed": 0, "faults": [
        {"kind": "flap_reconnect", "device_id": "*", "op": "train",
         "count": 2, "site": "client"},
        {"kind": "delay", "device_id": "*", "op": "train",
         "ms": 150, "count": 3, "site": "client"},
    ]}


def _run_async_fleet(
    aggregations: int,
    n_workers: int,
    buffer_size: int,
    kills: list[KillSpec],
    workdir: str,
    round_timeout: float,
    enroll_timeout: float,
    timeout_s: float,
    seed: int,
    n_aggregators: int = 0,
    fault_plan: Optional[dict] = None,
    log_fn: Optional[Callable[[dict], None]] = None,
    lock_witness: bool = False,
    backend: str = "gpu",
) -> dict:
    """One buffered-asynchronous process federation (broker, N workers,
    the asynchronous coordinator, and with ``n_aggregators`` that many
    aggregator processes), with the process soak's kill loop keyed on
    aggregation records (``{"aggregation": i, "model_version": v, ...}``):
    a ``KillSpec(target, after_round=k)`` fires as aggregation ``k``'s
    record appears, mid-aggregation ``k + 1``.  Records are deduplicated
    by aggregation index (the last wins: a resumed incarnation's re-run of
    an uncommitted aggregation replaces the lost one), and the model
    version is checked to increase within each incarnation as the stream
    arrives."""
    os.makedirs(workdir, exist_ok=True)
    ckpt_dir = os.path.join(workdir, "ckpt")
    flight_dir = os.path.join(workdir, "flight")

    env = _child_env(backend)
    witness_dir = os.path.join(workdir, "lockwitness")
    if lock_witness:
        # Every process runs its locks through faults.lockwitness and
        # writes a per-pid report at exit; the summary merges them.
        env["COLEARN_LOCK_WITNESS"] = "1"
        env["COLEARN_LOCK_WITNESS_DIR"] = witness_dir
    else:
        # A witness asked for by the caller's environment stays out of a
        # soak that did not ask for it (its cost would skew the timings).
        env.pop("COLEARN_LOCK_WITNESS", None)
        env.pop("COLEARN_LOCK_WITNESS_DIR", None)

    fleet = _Fleet(workdir, env)
    watchdog = threading.Timer(timeout_s, fleet.kill_all)
    watchdog.daemon = True

    records: dict[int, dict] = {}
    events: list[dict] = []
    resumed = 0
    incarnations = 1
    delivered: list[dict] = []
    pending = sorted(kills, key=lambda k: (k.after_round, k.target))
    version_monotonic = True
    last_version = -1
    rc: Optional[int] = None

    try:
        watchdog.start()
        flight_flags = ["--flight-dir", flight_dir,
                        "--flight-heartbeat", "0.5"]
        health_flags = ["--health-dir", os.path.join(workdir, "health")]
        host, port = fleet.start_broker(timeout=30.0, extra=flight_flags)
        worker_cfg = (_async_config_flags(aggregations, n_workers, seed,
                                          backend=backend)
                      + flight_flags + health_flags)
        if n_aggregators:
            # A slice buffer of 1-2 devices never clears the default
            # distinct-contributor quorum at the root (partials ship per
            # slice); the last flag wins, so the override goes at the end.
            worker_cfg += ["--min-cohort-fraction", "0"]
        for i in range(n_workers):
            fleet.start_worker(i, worker_cfg, host, port)
        # The aggregators start before the coordinator, so their retained
        # announcements are on the broker when the root subscribes.
        agg_cfg = worker_cfg
        for a in range(n_aggregators):
            fleet.start_aggregator(a, agg_cfg, host, port)
        coord_cfg = (_async_config_flags(aggregations, n_workers, seed,
                                         checkpoint_dir=ckpt_dir,
                                         backend=backend)
                     + flight_flags + health_flags)
        if n_aggregators:
            # A 1 s heartbeat deadline (5 s by default) keeps the failover's
            # detection inside a short soak's runway; the oracle gets the
            # same value, so the runs keep one config.
            coord_cfg += ["--num-aggregators", str(n_aggregators),
                          "--min-cohort-fraction", "0",
                          "--agg-heartbeat-timeout", "1.0"]
        if fault_plan is not None:
            plan_path = os.path.join(workdir, "fault_plan.json")
            with open(plan_path, "w") as f:
                json.dump(fault_plan, f)
            coord_cfg += ["--fault-plan", plan_path]

        def launch(resume: bool) -> subprocess.Popen:
            return fleet.start_async_coordinator(
                coord_cfg, host, port, n_workers, round_timeout,
                enroll_timeout, buffer_size, resume=resume)

        coord = launch(resume=False)
        restart_pending = False
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
                    # A fresh incarnation resumes from its checkpointed
                    # version, which may lie below the dead one's last
                    # streamed record: monotonicity restarts with it.
                    last_version = -1
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
            if "aggregation" not in doc:
                continue
            agg = int(doc["aggregation"])
            v = doc.get("model_version")
            if v is not None:
                if int(v) <= last_version:
                    version_monotonic = False
                last_version = int(v)
            records[agg] = doc         # the last record per aggregation wins
            if log_fn is not None:
                log_fn(doc)
            while pending and pending[0].after_round <= agg:
                kill_rec, coord_died = fleet.deliver(
                    pending.pop(0), agg, host, port, worker_cfg, agg_cfg)
                restart_pending = restart_pending or coord_died
                delivered.append(kill_rec)
    finally:
        watchdog.cancel()
        fleet.close()

    if rc is None:
        raise RuntimeError(
            f"async coordinator never exited cleanly within {timeout_s}s "
            f"(records for aggregations {sorted(records)})")

    from colearn_federated_learning_tpu_torch.telemetry import flight

    dumps = flight.load_flight_dumps(flight_dir)
    dumped_pids = {d.get("pid") for d in dumps if "error" not in d}
    flight_missing = sorted({k["pid"] for k in delivered if "pid" in k}
                            - dumped_pids)

    recs = [records[a] for a in sorted(records)]
    return {
        "lock_witness": (_collect_lockwitness(witness_dir)
                         if lock_witness else {"enabled": False}),
        "aggregations_run": len(recs),
        "records": recs,
        "version_monotonic": version_monotonic,
        "resumed": resumed,
        "coordinator_incarnations": incarnations,
        "kills": delivered,
        "flight_dumps": len(dumped_pids),
        "flight_missing": flight_missing,
        "events": events,
        "exit_code": rc,
        "workdir": workdir,
    }


def _collect_lockwitness(witness_dir: str) -> dict:
    """Merge a fleet's per-pid ``lockwitness-*.json`` reports into one
    summary for the gate: the report count, the inversions and unguarded
    accesses (with their records), and the acquires and guarded ops that
    show the witness saw traffic."""
    reports = []
    skipped = 0
    if os.path.isdir(witness_dir):
        for name in sorted(os.listdir(witness_dir)):
            if not (name.startswith("lockwitness-")
                    and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(witness_dir, name)) as f:
                    reports.append(json.load(f))
            except (OSError, ValueError):
                # A report torn by a kill mid-write is no witnessed fault;
                # the skipped count shows the gap.
                skipped += 1
    inversions = [inv for r in reports for inv in r.get("inversions", [])]
    unguarded = [u for r in reports for u in r.get("unguarded", [])]
    return {
        "enabled": True,
        "reports": len(reports),
        "reports_unparseable": skipped,
        "acquires": sum(int(r.get("acquires", 0)) for r in reports),
        "guarded_ops": sum(int(r.get("guarded_ops", 0)) for r in reports),
        "inversions": len(inversions),
        "unguarded": len(unguarded),
        "inversion_records": inversions,
        "unguarded_records": unguarded,
    }


def _tail_loss(records: list[dict], n: int = 3) -> float:
    """Mean train loss over the last ``n`` aggregations with a finite
    one: asynchronous losses vary with thread timing from aggregation to
    aggregation, so the gates compare smoothed tails."""
    tail = [float(r["train_loss"]) for r in records
            if "train_loss" in r
            and math.isfinite(float(r["train_loss"]))][-n:]
    return sum(tail) / len(tail) if tail else float("inf")


def _merge_lockwitness(*parts: dict) -> dict:
    """Fold the fleets' witness summaries (faulted and baseline or oracle)
    into the one entry the chaos gate reads."""
    if not any(p.get("enabled") for p in parts):
        return {"enabled": False}
    merged = {"enabled": True, "reports": 0, "acquires": 0,
              "guarded_ops": 0, "inversions": 0, "unguarded": 0,
              "inversion_records": [], "unguarded_records": []}
    for p in parts:
        if not p.get("enabled"):
            continue
        for k in ("reports", "acquires", "guarded_ops",
                  "inversions", "unguarded"):
            merged[k] += int(p.get(k, 0))
        merged["inversion_records"] += list(p.get("inversion_records", []))
        merged["unguarded_records"] += list(p.get("unguarded_records", []))
    return merged


def run_async_soak(
    aggregations: int = 6,
    n_workers: int = 3,
    buffer_size: int = 2,
    workdir: Optional[str] = None,
    round_timeout: float = 120.0,
    enroll_timeout: float = 90.0,
    timeout_s: float = 600.0,
    kill: bool = True,
    seed: int = 0,
    loss_tol: float = 0.75,
    log_fn: Optional[Callable[[dict], None]] = None,
    lock_witness: bool = False,
    backend: str = "gpu",
) -> dict:
    """The asynchronous plane's chaos gate: the asynchronous coordinator
    SIGKILLed mid-aggregation and relaunched with ``--resume``, against a
    kill-free baseline of the same config and seed.

    - **faulted**: the coordinator dies as aggregation
      ``aggregations // 2 - 1``'s record streams (pumps in flight, the
      buffer unfolded), then resumes; a count-bounded client-site fault
      plan rides on its pumps;
    - **baseline**: the same federation, with no kill and no fault.

    Gates (``chaos --async``): the model version increases within each
    incarnation; replaying the records' ``dp_z_eff`` into a fresh
    accountant lands on the last record's ``dp_epsilon`` (no double
    charge through the resume); the faulted tail loss is within
    ``loss_tol`` of the baseline's; the killed pid's flight dump names the
    coordinator, the health ledgers survive the kill, and the injected
    pump faults show as per-device retries in them."""
    if aggregations < 4:
        raise ValueError(
            f"async soak needs >= 4 aggregations so the kill lands after "
            f"a committed checkpoint, got {aggregations}")
    workdir = workdir or tempfile.mkdtemp(prefix="colearn_asyncsoak_")
    os.makedirs(workdir, exist_ok=True)
    kills = ([KillSpec("async-coordinator",
                       after_round=max(1, aggregations // 2 - 1))]
             if kill else [])

    faulted = _run_async_fleet(
        aggregations=aggregations, n_workers=n_workers,
        buffer_size=buffer_size, kills=kills,
        workdir=os.path.join(workdir, "faulted"),
        round_timeout=round_timeout, enroll_timeout=enroll_timeout,
        timeout_s=timeout_s, seed=seed,
        fault_plan=_async_fault_plan() if kill else None, log_fn=log_fn,
        lock_witness=lock_witness, backend=backend)
    baseline = _run_async_fleet(
        aggregations=aggregations, n_workers=n_workers,
        buffer_size=buffer_size, kills=[],
        workdir=os.path.join(workdir, "baseline"),
        round_timeout=round_timeout, enroll_timeout=enroll_timeout,
        timeout_s=timeout_s, seed=seed, fault_plan=None, log_fn=log_fn,
        lock_witness=lock_witness, backend=backend)

    # The deduplicated record stream is the final coordinator's history:
    # its realized multipliers must replay to the last record's epsilon.
    from colearn_federated_learning_tpu_torch.privacy.accountant import (
        RdpAccountant)

    acct = RdpAccountant(noise_multiplier=_ASYNC_DP_NOISE,
                         sampling_rate=1.0, delta=_ASYNC_DP_DELTA)
    final_eps = None
    for rec in faulted["records"]:
        if "dp_z_eff" in rec:
            acct.step(1, sampling_rate=1.0,
                      noise_multiplier=float(rec["dp_z_eff"]))
        if "dp_epsilon" in rec:
            final_eps = float(rec["dp_epsilon"])
    replayed_eps = acct.epsilon()
    dp_replay_ok = (final_eps is not None
                    and math.isfinite(final_eps)
                    and math.isfinite(replayed_eps)
                    and abs(replayed_eps - final_eps)
                    <= 1e-6 * max(1.0, abs(final_eps)))

    final_loss = _tail_loss(faulted["records"])
    baseline_loss = _tail_loss(baseline["records"])
    loss_gap = abs(final_loss - baseline_loss)
    loss_gap_ok = math.isfinite(loss_gap) and loss_gap <= loss_tol

    faulted_dir = os.path.join(workdir, "faulted")
    attributed = _killed_role_named(faulted_dir, faulted["kills"], kill,
                                    lambda role: role == "coordinator")
    devices = _fleet_health(faulted_dir)
    fault_retries = sum(int(h.counts.get("retry", 0))
                        for h in devices.values())

    return {
        "exit_code": faulted["exit_code"],
        "baseline_exit_code": baseline["exit_code"],
        "aggregations_run": faulted["aggregations_run"],
        "baseline_aggregations_run": baseline["aggregations_run"],
        "version_monotonic": (faulted["version_monotonic"]
                              and baseline["version_monotonic"]),
        "resumed": faulted["resumed"],
        "coordinator_incarnations": faulted["coordinator_incarnations"],
        "dp_replay_ok": dp_replay_ok,
        "dp_epsilon": final_eps,
        "dp_epsilon_replayed": replayed_eps,
        "final_loss": final_loss,
        "baseline_final_loss": baseline_loss,
        "loss_gap": loss_gap,
        "loss_gap_ok": loss_gap_ok,
        "postmortem_attributed": attributed,
        "health_ledger_ok": bool(devices),
        "health_devices": len(devices),
        "fault_retries": fault_retries,
        "faults_attributed": (not kill) or fault_retries >= 1,
        "flight_missing": faulted["flight_missing"],
        "kills": faulted["kills"],
        "records": faulted["records"],
        "lock_witness": _merge_lockwitness(faulted["lock_witness"],
                                           baseline["lock_witness"]),
        "workdir": workdir,
    }


def run_tree_async_soak(
    aggregations: int = 6,
    n_workers: int = 3,
    buffer_size: int = 2,
    workdir: Optional[str] = None,
    round_timeout: float = 120.0,
    enroll_timeout: float = 90.0,
    timeout_s: float = 900.0,
    kill: bool = True,
    seed: int = 0,
    loss_tol: float = 0.75,
    log_fn: Optional[Callable[[dict], None]] = None,
    lock_witness: bool = False,
    backend: str = "gpu",
) -> dict:
    """The asynchronous tree's chaos gate: the buffered-asynchronous
    federation through 2 aggregator processes' slice buffers, an
    aggregator SIGKILLed mid-aggregation and left dead, and the broker
    SIGKILLed and rebound on its port two aggregations later, against a
    kill-free tree oracle of the same config and seed.

    - **faulted**: aggregator 0 dies as aggregation
      ``max(1, aggregations // 3)``'s record streams; the root marks its
      address dead and re-homes the slice's contributions in flight onto
      aggregator 1 without folding any twice; then the broker dies and
      rebinds (the workers' re-enrollment and the root's re-subscription
      heal);
    - **oracle**: the same tree, with no kill.

    Gates (``chaos --tree-async``): the faulted tail loss within
    ``loss_tol`` of the oracle's; no ``folded_keys`` entry twice across
    the records (``double_folds`` 0); with ``kill``, ``agg_failovers`` >= 1
    and every device of a record's ``rehomed_devices`` with ``rehomed`` >=
    1 in the health ledger; the version increasing, every killed pid's
    flight dump, the postmortem naming the dead aggregator and the ledgers
    surviving, as in the flat soak."""
    if aggregations < 4:
        raise ValueError(
            f"tree-async soak needs >= 4 aggregations so the kills land "
            f"inside the run, got {aggregations}")
    workdir = workdir or tempfile.mkdtemp(prefix="colearn_treeasync_")
    os.makedirs(workdir, exist_ok=True)
    # Kill early (after about a third of the run), so that the failover's
    # detection, the slice's re-home and the re-homed partials' folds all
    # land before the root reaches its budget.
    cut = max(1, aggregations // 3)
    kills = ([KillSpec("aggregator:0", after_round=cut, restart=False),
              KillSpec("broker", after_round=min(cut + 2,
                                                 aggregations - 1))]
             if kill else [])

    faulted = _run_async_fleet(
        aggregations=aggregations, n_workers=n_workers,
        buffer_size=buffer_size, kills=kills,
        workdir=os.path.join(workdir, "faulted"),
        round_timeout=round_timeout, enroll_timeout=enroll_timeout,
        timeout_s=timeout_s, seed=seed, n_aggregators=2,
        fault_plan=None, log_fn=log_fn, lock_witness=lock_witness,
        backend=backend)
    oracle = _run_async_fleet(
        aggregations=aggregations, n_workers=n_workers,
        buffer_size=buffer_size, kills=[],
        workdir=os.path.join(workdir, "oracle"),
        round_timeout=round_timeout, enroll_timeout=enroll_timeout,
        timeout_s=timeout_s, seed=seed, n_aggregators=2,
        fault_plan=None, log_fn=log_fn, lock_witness=lock_witness,
        backend=backend)

    final_loss = _tail_loss(faulted["records"])
    oracle_loss = _tail_loss(oracle["records"])
    loss_gap = abs(final_loss - oracle_loss)
    loss_gap_ok = math.isfinite(loss_gap) and loss_gap <= loss_tol

    # Each record names the dedup keys (``version@device``) its partial
    # was built from: a key in two records reached the model twice.
    seen_keys: set = set()
    double_folds = 0
    for rec in faulted["records"]:
        for key in rec.get("folded_keys", []):
            if key in seen_keys:
                double_folds += 1
            seen_keys.add(key)

    agg_failovers = sum(int(r.get("agg_failovers", 0))
                        for r in faulted["records"])
    rehomed_devices = sorted({str(d) for r in faulted["records"]
                              for d in r.get("rehomed_devices", [])})

    faulted_dir = os.path.join(workdir, "faulted")
    agg_attributed = _killed_role_named(
        faulted_dir, faulted["kills"], kill,
        lambda role: role.startswith("aggregator"))
    # Every device the records say was re-homed carries a ``rehomed``
    # count in the merged ledger.
    devices = _fleet_health(faulted_dir)
    ledger_rehomed = {d for d, h in devices.items()
                      if int(h.counts.get("rehomed", 0)) >= 1}
    rehomed_attributed = ((not kill) or
                          (bool(rehomed_devices)
                           and set(rehomed_devices) <= ledger_rehomed))

    return {
        "exit_code": faulted["exit_code"],
        "oracle_exit_code": oracle["exit_code"],
        "aggregations_run": faulted["aggregations_run"],
        "oracle_aggregations_run": oracle["aggregations_run"],
        "version_monotonic": (faulted["version_monotonic"]
                              and oracle["version_monotonic"]),
        "final_loss": final_loss,
        "oracle_final_loss": oracle_loss,
        "loss_gap": loss_gap,
        "loss_gap_ok": loss_gap_ok,
        "double_folds": double_folds,
        "folded_keys_total": len(seen_keys),
        "agg_failovers": agg_failovers,
        "failover_fired": (not kill) or agg_failovers >= 1,
        "rehomed_devices": rehomed_devices,
        "rehomed_attributed": rehomed_attributed,
        "postmortem_attributed": agg_attributed,
        "health_ledger_ok": bool(devices),
        "health_devices": len(devices),
        "flight_missing": faulted["flight_missing"],
        "kills": faulted["kills"],
        "records": faulted["records"],
        "lock_witness": _merge_lockwitness(faulted["lock_witness"],
                                           oracle["lock_witness"]),
        "workdir": workdir,
    }


# --------------------------------------------------- streaming-ckpt soak --

def _ckpt_fault_plan(slow_ms: int) -> dict:
    """``slow_io`` on every per-shard checkpoint write: each shard file
    costs ``slow_ms`` more before its bytes land, widening the window
    between the first shard's commit and the manifest's so the watcher's
    SIGKILL lands inside a save."""
    return {"seed": 0, "faults": [
        {"kind": "slow_io", "device_id": "*", "round": -1, "op": "shard",
         "ms": slow_ms, "count": 0, "site": "server", "hop": "shard"},
    ]}


def _ckpt_gen_entries(ckpt_dir: str) -> list[str]:
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return []
    return sorted(os.path.join(ckpt_dir, n) for n in names
                  if n.startswith("gen_"))


def _ckpt_has_committed(ckpt_dir: str) -> bool:
    return any(os.path.exists(os.path.join(g, "manifest.json"))
               for g in _ckpt_gen_entries(ckpt_dir))


def _ckpt_in_progress(ckpt_dir: str) -> Optional[str]:
    """The newest generation directory with shard files on disk and no
    manifest: a save in flight (or a dead one the next restore falls
    through)."""
    for g in reversed(_ckpt_gen_entries(ckpt_dir)):
        if os.path.exists(os.path.join(g, "manifest.json")):
            continue
        try:
            names = os.listdir(g)
        except OSError:
            continue     # pruned while scanned: not a save in flight
        if any(n.startswith("shard_") and n.endswith(".npz")
               for n in names):
            return g
    return None


def _run_ckpt_fleet(
    rounds: int,
    n_workers: int,
    workdir: str,
    round_timeout: float,
    enroll_timeout: float,
    timeout_s: float,
    seed: int,
    tp_size: int,
    resume_tp_size: int,
    kill_during_save: bool,
    fault_plan: Optional[dict] = None,
    start_resumed: bool = False,
    ckpt_dir: Optional[str] = None,
    log_fn: Optional[Callable[[dict], None]] = None,
    backend: str = "gpu",
) -> dict:
    """One streaming-checkpoint fleet (a broker, N workers and the
    synchronous coordinator with ``--ckpt-stream``, on the CPU).  With
    ``kill_during_save`` a watcher thread polls the checkpoint directory
    and SIGKILLs the coordinator as soon as a generation has shard files
    and no manifest, after an earlier generation committed; right after
    the kill it records the last committed generation's step and digest
    (``ckpt.streaming.load_generation_host``), which the relaunched
    ``--resume`` coordinator (at ``resume_tp_size``) must restore.
    ``start_resumed`` launches the first coordinator with ``--resume``
    against an existing ``ckpt_dir`` (the kill-free smoke leg)."""
    os.makedirs(workdir, exist_ok=True)
    ckpt_dir = ckpt_dir or os.path.join(workdir, "ckpt")
    flight_dir = os.path.join(workdir, "flight")

    env = _child_env(backend)
    # The coordinator's placement needs tp_size host positions: the test
    # suite's 8 (the workers read nothing of it).
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8"
                        ).strip()

    fleet = _Fleet(workdir, env)
    watchdog = threading.Timer(timeout_s, fleet.kill_all)
    watchdog.daemon = True

    records: dict[int, dict] = {}
    events: list[dict] = []
    per_client: dict = {}
    resumed = 0
    incarnations = 1
    resume_event: Optional[dict] = None
    rc: Optional[int] = None
    holder: dict = {"coord": None, "restart_pending": False, "stop": False}
    killed: dict = {}

    def watch() -> None:
        from colearn_federated_learning_tpu_torch.ckpt.streaming import (
            load_generation_host)

        # Armed once a generation committed: a kill during the first save
        # would leave nothing to fall back to.
        while not holder["stop"] and not _ckpt_has_committed(ckpt_dir):
            time.sleep(0.02)
        prog = None
        while not holder["stop"]:
            prog = _ckpt_in_progress(ckpt_dir)
            if prog:
                break
            time.sleep(0.01)
        coord = holder["coord"]
        if holder["stop"] or coord is None or prog is None:
            return
        holder["restart_pending"] = True
        killed["pid"] = coord.pid
        killed["gen"] = os.path.basename(prog)
        coord.send_signal(signal.SIGKILL)
        killed["at"] = time.time()      # the kill's wall time
        coord.wait()
        # The process is dead and its relaunch not started: the directory
        # holds what the next restore must come back with.
        killed["mid_save"] = not os.path.exists(
            os.path.join(prog, "manifest.json"))
        try:
            _, step, digest = load_generation_host(ckpt_dir)
            killed["committed_step"] = step
            killed["digest"] = digest
        except FileNotFoundError:
            killed["committed_step"] = None
            killed["digest"] = None

    watcher = (threading.Thread(target=watch, daemon=True)
               if kill_during_save else None)

    try:
        watchdog.start()
        flight_flags = ["--flight-dir", flight_dir,
                        "--flight-heartbeat", "0.5"]
        host, port = fleet.start_broker(timeout=30.0, extra=flight_flags)
        worker_cfg = (_config_flags(rounds, n_workers, seed, backend=backend)
                      + flight_flags)
        for i in range(n_workers):
            fleet.start_worker(i, worker_cfg, host, port)
        coord_cfg = (_config_flags(rounds, n_workers, seed,
                                   checkpoint_dir=ckpt_dir, backend="cpu")
                     + ["--ckpt-stream"] + flight_flags)
        if fault_plan is not None:
            plan_path = os.path.join(workdir, "fault_plan.json")
            with open(plan_path, "w") as f:
                json.dump(fault_plan, f)
            coord_cfg += ["--fault-plan", plan_path]

        def launch(resume: bool) -> subprocess.Popen:
            tp = resume_tp_size if resume else tp_size
            c = fleet.start_coordinator(
                coord_cfg + ["--tp-size", str(tp)], host, port, n_workers,
                round_timeout, enroll_timeout, resume=resume)
            holder["coord"] = c
            return c

        coord = launch(resume=start_resumed)
        if watcher is not None:
            watcher.start()
        err_log = fleet._log_file("coordinator.err")
        while True:
            line = coord.stderr.readline()
            if line:
                err_log.write(line.encode())
                err_log.flush()
            if not line:
                coord.wait()
                if holder["restart_pending"]:
                    holder["restart_pending"] = False
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
                    resume_event = doc
                continue
            if "num_clients_evaluated" in doc:
                per_client = doc
                continue
            if "round" not in doc:
                continue
            records[int(doc["round"])] = doc
            if log_fn is not None:
                log_fn(doc)
    finally:
        holder["stop"] = True
        watchdog.cancel()
        fleet.close()
        if watcher is not None and watcher.is_alive():
            watcher.join(timeout=5.0)

    if rc is None:
        raise RuntimeError(
            f"coordinator never exited cleanly within {timeout_s}s "
            f"(records for rounds {sorted(records)})")

    from colearn_federated_learning_tpu_torch.telemetry import flight

    dumps = flight.load_flight_dumps(flight_dir)
    dumped_pids = {d.get("pid") for d in dumps if "error" not in d}
    flight_missing = sorted(({killed["pid"]} if "pid" in killed else set())
                            - dumped_pids)

    recs = [records[r] for r in sorted(records)]
    return {
        "rounds_run": len(recs),
        "records": recs,
        "weighted_acc": per_client.get("weighted_acc"),
        "resumed": resumed,
        "resume_event": resume_event,
        "coordinator_incarnations": incarnations,
        "kill": killed,
        "flight_dumps": len(dumped_pids),
        "flight_missing": flight_missing,
        "events": events,
        "exit_code": rc,
        "ckpt_dir": ckpt_dir,
        "workdir": workdir,
    }


def run_ckpt_soak(
    rounds: int = 4,
    n_workers: int = 2,
    workdir: Optional[str] = None,
    round_timeout: float = 120.0,
    enroll_timeout: float = 90.0,
    timeout_s: float = 600.0,
    kill: bool = True,
    seed: int = 0,
    loss_tol: float = 0.75,
    tp_size: int = 2,
    resume_tp_size: int = 1,
    slow_ms: int = 300,
    log_fn: Optional[Callable[[dict], None]] = None,
    backend: str = "gpu",
) -> dict:
    """The streaming checkpoint's chaos gate (``chaos --ckpt``).

    **Kill leg** (``kill=True``): a ``tp_size`` federation saves a
    streaming generation every round under a ``slow_io`` plan on its shard
    writes; a filesystem watcher SIGKILLs the coordinator while a save is
    in flight (shard files on disk, no manifest yet), after at least one
    generation committed, and the coordinator is relaunched with
    ``--resume`` at ``resume_tp_size``.  The gate holds:

    - the kill landed mid-save (``killed_mid_save``) and the resume
      restored the last committed generation: the resumed round is the
      step the watcher recorded at the kill;
    - the resume event's ``ckpt_digest`` equals the digest
      ``load_generation_host`` computed from that generation, across the
      tp change (``resharded`` >= 1 when the tps differ);
    - the tail train loss is within ``loss_tol`` of a kill-free oracle
      federation at ``resume_tp_size``;
    - the killed pid left a flight dump whose postmortem names the
      coordinator.

    **Smoke leg** (``kill=False``): a kill-free ``tp_size`` run to its
    end, then a fresh fleet resumes the same directory at
    ``resume_tp_size`` with no rounds left: its digest must be the
    harness's ``load_generation_host`` digest of the final generation."""
    if rounds < 3:
        raise ValueError(
            f"ckpt soak needs >= 3 rounds so the mid-save kill lands "
            f"after a committed generation, got {rounds}")
    workdir = workdir or tempfile.mkdtemp(prefix="colearn_ckptsoak_")
    os.makedirs(workdir, exist_ok=True)
    reshard = tp_size != resume_tp_size

    if not kill:
        first = _run_ckpt_fleet(
            rounds, n_workers, os.path.join(workdir, "save"),
            round_timeout, enroll_timeout, timeout_s, seed,
            tp_size=tp_size, resume_tp_size=tp_size,
            kill_during_save=False, log_fn=log_fn, backend=backend)
        from colearn_federated_learning_tpu_torch.ckpt.streaming import (
            load_generation_host)

        _, step, digest = load_generation_host(first["ckpt_dir"])
        second = _run_ckpt_fleet(
            rounds, n_workers, os.path.join(workdir, "resume"),
            round_timeout, enroll_timeout, timeout_s, seed,
            tp_size=resume_tp_size, resume_tp_size=resume_tp_size,
            kill_during_save=False, start_resumed=True,
            ckpt_dir=first["ckpt_dir"], log_fn=log_fn, backend=backend)
        ev = second["resume_event"] or {}
        return {
            "mode": "smoke",
            "exit_code": first["exit_code"],
            "resume_exit_code": second["exit_code"],
            "rounds_run": first["rounds_run"],
            "committed_step": step,
            "save_digest": digest,
            "resume_digest": ev.get("ckpt_digest"),
            "resume_round": ev.get("round"),
            "resume_round_ok": ev.get("round") == step,
            "digest_ok": (digest is not None
                          and ev.get("ckpt_digest") == digest),
            "resharded_resumes": int(ev.get("resharded", 0) or 0),
            "reshard_ok": ((not reshard)
                           or int(ev.get("resharded", 0) or 0) >= 1),
            "records": first["records"],
            "workdir": workdir,
        }

    faulted = _run_ckpt_fleet(
        rounds, n_workers, os.path.join(workdir, "faulted"),
        round_timeout, enroll_timeout, timeout_s, seed,
        tp_size=tp_size, resume_tp_size=resume_tp_size,
        kill_during_save=True, fault_plan=_ckpt_fault_plan(slow_ms),
        log_fn=log_fn, backend=backend)
    oracle = _run_ckpt_fleet(
        rounds, n_workers, os.path.join(workdir, "oracle"),
        round_timeout, enroll_timeout, timeout_s, seed,
        tp_size=resume_tp_size, resume_tp_size=resume_tp_size,
        kill_during_save=False, log_fn=log_fn, backend=backend)

    ev = faulted["resume_event"] or {}
    killed = faulted["kill"]
    committed = killed.get("committed_step")
    final_loss = _tail_loss(faulted["records"])
    oracle_loss = _tail_loss(oracle["records"])
    loss_gap = abs(final_loss - oracle_loss)
    faulted_dir = os.path.join(workdir, "faulted")
    attributed = _killed_role_named(
        faulted_dir, [killed] if "pid" in killed else [], True,
        lambda role: role == "coordinator")

    return {
        "mode": "kill",
        "exit_code": faulted["exit_code"],
        "oracle_exit_code": oracle["exit_code"],
        "rounds_run": faulted["rounds_run"],
        "oracle_rounds_run": oracle["rounds_run"],
        "killed_mid_save": bool(killed.get("mid_save")),
        "killed_gen": killed.get("gen"),
        "committed_step": committed,
        "kill_digest": killed.get("digest"),
        "resume_digest": ev.get("ckpt_digest"),
        "resume_round": ev.get("round"),
        "resume_round_ok": (committed is not None
                            and ev.get("round") == committed),
        "digest_ok": (killed.get("digest") is not None
                      and ev.get("ckpt_digest") == killed["digest"]),
        "resharded_resumes": int(ev.get("resharded", 0) or 0),
        "reshard_ok": ((not reshard)
                       or int(ev.get("resharded", 0) or 0) >= 1),
        "resumed": faulted["resumed"],
        "coordinator_incarnations": faulted["coordinator_incarnations"],
        "final_loss": final_loss,
        "oracle_final_loss": oracle_loss,
        "loss_gap": loss_gap,
        "loss_gap_ok": math.isfinite(loss_gap) and loss_gap <= loss_tol,
        "postmortem_attributed": attributed,
        "flight_missing": faulted["flight_missing"],
        "kill": killed,
        "records": faulted["records"],
        "workdir": workdir,
    }
