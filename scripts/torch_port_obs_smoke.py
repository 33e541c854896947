#!/usr/bin/env python3
"""Observability-plane smoke of the port: small real federations, every
plane hit (the counterpart of the JAX package's ``scripts/obs_smoke.py``:
its four phases, their checks and their argv selection).

Each phase spawns a broker, workers and a coordinator of the port's
command line (``python -m colearn_federated_learning_tpu_torch.cli``) as
real subprocesses on real ports, on the card unless the caller asks for
the CPU (``--device cpu``):

- **classic**: the flight recorder on a fast heartbeat, the Prometheus
  endpoint on an ephemeral port and the JSONL event stream; the
  mid-run ``/metrics`` scrape against the exposition grammar, the
  mid-run ``/snapshot.json`` replayed to ``top --once`` after the run
  (the CLI's start-up is slower than the 3-round federation), a worker
  SIGKILLed mid-run leaving a parseable flight dump, the start event
  and one event per round, ``postmortem`` over the flight dir;
- **tree**: a 2-aggregator tier with ``--trace-dir`` and
  ``--health-dir``: one stitched round trace over the three tiers, a
  non-empty health ledger fed by the aggregators, labeled histogram
  samples in the scrape;
- **async**: ``coordinate --async-buffer 2 --async-observe``: the
  labeled staleness histogram and the arrival-rate gauge in the scrape,
  ``fold_update`` spans carrying τ and parented on their dispatch, one
  trace stitching dispatch -> train -> fold;
- **learning**: ``--learn-observe``: the ``learn_*`` instruments in the
  scrape and the ``conv_*`` trail in the event stream.

Exit 0 only if every check passes.  Pass phase names (``classic``,
``tree``, ``async``, ``learning``) to run a subset:

    python scripts/torch_port_obs_smoke.py [--device cpu] [PHASE ...]
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_CLI = "colearn_federated_learning_tpu_torch.cli"
ROUNDS = 3
N_WORKERS = 2

# Prometheus text exposition 0.0.4: comment lines or `name{labels} value`
# (the JAX script's grammar oracle).
_PROM_LINE = re.compile(
    r"^(# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .*"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9.eE+naif-]+)$")


def _config_flags(backend: str, n_clients: int = N_WORKERS) -> list[str]:
    return ["--config", "mnist_mlp_fedavg", "--backend", backend,
            "--dataset", "mnist_tiny", "--partition", "iid",
            "--num-clients", str(n_clients), "--rounds", str(ROUNDS),
            "--cohort-size", "0", "--local-steps", "2",
            "--batch-size", "16", "--min-cohort-fraction", "0.5",
            "--evict-after", "2", "--seed", "0"]


def bad_lines(text: str) -> tuple[list, list]:
    """The non-empty lines of an exposition and those the grammar
    rejects."""
    lines = [ln for ln in text.splitlines() if ln]
    return lines, [ln for ln in lines if not _PROM_LINE.match(ln)]


def _scrape(port: int, path: str = "metrics") -> bytes:
    return urllib.request.urlopen(f"http://127.0.0.1:{port}/{path}",
                                  timeout=10).read()


class Fleet:
    """A broker and ``n`` workers of the port's CLI, and whatever else is
    spawned through :meth:`spawn`; :meth:`close` kills what still runs."""

    def __init__(self, env: dict, workdir: str, cfg: list, n: int,
                 worker_flags=()):
        self.env, self.workdir, self.procs = env, workdir, []
        self.coordinators: list = []
        broker = self.spawn(["broker"], stdout=subprocess.PIPE, text=True)
        addr = json.loads(broker.stdout.readline())
        self.host, self.port = addr["host"], str(addr["port"])
        self.workers = [self.spawn_logged(
            f"worker{i}", ["worker", *cfg, *worker_flags, "--client-id",
                           str(i), *self.at()]) for i in range(n)]

    def at(self) -> list[str]:
        return ["--broker-host", self.host, "--broker-port", self.port]

    def spawn(self, args: list[str], **kw) -> subprocess.Popen:
        p = subprocess.Popen([sys.executable, "-m", _CLI, *args],
                             env=self.env, **kw)
        self.procs.append(p)
        return p

    def spawn_logged(self, name: str, args: list[str]) -> subprocess.Popen:
        log = open(os.path.join(self.workdir, f"{name}.log"), "ab")
        try:
            return self.spawn(args, stdout=log, stderr=log)
        finally:
            log.close()

    def coordinate(self, args: list[str]) -> subprocess.Popen:
        p = self.spawn(["coordinate", *args, *self.at()],
                       stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                       text=True)
        self.coordinators.append(p)
        return p

    @contextlib.contextmanager
    def paused(self):
        """Every worker and aggregator stopped (SIGSTOP) for the body, and
        resumed after it: a mid-run scrape then reaches a coordinator
        still waiting for its next round, however fast the rounds run.
        The pause is far below the round timeouts."""
        held = [p for p in self.procs[1:]
                if p.poll() is None and p not in self.coordinators]
        for p in held:
            p.send_signal(signal.SIGSTOP)
        try:
            yield
        finally:
            for p in held:
                if p.poll() is None:
                    p.send_signal(signal.SIGCONT)

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()


def _records(coord: subprocess.Popen):
    """``(metrics_port, doc)`` for each JSON line of the coordinator's
    stderr, the port announced so far beside it."""
    metrics_port = None
    for line in coord.stderr:
        try:
            doc = json.loads(line.strip())
        except json.JSONDecodeError:
            continue
        if doc.get("event") == "metrics_port":
            metrics_port = int(doc["port"])
        yield metrics_port, doc


def _trace_files(trace_dir: str) -> list[str]:
    return ([os.path.join(trace_dir, f) for f in sorted(os.listdir(trace_dir))
             if f.endswith("_trace.json")]
            if os.path.isdir(trace_dir) else [])


def run_tree_phase(check, env: dict, backend: str) -> None:
    """2-aggregator federation: stitched trace + health ledger + labeled
    histograms (the fleet-health plane's end-to-end contract)."""
    from colearn_federated_learning_tpu_torch import telemetry

    workdir = tempfile.mkdtemp(prefix="colearn_obs_tree_")
    trace_dir = os.path.join(workdir, "trace")
    health_dir = os.path.join(workdir, "health")
    cfg = _config_flags(backend) + ["--health-dir", health_dir]
    fleet = Fleet(env, workdir, cfg, N_WORKERS)
    try:
        for a in range(2):
            fleet.spawn_logged(f"aggregator{a}", [
                "aggregator", *cfg, "--agg-id", str(a), *fleet.at()])
        coord = fleet.coordinate(
            [*cfg, "--num-aggregators", "2", "--trace-dir", trace_dir,
             "--metrics-port", "0", "--min-devices", str(N_WORKERS),
             "--round-timeout", "30", "--enroll-timeout", "90",
             "--no-evaluator"])
        scraped = False
        for metrics_port, doc in _records(coord):
            if "round" in doc and not scraped and metrics_port:
                scraped = True
                with fleet.paused():
                    text = _scrape(metrics_port).decode("utf-8")
                lines, bad = bad_lines(text)
                check(not bad,
                      f"tree scrape matches the exposition grammar "
                      f"(bad: {bad[:3]})")
                labeled_hist = [
                    ln for ln in lines
                    if ln.startswith("colearn_fed_phase_time_s{")
                    and "quantile=" in ln and "phase=" in ln]
                check(bool(labeled_hist),
                      "scrape carries LABELED histogram samples "
                      "(fed_phase_time_s{phase=...})")
        rc = coord.wait(timeout=180)
        check(rc == 0, f"tree coordinator exited 0 (got {rc})")

        # One stitched round trace: coordinator, BOTH aggregator slice
        # folds, and worker train spans, linked parent -> child.
        traces = _trace_files(trace_dir)
        check(bool(traces), "tree run wrote a Chrome-trace JSON")
        if traces:
            spans = telemetry.trace_spans(telemetry.load_trace(traces[0]))
            folds = [s for s in spans if s.name == "aggregator.fold"]
            fold_aggs = {s.process for s in folds}
            check(fold_aggs >= {"aggregator-0", "aggregator-1"},
                  f"both aggregator slice folds in the trace "
                  f"(got {sorted(fold_aggs)})")
            stitched = False
            for tid in {s.trace_id for s in folds}:
                tier = [s for s in spans if s.trace_id == tid]
                ids = {s.span_id for s in tier}
                t_folds = [s for s in tier if s.name == "aggregator.fold"
                           and s.parent_id in ids]
                t_train = [s for s in tier if s.name == "worker.train"
                           and s.parent_id in {f.span_id for f in t_folds}]
                t_coord = [s for s in tier
                           if s.process.startswith("coordinator")]
                if len(t_folds) >= 2 and t_train and t_coord:
                    stitched = True
                    break
            check(stitched,
                  "one round trace stitches coordinator -> 2 aggregator "
                  "folds -> worker train spans with parent links")

        devices = telemetry.load_health(health_dir)
        check(bool(devices),
              f"health ledger non-empty ({len(devices)} device(s))")
        check(any(h.lat_samples for h in devices.values()),
              "health ledger attributes per-device round latency")
        sources = (sorted(os.listdir(health_dir))
                   if os.path.isdir(health_dir) else [])
        check(any(s.startswith("health_aggregator") for s in sources),
              f"aggregator tier fed the ledger (files: {sources})")
    finally:
        fleet.close()


def run_async_phase(check, env: dict, backend: str) -> None:
    """Buffered-async federation: labeled staleness exposition + the
    observatory's stitched dispatch -> train -> fold lineage traces."""
    from colearn_federated_learning_tpu_torch import telemetry

    n_workers = 3
    workdir = tempfile.mkdtemp(prefix="colearn_obs_async_")
    trace_dir = os.path.join(workdir, "trace")
    health_dir = os.path.join(workdir, "health")
    cfg = _config_flags(backend, n_workers) + ["--health-dir", health_dir]
    fleet = Fleet(env, workdir, cfg, n_workers)
    try:
        coord = fleet.coordinate(
            [*cfg, "--async-buffer", "2", "--async-observe",
             "--trace-dir", trace_dir, "--metrics-port", "0",
             "--min-devices", str(n_workers), "--round-timeout", "30",
             "--enroll-timeout", "90", "--no-evaluator"])
        scraped = False
        observed_rec = False
        for metrics_port, doc in _records(coord):
            if "aggregation" in doc and "arrival_rate_per_s" in doc:
                observed_rec = True
            if "aggregation" in doc and not scraped and metrics_port:
                scraped = True
                with fleet.paused():
                    text = _scrape(metrics_port).decode("utf-8")
                lines, bad = bad_lines(text)
                check(not bad,
                      f"async scrape matches the exposition grammar "
                      f"(bad: {bad[:3]})")
                stale = [ln for ln in lines
                         if ln.startswith("colearn_async_staleness{")
                         and "outcome=" in ln]
                check(bool(stale),
                      "scrape carries the labeled staleness histogram "
                      "(async_staleness{outcome=...})")
                arrival = [ln for ln in lines if ln.startswith(
                    "colearn_async_arrival_rate_per_s")]
                check(bool(arrival),
                      "scrape carries the arrival-rate gauge")
        rc = coord.wait(timeout=180)
        check(rc == 0, f"async coordinator exited 0 (got {rc})")
        check(observed_rec,
              "observatory keys (arrival_rate_per_s) in aggregation "
              "records under --async-observe")

        traces = _trace_files(trace_dir)
        check(bool(traces), "async run wrote a Chrome-trace JSON")
        if traces:
            spans = telemetry.trace_spans(telemetry.load_trace(traces[0]))
            folds = [s for s in spans if s.name == "fold_update"]
            check(bool(folds), "trace carries fold_update lineage spans")
            check(all("tau" in s.attrs for s in folds),
                  "every fold_update span carries tau in its args")
            check(folds and all(s.parent_id for s in folds),
                  "every fold_update span is parented on its dispatch "
                  "context")
            # Full lineage: one trace id holds dispatch -> worker train
            # -> fold for the same update.
            stitched = False
            for f in folds:
                tier = [s for s in spans if s.trace_id == f.trace_id]
                if {"dispatch_train", "worker.train",
                        "fold_update"} <= {s.name for s in tier}:
                    stitched = True
                    break
            check(stitched,
                  "one trace stitches dispatch_train -> worker.train -> "
                  "fold_update for an update")
            aggs = [s for s in spans if s.name == "async.aggregate"]
            check(bool(aggs) and any(s.attrs.get("link_folds")
                                     for s in aggs),
                  "async.aggregate spans cross-link their folds")
    finally:
        fleet.close()


def run_learning_phase(check, env: dict, backend: str) -> None:
    """Convergence observatory over a REAL federation (--learn-observe):
    the mid-run scrape carries the learn_* instruments and the committed
    event stream carries the conv_* trail, one signal per round."""
    workdir = tempfile.mkdtemp(prefix="colearn_obs_learn_")
    events_path = os.path.join(workdir, "events.jsonl")
    cfg = _config_flags(backend)
    fleet = Fleet(env, workdir, cfg, N_WORKERS)
    try:
        coord = fleet.coordinate(
            [*cfg, "--learn-observe", "--metrics-port", "0",
             "--events-file", events_path, "--min-devices", str(N_WORKERS),
             "--round-timeout", "30", "--enroll-timeout", "90",
             "--no-evaluator"])
        scraped = False
        for metrics_port, doc in _records(coord):
            if "round" in doc and not scraped and metrics_port:
                scraped = True
                with fleet.paused():
                    text = _scrape(metrics_port).decode("utf-8")
                lines, bad = bad_lines(text)
                check(not bad,
                      f"learning scrape matches the exposition grammar "
                      f"(bad: {bad[:3]})")
                norm = [ln for ln in lines
                        if ln.startswith("colearn_learn_update_norm ")]
                check(bool(norm),
                      "scrape carries the learn_update_norm gauge")
                trend = [ln for ln in lines
                         if ln.startswith("colearn_learn_trend_total{")
                         and "trend=" in ln]
                check(bool(trend),
                      "scrape carries the labeled trend census "
                      "(learn_trend_total{trend=...})")
        rc = coord.wait(timeout=180)
        check(rc == 0, f"learning coordinator exited 0 (got {rc})")

        with open(events_path) as f:
            events = [json.loads(ln) for ln in f if ln.strip()]
        rounds = [e for e in events if e.get("event") == "round"]
        check(len(rounds) >= ROUNDS,
              f"event stream carries one event per round "
              f"({len(rounds)}/{ROUNDS})")
        trail = [e.get("conv_update_norm") for e in rounds]
        check(all(isinstance(v, (int, float)) and v > 0 for v in trail),
              f"every round event carries a conv_update_norm signal "
              f"(trail: {trail})")
        check(all("conv_trend" in e for e in rounds),
              "every round event carries a conv_trend classification")
        check(all("conv_cos_prev" in e for e in rounds[1:])
              and "conv_cos_prev" not in rounds[0],
              "conv_cos_prev absent on the first round, present after")
    finally:
        fleet.close()


def _replay_top(env: dict, snapshot_body: bytes) -> subprocess.CompletedProcess:
    """``top --once`` against a local server replaying a captured
    ``/snapshot.json``."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Replay(BaseHTTPRequestHandler):
        def do_GET(self):      # noqa: N802 (stdlib handler name)
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(snapshot_body)))
            self.end_headers()
            self.wfile.write(snapshot_body)

        def log_message(self, fmt, *log_args):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Replay)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        return subprocess.run(
            [sys.executable, "-m", _CLI, "top", "--once", "--url",
             f"http://127.0.0.1:{srv.server_address[1]}/snapshot.json"],
            env=env, capture_output=True, text=True, timeout=60)
    finally:
        srv.shutdown()
        srv.server_close()


def run_classic_phase(check, env: dict, backend: str) -> None:
    """Flight recorder + exporter + event stream + SIGKILL dump +
    top/postmortem over one real federation (the original smoke)."""
    from colearn_federated_learning_tpu_torch.telemetry import flight

    workdir = tempfile.mkdtemp(prefix="colearn_obs_")
    flight_dir = os.path.join(workdir, "flight")
    events_path = os.path.join(workdir, "events.jsonl")
    cfg = _config_flags(backend)
    obs = ["--flight-dir", flight_dir, "--flight-heartbeat", "0.5"]
    fleet = Fleet(env, workdir, cfg, N_WORKERS, worker_flags=obs)
    try:
        coord = fleet.coordinate(
            [*cfg, *obs, "--metrics-port", "0", "--events-file",
             events_path, "--min-devices", str(N_WORKERS),
             "--round-timeout", "25", "--enroll-timeout", "90",
             "--no-evaluator", "--elastic"])
        victim_pid = None
        scraped = False
        snapshot_body = b""
        for metrics_port, doc in _records(coord):
            if "round" in doc and not scraped:
                scraped = True
                check(metrics_port is not None,
                      "metrics_port announced before the first round")
                if metrics_port:
                    with fleet.paused():
                        text = _scrape(metrics_port).decode("utf-8")
                        snapshot_body = _scrape(metrics_port,
                                                "snapshot.json")
                    lines, bad = bad_lines(text)
                    check(not bad,
                          f"every /metrics line matches the exposition "
                          f"grammar (bad: {bad[:3]})")
                    check(any(ln.startswith("colearn_") for ln in lines),
                          "scrape carries colearn_* samples")
                    check(bool(json.loads(snapshot_body)),
                          "/snapshot.json serves the live registry")
                # Induced kill: the dump the recorder's heartbeat left
                # behind must survive an uncatchable SIGKILL.
                victim = fleet.workers[-1]
                victim_pid = victim.pid
                time.sleep(1.0)          # > one 0.5 s heartbeat period
                victim.send_signal(signal.SIGKILL)
        rc = coord.wait(timeout=120)
        check(rc == 0, f"coordinator exited 0 (got {rc})")

        # Replay the mid-run snapshot for `top --once` so the render path
        # is exercised on real federation data without racing the
        # (long-gone) coordinator's exporter.
        if snapshot_body:
            top = _replay_top(env, snapshot_body)
            check(top.returncode == 0 and bool(top.stdout.strip()),
                  f"colearn top --once renders the captured snapshot"
                  f" (rc={top.returncode},"
                  f" err={top.stderr.strip()[:200]!r})")
        else:
            check(False, "no /snapshot.json captured mid-run")

        dumps = flight.load_flight_dumps(flight_dir)
        dumped = {d.get("pid") for d in dumps if "error" not in d}
        check(victim_pid in dumped,
              f"SIGKILLed worker pid {victim_pid} left a parseable "
              f"flight dump (found pids: {sorted(dumped)})")

        with open(events_path) as f:
            events = [json.loads(ln) for ln in f if ln.strip()]
        check(any(e.get("event") == "start" for e in events),
              "event stream carries the start event")
        n_round_events = sum(1 for e in events if e.get("event") == "round")
        check(n_round_events >= ROUNDS,
              f"event stream carries one event per round "
              f"({n_round_events}/{ROUNDS})")

        pm = subprocess.run(
            [sys.executable, "-m", _CLI, "postmortem", flight_dir,
             "--format", "json"],
            env=env, capture_output=True, text=True, timeout=60)
        ok_pm = pm.returncode == 0
        if ok_pm:
            report = json.loads(pm.stdout)
            ok_pm = len(report.get("processes", [])) >= 1
        check(ok_pm, "colearn postmortem parses the flight dir")
    finally:
        fleet.close()


_PHASES = {
    "classic": run_classic_phase,
    "tree": run_tree_phase,
    "async": run_async_phase,
    "learning": run_learning_phase,
}


def child_env(backend: str) -> dict:
    """The processes' environment: streamed output, the checkout on the
    path, and on the CPU one intra-op thread per process (a fleet of 5-6
    processes with a thread per core each slows every update)."""
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    if backend == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
    return env


def main(argv=None) -> int:
    names = list(argv if argv is not None else sys.argv[1:])
    backend = "gpu"
    if "--device" in names:
        i = names.index("--device")
        device = names[i + 1] if i + 1 < len(names) else ""
        if device not in ("cuda", "cpu"):
            print(f"[obs-smoke] --device takes cuda or cpu, not {device!r}",
                  file=sys.stderr)
            return 2
        backend = "gpu" if device == "cuda" else "cpu"
        del names[i:i + 2]
    unknown = [n for n in names if n not in _PHASES]
    if unknown:
        print(f"[obs-smoke] unknown phase(s) {unknown}; "
              f"choose from {sorted(_PHASES)}", file=sys.stderr)
        return 2
    if backend == "gpu":
        import torch

        if not torch.cuda.is_available():
            print("[obs-smoke] no CUDA device (use --device cpu for the "
                  "CPU)", file=sys.stderr)
            return 1
    if not names:
        names = ["classic", "tree", "async", "learning"]
    env = child_env(backend)
    failures: list[str] = []

    def check(ok: bool, label: str) -> None:
        print(f"[obs-smoke] {'ok' if ok else 'FAIL'}: {label}",
              file=sys.stderr)
        if not ok:
            failures.append(label)

    for name in names:
        print(f"[obs-smoke] phase: {name}", file=sys.stderr)
        _PHASES[name](check, env, backend)

    if failures:
        print(f"[obs-smoke] {len(failures)} check(s) failed",
              file=sys.stderr)
        return 1
    print("[obs-smoke] all checks passed", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
