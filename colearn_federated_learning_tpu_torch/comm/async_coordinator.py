"""Asynchronous (buffered) federated coordinator over the socket planes: the
counterpart of the JAX package's ``comm/async_coordinator.py``.

The synchronous coordinator (``comm/coordinator.py``) waits every round on
a deadline for the whole cohort, so one slow device stalls the federation.
This one is buffered-asynchronous (FedBuff-style):

- one dispatch pump per trainer keeps that device busy: snapshot the
  CURRENT global model (encoded once per model version), request local
  training, queue the returned delta tagged with the version it started
  from; a pump trains at most once per (device, version) and then waits
  on the version condition;
- an aggregation applies the buffer as soon as ``buffer_size`` updates
  have arrived: an update trained on version ``v`` applied at version
  ``t`` weighs ``(1 + t - v)^(-staleness_exponent)``, and one older than
  ``max_staleness`` is discarded; the server step is the same
  ``fed/strategies.py`` update the synchronous coordinator applies, on the
  coordinator's device;
- the fold is the ``StreamingFolder`` with arrival-indexed staging keys
  (``f"{idx:08d}@{dev}"``, so its sorted finalize is the arrival order),
  on the card with ``run.fold_device``.  Only the aggregating thread
  folds, steps and copies the params to the host; the pumps encode that
  host copy and touch no device.

With ``buffer_size`` equal to the number of trainers each pump trains once
per version, so every aggregation folds one fresh (τ = 0) update per
trainer: a full-participation FedAvg round, up to the fold order.

DP: every applied aggregation is charged to the RDP accountant as one
Gaussian mechanism at its realized effective multiplier (``q = 1``; see
:meth:`AsyncFederatedCoordinator._charge_privacy`).  Secure aggregation,
adaptive clipping, ``compress_down`` and the non-mean aggregators are
refused with the JAX package's words.

Pruning (``prune_after``/``prune_score``, with ``run.health_dir``): a
device whose updates keep arriving too stale, or whose health-ledger
score is too high, has its pump paused for ``probation`` aggregations,
never below ``buffer_size`` active pumps.  A pump whose device fails
``run.evict_after`` dispatches in a row evicts it; elastic re-enrollment
(:meth:`refresh_membership`) starts a fresh pump.  ``buffer_size="auto"``
sizes K from the observed arrival rate (``telemetry/arrival.py``), slew-
limited to [K/2, 3K/2] per aggregation; ``observe`` stamps the
contribution-mass, arrival-rate and staleness-tail keys into the records.

Tree mode (``run.num_aggregators`` > 0): each contribution streams into its
assigned aggregator's slice buffer (``abuf``) under the dedup key
``f"{version:08d}@{device}"``; one drainer thread per aggregator long-polls
partial folds (``adrain``); the root resolves staleness against each
partial's OLDEST constituent version, scales the partial in f32 on the
host and folds it through ``add_partial``.  A dead aggregator's
contributions still in flight are re-homed to a live sibling under their
keys, so nothing is folded twice.

Telemetry is JAX's: ``dispatch_train`` per dispatch, an ``async.aggregate``
span with ``collect_updates`` and ``apply_update`` inside, and one
``fold_update`` per consumed update parented on its dispatch context; the
``async.*`` and ``comm.agg_*`` instruments count at JAX's sites.  The
locks are plain ``threading`` locks (JAX wraps its own in a lock witness
for the chaos soaks, ROADMAP item 16).

LoRA is refused in the port's own words: the JAX package's asynchronous
coordinator has no LoRA branch (it broadcasts a plain params frame, which
a LoRA worker cannot read, so every dispatch fails).

With ``run.checkpoint_dir`` the state ``(server_state,)`` is saved keyed
by ``version``, after the record is logged, every
``run.checkpoint_every`` aggregations and after the last (JAX's order);
``restore_checkpoint`` sets the version under the state lock, drops the
snapshot cache and rebuilds the accountant by replaying each record's
``dp_z_eff``.  As JAX's, it keeps no enrollment ledger and runs no
challenge on resume.

With ``run.tp_size`` > 1 the server state, the buffered folds (flat,
and the tree's drained partials) and the server step are sharded over
``CoordinatorCore``'s placement, as in the synchronous coordinator; the
pumps' host copy of the params is read per shard, and a resume is re-cut
onto the placement.

With ``run.learn_observe`` the convergence observatory
(``CoordinatorCore``'s, as in the synchronous coordinator) observes each
applied buffer's mean after the server step: the ``apply_update`` span
carries the ``conv_*`` attributes (the tree's aggregations put none, as
JAX's) and the record the ``conv_*`` keys.  It keeps a copy of the
previous mean on the coordinator's device for the cosine.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from colearn_federated_learning_tpu_torch import telemetry
from colearn_federated_learning_tpu_torch.comm import aggregator as agg_lib
from colearn_federated_learning_tpu_torch.comm import protocol
from colearn_federated_learning_tpu_torch.comm.aggregation import (
    StreamingFolder)
from colearn_federated_learning_tpu_torch.comm.coordinator import (
    CoordinatorCore)
from colearn_federated_learning_tpu_torch.comm.downlink import host_params
from colearn_federated_learning_tpu_torch.comm.enrollment import DeviceInfo
from colearn_federated_learning_tpu_torch.comm.transport import TensorClient
from colearn_federated_learning_tpu_torch.faults import lockwitness
from colearn_federated_learning_tpu_torch.fed import setup as setup_lib
from colearn_federated_learning_tpu_torch.utils import trees
from colearn_federated_learning_tpu_torch.utils.config import (
    ExperimentConfig, validate_robustness)
from colearn_federated_learning_tpu_torch.utils.serialization import (
    pytree_to_bytes)

PUMP_STATES = ("wait", "train", "retry", "pruned", "evicted")


class AsyncFederatedCoordinator(CoordinatorCore):
    """Buffered-asynchronous aggregation server (see module docstring)."""

    def __init__(
        self,
        config: ExperimentConfig,
        broker_host: str,
        broker_port: int,
        buffer_size=4,
        staleness_exponent: float = 0.5,
        max_staleness: int = 10,
        request_timeout: float = 60.0,
        want_evaluator: bool = True,
        mud_policy=None,
        prune_after: int = 0,
        prune_score: float = 0.0,
        probation: int = 8,
        observe: bool = False,
        auto_interval_s: float = 2.0,
        device=None,
    ):
        """``buffer_size``: an int >= 1, or ``"auto"`` (K = the observed
        arrival rate × ``auto_interval_s``, re-evaluated before every
        aggregation).  ``prune_after``: consecutive too-stale discards
        that pause a pump (0 disables); ``prune_score``: the health score
        that pauses one (0 disables); ``probation``: aggregations a
        paused device sits out.  Either trigger needs ``run.health_dir``.
        ``observe``: stamp the observatory keys into the records (implied
        by auto-K).  ``device``: where the server state and the device
        fold live (``None``: the card, raising without one)."""
        if isinstance(buffer_size, str):
            if buffer_size != "auto":
                raise ValueError(
                    f"buffer_size must be an int >= 1 or 'auto', "
                    f"got {buffer_size!r}")
            self.auto_buffer = True
            buffer_size = 4       # warm-start K until the estimator is live
        else:
            self.auto_buffer = False
            if buffer_size < 1:
                raise ValueError(
                    f"buffer_size must be >= 1, got {buffer_size}")
        if auto_interval_s <= 0:
            raise ValueError(
                f"auto_interval_s must be > 0, got {auto_interval_s}")
        if prune_after < 0 or prune_score < 0:
            raise ValueError("prune_after/prune_score must be >= 0")
        if probation < 1:
            raise ValueError(f"probation must be >= 1, got {probation}")
        if (prune_after or prune_score) and not config.run.health_dir:
            raise ValueError(
                "straggler pruning scores devices from the health ledger; "
                "set run.health_dir (--health-dir) to enable it"
            )
        if config.fed.dp_adaptive_clip:
            raise NotImplementedError(
                "dp_adaptive_clip is engine-only (stateless socket "
                "participants carry no cross-round clip state); use a "
                "fixed dp_clip for async DP"
            )
        if config.fed.secure_agg:
            raise NotImplementedError(
                "asynchronous aggregation with secure_agg is unsupported: "
                "pairwise masks need an agreed per-round cohort, and the "
                "dropout-recovery share distribution (privacy/dropout.py) "
                "is a round-scoped synchronous fan-out the per-device "
                "pumps don't have; use the synchronous coordinator"
            )
        if config.fed.compress_down != "none":
            raise NotImplementedError(
                "downlink delta compression (compress_down) is "
                "synchronous-only: each async pump trains a different "
                "model version, so there is no shared broadcast base to "
                "delta against; use the synchronous coordinator"
            )
        setup_lib.require_mean_aggregator(config, "the async coordinator")
        validate_robustness(config)
        if config.fed.lora_rank > 0:
            raise NotImplementedError(
                "asynchronous aggregation with LoRA is unsupported: the "
                "async coordinator broadcasts a plain params frame, which "
                "a LoRA worker cannot read (the reference coordinator has "
                "no LoRA branch, so every dispatch fails there); use the "
                "synchronous coordinator")
        # Quorum over DISTINCT contributors; 0 disables.
        self.min_cohort_fraction = config.fed.min_cohort_fraction
        self.buffer_size = buffer_size
        self.observe_records = bool(observe) or self.auto_buffer
        self.auto_interval_s = float(auto_interval_s)
        self.staleness_exponent = staleness_exponent
        self.max_staleness = max_staleness
        self.request_timeout = request_timeout
        self._init_core(config, broker_host, broker_port, want_evaluator,
                        mud_policy, None, device, "async-coordinator")
        # The pumps observe every successful dispatch; auto-K and the
        # gauges read the fleet rate.
        self.arrival = telemetry.ArrivalEstimator()
        self._pump_state: dict[str, str] = {}
        # Cumulative fold/discard counts: auto-K scales its target by the
        # fold fraction (only folded arrivals fill the buffer).
        self._folded_total = 0
        self._discarded_total = 0
        self._results: queue.Queue = queue.Queue()
        # (version, encoded frame): one encode per version.
        self._snap_cache: Optional[tuple] = None
        self._state_lock = lockwitness.lock("coord.state_lock")
        self._version_cv = lockwitness.condition("coord.version_cv")
        self._cv_poll_s = 0.1
        self.version = 0                       # server model version t
        self._stop = threading.Event()
        self._closed = False
        self._threads: list[threading.Thread] = []
        self.failures: dict[str, int] = {}
        self._health_lock = lockwitness.lock("coord.health_lock")
        self.prune_after = int(prune_after)
        self.prune_score = float(prune_score)
        self.probation = int(probation)
        self.prune_enabled = bool(prune_after or prune_score)
        self._pruned: dict[str, int] = {}      # device -> probation's end
        self._stale_streak: dict[str, int] = {}
        self.evict_after = config.run.evict_after
        self._fail_streak: dict[str, int] = {}
        self.evicted: list[str] = []
        self._evicted_pending: list[str] = []
        # ---- tree mode (inert in the flat mode) -------------------------
        self.tree_mode = self.num_aggregators > 0
        self.agg_interval_s = float(config.run.agg_buffer_interval_s)
        # Sticky-dead addresses: nothing is drained from a dead process
        # again; a restart announces a fresh (host, port).
        self._dead_addrs: set = set()
        self._dead_aggs: set = set()
        self._assign: dict[str, int] = {}      # device -> agg_id
        self._inflight_lock = lockwitness.lock("coord.inflight_lock")
        # dedup key -> contribution
        self._inflight: dict[str, tuple] = lockwitness.guarded(
            {}, "coord._inflight",
            self._inflight_lock)  # colearn: guarded-by(_inflight_lock)
        self._partials: queue.Queue = queue.Queue()
        self._drainers: list[threading.Thread] = []
        self._failovers_pending = 0
        self._rehomed_pending: set = set()
        self._rehomed_total = 0

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Stop the pumps and drainers (waking the parked ones first) and
        close every connection and the ledger; idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        with self._version_cv:
            # Wake the pumps parked on the version condition: shutdown
            # must not wait out their poll.
            self._version_cv.notify_all()
        for t in self._threads:
            t.join(timeout=2 * self.request_timeout)
        for t in self._drainers:
            t.join(timeout=2 * self.agg_interval_s + 2.0)
        for c in list(self._clients.values()):
            c.close()
        self._close_agg_sub()
        self._broker.close()
        if self._ckpt is not None:
            self._ckpt.close()
            self._ckpt = None
        if self.health is not None:
            with self._health_lock:
                self.health.flush()
                self.health.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def _load_params(self, tree) -> None:
        super()._load_params(tree)
        self._host_np = host_params(self.params_tree())
        self._snap_cache = None

    def _snapshot(self):
        """(version, encoded frame) under the state lock: the host copy of
        the params (``_host_np``, kept by the aggregating thread) is
        encoded once per model version and shared read-only by every pump
        (``comm.broadcast_encode_total``)."""
        with self._state_lock:
            v = self.version
            if self._snap_cache is None or self._snap_cache[0] != v:
                body = memoryview(pytree_to_bytes(self._host_np,
                                                  {"round": v}))
                telemetry.get_registry().counter(
                    "comm.broadcast_encode_total").inc()
                self._snap_cache = (v, body)
            return self._snap_cache

    def _dispatch_loop(self, dev: DeviceInfo) -> None:
        """One device's pump: train on the freshest model, queue, repeat —
        at most once per (device, model version)."""
        cli = self._clients[dev.device_id]
        last_v = -1
        reg = telemetry.get_registry()
        while not self._stop.is_set():
            self._pump_state[dev.device_id] = "wait"
            with self._version_cv:
                while self.version == last_v and not self._stop.is_set():
                    # A poll, not the wake: the aggregator notifies under
                    # the condition it holds across the version bump, and
                    # close() notifies after setting the stop event.
                    self._version_cv.wait(self._cv_poll_s)
            if self._stop.is_set():
                return
            if dev.device_id in self._pruned:
                # A paused pump idles until probation re-admits it.
                self._pump_state[dev.device_id] = "pruned"
                self._stop.wait(0.25)
                continue
            v, body = self._snapshot()
            self._pump_state[dev.device_id] = "train"
            t_req = time.perf_counter()
            try:
                with self.tracer.span("dispatch_train",
                                      device=dev.device_id,
                                      version=v) as dispatch_sp:
                    header, delta = cli.request(
                        protocol.attach_trace(
                            {"op": "train", "round": v},
                            self.tracer.current_context()),
                        body=body, timeout=self.request_timeout)
                if header.get("status") != "ok":
                    raise RuntimeError(header.get("error"))
                protocol.pop_trace_spans(header.get("meta"), self.tracer)
            except Exception:
                if self._stop.is_set():
                    return
                self._pump_state[dev.device_id] = "retry"
                self.failures[dev.device_id] = (
                    self.failures.get(dev.device_id, 0) + 1)
                reg.counter("async.dispatch_failures").inc()
                self._record_health(dev.device_id, retry=1)
                streak = self._fail_streak.get(dev.device_id, 0) + 1
                self._fail_streak[dev.device_id] = streak
                if streak >= self.evict_after:
                    self._evict(dev)
                    return
                # A fresh connection (a late reply on the old one would
                # desynchronise it), a back-off, and the SAME version again.
                try:
                    cli.close()
                    cli = TensorClient(dev.host, dev.port,
                                       timeout=protocol.CONNECT_TIMEOUT,
                                       ident=dev.device_id)
                    self._clients[dev.device_id] = cli
                except OSError:
                    reg.counter("comm.reconnect_failures_total").inc()
                self._stop.wait(0.2)
                continue
            self._fail_streak.pop(dev.device_id, None)
            lat = time.perf_counter() - t_req
            self._record_health(dev.device_id, round=v, latency_s=lat)
            if lat > 0.5 * self.request_timeout:
                # The device answered, but spent most of its budget.
                reg.counter("async.pump_stalls_total",
                            labels={"device": str(dev.device_id)}).inc()
                self._record_health(dev.device_id, pump_stall=1)
            self.arrival.observe(dev.device_id, now=time.monotonic())
            last_v = v
            if self.tree_mode:
                self._tree_submit(dev.device_id, header["meta"], delta, v)
                continue
            # With its dispatch context (lineage) and arrival time (the
            # buffer wait).
            self._results.put((dev.device_id, header["meta"], delta, v,
                               dispatch_sp.context, time.perf_counter()))

    def _record_health(self, device_id: str, **kw) -> None:
        """Ledger append shared by the pumps and the aggregator."""
        if self.health is None:
            return
        with self._health_lock:
            self.health.record(str(device_id), **kw)

    def _evict(self, dev: DeviceInfo) -> None:
        """Revoke a trainer whose pump failed ``evict_after`` dispatches in
        a row; runs on that pump, which renames itself so a re-admitted
        device gets a fresh pump under the canonical name."""
        with self._state_lock:
            self.trainers = [t for t in self.trainers
                             if t.device_id != dev.device_id]
            self.evicted.append(dev.device_id)
            self._evicted_pending.append(dev.device_id)
        cli = self._clients.pop(dev.device_id, None)
        if cli is not None:
            cli.close()
        self._fail_streak.pop(dev.device_id, None)
        self._pump_state[dev.device_id] = "evicted"
        telemetry.get_registry().counter("fed.devices_evicted_total").inc()
        self._record_health(dev.device_id, eviction=1)
        threading.current_thread().name = (
            f"dispatch-{dev.device_id}-evicted")

    def _update_pruning(self, agg_idx: int) -> None:
        """Once per aggregation: probation re-admission, then pruning by
        stale streak (``prune_after``) and by health score plus the
        latency EWMA's multiples over the fleet median (``prune_score``),
        worst first, never below ``buffer_size`` active pumps."""
        reg = telemetry.get_registry()
        for d in [d for d, until in self._pruned.items()
                  if until <= agg_idx]:
            del self._pruned[d]
            self._stale_streak.pop(d, None)
            reg.counter("async.devices_readmitted_total").inc()
        candidates: list[tuple[float, str, str]] = []
        if self.prune_after:
            for d, streak in self._stale_streak.items():
                if streak >= self.prune_after and d not in self._pruned:
                    candidates.append((float(streak), d, "stale"))
        if self.prune_score:
            with self._health_lock:
                fleet = self.health.devices()
            ewmas = [h.lat_ewma for h in fleet.values()
                     if h.lat_ewma is not None]
            median = float(np.median(ewmas)) if ewmas else 0.0
            flagged = {d for _, d, _ in candidates}
            for d, h in fleet.items():
                if d in self._pruned or d in flagged:
                    continue
                eff = h.score()
                if median > 0 and h.lat_ewma is not None:
                    eff += max(0.0, h.lat_ewma / median - 1.0)
                if eff >= self.prune_score:
                    candidates.append((eff, d, "score"))
        if not candidates:
            return
        candidates.sort(key=lambda c: (-c[0], c[1]))
        with self._state_lock:
            enrolled = {t.device_id for t in self.trainers}
        for _, d, reason in candidates:
            if d not in enrolled:
                continue
            active = len(enrolled) - len(self._pruned)
            if active - 1 < self.buffer_size:
                break
            self._pruned[d] = agg_idx + self.probation
            reg.counter("async.devices_pruned_total",
                        labels={"reason": reason}).inc()
            if self.health is not None:
                with self._health_lock:
                    self.health.record(str(d), prune=1)

    def _health_async_feed(self) -> dict:
        """Per-aggregation ledger flush and merged fleet view (the pumps
        and the collect already attributed their events)."""
        with self._health_lock:
            return self._health_flush()

    def _start_dispatchers(self) -> None:
        """A pump for every trainer that has no live one (an evicted
        device's dead pump drops out, so a re-enrolled one gets a new)."""
        self._threads = [t for t in self._threads if t.is_alive()]
        started = {t.name for t in self._threads}
        with self._state_lock:
            roster = list(self.trainers)
        for d in roster:
            name = f"dispatch-{d.device_id}"
            if name in started:
                continue
            t = threading.Thread(target=self._dispatch_loop, args=(d,),
                                 daemon=True, name=name)
            t.start()
            self._threads.append(t)

    def refresh_membership(self, poll: float = 0.1) -> list[str]:
        """Elastic late join: devices enrolled after :meth:`enroll` become
        trainers with pumps of their own, contributing from the next
        aggregation on."""
        admitted = self._admit_late_joiners(poll)
        if admitted and self._threads:
            self._start_dispatchers()
        if admitted and self.tree_mode:
            with self._agg_lock:
                self._recompute_assignment()
        return admitted

    # ---- aggregator tree (tree mode) ---------------------------------
    def enroll_aggregators(self, timeout: float = 30.0) -> list[int]:
        """Discover ``num_aggregators`` aggregators (as the synchronous
        coordinator does), assign the slices and start one drainer per
        aggregator.  Call after :meth:`enroll`."""
        ids = super().enroll_aggregators(timeout)
        with self._agg_lock:
            self._recompute_assignment()
        for aid in ids:
            t = threading.Thread(target=self._drain_loop, args=(aid,),
                                 daemon=True, name=f"agg-drain-{aid}")
            t.start()
            self._drainers.append(t)
        return ids

    def _live_agg_ids(self) -> list[int]:
        with self._agg_lock:
            return sorted(a for a in self._aggs if a not in self._dead_aggs)

    def _recompute_assignment(self) -> None:  # colearn: holds(_agg_lock)
        """Device -> aggregator over the live aggregators, ranked by the
        health ledger's scores when there is one.  Caller holds
        ``_agg_lock``."""
        live = sorted(a for a in self._aggs if a not in self._dead_aggs)
        if not live:
            self._assign = {}
            return
        with self._state_lock:
            roster = list(self.trainers)
        ids = sorted((t.device_id for t in roster), key=str)
        scores = None
        if self.health is not None:
            with self._health_lock:
                fleet = self.health.devices()
            if fleet:
                scores = {str(d): h.score() for d, h in fleet.items()}
        slices = agg_lib.assign_slices(ids, len(live), scores=scores)
        assign: dict[str, int] = {}
        reg = telemetry.get_registry()
        for aid, sl in zip(live, slices):
            for d in sl:
                assign[d] = aid
            reg.gauge("comm.agg_slice_devices",
                      labels={"agg": str(aid)}).set(float(len(sl)))
        self._assign = assign

    def _slice_size(self, aid: int) -> int:
        with self._agg_lock:
            return sum(1 for a in self._assign.values() if a == aid)

    def _note_rehome(self, dev_id: str) -> None:
        reg = telemetry.get_registry()
        reg.counter("comm.agg_failovers_total",
                    labels={"action": "rehome"}).inc()
        reg.counter("comm.agg_rehomed_total").inc()
        with self._inflight_lock:
            self._failovers_pending += 1
            self._rehomed_total += 1
            self._rehomed_pending.add(str(dev_id))
        self._record_health(dev_id, rehomed=1)

    def _agg_failure(self, aid: int) -> None:
        """One failed aggregator request: refresh the heartbeat view and
        declare the aggregator dead only once its heartbeat is older than
        ``agg_heartbeat_timeout``; then re-home what it held in flight."""
        self._refresh_aggs()
        now = time.time()
        rehome_keys: list = []
        with self._agg_lock:
            info = self._aggs.get(aid)
            if info is None or aid in self._dead_aggs:
                return
            age = now - float(info.get("ts", 0.0))
            telemetry.get_registry().gauge(
                "comm.agg_heartbeat_age_s",
                labels={"agg": str(aid)}).set(age)
            if age <= self.config.run.agg_heartbeat_timeout:
                return
            # Dead by ADDRESS: this process's buffer is gone for good.
            self._dead_aggs.add(aid)
            self._dead_addrs.add((str(info["host"]), int(info["port"])))
            telemetry.get_registry().counter(
                "comm.agg_heartbeat_expired_total").inc()
            self._recompute_assignment()
            with self._inflight_lock:
                rehome_keys = [k for k, ent in self._inflight.items()
                               if ent[4] == aid]
        # Outside the locks: each contribution still at the dead aggregator
        # goes to a live sibling under its own key.
        for key in rehome_keys:
            with self._inflight_lock:
                ent = self._inflight.get(key)
            if ent is None or ent[4] != aid:
                continue            # drained or already re-homed
            dev_id, meta, delta, v, _ = ent
            self._note_rehome(dev_id)
            self._send_contribution(key, dev_id, meta, delta, v,
                                    rehomed=True)

    def _maybe_resurrect(self, aid: int) -> bool:
        """Re-admit a dead aggregator slot once it announces from an
        address never declared dead (a restart holds an empty buffer)."""
        with self._agg_lock:
            if aid not in self._dead_aggs:
                return True
            info = self._aggs.get(aid)
            if not info:
                return False
            addr = (str(info["host"]), int(info["port"]))
            if addr in self._dead_addrs:
                return False
            self._dead_aggs.discard(aid)
            self._recompute_assignment()
            return True

    def _tree_submit(self, dev_id: str, meta: dict, delta, v: int,
                     rehomed: bool = False) -> None:
        key = f"{int(v):08d}@{dev_id}"
        with self._inflight_lock:
            self._inflight[key] = (str(dev_id), dict(meta), delta,
                                   int(v), None)
        self._send_contribution(key, dev_id, meta, delta, v,
                                rehomed=rehomed)

    def _send_contribution(self, key: str, dev_id: str, meta: dict,
                           delta, v: int, rehomed: bool = False) -> bool:
        """Stage one contribution at its assigned aggregator, else at a
        live sibling (a re-home: flagged and attributed), on a connection
        of its own; blocks, bounded by the stop event, while none is
        reachable.  The accepting aggregator is recorded on the in-flight
        entry, the buffer a later failover re-homes from."""
        home: Optional[int] = None
        home_failed = False
        while not self._stop.is_set():
            with self._agg_lock:
                assigned = self._assign.get(str(dev_id))
                live = [a for a in sorted(self._aggs)
                        if a not in self._dead_aggs]
                infos = {a: dict(self._aggs[a]) for a in live}
            if home is None:
                home = assigned
            order = ([assigned] if assigned in live else []) + [
                a for a in live if a != assigned]
            for aid in order:
                info = infos[aid]
                fallback = home_failed and aid != home
                cli = None
                try:
                    cli = TensorClient(info["host"], int(info["port"]),
                                       timeout=protocol.CONNECT_TIMEOUT,
                                       ident=str(dev_id))
                    hdr, _ = cli.request(
                        {"op": "abuf", "key": key, "device": str(dev_id),
                         "version": int(v),
                         "rehomed": bool(rehomed or fallback),
                         "meta": dict(meta)},
                        delta, timeout=self.request_timeout)
                    if hdr.get("status") != "ok":
                        raise RuntimeError(hdr.get("error"))
                    with self._inflight_lock:
                        if key in self._inflight:
                            ent = self._inflight[key]
                            self._inflight[key] = ent[:4] + (aid,)
                    if fallback and not rehomed:
                        # The pump's own failover (the explicit re-home
                        # attributed before calling).
                        self._note_rehome(dev_id)
                    return True
                except Exception:
                    if self._stop.is_set():
                        return False
                    if aid == home:
                        home_failed = True
                    self._agg_failure(aid)
                    continue
                finally:
                    if cli is not None:
                        cli.close()
            self._stop.wait(0.2)    # nobody live: wait for a restart
        return False

    def _drain_loop(self, aid: int) -> None:
        """One aggregator's drainer: ``aprep`` once per connection, then
        long-poll ``adrain``.  A drained partial's keys leave
        ``_inflight`` on receipt, so a later death cannot re-home them."""
        cli: Optional[TensorClient] = None
        poll = max(self.agg_interval_s, 0.5)
        while not self._stop.is_set():
            if not self._maybe_resurrect(aid):
                self._refresh_aggs()
                if cli is not None:
                    cli.close()
                    cli = None
                self._stop.wait(0.25)
                continue
            with self._agg_lock:
                info = dict(self._aggs.get(aid) or {})
            if not info:
                self._refresh_aggs()
                self._stop.wait(0.25)
                continue
            if cli is None:
                try:
                    cli = TensorClient(info["host"], int(info["port"]),
                                       timeout=protocol.CONNECT_TIMEOUT,
                                       ident=f"agg:{aid}")
                    hdr, _ = cli.request({"op": "aprep", "meta": {}},
                                         self._shapes_np,
                                         timeout=self.request_timeout)
                    if hdr.get("status") != "ok":
                        raise RuntimeError(hdr.get("error"))
                except Exception:
                    if self._stop.is_set():
                        return
                    if cli is not None:
                        cli.close()
                        cli = None
                    self._agg_failure(aid)
                    self._stop.wait(0.25)
                    continue
            try:
                hdr, tree = cli.request(
                    {"op": "adrain", "interval_s": self.agg_interval_s,
                     "timeout": poll,
                     "slice_devices": self._slice_size(aid)},
                    timeout=poll + self.request_timeout)
                if hdr.get("status") != "ok":
                    raise RuntimeError(hdr.get("error"))
                meta = hdr.get("meta") or {}
                if not int(meta.get("count", 0)):
                    continue                      # idle poll
                with self._inflight_lock:
                    for k in meta.get("keys", []):
                        self._inflight.pop(k, None)
                self._partials.put((meta, tree, time.perf_counter()))
            except Exception:
                if self._stop.is_set():
                    return
                cli.close()
                cli = None
                self._agg_failure(aid)
                self._stop.wait(0.1)

    # ------------------------------------------------------------------
    def _auto_resize(self, reg) -> None:
        """Auto-K: a fold about every ``auto_interval_s`` at the observed
        fleet rate (scaled by the fold fraction), clamped to [1, trainers]
        and slew-limited to [K/2, 3K/2]."""
        seen = self._folded_total + self._discarded_total
        fold_frac = self._folded_total / seen if seen else 1.0
        k = self.arrival.recommend_buffer(
            self.auto_interval_s * max(fold_frac, 0.05), lo=1,
            hi=max(1, len(self.trainers)), current=self.buffer_size)
        k = max(max(1, self.buffer_size // 2),
                min(k, max(2, self.buffer_size * 3 // 2)))
        if k != self.buffer_size:
            reg.counter("async.buffer_resizes_total").inc()
            self.buffer_size = k

    def _quorum(self) -> int:
        return (max(1, math.ceil(self.min_cohort_fraction
                                 * len(self.trainers)))
                if self.min_cohort_fraction > 0 else 0)

    def _apply(self, mean_delta) -> None:
        """The server step, the pumps' host copy of the params and the
        version bump, under both locks: the state lock keeps (params,
        version) consistent for ``_snapshot``, and holding the condition
        across bump and notify leaves no lost wake-up."""
        with self._state_lock:
            if mean_delta is not None:
                self._server_step(mean_delta)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self._host_np = host_params(self.params_tree())
            with self._version_cv:
                self.version += 1
                self._version_cv.notify_all()

    def run_aggregation(self) -> dict:
        """Block until ``buffer_size`` fresh-enough updates arrived, then
        apply their staleness-weighted mean as one server step.  Raises
        ``RuntimeError`` (with the per-device failure counts) when nothing
        arrives for ``2 × request_timeout``."""
        reg = telemetry.get_registry()
        if self.tree_mode:
            return self._run_tree_aggregation()
        if self.auto_buffer:
            self._auto_resize(reg)
        if self.buffer_size > len(self.trainers):
            raise ValueError(
                f"buffer_size {self.buffer_size} exceeds the "
                f"{len(self.trainers)} enrolled trainers: each device "
                "contributes at most one update per model version, so the "
                "buffer could never fill"
            )
        self._start_dispatchers()
        reg.gauge("async.buffer_target").set(float(self.buffer_size))
        t0 = time.perf_counter()
        # Arrival-indexed staging keys: a device may land updates of two
        # versions in one buffer, and the sorted finalize is arrival order.
        folder = StreamingFolder(self._shapes_np,
                                 placement=self._fold_placement,
                                 device_fold=self._fold_device,
                                 device=self.device)
        staleness: list[int] = []
        contributors: list[str] = []
        weights: list[float] = []
        discarded = 0
        mass_folded = 0.0
        mass_discarded = 0.0
        fold_span_ids: list[str] = []
        stall_deadline = t0 + 2.0 * self.request_timeout
        with self.tracer.span("async.aggregate", version=self.version,
                              buffer_size=self.buffer_size) as agg_sp:
            with self.tracer.span(
                    "collect_updates",
                    buffer_size=self.buffer_size) as collect_sp:
                while len(staleness) < self.buffer_size:
                    try:
                        dev_id, meta, delta, v, dctx, t_arr = (
                            self._results.get(timeout=max(
                                0.1,
                                stall_deadline - time.perf_counter())))
                    except queue.Empty:
                        raise RuntimeError(
                            f"no update arrived within "
                            f"{2 * self.request_timeout:.0f}s "
                            f"({len(staleness)}/{self.buffer_size} "
                            f"buffered); "
                            f"device failures: {dict(self.failures)}"
                        ) from None
                    stall_deadline = (time.perf_counter()
                                      + 2.0 * self.request_timeout)
                    tau = self.version - v
                    stale_w = (1.0 + tau) ** (-self.staleness_exponent)
                    wait_s = time.perf_counter() - t_arr
                    if tau > self.max_staleness:
                        discarded += 1
                        self._discarded_total += 1
                        mass_discarded += stale_w
                        reg.counter("async.updates_discarded_stale",
                                    labels={"device": str(dev_id)}).inc()
                        reg.counter(
                            "async.contribution_mass",
                            labels={"outcome": "discarded"}).inc(stale_w)
                        reg.histogram(
                            "async.staleness",
                            labels={"outcome": "discarded"}).observe(
                                float(tau))
                        with self.tracer.span(
                                "fold_update", parent=dctx,
                                device=str(dev_id), tau=tau, version=v,
                                applied_version=self.version,
                                outcome="discarded",
                                buffer_wait_s=wait_s,
                                link_agg=agg_sp.span_id):
                            pass
                        self._stale_streak[dev_id] = (
                            self._stale_streak.get(dev_id, 0) + 1)
                        self._record_health(dev_id, round=self.version,
                                            deadline_miss=1)
                        continue
                    self._stale_streak.pop(dev_id, None)
                    w = float(meta.get("weight", 1.0)) * stale_w
                    fmeta = dict(meta)
                    fmeta["client_id"] = f"{len(staleness):08d}@{dev_id}"
                    with self.tracer.span(
                            "fold_update", parent=dctx,
                            device=str(dev_id), tau=tau, version=v,
                            applied_version=self.version,
                            outcome="folded", buffer_wait_s=wait_s,
                            link_agg=agg_sp.span_id) as fold_sp:
                        folder.add(fmeta, delta, weight=w)
                    fold_span_ids.append(fold_sp.span_id)
                    self._folded_total += 1
                    mass_folded += stale_w
                    reg.counter("async.contribution_mass",
                                labels={"outcome": "folded"}).inc(stale_w)
                    reg.histogram(
                        "async.staleness",
                        labels={"outcome": "folded"}).observe(float(tau))
                    staleness.append(tau)
                    contributors.append(dev_id)
                    weights.append(w)
                    reg.gauge("async.buffer_occupancy").set(
                        float(len(staleness)))

            with self.tracer.span("apply_update",
                                  version=self.version) as apply_sp:
                mean_delta, total_w, mean_loss = folder.mean()
                # A sub-quorum buffer is discarded, but the version still
                # advances, or every pump would wait forever.
                quorum = self._quorum()
                skipped_quorum = (bool(quorum)
                                  and len(set(contributors)) < quorum)
                if skipped_quorum:
                    reg.counter("fed.rounds_skipped_quorum").inc()
                    mean_delta = None
                    mean_loss = float("nan")
                self._apply(mean_delta)
                conv_sig = self._observe_learning(mean_delta, apply_sp)
            agg_sp.attrs["folded"] = len(staleness)
            agg_sp.attrs["discarded"] = discarded
            agg_sp.attrs["link_folds"] = fold_span_ids
        reg.gauge("async.buffer_occupancy").set(0.0)
        reg.gauge("async.pending_updates").set(float(self._results.qsize()))
        rec = {
            "buffer_size": self.buffer_size,
            "staleness_mean": float(np.mean(staleness)),
            "staleness_max": int(np.max(staleness)),
            "discarded": discarded,
            "contributors": contributors,
            "train_loss": mean_loss,
            "total_weight": total_w,
            "agg_time_s": time.perf_counter() - t0,
            "phase_collect_s": collect_sp.duration_s,
            "phase_apply_s": apply_sp.duration_s,
        }
        return self._finish_record(reg, rec, quorum, skipped_quorum,
                                   mass_folded, mass_discarded, mean_delta,
                                   weights, contributors, conv_sig=conv_sig)

    def _finish_record(self, reg, rec: dict, quorum: int,
                       skipped_quorum: bool, mass_folded: float,
                       mass_discarded: float, mean_delta, weights,
                       contributors, tree_keys: Optional[dict] = None,
                       conv_sig: Optional[dict] = None) -> dict:
        """The gauges, pruning, accounting and the record's keys after the
        core ones, in JAX's order and under JAX's conditions; appends the
        record to the history."""
        self._export_pump_gauges(reg)
        self.arrival.export_gauges(reg, "async.arrival_rate_per_s")
        agg_idx = len(self.history)
        reg.counter("async.aggregations_total").inc()
        if self.prune_enabled:
            self._update_pruning(agg_idx)
        rec = {"aggregation": agg_idx, "model_version": self.version,
               **rec, **(tree_keys or {})}
        if self.observe_records:
            rec["mass_folded"] = round(mass_folded, 6)
            rec["mass_discarded"] = round(mass_discarded, 6)
            rec["arrival_rate_per_s"] = round(self.arrival.rate(), 6)
            hs = reg.histogram("async.staleness",
                               labels={"outcome": "folded"}).summary()
            if hs.get("count"):
                rec["staleness_p50"] = hs["p50"]
                rec["staleness_p90"] = hs["p90"]
                rec["staleness_p99"] = hs["p99"]
        if quorum:
            rec["skipped_quorum"] = skipped_quorum
        if self.prune_enabled:
            rec["pruned"] = sorted(self._pruned)
        with self._state_lock:
            if self._evicted_pending:
                rec["evicted"] = self._evicted_pending
                self._evicted_pending = []
        reg.histogram("async.agg_time_s").observe(rec["agg_time_s"])
        if self.accountant is not None and mean_delta is not None:
            rec["dp_z_eff"] = self._charge_privacy(weights, contributors)
            rec["dp_epsilon"] = self.accountant.epsilon()
        if self.health is not None:
            rec.update(telemetry.health_record_keys(
                self._health_async_feed()))
        if conv_sig:
            # The conv_* keys only under learn_observe.
            rec.update(conv_sig)
        self.history.append(rec)
        return rec

    def _run_tree_aggregation(self) -> dict:
        """Tree mode: apply ONE partial fold from the aggregator tier as
        one server step.  Staleness is resolved here against the partial's
        oldest constituent version (τ = version − oldest): the whole
        partial is scaled by ``(1+τ)^-staleness_exponent`` in f32 on the
        host, or discarded with per-device attribution past
        ``max_staleness``."""
        reg = telemetry.get_registry()
        self._start_dispatchers()
        t0 = time.perf_counter()
        folder = StreamingFolder(self._shapes_np,
                                 placement=self._fold_placement,
                                 device_fold=self._fold_device,
                                 device=self.device)
        discarded = 0
        mass_folded = 0.0
        mass_discarded = 0.0
        with self.tracer.span("async.aggregate", version=self.version,
                              tree=True) as agg_sp:
            with self.tracer.span("collect_updates") as collect_sp:
                stall_deadline = (time.perf_counter()
                                  + 2.0 * self.request_timeout)
                while True:
                    try:
                        meta, tree, _t_arr = self._partials.get(
                            timeout=max(0.1, stall_deadline
                                        - time.perf_counter()))
                    except queue.Empty:
                        raise RuntimeError(
                            f"no partial fold arrived within "
                            f"{2 * self.request_timeout:.0f}s; device "
                            f"failures: {dict(self.failures)}") from None
                    stall_deadline = (time.perf_counter()
                                      + 2.0 * self.request_timeout)
                    tau = max(0, self.version
                              - int(meta["oldest_version"]))
                    stale_w = (1.0 + tau) ** (-self.staleness_exponent)
                    n = int(meta["count"])
                    if tau > self.max_staleness:
                        discarded += n
                        self._discarded_total += n
                        mass_discarded += stale_w * n
                        reg.counter(
                            "async.partials_discarded_stale").inc()
                        reg.counter(
                            "async.contribution_mass",
                            labels={"outcome": "discarded"}).inc(
                                stale_w * n)
                        reg.histogram(
                            "async.staleness",
                            labels={"outcome": "discarded"}).observe(
                                float(tau))
                        for d in meta["devices"]:
                            reg.counter(
                                "async.updates_discarded_stale",
                                labels={"device": str(d)}).inc()
                            self._stale_streak[str(d)] = (
                                self._stale_streak.get(str(d), 0) + 1)
                            self._record_health(str(d),
                                                round=self.version,
                                                deadline_miss=1)
                        continue
                    break
                contributors = [str(d) for d in meta["devices"]]
                staleness = [max(0, self.version - int(pv))
                             for pv in meta["versions"]]
                weights = [float(w) * stale_w for w in meta["weights"]]
                for d in contributors:
                    self._stale_streak.pop(d, None)
                scaled = None
                if tree is not None:
                    # JAX's tree_scale: an f32 leaf times a Python float
                    # stays f32.
                    scaled = trees.map_leaves(
                        lambda x: np.asarray(x) * stale_w, tree)
                folder.add_partial(f"agg:{meta['agg_id']}",
                                   float(meta["total_w"]) * stale_w,
                                   scaled,
                                   float(meta["loss_sum"]) * stale_w,
                                   count=n)
                self._folded_total += n
                mass_folded += stale_w * n
                reg.counter("async.partials_folded_total",
                            labels={"agg": str(meta["agg_id"])}).inc()
                reg.counter("comm.agg_partials_folded_total",
                            labels={"agg": str(meta["agg_id"])}).inc()
                reg.counter("async.contribution_mass",
                            labels={"outcome": "folded"}).inc(stale_w * n)
                for t_i in staleness:
                    reg.histogram(
                        "async.staleness",
                        labels={"outcome": "folded"}).observe(float(t_i))

            with self.tracer.span("apply_update",
                                  version=self.version) as apply_sp:
                mean_delta, total_w, mean_loss = folder.mean()
                quorum = self._quorum()
                skipped_quorum = (bool(quorum)
                                  and len(set(contributors)) < quorum)
                if skipped_quorum:
                    reg.counter("fed.rounds_skipped_quorum").inc()
                    mean_delta = None
                    mean_loss = float("nan")
                self._apply(mean_delta)
                conv_sig = self._observe_learning(mean_delta, None)
            agg_sp.attrs["folded"] = len(contributors)
            agg_sp.attrs["discarded"] = discarded
            agg_sp.attrs["agg_id"] = int(meta["agg_id"])
        reg.gauge("async.pending_updates").set(
            float(self._partials.qsize()))
        with self._inflight_lock:
            failovers = self._failovers_pending
            self._failovers_pending = 0
            rehomed = sorted(self._rehomed_pending)
            self._rehomed_pending = set()
            rehomed_total = self._rehomed_total
        rec = {
            "buffer_size": int(meta["buffer_k"]),
            "staleness_mean": float(np.mean(staleness)),
            "staleness_max": int(np.max(staleness)),
            "discarded": discarded,
            "contributors": contributors,
            "train_loss": mean_loss,
            "total_weight": total_w,
            "agg_time_s": time.perf_counter() - t0,
            "phase_collect_s": collect_sp.duration_s,
            "phase_apply_s": apply_sp.duration_s,
        }
        # The tree's keys (present only in tree mode).
        tree_keys = {
            "agg_id": int(meta["agg_id"]),
            "agg_buffer_k": int(meta["buffer_k"]),
            "agg_buffer_rate_per_s": round(
                float(meta["arrival_rate_per_s"]), 6),
            "oldest_version": int(meta["oldest_version"]),
            "folded_keys": [str(k) for k in meta["keys"]],
            "agg_failovers": failovers,
            "rehomed_devices": rehomed,
            "rehomed_total": rehomed_total,
        }
        return self._finish_record(reg, rec, quorum, skipped_quorum,
                                   mass_folded, mass_discarded, mean_delta,
                                   weights, contributors, tree_keys,
                                   conv_sig)

    def _export_pump_gauges(self, reg) -> None:
        """``async.pumps{state=...}``: every state each aggregation, zeros
        included."""
        states: dict[str, int] = {}
        for st in list(self._pump_state.values()):
            states[st] = states.get(st, 0) + 1
        for st in PUMP_STATES:
            reg.gauge("async.pumps", labels={"state": st}).set(
                float(states.get(st, 0)))

    def _charge_privacy(self, weights: list[float],
                        contributors: list[str]) -> float:
        """Charge one applied aggregation to the RDP accountant; returns
        its effective multiplier ``(σ/√B_cfg) · √(Σ wᵢ²) / max_dev(Σ w)``
        (a device's influence is the sum of its weights: it may land two
        versions in one buffer)."""
        c = self.config.fed
        b_cfg = setup_lib.dp_effective_cohort(self.config)
        per_dev: dict[str, float] = {}
        for w, d in zip(weights, contributors):
            per_dev[d] = per_dev.get(d, 0.0) + w
        warr = np.asarray(weights, np.float64)
        z_eff = (c.dp_noise_multiplier / math.sqrt(b_cfg)
                 * math.sqrt(float(np.sum(warr * warr)))
                 / max(per_dev.values()))
        self.accountant.step(1, sampling_rate=1.0, noise_multiplier=z_eff)
        return float(z_eff)

    def evaluate(self) -> dict:
        """Score the global model on the evaluator device."""
        return self._ask_evaluator(self.request_timeout)

    # ---- checkpoint/resume (ckpt/) ----------------------------------------
    def save_checkpoint(self) -> None:
        """Save ``(server_state,)`` and the history at step ``version``."""
        self._checkpointer().save(
            self.version, (self._checkpoint_server_state(),), self.history)

    def restore_checkpoint(self) -> int:
        """Restore the latest checkpoint; returns the resumed model
        version.  Call it before ``enroll`` and ``fit``: the pumps
        snapshot the restored state on their first cycle."""
        template = self._checkpoint_server_state()
        state, history, step = self._checkpointer().restore((template,))
        with self._state_lock:
            self._restore_server_state(template, state[0])
            self._host_np = host_params(self.params_tree())
            self.history = history
            self.version = step
            self._snap_cache = None
        if self.accountant is not None:
            # The mechanism varies per aggregation (z_eff follows the
            # buffer's staleness weights), so the budget is rebuilt by
            # replaying each record's charge; the reset first makes a
            # repeated restore charge nothing twice.
            self.accountant.steps = 0
            for rec in history:
                if "dp_z_eff" in rec:
                    self.accountant.step(1, sampling_rate=1.0,
                                         noise_multiplier=rec["dp_z_eff"])
        telemetry.get_registry().counter("fed.rounds_resumed_total").inc()
        return step

    def fit(self, aggregations: int, log_fn=None,
            eval_every: Optional[int] = None,
            elastic: bool = False) -> list[dict]:
        """Run ``aggregations`` aggregations, scoring the evaluator every
        ``eval_every`` (cumulative index) and on the last; ``elastic``
        admits late joiners before each.  With ``run.checkpoint_dir`` the
        state is saved after the record is logged, every
        ``run.checkpoint_every`` aggregations and after the last."""
        eval_every = eval_every or self.config.run.eval_every
        run = self.config.run
        ckpt_every = max(0, run.checkpoint_every)
        want_ckpt = bool(run.checkpoint_dir)
        last = len(self.history) + aggregations - 1
        for _ in range(aggregations):
            if elastic:
                self.refresh_membership()
            rec = self.run_aggregation()
            if self.evaluator is not None and (
                    rec["aggregation"] % max(1, eval_every) == 0
                    or rec["aggregation"] == last):
                rec.update(self.evaluate())
            if log_fn is not None:
                log_fn(rec)
            if want_ckpt and (
                    (ckpt_every
                     and (rec["aggregation"] + 1) % ckpt_every == 0)
                    or rec["aggregation"] == last):
                self.save_checkpoint()
        return self.history
