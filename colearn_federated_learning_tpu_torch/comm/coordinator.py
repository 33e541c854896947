"""Federated coordinator over the socket planes: the synchronous path of
the JAX package's ``comm/coordinator.py``.

It enrolls devices on the broker, assigns trainer and evaluator roles,
then per round: samples a cohort, broadcasts the global params once
serialized, fans the train requests out on a thread per device against
one deadline (a device that fails or is too slow is dropped from the
round), folds the updates as they arrive in cohort order
(``StreamingFolder``, on the card with ``run.fold_device``), removes
secure aggregation's masks (DH share recovery or the shared seed),
applies the server strategy on the coordinator's device, charges the DP
accountant at the realized noise, and scores the evaluator.  Devices that
fail ``evict_after`` rounds in a row are evicted; ``fit(elastic=True)``
admits late joiners.  Round records carry the JAX package's keys under
the same conditions; the ``phase_*_s`` values come from the port's own
clock around the same phases.

With ``run.num_aggregators`` > 0 the train fan-out goes through the
aggregator tree (``comm/aggregator.py``): one fold request per cohort
slice, a dead aggregator's slice re-homed to a live sibling or dropped,
secure aggregation's masks paired and recovered per slice, and the root
folding one partial per slice.  ``device_type`` restricts enrollment to
one MUD device type (``comm/per_type.py`` runs one coordinator per type).

The server state lives on the coordinator's device (the card unless the
caller passes ``device="cpu"``), in the flax layout the wire carries.
With ``run.tp_size`` > 1 it is sharded over a 1-D ``(run.tp_axis,)``
placement (``parallel.partition.ServerPlacement``: the distinct cards, or
on the CPU the host positions ``XLA_FLAGS`` forces): a flat dict with one
tensor per (leaf, shard), each on its position's device, which the
server step runs over unchanged; the fold stages per shard, the downlink
and the checkpoints read per shard, and ``comm.gather_bytes_avoided_total``
counts what a replicated layout would have gathered.  A host that cannot
honour ``tp_size``, or a model the rules shard nothing of, runs
replicated and counts ``fed.mesh_fallback_total{reason}``, as JAX does.
Under LoRA the factors and their folds stay replicated; the merge runs
shard-wise on the sharded base.
:class:`CoordinatorCore` holds what this coordinator shares with the
asynchronous one (``comm/async_coordinator.py``): the device, the control
plane, the aggregator tier's discovery, the server state, the ledger's
flush and the evaluator.

Telemetry is JAX's: the coordinator's tracer is always on; a round runs
under a ``round`` span with ``share_setup``, ``serialize_params``,
``broadcast_collect``, ``aggregate`` and ``unmask`` inside it (and
``evaluate`` for the evaluator), every request carries the span context
of the phase that sends it, and the spans the workers and aggregators
ship back are adopted, so one trace covers the federation.  The
``fed.*``, ``comm.*`` and ``privacy.*`` instruments count at JAX's sites.
With ``run.health_dir`` a :class:`telemetry.HealthLedger` records each
device's latency (its own ``worker.train`` span), deadline misses,
secure-aggregation dropouts, evictions and retries, the records gain the
``health_*`` keys, and the tree ranks its slices by the ledger's scores
(``aggregator.assign_slices``).

With ``fed.lora_rank`` > 0 (``fed/lora.py``) the server keeps the frozen
base and a small factor tree on its device: rounds broadcast one
``{"base", "factors"}`` composite with the ``lora`` meta marker, fold the
workers' factor deltas (flat or through the tree), step the factors, and
every ``lora_merge_every`` aggregations merge B·A·(α/r) into the base and
zero B.  The evaluator scores a temporary merge.

With ``run.checkpoint_dir`` (``ckpt/``) each round is logged first in
the round WAL (``round``, ``accepted``, ``completed``, ``total_weight``)
and its state saved second, before the record is logged, every
``run.checkpoint_every`` rounds and after the last; ``run.ckpt_stream``
picks the streaming checkpointer.  The state saved is ``(server_state,
acct_rdp)``.  ``restore_checkpoint`` (a ``resume`` span) restores it,
the accountant's RDP vector and steps, and rewinds the WAL past the
restored step.  Every admission goes to the durable enrollment ledger,
and after a resume :meth:`FederatedCoordinator.verify_resumed_devices`
readmits only the devices the previous incarnation's ledger knows that
answer a nonce challenge under their recorded key.  As in JAX, the
asynchronous coordinator shares the checkpointer but keeps no ledger and
runs no challenge.

With ``run.learn_observe`` both coordinators keep JAX's convergence
observatory (``telemetry/convergence.py``): after the fold and the server
step it observes the round's mean update (the factor tree under LoRA, the
placed mean under a placement; a no-op round observes nothing), puts
``conv_update_norm``, ``conv_trend`` and ``conv_cos_prev`` on the
``aggregate`` span, exports the ``learn.*`` metrics and stamps the
``conv_*`` keys on the record.  Without it the records keep their keys.
"""

from __future__ import annotations

import concurrent.futures as cf
import hashlib
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from colearn_federated_learning_tpu_torch import telemetry
from colearn_federated_learning_tpu_torch.comm import aggregator as agg_lib
from colearn_federated_learning_tpu_torch.comm import enrollment, keyexchange
from colearn_federated_learning_tpu_torch.comm import protocol
from colearn_federated_learning_tpu_torch.comm.aggregation import (
    StreamingFolder)
from colearn_federated_learning_tpu_torch.comm.broker import BrokerClient
from colearn_federated_learning_tpu_torch.comm.downlink import (
    DownlinkEncoder, host_params)
from colearn_federated_learning_tpu_torch.comm.enrollment import (
    DeviceInfo, EnrollmentManager)
from colearn_federated_learning_tpu_torch.comm.transport import (
    RetryPolicy, TensorClient)
from colearn_federated_learning_tpu_torch.faults import lockwitness
from colearn_federated_learning_tpu_torch.fed import compression, evaluation
from colearn_federated_learning_tpu_torch.fed import lora as lora_lib
from colearn_federated_learning_tpu_torch.fed import programs, strategies
from colearn_federated_learning_tpu_torch.fed import setup as setup_lib
from colearn_federated_learning_tpu_torch.parallel import partition
from colearn_federated_learning_tpu_torch.privacy import dropout
from colearn_federated_learning_tpu_torch.privacy import secure_agg as sa
from colearn_federated_learning_tpu_torch.privacy.accountant import (
    RdpAccountant)
from colearn_federated_learning_tpu_torch.telemetry import health as _hl
from colearn_federated_learning_tpu_torch.utils import trees
from colearn_federated_learning_tpu_torch.utils.config import (
    ExperimentConfig, validate_robustness)
from colearn_federated_learning_tpu_torch.utils.device import resolve_device
from colearn_federated_learning_tpu_torch.utils.serialization import (
    pytree_to_bytes, wire_frame_length)

# A masker too slow to distribute its recovery shares within this fraction
# of the round budget is pruned before it masks.
SHARE_TIMEOUT_FRACTION = 0.25


# How long _refresh_aggs may read the aggregators' announce topic: the
# backlog of heartbeats is read in windows until one comes back empty.
REFRESH_BUDGET_S = 1.0


def _shape_views(tree):
    """Zero-stride f32 views shaped as ``tree``'s leaves (no memory)."""
    return trees.map_leaves(
        lambda a: np.broadcast_to(np.float32(0), np.shape(a)), tree)


class CoordinatorCore:
    """What the synchronous and the asynchronous coordinators share
    (``FederatedCoordinator`` here, ``comm/async_coordinator.py``'s
    ``AsyncFederatedCoordinator``): the coordinator's device and the
    server placement, the control plane (enrollment, late joiners, the
    broker's rebuild), the aggregator tier's discovery, the server state
    in the flax layout on that device (or sharded over the placement),
    the tracer, the health ledger's flush and the evaluator."""

    def _observe_learning(self, mean_delta, span) -> Optional[dict]:
        """The round's (or aggregation's) learning signals under
        ``run.learn_observe``: observe the mean update, put the span's
        ``conv_*`` attributes (with a span; the asynchronous tree's
        aggregation puts none, as JAX's) and export ``learn.*``.  None
        when off, or for a no-op (``mean_delta`` None), which leaves the
        trend state untouched."""
        if self._learn is None:
            return None
        sig = self._learn.observe(mean_delta, lr=self.config.fed.server_lr)
        if sig and span is not None:
            span.attrs["conv_update_norm"] = sig["conv_update_norm"]
            span.attrs["conv_trend"] = sig["conv_trend"]
            if "conv_cos_prev" in sig:
                span.attrs["conv_cos_prev"] = sig["conv_cos_prev"]
        if sig:
            self._learn.export_metrics(telemetry.get_registry(), sig)
        return sig

    def _init_core(self, config: ExperimentConfig, broker_host: str,
                   broker_port: int, want_evaluator: bool, mud_policy,
                   device_type: Optional[str], device, process: str) -> None:
        """Everything but the validation, which each coordinator runs
        first.  ``process`` names the tracer's process and the ledger's
        file (``health_<process>.jsonl``)."""
        self.config = config
        self.device = resolve_device(device)
        self.want_evaluator = want_evaluator
        # The coordinator's spans live here, and the workers' spans are
        # adopted from their replies, so one trace covers the federation;
        # the CLI writes it to run.trace_dir after fit.
        self.tracer = telemetry.Tracer(process=process)
        # The per-device health ledger, only with run.health_dir: the
        # default path writes nothing and its records keep their keys.
        self.health = None
        self._health_retry_seen: dict[str, float] = {}
        if config.run.health_dir:
            self.health = telemetry.HealthLedger(config.run.health_dir,
                                                 process)
        # The convergence observatory, only with run.learn_observe: it
        # needs the aggregate alone (under secure aggregation the server
        # never opens an individual update).
        self._learn = (telemetry.ConvergenceObservatory()
                       if config.run.learn_observe else None)
        self._broker_addr = (broker_host, broker_port)
        self._mud_policy = mud_policy
        self._device_type = device_type
        self._broker = BrokerClient(broker_host, broker_port,
                                    timeout=protocol.CONNECT_TIMEOUT)
        self._enroll = EnrollmentManager(self._broker, mud_policy=mud_policy,
                                         device_type=device_type)
        # The aggregator tier (comm/aggregator.py), found from its retained
        # announcements: agg_id -> host/port/ts.
        self.num_aggregators = int(config.run.num_aggregators)
        self._agg_lock = lockwitness.lock("coord.agg_lock")
        self._aggs: dict[int, dict] = lockwitness.guarded(
            {}, "coord._aggs", self._agg_lock)  # colearn: guarded-by(_agg_lock)
        # Serializes _refresh_aggs's broker reads (try-acquired only).
        self._agg_refreshing = lockwitness.lock("coord.agg_refreshing")
        self._agg_sub: Optional[BrokerClient] = None
        params = setup_lib.init_global_params(config, self.device)
        self._shapes_np = _shape_views(params)
        self._fold_device = bool(config.run.fold_device)
        # The sharded server, or None (replicated; the fallback counted).
        self._placement = partition.make_server_placement(
            params, config.run.tp_size, config.run.tp_axis,
            config.model.name, device=self.device)
        # The folds stage per shard, but under LoRA they fold the factors,
        # which stay replicated; only the base is sharded.
        self._fold_placement = (None if config.fed.lora_rank > 0
                                else self._placement)
        # The replicated state's keys (a placement keys its own).
        self._names = [str(i) for i in range(len(trees.leaves(params)))]
        self._load_params(params)
        if self._placement is not None:
            telemetry.get_registry().gauge("comm.server_bytes_per_chip").set(
                partition.bytes_per_chip(self._checkpoint_server_state()))
        self.history: list[dict] = []
        self._clients: dict[str, TensorClient] = {}
        self.trainers: list[DeviceInfo] = []
        self.evaluator: Optional[DeviceInfo] = None
        # Charged at the realized noise of what each step released.
        self.accountant = RdpAccountant.from_config(config.fed,
                                                    sampling_rate=1.0)
        self._ckpt = None

    # ---- checkpoint/resume (ckpt/): the round checkpointer, or the
    # streaming one with run.ckpt_stream ------------------------------------
    def _checkpointer(self):
        if self._ckpt is None:
            from colearn_federated_learning_tpu_torch.ckpt import (
                RoundCheckpointer, StreamingCheckpointer)

            cls = (StreamingCheckpointer if self.config.run.ckpt_stream
                   else RoundCheckpointer)
            self._ckpt = cls.for_run(self.config.run)
        return self._ckpt

    def _checkpoint_server_state(self) -> strategies.ServerState:
        """The server state in the JAX coordinator's layout, as views of
        the live tensors: flax-layout trees (of sharded leaves under a
        placement), ``round_idx`` an int32 ``()`` array."""
        s = self.server_state

        def tree(d):
            return None if d is None else self._tree_of(d)

        return strategies.ServerState(
            params=tree(s.params), opt_m=tree(s.opt_m), opt_v=tree(s.opt_v),
            control=tree(s.control),
            round_idx=np.asarray(s.round_idx, np.int32))

    def _restore_server_state(self, template, restored) -> None:
        """Copy a restored server state into the live tensors (re-cut onto
        this coordinator's placement by the restore)."""
        from colearn_federated_learning_tpu_torch.ckpt import streaming

        streaming.copy_leaves(template, restored)
        self.server_state.round_idx = int(restored.round_idx)

    def _state_dict(self, tree) -> dict:
        """A flax-layout tree (host arrays, tensors, or sharded leaves) as
        the server state's flat dict: one tensor per leaf on the
        coordinator's device, or under a placement one per (leaf, shard)
        on its position's device."""
        if self._placement is not None:
            return self._placement.flatten(tree)
        return {n: (l if isinstance(l, torch.Tensor)
                    else torch.from_numpy(np.asarray(l))).to(self.device)
                for n, l in zip(self._names, trees.leaves(tree))}

    def _tree_of(self, flat: dict) -> dict:
        """The server state's flat dict as a flax-layout tree of views."""
        if self._placement is not None:
            return self._placement.unflatten(flat)
        return trees.unflatten(self._shapes_np,
                               [flat[n] for n in self._names])

    def _load_params(self, tree) -> None:
        """Start the server state from a flax-layout params tree."""
        self.server_state = strategies.init_server_state(
            self._state_dict(trees.map_leaves(
                lambda l: np.array(l, np.float32), tree)), self.config.fed)

    def params_tree(self) -> dict:
        """The global params as a flax-layout tree of tensors on the
        coordinator's device (of sharded leaves under a placement)."""
        return self._tree_of(self.server_state.params)

    def _eval_params(self) -> dict:
        """The params the evaluator scores (flax layout, on the device)."""
        return self.params_tree()

    def _server_step(self, mean_delta) -> None:
        """Apply the server strategy to a flax-layout mean delta (host
        arrays, or the placed tree a sharded fold assembles) on the
        server's devices: elementwise, so shard by shard it is bitwise
        the replicated step."""
        self.server_state = strategies.server_update(
            self.server_state, self._state_dict(mean_delta), self.config.fed)

    def enroll(self, min_devices: int, timeout: float = 30.0) -> None:
        """Wait for devices, assign roles, open tensor connections."""
        self._enroll.wait_for(min_devices, timeout)
        self.trainers, self.evaluator = self._enroll.assign_roles(
            want_evaluator=self.want_evaluator)
        for d in self.trainers + ([self.evaluator] if self.evaluator else []):
            self._clients[d.device_id] = TensorClient(
                d.host, d.port, timeout=protocol.CONNECT_TIMEOUT,
                ident=d.device_id)

    def _admit_late_joiners(self, poll: float) -> list[str]:
        """Admit devices that enrolled after :meth:`enroll` as trainers,
        rebuilding the control plane first if the broker died."""
        if not self._broker.alive():
            # A restarted broker lost our subscription; workers re-announce
            # through their own watchdogs.
            self._rebuild_broker()
        try:
            return enrollment.admit_late_joiners(
                self._enroll, self._broker, self.trainers, self.evaluator,
                self._clients, poll)
        except (OSError, protocol.ConnectionClosed):
            self._rebuild_broker()
            return []

    def _rebuild_broker(self) -> None:
        """Reconnect the control plane after a broker death (training runs
        on direct tensor connections either way); the outcome counts in
        ``comm.broker_reconnects_total``."""
        reg = telemetry.get_registry()
        try:
            fresh = BrokerClient(self._broker_addr[0], self._broker_addr[1],
                                 timeout=protocol.CONNECT_TIMEOUT)
        except OSError:
            reg.counter("comm.broker_reconnects_total",
                        labels={"outcome": "failed"}).inc()
            return
        self._broker.close()
        self._broker = fresh
        self._enroll = EnrollmentManager(fresh, mud_policy=self._mud_policy,
                                         device_type=self._device_type)
        reg.counter("comm.broker_reconnects_total",
                    labels={"outcome": "ok"}).inc()

    def enroll_aggregators(self, timeout: float = 30.0) -> list[int]:
        """Discover ``num_aggregators`` aggregators from their retained
        announcements and return their ids.  Raises ``TimeoutError`` when
        fewer announce in time."""
        deadline = time.monotonic() + timeout
        while True:
            self._refresh_aggs(drain_timeout=0.2)
            with self._agg_lock:
                ids = sorted(self._aggs)
            if len(ids) >= self.num_aggregators:
                return ids
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"only {len(ids)}/{self.num_aggregators} aggregators "
                    f"announced within {timeout:.0f}s")

    def _refresh_aggs(self, drain_timeout: float = 0.02) -> None:
        """Read the retained announce topic into ``_aggs`` (the latest
        record per agg_id wins), subscribing again after a broker
        restart.  Broker reads happen under no lock: a caller that finds
        another refresh in flight returns at once.  ``fetch_aggregators``
        bounds each read by ``drain_timeout``, so the backlog is read in
        such windows until one brings nothing, within
        ``REFRESH_BUDGET_S``."""
        if not self._agg_refreshing.acquire(blocking=False):
            return
        try:
            with self._agg_lock:
                sub = self._agg_sub
            if sub is None:
                try:
                    sub = BrokerClient(self._broker_addr[0],
                                       self._broker_addr[1],
                                       timeout=protocol.CONNECT_TIMEOUT)
                    sub.subscribe(agg_lib.AGG_TOPIC + "#")
                except OSError:
                    telemetry.get_registry().counter(
                        "comm.broker_reconnects_total",
                        labels={"outcome": "failed"}).inc()
                    return
                with self._agg_lock:
                    self._agg_sub = sub
            fresh: dict = {}
            budget = time.monotonic() + REFRESH_BUDGET_S
            try:
                while True:
                    window: dict = {}
                    agg_lib.fetch_aggregators(sub, window,
                                              drain_timeout=drain_timeout)
                    fresh.update(window)
                    if not window or time.monotonic() >= budget:
                        break
            except (protocol.ConnectionClosed, OSError):
                with self._agg_lock:
                    if self._agg_sub is sub:
                        self._agg_sub = None  # broker died; rebuilt next
                try:
                    sub.close()
                except OSError:
                    protocol.count_suppressed()
                return
            if fresh:
                with self._agg_lock:
                    self._aggs.update(fresh)
        finally:
            self._agg_refreshing.release()

    def _close_agg_sub(self) -> None:
        with self._agg_lock:
            sub, self._agg_sub = self._agg_sub, None
        if sub is not None:
            sub.close()

    def _health_flush(self) -> dict:
        """Fold the transport's per-device retries into the ledger, flush
        it durably, and return the merged view of every ledger in its
        directory (exported as gauges)."""
        _hl.feed_transport_retries(self.health, self._health_retry_seen)
        self.health.flush()
        fleet = _hl.load_health(os.path.dirname(self.health.path))
        _hl.export_gauges(fleet)
        return fleet

    def _ask_evaluator(self, timeout: float) -> dict:
        """Score the global model on the evaluator device."""
        if self.evaluator is None:
            raise RuntimeError("no evaluator was assigned")
        params_np = host_params(self._eval_params())
        with self.tracer.span("evaluate"):
            header, _ = self._clients[self.evaluator.device_id].request(
                protocol.attach_trace({"op": "eval"},
                                      self.tracer.current_context()),
                params_np, timeout=timeout)
        if header.get("status") != "ok":
            raise RuntimeError(f"evaluator failed: {header.get('error')}")
        meta = header["meta"]
        protocol.pop_trace_spans(meta, self.tracer)
        return meta


class FederatedCoordinator(CoordinatorCore):
    def __init__(
        self,
        config: ExperimentConfig,
        broker_host: str,
        broker_port: int,
        round_timeout: float = 60.0,
        want_evaluator: bool = True,
        mud_policy=None,
        device_type: Optional[str] = None,
        device=None,
    ):
        """``mud_policy``: an optional :class:`comm.mud.MudPolicy` gating
        enrollment by RFC 8520 identity.  ``device_type``: federate ONLY
        devices of this MUD type (the per-type topology)."""
        setup_lib.require_mean_aggregator(config, "the socket coordinator")
        fed = config.fed
        if fed.secure_agg and fed.secure_agg_neighbors and (
            fed.secure_agg_neighbors % 2 or fed.secure_agg_neighbors < 2
        ):
            raise ValueError(
                "secure_agg_neighbors must be an even integer >= 2, got "
                f"{fed.secure_agg_neighbors}")
        if fed.secure_agg and not 0.0 < fed.secure_agg_threshold <= 1.0:
            raise ValueError(
                "secure_agg_threshold must be in (0, 1], got "
                f"{fed.secure_agg_threshold}")
        validate_robustness(config)
        if config.run.num_aggregators and fed.compress_down != "none":
            raise ValueError(
                "the aggregator tree requires compress_down='none': the "
                "per-device resync protocol is not relayed through the "
                "fold tier"
            )
        self.agg_heartbeat_timeout = float(config.run.agg_heartbeat_timeout)
        self.round_timeout = round_timeout
        self.retry = (
            RetryPolicy(max_retries=config.run.comm_retries,
                        backoff_base=config.run.comm_backoff_base,
                        backoff_max=config.run.comm_backoff_max)
            if config.run.comm_retries > 0 else None)
        # Sub-quorum rounds are explicit no-ops; 0 disables.
        self.min_cohort_fraction = fed.min_cohort_fraction
        self._init_core(config, broker_host, broker_port, want_evaluator,
                        mud_policy, device_type, device, "coordinator")
        self._wal = None
        # The durable enrollment ledger (ckpt/wal.EnrollmentLedger) and
        # what the previous incarnation admitted, read before this process
        # appends: challenge-on-resume verifies against it.
        self._ledger = None
        self._ledger_prior: Optional[dict] = None
        # The accepted-update manifest of the last round, for the WAL.
        self._last_accepted: list[int] = []
        self._draws = programs.Draws(config.run.seed)
        self._fail_counts: dict[str, int] = {}
        self.evict_after = config.run.evict_after
        # One fan-out pool per coordinator, grown and never shrunk.
        self._pool: Optional[cf.ThreadPoolExecutor] = None
        self._pool_size = 0
        # Asks that could not be cancelled after a timeout keep running on
        # their (closed) clients; see _fan_out.
        self._abandoned: list[cf.Future] = []
        self._downlink = DownlinkEncoder(fed.compress_down)
        # The LoRA adapters (fed/lora.py): the factors live beside the
        # frozen base, in the flax layout on the coordinator's device.
        self._lora = fed.lora_rank > 0
        self._factors = None
        self._lora_agg_count = 0
        if self._lora:
            self._factors = setup_lib.init_lora_factors(
                config, self._shapes_np, self.device)
            reg = telemetry.get_registry()
            reg.gauge("fed.lora_rank").set(fed.lora_rank)
            reg.gauge("fed.lora_factor_params").set(
                lora_lib.count_factor_params(self._factors))
        # The fold and mask template: what the uplink ships.
        self._fold_shapes = (_shape_views(self._factors) if self._lora
                             else self._shapes_np)
        # What a compressed (or factor) uplink saves per update against the
        # dense one, priced once on zeros (frame lengths depend on shapes,
        # never values).
        self._uplink_saved_per_update = 0
        if fed.compress != "none" or self._lora:
            zeros = trees.map_leaves(
                lambda a: np.zeros(np.shape(a), np.float32), self._shapes_np)
            dense_len = wire_frame_length(
                zeros, {"round": 0, "op": "train", "compress": "none"})
            sample = (trees.map_leaves(
                lambda a: np.zeros(np.shape(a), np.float32),
                self._fold_shapes) if self._lora else zeros)
            if fed.compress != "none":
                wire_up, meta_up = compression.compress_delta(
                    sample, fed.compress, topk_fraction=fed.topk_fraction)
                comp_len = wire_frame_length(
                    wire_up, {"round": 0, "op": "train", **meta_up})
            else:
                comp_len = wire_frame_length(
                    sample, {"round": 0, "op": "train", "compress": "none"})
            self._uplink_saved_per_update = max(0, int(dense_len - comp_len))

    # ------------------------------------------------------------------
    # ---- aggregator tier (comm/aggregator.py) ----------------------------
    def _live_aggregators(self) -> list[int]:
        """Aggregators whose retained heartbeat is younger than
        ``agg_heartbeat_timeout``."""
        self._refresh_aggs()
        now = time.time()
        with self._agg_lock:
            ts = {a: info["ts"] for a, info in self._aggs.items()}
        live = []
        reg = telemetry.get_registry()
        for agg_id in sorted(ts):
            age = now - ts[agg_id]
            reg.gauge("comm.agg_heartbeat_age_s",
                      labels={"agg": str(agg_id)}).set(age)
            if age <= self.agg_heartbeat_timeout:
                live.append(agg_id)
            else:
                reg.counter("comm.agg_heartbeat_expired_total").inc()
        return live

    def close(self) -> None:
        self._close_agg_sub()
        if self._ledger is not None:
            self._ledger.close()
            self._ledger = None
        for c in self._clients.values():
            c.close()
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
        self._broker.close()
        if self._ckpt is not None:
            self._ckpt.close()
            self._ckpt = None
        if self._wal is not None:
            self._wal.close()
            self._wal = None
        if self.health is not None:
            self.health.flush()
            self.health.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def enroll(self, min_devices: int, timeout: float = 30.0) -> None:
        """Wait for devices, assign roles, open tensor connections; with a
        ``checkpoint_dir`` every admission is appended to the durable
        enrollment ledger, which challenge-on-resume verifies against."""
        super().enroll(min_devices, timeout)
        for d in self.trainers + ([self.evaluator] if self.evaluator else []):
            self._ledger_admit(d)

    def refresh_membership(self, poll: float = 0.1) -> list[str]:
        """Elastic membership: admit devices that enrolled after
        :meth:`enroll` as trainers of the next round (and to the
        ledger)."""
        admitted = self._admit_late_joiners(poll)
        if admitted:
            fresh = set(admitted)
            for d in self.trainers:
                if d.device_id in fresh:
                    self._ledger_admit(d)
        return admitted

    # ---- durable enrollment and challenge-on-resume ----------------------
    def _enroll_ledger(self):
        if self._ledger is None and self.config.run.checkpoint_dir:
            from colearn_federated_learning_tpu_torch.ckpt import (
                EnrollmentLedger)

            self._ledger = EnrollmentLedger(self.config.run.checkpoint_dir)
            # What the PREVIOUS incarnation admitted, before this process
            # appends anything: this process's own admissions come from
            # the replayable announcements the challenge distrusts.
            self._ledger_prior = self._ledger.devices()
        return self._ledger

    def _ledger_admit(self, d: DeviceInfo) -> None:
        ledger = self._enroll_ledger()
        if ledger is not None:
            ledger.admit(d)

    def verify_resumed_devices(self) -> dict:
        """Challenge-on-resume: after a resumed coordinator re-enrolls,
        readmit only devices the previous incarnation's ledger knows and,
        where the ledger holds an identity pubkey, only once the device
        proves it holds the matching private key (a nonce echoed under a
        fresh ephemeral DH pairing).  A rejected device is dropped from
        the federation, revoked in the ledger and counted in
        ``comm.enroll_challenge_rejected_total{reason}`` (``not_in_ledger``,
        ``bad_ledger_key``, ``unreachable``, ``bad_tag``).  An entry
        without a pubkey (a device enrolled by a pre-identity build) is
        admitted on its presence alone.  Returns ``{"verified": [...],
        "rejected": [...]}``."""
        ledger = self._enroll_ledger()
        reg = telemetry.get_registry()
        out = {"verified": [], "rejected": []}
        if ledger is None:
            return out
        known = self._ledger_prior or {}
        eph_priv, eph_pub = keyexchange.generate_keypair()
        pub_s = keyexchange.encode_public(eph_pub)

        def reject(dev: DeviceInfo, reason: str) -> None:
            reg.counter("comm.enroll_challenge_rejected_total",
                        labels={"reason": reason}).inc()
            # Retract the admission this enrollment just recorded from the
            # announcement, so it cannot pass a later resume either.
            ledger.revoke(dev.device_id)
            out["rejected"].append(dev.device_id)
            self.trainers = [t for t in self.trainers
                             if t.device_id != dev.device_id]
            if (self.evaluator is not None
                    and self.evaluator.device_id == dev.device_id):
                self.evaluator = None
            cli = self._clients.pop(dev.device_id, None)
            if cli is not None:
                cli.close()

        devices = list(self.trainers)
        if self.evaluator is not None:
            devices.append(self.evaluator)
        for dev in devices:
            rec = known.get(str(dev.device_id))
            if rec is None:
                reject(dev, "not_in_ledger")
                continue
            pubkey = rec.get("pubkey", "")
            if not pubkey:
                out["verified"].append(dev.device_id)
                continue
            nonce = os.urandom(16).hex()
            try:
                secret = keyexchange.shared_secret(
                    eph_priv, keyexchange.decode_public(pubkey))
            except ValueError:
                reject(dev, "bad_ledger_key")
                continue
            expect = hashlib.sha256(
                secret + bytes.fromhex(nonce)).hexdigest()
            try:
                header, _ = self._clients[dev.device_id].request(
                    {"op": "challenge", "nonce": nonce, "pub": pub_s},
                    timeout=self.round_timeout)
                tag = (header.get("meta") or {}).get("tag", "")
            except (OSError, protocol.ConnectionClosed, TimeoutError):
                reject(dev, "unreachable")
                continue
            if header.get("status") != "ok" or tag != expect:
                # Whoever answered does not hold the key the ledger bound
                # this device id to.
                reject(dev, "bad_tag")
                continue
            out["verified"].append(dev.device_id)
        return out

    def _note_round_outcome(self, cohort, dropped) -> list[str]:
        """Count consecutive failures; evict peers that failed
        ``evict_after`` rounds in a row."""
        dropped_set = set(dropped)
        for d in cohort:
            if d.device_id in dropped_set:
                self._fail_counts[d.device_id] = (
                    self._fail_counts.get(d.device_id, 0) + 1)
            else:
                self._fail_counts.pop(d.device_id, None)
        evicted = [i for i, n in self._fail_counts.items()
                   if n >= self.evict_after]
        for dev_id in evicted:
            self._fail_counts.pop(dev_id, None)
            self.trainers = [t for t in self.trainers
                             if t.device_id != dev_id]
            cli = self._clients.pop(dev_id, None)
            if cli is not None:
                cli.close()
        return evicted

    def _reconnect(self, dev: DeviceInfo) -> None:
        """Replace a device's connection after a failure: a late reply on
        the old one would desynchronise the stream.  A dead peer stays
        closed, counted."""
        self._clients[dev.device_id].close()
        try:
            self._clients[dev.device_id] = TensorClient(
                dev.host, dev.port, timeout=protocol.CONNECT_TIMEOUT,
                ident=dev.device_id)
        except OSError:
            telemetry.get_registry().counter(
                "comm.reconnect_failures_total").inc()

    def _request(self, dev: DeviceInfo, header: dict, tree=None, meta=None,
                 deadline=None, body=None):
        """One device request under the retry policy, every attempt
        budgeted against the shared ``deadline``."""
        return self._clients[dev.device_id].request(
            header, tree, meta=meta, timeout=self.round_timeout,
            retry=self.retry, deadline=deadline, body=body)

    def _executor(self, n: int) -> cf.ThreadPoolExecutor:
        if self._pool is None or self._pool_size < n:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
            self._pool_size = max(1, n)
            self._pool = cf.ThreadPoolExecutor(
                max_workers=self._pool_size, thread_name_prefix="fanout")
        return self._pool

    def _fan_out(self, devs, ask, on_result=None, timeout=None):
        """Fan ``ask(dev, deadline)`` out over ``devs`` against one shared
        deadline (``timeout``, default ``round_timeout``).  Replies are
        taken as they arrive on this thread (``on_result(dev, result)``,
        so folders need no lock); a failed or late device is reconnected,
        and an ask that cannot be cancelled is kept in ``_abandoned`` on
        its closed client.  Returns (results, failed devices in ``devs``
        order)."""
        self._abandoned = [f for f in self._abandoned if not f.done()]
        budget = self.round_timeout if timeout is None else timeout
        results, failed_ids, handled = [], set(), set()
        deadline = time.monotonic() + budget
        pool = self._executor(len(devs))
        futs = {pool.submit(ask, d, deadline): d for d in devs}  # colearn: hot

        def take(fut, dev):
            handled.add(fut)
            try:
                res = fut.result()
            except Exception:
                failed_ids.add(dev.device_id)
                self._reconnect(dev)
                return
            if on_result is not None:
                on_result(dev, res)
            results.append(res)

        try:
            for fut in cf.as_completed(futs, timeout=budget):
                take(fut, futs[fut])
        except cf.TimeoutError:   # colearn: noqa(CL003): stragglers dropped/counted/reconnected below
            pass                       # stragglers are handled below
        for fut, dev in futs.items():
            if fut in handled:
                continue
            if fut.done():             # finished in the race window
                take(fut, dev)
                continue
            if not fut.cancel():
                self._abandoned.append(fut)
            failed_ids.add(dev.device_id)
            self._reconnect(dev)
        failed = [d for d in devs if d.device_id in failed_ids]
        return results, failed

    def _sample_cohort(self, round_idx: int) -> list[DeviceInfo]:
        k = self.config.fed.cohort_size
        if not k or k >= len(self.trainers):
            return list(self.trainers)
        rng = np.random.default_rng(self.config.run.seed * 100_003 + round_idx)
        idx = rng.choice(len(self.trainers), size=k, replace=False)
        return [self.trainers[i] for i in sorted(idx)]

    def run_round(self) -> dict:
        """One round: broadcast, parallel local training against the
        deadline, weighted aggregation of the updates that made it."""
        r = len(self.history)
        reg = telemetry.get_registry()
        retries_before = reg.counter("comm.retry_total").value
        with self.tracer.span("round", round=r) as round_sp:
            rec = self._run_round(r)
        rec["round_time_s"] = round_sp.duration_s
        retries = reg.counter("comm.retry_total").value - retries_before
        if retries:
            rec["retries"] = int(retries)
        reg.counter("fed.rounds_total").inc()
        reg.counter("fed.clients_dropped").inc(len(rec["dropped"]))
        reg.counter("fed.clients_evicted").inc(len(rec["evicted"]))
        reg.histogram("fed.round_time_s").observe(rec["round_time_s"])
        # Per-phase latency, as labelled children of one family.
        for phase, key in (("broadcast_collect", "phase_broadcast_collect_s"),
                           ("aggregate", "phase_aggregate_s"),
                           ("agg_fold", "phase_agg_fold_s")):
            if key in rec:
                reg.histogram("fed.phase_time_s",
                              labels={"phase": phase}).observe(rec[key])
        self.history.append(rec)
        return rec

    def _run_round(self, r: int) -> dict:
        fed = self.config.fed
        tracer = self.tracer
        cohort = self._sample_cohort(r)
        cohort_full = list(cohort)
        # The round span's context, taken here: the fan-out's asks run on
        # pool threads, where it is not implicit.
        ctx = tracer.current_context()
        round_t0 = time.monotonic()
        secure = fed.secure_agg
        dh = secure and fed.secure_agg_key_exchange == "dh"
        tree_mode = self.num_aggregators > 0
        share_info = None
        pruned: list[str] = []
        slices_full: list[list[DeviceInfo]] = []
        cohort_of = None
        tree_stats = None
        if tree_mode:
            # The slice layout is fixed over the SAMPLED cohort, before the
            # share phase prunes, so each device's pairing cohort at
            # share_setup is its slice at train time: every mask pair
            # lives inside one aggregator's partial.  With a ledger the
            # cohort is ranked by straggler score first (chronic
            # stragglers go to the last slices); without one, or with
            # equal scores, this is the contiguous slice_cohort.
            scores = None
            if self.health is not None:
                fleet_now = self.health.devices()
                if fleet_now:
                    scores = {str(d): h.score()
                              for d, h in fleet_now.items()}
            slices_full = agg_lib.assign_slices(cohort, self.num_aggregators,
                                                scores=scores)
            if secure:
                cohort_of = {}
                for sl in slices_full:
                    ids = sorted(int(d.device_id) for d in sl)
                    for d in sl:
                        cohort_of[d.device_id] = ids
        if dh:
            # Every member distributes its recovery shares before any mask
            # is committed; members that miss the share deadline are
            # pruned, so their death orphans no mask.
            with tracer.span("share_setup", cohort=len(cohort)):
                share_info, share_failed = self._share_phase(
                    r, cohort, ctx, cohort_of)
            if share_failed:
                pruned = [d.device_id for d in share_failed]
                cut = set(pruned)
                cohort = [d for d in cohort if d.device_id not in cut]
        with tracer.span("serialize_params"):  # colearn: hot
            # One encode for the whole cohort (serialize-once).
            if self._lora:
                body, resync_body, saved = self._encode_lora_round(r)
            else:
                body, resync_body, saved = self._downlink.encode_round(
                    r, self.params_tree())
        cohort_ids = sorted(int(d.device_id) for d in cohort)
        stale: list[str] = []
        if tree_mode:
            # The share phase's survivors, grouped by the original layout;
            # the root folds one partial per slice, keyed in slice order.
            alive = {d.device_id for d in cohort}
            slices = [[d for d in sl if d.device_id in alive]
                      for sl in slices_full]
            folder = StreamingFolder(
                self._fold_shapes,
                order=[f"slice:{i}" for i in range(len(slices))],
                placement=self._fold_placement,
                device_fold=self._fold_device, device=self.device)
            with tracer.span("broadcast_collect",
                             cohort=len(cohort)) as collect_sp:
                train_timeout = max(1.0, self.round_timeout
                                    - (time.monotonic() - round_t0))
                tree_stats = self._tree_collect(
                    r, slices, body, share_info, folder, train_timeout,
                    secure, stale, ctx)
            dropped = pruned + tree_stats["failed"]
        else:
            with tracer.span("broadcast_collect",
                             cohort=len(cohort)) as collect_sp:
                folder, failed = self._flat_collect(
                    r, cohort, cohort_ids, body, resync_body, saved,
                    share_info, secure, stale, round_t0, ctx)
            dropped = pruned + [d.device_id for d in failed]

        with tracer.span("aggregate") as agg_sp:
            folder.finalize()
            if stale:
                pos = {str(int(d.device_id)): i
                       for i, d in enumerate(cohort)}
                dropped.extend(sorted(stale,
                                      key=lambda c: pos.get(c, len(pos))))
            # Under the tree the folded ids are slice keys; the devices
            # come from the partials' metas, in slice order.
            received = (tree_stats["received"] if tree_mode
                        else [int(c) for c in folder.folded_ids])
            folded = folder.count
            # The accepted-update manifest for the round WAL (not a key of
            # the record, whose layout is JAX's).
            self._last_accepted = received
            # Judged against the nominal sampled cohort.
            quorum = (max(1, math.ceil(self.min_cohort_fraction
                                       * len(cohort_full)))
                      if self.min_cohort_fraction > 0 else 0)
            skipped_quorum = bool(quorum) and folded < quorum
            missing = sorted(set(cohort_ids) - set(received))
            unmask_failed = False
            if secure and folded and not skipped_quorum and (dh or missing):
                # Masks pair within a group: the whole cohort, or one
                # slice of the tree.  Each group with a folded member gets
                # its own recovery; a fully dropped slice orphans no mask
                # half.
                if tree_mode:
                    groups = [(ids, recv) for ids, recv
                              in zip(tree_stats["slice_ids"],
                                     tree_stats["slice_received"]) if recv]
                else:
                    groups = [(cohort_ids, received)]
                with tracer.span("unmask", dropped=len(missing)):
                    for g_ids, g_recv in groups:
                        g_miss = sorted(set(g_ids) - set(g_recv))
                        if dh:
                            # Runs every dh round: the folded clients'
                            # self-masks come off even when nobody
                            # dropped.
                            ok = self._recover_dh(r, g_ids, g_recv, g_miss,
                                                  folder, share_info)
                        elif g_miss:
                            ok = self._recover_shared_seed(
                                r, g_ids, g_recv, g_miss, folder)
                        else:
                            ok = True
                        if not ok:
                            unmask_failed = True
                            break
            mean_delta, total_w, mean_loss = folder.mean()
            if skipped_quorum:
                telemetry.get_registry().counter(
                    "fed.rounds_skipped_quorum").inc()
            if skipped_quorum or unmask_failed:
                # A no-op round: orphaned masks or a sub-quorum average
                # must never reach the model.
                mean_delta = None
                mean_loss = float("nan")
            if secure:
                mean_loss = float("nan")  # workers withhold per-client loss
            lora_merged = False
            if mean_delta is not None:
                if self._lora:
                    lora_merged = self._apply_lora_update(mean_delta)
                else:
                    self._server_step(mean_delta)
            conv_sig = self._observe_learning(mean_delta, agg_sp)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        evicted = self._note_round_outcome(cohort_full, dropped)
        rec = {
            "round": r,
            "completed": folded,
            "cohort": len(cohort_full),
            "dropped": dropped,
            "evicted": evicted,
            "train_loss": mean_loss,
            "total_weight": total_w,
            "phase_broadcast_collect_s": collect_sp.duration_s,
            "phase_aggregate_s": agg_sp.duration_s,
            # Decode and staging work the streaming fold overlapped with
            # the stragglers (the tier's included).
            "phase_fold_overlap_s": folder.fold_s,
        }
        if secure:
            rec["unmask_failed"] = unmask_failed
        if quorum:
            rec["skipped_quorum"] = skipped_quorum
        if fed.compress != "none" or self._lora:
            rec["bytes_saved_uplink"] = self._uplink_saved_per_update * folded
            rec["uplink_densify_avoided"] = folder.densify_avoided
        if self._lora:
            rec["lora_merged"] = lora_merged
        if tree_mode:
            rec["aggregators"] = self.num_aggregators
            # The tier's critical path: its slowest slice fold.
            rec["phase_agg_fold_s"] = tree_stats["fold_wall_s"]
            if tree_stats["failovers"]:
                rec["agg_failovers"] = tree_stats["failovers"]

        if self.accountant is not None:
            # Workers calibrate noise to the nominal cohort, so with only
            # ``folded`` contributors the central noise is
            # σ·C·sqrt(folded/nominal): charge that.  A round that released
            # nothing costs nothing.
            if folded > 0 and not (secure and unmask_failed) \
                    and not skipped_quorum:
                nominal = setup_lib.dp_effective_cohort(self.config)
                sigma_eff = (fed.dp_noise_multiplier
                             * math.sqrt(min(folded, nominal) / nominal))
                q = len(cohort_full) / max(1, len(self.trainers))
                self.accountant.step(sampling_rate=q,
                                     noise_multiplier=sigma_eff)
            rec["dp_epsilon"] = self.accountant.epsilon()
            rec["dp_delta"] = self.accountant.delta
        if self.health is not None:
            # The health_* keys only when the ledger is on.
            rec.update(_hl.health_record_keys(self._health_round_feed(
                r, pruned, dropped, evicted, tree_mode, tree_stats)))
        if conv_sig:
            # The conv_* keys only under learn_observe.
            rec.update(conv_sig)
        return rec

    # ---- health ledger (telemetry/health.py) -----------------------------
    def _health_note_worker(self, meta: dict, r: int) -> None:
        """A device's round latency, read from its own ``worker.train``
        span in the reply meta (flat; under the tree the owning aggregator
        records its slice)."""
        for sd in meta.get(protocol.TRACE_SPANS_KEY) or []:
            if str(sd.get("name")) != "worker.train":
                continue
            did = str((sd.get("attrs") or {}).get(
                "client_id", meta.get("client_id", "")))
            if did:
                self.health.record(
                    did, round=r, latency_s=float(sd.get("duration_s", 0.0)))

    def _health_round_feed(self, r: int, pruned, dropped, evicted,
                           tree_mode: bool, tree_stats) -> dict:
        """The round's attribution: deadline misses (under the tree only
        whole-slice drops; the owning aggregator records its devices'),
        share-phase prunes as secure-aggregation dropouts, evictions and
        the transport's per-device retries; one durable flush.  Returns
        the merged view of every ledger in the directory (under the tree
        the latencies are in the aggregators' files)."""
        pruned_set = set(pruned)
        miss = (tree_stats["slice_dropped"] if tree_mode
                else [d for d in dropped if d not in pruned_set])
        for did in miss:
            self.health.record(str(did), round=r, deadline_miss=1)
        for did in pruned:
            self.health.record(str(did), round=r, secure_dropout=1)
        for did in evicted:
            self.health.record(str(did), round=r, eviction=1)
        return self._health_flush()

    def _flat_collect(self, r, cohort, cohort_ids, body, resync_body, saved,
                      share_info, secure, stale, round_t0, ctx):
        """The flat collect: every cohort member's train request from here,
        under the round's span context ``ctx``, folded as it arrives.
        Returns (folder, failed devices)."""
        reg = telemetry.get_registry()

        def train_req(dev: DeviceInfo):
            req = protocol.attach_trace({"op": "train", "round": r}, ctx)
            if secure:
                req["cohort"] = cohort_ids
            if share_info is not None:
                inbox = share_info["to"].get(dev.device_id)
                if inbox:
                    req["shares_in"] = inbox
            return req

        def ask(dev: DeviceInfo, deadline: float):
            header, delta = self._request(dev, train_req(dev), body=body,
                                          deadline=deadline)
            if header.get("status") == "resync" and resync_body is not None:
                # The worker's cache missed: one full-params send for it.
                reg.counter("comm.resync_total").inc()
                header, delta = self._request(dev, train_req(dev),
                                              body=resync_body(),
                                              deadline=deadline)
            elif saved:
                reg.counter("comm.bytes_saved_downlink").inc(saved)
            if header.get("status") != "ok":
                raise RuntimeError(f"{dev.device_id}: {header.get('error')}")
            if self._uplink_saved_per_update:
                reg.counter("comm.bytes_saved_uplink").inc(
                    self._uplink_saved_per_update)
            return header["meta"], delta

        # The sum is pinned to cohort order whatever the arrival order.
        folder = StreamingFolder(
            self._fold_shapes, order=[str(int(d.device_id)) for d in cohort],
            placement=self._fold_placement,
            device_fold=self._fold_device, device=self.device)

        def fold(dev: DeviceInfo, res) -> None:
            meta, delta = res
            if self.health is not None:
                # The device's latency, from its own train span, read
                # before the spans are adopted.
                self._health_note_worker(meta, r)
            protocol.pop_trace_spans(meta, self.tracer)
            if int(meta.get("round", r)) != r:     # stale update: refuse
                stale.append(str(meta.get("client_id")))
                return
            folder.add(meta, delta)

        # The train fan-out races what is left of the round's budget after
        # the share phase.
        train_timeout = max(1.0, self.round_timeout
                            - (time.monotonic() - round_t0))
        _, failed = self._fan_out(cohort, ask, on_result=fold,
                                  timeout=train_timeout)
        return folder, failed

    def _tree_collect(self, r: int, slices, body, share_info, folder,
                      timeout: float, secure: bool, stale: list,
                      ctx=None) -> dict:
        """The tree's collect: ONE fold request per cohort slice, to
        aggregator ``i mod N``.  A failed request (expired heartbeat,
        refused connection, death mid-fold) re-homes the WHOLE slice to
        the next live sibling within what is left of the budget, on a
        fresh connection per attempt; devices retrain on the relayed
        duplicate.  A slice with no live sibling is dropped and the mean
        renormalises.  Partials fold through ``add_partial``; the tier's
        spans are adopted.  Returns the per-slice bookkeeping the masks'
        recovery needs."""
        reg = telemetry.get_registry()
        live = self._live_aggregators()
        with self._agg_lock:
            aggs = {a: dict(info) for a, info in self._aggs.items()}
        agg_order = sorted(aggs)
        deadline = time.monotonic() + timeout
        slice_ids = [sorted(int(d.device_id) for d in sl) for sl in slices]

        def ask_slice(i: int, devs):
            req = protocol.attach_trace({
                "op": "fold", "round": r,
                "devices": [[int(d.device_id), d.host, d.port]
                            for d in devs]}, ctx)
            if secure:
                req["cohort"] = slice_ids[i]
            if share_info is not None:
                inboxes = {d.device_id: share_info["to"][d.device_id]
                           for d in devs
                           if share_info["to"].get(d.device_id)}
                if inboxes:
                    req["shares_in"] = inboxes
            assigned = agg_order[i % len(agg_order)] if agg_order else None
            candidates = (([assigned] if assigned in live else [])
                          + [a for a in live if a != assigned])
            for agg_id in candidates:
                info = aggs[agg_id]
                # What is left of the round at THIS attempt: a re-home does
                # not restart the clock.
                req["timeout"] = max(1.0, deadline - time.monotonic())
                try:
                    cli = TensorClient(info["host"], info["port"],
                                       timeout=protocol.CONNECT_TIMEOUT,
                                       ident=f"agg:{agg_id}")
                except OSError:
                    protocol.count_suppressed()   # dead: the next one
                    continue
                try:
                    hdr, tree = cli.request(req, body=body, timeout=timeout,
                                            retry=self.retry,
                                            deadline=deadline)
                    if hdr.get("status") != "ok":
                        raise RuntimeError(
                            f"agg {agg_id}: {hdr.get('error')}")
                    return hdr["meta"], tree, agg_id != assigned
                except (OSError, protocol.ConnectionClosed, TimeoutError,
                        RuntimeError):
                    protocol.count_suppressed()   # died mid-fold: the next
                    continue
                finally:
                    cli.close()
            raise RuntimeError(f"slice {i}: no live aggregator")

        results: dict[int, tuple[dict, bool]] = {}
        work = [(i, sl) for i, sl in enumerate(slices) if sl]
        if agg_order:
            for i, sl in work:
                # The slice size at dispatch, per assigned aggregator.
                reg.gauge("comm.agg_slice_devices",
                          labels={"agg": str(agg_order[i % len(agg_order)])}
                          ).set(len(sl))
        if work:
            with cf.ThreadPoolExecutor(
                    max_workers=len(work),
                    thread_name_prefix="tree-collect") as pool:
                futs = {pool.submit(ask_slice, i, sl): i for i, sl in work}
                pending = dict(futs)

                def take(fut, i):
                    try:
                        meta, tree, rehomed = fut.result()
                    except Exception:
                        return          # the slice is dropped: charged below
                    # The tier's spans (its fold span and the worker spans
                    # it harvested) join the round's trace.
                    protocol.pop_trace_spans(meta, self.tracer)
                    reg.counter("comm.agg_partials_folded_total",
                                labels={"agg": str(meta.get("agg_id", "?"))}
                                ).inc()
                    results[i] = (meta, rehomed)
                    # Arrival order is immaterial: finalize folds in slice
                    # order.
                    folder.add_partial(
                        f"slice:{i}", float(meta.get("total_w", 0.0)),
                        tree, float(meta.get("loss_sum", 0.0)),
                        count=len(meta.get("folded_ids") or []))

                try:
                    for fut in cf.as_completed(futs, timeout=timeout):
                        take(fut, pending.pop(fut))
                except cf.TimeoutError:     # colearn: noqa(CL003): stragglers cancelled and counted below
                    pass
                for fut, i in pending.items():
                    if fut.done():
                        take(fut, i)    # finished in the race window
                    else:
                        fut.cancel()

        rehomes = drops = 0
        received: list[int] = []
        failed: list[str] = []
        slice_dropped: list[str] = []
        fold_walls: list[float] = []
        slice_recv: list[list[int]] = [[] for _ in slices]
        for i, sl in enumerate(slices):
            got = results.get(i)
            if got is None:
                if sl:
                    drops += 1
                    failed.extend(d.device_id for d in sl)
                    # A whole slice lost (its aggregator died): no
                    # aggregator recorded these devices, the root does.
                    slice_dropped.extend(d.device_id for d in sl)
                continue
            meta, rehomed = got
            rehomes += int(rehomed)
            recv = [int(c) for c in meta.get("folded_ids") or []]
            slice_recv[i] = recv
            received.extend(recv)
            failed.extend(str(f) for f in meta.get("failed") or [])
            stale.extend(str(c) for c in meta.get("stale") or [])
            # The tier's decode and staging time, in the root's overlap
            # slot.
            folder.fold_s += float(meta.get("fold_s", 0.0))
            folder.densify_avoided += int(meta.get("densify_avoided", 0))
            fold_walls.append(float(meta.get("fold_wall_s", 0.0)))
        if rehomes:
            reg.counter("comm.agg_failovers_total",
                        labels={"action": "rehome"}).inc(rehomes)
        if drops:
            reg.counter("comm.agg_failovers_total",
                        labels={"action": "drop"}).inc(drops)
        if self._uplink_saved_per_update and received:
            reg.counter("comm.bytes_saved_uplink").inc(
                self._uplink_saved_per_update * len(received))
        return {"received": received, "failed": failed,
                "slice_ids": slice_ids, "slice_received": slice_recv,
                "failovers": rehomes + drops,
                "slice_dropped": slice_dropped,
                "fold_wall_s": max(fold_walls) if fold_walls else 0.0}

    # ---- secure aggregation ---------------------------------------------
    def _share_phase(self, r: int, cohort, ctx, cohort_of=None):
        """Collect every member's encrypted recovery shares under the share
        deadline.  Returns ``(share_info, failed devices)``; ``share_info``
        routes each ciphertext to its destination's train request and
        keeps each origin's threshold and self-mask commitment.
        ``cohort_of`` (the tree) maps each device to its slice's ids, its
        pairing cohort."""
        cohort_ids = sorted(int(d.device_id) for d in cohort)

        def ask(dev: DeviceInfo, deadline: float):
            ids = (cohort_of.get(dev.device_id, cohort_ids)
                   if cohort_of else cohort_ids)
            header, _ = self._request(
                dev, protocol.attach_trace(
                    {"op": "share_setup", "round": r, "cohort": ids}, ctx),
                deadline=deadline)
            if header.get("status") != "ok":
                raise RuntimeError(f"{dev.device_id}: {header.get('error')}")
            return header["meta"]

        got: dict[str, dict] = {}
        share_timeout = max(1.0,
                            self.round_timeout * SHARE_TIMEOUT_FRACTION)
        _, failed = self._fan_out(
            cohort, ask,
            on_result=lambda dev, m: got.__setitem__(dev.device_id, m),
            timeout=share_timeout)
        info = {"t": {}, "commit": {}, "to": {}}
        total = 0
        for dev_id, meta in got.items():
            protocol.pop_trace_spans(meta, self.tracer)
            origin = str(meta.get("client_id", dev_id))
            info["t"][origin] = int(meta.get("t", 0))
            info["commit"][origin] = str(meta.get("b_commit", ""))
            for dest, blob in (meta.get("shares") or {}).items():
                info["to"].setdefault(str(dest), {})[origin] = blob
                total += 1
        if total:
            telemetry.get_registry().counter(
                "privacy.shares_distributed_total").inc(total)
        return info, failed

    def _partners_of(self, r: int, members, cohort_ids) -> np.ndarray:
        neighbors = self.config.fed.secure_agg_neighbors
        ring = (self._draws.ring_order(r, np.asarray(cohort_ids))
                if neighbors else None)
        return np.asarray(sa.partner_table(np.asarray(members),
                                           np.asarray(cohort_ids),
                                           neighbors, ring))

    def _recover_dh(self, r: int, cohort_ids, received, missing, folder,
                    share_info) -> bool:
        """Share-based mask recovery: collect t-of-n shares from the folded
        survivors, reconstruct every folded client's self-mask seed and
        every dead client's session secret, and subtract the self-masks
        and the orphaned pair masks as one correction on the finalized
        fold.  A reconstruction short of its threshold, or one that fails
        its commitment or public key, discards the round (False), counted
        in ``privacy.share_recovery_failures_total`` by stage."""
        reg = telemetry.get_registry()

        def fail(stage: str) -> bool:
            reg.counter("privacy.share_recovery_failures_total",
                        labels={"stage": stage}).inc()
            return False

        by_id = {int(d.device_id): d for d in self.trainers}
        devs = [by_id[cid] for cid in received if cid in by_id]
        alive_masked = [u for u in received
                        if int(share_info["t"].get(str(u), 0)) > 0]
        s_shares: dict = {y: {} for y in missing}
        b_shares: dict = {u: {} for u in alive_masked}
        b_direct: dict = {}
        if missing or alive_masked:
            ctx = self.tracer.current_context()

            def ask(dev: DeviceInfo, deadline: float):
                header, _ = self._request(
                    dev, protocol.attach_trace(
                        {"op": "unmask", "round": r, "dropped": missing,
                         "alive": alive_masked}, ctx), deadline=deadline)
                if header.get("status") != "ok":
                    raise RuntimeError(
                        f"{dev.device_id}: {header.get('error')}")
                return header["meta"]

            got: dict[str, dict] = {}
            self._fan_out(devs, ask, on_result=lambda dev, m: got.__setitem__(
                dev.device_id, m))
            collected = 0
            for dev in devs:
                meta = got.get(dev.device_id)
                if meta is None:
                    continue    # t-of-n: silent survivors are tolerated
                protocol.pop_trace_spans(meta, self.tracer)
                x = int(meta["client_id"]) + 1
                for origin, val in (meta.get("s_shares") or {}).items():
                    if int(origin) in s_shares:
                        s_shares[int(origin)][x] = int(val, 16)
                        collected += 1
                for origin, val in (meta.get("b_shares") or {}).items():
                    if int(origin) in b_shares:
                        b_shares[int(origin)][x] = int(val, 16)
                        collected += 1
                if meta.get("b_self") is not None and (
                        int(meta["client_id"]) in b_shares):
                    b_direct[int(meta["client_id"])] = int(meta["b_self"], 16)
                    collected += 1
            reg.counter("privacy.shares_collected_total").inc(collected)

        keys: list = []
        signs: list = []
        for u in alive_masked:
            t_u = int(share_info["t"][str(u)])
            try:
                b = (b_direct[u] if u in b_direct
                     else dropout.reconstruct(b_shares.get(u, {}), t_u))
            except dropout.RecoveryError:
                return fail("self_mask")
            if dropout.commitment(b) != share_info["commit"].get(str(u)):
                return fail("self_mask_commit")   # a wrong seed
            keys.append(dropout.self_mask_key(b))
            signs.append(1.0)
        if alive_masked:
            reg.counter("privacy.self_masks_removed_total").inc(
                len(alive_masked))
        if missing:
            table = self._partners_of(r, missing, cohort_ids)
            folded_set = set(received)
            info_cache: dict = {}
            for y, row in zip(missing, table):
                t_y = share_info["t"].get(str(y))
                if t_y is None:
                    return fail("no_share_setup")
                try:
                    s_y = dropout.reconstruct(s_shares.get(y, {}), int(t_y))
                except dropout.RecoveryError:
                    return fail("session_secret")
                try:
                    pub_y = keyexchange.decode_public(
                        enrollment.fetch_device_info(
                            self._broker, str(y), cache=info_cache).pubkey)
                except (OSError, TimeoutError, ValueError):
                    return fail("pubkey_lookup")
                if pow(keyexchange.GROUP14_G, s_y,
                       keyexchange.GROUP14_P) != pub_y:
                    # The public key binds the secret.
                    return fail("session_secret_verify")
                partners = sorted(
                    ({int(p) for p in row.tolist()} & folded_set) - {y})
                for v in partners:
                    try:
                        pub_v = keyexchange.decode_public(
                            enrollment.fetch_device_info(
                                self._broker, str(v),
                                cache=info_cache).pubkey)
                    except (OSError, TimeoutError, ValueError):
                        return fail("pubkey_lookup")
                    secret = keyexchange.shared_secret(s_y, pub_v)
                    keys.append(keyexchange.pair_prng_key(secret, v, y))
                    # Survivor v folded sign(y − v)·PRG(k_vy): subtract it.
                    signs.append(1.0 if y > v else -1.0)
                reg.counter("privacy.masks_recovered_total",
                            labels={"device": str(y)}).inc()
        if keys:
            n = sum(int(np.prod(np.shape(l))) for l in
                    trees.leaves(folder.shapes))
            folder.apply_correction(sa.unflat_wire(
                folder.shapes, sa.pairwise_mask_with_keys(
                    n, keys, signs, r, self.device)))
        return True

    def _recover_shared_seed(self, r: int, cohort_ids, received, missing,
                             folder) -> bool:
        """Recovery under the coordinator-trusted ``shared_seed`` exchange:
        every pair stream derives from the experiment seed, so the orphaned
        halves are recomputed here, with no survivor round trip."""
        table = self._partners_of(r, missing, cohort_ids)
        folded_set = set(received)
        refs = trees.leaves(folder.shapes)
        shapes = [tuple(np.shape(l)) for l in refs]
        correction = None
        for y, row in zip(missing, table):
            partners = sorted({int(p) for p in row.tolist()} & folded_set)
            if not partners:
                continue
            # The mask y would have added is the exact negative of its
            # orphaned halves in the folded sum.
            mask_y = [torch.zeros(s, device=self.device) for s in shapes]
            sa.mask_update(mask_y, y, partners,
                           lambda a, b: self._draws.pair_mask(
                               r, a, b, shapes, self.device))
            neg = [(-m).cpu().numpy() for m in mask_y]
            correction = (neg if correction is None
                          else [np.add(c, n) for c, n in zip(correction, neg)])
            telemetry.get_registry().counter(
                "privacy.masks_recovered_total",
                labels={"device": str(y)}).inc()
        if correction is not None:
            folder.apply_correction(trees.unflatten(folder.shapes,
                                                    correction))
        return True

    # ---- LoRA adapters (fed/lora.py) -------------------------------------
    def _load_factors(self, tree) -> None:
        """Start the factors from a flax-layout factor tree."""
        self._factors = trees.map_leaves(
            lambda l: torch.from_numpy(np.array(l, np.float32)).to(
                self.device), tree)

    def _encode_lora_round(self, r: int):
        """The round's one composite frame (the base, read per shard under
        a placement, and this cycle's factors) with the ``lora`` meta
        marker the aggregator tier reads;
        (body, resync_body, saved) as ``DownlinkEncoder.encode_round``
        gives them (no resync: workers keep no delta cache under LoRA)."""
        composite = {"base": host_params(self.params_tree()),
                     "factors": host_params(self._factors)}
        body = pytree_to_bytes(
            composite, {"round": r, "lora": self.config.fed.lora_rank})
        telemetry.get_registry().counter("comm.broadcast_encode_total").inc()
        return memoryview(body), None, 0

    @torch.no_grad()
    def _apply_lora_update(self, mean_delta) -> bool:
        """factors += server_lr · mean factor delta (FedAvg/FedProx's step;
        the adaptive server optimizers are refused under LoRA) and, every
        ``lora_merge_every`` aggregations, the merge.  True when this
        round merged."""
        f = trees.leaves(self._factors)
        d = [torch.from_numpy(np.asarray(l)).to(self.device)
             for l in trees.flatten_up_to(self._factors, mean_delta)]
        torch._foreach_add_(f, torch._foreach_mul(d, self.config.fed.server_lr))
        self.server_state.round_idx += 1
        self._lora_agg_count += 1
        if self._lora_agg_count < self.config.fed.lora_merge_every:
            return False
        self._merge_lora()
        return True

    @torch.no_grad()
    def _merge_lora(self) -> None:
        """Merge B·A·(α/r) into the base, then zero B (A is kept, so the
        factors' shapes never change); counted in
        ``fed.lora_merges_total``.  On a sharded base the merge runs shard
        by shard (A and B stay replicated) and the bytes a replicated
        merge would have gathered count in
        ``comm.gather_bytes_avoided_total``."""
        fed = self.config.fed
        reg = telemetry.get_registry()
        params = self.params_tree()
        avoided = partition.tree_gather_avoided(params)
        merged = lora_lib.merge_adapters(params, self._factors,
                                         fed.lora_alpha, fed.lora_rank)
        self.server_state.params.update(self._state_dict(merged))
        self._factors = lora_lib.reset_factors(self._factors)
        self._lora_agg_count = 0
        reg.counter("fed.lora_merges_total").inc()
        if avoided:
            reg.counter("comm.gather_bytes_avoided_total").inc(avoided)

    def _eval_params(self) -> dict:
        """Under LoRA a temporary merge, so the unmerged cycle counts; the
        base itself is left as it is."""
        params = self.params_tree()
        if self._lora:
            fed = self.config.fed
            with torch.no_grad():
                params = lora_lib.merge_adapters(params, self._factors,
                                                 fed.lora_alpha, fed.lora_rank)
        return params

    # ---- evaluation -------------------------------------------------------
    def evaluate_per_client(self) -> dict:
        """The global model on every trainer's own shard (``self_eval``),
        one shared deadline; devices that fail are skipped.  Summarized
        in trainer order."""
        if self.config.fed.secure_agg:
            raise NotImplementedError(
                "per-client evaluation is disabled under secure_agg: "
                "per-client statistics are exactly what the masks hide")
        body = memoryview(pytree_to_bytes(host_params(self._eval_params())))
        telemetry.get_registry().counter("comm.broadcast_encode_total").inc()
        ctx = self.tracer.current_context()

        def ask(dev: DeviceInfo, deadline: float):
            header, _ = self._request(
                dev, protocol.attach_trace({"op": "self_eval"}, ctx),
                body=body, deadline=deadline)
            if header.get("status") != "ok":
                raise RuntimeError(f"{dev.device_id}: {header.get('error')}")
            return header["meta"]

        got: dict[str, dict] = {}
        self._fan_out(self.trainers, ask,
                      on_result=lambda dev, m: got.__setitem__(
                          dev.device_id, m))
        metas = [got[d.device_id] for d in self.trainers
                 if d.device_id in got]
        for m in metas:
            protocol.pop_trace_spans(m, self.tracer)
        if not metas:
            return {"num_clients_evaluated": 0}
        out = evaluation.summarize_per_client(
            [m["self_loss"] for m in metas], [m["self_acc"] for m in metas],
            [m["num_examples"] for m in metas])
        out["num_clients_evaluated"] = len(metas)
        out["per_client"] = {m["client_id"]: m["self_acc"] for m in metas}
        return out

    def evaluate(self) -> dict:
        """Score the global model on the evaluator device."""
        return self._ask_evaluator(self.round_timeout)

    # ---- checkpoint/resume ------------------------------------------------
    def _round_wal(self):
        if self._wal is None:
            from colearn_federated_learning_tpu_torch.ckpt import RoundWal

            if not self.config.run.checkpoint_dir:
                raise ValueError("config.run.checkpoint_dir is not set")
            self._wal = RoundWal(self.config.run.checkpoint_dir)
        return self._wal

    def _acct_rdp(self) -> np.ndarray:
        # "No accountant" is a (1,) zero, as in JAX's checkpoints.
        return (self.accountant.total_rdp if self.accountant is not None
                else np.zeros(1))

    def save_checkpoint(self) -> None:
        """Save ``(server_state, acct_rdp)`` and the history at step
        ``len(history)``: the RDP vector rides along, since per-round
        sampling rates follow the membership."""
        self._checkpointer().save(
            len(self.history),
            (self._checkpoint_server_state(), self._acct_rdp()),
            self.history)

    def restore_checkpoint(self) -> int:
        """Restore the latest checkpoint; returns the resumed round index.
        Workers are stateless between rounds, so the server state, the
        history and the privacy budget are all that survive.  Rounds the
        WAL logged past the restored step never committed their state:
        they are rewound (``ckpt.wal_uncommitted_discarded_total``) and
        run again."""
        reg = telemetry.get_registry()
        with self.tracer.span("resume"):
            template = self._checkpoint_server_state()
            state, history, step = self._checkpointer().restore(
                (template, self._acct_rdp()))
            restored, acct_rdp = state
            self._restore_server_state(template, restored)
            self.history = history
            if self.accountant is not None:
                self.accountant.total_rdp = np.asarray(acct_rdp)
                self.accountant._steps = step
            wal = self._round_wal()
            logged = wal.load()
            if len(logged) > step:
                reg.counter("ckpt.wal_uncommitted_discarded_total").inc(
                    len(logged) - step)
                wal.rewind(step)
        reg.counter("fed.rounds_resumed_total").inc()
        return step

    def fit(self, rounds: Optional[int] = None, log_fn=None,
            eval_every: Optional[int] = None,
            elastic: bool = False) -> list[dict]:
        """Run ``rounds`` rounds (default: what remains of
        ``config.fed.rounds``), scoring the evaluator every ``eval_every``
        rounds and on the last.  ``elastic=True`` admits late joiners
        between rounds.  With ``run.checkpoint_dir`` each round goes to
        the WAL first and its state is saved before the record is logged
        (every ``run.checkpoint_every`` rounds and after the last), so a
        kill keyed on a record line lands on a committed checkpoint."""
        if rounds is None:
            rounds = max(0, self.config.fed.rounds - len(self.history))
        eval_every = eval_every or self.config.run.eval_every
        run = self.config.run
        ckpt_every = max(0, run.checkpoint_every)
        want_ckpt = bool(run.checkpoint_dir)
        last_round = len(self.history) + rounds - 1
        for _ in range(rounds):
            if elastic:
                self.refresh_membership()
            rec = self.run_round()
            if want_ckpt:
                # WAL first, state second: an entry past the latest
                # checkpoint step marks an uncommitted round.
                self._round_wal().append({
                    "round": rec["round"],
                    "accepted": list(self._last_accepted),
                    "completed": rec["completed"],
                    "total_weight": rec["total_weight"],
                })
            if self.evaluator is not None and (
                    rec["round"] % max(1, eval_every) == 0
                    or rec["round"] == last_round):
                rec.update(self.evaluate())
            if want_ckpt and (
                    (ckpt_every and (rec["round"] + 1) % ckpt_every == 0)
                    or rec["round"] == last_round):
                self.save_checkpoint()
            if log_fn is not None:
                log_fn(rec)
        return self.history
