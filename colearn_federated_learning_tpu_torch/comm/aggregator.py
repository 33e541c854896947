"""Aggregator tier: distributed ingest between devices and the root (the
counterpart of the JAX package's ``comm/aggregator.py``).

One coordinator folding every uplink byte caps the federation at one
host's ingest bandwidth and fold time.  N :class:`AggregatorServer`
processes each own a contiguous slice of the round cohort, run the same
:class:`StreamingFolder` the root runs over their slice, and send ONE
partial sum up; the root folds N partials instead of C updates.

Exactness: the root's combine of the partials is the float sum regrouped
at the slice boundaries, which is what ``StreamingFolder(slices=...)``
computes flat, so the tree fold is bitwise that slice-blocked flat fold
(with one aggregator, the flat fold outright).

Robustness: every aggregator heartbeats a retained broker record
(``colearn/agg/<id>``, a fresh ``ts`` each beat) and the root reads its
age before dispatch (``run.agg_heartbeat_timeout``).  A fold request that
fails re-homes its whole slice to a live sibling inside the round budget;
only when none is left is the slice dropped, and the mean renormalises.

Secure aggregation is slice-local: the root gives each device its SLICE as
the pairing cohort, so every mask pair cancels inside one partial and a
fully dropped slice orphans no mask half.

The aggregator runs no model: the relayed broadcast, decoded, is its
shapes template; it is re-encoded once for the whole slice
(serialize-once per tier).  ``compress_down`` must be ``none`` under the
tree (the coordinator refuses it).  With ``run.fold_device`` the slice
folds through the fold kernel on the aggregator's device (the card unless
``device="cpu"``, raising without one); without it the fold is the host
fold in numpy.

Telemetry: a slice fold runs under an ``aggregator.fold`` span parented
on the root's span context; each relayed train request carries that
span's context, and the reply ships the workers' spans and the tier's own
up to the root.  Folds count in ``comm.agg_folds_total`` and
``comm.agg_fold_time_s`` per aggregator.  With ``run.health_dir`` the
aggregator keeps its own health ledger of its slice's devices, and the
root ranks its slices by the ledgers' scores (:func:`assign_slices`).

The buffered-asynchronous half (``comm/async_coordinator.py``'s tree
mode): ``aprep`` installs the shapes template and opens an empty slice
buffer; ``abuf`` stages one contribution under its dedup key
(``{version:08d}@{device}``; a repeated key replaces the staged copy, so
a re-homed contribution folds once); ``adrain`` long-polls until the
buffer holds the slice's auto-K (its own arrival estimator's K for one
partial per ``interval_s``, slew-limited to [K/2, 3K/2] per drain) or
the poll's budget ends, swaps in a fresh buffer under the condition,
finalizes the old one outside it and replies one partial with the
versions the root resolves staleness against.  Arrivals racing a drain
stage into the next partial.  Staging is host work; the device fold runs
in the drain, on the shared fold kernel that stages one batch at a time.

Under LoRA the broadcast is a ``{"base", "factors"}`` composite whose
meta carries the ``lora`` marker: its ``factors`` half is the fold (or
buffer) template, since the replies are factor deltas, and the relay
re-encodes the composite with its meta.

:func:`expected_ingest` is the tree's analytic per-round ingest bill
(shape-only pricing, JAX's).
"""

from __future__ import annotations

import concurrent.futures as cf
import math
import threading
import time
from typing import Any, Optional, Sequence

from colearn_federated_learning_tpu_torch import telemetry
from colearn_federated_learning_tpu_torch.comm import protocol
from colearn_federated_learning_tpu_torch.comm.aggregation import (
    StreamingFolder)
from colearn_federated_learning_tpu_torch.comm.broker import BrokerClient
from colearn_federated_learning_tpu_torch.comm.transport import (
    RetryPolicy, TensorClient, TensorServer)
from colearn_federated_learning_tpu_torch.faults import lockwitness
from colearn_federated_learning_tpu_torch.utils.config import (
    ExperimentConfig)
from colearn_federated_learning_tpu_torch.utils.device import resolve_device
from colearn_federated_learning_tpu_torch.utils.serialization import (
    pytree_to_bytes)

# Retained announce/heartbeat topic per aggregator (control plane).
AGG_TOPIC = "colearn/agg/"


def slice_cohort(cohort: Sequence[Any], n: int) -> list[list[Any]]:
    """Partition ``cohort`` (in cohort order) into ``n`` contiguous slices
    whose sizes differ by at most one: the tree's slice layout and the flat
    parity oracle's block layout.  Slices may be empty when ``n`` exceeds
    the cohort; ``n`` below 1 is taken as 1."""
    n = max(1, int(n))
    base, rem = divmod(len(cohort), n)
    out, start = [], 0
    for i in range(n):
        size = base + (1 if i < rem else 0)
        out.append(list(cohort[start:start + size]))
        start += size
    return out


def _device_key(d: Any) -> str:
    """Canonical string id of a cohort entry: device tuples ``(id, host,
    port)`` on the synchronous plane, bare ids on the asynchronous one."""
    if isinstance(d, (tuple, list)):
        return str(int(d[0]))
    return str(getattr(d, "device_id", d))


def assign_slices(cohort: Sequence[Any], n: int,
                  scores: Optional[dict] = None) -> list[list[Any]]:
    """Health-driven slice assignment: ``n`` slices of the sizes of
    :func:`slice_cohort`, over the cohort ordered by the health ledger's
    straggler ``scores`` (canonical device id -> score, ascending), so
    chronic stragglers gather in the last slices.  ``None``, or scores
    that are all equal, give :func:`slice_cohort` exactly (the sort is
    stable over the cohort order)."""
    if scores is None:
        return slice_cohort(cohort, n)
    vals = [float(scores.get(_device_key(d), 0.0)) for d in cohort]
    if len(set(vals)) <= 1:
        return slice_cohort(cohort, n)
    order = sorted(range(len(cohort)), key=lambda i: (vals[i], i))
    return slice_cohort([cohort[i] for i in order], n)


class AggregatorServer:
    """One aggregator: a tensor server folding its device slice.

    Serves ``{"op": "fold"}`` from the root: the body is the round's
    broadcast frame, the header carries the slice's device addresses, the
    slice-local secure-aggregation cohort and the relayed share inboxes.
    The reply is the slice's weighted-sum tree and the fold's bookkeeping
    (``total_w``, ``loss_sum``, ``folded_ids``, ``failed``, ``stale``,
    ``fold_s``, ``fold_wall_s``, ``densify_avoided``)."""

    def __init__(self, config: ExperimentConfig, agg_id: int,
                 broker_host: Optional[str] = None,
                 broker_port: Optional[int] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 heartbeat_s: float = 0.5, device=None):
        self.config = config
        self.agg_id = int(agg_id)
        self._fold_device = bool(config.run.fold_device)
        # Only the device fold touches a device; the host fold is numpy.
        self.device = resolve_device(device) if self._fold_device else None
        # Spans are captured per fold and shipped up to the root, which
        # owns the stitched trace; the local buffer keeps the tier's own.
        self.tracer = telemetry.Tracer(process=f"aggregator-{self.agg_id}",
                                       max_spans=4096)
        # The slice's devices in a ledger of its own, only with
        # run.health_dir.
        self.health = None
        if config.run.health_dir:
            self.health = telemetry.HealthLedger(
                config.run.health_dir, f"aggregator{self.agg_id}")
        self._server = TensorServer(self._handle, host=host, port=port,
                                    ident=f"agg:{self.agg_id}")
        self._broker_addr = (broker_host, broker_port)
        self._broker: Optional[BrokerClient] = None
        self.heartbeat_s = float(heartbeat_s)
        self._stop = threading.Event()
        self._hb: Optional[threading.Thread] = None
        # The root's retry policy, so a flaky device gets the same second
        # chance through either tier.
        self.retry = (
            RetryPolicy(max_retries=config.run.comm_retries,
                        backoff_base=config.run.comm_backoff_base,
                        backoff_max=config.run.comm_backoff_max)
            if config.run.comm_retries > 0 else None)
        # The buffered half: one slice buffer the root fills by ``abuf``
        # and drains by ``adrain``, sized by this slice's arrival rate.
        self.arrival = telemetry.ArrivalEstimator()
        self._abuf_cv = lockwitness.condition(f"agg{agg_id}.abuf_cv")
        self._abuf_folder: Optional[StreamingFolder] = None
        self._abuf_shapes = None
        self._abuf_entries: dict[str, dict] = {}   # dedup key -> its entry
        self._abuf_k: Optional[int] = None         # the slew's anchor
        self._abuf_dedup = 0

    @property
    def host(self) -> str:
        return self._server.host

    @property
    def port(self) -> int:
        return self._server.port

    def start(self) -> "AggregatorServer":
        self._server.start()
        bh, bp = self._broker_addr
        if bh is not None:
            self._broker = BrokerClient(bh, bp,
                                        timeout=protocol.CONNECT_TIMEOUT)
            self._announce()
            self._hb = threading.Thread(
                target=self._heartbeat_loop,
                name=f"agg-{self.agg_id}-heartbeat", daemon=True)
            self._hb.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._hb is not None:
            self._hb.join(timeout=2.0)
        self._server.stop()
        if self._broker is not None:
            self._broker.close()
        if self.health is not None:
            self.health.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _announce(self) -> None:
        self._broker.publish(AGG_TOPIC + str(self.agg_id), {
            "agg_id": self.agg_id, "host": self.host, "port": self.port,
            "ts": time.time(),
        }, retain=True)

    def _heartbeat_loop(self) -> None:
        """Republish the retained announce with a fresh ``ts`` every beat:
        the root's liveness signal.  A dead broker is reconnected in place
        (the retained record died with it)."""
        bh, bp = self._broker_addr
        while not self._stop.wait(self.heartbeat_s):
            try:
                if self._broker is None or not self._broker.alive():
                    fresh = BrokerClient(bh, bp,
                                         timeout=protocol.CONNECT_TIMEOUT)
                    if self._broker is not None:
                        self._broker.close()
                    self._broker = fresh
                self._announce()
            except OSError:
                protocol.count_suppressed()   # broker down: the next beat
                continue

    def _handle(self, header: dict, tree: Any) -> tuple[dict, Any]:
        op = header.get("op")
        if op == "fold":
            return self._fold(header, tree)
        if op == "aprep":
            return self._aprep(header, tree)
        if op == "abuf":
            return self._abuf(header, tree)
        if op == "adrain":
            return self._adrain(header)
        if op == "info":
            return ({"meta": {"agg_id": self.agg_id,
                              "host": self.host, "port": self.port}}, None)
        return ({"status": "error", "error": f"unknown op {op!r}"}, None)

    # ------------------------------------------------- buffered (async) --
    def _new_buffer(self) -> StreamingFolder:
        return StreamingFolder(self._abuf_shapes,
                               device_fold=self._fold_device,
                               device=self.device)

    def _aprep(self, header: dict, tree: Any) -> tuple[dict, Any]:
        """Install the shapes template and (re)open an empty buffer: once
        per root connection, at enrollment and after a restart (a restarted
        process announces a fresh port with nothing staged)."""
        if tree is None:
            return ({"status": "error",
                     "error": "aprep carried no shapes template"}, None)
        # Under LoRA the template is the composite's factor half.
        shapes = tree["factors"] if (header.get("meta") or {}).get(
            "lora") else tree
        with self._abuf_cv:
            self._abuf_shapes = shapes
            self._abuf_folder = self._new_buffer()
            self._abuf_entries = {}
            self._abuf_dedup = 0
            self._abuf_cv.notify_all()
        return ({"meta": {"agg_id": self.agg_id, "prepared": True}}, None)

    def _abuf(self, header: dict, tree: Any) -> tuple[dict, Any]:
        """Stage ONE contribution in the open buffer under
        ``header["key"]``: a repeated key (a re-homed copy racing the
        original, a retry) replaces the staged copy."""
        if tree is None:
            return ({"status": "error",
                     "error": "abuf carried no delta"}, None)
        key = str(header.get("key"))
        dev = str(header.get("device"))
        meta = dict(header.get("meta") or {})
        meta["client_id"] = key
        reg = telemetry.get_registry()
        with self._abuf_cv:
            if self._abuf_folder is None:
                return ({"status": "error",
                         "error": "aggregator buffer not prepared "
                                  "(aprep first)"}, None)
            dup = self._abuf_folder.discard(key)
            if dup:
                self._abuf_dedup += 1
                reg.counter("comm.agg_buffer_dedup_total",
                            labels={"agg": str(self.agg_id)}).inc()
            self._abuf_folder.add(meta, tree)
            self._abuf_entries[key] = {
                "device": dev,
                "version": int(header.get("version", 0)),
                "weight": float(meta.get("weight", 1.0)),
                "rehomed": bool(header.get("rehomed")),
            }
            self.arrival.observe(dev, now=time.monotonic())
            staged = len(self._abuf_entries)
            self._abuf_cv.notify_all()
        reg.counter("comm.agg_buffer_staged_total",
                    labels={"agg": str(self.agg_id)}).inc()
        reg.gauge("comm.agg_buffer_occupancy",
                  labels={"agg": str(self.agg_id)}).set(staged)
        return ({"meta": {"agg_id": self.agg_id, "staged": staged,
                          "dedup": dup}}, None)

    def _auto_k(self, interval_s: float, slice_devices: int) -> int:  # colearn: holds(_abuf_cv)
        """The slice's K: one partial per ``interval_s`` at its observed
        arrival rate, clamped to the slice size (2^10 when unknown) and
        slew-limited to [K/2, 3K/2] per drain.  Caller holds
        ``_abuf_cv``."""
        hi = max(1, int(slice_devices)) if slice_devices else 1 << 10
        cur = self._abuf_k if self._abuf_k is not None else min(4, hi)
        k = self.arrival.recommend_buffer(interval_s, lo=1, hi=hi,
                                          current=cur)
        k = max(max(1, cur // 2), min(k, max(2, cur * 3 // 2)))
        k = max(1, min(k, hi))
        self._abuf_k = k
        return k

    def _adrain(self, header: dict) -> tuple[dict, Any]:
        """Long-poll: wait until the buffer holds the slice's K (or the
        poll's budget ends), then ship ONE partial with the dispatch
        versions of its contributions; an empty expiry replies
        ``count: 0``."""
        interval = float(header.get("interval_s", 2.0))
        budget = float(header.get("timeout", max(2.0 * interval, 1.0)))
        slice_n = int(header.get("slice_devices", 0))
        deadline = time.monotonic() + budget
        reg = telemetry.get_registry()
        with self._abuf_cv:
            if self._abuf_folder is None:
                return ({"status": "error",
                         "error": "aggregator buffer not prepared "
                                  "(aprep first)"}, None)
            while True:
                k = self._auto_k(interval, slice_n)
                if len(self._abuf_entries) >= k:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0.0:
                    break
                self._abuf_cv.wait(timeout=min(remaining, 0.05))
                if self._abuf_folder is None:
                    return ({"status": "error",
                             "error": "buffer reset mid-drain"}, None)
            rate = self.arrival.rate()
            reg.gauge("comm.agg_buffer_k",
                      labels={"agg": str(self.agg_id)}).set(k)
            reg.gauge("comm.agg_arrival_rate_per_s",
                      labels={"agg": str(self.agg_id)}).set(rate)
            if not self._abuf_entries:
                return ({"meta": {"agg_id": self.agg_id, "count": 0,
                                  "buffer_k": k,
                                  "arrival_rate_per_s": rate}}, None)
            folder = self._abuf_folder
            entries = self._abuf_entries
            dedup = self._abuf_dedup
            # Arrivals racing this drain stage into the NEXT partial.
            self._abuf_folder = self._new_buffer()
            self._abuf_entries = {}
            self._abuf_dedup = 0
        folder.finalize()
        keys = folder.folded_ids     # sorted: version, then device
        devices = [entries[c]["device"] for c in keys]
        versions = [entries[c]["version"] for c in keys]
        weights = [entries[c]["weight"] for c in keys]
        rehomed = sorted({entries[c]["device"] for c in keys
                          if entries[c]["rehomed"]})
        reg.counter("comm.agg_partials_shipped_total",
                    labels={"agg": str(self.agg_id)}).inc()
        reg.counter("comm.agg_folds_total",
                    labels={"agg": str(self.agg_id)}).inc()
        reg.gauge("comm.agg_buffer_occupancy",
                  labels={"agg": str(self.agg_id)}).set(0)
        out_meta = {
            "agg_id": self.agg_id,
            "count": len(keys),
            "keys": keys,
            "devices": devices,
            "versions": versions,
            "weights": weights,
            "rehomed": rehomed,
            "oldest_version": min(versions),
            "total_w": folder.total_w,
            "loss_sum": folder.loss_sum,
            "buffer_k": k,
            "dedup": dedup,
            "fold_s": folder.fold_s,
            "densify_avoided": folder.densify_avoided,
            "arrival_rate_per_s": rate,
        }
        return ({"meta": out_meta}, folder.wsum)

    def _fold(self, header: dict, tree: Any) -> tuple[dict, Any]:
        """Relay the broadcast to this slice's devices under one deadline,
        fold their replies in slice order, reply with ONE partial sum.

        The fold runs under an ``aggregator.fold`` span parented on the
        root's context; each relayed request carries this span's context,
        so the workers' spans parent onto the tier that dispatched them,
        and the reply ships them up with the tier's own spans."""
        if tree is None:
            return ({"status": "error",
                     "error": "fold request carried no params frame"}, None)
        meta_in = header.get("meta") or {}
        r = int(header.get("round", 0))
        devices = header.get("devices") or []
        cohort = header.get("cohort")
        shares_in = header.get("shares_in") or {}
        budget = float(header.get("timeout", 30.0))
        ctx = protocol.extract_trace(header)
        # Serialize-once per tier: one re-encode, shared by every send.
        body = memoryview(pytree_to_bytes(tree, meta_in or None))
        order = [str(int(d[0])) for d in devices]
        # The decoded broadcast is the fold template (only its shapes are
        # read); under LoRA its factor half, since the replies are factor
        # deltas.
        shapes = tree["factors"] if meta_in.get("lora") else tree
        folder = StreamingFolder(shapes, order=order,
                                 device_fold=self._fold_device,
                                 device=self.device)
        stale: list[str] = []
        failed: list[str] = []
        worker_spans: list = []
        deadline = time.monotonic() + budget

        def ask(dev, fold_ctx):
            did, dhost, dport = str(int(dev[0])), str(dev[1]), int(dev[2])
            req = protocol.attach_trace({"op": "train", "round": r},
                                        fold_ctx)
            if cohort is not None:
                req["cohort"] = cohort
            inbox = shares_in.get(did)
            if inbox:
                req["shares_in"] = inbox
            cli = TensorClient(dhost, dport,
                               timeout=protocol.CONNECT_TIMEOUT, ident=did)
            try:
                hdr, delta = cli.request(req, body=body, timeout=budget,
                                         retry=self.retry, deadline=deadline)
                if hdr.get("status") != "ok":
                    raise RuntimeError(f"{did}: {hdr.get('error')}")
                return hdr["meta"], delta
            finally:
                cli.close()

        def take(fut, did):
            try:
                meta, delta = fut.result()
            except Exception:
                failed.append(did)
                return
            # The worker's spans go up with the partial; its train span
            # is the device's round latency for the ledger.
            spans = meta.pop(protocol.TRACE_SPANS_KEY, None) or []
            worker_spans.extend(spans)
            if self.health is not None:
                for sd in spans:
                    if str(sd.get("name")) == "worker.train":
                        self.health.record(
                            did, round=r, agg=str(self.agg_id),
                            latency_s=float(sd.get("duration_s", 0.0)))
            if int(meta.get("round", r)) != r:
                stale.append(str(meta.get("client_id", did)))
                return
            folder.add(meta, delta)

        with self.tracer.capture() as captured:
            with self.tracer.span("aggregator.fold", parent=ctx,
                                  agg=self.agg_id, round=r) as fold_sp:
                # The pool's threads have empty span stacks: they get the
                # fold span's identity explicitly.
                fold_ctx = fold_sp.context
                if devices:
                    with cf.ThreadPoolExecutor(
                            max_workers=len(devices),
                            thread_name_prefix=f"agg{self.agg_id}-fanout"
                    ) as pool:
                        futs = {pool.submit(ask, d, fold_ctx): str(int(d[0]))
                                for d in devices}
                        pending = dict(futs)
                        try:
                            for fut in cf.as_completed(futs, timeout=budget):
                                take(fut, pending.pop(fut))
                        except cf.TimeoutError:
                            pass        # stragglers are charged below
                        for fut, did in pending.items():
                            if fut.done():  # finished in the race window
                                take(fut, did)
                            else:
                                fut.cancel()
                                failed.append(did)
                folder.finalize()
        reg = telemetry.get_registry()
        reg.counter("comm.agg_folds_total",
                    labels={"agg": str(self.agg_id)}).inc()
        reg.histogram("comm.agg_fold_time_s",
                      labels={"agg": str(self.agg_id)}).observe(
                          fold_sp.duration_s)
        failed_ids = sorted(set(failed), key=order.index)
        if self.health is not None:
            for did in failed_ids:
                self.health.record(did, round=r, agg=str(self.agg_id),
                                   deadline_miss=1)
            self.health.flush()
        out_meta = {
            "agg_id": self.agg_id,
            "round": r,
            "total_w": folder.total_w,
            "loss_sum": folder.loss_sum,
            "folded_ids": folder.folded_ids,
            "failed": failed_ids,
            "stale": stale,
            "fold_s": folder.fold_s,
            # The tier's wall time, relay and fold together (the span's
            # clock); fold_s is the part spent inside the folder's add.
            "fold_wall_s": fold_sp.duration_s,
            "densify_avoided": folder.densify_avoided,
        }
        if ctx is not None:
            # The whole tier's trace goes up: the workers' spans and the
            # tier's own (the fold span and anything under it).
            out_meta[protocol.TRACE_SPANS_KEY] = (
                worker_spans + [s.to_dict() for s in captured])
        return {"meta": out_meta}, folder.wsum


def combine_partial_weights(total_ws: Sequence[float]) -> float:
    """The root's sequential sum of partial weights, as JAX's root computes
    it.  Nothing in the port calls it: ``StreamingFolder.add_partial`` runs
    the same sum as it folds the partials; it is kept to hold that
    arithmetic to JAX's in the tests."""
    total = 0.0
    for t in total_ws:
        total += float(t)
    return total


def expected_ingest(cohort: int, n_aggregators: int, update_bytes: int,
                    partial_bytes: int) -> dict:
    """Analytic per-round ingest bill of the tree (shape-only pricing,
    same convention as the wire bench): each aggregator ingests
    ``ceil(C/N)`` device update frames; the root ingests ``N`` partial
    frames instead of ``C`` update frames."""
    per_agg_devices = math.ceil(cohort / max(1, n_aggregators))
    return {
        "agg_ingest_bytes": per_agg_devices * update_bytes,
        "root_ingest_bytes": n_aggregators * partial_bytes,
        "flat_root_ingest_bytes": cohort * update_bytes,
    }


def run_aggregator_forever(config: ExperimentConfig, agg_id: int,
                           broker_host: str, broker_port: int,
                           heartbeat_s: float = 0.5, device=None,
                           stop: Optional[threading.Event] = None
                           ) -> AggregatorServer:
    """Announce, heartbeat and serve folds until ``stop`` is set (never,
    without one); returns the stopped server (its ``tracer`` holds the
    tier's spans)."""
    agg = AggregatorServer(config, agg_id, broker_host, broker_port,
                           heartbeat_s=heartbeat_s, device=device)
    recorder = telemetry.get_flight_recorder()
    if recorder is not None:
        # The recorder's dumps carry this tracer's span tail, so a
        # SIGKILLed aggregator's last folds are attributable.
        recorder.attach_tracer(agg.tracer)
    agg.start()
    try:
        (stop or threading.Event()).wait()
    finally:
        agg.stop()
    return agg


def fetch_aggregators(sub: BrokerClient, known: dict,
                      drain_timeout: float = 0.05) -> dict:
    """Read the retained ``colearn/agg/#`` subscription into ``known``
    (``agg_id -> {"host", "port", "ts"}``, the latest record wins) for at
    most ``drain_timeout`` seconds; the ``ts`` it refreshes is the root's
    liveness signal.  The bound is on the whole read, not on a quiet gap:
    heartbeats closer together than ``drain_timeout`` never leave one."""
    deadline = time.monotonic() + drain_timeout
    while True:
        try:
            header, _ = sub.recv(
                timeout=max(0.0, deadline - time.monotonic()))
        except TimeoutError:
            return known
        if not str(header.get("topic", "")).startswith(AGG_TOPIC):
            continue
        try:
            agg_id = int(header["agg_id"])
            known[agg_id] = {"host": str(header["host"]),
                             "port": int(header["port"]),
                             "ts": float(header.get("ts", 0.0))}
        except (KeyError, TypeError, ValueError):
            protocol.count_suppressed()   # a malformed announce: skipped
            continue
