"""The fleet simulator's round loop: the engine's round over a cohort
processed in fixed-size chunks.

The counterpart of the JAX package's ``fleetsim/sim.py``.  One simulated
round is exactly the engine's round: the same per-(client, round) draws
(``fed/programs.Draws``, keyed on the global device id), the same FedAvg
weighting (``num_examples * contrib``), the same mean +
``strategies.server_update`` epilogue, but the cohort is processed in
FIXED-SIZE chunks:

    cohort -> [chunk_0 | chunk_1 | ...]
    chunk_i: each client's local update -> a weighted partial sum
    fold:    the partial sums add into the round accumulator (on device)

Where JAX vmaps ``local_update`` over a zero-padded chunk, a chunk here
runs its clients one after another through the engine's own local
trainer and keeps the engine's running f32 weighted sum
(``fed/programs.cohort_step``), so a one-chunk round reproduces the
engine's round bit for bit; padding lanes are skipped, not trained.
Memory is O(chunk x shard + model) at any cohort size: only the chunk's
shards are materialized (``population.py``) and moved to the device.
A batched (vmapped) trainer is ROADMAP.md's "batched cohort step" perf
item; this loop is its starting point.

Faults reuse the FaultPlan key space ``(device, round, op)`` with
``op="train"`` (``faults/plan.py``):

- ``drop_request``    -- the device never trains or reports (no uplink);
- ``delay``           -- straggle: the device loses ``ms`` of its
  simulated round deadline, its step budget shrinks proportionally
  (the local trainer stops at the budget; below the completion threshold
  its FedAvg weight zeroes exactly like an engine straggler);
- ``corrupt_payload`` -- the update arrives corrupted and is discarded
  (uplink bytes spent, weight zeroed -- the CRC-reject analog).

NOTE on plan authoring: ``FaultSpec.count`` defaults to 1 (one firing
TOTAL); fleet-wide schedules want explicit ``count=0`` (unlimited) or a
budget sized to the cohort.

With ``run.learn_observe`` the convergence observatory
(``telemetry/convergence.py``) watches the simulated fleet: updates are
simulation-local, so besides the aggregate's signals it attributes
per-device norms (``device_skew``: ``conv_norm_median``, ``_p90``,
``_anomalies``; an anomaly is a ``norm_anomaly`` in the health ledger) and
per-home-class drift (``cohort_skew``) on the synchronous plane, and the
aggregate's signals on the asynchronous planes.

Departures from JAX: nothing is compiled, so there is no
``compile_counts`` (JAX's pad-to-fixed-width invariant has no object
here).  JAX's observed chunk is a separate vmapped program; here the
chunk loop itself keeps, under observation only, each device's update
norm and the per-home-class f32 weighted sums (one bucket for a
``from_learner`` fleet, which has no population), so without the flag
the loop is the one it was.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from colearn_federated_learning_tpu_torch import convert, telemetry
from colearn_federated_learning_tpu_torch.fed import compression, programs
from colearn_federated_learning_tpu_torch.fed import setup as setup_lib
from colearn_federated_learning_tpu_torch.fed import strategies
from colearn_federated_learning_tpu_torch.utils import prng
from colearn_federated_learning_tpu_torch.utils.config import ExperimentConfig
from colearn_federated_learning_tpu_torch.utils.device import resolve_device
from colearn_federated_learning_tpu_torch.utils.serialization import (
    wire_frame_length)

_FLEET_FAULT_KINDS = ("drop_request", "delay", "corrupt_payload")


def _validate_fleet_config(config: ExperimentConfig) -> None:
    """The fleet path is the engine's plain weighted-mean FedAvg family;
    the stateful/privacy variants keep their engine-only homes."""
    setup_lib.require_stateless_strategy(config, "fleetsim")
    setup_lib.require_mean_aggregator(config, "fleetsim")
    c = config.fed
    if c.dp_clip > 0.0 or c.secure_agg:
        raise NotImplementedError(
            "fleetsim does not support dp/secure-agg hooks yet: their "
            "noise accounting and mask pairing assume the engine's "
            "single-program cohort; run the on-device engine")


def _count_fault(kind: str) -> None:
    """Fault-plane telemetry, aggregate only: the comm injector labels
    ``fault.injected_total`` per device, but at fleet scale per-device
    label children would grow the registry O(cohort) per round."""
    reg = telemetry.get_registry()
    reg.counter("fault.injected_total", labels={"kind": kind}).inc()
    reg.counter(f"fault.injected.{kind}").inc()


class _Partial:
    """A weighted partial sum: ``wsum`` (one f32 tensor per parameter),
    ``total_w`` (a Python float, as the engine keeps it), ``loss_sum`` (a
    device f32 scalar) and ``n_comp``."""

    __slots__ = ("wsum", "total_w", "loss_sum", "n_comp")

    def __init__(self, params: list, device):
        self.wsum = [torch.zeros(p.shape, dtype=torch.float32, device=device)
                     for p in params]
        self.total_w = 0.0
        self.loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        self.n_comp = 0

    def fold(self, other: "_Partial") -> None:
        torch._foreach_add_(self.wsum, other.wsum)
        self.total_w += other.total_w
        self.loss_sum += other.loss_sum
        self.n_comp += other.n_comp

    def scale(self, s_w: float) -> None:
        """The asynchronous plane's staleness discount, in f32."""
        torch._foreach_mul_(self.wsum, s_w)
        self.total_w = float(np.float32(self.total_w) * np.float32(s_w))
        self.loss_sum *= s_w


class _Observed:
    """What the chunk loop keeps under ``run.learn_observe`` besides the
    sums: each cohort device's update norm (0 for a non-contributor, in
    cohort order) and the per-home-class f32 weighted delta sums
    (``class_wsum``, a leading class axis) and weights."""

    __slots__ = ("norms", "class_wsum", "class_w")

    def __init__(self, params: list, num_classes: int, device):
        self.norms: list = []
        self.class_wsum = [torch.zeros((num_classes,) + p.shape,
                                       dtype=torch.float32, device=device)
                           for p in params]
        self.class_w = np.zeros(num_classes, np.float32)


class FleetSim:
    """Chunked fleet simulator.

    Build with :meth:`from_population` (synthetic fleet + traffic model,
    the 1k->1M workload) or :meth:`from_learner` (wrap an existing
    one-device :class:`~fed.engine.FederatedLearner`'s data, trainer and
    draws -- the parity harness the chunked path is held to).

    ``draws``: an object with :class:`fed.programs.Draws`'s
    ``batch_indices`` and ``step_budgets`` (tests replay JAX's draws);
    ``device``: where the model, the shards of a chunk and the sums live
    (None: the card, raising without one).
    """

    def __init__(
        self,
        *,
        config: ExperimentConfig,
        local_update: Callable,
        num_steps: int,
        draws,
        server_state,
        shard_fn: Callable[[np.ndarray], tuple],
        budget_fn: Callable[[np.ndarray], np.ndarray],
        select_fn: Callable[[int], np.ndarray],
        num_devices: int,
        cohort_size: int,
        chunk_size: int = 1024,
        fault_plan=None,
        round_deadline_ms: float = 1000.0,
        available_fraction_fn: Optional[Callable[[int], float]] = None,
        device=None,
    ):
        _validate_fleet_config(config)
        self.config = config
        self.device = resolve_device(device)
        self.local_update = local_update
        self.num_steps = int(num_steps)
        self.draws = draws
        self.server_state = server_state
        self._shard_fn = shard_fn
        self._budget_fn = budget_fn
        self._select_fn = select_fn
        self.num_devices = int(num_devices)
        self.cohort_size = int(min(cohort_size, num_devices))
        self.chunk_size = int(min(chunk_size, max(1, self.cohort_size)))
        self.fault_plan = fault_plan
        self.round_deadline_ms = float(round_deadline_ms)
        self._available_fraction_fn = available_fraction_fn
        # Set by from_population; fit_async needs per-device arrival
        # rates, not just the fleet-mean fraction.
        self._traffic = None
        self.history: list[dict] = []
        self.tracer = telemetry.Tracer(process="fleetsim", enabled=False)
        # Per-device health feed (telemetry/health.py): the simulated
        # fleet attributes its injected faults to devices exactly like
        # the socket planes attribute real ones.  Off by default.
        self.health = None
        if config.run.health_dir:
            self.health = telemetry.HealthLedger(config.run.health_dir,
                                                 "fleetsim")
        # The convergence observatory, off by default: without it the
        # chunk loop keeps nothing more and the records their keys.
        self._learn = (telemetry.ConvergenceObservatory()
                       if config.run.learn_observe else None)
        self._population = None           # set by from_population
        self._price_wire()
        reg = telemetry.get_registry()
        reg.gauge("fleetsim.devices").set(self.num_devices)
        reg.gauge("fleetsim.chunk_size").set(self.chunk_size)

    def _price_wire(self) -> None:
        """The wire-cost model (the comm codecs, shape-only, so computed
        once): frame lengths depend on leaf shapes and dtypes, not
        values."""
        config = self.config
        params_np = convert.state_dict_to_flax(
            {n: torch.zeros(t.shape, dtype=torch.float32)
             for n, t in self.server_state.params.items()},
            num_heads=config.model.num_heads)
        zeros = params_np
        self.down_full_bytes = int(wire_frame_length(
            params_np, {"round": 0, "down": "full"}))
        scheme_down = config.fed.compress_down
        if scheme_down == "none":
            self.down_frame_bytes = self.down_full_bytes
        else:
            wire, meta = compression.compress_delta(zeros, scheme_down)
            self.down_frame_bytes = int(wire_frame_length(
                wire, {"round": 0, "down": "delta", **meta}))
        # LoRA pricing (fed/lora.py): with fed.lora_rank > 0 the real
        # wire planes ship FACTOR frames on the uplink, so the byte
        # estimator prices those.  The simulated training stays dense;
        # only the wire-cost model is adapter-aware.
        if config.fed.lora_rank > 0:
            from colearn_federated_learning_tpu_torch.fed import lora as lora_lib

            up_zeros = _numpy_tree(lora_lib.init_factors(
                params_np, config.fed.lora_rank,
                model_name=config.model.name))
        else:
            up_zeros = zeros
        wire_up, meta_up = compression.compress_delta(
            up_zeros, config.fed.compress,
            topk_fraction=config.fed.topk_fraction)
        self.up_frame_bytes = int(wire_frame_length(
            wire_up, {"round": 0, "op": "train", **meta_up}))
        # Per-update bytes a compressed (or factor-only) uplink saves
        # against the dense train frame: the coordinator's
        # comm.bytes_saved_uplink pricing.
        if config.fed.compress == "none" and config.fed.lora_rank == 0:
            self.up_saved_bytes = 0
        else:
            dense_up = int(wire_frame_length(
                zeros, {"round": 0, "op": "train", "compress": "none"}))
            self.up_saved_bytes = max(0, dense_up - self.up_frame_bytes)
        # With run.tp_size > 1 the server encodes each broadcast from
        # per-device shards; the estimator learns the gather bytes
        # AVOIDED per encode, from the partition rules' shape math alone.
        tp = config.run.tp_size
        if tp > 1:
            from colearn_federated_learning_tpu_torch.parallel import partition

            self.gather_avoided_bytes = int(partition.estimate_gather_avoided(
                params_np, partition.rules_for_model(config.model.name),
                config.run.tp_axis, tp))
        else:
            self.gather_avoided_bytes = 0

    # ------------------------------------------------------ constructors --
    @classmethod
    def from_population(
        cls,
        config: ExperimentConfig,
        population,
        traffic,
        cohort_size: int,
        chunk_size: int = 1024,
        fault_plan=None,
        round_deadline_ms: float = 1000.0,
        device=None,
        draws=None,
    ) -> "FleetSim":
        """Synthetic fleet: shards materialize on demand from per-device
        keys (``fleetsim/population.py``), a chunk at a time; the traffic
        model picks each round's cohort among the available devices.  The
        model is the registry's, on ``device``, drawn from the config's
        seed."""
        from colearn_federated_learning_tpu_torch.models import (
            registry as model_registry)

        device = resolve_device(device)
        spec = population.spec
        model = model_registry.build_model(
            setup_lib.local_model_config(config.model), device,
            generator=prng.init_generator(config.run.seed),
            input_shape=(spec.feature_dim,))
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        local_update, num_steps = setup_lib.local_trainer_for_config(
            config, model, spec.shard_capacity, lora_dense_ok=True)
        sim = cls(
            config=config,
            local_update=local_update,
            num_steps=num_steps,
            draws=(draws if draws is not None
                   else programs.Draws(config.run.seed)),
            server_state=strategies.init_server_state(params, config.fed),
            shard_fn=population.materialize,
            budget_fn=lambda ids: population.step_budgets(ids, num_steps),
            select_fn=lambda r: traffic.sample_cohort(r, cohort_size),
            num_devices=spec.num_devices,
            cohort_size=cohort_size,
            chunk_size=chunk_size,
            fault_plan=fault_plan,
            round_deadline_ms=round_deadline_ms,
            available_fraction_fn=lambda r: float(
                traffic.available_mask(r).mean()),
            device=device,
        )
        sim._traffic = traffic
        sim._population = population
        return sim

    @classmethod
    def from_learner(cls, learner, chunk_size: int = 1024,
                     fault_plan=None,
                     round_deadline_ms: float = 1000.0) -> "FleetSim":
        """Wrap a one-device :class:`FederatedLearner`: the same shards
        (its device tensors), the same trainer, the same draws, the same
        cohort ranking, from a copy of its server state -- the ONLY
        difference from ``learner.run_round()`` is the chunked loop,
        which is exactly what the parity tests pin down."""
        if learner.mesh is not None:
            raise NotImplementedError(
                "from_learner wraps the single-device vmap path; shard "
                "the fleet over a mesh via the engine instead")
        s = learner.server_state

        def copy(tree):
            return None if tree is None else {k: v.clone()
                                              for k, v in tree.items()}

        state = strategies.ServerState(
            params=copy(s.params), opt_m=copy(s.opt_m), opt_v=copy(s.opt_v),
            control=copy(s.control), round_idx=s.round_idx)

        def shard_slices(ids: np.ndarray) -> tuple:
            idx = torch.as_tensor(ids, device=learner.device)
            return learner.x[idx], learner.y[idx], learner.counts[ids]

        num_steps = learner.num_steps
        return cls(
            config=learner.config,
            local_update=learner.local_update,
            num_steps=num_steps,
            draws=learner.draws,
            server_state=state,
            shard_fn=shard_slices,
            budget_fn=lambda ids: np.full(ids.shape[0], num_steps, np.int32),
            select_fn=lambda r: programs.sample_cohort(learner, r),
            num_devices=learner.num_clients,
            cohort_size=learner.cohort_size,
            chunk_size=chunk_size,
            fault_plan=fault_plan,
            round_deadline_ms=round_deadline_ms,
            device=learner.device,
        )

    def load_flax_params(self, flax_params) -> None:
        """Start from parameters in the JAX package's flax layout (a nested
        dict of numpy arrays), converted exactly by ``convert.py``."""
        sd = convert.flax_to_state_dict(flax_params)
        names = list(self.server_state.params)
        if sorted(sd) != sorted(names):
            raise ValueError(f"flax params do not match the model: "
                             f"{sorted(set(sd) ^ set(names))}")
        self.server_state = strategies.init_server_state(
            {n: sd[n].to(self.device, torch.float32).clone() for n in names},
            self.config.fed)

    # ------------------------------------------------------------ chunks --
    def _train_chunk(self, params: list, ids: np.ndarray, round_idx: int,
                     budgets: np.ndarray, keep: np.ndarray,
                     obs: Optional[_Observed] = None,
                     classes: Optional[np.ndarray] = None) -> _Partial:
        """One chunk's training and weighting: every device of ``ids``
        runs the engine's local update from ``params`` in order, and its
        update joins the chunk's running weighted sum as in
        ``fed/programs.cohort_step``; a device with a zero budget (dropped,
        or delayed past its whole deadline) is skipped, since it would run
        no step and add nothing.  The engine's simulated stragglers
        (``straggler_prob``), keyed on the global device ids, cap
        ``budgets`` from below.  With ``obs`` (under observation) each
        device's update norm and its weighted delta in its home class's
        row (``classes``) are kept too."""
        fed = self.config.fed
        dev = self.device
        if fed.straggler_prob > 0.0:
            budgets = np.minimum(budgets, self.draws.step_budgets(
                round_idx, ids, self.num_steps, fed.straggler_prob))
        lr_scale = strategies.lr_scale_for_round(fed, round_idx)
        part = _Partial(params, dev)
        run = [j for j in range(len(ids)) if budgets[j] > 0]
        if obs is not None:
            # Every device's norm, 0 until it contributes; kept in
            # cohort order.
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            at = len(obs.norms)
            obs.norms.extend([zero] * len(ids))
        if not run:
            return part
        x, y, counts = self._shard_fn(ids[run])
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev).long()
        for k, j in enumerate(run):  # colearn: hot
            count = int(counts[k])
            idx = self.draws.batch_indices(round_idx, int(ids[j]), count,
                                           self.num_steps, fed.batch_size)
            idx = torch.as_tensor(idx, dtype=torch.long).to(
                dev, non_blocking=True)
            res = self.local_update(  # colearn: noqa(CL009): one client at a time on purpose, the engine's bitwise order; ROADMAP's batched cohort step replaces this loop
                params, x[k], y[k], count, idx, int(budgets[j]), lr_scale)
            contrib = bool(res.completed and res.num_examples > 0
                           and keep[j])
            weight = float(res.num_examples) if contrib else 0.0  # colearn: noqa(CL006): num_examples is a host int, no device read
            if contrib:
                wd = torch._foreach_mul(res.delta, weight)
                torch._foreach_add_(part.wsum, wd)
                if obs is not None:
                    c = int(classes[j])
                    torch._foreach_add_([w[c] for w in obs.class_wsum], wd)
                    obs.class_w[c] += np.float32(weight)
                    obs.norms[at + j] = torch.stack(
                        torch._foreach_norm(res.delta)).square().sum().sqrt()
            part.total_w += weight
            part.loss_sum += res.mean_loss * weight
            part.n_comp += int(contrib)
            del res
        return part

    def _finish(self, acc: _Partial) -> dict:
        """The engine's round epilogue (``fed/programs.finish_round``,
        plain path): the mean, then the server step; a round with no
        contributor steps with a zero delta (a no-op for the FedAvg
        family).  Metrics as device scalars and ints."""
        fed = self.config.fed
        total_w = acc.total_w
        denom = np.float32(total_w) if total_w > 0 else np.float32(1.0)
        scale = float(np.float32(1.0) / denom) if total_w > 0 else 0.0
        torch._foreach_mul_(acc.wsum, scale)
        names = list(self.server_state.params)
        strategies.server_update(self.server_state,
                                 dict(zip(names, acc.wsum)), fed)
        return {"train_loss": acc.loss_sum / float(denom),
                "completed": acc.n_comp, "total_weight": total_w}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ faults --
    def _resolve_faults(self, ids: np.ndarray, round_idx: int):
        """Host-side fault resolution for the round cohort: one
        ``plan.match`` per cohort device on the ``(device, round,
        op="train")`` key -- the same key space the transport injector
        consumes (faults/inject.py), so one plan drives every plane.
        Returns ``(keep_weight, trains, uplink_ok, lost_ms, stats)``."""
        n = ids.shape[0]
        keep = np.ones(n, bool)          # contributes to the aggregate
        uplink = np.ones(n, bool)        # spends uplink bytes
        trains = np.ones(n, bool)        # runs local training at all
        lost_ms = np.zeros(n, np.float64)
        plan = self.fault_plan
        if plan is None:
            from colearn_federated_learning_tpu_torch.faults import inject

            plan = inject.active_plan()
        stats = {"dropped": 0, "straggled": 0, "corrupted": 0}
        if plan is None:
            return keep, trains, uplink, lost_ms, stats
        for j in range(n):
            did = str(int(ids[j]))
            fired = plan.match(did, round_idx, "train",
                               kinds=_FLEET_FAULT_KINDS, site="server")
            for f in fired:
                _count_fault(f.kind)
                if f.kind == "drop_request":
                    keep[j] = uplink[j] = trains[j] = False
                    stats["dropped"] += 1
                    if self.health is not None:
                        self.health.record(did, round=round_idx,
                                           deadline_miss=1)
                elif f.kind == "delay":
                    lost_ms[j] += f.ms
                    stats["straggled"] += 1
                    if self.health is not None:
                        # The injected delay IS this device's observed
                        # extra latency in the simulated plane.
                        self.health.record(did, round=round_idx,
                                           latency_s=f.ms / 1000.0)
                elif f.kind == "corrupt_payload":
                    keep[j] = False
                    stats["corrupted"] += 1
                    if self.health is not None:
                        self.health.record(did, round=round_idx,
                                           corrupt_frame=1)
        return keep, trains, uplink, lost_ms, stats

    # ------------------------------------------------------------- round --
    def run_round(self) -> dict:
        """One simulated federated round over a traffic-sampled cohort;
        ``round_time_s`` runs to a device sync."""
        r = len(self.history)
        t0 = time.perf_counter()
        reg = telemetry.get_registry()
        with self.tracer.span("fleet_round", round=r):
            with self.tracer.span("cohort_sample", round=r):
                ids = np.asarray(self._select_fn(r), np.int64)
            keep_w, trains, uplink, lost_ms, fstats = self._resolve_faults(
                ids, r)
            budgets = self._budget_fn(ids).astype(np.int32)
            if np.any(lost_ms > 0):
                frac = np.clip(1.0 - lost_ms / self.round_deadline_ms,
                               0.0, 1.0)
                budgets = np.minimum(
                    budgets, np.floor(frac * self.num_steps)).astype(
                        np.int32)
            # Dropped devices never train: zero budget AND zero weight.
            budgets = np.where(trains, budgets, 0)

            n = ids.shape[0]
            chunk = self.chunk_size
            padded = max(chunk, ((n + chunk - 1) // chunk) * chunk)
            params = list(self.server_state.params.values())
            acc = _Partial(params, self.device)
            obs = classes = None
            if self._learn is not None:
                pop = self._population
                obs = _Observed(params, pop.spec.num_classes if pop else 1,
                                self.device)
                classes = (pop.home_classes(ids) if pop is not None
                           else np.zeros(n, np.int32))
            with self.tracer.span("train_chunks", round=r, cohort=n,
                                  chunks=padded // chunk):
                if n:
                    for lo in range(0, padded, chunk):  # colearn: hot
                        # Child span per chunk: trace-summary renders the
                        # sweep's phase mix instead of one opaque block.
                        with self.tracer.span("train_chunk", round=r,
                                              chunk=lo // chunk):
                            sl = slice(lo, min(lo + chunk, n))
                            acc.fold(self._train_chunk(
                                params, ids[sl], r, budgets[sl],
                                keep_w[sl], obs,
                                None if classes is None else classes[sl]))
            with self.tracer.span("server_update", round=r) as up_sp:
                metrics = self._finish(acc)
                out = {k: float(v) for k, v in metrics.items()}
                conv_sig = None
                if obs is not None:
                    conv_sig = self._learn_round_feed(r, ids, acc.wsum,
                                                      up_sp, obs)
                self._sync()

        n_trained = int(trains.sum())
        n_reporting = int(uplink.sum())
        bytes_down = n_trained * self.down_frame_bytes
        bytes_up = n_reporting * self.up_frame_bytes
        out.update(
            round=r,
            cohort=n,
            cohort_requested=self.cohort_size,
            clients_trained=n_trained,
            bytes_down_est=bytes_down,
            bytes_up_est=bytes_up,
            **fstats,
        )
        if conv_sig:
            # The conv_* keys only under learn_observe.
            out.update(conv_sig)
        if self.gather_avoided_bytes:
            # Key present only under a sharded server (tp_size > 1): one
            # broadcast encode per round, one avoidance charge.
            out["bytes_gather_avoided_est"] = self.gather_avoided_bytes
            reg.counter("fleetsim.bytes_gather_avoided_est_total").inc(
                self.gather_avoided_bytes)
        if self.up_saved_bytes:
            bytes_up_saved = n_reporting * self.up_saved_bytes
            out["bytes_up_saved_est"] = bytes_up_saved
            reg.counter("fleetsim.bytes_up_saved_est_total").inc(
                bytes_up_saved)
        if self._available_fraction_fn is not None:
            frac = self._available_fraction_fn(r)
            out["available_fraction"] = frac
            reg.gauge("fleetsim.available_fraction").set(frac)
        out["round_time_s"] = time.perf_counter() - t0
        if self.health is not None:
            # Durable once per round; health_* keys only when the plane
            # is on (default records stay byte-identical).
            self.health.flush()
            out.update(telemetry.health_record_keys(self.health.devices()))
        reg.counter("fleetsim.rounds_total").inc()
        reg.counter("fleetsim.clients_trained_total").inc(n_trained)
        reg.counter("fleetsim.bytes_down_est_total").inc(bytes_down)
        reg.counter("fleetsim.bytes_up_est_total").inc(bytes_up)
        reg.histogram("fleetsim.round_time_s").observe(out["round_time_s"])
        self.history.append(out)
        return out

    def _learn_round_feed(self, r: int, ids: np.ndarray, mean_delta: list,
                          span, obs: _Observed) -> Optional[dict]:
        """The round's learning signals: the aggregate's norm, cosine and
        trend from the observatory, the per-device skew (an anomalous
        norm is a ``norm_anomaly`` in the health ledger), the per-cohort
        drift (with a population), the span's attributes and the
        ``learn.*`` export; returns the record's ``conv_*`` dict."""
        from colearn_federated_learning_tpu_torch.telemetry import (
            convergence)

        sig = self._learn.observe(mean_delta, lr=self.config.fed.server_lr)
        if sig is None:
            return None
        if obs.norms:
            norms = torch.stack(obs.norms).cpu().numpy()
            contributors = norms > 0.0
            if contributors.any():
                sk = convergence.device_skew(norms[contributors])
                sig["conv_norm_median"] = round(sk["median"], 8)
                sig["conv_norm_p90"] = round(sk["p90"], 8)
                sig["conv_norm_anomalies"] = len(sk["anomalies"])
                if self.health is not None and sk["anomalies"]:
                    cids = ids[contributors]
                    for idx in sk["anomalies"]:
                        self.health.record(str(int(cids[idx])), round=r,
                                           norm_anomaly=1)
            if self._population is not None:
                sig.update(convergence.cohort_skew(
                    obs.class_wsum, obs.class_w, mean_delta))
        span.attrs["conv_update_norm"] = sig["conv_update_norm"]
        span.attrs["conv_trend"] = sig["conv_trend"]
        if "conv_cos_prev" in sig:
            span.attrs["conv_cos_prev"] = sig["conv_cos_prev"]
        self._learn.export_metrics(telemetry.get_registry(), sig)
        return sig

    def _learn_async(self, mean_delta: list, reg) -> Optional[dict]:
        """An asynchronous aggregation's signals (the aggregate's only,
        as JAX's), exported to ``learn.*``; None when off."""
        if self._learn is None:
            return None
        sig = self._learn.observe(mean_delta, lr=self.config.fed.server_lr)
        if sig:
            self._learn.export_metrics(reg, sig)
        return sig

    def fit(self, rounds: int, log_fn=None) -> list[dict]:
        for _ in range(rounds):
            rec = self.run_round()
            if log_fn is not None:
                log_fn(rec)
        return self.history

    # ------------------------------------------------------------- async --
    def _async_arrival_wait(self, rng, ids: np.ndarray,
                            now_min: float) -> np.ndarray:
        """Minutes until each device's NEXT check-in, drawn from the
        diurnal-Poisson traffic model at sim time ``now_min``: the
        per-device arrival rate is recovered from the model's window
        probability (p = 1 - exp(-rate * window)), so the async plane
        consumes the exact rates the sync cohort sampler does."""
        spec = self._traffic.spec
        rnd = int(now_min / spec.round_minutes)
        p = np.clip(self._traffic.availability_probability(rnd, ids),
                    1e-6, 1.0 - 1e-9)
        rate_per_min = -np.log1p(-p) / spec.round_minutes
        return rng.exponential(1.0, size=ids.shape[0]) / rate_per_min

    def _snapshot(self) -> list:
        """A copy of the current params: the server step updates them in
        place, and an update dispatched at this version trains from it."""
        return [p.clone() for p in self.server_state.params.values()]

    def _fold_versions(self, batch: list, ring: dict,
                       scale_of: Optional[Callable[[int], float]]):
        """Train and fold a buffer of ``(device, version)`` updates grouped
        by dispatch version (each group from its ring snapshot, at its
        version's round index), each group's partial scaled by
        ``scale_of(version)`` (unscaled when None)."""
        acc = _Partial(list(self.server_state.params.values()), self.device)
        for v in sorted({v for _, v in batch}):
            ids = np.asarray([d for d, dv in batch if dv == v], np.int64)
            part = self._train_chunk(
                ring[v], ids, v, self._budget_fn(ids).astype(np.int32),
                np.ones(ids.shape[0], bool))
            if scale_of is not None:
                part.scale(scale_of(v))
            acc.fold(part)
        return acc

    def _async_setup(self, straggler_fraction: float,
                     straggler_multiplier: float):
        """The seeded service times (sim minutes) and the event heap with
        every device's first arrival, drawn as JAX's ``fit_async`` draws
        them: per-device lognormal service around the traffic window,
        chronic stragglers at the head of a permutation."""
        import heapq

        n_dev = self.num_devices
        spec = self._traffic.spec
        rng = np.random.default_rng(
            np.random.SeedSequence([self.config.run.seed, 0xA51C]))
        service = spec.round_minutes * rng.lognormal(
            0.0, 0.5, size=n_dev)
        n_slow = int(round(straggler_fraction * n_dev))
        slow_ids = rng.permutation(n_dev)[:n_slow]
        service[slow_ids] *= straggler_multiplier
        heap: list = []          # (t_done, seq, device_id, version)
        all_ids = np.arange(n_dev, dtype=np.int64)
        wait0 = self._async_arrival_wait(rng, all_ids, 0.0)
        for d in range(n_dev):
            heapq.heappush(heap, (wait0[d] + service[d], d, d, 0))
        return rng, service, heap

    def _require_traffic(self) -> None:
        if self._traffic is None:
            raise NotImplementedError(
                "fit_async needs the traffic model: build the sim with "
                "FleetSim.from_population")

    def fit_async(
        self,
        aggregations: int,
        buffer_size=32,
        *,
        staleness_exponent: float = 0.5,
        max_staleness: int = 10,
        prune_after: int = 0,
        probation: int = 8,
        straggler_fraction: float = 0.05,
        straggler_multiplier: float = 20.0,
        observe: bool = False,
        auto_interval_min: Optional[float] = None,
        aggregators: int = 0,
        log_fn=None,
    ) -> list[dict]:
        """Buffered-asynchronous simulation (FedBuff semantics over the
        chunked path): devices check in on the diurnal-Poisson traffic
        model, train against the model version current at dispatch, and
        the server folds every ``buffer_size`` completions with staleness
        weights ``(1 + tau)^(-staleness_exponent)``, discarding updates
        staler than ``max_staleness``.

        The event clock is virtual (sim minutes): per-device service time
        is lognormal around the traffic model's round window, with a
        seeded ``straggler_fraction`` of chronic stragglers at
        ``straggler_multiplier`` x.  Every draw is JAX's (the same numpy
        generator and order), so the event schedule -- arrivals, buffer
        sizes, staleness, discards, pruning -- is JAX's exactly.

        ``prune_after`` > 0: a device whose updates are discarded
        too-stale ``prune_after`` times consecutively stops being
        re-dispatched for ``probation`` aggregations.  The buffer folds
        grouped by dispatch version, each group trained from its version's
        snapshot.  ``buffer_size="auto"`` sizes K from the seeded-EWMA
        arrival-rate estimator before every aggregation (K = observed
        rate x fold fraction x ``auto_interval_min``, default
        ``round_minutes``; resizes slew-limited to +-50%).  ``observe``
        stamps the observatory keys (staleness tail, contribution mass,
        EWMA arrival rate) into records; implied by auto-K.

        ``aggregators`` > 0 switches to the TWO-TIER tree
        (:meth:`_fit_async_tree`)."""
        import heapq

        if aggregators:
            return self._fit_async_tree(
                aggregations, aggregators, buffer_size,
                staleness_exponent=staleness_exponent,
                max_staleness=max_staleness, prune_after=prune_after,
                probation=probation,
                straggler_fraction=straggler_fraction,
                straggler_multiplier=straggler_multiplier,
                auto_interval_min=auto_interval_min, log_fn=log_fn)
        self._require_traffic()
        n_dev = self.num_devices
        auto_buffer = isinstance(buffer_size, str)
        if auto_buffer:
            if buffer_size != "auto":
                raise ValueError(
                    f"buffer_size must be an int >= 1 or 'auto', "
                    f"got {buffer_size!r}")
            buffer_size = min(8, n_dev)   # warm-start K
        elif buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        if buffer_size > n_dev:
            raise ValueError(
                f"buffer_size {buffer_size} exceeds the {n_dev}-device "
                "fleet -- the buffer could never fill")
        if buffer_size > self.chunk_size:
            raise ValueError(
                f"buffer_size {buffer_size} exceeds chunk_size "
                f"{self.chunk_size} -- the version-grouped fold trains "
                "each group as one chunk")
        observe = bool(observe) or auto_buffer
        spec = self._traffic.spec
        if auto_interval_min is None:
            auto_interval_min = spec.round_minutes
        # Arrival-rate estimator on the VIRTUAL clock (sim minutes).
        est = telemetry.ArrivalEstimator()
        rng, service, heap = self._async_setup(straggler_fraction,
                                               straggler_multiplier)
        reg = telemetry.get_registry()
        reg.gauge("fleetsim.async_buffer_size").set(buffer_size)

        version = 0
        ring: dict[int, list] = {0: self._snapshot()}
        seq = n_dev
        now = 0.0
        arrivals = 0
        wasted = 0
        stale_streak: dict[int, int] = {}
        pruned: dict[int, int] = {}   # device -> aggregation to re-admit
        pruned_total = 0
        base_len = len(self.history)
        start = time.perf_counter()

        def redispatch(d: int, t: float) -> None:
            nonlocal seq
            wait = float(self._async_arrival_wait(
                rng, np.asarray([d], np.int64), t)[0])
            heapq.heappush(heap, (t + wait + service[d], seq, d, version))
            seq += 1

        for agg in range(aggregations):
            t0 = time.perf_counter()
            # Probation re-admission first: a re-admitted device rejoins
            # the arrival stream at the current version, clean streak.
            for d in [d for d, until in pruned.items() if until <= agg]:
                del pruned[d]
                stale_streak.pop(d, None)
                redispatch(d, now)
            if auto_buffer:
                # K from the observed arrival rate: one fold per
                # auto_interval_min, scaled by the observed fold fraction,
                # clamped to the active fleet and the chunk.
                fold_frac = 1.0 - wasted / arrivals if arrivals else 1.0
                k = est.recommend_buffer(
                    auto_interval_min * max(fold_frac, 0.05), lo=1,
                    hi=max(1, min(self.chunk_size, n_dev - len(pruned))),
                    current=buffer_size)
                # Slew-limit the resize: the rate estimate trails the
                # diurnal swing by one fill.
                k = int(np.clip(k, max(1, buffer_size // 2),
                                max(2, buffer_size * 3 // 2)))
                if k != buffer_size:
                    reg.counter(
                        "fleetsim.async_buffer_resizes_total").inc()
                    buffer_size = k
                reg.gauge("fleetsim.async_buffer_size").set(buffer_size)
            buffered: list[tuple[int, int]] = []   # (device, version)
            discarded = 0
            mass_folded = 0.0
            mass_discarded = 0.0
            while len(buffered) < buffer_size:
                t_done, _, d, v = heapq.heappop(heap)
                now = max(now, t_done)
                arrivals += 1
                est.observe(str(d), now=now)
                tau = version - v
                if tau > max_staleness:
                    # Too stale: wasted compute + uplink.
                    discarded += 1
                    wasted += 1
                    s_w = float((1.0 + tau) ** -staleness_exponent)
                    mass_discarded += s_w
                    reg.counter(
                        "fleetsim.async_contribution_mass",
                        labels={"outcome": "discarded"}).inc(s_w)
                    reg.histogram(
                        "fleetsim.async_staleness",
                        labels={"outcome": "discarded"}).observe(
                            float(tau))
                    reg.counter(
                        "fleetsim.async_updates_discarded_total").inc()
                    streak = stale_streak.get(d, 0) + 1
                    stale_streak[d] = streak
                    if (prune_after > 0 and streak >= prune_after
                            and n_dev - len(pruned) - 1 >= buffer_size):
                        pruned[d] = agg + probation
                        pruned_total += 1
                        reg.counter(
                            "fleetsim.async_devices_pruned_total").inc()
                    else:
                        redispatch(d, now)
                    continue
                stale_streak.pop(d, None)
                s_w = float((1.0 + tau) ** -staleness_exponent)
                mass_folded += s_w
                reg.counter("fleetsim.async_contribution_mass",
                            labels={"outcome": "folded"}).inc(s_w)
                reg.histogram("fleetsim.async_staleness",
                              labels={"outcome": "folded"}).observe(
                                  float(tau))
                buffered.append((d, v))

            # Fold the buffer grouped by dispatch version, each group
            # discounted by its own staleness.
            stalenesses = [version - v for _, v in buffered]
            acc = self._fold_versions(
                buffered, ring,
                lambda v: float((1.0 + (version - v)) ** -staleness_exponent))
            metrics = self._finish(acc)
            out = {k: float(x) for k, x in metrics.items()}
            conv_sig = self._learn_async(acc.wsum, reg)
            version += 1
            ring[version] = self._snapshot()
            for v in [v for v in ring if v < version - max_staleness]:
                del ring[v]
            for d, _ in buffered:
                redispatch(d, now)

            rec = {
                "aggregation": base_len + agg,
                "model_version": version,
                "buffer_size": buffer_size,
                "staleness_mean": float(np.mean(stalenesses)),
                "staleness_max": int(np.max(stalenesses)),
                "discarded": discarded,
                "contributors": len(buffered),
                "train_loss": out["train_loss"],
                "total_weight": out["total_weight"],
                "sim_time_min": now,
                "arrival_rate_per_min": arrivals / max(now, 1e-9),
                "agg_rate_per_min": (agg + 1) / max(now, 1e-9),
                "wasted_updates_total": wasted,
                "agg_time_s": time.perf_counter() - t0,
            }
            reg.gauge("fleetsim.async_arrival_rate_per_min").set(
                est.rate())
            if observe:
                _observe_keys(rec, reg, est.rate(), mass_folded,
                              mass_discarded)
            if prune_after > 0:
                rec["pruned"] = len(pruned)
                rec["pruned_total"] = pruned_total
            if conv_sig:
                rec.update(conv_sig)
            reg.counter("fleetsim.async_aggregations_total").inc()
            self.history.append(rec)
            if log_fn is not None:
                log_fn(rec)
        reg.gauge("fleetsim.async_sim_minutes").set(now)
        reg.histogram("fleetsim.round_time_s").observe(
            time.perf_counter() - start)
        return self.history

    def _fit_async_tree(
        self,
        aggregations: int,
        aggregators: int,
        buffer_size,
        *,
        staleness_exponent: float,
        max_staleness: int,
        prune_after: int,
        probation: int,
        straggler_fraction: float,
        straggler_multiplier: float,
        auto_interval_min: Optional[float],
        log_fn,
    ) -> list[dict]:
        """Two-tier buffered-async: per-slice aggregator buffers over the
        same virtual event clock as :meth:`fit_async`.

        Devices are sliced across ``aggregators`` by SERVICE TIME (sorted,
        contiguous divmod), which concentrates chronic stragglers in the
        last slice.  Each slice runs its own ``ArrivalEstimator`` and
        auto-K buffer (slew-limited to +-50% per retune): one partial per
        ``auto_interval_min`` of that slice's measured arrival rate.

        A full slice buffer ships a PARTIAL: its version groups fold
        UNSCALED at the edge, and the root scales the whole partial by
        ``(1 + tau)^-exp`` where ``tau`` is measured against the
        partial's OLDEST constituent version.  A partial whose oldest
        constituent exceeds ``max_staleness`` is discarded WHOLE
        (``fleetsim.async_partials_discarded_total``); one root
        aggregation applies one surviving partial.

        ``agg_fold_tracking_min`` is the worst slice's ``min(r, 1/r)`` for
        ``r`` = realized mean ship interval / the interval auto-K can
        deliver."""
        import heapq

        self._require_traffic()
        n_dev = self.num_devices
        if aggregators < 2:
            raise ValueError(
                f"tree-async needs >= 2 aggregators, got {aggregators}")
        if aggregators > n_dev:
            raise ValueError(
                f"{aggregators} aggregators exceed the {n_dev}-device "
                "fleet -- a slice would be empty")
        warm = 8 if isinstance(buffer_size, str) else int(buffer_size)
        if not isinstance(buffer_size, str) and buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        spec = self._traffic.spec
        if auto_interval_min is None:
            auto_interval_min = spec.round_minutes
        rng, service, heap = self._async_setup(straggler_fraction,
                                               straggler_multiplier)
        reg = telemetry.get_registry()

        # Service-time-sorted contiguous slices: slice 0 gets the fast
        # devices, the last slice the stragglers (deep buffer).
        order = np.argsort(service, kind="stable")
        base, extra = divmod(n_dev, aggregators)
        slice_of = np.empty(n_dev, np.int64)
        slice_ids: list[np.ndarray] = []
        pos = 0
        for a in range(aggregators):
            size = base + (1 if a < extra else 0)
            members = order[pos:pos + size]
            slice_of[members] = a
            slice_ids.append(members)
            pos += size

        ests = [telemetry.ArrivalEstimator() for _ in range(aggregators)]
        ks = [max(1, min(warm, len(slice_ids[a]), self.chunk_size))
              for a in range(aggregators)]
        buffers: list[list[tuple[int, int]]] = [[] for _ in
                                                range(aggregators)]
        ship_times: list[list[float]] = [[] for _ in range(aggregators)]

        version = 0
        ring: dict[int, list] = {0: self._snapshot()}
        seq = n_dev
        now = 0.0
        arrivals = 0
        wasted = 0
        stale_streak: dict[int, int] = {}
        pruned: dict[int, int] = {}   # device -> aggregation to re-admit
        pruned_total = 0
        base_len = len(self.history)
        start = time.perf_counter()

        def redispatch(d: int, t: float) -> None:
            nonlocal seq
            wait = float(self._async_arrival_wait(
                rng, np.asarray([d], np.int64), t)[0])
            heapq.heappush(heap, (t + wait + service[d], seq, d, version))
            seq += 1

        def active(a: int) -> int:
            return sum(1 for d in slice_ids[a] if int(d) not in pruned)

        def retune(a: int) -> None:
            # Auto-K on the slice's OWN arrival rate, slew-limited.
            cur = ks[a]
            hi = max(1, min(self.chunk_size, active(a)))
            k = ests[a].recommend_buffer(auto_interval_min, lo=1, hi=hi,
                                         current=cur)
            k = int(np.clip(k, max(1, cur // 2), max(2, cur * 3 // 2)))
            k = max(1, min(k, hi))
            if k != cur:
                reg.counter("fleetsim.async_buffer_resizes_total").inc()
            ks[a] = k

        def tracking_min() -> float:
            # Realized mean ship interval (the last 5) against the
            # interval auto-K can deliver for the slice: the target
            # clipped into [1/rate, hi/rate].
            vals = []
            for a in range(aggregators):
                rate = ests[a].rate()
                hi = max(1, min(self.chunk_size, active(a)))
                t_eff = auto_interval_min
                if rate > 0:
                    t_eff = float(np.clip(auto_interval_min,
                                          1.0 / rate, hi / rate))
                ts = ship_times[a][-6:]
                if len(ts) >= 2:
                    realized = (ts[-1] - ts[0]) / (len(ts) - 1)
                    r = realized / max(t_eff, 1e-9)
                    vals.append(min(r, 1.0 / r) if r > 0 else 0.0)
                elif len(ts) == 1:
                    vals.append(1.0)   # one ship -- no interval yet
                else:
                    # Never shipped: on cadence only while younger than
                    # two achievable intervals.
                    vals.append(1.0 if now <= 2 * t_eff else 0.0)
            return round(min(vals), 6)

        for agg in range(aggregations):
            t0 = time.perf_counter()
            for d in [d for d, until in pruned.items() if until <= agg]:
                del pruned[d]
                stale_streak.pop(d, None)
                redispatch(d, now)
            discarded_partials = 0
            mass_folded = 0.0
            mass_discarded = 0.0
            while True:
                # Pump arrivals into slice buffers until one fills.
                while True:
                    t_done, _, d, v = heapq.heappop(heap)
                    now = max(now, t_done)
                    arrivals += 1
                    a = int(slice_of[d])
                    ests[a].observe(str(d), now=now)
                    buffers[a].append((int(d), int(v)))
                    if len(buffers[a]) >= ks[a]:
                        break
                batch, buffers[a] = buffers[a], []
                k_ship = ks[a]
                ship_times[a].append(now)
                retune(a)
                oldest = min(v for _, v in batch)
                tau = version - oldest
                s_w = float((1.0 + tau) ** -staleness_exponent)
                if tau > max_staleness:
                    # Whole-partial discard: the root cannot unpick one
                    # constituent out of a pre-folded sum.
                    discarded_partials += 1
                    wasted += len(batch)
                    reg.counter(
                        "fleetsim.async_partials_discarded_total").inc()
                    for dd, dv in batch:
                        dtau = version - dv
                        dw = float((1.0 + dtau) ** -staleness_exponent)
                        mass_discarded += dw
                        reg.counter(
                            "fleetsim.async_contribution_mass",
                            labels={"outcome": "discarded"}).inc(dw)
                        reg.histogram(
                            "fleetsim.async_staleness",
                            labels={"outcome": "discarded"}).observe(
                                float(dtau))
                        reg.counter(
                            "fleetsim.async_updates_discarded_total").inc()
                        # Prune streaks accrue only to devices whose OWN
                        # contribution was too stale.
                        if dtau > max_staleness:
                            streak = stale_streak.get(dd, 0) + 1
                            stale_streak[dd] = streak
                        else:
                            streak = 0
                        if (prune_after > 0 and streak >= prune_after
                                and active(a) > 1):
                            pruned[dd] = agg + probation
                            pruned_total += 1
                            reg.counter(
                                "fleetsim.async_devices_pruned_total"
                            ).inc()
                        else:
                            redispatch(dd, now)
                    continue
                break

            # Fold the partial: version groups UNSCALED at the edge, then
            # one root-side discount keyed off its oldest constituent.
            stalenesses = [version - v for _, v in batch]
            acc = self._fold_versions(batch, ring, None)
            acc.scale(s_w)
            metrics = self._finish(acc)
            out = {k: float(x) for k, x in metrics.items()}
            conv_sig = self._learn_async(acc.wsum, reg)
            for dd, dv in batch:
                stale_streak.pop(dd, None)
                dtau = version - dv
                dw = float((1.0 + dtau) ** -staleness_exponent)
                mass_folded += dw
                reg.counter("fleetsim.async_contribution_mass",
                            labels={"outcome": "folded"}).inc(dw)
                reg.histogram("fleetsim.async_staleness",
                              labels={"outcome": "folded"}).observe(
                                  float(dtau))
            reg.counter("fleetsim.async_partials_folded_total").inc()
            version += 1
            ring[version] = self._snapshot()
            for v in [v for v in ring if v < version - max_staleness]:
                del ring[v]
            for dd, _ in batch:
                redispatch(dd, now)

            rec = {
                "aggregation": base_len + agg,
                "model_version": version,
                "buffer_size": k_ship,
                "staleness_mean": float(np.mean(stalenesses)),
                "staleness_max": int(np.max(stalenesses)),
                "discarded": discarded_partials,
                "contributors": len(batch),
                "train_loss": out["train_loss"],
                "total_weight": out["total_weight"],
                "sim_time_min": now,
                "arrival_rate_per_min": arrivals / max(now, 1e-9),
                "agg_rate_per_min": (agg + 1) / max(now, 1e-9),
                "wasted_updates_total": wasted,
                "agg_time_s": time.perf_counter() - t0,
                # Tree keys (absent from flat async records).
                "aggregators": aggregators,
                "agg_id": int(a),
                "agg_buffer_k": int(ks[a]),
                "agg_fold_tracking_min": tracking_min(),
            }
            rate = sum(e.rate() for e in ests)
            reg.gauge("fleetsim.async_buffer_size").set(ks[a])
            reg.gauge("fleetsim.async_arrival_rate_per_min").set(rate)
            # Tree mode is always auto-K, which implies observe.
            _observe_keys(rec, reg, rate, mass_folded, mass_discarded)
            if prune_after > 0:
                rec["pruned"] = len(pruned)
                rec["pruned_total"] = pruned_total
            if conv_sig:
                rec.update(conv_sig)
            reg.counter("fleetsim.async_aggregations_total").inc()
            self.history.append(rec)
            if log_fn is not None:
                log_fn(rec)
        reg.gauge("fleetsim.async_sim_minutes").set(now)
        reg.histogram("fleetsim.round_time_s").observe(
            time.perf_counter() - start)
        return self.history


def _observe_keys(rec: dict, reg, rate: float, mass_folded: float,
                  mass_discarded: float) -> None:
    """The observatory keys of an asynchronous record: the EWMA arrival
    rate, the contribution mass and the folded staleness tail."""
    rec["arrival_rate_ewma_per_min"] = round(rate, 6)
    rec["mass_folded"] = round(mass_folded, 6)
    rec["mass_discarded"] = round(mass_discarded, 6)
    hs = reg.histogram("fleetsim.async_staleness",
                       labels={"outcome": "folded"}).summary()
    if hs.get("count"):
        rec["staleness_p50"] = hs["p50"]
        rec["staleness_p90"] = hs["p90"]
        rec["staleness_p99"] = hs["p99"]


def _numpy_tree(tree):
    """A nested dict of tensors as numpy arrays."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
