"""Chaos soak: an in-process federation run under a fault plan (the
counterpart of the JAX package's ``faults/soak.py``).

One broker, ``n_workers`` DeviceWorkers and a FederatedCoordinator run in
this process.  After a fault-free warm-up round (the first train request
builds each worker's trainer: a plan must perturb steady-state rounds, not
start-up) the plan is installed and the remaining rounds run against
injected drops, delays, corrupt frames and crashes.  The summary carries
every round record and the counter deltas, so a caller (``chaos``, the
tests) asserts that the robustness machinery held.

The configs are JAX's, except that JAX fixes ``backend="cpu"``: here they
run on the card (``backend="gpu"``, which raises without one) unless the
caller passes ``backend="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from colearn_federated_learning_tpu_torch import telemetry
from colearn_federated_learning_tpu_torch.analysis.metric_catalog import (
    SECURE_SOAK_DELTA_COUNTERS as _SECURE_COUNTERS,
    SOAK_DELTA_COUNTERS as _COUNTERS,
)
from colearn_federated_learning_tpu_torch.faults import inject
from colearn_federated_learning_tpu_torch.faults.plan import (
    FaultPlan, FaultSpec)
from colearn_federated_learning_tpu_torch.utils.config import (
    DataConfig, ExperimentConfig, FedConfig, ModelConfig, RunConfig)


def soak_device(config: ExperimentConfig) -> str:
    """The torch device of a soak config: the CPU only when its
    ``backend`` asks for it."""
    return "cpu" if config.run.backend == "cpu" else "cuda"


def default_soak_config(n_workers: int = 4, seed: int = 0,
                        min_cohort_fraction: float = 0.5,
                        evict_after: int = 2,
                        comm_retries: int = 2,
                        backend: str = "gpu") -> ExperimentConfig:
    """Tiny federation with the robustness features on: quorum at half
    the cohort, eviction after 2 failures in a row, 2 retries.

    Plain SGD (no momentum) at a calm lr: the verdict compares final
    accuracy between a faulted and a fault-free run, so the optimizer must
    converge monotonically."""
    return ExperimentConfig(
        data=DataConfig(dataset="mnist_tiny", num_clients=n_workers,
                        partition="iid"),
        model=ModelConfig(name="mlp", num_classes=10, hidden_dim=32,
                          depth=2),
        fed=FedConfig(strategy="fedavg", rounds=10, cohort_size=0,
                      local_steps=4, batch_size=16, lr=0.05, momentum=0.0,
                      min_cohort_fraction=min_cohort_fraction),
        run=RunConfig(name="chaos_soak", backend=backend, seed=seed,
                      evict_after=evict_after, comm_retries=comm_retries),
    )


def canned_plan(seed: int = 7) -> FaultPlan:
    """The acceptance plan against the default 4-worker soak (rounds are
    post-warm-up: the warm-up is round 0, faults start at 1):

    - round 1: a delayed and a twice-flapped trainer, both recovered
      within the round by the retry path;
    - round 2: three parallel request drops: one survivor, below the 50 %
      quorum, so the round is an explicit no-op;
    - round 3: one corrupt reply frame: a CRC failure, retried, recovered;
    - round 4: one worker crash: the device drops this round and every
      later one, and is evicted after ``evict_after`` failures.

    Rounds 5+ are fault-free, a recovery tail for the final accuracy.
    """
    return FaultPlan([
        FaultSpec(kind="delay", device_id="0", round=1, op="train", ms=150),
        FaultSpec(kind="flap_reconnect", device_id="1", round=1, op="train",
                  count=2),
        FaultSpec(kind="drop_request", device_id="0", round=2, op="train"),
        FaultSpec(kind="drop_request", device_id="1", round=2, op="train"),
        FaultSpec(kind="drop_request", device_id="2", round=2, op="train"),
        FaultSpec(kind="corrupt_payload", device_id="1", round=3,
                  op="train"),
        FaultSpec(kind="crash_worker", device_id="3", round=4, op="train"),
    ], seed=seed)


def _start_federation(config: ExperimentConfig, n_workers: int,
                      round_timeout: float):
    """A broker, ``n_workers`` started workers and an enrolled
    coordinator (no evaluator) on ``config``'s device, trainers in id
    order.  Returns ``(broker, workers, coord)``; what was started is
    stopped again if a later step raises."""
    from colearn_federated_learning_tpu_torch.comm.broker import MessageBroker
    from colearn_federated_learning_tpu_torch.comm.coordinator import (
        FederatedCoordinator)
    from colearn_federated_learning_tpu_torch.comm.worker import DeviceWorker

    device = soak_device(config)
    broker = MessageBroker().start()
    workers, coord = [], None
    try:
        for i in range(n_workers):
            workers.append(DeviceWorker(config, i, broker.host, broker.port,
                                        device=device).start())
        coord = FederatedCoordinator(config, broker.host, broker.port,
                                     round_timeout=round_timeout,
                                     want_evaluator=False, device=device)
        coord.enroll(min_devices=n_workers, timeout=30.0)
        # Announcements arrive in a thread race; the fold follows trainer
        # order, so sort for run-to-run identical records.
        coord.trainers.sort(key=lambda d: int(d.device_id))
        for w in workers:
            w.await_role(timeout=10.0)
    except BaseException:
        _stop_federation(broker, workers, coord)
        raise
    return broker, workers, coord


def _stop_federation(broker, workers, coord) -> None:
    for w in workers:
        w.stop()
    broker.stop()
    if coord is not None:
        coord.close()


def run_soak(rounds: int = 10, n_workers: int = 4,
             plan: Optional[FaultPlan] = None,
             round_timeout: float = 6.0,
             warmup_timeout: float = 120.0,
             config: Optional[ExperimentConfig] = None,
             log_fn: Optional[Callable[[dict], None]] = None,
             backend: str = "gpu") -> dict:
    """Run ``rounds`` federated rounds (1 fault-free warm-up and the rest
    under ``plan``) and return a summary: ``records`` (every round record,
    in order), ``skipped_rounds``, ``evicted``, per-counter deltas under
    ``counters``, the plan's ``faults_fired`` ledger, and a fault-free
    final ``weighted_acc``/``weighted_loss`` over the surviving trainers'
    own shards.  ``backend`` picks the device of the default config; a
    given ``config`` carries its own."""
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    config = config or default_soak_config(n_workers, backend=backend)
    reg = telemetry.get_registry()
    before = {name: reg.counter(name).value for name in _COUNTERS}  # colearn: noqa(CL005): names from the catalog-declared counter tuple
    labeled = "fault.injected_total{"
    labeled_before = {k: v for k, v in reg.snapshot().items()
                      if k.startswith(labeled)}

    broker, workers, coord = _start_federation(config, n_workers,
                                               warmup_timeout)
    installed = False
    try:
        rec = coord.run_round()                      # warm-up (round 0)
        if log_fn is not None:
            log_fn(rec)
        coord.round_timeout = round_timeout
        if plan is not None:
            inject.install(plan)
            installed = True
        for _ in range(rounds - 1):
            rec = coord.run_round()
            if log_fn is not None:
                log_fn(rec)
        if installed:
            inject.uninstall()
            installed = False
        # Scored after the uninstall, on the generous deadline: the
        # verdict measures what the faults did to the model.
        coord.round_timeout = warmup_timeout
        per_client = coord.evaluate_per_client()
    finally:
        if installed:
            inject.uninstall()
        _stop_federation(broker, workers, coord)

    records = list(coord.history)
    return {
        "rounds_run": len(records),
        "records": records,
        "completed_rounds": [r["round"] for r in records
                             if r["completed"] > 0
                             and not r.get("skipped_quorum")],
        "skipped_rounds": [r["round"] for r in records
                           if r.get("skipped_quorum")],
        "evicted": sorted({d for r in records for d in r["evicted"]}),
        "weighted_acc": per_client.get("weighted_acc"),
        "weighted_loss": per_client.get("weighted_loss"),
        # device_id -> final own-shard accuracy: a verdict against a
        # baseline compares the devices both runs still have.
        "per_client_acc": per_client.get("per_client", {}),
        "counters": {name: reg.counter(name).value - before[name]  # colearn: noqa(CL005): names from the catalog-declared counter tuple
                     for name in _COUNTERS},
        # Per-(device, kind) injection deltas, worst offender first.
        "top_faults": sorted(
            ({"label": k[len(labeled) - 1:], "count": delta}
             for k, v in reg.snapshot().items()
             if k.startswith(labeled)
             and (delta := v - labeled_before.get(k, 0)) > 0),
            key=lambda t: (-t["count"], t["label"])),
        "faults_fired": dict(plan.fired) if plan is not None else {},
    }


# ------------------------------------------------------- secure flavor --
def secure_soak_config(n_workers: int = 5, seed: int = 0,
                       comm_retries: int = 2,
                       backend: str = "gpu") -> ExperimentConfig:
    """The soak config with DH secure aggregation on.

    Five workers is the floor for :func:`canned_secure_plan`'s combined
    round: with one trainer dead and one masker silent in the recovery,
    each origin's threshold t = ceil(0.5 * 4) = 2 still has 3 reachable
    share holders.  ``max_examples_per_client`` caps each round's work."""
    cfg = default_soak_config(n_workers, seed=seed,
                              comm_retries=comm_retries, backend=backend)
    return cfg.replace(
        data=dataclasses.replace(cfg.data, max_examples_per_client=64),
        fed=dataclasses.replace(cfg.fed, secure_agg=True,
                                secure_agg_key_exchange="dh",
                                secure_agg_threshold=0.5),
        run=dataclasses.replace(cfg.run, name="secure_soak"),
    )


def canned_secure_plan(seed: int = 11) -> FaultPlan:
    """The dropout matrix of the secure-aggregation gate (5 workers; the
    warm-up is round 0).  ``count=3`` on every drop outruns the
    transport's 2 retries, so the drop sticks:

    - round 1: device 0's train request is swallowed: its session secret
      is reconstructed and its orphaned pair-mask halves stripped;
    - round 2: device 1 trains and goes silent in ``unmask``: its
      self-mask comes back from t-of-n shares;
    - round 3: both at once: device 2 never trains, device 3 goes silent
      in the recovery;
    - round 4: device 0 is deaf to ``share_setup``: pruned before
      training, which is not a mask recovery.
    """
    return FaultPlan([
        FaultSpec(kind="drop_request", device_id="0", round=1, op="train",
                  count=3),
        FaultSpec(kind="drop_request", device_id="1", round=2, op="unmask",
                  count=3),
        FaultSpec(kind="drop_request", device_id="2", round=3, op="train",
                  count=3),
        FaultSpec(kind="drop_request", device_id="3", round=3, op="unmask",
                  count=3),
        FaultSpec(kind="drop_request", device_id="0", round=4,
                  op="share_setup", count=3),
    ], seed=seed)


def oracle_plan(plan: FaultPlan) -> FaultPlan:
    """The plain federation's mirror of a secure-aggregation fault plan:
    it loses exactly the trainers the secure run lost: ``share_setup``
    drops become ``train`` drops, ``unmask`` drops vanish (the masked
    update already folded), everything else carries over."""
    specs = []
    for f in plan.faults:
        if f.op == "unmask":
            continue
        if f.op == "share_setup":
            f = dataclasses.replace(f, op="train")
        specs.append(f)
    return FaultPlan(specs, seed=plan.seed)


def run_secure_soak(rounds: int = 6, n_workers: int = 5,
                    plan: Optional[FaultPlan] = None,
                    round_timeout: float = 8.0,
                    warmup_timeout: float = 120.0,
                    atol: float = 2e-4,
                    log_fn: Optional[Callable[[dict], None]] = None,
                    backend: str = "gpu") -> dict:
    """Chaos-gated exactness: a DH secure-aggregation federation and a
    plain FedAvg oracle run in lockstep in this process (same seed, model
    init and data), ``plan`` (default :func:`canned_secure_plan`) hitting
    the secure run and :func:`oracle_plan` mirroring its losses onto the
    oracle.  After every round the two global models agree to ``atol``
    (f32 mask-cancellation roundoff).

    The two plans are installed in turn around each ``run_round``: the
    injector seam is process-global and both fleets share device ids.
    There is no per-client evaluation: secure aggregation hides it."""
    if rounds < 2:
        raise ValueError(f"rounds must be >= 2 (warmup + faulted), "
                         f"got {rounds}")
    from colearn_federated_learning_tpu_torch.comm.downlink import (
        host_params)
    from colearn_federated_learning_tpu_torch.utils import trees

    cfg_secure = secure_soak_config(n_workers, backend=backend)
    cfg_plain = cfg_secure.replace(
        fed=dataclasses.replace(cfg_secure.fed, secure_agg=False),
        run=dataclasses.replace(cfg_secure.run, name="secure_soak_oracle"),
    )
    plan = plan if plan is not None else canned_secure_plan()
    plan_plain = oracle_plan(plan)

    reg = telemetry.get_registry()
    before = {name: reg.counter(name).value for name in _SECURE_COUNTERS}  # colearn: noqa(CL005): names from the catalog-declared counter tuple

    def flat(coord) -> np.ndarray:
        return np.concatenate([
            np.ravel(a) for a in trees.leaves(host_params(coord.params_tree()))
        ])

    fleets = []      # (broker, workers, coord) per federation
    installed = False
    try:
        for cfg in (cfg_secure, cfg_plain):
            fleets.append(_start_federation(cfg, n_workers, warmup_timeout))
        (_, _, coord_s), (_, _, coord_p) = fleets

        diffs = []
        for _ in range(rounds):
            faulted = bool(coord_s.history)      # round 0 is the warm-up
            if faulted:
                inject.install(plan)
                installed = True
            rec_s = coord_s.run_round()
            if installed:
                inject.uninstall()
                installed = False
            if faulted:
                inject.install(plan_plain)
                installed = True
            rec_p = coord_p.run_round()
            if installed:
                inject.uninstall()
                installed = False
            if len(coord_s.history) == 1:
                # The warm-up is done on both: the faulted rounds' deadline.
                coord_s.round_timeout = round_timeout
                coord_p.round_timeout = round_timeout
            diff = float(np.max(np.abs(flat(coord_s) - flat(coord_p))))
            diffs.append(diff)
            if log_fn is not None:
                log_fn({"round": rec_s["round"], "param_diff": diff,
                        "secure": strip_timing(rec_s),
                        "oracle": strip_timing(rec_p)})
    finally:
        if installed:
            inject.uninstall()
        for fleet in fleets:
            _stop_federation(*fleet)

    records = list(coord_s.history)
    return {
        "rounds_run": len(records),
        "records": records,
        "oracle_records": list(coord_p.history),
        "param_diffs": diffs,
        "max_param_diff": max(diffs) if diffs else float("nan"),
        "oracle_ok": bool(diffs) and all(d <= atol for d in diffs),
        "skipped_rounds": [r["round"] for r in records
                           if r.get("skipped_quorum")],
        "counters": {name: reg.counter(name).value - before[name]  # colearn: noqa(CL005): names from the catalog-declared counter tuple
                     for name in _SECURE_COUNTERS},
        "faults_fired": dict(plan.fired) if plan is not None else {},
        "oracle_faults_fired": dict(plan_plain.fired),
    }


# Timing keys vary run to run; everything else in a round record is
# identical between a no-plan run and an empty-plan run.
_TIMING_KEYS = ("round_time_s",)


def strip_timing(rec: dict) -> dict:
    """A round record without its wall-clock fields."""
    return {k: v for k, v in rec.items()
            if k not in _TIMING_KEYS and not k.startswith("phase_")}
