"""Canonical catalog of every metric name the codebase may register.

One declared list, imported by BOTH the runtime registry
(telemetry/registry.py — optional strict mode, label-name validation)
and the CL005 lint rule (analysis/rules.py), so a counter-name typo
(``comm.retry_totl``) is a lint error at review time instead of a
silently-empty series the chaos-soak gate never sees.

Keep this module dependency-free: it is imported by telemetry/registry,
which every layer (including jit-adjacent code) pulls in.

Entries ending in ``.*`` are prefix wildcards for families minted at
runtime (``fault.injected.<kind>``).  Labeled instruments
(``comm.retry_total{device=3}``) are validated on the base name — the
label suffix is stripped by :func:`base_name`.
"""

from __future__ import annotations

# ---------------------------------------------------------------- catalog --
# Counters -----------------------------------------------------------------
COUNTERS = (
    # checkpoint plane (ckpt/manager.py, ckpt/wal.py, ckpt/streaming.py)
    "ckpt.saves_total",
    "ckpt.restores_total",
    "ckpt.wal_appends_total",
    "ckpt.wal_torn_tail_total",            # in-flight append lost to a kill
    "ckpt.wal_uncommitted_discarded_total",  # logged rounds past the ckpt
    "ckpt.shards_written_total",           # streaming per-shard files committed
    "ckpt.save_aborted_total",             # save ended before manifest commit
    "ckpt.resharded_resumes_total",        # restore re-cut onto a different tp
    # torn/missing/CRC-bad generations skipped by streaming recovery;
    # labeled {reason=missing_manifest|torn_manifest|missing_shard|
    # torn_shard|crc_mismatch}
    "ckpt.generations_discarded_total",
    # engine plane (fed/engine.py, fed/local.py)
    "engine.rounds_total",
    "local.trainers_built",
    # comm plane (comm/protocol.py, comm/transport.py, comm/worker.py)
    "comm.messages_sent",
    "comm.messages_received",
    "comm.bytes_sent",
    "comm.bytes_received",
    "comm.corrupt_frames_total",
    "comm.suppressed_oserrors_total",
    "comm.retry_total",              # labeled per device: {device=<id>}
    "comm.reenroll_total",
    "comm.reconnect_failures_total",
    # wire fast path (comm/downlink.py, comm/coordinator.py,
    # comm/aggregation.py)
    "comm.broadcast_encode_total",   # CLW1 encodes of a broadcast frame
    "comm.bytes_saved_downlink",     # delta vs full-params payload bytes
    "comm.bytes_saved_uplink",       # compressed vs dense train-reply bytes
    "comm.uplink_densify_avoided_total",  # contributions folded sparse (O(k))
    "comm.fold_device_total",           # contributions folded on-device
    "comm.resync_total",             # worker cache misses → full re-send
    # sharded server plane (parallel/partition.py, comm/downlink.py):
    # per-chip replication bytes the gather-free downlink never
    # materialized (per-shard host reads instead of a full-tree gather)
    "comm.gather_bytes_avoided_total",
    # key exchange & broker healing (comm/keyexchange.py, comm/coordinator.py)
    "comm.keyexchange_rejected_total",  # labeled {reason=zero|identity|...}
    "comm.broker_reconnects_total",     # labeled {outcome=ok|failed}
    # aggregator tree (comm/aggregator.py, comm/coordinator.py)
    "comm.agg_folds_total",             # labeled {agg=<id>}: partials folded
    "comm.agg_failovers_total",         # labeled {action=rehome|drop}
    "comm.agg_heartbeat_expired_total",  # stale heartbeat seen at dispatch
    "comm.agg_partials_folded_total",   # root-side, labeled {agg=<id>}
    # health ledger (telemetry/health.py)
    "health.ledger_appends_total",
    "health.ledger_compactions_total",
    # durable enrollment + challenge-on-resume (ckpt/wal.py EnrollmentLedger,
    # comm/coordinator.py verify_resumed_devices)
    "comm.enroll_ledger_appends_total",
    "comm.enroll_challenge_rejected_total",  # labeled {reason=not_in_ledger|
    #                                          bad_tag|unreachable|...}
    # dropout-tolerant secure aggregation (privacy/dropout.py,
    # comm/coordinator.py share phase + mask recovery)
    "privacy.shares_distributed_total",     # encrypted share blobs relayed
    "privacy.shares_collected_total",       # reveal shares received back
    "privacy.self_masks_removed_total",     # b_u reconstructions applied
    "privacy.masks_recovered_total",        # labeled {device=<dropped id>}
    "privacy.share_recovery_failures_total",  # labeled {stage=<where>}
    # fault plane (faults/inject.py)
    "fault.injected_total",
    "fault.injected.*",              # per-kind family
    # federation round outcomes (comm/coordinator.py)
    "fed.rounds_total",
    "fed.clients_dropped",
    "fed.clients_evicted",
    "fed.rounds_skipped_quorum",
    "fed.rounds_resumed_total",      # --resume restored a checkpoint
    # tp_size degraded to a replicated layout (fed/engine.py from_config,
    # parallel/partition.py make_server_placement); labeled
    # {reason=indivisible_devices|insufficient_devices|rules_matched_nothing}
    "fed.mesh_fallback_total",
    # file & hierarchical planes (fed/offline.py, fed/hierarchical.py)
    "fed.offline_updates_rejected_total",  # labeled {reason=torn|stale|...}
    "fed.offline_residual_resets_total",   # labeled {reason=stale|...}
    "fed.hier_groups_dropped_total",       # labeled per group: {group=g1}
    # LoRA adapter plane (fed/lora.py, comm/coordinator.py): server-side
    # B·A·(α/r) merges of aggregated factors into the global model
    "fed.lora_merges_total",
    # buffered-async plane (comm/async_coordinator.py)
    "async.dispatch_failures",
    "async.aggregations_total",
    "async.updates_discarded_stale",
    "async.devices_pruned_total",      # labeled {reason=straggler|...}
    "async.devices_readmitted_total",  # probation expiry re-admissions
    "fed.devices_evicted_total",       # dead-pump eviction, labeled {device=}
    # staleness observatory (comm/async_coordinator.py)
    "async.contribution_mass",       # Σ(1+τ)^-α, labeled {outcome=folded|...}
    "async.pump_stalls_total",       # dispatch slower than timeout/2, {device=}
    "async.buffer_resizes_total",    # auto-K changed the fold threshold
    # buffered-async aggregator tree (comm/aggregator.py buffered ops,
    # comm/async_coordinator.py tree mode)
    "comm.agg_buffer_staged_total",   # labeled {agg=<id>}: abuf contributions
    "comm.agg_buffer_dedup_total",    # duplicate dedup-key overwrites, {agg=}
    "comm.agg_partials_shipped_total",  # adrain partials sent up, {agg=<id>}
    "comm.agg_rehomed_total",         # contributions re-sent to a sibling
    "async.partials_folded_total",    # root-side tree folds, {agg=<id>}
    "async.partials_discarded_stale",  # whole partial past max_staleness
    # fleet simulation (fleetsim/sim.py)
    "fleetsim.rounds_total",
    "fleetsim.clients_trained_total",
    "fleetsim.async_aggregations_total",
    "fleetsim.async_updates_discarded_total",  # too-stale at fold time
    "fleetsim.async_devices_pruned_total",
    "fleetsim.async_contribution_mass",   # labeled {outcome=folded|discarded}
    "fleetsim.async_buffer_resizes_total",  # auto-K resizes (virtual clock)
    "fleetsim.async_partials_folded_total",   # two-tier mode, {agg=<slice>}
    "fleetsim.async_partials_discarded_total",  # whole partial too stale
    "fleetsim.bytes_up_est_total",     # wire-codec frame estimate, uplink
    "fleetsim.bytes_down_est_total",   # wire-codec frame estimate, downlink
    "fleetsim.bytes_gather_avoided_est_total",  # sharded-downlink estimate
    "fleetsim.bytes_up_saved_est_total",  # uplink-codec savings estimate
    # runtime observability plane (telemetry/runtime.py, telemetry/flight.py)
    "telemetry.compile_total",       # labeled {fn=<name>}: distinct XLA sigs
    "telemetry.recompile_total",     # labeled {fn,reason=shape|dtype|structure}
    "flight.dumps_total",            # flight-recorder dump writes
    "export.scrapes_total",          # /metrics + /snapshot.json hits
    "export.events_written_total",   # JSONL event-stream lines
    # convergence observatory (telemetry/convergence.py export_metrics):
    # per-fold trend classification census, labeled {trend=progress|...}
    "learn.trend_total",
)

# Gauges -------------------------------------------------------------------
GAUGES = (
    "engine.h2d_transfer_s",
    "local.steps_per_round",
    "fleetsim.devices",
    "fleetsim.chunk_size",
    "fleetsim.available_fraction",
    "fleetsim.async_buffer_size",
    "fleetsim.async_sim_minutes",   # simulated-clock minutes elapsed
    # sharded server: measured per-chip server-state bytes (per-shard
    # accounting via parallel/partition.bytes_per_chip — deterministic
    # even where memory_stats() is empty)
    "comm.server_bytes_per_chip",
    # uplink error feedback (comm/worker.py): norm of the carried
    # compression residual — should stay bounded round over round
    "fed.uplink_residual_norm",
    # adaptive topk (comm/worker.py _adapt_topk): the per-round density
    # the controller actually used, inside [topk_min, topk_max]
    "fed.topk_fraction_effective",
    # LoRA adapter plane (comm/coordinator.py): configured rank and the
    # trainable factor-parameter count it induces on the global model
    "fed.lora_rank",
    "fed.lora_factor_params",
    # live HBM sampling (telemetry/runtime.py; empty on CPU backends)
    "runtime.hbm_bytes_in_use",
    "runtime.hbm_bytes_limit",
    "runtime.hbm_peak_bytes_in_use",
    # aggregator tier visibility (comm/coordinator.py → `colearn top`)
    "comm.agg_heartbeat_age_s",      # labeled {agg=<id>}: announce staleness
    "comm.agg_slice_devices",        # labeled {agg=<id>}: dispatch slice size
    # buffered-async aggregator tree: per-slice buffer visibility
    "comm.agg_buffer_k",             # labeled {agg=<id>}: auto-K in force
    "comm.agg_buffer_occupancy",     # labeled {agg=<id>}: staged, undrained
    "comm.agg_arrival_rate_per_s",   # labeled {agg=<id>}: slice-local EWMA
    # staleness observatory (comm/async_coordinator.py, telemetry/arrival.py)
    "async.buffer_target",           # K in force for the current aggregation
    "async.buffer_occupancy",        # updates folded into the open buffer
    "async.pending_updates",         # arrived-but-unfolded queue depth
    "async.pumps",                   # labeled {state=wait|train|retry|...}
    "async.arrival_rate_per_s",      # seeded-EWMA; labeled {device=} children
    "fleetsim.async_arrival_rate_per_min",  # same estimator, virtual clock
    # health ledger exports (telemetry/health.py export_gauges)
    "health.devices_tracked",
    "health.device_score",           # labeled {device=<id>}: offender rank
    "health.device_latency_ewma_s",  # labeled {device=<id>}
    # convergence observatory (telemetry/convergence.py export_metrics):
    # learning-health signals computed from the materialized aggregate
    "learn.update_norm",             # ‖mean update‖ of the latest fold
    "learn.update_norm_ewma",        # trend baseline the classifier uses
    "learn.step_size",               # ‖mean update‖ × server_lr
    "learn.cos_prev",                # cosine to the previous mean update
    "learn.cohort_skew",             # 1 − min cohort-centroid cosine
)

# Histograms ---------------------------------------------------------------
HISTOGRAMS = (
    "ckpt.save_s",
    "ckpt.restore_s",
    "engine.round_time_s",
    "fed.round_time_s",
    "fed.phase_time_s",      # labeled {phase=broadcast_collect|aggregate|...}
    "async.agg_time_s",
    "async.staleness",       # labeled {outcome=folded|discarded}: τ per update
    "fleetsim.async_staleness",      # same, on the simulated clock
    "fleetsim.round_time_s",
    "comm.agg_fold_time_s",  # labeled {agg=<id>}: middle-tier slice folds
    # convergence observatory: distribution of per-fold update norms
    "learn.update_norm_dist",
)

# Counters whose soak-window delta faults/soak.py reports (a curated
# subset of COUNTERS — declared here so the soak gate and the catalog
# cannot drift apart).
SOAK_DELTA_COUNTERS = (
    "comm.retry_total",
    "comm.corrupt_frames_total",
    "comm.reconnect_failures_total",
    "fault.injected_total",
    "fed.rounds_skipped_quorum",
)

# Additional deltas the SECURE soak flavor reports (faults/soak.py
# run_secure_soak).  Kept separate from SOAK_DELTA_COUNTERS so the
# classic chaos-soak report — and the tests pinning it — are unchanged.
SECURE_SOAK_DELTA_COUNTERS = (
    "privacy.shares_distributed_total",
    "privacy.shares_collected_total",
    "privacy.self_masks_removed_total",
    "privacy.masks_recovered_total",
    "privacy.share_recovery_failures_total",
    "fed.rounds_skipped_quorum",
    "fault.injected_total",
)

METRICS: frozenset = frozenset(COUNTERS) | frozenset(GAUGES) | frozenset(
    HISTOGRAMS
)

assert set(SOAK_DELTA_COUNTERS) <= set(COUNTERS)
assert set(SECURE_SOAK_DELTA_COUNTERS) <= set(COUNTERS)

_WILDCARDS = tuple(sorted(m[:-1] for m in METRICS if m.endswith(".*")))


def base_name(name: str) -> str:
    """Strip a ``{label=value,...}`` suffix: the catalog declares base
    names; labels are free-form attribution."""
    brace = name.find("{")
    return name if brace < 0 else name[:brace]


def is_known(name: str) -> bool:
    """True when ``name`` (label suffix ignored) is declared here, either
    exactly or under a ``family.*`` wildcard."""
    base = base_name(name)
    if base in METRICS:
        return True
    return any(base.startswith(w) for w in _WILDCARDS)


# ------------------------------------------------------------ record keys --
# Round/aggregation-record keys the comm/ and fleetsim/ hot paths may
# stamp (comm/coordinator.py, comm/async_coordinator.py,
# fleetsim/sim.py).  The CL016 lint rule (analysis/rules.py) validates
# every literal key stored into those records against this tuple, so a
# record-key typo ("train_los") is a lint error instead of a silently
# forked series downstream sentinels and `colearn converge` never match.
RECORD_KEYS_LIST = (
    # sync federation round record (comm/coordinator.py)
    "round", "completed", "cohort", "dropped", "evicted", "train_loss",
    "total_weight", "phase_broadcast_collect_s", "phase_aggregate_s",
    "phase_fold_overlap_s", "round_time_s", "retries",
    # conditional sync keys (feature-gated; default records byte-identical)
    "unmask_failed", "skipped_quorum", "bytes_saved_uplink",
    "uplink_densify_avoided", "lora_merged", "aggregators",
    "phase_agg_fold_s", "agg_failovers", "dp_epsilon", "dp_delta",
    # per-client evaluation report (comm/coordinator.py)
    "num_clients_evaluated", "per_client",
    # challenge-on-resume report (comm/coordinator.py
    # verify_resumed_devices)
    "verified", "rejected",
    # buffered-async aggregation record (comm/async_coordinator.py)
    "aggregation", "model_version", "buffer_size", "staleness_mean",
    "staleness_max", "discarded", "contributors", "agg_time_s",
    "phase_collect_s", "phase_apply_s",
    # observe-gated async keys
    "mass_folded", "mass_discarded", "arrival_rate_per_s",
    "staleness_p50", "staleness_p90", "staleness_p99", "pruned",
    "dp_z_eff",
    # tree-async keys (comm/async_coordinator.py tree mode + fleetsim
    # two-tier fit_async; absent unless num_aggregators/aggregators > 0,
    # so default records stay byte-identical)
    "agg_id", "agg_buffer_k", "agg_buffer_staged", "agg_buffer_rate_per_s",
    "oldest_version", "folded_keys", "rehomed_devices", "rehomed_total",
    "agg_fold_tracking_min",
    # fleetsim sync round record (fleetsim/sim.py run_round)
    "cohort_requested", "clients_trained", "bytes_down_est",
    "bytes_up_est", "bytes_gather_avoided_est", "bytes_up_saved_est",
    "available_fraction", "straggled", "corrupted",
    # fleetsim async record extras (fleetsim/sim.py fit_async)
    "sim_time_min", "arrival_rate_per_min", "agg_rate_per_min",
    "wasted_updates_total", "arrival_rate_ewma_per_min", "pruned_total",
    # fleetsim compile-census report (DeviceFleetSim.compile_counts)
    "chunk", "finish", "fold", "obs_chunk",
    # health-ledger summary keys (telemetry/health.py health_record_keys)
    "health_devices", "health_lat_p99_s", "health_worst_device",
    "health_worst_score",
    # convergence observatory (telemetry/convergence.py; --learn-observe)
    "conv_update_norm",      # ‖mean update‖ of the materialized aggregate
    "conv_step_size",        # ‖mean update‖ × server_lr
    "conv_norm_ewma",        # trend baseline at classification time
    "conv_trend",            # warmup|progress|plateau|divergence|oscillation
    "conv_cos_prev",         # cosine to previous update (absent round 0)
    "conv_norm_median",      # fleetsim per-device skew (updates visible)
    "conv_norm_p90",
    "conv_norm_anomalies",   # devices with norm > anomaly_ratio × median
    "conv_cohort_skew",      # 1 − min cohort-centroid cosine vs aggregate
    "conv_cohort_cos_min",
)

RECORD_KEYS: frozenset = frozenset(RECORD_KEYS_LIST)

assert len(RECORD_KEYS) == len(RECORD_KEYS_LIST), "duplicate record key"


def is_known_record_key(key: str) -> bool:
    """True when ``key`` is a declared round-record key."""
    return key in RECORD_KEYS
