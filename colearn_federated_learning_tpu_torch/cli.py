"""Command line of the PyTorch port: ``train``, ``init``, ``aggregate``,
``eval``, ``configs``, ``bench``, ``broker``, ``worker``, ``aggregator``,
``coordinate``, ``trace-summary``, ``health``, ``postmortem``,
``chaos``, ``fleetsim``, ``top``, ``converge``, ``lint`` and
``sentinel``.

    python -m colearn_federated_learning_tpu_torch.cli train --config NAME \\
        [--backend gpu|cpu] [overrides]

The counterpart of the JAX package's ``colearn`` command line (its
``config_from_args``, ``cmd_train``, ``cmd_init``, ``cmd_aggregate``,
``cmd_eval``, ``cmd_configs`` and ``cmd_bench``) for what this package runs: the
single-device federated round with every strategy, DP (fixed or adaptive
clipping, with the RDP accountant), secure aggregation and the robust
aggregators; hierarchical edge → cloud federation (``--edge-groups`` >= 2,
``--edge-sync-period``); on the flat path, a per-client evaluation of the
final model (``--per-client-eval``, its report on stderr); the file plane
(``init``, ``train --role client`` with ``--compress``, ``aggregate``,
``eval``; ``fed/offline.py``); the headline benchmark (``bench``); and the
synchronous socket plane (``broker``, ``worker``, ``coordinate``;
``comm/``), with ``--fault-plan`` installed on the process's transport,
its aggregator tree (``aggregator`` processes, ``coordinate
--num-aggregators``), per-type federation (``coordinate --per-type``,
which exits 1 when a type's federation fails or none runs) and the
buffered-asynchronous coordinator (``coordinate --async-buffer N|auto``,
through the aggregators' slice buffers with ``--num-aggregators``).  ``broker``,
``worker`` and ``aggregator`` serve until SIGINT or SIGTERM and then exit
0.  Telemetry (``telemetry/``): ``train --log-file`` and
``--tensorboard-dir`` log the records through ``MetricsLogger``;
``--trace-dir`` (with ``--trace-rounds`` on ``train``) writes the
Chrome-trace JSON of ``train``, ``coordinate`` and ``aggregator``, which
``trace-summary`` breaks down; ``--health-dir`` keeps the per-device
health ledgers of ``coordinate`` and ``aggregator``, which ``health``
renders.  Both print the JAX command's text and exit with its codes.
Checkpoints (``ckpt/``): ``--checkpoint-dir`` and ``--checkpoint-every``
save the state of ``train`` and ``coordinate`` (``--ckpt-stream`` picks
the streaming format); ``train --resume`` prints ``resumed at round k``
(under ``torchrun`` on a client mesh too, rank 0 only) and runs the
remaining rounds, ``coordinate --resume`` prints the event
``resume_cold`` or ``resumed`` and, on the synchronous plane, after
enrollment ``challenge_verified``.  The flight recorder
(``telemetry/flight.py``): ``--flight-dir``, ``--flight-heartbeat`` and
``--flight-watchdog`` on ``broker``, ``worker``, ``aggregator`` and
``coordinate`` keep a heartbeat-rewritten ``flight_<pid>.json`` (dumped
at once on SIGTERM, an uncaught exception or a watchdog stall), which
``postmortem`` merges with the round WAL.  ``chaos`` runs the chaos soaks
(``faults/soak.py``, ``faults/procsoak.py``): in this process under a
fault plan, ``--secure`` against a plain oracle, and ``--mp``, ``--agg``,
``--async``, ``--tree-async`` and ``--ckpt`` as processes under real
SIGKILLs (``--async`` and ``--tree-async`` with ``--lock-witness``, the
lock witness in every process), with JAX's gates and exit codes.
``fleetsim`` simulates a fleet of up to a million devices
(``fleetsim/``): chunked rounds over a seeded synthetic population and a
traffic model, or with ``--async-buffer`` the buffered-asynchronous
plane on a virtual clock (``--aggregators``: its two-tier tree), with
JAX's flags and summary keys (less the compile census, ``compiles``).
``coordinate --tp-size N`` shards the server state over N positions
(the cards, or on the CPU the host positions ``XLA_FLAGS`` forces) or,
on a host with fewer, runs replicated and counts the fallback.
Everything runs on the card (``--backend gpu``, the default, which raises
without one) or, only when asked, on the CPU.  ``train`` writes each
round's record to stderr as one JSON line and its summary to stdout, as in
the JAX package; every command prints its result as one JSON line on
stdout, and :func:`main` returns it.

``train`` builds its learner with ``FederatedLearner.from_config``: in a
plain process on one device, under ``torchrun --nproc-per-node N`` over a
client mesh of the N ranks (NCCL; gloo with ``--backend cpu``), with a
``seq`` axis for ``--attn-impl ring|ulysses`` and a ``model`` axis for
``--tp-size``; only rank 0 prints.  On one device ``--attn-impl ring``
runs the dense core and ``--tp-size 2`` warns and runs untiled, as in
JAX; ``--remat`` checkpoints the transformer blocks' activations.

Observability (``telemetry/runtime.py``, ``telemetry/convergence.py``):
``--metrics-port`` (0: an ephemeral port, announced as a ``metrics_port``
event on stderr) serves ``/metrics`` and ``/snapshot.json`` from
``broker``, ``worker``, ``aggregator`` and ``coordinate``, which ``top``
renders; ``--events-file`` appends their ``start``, ``round`` and
``stop`` events as JSONL; ``--learn-observe`` stamps the convergence
observatory's ``conv_*`` keys on the coordinators' and ``fleetsim``'s
records (a no-op in ``train``, as in JAX), which ``converge`` reports;
``train --profile-dir`` profiles rounds 1..2 with ``torch.profiler``.
``train --personalize-steps N`` and ``--detection-eval`` dump JAX's
personalized and detection reports on stderr after training, and ``eval
--detection-eval`` adds the detection view to the file's score.

``lint`` runs this package's AST lint (``analysis/``; by default over
this package, with the repo's ``[tool.colearn.lint]`` and baseline) and
``sentinel`` the ``[tool.colearn.slo]`` rules over ``results/``, with
JAX's flags, output and exit codes; neither imports torch.  ``configs``,
``trace-summary``, ``health``, ``postmortem``, ``top``, ``converge``,
``lint`` and ``sentinel`` print JAX's text, not a JSON result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import sys
import threading
import time
from typing import Callable, Optional

from colearn_federated_learning_tpu_torch.utils.config import (
    CONFIGS, ExperimentConfig, get_config)

_FED_KEYS = {"rounds", "cohort_size", "local_epochs", "local_steps",
             "batch_size", "lr", "lr_schedule", "warmup_rounds",
             "lr_min_fraction", "momentum", "local_optimizer", "strategy",
             "prox_mu", "aggregator", "trim_fraction", "dp_clip",
             "dp_noise_multiplier", "dp_delta", "dp_adaptive_clip",
             "dp_target_quantile", "dp_clip_lr", "dp_bit_noise",
             "secure_agg", "secure_agg_neighbors", "straggler_prob",
             "edge_groups", "edge_sync_period", "compress",
             "compress_feedback", "topk_fraction", "min_cohort_fraction",
             "compress_down", "topk_adaptive", "topk_min_fraction",
             "topk_max_fraction", "lora_rank", "lora_alpha",
             "lora_merge_every"}
_DATA_KEYS = {"num_clients", "dataset", "partition", "dirichlet_alpha"}
_MODEL_KEYS = {"attn_impl", "remat", "width", "stem", "norm"}
_RUN_KEYS = {"seed", "tp_size", "eval_every", "log_every", "evict_after",
             "worker_enroll_timeout", "comm_retries", "comm_backoff_base",
             "comm_backoff_max", "fault_plan", "fault_seed", "fold_device",
             "num_aggregators", "agg_heartbeat_timeout",
             "agg_buffer_interval_s", "trace_dir", "trace_rounds",
             "health_dir", "checkpoint_dir", "checkpoint_every",
             "ckpt_stream", "profile_dir", "learn_observe"}


def _add_override_flags(p: argparse.ArgumentParser) -> None:
    """The config overrides every subcommand but ``bench`` takes."""
    p.add_argument("--config", default="mnist_mlp_fedavg",
                   help=f"experiment config; one of {sorted(CONFIGS)}")
    p.add_argument("--backend", choices=["gpu", "cpu"], default="gpu",
                   help="the card (default; raises without one) or the CPU")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--rounds", type=int, default=None)
    p.add_argument("--num-clients", type=int, default=None)
    p.add_argument("--cohort-size", type=int, default=None)
    p.add_argument("--local-epochs", type=int, default=None)
    p.add_argument("--local-steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr-schedule", default=None,
                   choices=["constant", "cosine", "warmup_cosine"])
    p.add_argument("--warmup-rounds", type=int, default=None)
    p.add_argument("--lr-min-fraction", type=float, default=None)
    p.add_argument("--momentum", type=float, default=None)
    p.add_argument("--local-optimizer", default=None,
                   choices=["sgd", "adam", "adamw"])
    p.add_argument("--strategy", default=None,
                   choices=["fedavg", "fedprox", "fedadam", "fedyogi",
                            "scaffold", "fednova"])
    p.add_argument("--prox-mu", type=float, default=None)
    p.add_argument("--aggregator", default=None,
                   choices=["mean", "median", "trimmed_mean", "krum"])
    p.add_argument("--trim-fraction", type=float, default=None)
    p.add_argument("--dataset", default=None)
    p.add_argument("--partition", default=None,
                   choices=["iid", "dirichlet", "pathological"])
    p.add_argument("--dirichlet-alpha", type=float, default=None)
    p.add_argument("--dp-clip", type=float, default=None)
    p.add_argument("--dp-noise-multiplier", type=float, default=None)
    p.add_argument("--dp-delta", type=float, default=None,
                   help="δ at which the RDP accountant reports ε")
    p.add_argument("--dp-adaptive-clip", action="store_true", default=None,
                   help="track the --dp-target-quantile of update norms "
                        "(--dp-clip becomes the initial norm)")
    p.add_argument("--dp-target-quantile", type=float, default=None)
    p.add_argument("--dp-clip-lr", type=float, default=None)
    p.add_argument("--dp-bit-noise", type=float, default=None,
                   help="σ_b on the quantile-bit sum (0 = cohort/20)")
    p.add_argument("--secure-agg", action="store_true", default=None)
    p.add_argument("--secure-agg-neighbors", type=int, default=None,
                   help="k-regular random-ring masking (0 = all pairs)")
    p.add_argument("--straggler-prob", type=float, default=None)
    p.add_argument("--eval-every", type=int, default=None)
    p.add_argument("--log-every", type=int, default=None,
                   help="hand every Nth round's record (and the last) to "
                        "the log; the summary's rates are over those")
    p.add_argument("--edge-groups", type=int, default=None,
                   help=">= 2 turns on hierarchical edge->cloud federation "
                        "(fed/hierarchical.py)")
    p.add_argument("--edge-sync-period", type=int, default=None)
    p.add_argument("--attn-impl", default=None,
                   choices=["dense", "flash", "ring", "ulysses"],
                   help="attention core (models/attention.py); ring and "
                        "ulysses need a seq mesh axis (torchrun), and run "
                        "the dense core on one device")
    p.add_argument("--remat", action="store_true", default=None,
                   help="checkpoint each transformer block's activations "
                        "(recomputed in the backward pass)")
    p.add_argument("--tp-size", type=int, default=None,
                   help="model (tensor-parallel) axis size of the "
                        "torchrun mesh; warns and runs untiled when it "
                        "does not divide the world")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--stem", default=None, choices=["conv", "space_to_depth"])
    p.add_argument("--norm", default=None, choices=["group", "none"])
    p.add_argument("--compress", default=None,
                   choices=["none", "int8", "topk", "topk8"],
                   help="uplink codec of train --role client's update file "
                        "and of a worker's update")
    p.add_argument("--compress-feedback", action="store_true", default=None,
                   help="train --role client: carry the compression "
                        "residual to the next round (--residual-path)")
    p.add_argument("--topk-fraction", type=float, default=None,
                   help="keep density of the topk codecs")
    p.add_argument("--min-cohort-fraction", type=float, default=None,
                   help="aggregate: the share of update files that must "
                        "be usable for the round to commit")
    p.add_argument("--compress-down", default=None,
                   choices=["none", "int8", "topk"],
                   help="coordinate: downlink codec of the broadcast")
    p.add_argument("--topk-adaptive", action="store_true", default=None,
                   help="worker: steer the topk density off the feedback "
                        "residual's norm")
    p.add_argument("--topk-min-fraction", type=float, default=None)
    p.add_argument("--topk-max-fraction", type=float, default=None)
    p.add_argument("--lora-rank", type=int, default=None,
                   help="coordinate/worker: rank-r LoRA adapter federation "
                        "(fed/lora.py); workers train and ship rank-r "
                        "factors instead of dense deltas (0 = off)")
    p.add_argument("--lora-alpha", type=float, default=None,
                   help="LoRA scaling numerator: the merged delta is "
                        "B·A·(alpha/rank)")
    p.add_argument("--lora-merge-every", type=int, default=None,
                   help="coordinate: merge the aggregated factors into the "
                        "global model every N aggregations")
    p.add_argument("--fold-device", action="store_true", default=None,
                   help="coordinate: fold the updates with the fold "
                        "kernel on the card")
    p.add_argument("--evict-after", type=int, default=None,
                   help="coordinate: evict a device after this many "
                        "failed rounds in a row")
    p.add_argument("--num-aggregators", type=int, default=None,
                   help="coordinate: fan the round out through this many "
                        "aggregator processes (0 = flat)")
    p.add_argument("--agg-heartbeat-timeout", type=float, default=None,
                   help="coordinate: an aggregator whose heartbeat is older "
                        "than this many seconds is dead")
    p.add_argument("--agg-buffer-interval", type=float, default=None,
                   dest="agg_buffer_interval_s",
                   help="coordinate --async-buffer with aggregators: each "
                        "slice buffer aims at one partial per this many "
                        "seconds (its depth follows the slice's arrival "
                        "rate)")
    p.add_argument("--comm-retries", type=int, default=None)
    p.add_argument("--comm-backoff-base", type=float, default=None)
    p.add_argument("--comm-backoff-max", type=float, default=None)
    p.add_argument("--worker-enroll-timeout", type=float, default=None,
                   help="worker: seconds to wait for a role")
    p.add_argument("--fault-plan", default=None,
                   help="broker/worker/coordinate: install this FaultPlan "
                        "JSON on the process's transport")
    p.add_argument("--fault-seed", type=int, default=None)
    p.add_argument("--log-file", default=None)
    p.add_argument("--tensorboard-dir", default=None,
                   help="mirror scalar round metrics to TensorBoard")
    p.add_argument("--trace-dir", default=None,
                   help="write a Chrome-trace JSON of per-round phase spans "
                        "here (open in Perfetto / chrome://tracing, or use "
                        "`trace-summary`)")
    p.add_argument("--trace-rounds", type=int, default=None,
                   help="span-trace only the first N rounds (0 = all)")
    p.add_argument("--health-dir", default=None,
                   help="per-device health ledger directory "
                        "(telemetry/health.py): coordinator/aggregator "
                        "durably record deadline misses, retries, latency "
                        "sketches per device (`health` reads it)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save the server state here (train, coordinate); "
                        "--resume restores the latest step")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="save every N rounds (the last round always "
                        "saves with --checkpoint-dir)")
    p.add_argument("--ckpt-stream", action="store_true", default=None,
                   help="coordinate: streaming checkpoints "
                        "(ckpt/streaming.py): CRC-checked shard files and "
                        "a manifest commit marker written last, in the "
                        "JAX package's format")
    p.add_argument("--profile-dir", default=None,
                   help="train: write a torch.profiler Chrome trace of "
                        "rounds 1-2 here (the card's kernels included)")
    p.add_argument("--learn-observe", action="store_true", default=None,
                   help="convergence observatory "
                        "(telemetry/convergence.py): stamp conv_* "
                        "learning-health keys (update norm, cosine to "
                        "the previous update, EWMA trend) on the "
                        "coordinators' records and export learn.* "
                        "metrics; `converge` renders the report")


def _add_observability_flags(p: argparse.ArgumentParser) -> None:
    """The flight recorder's and the export plane's flags (JAX's)."""
    p.add_argument("--flight-dir", default=None,
                   help="crash flight recorder: heartbeat-rewrite a "
                        "bounded black box (flight_<pid>.json) here; it "
                        "survives SIGKILL up to one heartbeat of staleness "
                        "(`postmortem` reads these)")
    p.add_argument("--flight-heartbeat", type=float, default=5.0,
                   help="flight-recorder rewrite period in seconds")
    p.add_argument("--flight-watchdog", type=float, default=None,
                   help="declare a stall (and dump) after this many "
                        "seconds without round progress")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve /metrics (Prometheus text) and "
                        "/snapshot.json on 127.0.0.1:<port>; 0 binds an "
                        "ephemeral port announced as a metrics_port "
                        "event on stderr")
    p.add_argument("--events-file", default=None,
                   help="append lifecycle + round events as JSONL here "
                        "(push half of the export plane)")


def _async_buffer_arg(value: str):
    """``--async-buffer``: 0 (off), a positive int K, or ``auto``."""
    if value == "auto":
        return "auto"
    try:
        return int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer or 'auto', got {value!r}") from None


def build_parser() -> argparse.ArgumentParser:
    from colearn_federated_learning_tpu_torch import bench

    parser = argparse.ArgumentParser(
        prog="python -m colearn_federated_learning_tpu_torch.cli",
        description="colearn on PyTorch (the CUDA port)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("train", help="run federated training")
    _add_override_flags(p)
    p.add_argument("--role", choices=["sim", "client"], default="sim")
    p.add_argument("--client-id", type=int, default=None)
    p.add_argument("--global-model", default=None,
                   help="global model npz (client role)")
    p.add_argument("--out", default=None,
                   help="update npz to write (client role)")
    p.add_argument("--residual-path", default=None,
                   help="client role: persist the uplink error-feedback "
                        "compression residual here across file-plane "
                        "rounds (--compress-feedback)")
    p.add_argument("--per-client-eval", action="store_true", default=None,
                   help="report the final model's per-client accuracy "
                        "spread (stderr)")
    p.add_argument("--resume", action="store_true", default=None,
                   help="restore the latest checkpoint of --checkpoint-dir "
                        "and run the remaining rounds")
    p.add_argument("--personalize-steps", type=int, default=0,
                   help="fine-tune-then-eval personalization probe: N "
                        "local steps per client on half its shard, scored "
                        "on the held-out half (stderr)")
    p.add_argument("--detection-eval", action="store_true",
                   help="detection-oriented held-out report (per-class "
                        "P/R/F1, alarm detection/false-alarm rates; class "
                        "0 = benign; stderr)")

    p = sub.add_parser("init", help="write an initial global model file")
    _add_override_flags(p)
    p.add_argument("--out", required=True)

    p = sub.add_parser("aggregate",
                       help="fold client update files into a new global model")
    _add_override_flags(p)
    p.add_argument("--global-model", required=True)
    p.add_argument("--updates", nargs="+", required=True)
    p.add_argument("--out", required=True)

    p = sub.add_parser("eval", help="evaluate a global model file")
    _add_override_flags(p)
    p.add_argument("--global-model", required=True)
    p.add_argument("--detection-eval", action="store_true",
                   help="add the anomaly-detection report (per-class "
                        "P/R/F1, alarm detection/false-alarm rates)")

    sub.add_parser("configs", help="list experiment configs")

    sub.add_parser("bench", help="run the headline benchmark",
                   parents=[bench.build_parser(add_help=False)])

    p = sub.add_parser("broker", help="run the pub/sub control-plane broker")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    _add_observability_flags(p)

    p = sub.add_parser("worker", help="run a device worker process")
    _add_override_flags(p)
    p.add_argument("--client-id", type=int, default=None)
    p.add_argument("--broker-host", default="127.0.0.1")
    p.add_argument("--broker-port", type=int, required=True)
    p.add_argument("--mud-profile", default=None,
                   help="path to this device's RFC 8520 MUD JSON, "
                        "announced on enrollment")
    _add_observability_flags(p)

    p = sub.add_parser("aggregator", help="run one aggregator-tree process: "
                                          "fold a cohort slice, send one "
                                          "partial sum up")
    _add_override_flags(p)
    p.add_argument("--agg-id", type=int, default=None)
    p.add_argument("--broker-host", default="127.0.0.1")
    p.add_argument("--broker-port", type=int, required=True)
    p.add_argument("--heartbeat", type=float, default=0.5,
                   help="retained-announce heartbeat period (s); the "
                        "coordinator's liveness signal")
    _add_observability_flags(p)

    p = sub.add_parser("coordinate", help="run the federated coordinator "
                                          "over enrolled workers")
    _add_override_flags(p)
    p.add_argument("--broker-host", default="127.0.0.1")
    p.add_argument("--broker-port", type=int, required=True)
    p.add_argument("--min-devices", type=int, default=2)
    p.add_argument("--enroll-timeout", type=float, default=60.0)
    p.add_argument("--round-timeout", type=float, default=120.0)
    p.add_argument("--no-evaluator", action="store_true")
    p.add_argument("--elastic", action="store_true",
                   help="admit late-joining workers between rounds")
    p.add_argument("--per-client-eval", action="store_true",
                   help="report each trainer's own-shard accuracy after "
                        "training (stderr)")
    p.add_argument("--per-type", action="store_true",
                   help="one federation per MUD device type over the "
                        "broker (comm/per_type.py)")
    p.add_argument("--min-per-type", type=int, default=2,
                   help="with --per-type: the fewest devices of a type that "
                        "get their own federation")
    p.add_argument("--mud-require-profile", action="store_true",
                   help="refuse devices that enroll without a MUD profile")
    p.add_argument("--mud-allowed-types", default=None,
                   help="comma-separated device types admitted")
    p.add_argument("--async-buffer", type=_async_buffer_arg, default=0,
                   help="> 0: buffered-asynchronous aggregation, the "
                        "staleness-weighted mean applied every N updates "
                        "instead of synchronous rounds; 'auto' sizes N "
                        "from the observed arrival rate")
    p.add_argument("--async-observe", action="store_true",
                   help="stamp the observatory keys (contribution mass, "
                        "arrival rate, staleness tail) into the async "
                        "records (implied by --async-buffer auto)")
    p.add_argument("--async-prune-after", type=int, default=0,
                   help="pause a device's pump after this many "
                        "consecutive too-stale discards (needs "
                        "--health-dir)")
    p.add_argument("--async-prune-score", type=float, default=0.0,
                   help="pause pumps whose health score reaches this; 0 "
                        "disables (needs --health-dir)")
    p.add_argument("--async-probation", type=int, default=8,
                   help="aggregations a paused device sits out")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint of --checkpoint-dir "
                        "(cold start when there is none); the synchronous "
                        "coordinator then readmits only the devices its "
                        "enrollment ledger verifies")
    _add_observability_flags(p)

    p = sub.add_parser("trace-summary",
                       help="print a per-phase time breakdown of a "
                            "--trace-dir Chrome-trace JSON file")
    p.add_argument("trace_file", help="path to the *_trace.json file")
    p.add_argument("--root", default="round",
                   help="span name used as the per-round denominator")

    p = sub.add_parser("health",
                       help="per-device fleet health from a --health-dir "
                            "run: top offenders, straggler tail, "
                            "per-aggregator skew")
    p.add_argument("health_dir",
                   help="directory holding health_*.jsonl ledgers "
                        "(searched recursively)")
    p.add_argument("--top", type=int, default=10,
                   help="offender rows to show")
    p.add_argument("--format", choices=["text", "json"], default="text")

    p = sub.add_parser("postmortem",
                       help="merge crash flight dumps (--flight-dir) with "
                            "the round WAL into a who-died-where report")
    p.add_argument("flight_dir",
                   help="directory holding flight_<pid>.json dumps "
                        "(searched recursively)")
    p.add_argument("--wal-dir", default=None,
                   help="checkpoint dir holding round_wal.jsonl (or the "
                        "file itself) to reconcile rounds against")
    p.add_argument("--checkpoint-step", type=int, default=None,
                   help="latest durable checkpoint round; WAL entries "
                        "past it count as in flight, not committed")
    p.add_argument("--format", choices=["text", "json"], default="text")

    p = sub.add_parser("chaos",
                       help="run a chaos soak: a tiny federation under an "
                            "injected fault plan (in this process) or real "
                            "SIGKILLs (--mp, --agg, --async, --tree-async), "
                            "reporting recovery")
    p.add_argument("--backend", choices=["gpu", "cpu"], default="gpu",
                   help="the card (default; raises without one) or the "
                        "CPU, for the soak and every process it starts")
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--round-timeout", type=float, default=6.0,
                   help="per-round deadline of the faulted rounds (the "
                        "warm-up round gets a generous one)")
    p.add_argument("--fault-plan", default=None,
                   help="JSON fault-plan file; default is the canned "
                        "acceptance plan (faults/soak.py)")
    p.add_argument("--fault-seed", type=int, default=None)
    p.add_argument("--no-faults", action="store_true",
                   help="run the soak without any plan (baseline)")
    p.add_argument("--compress-down", default=None,
                   choices=["none", "int8", "topk"],
                   help="soak with downlink delta compression on")
    p.add_argument("--secure", action="store_true",
                   help="secure-aggregation exactness gate: a DH masked "
                        "federation against a plain FedAvg oracle in "
                        "lockstep under the dropout plan")
    p.add_argument("--mp", action="store_true",
                   help="multi-process soak: broker, coordinator and "
                        "workers as real subprocesses, real SIGKILL on the "
                        "canned schedule (coordinator included: --resume)")
    p.add_argument("--agg", action="store_true",
                   help="aggregator-tree failover gate: a 2-aggregator "
                        "federation with one aggregator SIGKILLed "
                        "mid-round, final params against a flat oracle")
    p.add_argument("--async", dest="chaos_async", action="store_true",
                   help="asynchronous-plane gate: the asynchronous "
                        "coordinator SIGKILLed mid-aggregation and resumed "
                        "with --resume, against a kill-free baseline "
                        "(version monotonicity, the accountant's replay, "
                        "the loss tail)")
    p.add_argument("--tree-async", dest="chaos_tree_async",
                   action="store_true",
                   help="the asynchronous plane through 2 aggregators: "
                        "aggregator 0 SIGKILLed mid-aggregation and left "
                        "dead, the broker killed and rebound, against a "
                        "kill-free tree oracle (no double fold, the "
                        "re-home attributed, the loss tail)")
    p.add_argument("--ckpt", action="store_true",
                   help="streaming-checkpoint gate: a --ckpt-stream "
                        "federation is SIGKILLed mid-save and resumed at "
                        "another --tp-size, restoring the last committed "
                        "generation bitwise (--no-faults: a kill-free "
                        "resume of the final generation)")
    p.add_argument("--lock-witness", action="store_true",
                   help="(--async/--tree-async) run every process of the "
                        "fleets under the lock witness (faults/lockwitness) "
                        "and gate on no ordering inversion and no "
                        "unguarded access")
    p.add_argument("--workdir", default=None,
                   help="--mp/--agg/--async/--tree-async scratch dir for "
                        "checkpoints, flight dumps and process logs "
                        "(default: a fresh temp dir)")
    p.add_argument("--mp-round-timeout", type=float, default=120.0,
                   help="--mp/--agg/--async/--tree-async per-round (or "
                        "per-request) deadline")
    p.add_argument("--mp-timeout", type=float, default=600.0,
                   help="whole-soak wall-clock backstop of the process "
                        "soaks; a hung federation is killed and reported")

    _add_fleetsim_parser(sub)

    p = sub.add_parser("top",
                       help="live terminal view of a --metrics-port "
                            "process: round rate, cohort health, faults, "
                            "device memory")
    p.add_argument("--port", type=int, default=9100,
                   help="metrics port of the process to watch")
    p.add_argument("--url", default=None,
                   help="full /snapshot.json URL (overrides --port)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh period in seconds")
    p.add_argument("--once", action="store_true",
                   help="print one snapshot and exit (no screen clear)")

    p = sub.add_parser("converge",
                       help="round-over-round learning report from a "
                            "--learn-observe run's JSONL (update norm / "
                            "cosine / trend per round)")
    p.add_argument("results",
                   help="JSONL file, or directory searched recursively "
                        "for *.jsonl")

    p = sub.add_parser("lint",
                       help="run the AST invariant checks (CL002-CL021, "
                            "CL023; analysis/) — fast, CPU-only, no torch "
                            "import")
    p.add_argument("paths", nargs="*",
                   help="files/dirs to lint (default: this package)")
    p.add_argument("--format", choices=["text", "json", "sarif"],
                   default="text")
    p.add_argument("--gate", action="store_true",
                   help="CI gate: additionally fail when the baseline file "
                        "still carries accepted fingerprints — every "
                        "suppression must be an inline reasoned noqa")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids to run (default: all "
                        "registered)")
    p.add_argument("--disable", default=None,
                   help="comma-separated rule ids to skip")
    p.add_argument("--baseline", default=None,
                   help="baseline JSON path relative to --root (default: "
                        "[tool.colearn.lint].baseline)")
    p.add_argument("--write-baseline", action="store_true",
                   help="accept every current finding into the baseline "
                        "file and exit 0")
    p.add_argument("--root", default=None,
                   help="repo root holding pyproject.toml + baseline "
                        "(default: cwd, else the package parent)")

    p = sub.add_parser("sentinel",
                       help="evaluate [tool.colearn.slo] rules against "
                            "results/*.jsonl; non-zero exit on any "
                            "regression (the CI perf gate)")
    p.add_argument("--root", default=None,
                   help="repo root holding pyproject.toml and the "
                        "rule-referenced result files (default: cwd, else "
                        "the package parent)")
    p.add_argument("--format", choices=["text", "json"], default="text")
    return parser


def _add_fleetsim_parser(sub) -> None:
    """``fleetsim``'s flags and defaults: JAX's, with ``--backend``."""
    p = sub.add_parser("fleetsim",
                       help="simulate a 1k-1M device fleet: chunked "
                            "rounds over a synthetic population with a "
                            "traffic model (fleetsim/)")
    p.add_argument("--backend", choices=["gpu", "cpu"], default="gpu",
                   help="the card (default; raises without one) or the CPU")
    p.add_argument("--devices", type=int, default=10_000)
    p.add_argument("--cohort", type=int, default=1024)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--chunk", type=int, default=1024,
                   help="chunk size: memory is O(chunk), the cohort runs "
                        "in cohort/chunk chunks")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--feature-dim", type=int, default=32)
    p.add_argument("--capacity", type=int, default=32,
                   help="padded per-device shard size")
    p.add_argument("--label-skew", type=float, default=0.7,
                   help="P(label == device home class); non-IID knob")
    p.add_argument("--base-rate", type=float, default=2.0,
                   help="mean device check-ins per hour")
    p.add_argument("--diurnal", type=float, default=0.8,
                   help="day/night availability swing in [0, 1]")
    p.add_argument("--round-minutes", type=float, default=10.0)
    p.add_argument("--strategy", default="fedavg",
                   choices=["fedavg", "fedprox", "fedadam", "fedyogi"])
    p.add_argument("--local-steps", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--hidden-dim", type=int, default=64)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--compress", default="none",
                   choices=["none", "int8", "topk", "topk8"],
                   help="uplink scheme for the byte estimates")
    p.add_argument("--lora-rank", type=int, default=0,
                   help="rank-r adapter federation: price the "
                        "factor-frame uplink (bytes_up_saved_est; "
                        "training stays dense in the sim)")
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--compress-down", default="none",
                   choices=["none", "int8", "topk"])
    p.add_argument("--fault-plan", default=None,
                   help="JSON fault plan; (device, round, op='train') "
                        "keys drive per-simulated-device drop/"
                        "straggle/corrupt")
    p.add_argument("--fault-seed", type=int, default=None)
    p.add_argument("--trace-dir", default=None,
                   help="write the sweep's span trace (fleet_round/"
                        "train_chunks/train_chunk) as a Chrome-trace "
                        "JSON here; read with `trace-summary`")
    p.add_argument("--async-buffer", type=_async_buffer_arg, default=0,
                   help="> 0 runs the buffered-ASYNC simulation "
                        "instead of sync rounds: fold every N "
                        "arrival-ordered completions with staleness "
                        "weighting (FleetSim.fit_async); --rounds "
                        "then counts aggregations; 'auto' sizes N "
                        "from the observed arrival rate")
    p.add_argument("--async-observe", action="store_true",
                   help="async mode: stamp observatory keys "
                        "(staleness tail, contribution mass, EWMA "
                        "arrival rate) into records (implied by "
                        "--async-buffer auto)")
    p.add_argument("--async-max-staleness", type=int, default=10,
                   help="async mode: discard updates staler than "
                        "this many versions (wasted compute)")
    p.add_argument("--async-prune-after", type=int, default=0,
                   help="async mode: stop re-dispatching a device "
                        "after this many CONSECUTIVE too-stale "
                        "discards (0 = off)")
    p.add_argument("--aggregators", type=int, default=0,
                   help="async mode: two-tier tree -- devices "
                        "sliced by service time across N per-"
                        "slice auto-K buffers, partials folded "
                        "unscaled at the edge and staleness-"
                        "discounted at the root against the "
                        "OLDEST constituent (0 = flat async)")
    p.add_argument("--async-probation", type=int, default=8,
                   help="async mode: aggregations a pruned device "
                        "sits out before re-admission")
    p.add_argument("--learn-observe", action="store_true",
                   help="convergence observatory: stamp conv_* "
                        "learning-health keys (update norm / cosine / "
                        "trend, per-cohort drift skew) on round records; "
                        "`converge` renders them")


def config_from_args(args: argparse.Namespace) -> ExperimentConfig:
    """The named config with the command line's overrides applied."""
    cfg = get_config(args.config)
    sections = {"fed": {}, "data": {}, "model": {}, "run": {}}
    for key, val in vars(args).items():
        if val is None:
            continue
        for section, keys in (("fed", _FED_KEYS), ("data", _DATA_KEYS),
                              ("model", _MODEL_KEYS), ("run", _RUN_KEYS)):
            if key in keys:
                sections[section][key] = val
    return cfg.replace(**{
        name: dataclasses.replace(getattr(cfg, name), **values)
        for name, values in sections.items()})


def refuse_edge_unsupported(args: argparse.Namespace,
                            config: ExperimentConfig) -> None:
    """Exit with status 2 and the JAX command line's message if the
    hierarchical path is asked for with a flag it does not support."""
    if config.fed.edge_groups < 2:
        return
    unsupported = [
        flag for flag, dest in [
            ("--resume", "resume"), ("--per-client-eval", "per_client_eval"),
            ("--detection-eval", "detection_eval"),
            ("--personalize-steps", "personalize_steps"),
            ("--checkpoint-dir", "checkpoint_dir"),
            ("--profile-dir", "profile_dir"), ("--trace-dir", "trace_dir"),
        ] if getattr(args, dest)]
    if unsupported:
        print(f"--edge-groups does not support {', '.join(unsupported)}",
              file=sys.stderr)
        raise SystemExit(2)


def train(args: argparse.Namespace,
          on_round: Optional[Callable] = None) -> dict:
    """``train``: build the learner (hierarchical when ``--edge-groups``
    >= 2), fit, evaluate; returns the summary.  ``on_round(learner,
    record)`` is called before the first round (with ``record`` None) and
    with each logged record.  The flat summary's rates are taken over the
    logged records' ``round_time_s``, which excludes evaluation.  The lead
    rank also logs the records to ``--log-file`` and ``--tensorboard-dir``;
    with ``--trace-dir`` the summary names the trace file."""
    from colearn_federated_learning_tpu_torch.fed import (
        FederatedLearner, HierarchicalLearner)
    from colearn_federated_learning_tpu_torch.metrics import MetricsLogger

    config = config_from_args(args)
    device = "cuda" if args.backend == "gpu" else "cpu"
    t_start = time.perf_counter()
    if config.fed.edge_groups >= 2:
        learner = HierarchicalLearner(
            config, num_groups=config.fed.edge_groups,
            sync_period=config.fed.edge_sync_period, device=device)
    else:
        learner = FederatedLearner.from_config(config, device=device)
    lead = is_lead()            # the world exists once the learner does
    with MetricsLogger(path=args.log_file if lead else None,
                       name=config.run.name,
                       tensorboard_dir=(args.tensorboard_dir if lead
                                        else None)) as logger:
        return _fit(args, config, learner, on_round, logger, t_start)


def _fit(args: argparse.Namespace, config: ExperimentConfig, learner,
         on_round: Optional[Callable], logger, t_start: float) -> dict:
    """``train``'s fit and summary (see :func:`train`)."""
    from colearn_federated_learning_tpu_torch.fed import evaluation

    lead = is_lead()
    if args.resume:
        step = learner.restore_checkpoint()
        if lead:
            print(f"resumed at round {step}", file=sys.stderr, flush=True)
    if on_round is not None:
        on_round(learner, None)
    records = []

    def log_fn(rec: dict) -> None:
        records.append(rec)
        if lead:
            logger.log(rec)
            print(json.dumps(rec), file=sys.stderr, flush=True)
        if on_round is not None:
            on_round(learner, rec)

    learner.fit(log_fn=log_fn)
    if config.fed.edge_groups >= 2:
        # fit() ends on a synced, evaluated round: its score is the cloud
        # model's.
        last = learner.history[-1] if learner.history else {}
        loss, acc = ((last["eval_loss"], last["eval_acc"])
                     if "eval_loss" in last else learner.evaluate())
        return {"name": config.run.name, "rounds": len(learner.history),
                "edge_groups": config.fed.edge_groups,
                "final_loss": loss, "final_acc": acc,
                "data_source": learner.dataset.source}
    def dump_report(report: dict) -> None:
        if lead:
            print(json.dumps(evaluation.sanitize_report(report)),
                  file=sys.stderr, flush=True)

    if args.per_client_eval:
        dump_report(learner.evaluate_per_client())
    if args.personalize_steps:
        dump_report(learner.evaluate_personalized(
            steps=args.personalize_steps))
    if args.detection_eval:
        dump_report(learner.evaluate_detection())
    n_chips = (learner.mesh.mesh.numel() if learner.mesh is not None else 1)
    out = {"name": config.run.name, "rounds": len(records),
           "elapsed_s": time.perf_counter() - t_start,
           "device": str(learner.device), "n_chips": n_chips}
    timed = [r["round_time_s"] for r in records]
    if timed:
        out["rounds_per_sec"] = len(timed) / sum(timed)
        samples = (learner.cohort_size * learner.num_steps
                   * config.fed.batch_size)
        out["client_samples_per_sec_per_chip"] = (
            out["rounds_per_sec"] * samples / n_chips)
    accs = [(r["round"], r["eval_acc"]) for r in records if "eval_acc" in r]
    if accs:
        out["final_acc"] = accs[-1][1]
        out["best_acc"] = max(a for _, a in accs)
        out["acc_at_round"] = dict(accs)
    losses = [r["eval_loss"] for r in records if "eval_loss" in r]
    if losses:
        out["final_loss"] = losses[-1]
    if records and "dp_epsilon" in records[-1]:
        out["dp_epsilon"] = records[-1]["dp_epsilon"]
        out["dp_delta"] = records[-1]["dp_delta"]
    out["data_source"] = learner.dataset.source
    if learner.last_trace_path:
        out["trace_file"] = learner.last_trace_path
    return out


def is_lead() -> bool:
    """Rank 0 of the world, or a plain process: the one that prints."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _device(args: argparse.Namespace) -> str:
    return "cuda" if args.backend == "gpu" else "cpu"


def client(args: argparse.Namespace) -> dict:
    """``train --role client``: one silo's round against a global-model
    file, its update written to ``--out`` (``fed/offline.client_update``)."""
    from colearn_federated_learning_tpu_torch.fed import offline

    if args.client_id is None or not args.global_model or not args.out:
        print("train --role client requires --client-id, --global-model, "
              "--out", file=sys.stderr)
        raise SystemExit(2)
    return offline.client_update(
        config_from_args(args), args.client_id, args.global_model, args.out,
        residual_path=args.residual_path, device=_device(args))


def init(args: argparse.Namespace) -> dict:
    from colearn_federated_learning_tpu_torch.fed import offline

    offline.init_global_model(config_from_args(args), args.out,
                              device=_device(args))
    return {"out": args.out, "round": 0}


def aggregate(args: argparse.Namespace) -> dict:
    from colearn_federated_learning_tpu_torch.fed import offline

    return offline.aggregate_updates(config_from_args(args),
                                     args.global_model, args.updates,
                                     args.out, device=_device(args))


def evaluate(args: argparse.Namespace) -> dict:
    from colearn_federated_learning_tpu_torch.fed import offline

    return offline.evaluate_global(config_from_args(args), args.global_model,
                                   detection=args.detection_eval,
                                   device=_device(args))


def _install_fault_plan(config: ExperimentConfig) -> None:
    """Install ``--fault-plan`` on this process's transport; a no-op
    without it."""
    if not config.run.fault_plan:
        return
    from colearn_federated_learning_tpu_torch import faults

    plan = faults.FaultPlan.load(config.run.fault_plan,
                                 seed=config.run.fault_seed or None)
    faults.install(plan)
    print(f"fault plan installed: {len(plan.faults)} spec(s), "
          f"seed {plan.seed}", file=sys.stderr)


def _stop_event() -> threading.Event:
    """An event set by SIGINT or SIGTERM: a served process stops cleanly
    and exits 0."""
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    return stop


def _setup_flight(args: argparse.Namespace, role: str, device=None):
    """With ``--flight-dir``, install this process's flight recorder (the
    recorder half of JAX's ``_setup_observability``) and record the device
    the role runs on; returns it, or None.  A served process calls this
    after :func:`_stop_event`, so that the recorder's SIGTERM handler dumps
    and then chains to the clean exit."""
    if not args.flight_dir:
        return None
    from colearn_federated_learning_tpu_torch import telemetry

    recorder = telemetry.install_flight_recorder(
        args.flight_dir, role=role, heartbeat_s=args.flight_heartbeat,
        watchdog_s=args.flight_watchdog)
    if device is not None:
        import torch

        name = (torch.cuda.get_device_name(0) if device == "cuda"
                else "cpu")
        recorder.record("device", device=device, name=name)
    return recorder


def _setup_observability(args: argparse.Namespace, role: str,
                         device=None) -> tuple:
    """Install what the observability flags opted into (JAX's
    ``_setup_observability``): the flight recorder (:func:`_setup_flight`),
    the metrics exporter (its port announced on stderr as a
    ``metrics_port`` event) and the event log, which gets a ``start``
    event.  Returns ``(exporter, events, recorder)``, each None when
    off."""
    from colearn_federated_learning_tpu_torch import telemetry

    recorder = _setup_flight(args, role, device)
    exporter = events = None
    if args.metrics_port is not None:
        exporter = telemetry.MetricsExporter(port=args.metrics_port).start()
        print(json.dumps({"event": "metrics_port", "port": exporter.port}),
              file=sys.stderr, flush=True)
    if args.events_file:
        events = telemetry.EventLog(args.events_file)
        events.emit("start", role=role)
    return exporter, events, recorder


def _close_observability(exporter, events, role: str) -> None:
    """A ``stop`` event and the exporter's shutdown, as the process ends
    (JAX's broker does this; the port's other roles too)."""
    if events is not None:
        events.emit("stop", role=role)
        events.close()
    if exporter is not None:
        exporter.close()


def _round_hook(recorder, events=None) -> Callable[[dict], None]:
    """Print each record as one JSON line on stderr; with an event log,
    append its scalar fields as a ``round`` event; with a recorder, put
    it in the flight ring and mark progress for the watchdog (JAX's
    ``_obs_round_hook``)."""
    def hook(rec: dict) -> None:
        print(json.dumps(rec), file=sys.stderr, flush=True)
        _observe_record(rec, events, recorder)
    return hook


def _observe_record(rec: dict, events, recorder) -> None:
    if events is not None:
        events.emit("round", **{k: v for k, v in rec.items()
                                if isinstance(v, (int, float, str, bool))})
    if recorder is not None:
        recorder.record("round", round=rec.get("round"))
        recorder.mark_progress()


def broker(args: argparse.Namespace) -> None:
    """``broker``: print the address as one JSON line, serve until
    stopped."""
    from colearn_federated_learning_tpu_torch.comm.broker import MessageBroker

    stop = _stop_event()
    exporter, events, recorder = _setup_observability(args, "broker")
    b = MessageBroker(host=args.host, port=args.port).start()
    print(json.dumps({"host": b.host, "port": b.port}), flush=True)
    if recorder is not None:
        recorder.record("broker_listening", port=b.port)
    try:
        stop.wait()
    finally:
        b.stop()
        _close_observability(exporter, events, "broker")


def worker(args: argparse.Namespace) -> None:
    """``worker``: enroll on the broker and serve until stopped."""
    from colearn_federated_learning_tpu_torch.comm.worker import (
        run_worker_forever)

    config = config_from_args(args)
    if args.client_id is None:
        print("worker requires --client-id", file=sys.stderr)
        raise SystemExit(2)
    _install_fault_plan(config)
    stop = _stop_event()
    role = f"worker{args.client_id}"
    exporter, events, _ = _setup_observability(args, role, _device(args))
    mud = None
    if args.mud_profile:
        with open(args.mud_profile) as f:
            mud = f.read()
    try:
        run_worker_forever(config, args.client_id, args.broker_host,
                           args.broker_port, mud_profile=mud,
                           device=_device(args), stop=stop)
    finally:
        _close_observability(exporter, events, role)


def aggregator(args: argparse.Namespace) -> None:
    """``aggregator``: announce on the broker, heartbeat and serve folds
    until stopped; then, with ``--trace-dir``, write the tier's spans."""
    from colearn_federated_learning_tpu_torch.comm.aggregator import (
        run_aggregator_forever)

    config = config_from_args(args)
    if args.agg_id is None:
        print("aggregator requires --agg-id", file=sys.stderr)
        raise SystemExit(2)
    _install_fault_plan(config)
    stop = _stop_event()
    role = f"aggregator{args.agg_id}"
    exporter, events, _ = _setup_observability(args, role, _device(args))
    try:
        agg = run_aggregator_forever(
            config, args.agg_id, args.broker_host, args.broker_port,
            heartbeat_s=args.heartbeat, device=_device(args), stop=stop)
    finally:
        _close_observability(exporter, events, role)
    _write_trace(config, f"{config.run.name}_aggregator{args.agg_id}",
                 agg.tracer)


def _write_trace(config: ExperimentConfig, name: str, tracer) -> None:
    """With ``--trace-dir``, write ``tracer``'s spans (and the registry's
    snapshot) as Chrome-trace JSON, as JAX's coordinator does."""
    if not config.run.trace_dir:
        return
    from colearn_federated_learning_tpu_torch import telemetry

    path = telemetry.write_tracer(config.run.trace_dir, name, tracer,
                                  metrics=telemetry.get_registry().snapshot())
    print(f"trace written to {path}", file=sys.stderr)


def per_type(args: argparse.Namespace, config: ExperimentConfig,
             mud_policy, recorder=None, events=None) -> dict:
    """``coordinate --per-type``: one federation per MUD device type; each
    record goes to stderr with its ``type``.  The summary holds each
    type's last record, the skipped types and the failed ones; it is
    printed and the process exits 1 when a type failed or none ran."""
    from colearn_federated_learning_tpu_torch.comm.per_type import (
        PerTypeFederation)

    fed = PerTypeFederation(
        config, args.broker_host, args.broker_port,
        round_timeout=args.round_timeout, mud_policy=mud_policy,
        min_devices_per_type=args.min_per_type, device=_device(args))

    def log_line(t, rec):
        # One write per record: the federations log from their threads.
        sys.stderr.write(json.dumps({"type": t, **rec}) + "\n")
        sys.stderr.flush()
        _observe_record({"type": t, **rec}, events, recorder)

    try:
        hists = fed.run(min_devices=args.min_devices,
                        enroll_timeout=args.enroll_timeout,
                        want_evaluator=not args.no_evaluator,
                        log_fn=log_line)
    finally:
        fed.close()
    summary = {"types": {t: (h[-1] if h else None) for t, h in hists.items()},
               "skipped": fed.skipped, "errors": fed.errors}
    if not hists or fed.errors:
        print(json.dumps(summary), flush=True)
        raise SystemExit(1)
    return summary


def coordinate(args: argparse.Namespace) -> dict:
    """``coordinate``: enroll ``--min-devices`` (and, with
    ``--num-aggregators``, the aggregators), fit, and return the last
    record; every record goes to stderr as one JSON line (and, with
    ``--events-file``, into the event log as a ``round`` event)."""
    config = config_from_args(args)
    _install_fault_plan(config)
    exporter, events, recorder = _setup_observability(args, "coordinator",
                                                      _device(args))
    try:
        return _coordinate(args, config, recorder, events)
    finally:
        _close_observability(exporter, events, "coordinator")


def _coordinate(args: argparse.Namespace, config: ExperimentConfig,
                recorder, events) -> dict:
    """``coordinate``'s body, between the observability set-up and its
    close."""
    from colearn_federated_learning_tpu_torch.comm.coordinator import (
        FederatedCoordinator)

    mud_policy = None
    if args.mud_require_profile or args.mud_allowed_types:
        from colearn_federated_learning_tpu_torch.comm.mud import MudPolicy

        mud_policy = MudPolicy(
            require_profile=args.mud_require_profile,
            allowed_types=tuple(
                t for t in (args.mud_allowed_types or "").split(",") if t))
    if args.per_type:
        return per_type(args, config, mud_policy, recorder, events)
    if args.async_buffer:
        return coordinate_async(args, config, mud_policy, recorder, events)
    coord = FederatedCoordinator(config, args.broker_host, args.broker_port,
                                 round_timeout=args.round_timeout,
                                 want_evaluator=not args.no_evaluator,
                                 mud_policy=mud_policy, device=_device(args))
    if recorder is not None:
        recorder.attach_tracer(coord.tracer)
    with coord:
        if args.resume:
            _coordinator_resume(coord)
        coord.enroll(min_devices=args.min_devices,
                     timeout=args.enroll_timeout)
        if args.resume:
            # Challenge-on-resume: retained announcements alone readmit
            # nobody; ledger-known devices that answer the challenge do.
            verdict = coord.verify_resumed_devices()
            print(json.dumps({"event": "challenge_verified", **verdict}),
                  file=sys.stderr, flush=True)
        if coord.num_aggregators:
            aggs = coord.enroll_aggregators(timeout=args.enroll_timeout)
            print(json.dumps({"event": "aggregators_enrolled",
                              "aggregators": aggs}), file=sys.stderr,
                  flush=True)
        hist = coord.fit(log_fn=_round_hook(recorder, events),
                         elastic=args.elastic)
        if args.per_client_eval:
            from colearn_federated_learning_tpu_torch.fed import evaluation

            print(json.dumps(evaluation.sanitize_report(
                coord.evaluate_per_client())), file=sys.stderr, flush=True)
        _write_trace(config, config.run.name, coord.tracer)
    return hist[-1]


def _coordinator_resume(coord) -> None:
    """``coordinate --resume``: restore the latest checkpoint if there is
    one, else start cold; prints the event ``resume_cold`` or ``resumed``
    (with, for a streaming restore, the restored generation's digest, the
    generations discarded on the way and the re-cut count) on stderr."""
    from colearn_federated_learning_tpu_torch import telemetry

    try:
        step = coord.restore_checkpoint()
    except FileNotFoundError:
        print(json.dumps({"event": "resume_cold"}), file=sys.stderr,
              flush=True)
        return
    reg = telemetry.get_registry()
    event = {"event": "resumed", "round": step,
             "rounds_resumed_total": reg.counter(
                 "fed.rounds_resumed_total").value}
    ckpt = coord._ckpt
    digest = getattr(ckpt, "last_restore_digest", None)
    if digest is not None:
        event["ckpt_digest"] = digest
        event["ckpt_discarded"] = sum(ckpt.generations_discarded.values())
        event["resharded"] = reg.counter(
            "ckpt.resharded_resumes_total").value
    print(json.dumps(event), file=sys.stderr, flush=True)


def coordinate_async(args: argparse.Namespace, config: ExperimentConfig,
                     mud_policy, recorder=None, events=None) -> dict:
    """``coordinate --async-buffer N|auto``: the buffered-asynchronous
    coordinator (through the aggregators' slice buffers with
    ``--num-aggregators``) for the config's ``rounds`` aggregations;
    every record goes to stderr, the last is returned."""
    from colearn_federated_learning_tpu_torch.comm.async_coordinator import (
        AsyncFederatedCoordinator)

    coord = AsyncFederatedCoordinator(
        config, args.broker_host, args.broker_port,
        buffer_size=args.async_buffer, request_timeout=args.round_timeout,
        want_evaluator=not args.no_evaluator, mud_policy=mud_policy,
        prune_after=args.async_prune_after,
        prune_score=args.async_prune_score,
        probation=args.async_probation, observe=args.async_observe,
        device=_device(args))
    if recorder is not None:
        recorder.attach_tracer(coord.tracer)
    with coord:
        if args.resume:
            _coordinator_resume(coord)
        coord.enroll(min_devices=args.min_devices,
                     timeout=args.enroll_timeout)
        if coord.tree_mode:
            aggs = coord.enroll_aggregators(timeout=args.enroll_timeout)
            print(json.dumps({"event": "aggregators_enrolled",
                              "aggregators": aggs}), file=sys.stderr,
                  flush=True)
        hist = coord.fit(
            aggregations=max(0, config.fed.rounds - len(coord.history)),
            log_fn=_round_hook(recorder, events), elastic=args.elastic)
        _write_trace(config, config.run.name, coord.tracer)
    return hist[-1]


def trace_summary(args: argparse.Namespace) -> None:
    """``trace-summary``: the per-phase breakdown of a trace file; exits 2
    when the file cannot be read, as JAX's does."""
    from colearn_federated_learning_tpu_torch import telemetry

    try:
        doc = telemetry.load_trace(args.trace_file)
    except (OSError, ValueError) as e:
        print(f"cannot read trace {args.trace_file}: {e}", file=sys.stderr)
        raise SystemExit(2)
    print(telemetry.summarize_trace(doc, root=args.root))


def health(args: argparse.Namespace) -> None:
    """``health``: render the per-device ledgers of a ``--health-dir`` run;
    exits 2 when they cannot be read and 1 when they hold no device, as
    JAX's does."""
    from colearn_federated_learning_tpu_torch import telemetry

    try:
        devices = telemetry.load_health(args.health_dir)
    except (OSError, ValueError) as e:
        print(f"colearn health: cannot read {args.health_dir}: {e}",
              file=sys.stderr)
        raise SystemExit(2)
    if args.format == "json":
        print(json.dumps({d: h.to_dict() for d, h in devices.items()}))
    else:
        print(telemetry.render_health(devices, top=args.top))
    if not devices:
        raise SystemExit(1)


def postmortem(args: argparse.Namespace) -> None:
    """``postmortem``: merge the flight dumps with the round WAL (JAX's
    ``cmd_postmortem``): who died, of what, at which round, and which
    rounds were in flight.  Exits 1 when there is no dump, as JAX's
    does."""
    import os

    from colearn_federated_learning_tpu_torch import telemetry
    from colearn_federated_learning_tpu_torch.ckpt.wal import RoundWal

    dumps = telemetry.load_flight_dumps(args.flight_dir)
    wal_entries = None
    if args.wal_dir:
        wal_dir = args.wal_dir
        if os.path.isfile(wal_dir):           # the file path works too
            wal_dir = os.path.dirname(wal_dir) or "."
        wal_entries = RoundWal(wal_dir).load()
    report = telemetry.postmortem_report(
        dumps, wal_entries=wal_entries, checkpoint_step=args.checkpoint_step)
    if args.format == "json":
        print(json.dumps(report), flush=True)
    else:
        print(telemetry.render_postmortem(report), flush=True)
    if not dumps:
        raise SystemExit(1)


def _chaos_log(rec: dict) -> None:
    print(json.dumps(rec), file=sys.stderr, flush=True)


def _chaos_gate(summary: dict, ok: bool) -> dict:
    """A soak's (or a fleet simulation's) summary when its gate passed;
    otherwise it is printed and the process exits 1, as JAX's ``chaos``
    and ``fleetsim`` do."""
    if not ok:
        print(json.dumps(summary), flush=True)
        raise SystemExit(1)
    return summary


def _lock_witness_ok(summary: dict, args: argparse.Namespace) -> bool:
    """The lock witness's gate of ``--async`` and ``--tree-async`` (JAX's):
    with ``--lock-witness`` the fleets wrote reports that saw lock traffic
    and no ordering inversion or unguarded access."""
    if not args.lock_witness:
        return True
    lw = summary.get("lock_witness") or {}
    ok = (bool(lw.get("enabled"))
          and int(lw.get("reports", 0)) >= 1
          and int(lw.get("acquires", 0)) >= 1
          and int(lw.get("inversions", 0)) == 0
          and int(lw.get("unguarded", 0)) == 0)
    if not ok:
        brief = {k: lw.get(k) for k in ("enabled", "reports", "acquires",
                                        "inversions", "unguarded")}
        print(f"# lock-witness gate failed: {json.dumps(brief)}",
              file=sys.stderr)
        for rec in (lw.get("inversion_records", [])
                    + lw.get("unguarded_records", [])):
            print(f"#   {json.dumps(rec)}", file=sys.stderr)
    return ok


def _chaos_conflict(args: argparse.Namespace) -> Optional[str]:
    """JAX's refusal of a combination of chaos modes, or None."""
    if args.secure and args.mp:
        return "--secure is an in-process exactness gate; drop --mp"
    if args.agg and (args.secure or args.mp):
        return "--agg is its own multi-process gate; drop --secure/--mp"
    if args.chaos_async and (args.secure or args.mp or args.agg):
        return ("--async is its own multi-process gate; "
                "drop --secure/--mp/--agg")
    if args.chaos_tree_async and (args.secure or args.mp or args.agg
                                  or args.chaos_async):
        return ("--tree-async is its own multi-process gate; "
                "drop --secure/--mp/--agg/--async")
    if args.ckpt and (args.secure or args.mp or args.agg
                      or args.chaos_async or args.chaos_tree_async):
        return ("--ckpt is its own multi-process gate; "
                "drop --secure/--mp/--agg/--async/--tree-async")
    if args.lock_witness and not (args.chaos_async
                                  or args.chaos_tree_async):
        return ("--lock-witness instruments the buffered-async fleets; "
                "pair it with --async or --tree-async")
    return None


def chaos(args: argparse.Namespace) -> dict:
    """``chaos`` (JAX's ``cmd_chaos``, with its gates and exit codes).
    Default: broker, workers and coordinator in this process with a fault
    plan installed after the warm-up round (``faults/soak.py``).
    ``--secure``: a DH secure-aggregation federation against a plain
    FedAvg oracle in lockstep.  ``--mp``: broker, coordinator and workers
    as subprocesses, SIGKILLed on the canned schedule, the coordinator
    resumed with ``--resume`` (``faults/procsoak.py``).  ``--agg``: the
    aggregator tree with one aggregator SIGKILLed, against a flat oracle.
    ``--async``: the asynchronous coordinator SIGKILLed and resumed,
    against a kill-free baseline; ``--tree-async``: the asynchronous plane
    through 2 aggregators, one SIGKILLed and the broker rebound, against a
    kill-free tree oracle; ``--lock-witness`` runs those two fleets under
    the lock witness and gates on its reports.  ``--ckpt``: a
    ``--ckpt-stream`` federation at tp = 2 SIGKILLed mid-save and resumed
    at tp = 1, against a kill-free oracle (``--no-faults``: a finished
    run's last generation resumed at tp = 1).  JAX's conflicts between
    the modes exit 2 first."""
    from colearn_federated_learning_tpu_torch import faults
    from colearn_federated_learning_tpu_torch.faults import procsoak, soak

    conflict = _chaos_conflict(args)
    if conflict:
        print(conflict, file=sys.stderr)
        raise SystemExit(2)
    if args.ckpt:
        summary = procsoak.run_ckpt_soak(
            rounds=args.rounds, n_workers=args.num_workers,
            workdir=args.workdir, round_timeout=args.mp_round_timeout,
            timeout_s=args.mp_timeout, kill=not args.no_faults,
            log_fn=_chaos_log, backend=args.backend)
        if summary["mode"] == "smoke":
            # A tp = 2 run's final generation resumes at tp = 1 with the
            # digest the harness computed, across the re-cut.
            return _chaos_gate(summary, (
                summary["exit_code"] == 0
                and summary["resume_exit_code"] == 0
                and summary["rounds_run"] >= args.rounds
                and summary["resume_round_ok"]
                and summary["digest_ok"]
                and summary["reshard_ok"]))
        # The kill landed mid-save, the resume restored the last committed
        # generation bitwise across the tp change, the federation finished
        # near the oracle's loss, and the postmortem names the coordinator.
        return _chaos_gate(summary, (
            summary["exit_code"] == 0
            and summary["oracle_exit_code"] == 0
            and summary["rounds_run"] >= args.rounds
            and summary["killed_mid_save"]
            and summary["resumed"] >= 1
            and summary["resume_round_ok"]
            and summary["digest_ok"]
            and summary["reshard_ok"]
            and summary["loss_gap_ok"]
            and summary["postmortem_attributed"]
            and not summary["flight_missing"]))
    if args.chaos_tree_async:
        summary = procsoak.run_tree_async_soak(
            aggregations=args.rounds, n_workers=args.num_workers,
            workdir=args.workdir, round_timeout=args.mp_round_timeout,
            timeout_s=args.mp_timeout, kill=not args.no_faults,
            log_fn=_chaos_log, lock_witness=args.lock_witness,
            backend=args.backend)
        # A contribution folds once, the tail tracks the kill-free tree
        # oracle and the ledgers survive; with the kills armed the
        # failover fired, every re-homed device is in the ledger, and the
        # dead aggregator is named by the postmortem with its dump on disk.
        return _chaos_gate(summary, (
            _lock_witness_ok(summary, args)
            and summary["exit_code"] == 0
            and summary["oracle_exit_code"] == 0
            and summary["aggregations_run"] >= args.rounds
            and summary["oracle_aggregations_run"] >= args.rounds
            and summary["version_monotonic"]
            and summary["double_folds"] == 0
            and summary["loss_gap_ok"]
            and summary["health_ledger_ok"]
            and (args.no_faults
                 or (summary["failover_fired"]
                     and summary["rehomed_attributed"]
                     and summary["postmortem_attributed"]
                     and not summary["flight_missing"]))))
    if args.chaos_async:
        summary = procsoak.run_async_soak(
            aggregations=args.rounds, n_workers=args.num_workers,
            workdir=args.workdir, round_timeout=args.mp_round_timeout,
            timeout_s=args.mp_timeout, kill=not args.no_faults,
            log_fn=_chaos_log, lock_witness=args.lock_witness,
            backend=args.backend)
        # The version increases per incarnation, the accountant replays to
        # the recorded epsilon and the tail tracks the baseline; with the
        # kill armed a resume ran, the postmortem names the victim, its
        # dump is on disk and the injected pump faults are in the ledger.
        return _chaos_gate(summary, (
            _lock_witness_ok(summary, args)
            and summary["exit_code"] == 0
            and summary["baseline_exit_code"] == 0
            and summary["aggregations_run"] >= args.rounds
            and summary["baseline_aggregations_run"] >= args.rounds
            and summary["version_monotonic"]
            and summary["dp_replay_ok"]
            and summary["loss_gap_ok"]
            and summary["health_ledger_ok"]
            and (args.no_faults
                 or (summary["resumed"] >= 1
                     and summary["postmortem_attributed"]
                     and summary["faults_attributed"]
                     and not summary["flight_missing"]))))
    if args.agg:
        summary = procsoak.run_agg_soak(
            rounds=args.rounds, n_workers=args.num_workers,
            workdir=args.workdir, round_timeout=args.mp_round_timeout,
            timeout_s=args.mp_timeout, kill=not args.no_faults,
            log_fn=_chaos_log, backend=args.backend)
        # With the kill armed the tree must have re-homed or
        # quorum-dropped a slice, the postmortem must name the victim and
        # its flight dump must exist; the ledgers must survive the kill.
        return _chaos_gate(summary, (
            summary["exit_code"] == 0
            and summary["oracle_exit_code"] == 0
            and summary["rounds_run"] == args.rounds
            and summary["oracle_ok"]
            and summary["health_ledger_ok"]
            and (args.no_faults
                 or (summary["agg_failovers"] >= 1
                     and summary["postmortem_attributed"]
                     and not summary["flight_missing"]))))
    if args.mp:
        kills = ([] if args.no_faults
                 else procsoak.canned_kill_schedule(args.rounds,
                                                    args.num_workers))
        summary = procsoak.run_proc_soak(
            rounds=args.rounds, n_workers=args.num_workers, kills=kills,
            workdir=args.workdir, round_timeout=args.mp_round_timeout,
            timeout_s=args.mp_timeout, log_fn=_chaos_log,
            backend=args.backend)
        for k in summary["kills"]:
            print(f"# killed {k['target']} after round "
                  f"{k['fired_after_round']}", file=sys.stderr, flush=True)
        need_resume = any(k.target == "coordinator" for k in kills)
        # Every SIGKILLed process must have left a parseable flight dump.
        return _chaos_gate(summary, (
            summary["exit_code"] == 0
            and summary["rounds_run"] == args.rounds
            and summary["weighted_acc"] is not None
            and (summary["rounds_resumed"] >= 1 or not need_resume)
            and not summary["flight_missing"]))
    if args.secure:
        if args.no_faults:
            plan = faults.FaultPlan([], seed=0)
        elif args.fault_plan:
            plan = faults.FaultPlan.load(args.fault_plan,
                                         seed=args.fault_seed or None)
        else:
            plan = soak.canned_secure_plan(
                seed=args.fault_seed if args.fault_seed is not None else 11)
        summary = soak.run_secure_soak(
            rounds=args.rounds, n_workers=args.num_workers, plan=plan,
            round_timeout=args.round_timeout, log_fn=_chaos_log,
            backend=args.backend)
        counters = summary["counters"]
        # With faults scheduled, recovery must actually have run.
        return _chaos_gate(summary, (
            summary["rounds_run"] == args.rounds
            and summary["oracle_ok"]
            and not summary["skipped_rounds"]
            and counters["privacy.share_recovery_failures_total"] == 0
            and (not plan.faults
                 or counters["privacy.masks_recovered_total"] >= 1)))
    if args.no_faults:
        plan = None
    elif args.fault_plan:
        plan = faults.FaultPlan.load(args.fault_plan,
                                     seed=args.fault_seed or None)
    else:
        plan = faults.canned_plan(
            seed=args.fault_seed if args.fault_seed is not None else 7)
    config = faults.default_soak_config(args.num_workers,
                                        backend=args.backend)
    if args.compress_down and args.compress_down != "none":
        config = dataclasses.replace(
            config, fed=dataclasses.replace(
                config.fed, compress_down=args.compress_down))
    summary = faults.run_soak(
        rounds=args.rounds, n_workers=args.num_workers, plan=plan,
        round_timeout=args.round_timeout, config=config, log_fn=_chaos_log)
    for t in summary.get("top_faults", [])[:5]:
        print(f"# top fault {t['label']}: {t['count']}", file=sys.stderr)
    return _chaos_gate(summary, (summary["rounds_run"] == args.rounds
                                 and summary["weighted_acc"] is not None))


def fleetsim(args: argparse.Namespace) -> dict:
    """``fleetsim``: chunked rounds (or, with ``--async-buffer``, the
    buffered-asynchronous plane, flat or through ``--aggregators``) over a
    seeded synthetic population with a traffic model; per-round records
    on stderr, the summary (JAX's keys, less the compile census) returned.
    A run that trained no client (or, asynchronously, applied no
    aggregation) prints its summary and exits 1, as JAX's."""
    from colearn_federated_learning_tpu_torch import fleetsim as fs
    from colearn_federated_learning_tpu_torch import telemetry
    from colearn_federated_learning_tpu_torch.utils.config import (
        FedConfig, ModelConfig, RunConfig)

    spec = fs.PopulationSpec(
        num_devices=args.devices, num_classes=args.classes,
        feature_dim=args.feature_dim, shard_capacity=args.capacity,
        label_skew=args.label_skew, seed=args.seed)
    population = fs.DevicePopulation(spec)
    traffic = fs.TrafficModel(
        fs.TrafficSpec(base_rate=args.base_rate,
                       diurnal_amplitude=args.diurnal,
                       round_minutes=args.round_minutes, seed=args.seed),
        spec.num_devices)
    config = ExperimentConfig(
        model=ModelConfig(name="mlp", num_classes=spec.num_classes,
                          hidden_dim=args.hidden_dim, depth=args.depth),
        fed=FedConfig(strategy=args.strategy, local_steps=args.local_steps,
                      batch_size=args.batch_size, lr=args.lr,
                      compress=args.compress,
                      compress_down=args.compress_down or "none",
                      lora_rank=args.lora_rank, lora_alpha=args.lora_alpha),
        run=RunConfig(name="fleetsim", seed=args.seed,
                      learn_observe=bool(args.learn_observe)))
    plan = None
    if args.fault_plan:
        from colearn_federated_learning_tpu_torch import faults

        plan = faults.FaultPlan.load(args.fault_plan,
                                     seed=args.fault_seed or None)
    sim = fs.FleetSim.from_population(
        config, population, traffic, cohort_size=args.cohort,
        chunk_size=args.chunk, fault_plan=plan, device=_device(args))
    if args.trace_dir:
        sim.tracer.enabled = True

    def log(rec: dict) -> None:
        print(json.dumps(rec), file=sys.stderr, flush=True)

    if args.async_buffer:
        history = sim.fit_async(
            args.rounds, buffer_size=args.async_buffer,
            max_staleness=args.async_max_staleness,
            prune_after=args.async_prune_after,
            probation=args.async_probation,
            observe=args.async_observe,
            aggregators=args.aggregators, log_fn=log)
        last = history[-1]
        # Arrival tracking: the share of arrived updates that were folded
        # (1 == the fold plane keeps up with the arrival stream).
        arrived = last["arrival_rate_per_min"] * last["sim_time_min"]
        folded = max(0.0, arrived - last["wasted_updates_total"])
        summary = {
            "devices": spec.num_devices,
            "buffer_size": last["buffer_size"],
            "aggregations": len(history),
            "model_version": last["model_version"],
            "sim_minutes": last["sim_time_min"],
            "arrival_rate_per_min": last["arrival_rate_per_min"],
            "agg_rate_per_min": last["agg_rate_per_min"],
            "arrival_tracking": folded / max(arrived, 1e-9),
            "staleness_mean": (
                sum(r["staleness_mean"] for r in history) / len(history)),
            "wasted_updates": last["wasted_updates_total"],
            "train_loss": last["train_loss"],
        }
        # The staleness tail over every FOLDED update of the run.
        hs = telemetry.get_registry().histogram(
            "fleetsim.async_staleness",
            labels={"outcome": "folded"}).summary()
        if hs.get("count"):
            summary["staleness_p50"] = hs["p50"]
            summary["staleness_p90"] = hs["p90"]
            summary["staleness_p99"] = hs["p99"]
        if args.async_buffer == "auto":
            summary["buffer_auto"] = True
        if args.aggregators:
            summary["aggregators"] = args.aggregators
            summary["agg_fold_tracking_min"] = last["agg_fold_tracking_min"]
        if args.async_prune_after:
            summary["pruned"] = last["pruned"]
            summary["pruned_total"] = last["pruned_total"]
        return _chaos_gate(summary, bool(history)
                           and last["model_version"] > 0)
    history = sim.fit(args.rounds, log_fn=log)
    if args.trace_dir:
        path = telemetry.write_tracer(
            args.trace_dir, "fleetsim", sim.tracer,
            metrics=telemetry.get_registry().snapshot())
        print(f"trace written to {path}", file=sys.stderr)
    wall = sum(r["round_time_s"] for r in history) or 1e-9
    clients = sum(r["clients_trained"] for r in history)
    summary = {
        "devices": spec.num_devices,
        "cohort": args.cohort,
        "chunk": sim.chunk_size,
        "rounds": len(history),
        "clients_trained": clients,
        "rounds_per_sec": len(history) / wall,
        "clients_per_sec": clients / wall,
        "bytes_up_per_round": (
            sum(r["bytes_up_est"] for r in history) / len(history)),
        "bytes_down_per_round": (
            sum(r["bytes_down_est"] for r in history) / len(history)),
        "dropped": sum(r["dropped"] for r in history),
        "straggled": sum(r["straggled"] for r in history),
        "corrupted": sum(r["corrupted"] for r in history),
        "train_loss": history[-1]["train_loss"],
    }
    return _chaos_gate(summary, bool(history) and clients > 0)


def top(args: argparse.Namespace) -> None:
    """``top`` (JAX's ``cmd_top``): a terminal dashboard over a live
    ``/snapshot.json`` endpoint — round rate, cohort health, fault
    counters, the async and learning planes, device memory.  Exits 1 when
    the endpoint cannot be read; ``--once`` prints one body."""
    import urllib.error
    import urllib.request

    from colearn_federated_learning_tpu_torch.telemetry import runtime

    url = args.url or f"http://127.0.0.1:{args.port}/snapshot.json"
    prev = None
    while True:
        try:
            with urllib.request.urlopen(url, timeout=5.0) as resp:
                snap = json.loads(resp.read().decode("utf-8"))
        except (OSError, urllib.error.URLError, ValueError) as e:
            print(f"colearn top: cannot fetch {url}: {e}", file=sys.stderr)
            raise SystemExit(1)
        body = runtime.render_top(
            snap, prev=prev,
            interval_s=args.interval if prev is not None else 0.0)
        if args.once:
            print(body, flush=True)
            return
        # Clear and home instead of curses: works in any terminal.
        sys.stdout.write("\x1b[2J\x1b[H" + body + "\n")
        sys.stdout.flush()
        prev = snap
        time.sleep(args.interval)


def converge(args: argparse.Namespace) -> None:
    """``converge`` (JAX's ``cmd_converge``): the round-over-round learning
    report of the ``conv_*`` records in a JSONL file or a directory's
    ``*.jsonl`` files.  Exits 2 when nothing can be read, 1 when no
    record carries learning signals."""
    import glob
    import os

    from colearn_federated_learning_tpu_torch import telemetry

    paths = ([args.results] if os.path.isfile(args.results)
             else sorted(glob.glob(os.path.join(args.results, "**",
                                                "*.jsonl"), recursive=True)))
    records: list = []
    for path in paths:
        try:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if isinstance(rec, dict):
                        records.append(rec)
        except OSError as e:
            print(f"colearn converge: cannot read {path}: {e}",
                  file=sys.stderr)
            raise SystemExit(2)
    if not paths:
        print(f"colearn converge: no JSONL under {args.results}",
              file=sys.stderr)
        raise SystemExit(2)
    report = telemetry.render_convergence_report(records)
    print(report, flush=True)
    if report.startswith("no learning signals"):
        raise SystemExit(1)


def _repo_root(arg: Optional[str]) -> str:
    """``--root``, else the working directory or the package's parent,
    whichever holds a ``pyproject.toml`` (the working directory when
    neither does), as JAX's ``lint`` and ``sentinel`` choose it."""
    import os

    if arg:
        return os.path.abspath(arg)
    parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return next((c for c in (os.getcwd(), parent)
                 if os.path.exists(os.path.join(c, "pyproject.toml"))),
                os.getcwd())


def lint(args: argparse.Namespace) -> None:
    """``lint``: JAX's ``cmd_lint`` over this package's rule set.  Exits 1
    on a finding (or, under ``--gate``, on a non-empty baseline) and 2 on
    an unknown rule id."""
    import os

    from colearn_federated_learning_tpu_torch.analysis import engine
    from colearn_federated_learning_tpu_torch.analysis import reporters

    root = _repo_root(args.root)
    config = engine.LintConfig.from_pyproject(root)
    if args.rules:
        config.enable = [r.strip() for r in args.rules.split(",")]
    if args.disable:
        config.disable = tuple(r.strip() for r in args.disable.split(","))
    try:
        eng = engine.LintEngine(config=config, root=root)
    except ValueError as e:
        print(f"colearn lint: {e}", file=sys.stderr)
        raise SystemExit(2)
    paths = args.paths or [os.path.dirname(os.path.abspath(__file__))]
    baseline_path = (os.path.join(root, args.baseline)
                     if args.baseline else None)
    if args.write_baseline:
        # Lint without the current baseline, then accept everything found.
        result = eng.run(paths, baseline_path="")
        target = baseline_path or os.path.join(root, config.baseline)
        entries = engine.write_baseline(target, result.findings)
        print(f"colearn lint: baselined {len(result.findings)} finding(s) "
              f"({len(entries)} fingerprint(s)) -> {target}")
        return
    if args.gate:
        # The baseline is a migration vehicle, not a place findings live:
        # the gate fails while any fingerprint is parked there.
        gate_baseline = baseline_path or os.path.join(root, config.baseline)
        entries = engine.load_baseline(gate_baseline)
        if entries:
            print(f"colearn lint --gate: baseline {gate_baseline} still "
                  f"carries {len(entries)} fingerprint(s); fix the "
                  f"findings or move each to an inline "
                  f"`# colearn: noqa(CLxxx): <reason>`", file=sys.stderr)
            raise SystemExit(1)
    result = eng.run(paths, baseline_path=baseline_path)
    render = {"json": reporters.render_json,
              "sarif": reporters.render_sarif}.get(args.format,
                                                   reporters.render_text)
    print(render(result), flush=True)
    if result.exit_code:
        raise SystemExit(result.exit_code)


def sentinel(args: argparse.Namespace) -> None:
    """``sentinel``: JAX's ``cmd_sentinel``; exits 1 on any violation (or
    no rule) and 2 on a malformed rule table."""
    from colearn_federated_learning_tpu_torch.analysis import sentinel as slo

    try:
        verdict = slo.evaluate_slo(_repo_root(args.root))
    except ValueError as e:
        print(f"colearn sentinel: {e}", file=sys.stderr)
        raise SystemExit(2)
    print(json.dumps(verdict) if args.format == "json"
          else slo.render_verdict(verdict), flush=True)
    if not verdict["ok"]:
        raise SystemExit(1)


def list_configs() -> None:
    """Print one line per experiment config, in the JAX CLI's format."""
    for name, cfg in sorted(CONFIGS.items()):
        print(f"{name}: {cfg.model.name} on {cfg.data.dataset}, "
              f"{cfg.data.num_clients} clients, {cfg.fed.strategy}")


def main(argv: Optional[list] = None,
         on_round: Optional[Callable] = None) -> dict:
    """Parse ``argv``, run the command and print its result as one JSON
    line on stdout (``bench`` prints its own); returns the result.
    ``on_round`` is :func:`train`'s."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.cmd == "bench":
        from colearn_federated_learning_tpu_torch import bench

        return bench.run(args)
    if args.cmd == "configs":
        return list_configs()
    if args.cmd == "trace-summary":
        return trace_summary(args)
    if args.cmd == "health":
        return health(args)
    if args.cmd == "postmortem":
        return postmortem(args)
    if args.cmd == "top":
        return top(args)
    if args.cmd == "converge":
        return converge(args)
    if args.cmd == "lint":
        return lint(args)
    if args.cmd == "sentinel":
        return sentinel(args)
    if args.cmd == "train":
        refuse_edge_unsupported(args, config_from_args(args))
    if args.cmd == "train" and args.role == "client":
        result = client(args)
    else:
        result = {"train": lambda a: train(a, on_round), "init": init,
                  "aggregate": aggregate, "eval": evaluate,
                  "broker": broker, "worker": worker,
                  "aggregator": aggregator,
                  "coordinate": coordinate, "chaos": chaos,
                  "fleetsim": fleetsim}[args.cmd](args)
    if result is not None and is_lead():
        print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
