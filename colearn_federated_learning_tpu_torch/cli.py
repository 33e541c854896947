"""Command line of the PyTorch port: ``train``, ``init``, ``aggregate``,
``eval`` and ``bench``.

    python -m colearn_federated_learning_tpu_torch.cli train --config NAME \\
        [--backend gpu|cpu] [overrides]

The counterpart of the JAX package's ``colearn`` command line (its
``config_from_args``, ``cmd_train``, ``cmd_init``, ``cmd_aggregate``,
``cmd_eval`` and ``cmd_bench``) for what this package runs: the
single-device federated round with every strategy, DP (fixed or adaptive
clipping, with the RDP accountant), secure aggregation and the robust
aggregators; hierarchical edge → cloud federation (``--edge-groups`` >= 2,
``--edge-sync-period``); on the flat path, a per-client evaluation of the
final model (``--per-client-eval``, its report on stderr); the file plane
(``init``, ``train --role client`` with ``--compress``, ``aggregate``,
``eval``; ``fed/offline.py``); and the headline benchmark (``bench``).
Everything runs on the card (``--backend gpu``, the default, which raises
without one) or, only when asked, on the CPU.  ``train`` writes each
round's record to stderr as one JSON line and its summary to stdout, as in
the JAX package; every command prints its result as one JSON line on
stdout, and :func:`main` returns it.

A flag of the JAX command line whose feature is not ported yet is
accepted by the parser and refused: the run exits with status 2 and names
the ROADMAP item that ports it, and never runs without it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
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
             "compress_feedback", "topk_fraction", "min_cohort_fraction"}
_DATA_KEYS = {"num_clients", "dataset", "partition", "dirichlet_alpha"}
_MODEL_KEYS = {"attn_impl", "width", "stem", "norm"}
_RUN_KEYS = {"seed", "eval_every", "log_every"}

_LORA = "ROADMAP.md Queue A item 5 (LoRA)"
_TP_SP = "ROADMAP.md Queue A item 7 (TP and SP)"
_COMM = "ROADMAP.md Queue A item 8 (the socket planes and faults/)"
_CKPT = "ROADMAP.md Queue A item 9 (fleetsim and checkpoints)"
_OBS = "ROADMAP.md Queue A item 10 (telemetry, tracing and evaluation extras)"

# dest -> (flag, argparse kwargs, the ROADMAP item that ports it): the
# override flags every subcommand takes, and those of ``train`` alone.
_UNPORTED = {
    "lora_rank": ("--lora-rank", dict(type=int), _LORA),
    "lora_alpha": ("--lora-alpha", dict(type=float), _LORA),
    "lora_merge_every": ("--lora-merge-every", dict(type=int), _LORA),
    "tp_size": ("--tp-size", dict(type=int), _TP_SP),
    "remat": ("--remat", dict(action="store_true"), _TP_SP),
    "compress_down": ("--compress-down", dict(), _COMM),
    "topk_adaptive": ("--topk-adaptive", dict(action="store_true"), _COMM),
    "fold_device": ("--fold-device", dict(action="store_true"), _COMM),
    "num_aggregators": ("--num-aggregators", dict(type=int), _COMM),
    "fault_plan": ("--fault-plan", dict(), _COMM),
    "fault_seed": ("--fault-seed", dict(type=int), _COMM),
    "topk_min_fraction": ("--topk-min-fraction", dict(type=float), _COMM),
    "topk_max_fraction": ("--topk-max-fraction", dict(type=float), _COMM),
    "agg_heartbeat_timeout": ("--agg-heartbeat-timeout",
                              dict(type=float), _COMM),
    "agg_buffer_interval_s": ("--agg-buffer-interval", dict(type=float),
                              _COMM),
    "evict_after": ("--evict-after", dict(type=int), _COMM),
    "comm_retries": ("--comm-retries", dict(type=int), _COMM),
    "comm_backoff_base": ("--comm-backoff-base", dict(type=float), _COMM),
    "comm_backoff_max": ("--comm-backoff-max", dict(type=float), _COMM),
    "worker_enroll_timeout": ("--worker-enroll-timeout", dict(type=float),
                              _COMM),
    "checkpoint_dir": ("--checkpoint-dir", dict(), _CKPT),
    "checkpoint_every": ("--checkpoint-every", dict(type=int), _CKPT),
    "ckpt_stream": ("--ckpt-stream", dict(action="store_true"), _CKPT),
    "trace_dir": ("--trace-dir", dict(), _OBS),
    "trace_rounds": ("--trace-rounds", dict(type=int), _OBS),
    "profile_dir": ("--profile-dir", dict(), _OBS),
    "log_file": ("--log-file", dict(), _OBS),
    "tensorboard_dir": ("--tensorboard-dir", dict(), _OBS),
    "health_dir": ("--health-dir", dict(), _OBS),
    "learn_observe": ("--learn-observe", dict(action="store_true"), _OBS),
}
_UNPORTED_TRAIN = {
    "resume": ("--resume", dict(action="store_true"), _CKPT),
    "personalize_steps": ("--personalize-steps", dict(type=int), _OBS),
    "detection_eval": ("--detection-eval", dict(action="store_true"), _OBS),
}


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
    p.add_argument("--attn-impl", default=None, choices=["dense", "flash"])
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--stem", default=None, choices=["conv", "space_to_depth"])
    p.add_argument("--norm", default=None, choices=["group", "none"])
    p.add_argument("--compress", default=None,
                   help="uplink codec of train --role client's update file "
                        "(none|int8|topk|topk8)")
    p.add_argument("--compress-feedback", action="store_true", default=None,
                   help="train --role client: carry the compression "
                        "residual to the next round (--residual-path)")
    p.add_argument("--topk-fraction", type=float, default=None,
                   help="keep density of the topk codecs")
    p.add_argument("--min-cohort-fraction", type=float, default=None,
                   help="aggregate: the share of update files that must "
                        "be usable for the round to commit")
    _add_unported(p, _UNPORTED)


def _add_unported(p: argparse.ArgumentParser, flags: dict) -> None:
    for dest, (flag, kwargs, _) in flags.items():
        p.add_argument(flag, dest=dest, default=None,
                       help="not ported yet (refused)", **kwargs)


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
    _add_unported(p, _UNPORTED_TRAIN)

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
    p.add_argument("--detection-eval", action="store_true", default=None,
                   help="not ported yet (refused)")

    sub.add_parser("bench", help="run the headline benchmark",
                   parents=[bench.build_parser(add_help=False)])
    return parser


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


def refuse_unported(args: argparse.Namespace) -> None:
    """Exit with status 2, naming the ROADMAP items, if any flag of a
    feature that is not ported yet was given."""
    flags = {**_UNPORTED, **_UNPORTED_TRAIN}
    given = [(flag, item) for dest, (flag, _, item) in flags.items()
             if getattr(args, dest, None) not in (None, False)]
    if given:
        for flag, item in given:
            print(f"{flag} is not ported to the PyTorch package yet; "
                  f"see {item}", file=sys.stderr)
        raise SystemExit(2)


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
    logged records' ``round_time_s``, which excludes evaluation."""
    from colearn_federated_learning_tpu_torch.fed import (
        FederatedLearner, HierarchicalLearner, evaluation)

    config = config_from_args(args)
    device = "cuda" if args.backend == "gpu" else "cpu"
    t_start = time.perf_counter()
    hierarchical = config.fed.edge_groups >= 2
    if hierarchical:
        learner = HierarchicalLearner(
            config, num_groups=config.fed.edge_groups,
            sync_period=config.fed.edge_sync_period, device=device)
    else:
        learner = FederatedLearner(config, device=device)
    if on_round is not None:
        on_round(learner, None)
    records = []

    def log_fn(rec: dict) -> None:
        records.append(rec)
        print(json.dumps(rec), file=sys.stderr, flush=True)
        if on_round is not None:
            on_round(learner, rec)

    learner.fit(log_fn=log_fn)
    if hierarchical:
        # fit() ends on a synced, evaluated round: its score is the cloud
        # model's.
        last = learner.history[-1] if learner.history else {}
        loss, acc = ((last["eval_loss"], last["eval_acc"])
                     if "eval_loss" in last else learner.evaluate())
        return {"name": config.run.name, "rounds": len(learner.history),
                "edge_groups": config.fed.edge_groups,
                "final_loss": loss, "final_acc": acc,
                "data_source": learner.dataset.source}
    if args.per_client_eval:
        print(json.dumps(evaluation.sanitize_report(
            learner.evaluate_per_client())), file=sys.stderr, flush=True)
    out = {"name": config.run.name, "rounds": len(records),
           "elapsed_s": time.perf_counter() - t_start,
           "device": str(learner.device)}
    timed = [r["round_time_s"] for r in records]
    if timed:
        out["rounds_per_sec"] = len(timed) / sum(timed)
        samples = (learner.cohort_size * learner.num_steps
                   * config.fed.batch_size)
        out["client_samples_per_sec_per_chip"] = out["rounds_per_sec"] * samples
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
    return out


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
                                   device=_device(args))


def main(argv: Optional[list] = None,
         on_round: Optional[Callable] = None) -> dict:
    """Parse ``argv``, run the command and print its result as one JSON
    line on stdout (``bench`` prints its own); returns the result.
    ``on_round`` is :func:`train`'s."""
    args = build_parser().parse_args(argv)
    if args.cmd == "bench":
        from colearn_federated_learning_tpu_torch import bench

        return bench.run(args)
    if args.cmd == "train":
        refuse_edge_unsupported(args, config_from_args(args))
    refuse_unported(args)
    if args.cmd == "train" and args.role == "client":
        result = client(args)
    else:
        result = {"train": lambda a: train(a, on_round), "init": init,
                  "aggregate": aggregate, "eval": evaluate}[args.cmd](args)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
