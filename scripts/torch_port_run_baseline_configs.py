"""Run the port on the scaled variants of the five BASELINE.json configs
end to end and record acc@round curves (the counterpart of the JAX
package's ``scripts/run_baseline_configs.py``: its ten variants, flags,
meta line and round records).

Each variant keeps the STRATEGY, MODEL FAMILY, PARTITION and round
structure of its config; the scaled ones cut width, depth, clients or
rounds, and the FULL ones keep the stated model and client count and cap
only examples per client and rounds.  Data is the registry's synthetic
stand-in unless real corpora are on disk.  The learners run on the card
unless the caller asks for the CPU:

    python scripts/torch_port_run_baseline_configs.py [--out results/torch_port]
        [--only NAME[,NAME...]] [--rounds N] [--max-examples N] [--lr LR]
        [--cohort N] [--attn-impl flash] [--device cpu]

Writes ``<out>/<name>.jsonl`` (a meta line, then one record per round)
and prints the summary JSON on stdout.  Nothing compiles, so there is no
compile cache.  Without a card and without ``--device cpu`` it exits 1
and writes nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "results", "torch_port")
TRANSFORMERS = ("bert", "moe_bert", "vit_b16")


def _vit_tiny7(model_cfg):
    """The ONE definition of the tiny/7 stand-in for ViT-B/16 (both the
    340-client curve and the spec-N bookkeeping variant scale with it)."""
    return dataclasses.replace(model_cfg, width=192, depth=4, num_heads=3,
                               patch_size=7)


def scaled_variants():
    """name -> (scaled ExperimentConfig, note): the JAX script's ten."""
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    out = {}

    c = get_config("mnist_mlp_fedavg")
    c = c.replace(
        data=dataclasses.replace(c.data, max_examples_per_client=512),
        fed=dataclasses.replace(c.fed, rounds=20),
    )
    out["mnist_mlp_fedavg"] = (c, "full config; 512 examples/client cap")

    c = get_config("cifar10_cnn_fedavg")
    c = c.replace(
        data=dataclasses.replace(c.data, max_examples_per_client=256),
        fed=dataclasses.replace(c.fed, rounds=50),
    )
    out["cifar10_cnn_fedavg"] = (c, "full model; 50 rounds, 256 ex/client")

    c = get_config("cifar100_resnet18_fedprox")
    c = c.replace(
        data=dataclasses.replace(c.data, max_examples_per_client=128),
        fed=dataclasses.replace(c.fed, rounds=30),
    )
    out["cifar100_resnet18_fedprox"] = (c, "full ResNet-18; 30 rounds")

    c = get_config("agnews_bert_fedavg")
    c = c.replace(
        model=dataclasses.replace(c.model, width=256, depth=4, num_heads=8),
        data=dataclasses.replace(c.data, max_examples_per_client=256),
        fed=dataclasses.replace(c.fed, rounds=20, lr=1e-4),
    )
    out["agnews_bert_fedavg"] = (
        c, "BERT scaled 768x12 -> 256x4 (single-chip budget); adam 1e-4 "
           "+ the config's warmup_cosine schedule (round 4)")

    # Not a BASELINE config: the MoE family is a rebuild superset; its
    # curve documents that the expert-parallel path LEARNS, not just runs.
    c = get_config("agnews_bert_fedavg")
    c = c.replace(
        model=dataclasses.replace(c.model, name="moe_bert", width=256,
                                  depth=4, num_heads=8, num_experts=4),
        data=dataclasses.replace(c.data, max_examples_per_client=256),
        fed=dataclasses.replace(c.fed, rounds=20, lr=1e-4),
    )
    c = c.replace(run=dataclasses.replace(c.run, name="agnews_moebert"))
    out["agnews_moebert_fedavg"] = (
        c, "MoE superset: 4 experts every other block, top-2 routing")

    # Thematic parity config: the reference's actual IoT anomaly task.
    c = get_config("iot_traffic_tcn_fedavg")
    c = c.replace(
        data=dataclasses.replace(c.data, dataset="iot_traffic",
                                 max_examples_per_client=128),
        fed=dataclasses.replace(c.fed, rounds=25),
    )
    out["iot_traffic_tcn_fedavg"] = (
        c, "full TCN; 25 rounds, 128 ex/client")

    c = get_config("femnist_vit_cross_silo")
    c = c.replace(
        model=_vit_tiny7(c.model),
        data=dataclasses.replace(c.data, num_clients=340,
                                 max_examples_per_client=64),
        fed=dataclasses.replace(c.fed, rounds=20, cohort_size=32),
    )
    out["femnist_vit_cross_silo"] = (
        c, "ViT scaled B/16 -> tiny/7, 3400 -> 340 clients, cohort 32")

    # FULL-SIZE variants: model dims and client counts as the configs
    # state them; only examples/client and the round budget are capped.
    c = get_config("agnews_bert_fedavg")          # BERT-base 768x12
    c = c.replace(
        data=dataclasses.replace(c.data, max_examples_per_client=256),
    )
    out["agnews_bert_full"] = (
        c, "FULL BERT-base 768x12x12h seq128, 50 clients, cohort 10 "
           "(config #4 at stated size)")

    c = get_config("femnist_vit_cross_silo")      # ViT-B/16, 3400 clients
    c = c.replace(
        data=dataclasses.replace(c.data, max_examples_per_client=64),
        fed=dataclasses.replace(c.fed, rounds=20),
    )
    out["femnist_vit_full3400"] = (
        c, "FULL ViT-B/16 768x12, ALL 3400 resident clients, cohort 256 "
           "(config #5 at stated N; 64 ex/client cap)")

    # Spec-N bookkeeping: all 3,400 resident clients and the cohort-256
    # round structure with the model scaled down (sampling, shard packing
    # and per-client state at config #5's stated N, not model quality).
    c = get_config("femnist_vit_cross_silo")
    c = c.replace(
        model=_vit_tiny7(c.model),
        data=dataclasses.replace(c.data, max_examples_per_client=64),
        fed=dataclasses.replace(c.fed, rounds=10),
    )
    out["femnist_vit3400_scaled"] = (
        c, "ALL 3400 resident clients, cohort 256 (spec N); ViT scaled "
           "B/16 -> tiny/7 so the run fits any session")
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=OUT)
    p.add_argument("--only", default=None,
                   help="a variant, or several separated by commas")
    p.add_argument("--rounds", type=int, default=None,
                   help="override every selected config's round count "
                        "(e.g. run the text configs to plateau)")
    p.add_argument("--max-examples", type=int, default=None,
                   help="override examples/client (scales local steps per "
                        "round: epochs * ceil(examples/batch)) - lets a "
                        "slow session trade steps-per-round for rounds")
    p.add_argument("--lr", type=float, default=None,
                   help="override the client peak lr (recipes tuned on "
                        "scaled stand-ins don't always transfer)")
    p.add_argument("--cohort", type=int, default=None,
                   help="override the cohort (a cut of the run, listed in "
                        "the meta line's note)")
    p.add_argument("--attn-impl", choices=["dense", "flash"], default=None,
                   help="override the transformer variants' attention "
                        "(flash runs kernels K1-K3 on the card and their "
                        "plain versions on the CPU; noted in the meta line)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the card (default), or the CPU when asked")
    return p


def select(args) -> list:
    """``(name, config, note)`` of each selected variant, in the variants'
    order, the overrides applied."""
    variants = scaled_variants()
    only = args.only.split(",") if args.only else list(variants)
    unknown = sorted(set(only) - set(variants))
    if unknown:
        raise SystemExit(f"unknown variant {unknown[0]!r}; choose from "
                         f"{sorted(variants)}")
    out = []
    for name, (cfg, note) in variants.items():
        if name not in only:
            continue
        if args.rounds:
            cfg = cfg.replace(
                fed=dataclasses.replace(cfg.fed, rounds=args.rounds))
        if args.max_examples is not None:
            # NOT truthiness: 0 is the documented "derive from dataset
            # size" value and must round-trip.
            cfg = cfg.replace(
                data=dataclasses.replace(cfg.data,
                                         max_examples_per_client=args.max_examples))
        if args.lr is not None:
            cfg = cfg.replace(fed=dataclasses.replace(cfg.fed, lr=args.lr))
        if (args.attn_impl is not None and cfg.model.name in TRANSFORMERS
                and cfg.model.attn_impl != args.attn_impl):
            note = (f"{note}; attn_impl {cfg.model.attn_impl} -> "
                    f"{args.attn_impl}")
            cfg = cfg.replace(model=dataclasses.replace(
                cfg.model, attn_impl=args.attn_impl))
        if args.cohort is not None:
            note = (f"{note}; cohort {cfg.fed.cohort_size or 'all'} -> "
                    f"{args.cohort} (cut)")
            cfg = cfg.replace(fed=dataclasses.replace(cfg.fed,
                                                      cohort_size=args.cohort))
        out.append((name, cfg, note))
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from colearn_federated_learning_tpu_torch.fed.engine import FederatedLearner

    if args.device == "cuda" and not torch.cuda.is_available():
        print("run_baseline_configs: no CUDA device (use --device cpu for "
              "the CPU)", file=sys.stderr)
        return 1
    device = None if args.device == "cuda" else "cpu"
    kind, platform = ((torch.cuda.get_device_name(0), "gpu")
                      if device is None else ("cpu", "cpu"))
    os.makedirs(args.out, exist_ok=True)
    summary = []
    for name, cfg, note in select(args):
        print(f"[{name}] {note}", file=sys.stderr)
        t0 = time.perf_counter()
        learner = FederatedLearner.from_config(cfg, device=device)
        path = os.path.join(args.out, f"{name}.jsonl")
        with open(path, "w") as f:
            meta = {"config": name, "note": note,
                    "device": kind, "platform": platform,
                    "num_clients": learner.num_clients,
                    "cohort": learner.cohort_size,
                    "local_steps": learner.num_steps,
                    "rounds": cfg.fed.rounds}
            f.write(json.dumps(meta) + "\n")

            def log(rec):
                f.write(json.dumps(rec) + "\n")
                f.flush()
                if "eval_acc" in rec:
                    print(f"[{name}] round {rec['round']:3d} "
                          f"loss {rec['train_loss']:.4f} "
                          f"acc {rec['eval_acc']:.4f}", file=sys.stderr)

            hist = learner.fit(log_fn=log)
        wall = time.perf_counter() - t0
        accs = [r.get("eval_acc") for r in hist if "eval_acc" in r]
        summary.append({
            "config": name,
            "rounds": len(hist),
            "final_acc": round(accs[-1], 4) if accs else None,
            "best_acc": round(max(accs), 4) if accs else None,
            "first_acc": round(accs[0], 4) if accs else None,
            "wall_s": round(wall, 1),
            "curve": path,
        })
        print(json.dumps(summary[-1]), file=sys.stderr)
        del learner
        if device is None:
            torch.cuda.empty_cache()
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
