"""Experiment configuration.

A copy of the JAX package's ``utils/config.py`` dataclasses and ``CONFIGS``
registry, so one config value means the same experiment in both packages.
Fields for features this package does not run yet (mesh axes, the socket
plane, privacy, compression) are kept so configs stay interchangeable; the
engine refuses a config that turns one of them on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "mnist"            # registry name (data/registry.py)
    num_clients: int = 10
    partition: str = "iid"            # "iid" | "dirichlet" | "pathological"
    dirichlet_alpha: float = 0.5      # non-IID skew
    max_examples_per_client: int = 0  # 0 = derive from dataset size


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "mlp"                 # models/registry.py name
    num_classes: int = 10
    # Family-specific knobs (ignored by families that don't use them):
    hidden_dim: int = 200             # MLP
    depth: int = 2                    # MLP layers / transformer blocks
    width: int = 64                   # CNN base channels / embed dim
    num_heads: int = 4                # transformers
    patch_size: int = 16              # ViT
    seq_len: int = 128                # text models
    vocab_size: int = 30522           # BERT wordpiece vocab size
    dtype: str = "float32"            # compute dtype: float32 | bfloat16
    attn_impl: str = "dense"          # dense | flash | ring/ulysses (SP)
    num_experts: int = 4              # MoE families
    moe_aux_weight: float = 0.01      # Switch load-balance loss weight
    remat: bool = False               # rematerialize transformer blocks
    stem: str = "conv"                # conv | space_to_depth (CNN)
    norm: str = "group"               # group | none (CNN)


@dataclasses.dataclass(frozen=True)
class FedConfig:
    strategy: str = "fedavg"          # fedavg | fedprox | fedadam | fedyogi | scaffold | fednova
    rounds: int = 20
    cohort_size: int = 0              # clients sampled per round; 0 = all
    local_epochs: int = 1
    local_steps: int = 0              # if >0 overrides epochs with a step budget
    batch_size: int = 32
    lr: float = 0.1
    # Client-lr schedule across rounds (fed/strategies.lr_scale_for_round).
    lr_schedule: str = "constant"     # constant | cosine | warmup_cosine
    warmup_rounds: int = 0
    lr_min_fraction: float = 0.0      # cosine floor as a fraction of lr
    momentum: float = 0.9
    local_optimizer: str = "sgd"      # sgd | adam | adamw (client-side)
    prox_mu: float = 0.0              # FedProx mu
    server_lr: float = 1.0            # server-side step on the mean delta
    aggregator: str = "mean"          # mean | median | trimmed_mean | krum
    trim_fraction: float = 0.1
    edge_groups: int = 0              # hierarchical federation groups
    edge_sync_period: int = 2
    server_beta1: float = 0.9         # FedAdam/FedYogi
    server_beta2: float = 0.99
    server_eps: float = 1e-3
    # Straggler simulation: each client gets a per-round step budget;
    # clients below ``straggler_min_fraction`` of the steps are dropped
    # from the weighted average.
    straggler_prob: float = 0.0
    straggler_min_fraction: float = 0.25
    # Privacy hooks (not run by this package yet).
    dp_clip: float = 0.0
    dp_noise_multiplier: float = 0.0
    dp_delta: float = 1e-5
    dp_adaptive_clip: bool = False
    dp_target_quantile: float = 0.5
    dp_clip_lr: float = 0.2
    dp_bit_noise: float = 0.0
    secure_agg: bool = False
    secure_agg_neighbors: int = 0
    secure_agg_key_exchange: str = "dh"
    secure_agg_threshold: float = 0.5
    # Wire-plane compression and the LoRA adapters (the socket plane).
    compress: str = "none"
    compress_feedback: bool = False
    topk_fraction: float = 0.05
    topk_adaptive: bool = False
    topk_min_fraction: float = 0.01
    topk_max_fraction: float = 0.25
    compress_down: str = "none"
    min_cohort_fraction: float = 0.0
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_merge_every: int = 10
    # Multiply the client lr by ``lr_spike_multiplier`` for exactly round
    # ``lr_spike_round`` (-1 disables).
    lr_spike_round: int = -1
    lr_spike_multiplier: float = 1.0


@dataclasses.dataclass(frozen=True)
class RunConfig:
    name: str = "default"
    seed: int = 0
    backend: str = "auto"
    mesh_axis: str = "clients"
    seq_axis: str = "seq"
    tp_axis: str = "model"
    tp_size: int = 1
    log_every: int = 1
    eval_every: int = 1
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    ckpt_stream: bool = False
    profile_dir: Optional[str] = None
    trace_dir: Optional[str] = None
    trace_rounds: int = 0
    evict_after: int = 3
    worker_enroll_timeout: float = 3600.0
    comm_retries: int = 2
    comm_backoff_base: float = 0.05
    comm_backoff_max: float = 2.0
    num_aggregators: int = 0
    agg_heartbeat_timeout: float = 5.0
    agg_buffer_interval_s: float = 2.0
    fold_device: bool = False
    health_dir: Optional[str] = None
    fault_plan: Optional[str] = None
    fault_seed: int = 0
    learn_observe: bool = False


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    fed: FedConfig = dataclasses.field(default_factory=FedConfig)
    run: RunConfig = dataclasses.field(default_factory=RunConfig)

    def replace(self, **sections) -> "ExperimentConfig":
        return dataclasses.replace(self, **sections)


def _cfg(**kw) -> ExperimentConfig:
    return ExperimentConfig(**kw)


# The benchmark configs, identical to the JAX package's registry.
CONFIGS: dict[str, ExperimentConfig] = {
    # 1. FedAvg 2-layer MLP on MNIST, 10 simulated clients.
    "mnist_mlp_fedavg": _cfg(
        data=DataConfig(dataset="mnist", num_clients=10, partition="iid"),
        model=ModelConfig(name="mlp", num_classes=10, hidden_dim=200, depth=2),
        fed=FedConfig(strategy="fedavg", rounds=20, local_epochs=1,
                      batch_size=32, lr=0.1, momentum=0.9),
        run=RunConfig(name="mnist_mlp_fedavg"),
    ),
    # 2. FedAvg CNN on CIFAR-10, 100 non-IID clients (Dirichlet alpha=0.5).
    "cifar10_cnn_fedavg": _cfg(
        data=DataConfig(dataset="cifar10", num_clients=100,
                        partition="dirichlet", dirichlet_alpha=0.5),
        model=ModelConfig(name="cnn", num_classes=10, width=64,
                          dtype="bfloat16"),
        fed=FedConfig(strategy="fedavg", rounds=100, cohort_size=20,
                      local_epochs=1, batch_size=32, lr=0.05, momentum=0.9),
        run=RunConfig(name="cifar10_cnn_fedavg"),
    ),
    # 3. FedProx ResNet-18 on CIFAR-100, 100 clients, mu=0.01.
    "cifar100_resnet18_fedprox": _cfg(
        data=DataConfig(dataset="cifar100", num_clients=100,
                        partition="dirichlet", dirichlet_alpha=0.5),
        model=ModelConfig(name="resnet18", num_classes=100,
                          dtype="bfloat16"),
        fed=FedConfig(strategy="fedprox", prox_mu=0.01, rounds=100,
                      cohort_size=20, local_epochs=1, batch_size=32,
                      lr=0.05, momentum=0.9),
        run=RunConfig(name="cifar100_resnet18_fedprox"),
    ),
    # 4. FedAvg BERT-base on AG-News, 50 text clients.
    "agnews_bert_fedavg": _cfg(
        data=DataConfig(dataset="agnews", num_clients=50, partition="iid"),
        model=ModelConfig(name="bert", num_classes=4, width=768, depth=12,
                          num_heads=12, seq_len=128, dtype="bfloat16"),
        fed=FedConfig(strategy="fedavg", rounds=50, cohort_size=10,
                      local_epochs=1, batch_size=16, lr=5e-5, momentum=0.0,
                      local_optimizer="adam",
                      lr_schedule="warmup_cosine", warmup_rounds=5,
                      lr_min_fraction=0.1),
        run=RunConfig(name="agnews_bert_fedavg"),
    ),
    # 5. Cross-silo ViT-B/16 on FEMNIST, 3400 clients.
    "femnist_vit_cross_silo": _cfg(
        data=DataConfig(dataset="femnist", num_clients=3400,
                        partition="dirichlet", dirichlet_alpha=0.3),
        model=ModelConfig(name="vit_b16", num_classes=62, width=768,
                          depth=12, num_heads=12, patch_size=16,
                          dtype="bfloat16"),
        fed=FedConfig(strategy="fedavg", rounds=100, cohort_size=256,
                      local_epochs=1, batch_size=16, lr=0.03, momentum=0.9,
                      lr_schedule="warmup_cosine", warmup_rounds=5,
                      lr_min_fraction=0.05),
        run=RunConfig(name="femnist_vit_cross_silo"),
    ),
}

# IoT network-anomaly detection as a federated TCN over traffic windows.
CONFIGS["iot_traffic_tcn_fedavg"] = _cfg(
    data=DataConfig(dataset="iot_traffic", num_clients=50,
                    partition="dirichlet", dirichlet_alpha=0.3),
    model=ModelConfig(name="tcn", num_classes=8, width=64, depth=4,
                      dtype="bfloat16"),
    fed=FedConfig(strategy="fedavg", rounds=50, cohort_size=10,
                  local_epochs=1, batch_size=32, lr=0.05, momentum=0.9),
    run=RunConfig(name="iot_traffic_tcn_fedavg"),
)


def get_config(name: str) -> ExperimentConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; available: {sorted(CONFIGS)}")
    return CONFIGS[name]


def validate_robustness(config: "ExperimentConfig") -> None:
    """Hard checks on the comm plane's robustness and LoRA knobs (the JAX
    package's ``validate_robustness``, with its words).  A quorum above 1.0 or an eviction threshold of 0 is not a
    slow configuration but a meaningless one, so these raise.  Called by
    the socket coordinator."""
    run, fed = config.run, config.fed
    if run.evict_after < 1:
        raise ValueError(f"evict_after must be >= 1, got {run.evict_after}")
    if not 0.0 <= fed.min_cohort_fraction <= 1.0:
        raise ValueError(
            "min_cohort_fraction must be in [0, 1], got "
            f"{fed.min_cohort_fraction}"
        )
    if run.comm_retries < 0:
        raise ValueError(
            f"comm_retries must be >= 0, got {run.comm_retries}")
    if run.comm_backoff_base < 0 or run.comm_backoff_max < 0:
        raise ValueError("comm backoff values must be >= 0")
    if fed.lr_spike_round < -1:
        raise ValueError(
            f"lr_spike_round must be >= -1, got {fed.lr_spike_round}")
    if fed.lr_spike_multiplier <= 0:
        raise ValueError(
            "lr_spike_multiplier must be positive, got "
            f"{fed.lr_spike_multiplier}")
    if run.worker_enroll_timeout <= 0:
        raise ValueError(
            "worker_enroll_timeout must be positive, got "
            f"{run.worker_enroll_timeout}"
        )
    from colearn_federated_learning_tpu_torch.fed.compression import SCHEMES

    if fed.compress not in SCHEMES:
        raise ValueError(
            f"unknown compress {fed.compress!r} (use {SCHEMES})"
        )
    if fed.compress_down not in SCHEMES:
        raise ValueError(
            f"unknown compress_down {fed.compress_down!r} (use {SCHEMES})"
        )
    if not 0.0 < fed.topk_fraction <= 1.0:
        raise ValueError(
            f"topk_fraction must be in (0, 1], got {fed.topk_fraction}"
        )
    if fed.secure_agg and fed.compress_feedback:
        raise ValueError(
            "secure_agg cannot carry uplink error feedback: masked updates "
            "are dense by construction (lossy compression would break the "
            "pairwise mask cancellation), so there is no compression "
            "residual to feed back"
        )
    if fed.topk_adaptive:
        if (fed.compress not in ("topk", "topk8")
                or not fed.compress_feedback):
            raise ValueError(
                "topk_adaptive steers density off the error-feedback "
                "residual norm, so it needs compress='topk'/'topk8' AND "
                "compress_feedback=True"
            )
        if not (0.0 < fed.topk_min_fraction
                <= fed.topk_max_fraction <= 1.0):
            raise ValueError(
                "topk_adaptive needs 0 < topk_min_fraction <= "
                "topk_max_fraction <= 1, got "
                f"[{fed.topk_min_fraction}, {fed.topk_max_fraction}]"
            )
    if fed.lora_rank < 0:
        raise ValueError(f"lora_rank must be >= 0, got {fed.lora_rank}")
    if fed.lora_rank > 0:
        if fed.lora_alpha <= 0:
            raise ValueError(
                f"lora_alpha must be positive, got {fed.lora_alpha}")
        if fed.lora_merge_every < 1:
            raise ValueError(
                "lora_merge_every must be >= 1, got "
                f"{fed.lora_merge_every}"
            )
        if fed.compress_down != "none":
            raise ValueError(
                "lora_rank > 0 replaces the broadcast with a base+factor "
                "frame; the downlink delta-cache protocol (compress_down) "
                "does not compose with it — factor uplink compression "
                "(fed.compress) is the supported knob"
            )
        if fed.strategy not in ("fedavg", "fedprox"):
            raise ValueError(
                "lora_rank > 0 folds FACTOR deltas, which the adaptive "
                "server optimizers' params-shaped moment state cannot "
                f"consume — use fedavg/fedprox, not {fed.strategy!r}"
            )
        # The sparse codecs (and their feedback) apply to the factors, and
        # secure aggregation masks the dense factor tree: both allowed.
    if run.num_aggregators < 0:
        raise ValueError(
            f"num_aggregators must be >= 0, got {run.num_aggregators}")
    if run.num_aggregators and run.agg_heartbeat_timeout <= 0:
        raise ValueError(
            "agg_heartbeat_timeout must be positive, got "
            f"{run.agg_heartbeat_timeout}"
        )
    if run.agg_buffer_interval_s <= 0:
        raise ValueError(
            "agg_buffer_interval_s must be positive, got "
            f"{run.agg_buffer_interval_s}"
        )
