"""Driver entry points: the flagship forward and the multi-rank dry run.

The counterpart of the JAX package's ``__graft_entry__.py``.

``entry(device=None)`` returns ``(fn, args)``: the forward of the flagship
model (ViT-B/16, BASELINE config #5 "Cross-silo ViT-B/16 on FEMNIST") in
eval mode on a zero FEMNIST batch of 8 images.  Its attention runs through
the flash wrapper, so on the card it is bf16 kernel K1 at L = 50 and on
the CPU that kernel's plain version.

``dryrun_multichip(n, device=None)`` runs ONE federated round on each of
two meshes over a world of ``n`` ranks, as the JAX dry run does on ``n``
devices:

1. a 1-D ``(clients,)`` mesh (CNN): per-client local SGD, DP clip and
   noise, secure-aggregation masks and the FedAvg all-reduce;
2. for even ``n``, the 3-D ``(clients, seq, model)`` mesh ``(n/4, 2, 2)``
   with MoE-BERT and ring attention (data, sequence, tensor and expert
   parallelism in one round) when ``n % 4 == 0``, else the 2-D
   ``(clients, seq)`` mesh ``(n/2, 2)`` with dense BERT.

Each round must complete at least one client with a finite
``train_loss``.  Under ``torchrun`` (or inside an initialised process
group) it runs on the world that is there, which must have ``n`` ranks;
otherwise it spawns ``n`` ranks itself, meeting through a ``FileStore`` in
a temporary directory.  On the card every rank takes a card of its own
(NCCL): spawning more ranks than the host has cards raises, naming both
counts.
There is no CPU fallback: ``device="cpu"`` runs gloo ranks on the CPU
because the caller asked.  ``scripts/torch_port_record_dryrun.py`` runs
it per world size in a subprocess and records the outcome.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

FLAGSHIP = "femnist_vit_cross_silo"
ENTRY_BATCH = (8, 28, 28, 1)            # a FEMNIST image batch


def entry(device=None):
    """``(fn, (params, x))`` for the flagship model's forward:
    ``fn(params, x)`` returns the (8, 62) f32 logits of ``x`` under
    ``params`` (a name -> tensor dict of the model's parameters, which a
    caller may replace, e.g. with converted JAX parameters)."""
    from colearn_federated_learning_tpu_torch.models import registry
    from colearn_federated_learning_tpu_torch.utils import prng
    from colearn_federated_learning_tpu_torch.utils.config import CONFIGS
    from colearn_federated_learning_tpu_torch.utils.device import (
        resolve_device)

    device = resolve_device(device)
    cfg = dataclasses.replace(CONFIGS[FLAGSHIP].model, attn_impl="flash")
    model = registry.build_model(cfg, device, generator=prng.init_generator(0),
                                 input_shape=ENTRY_BATCH[1:])
    model.eval()
    x = torch.zeros(ENTRY_BATCH, dtype=torch.float32, device=device)
    params = {n: p.detach() for n, p in model.named_parameters()}

    def fn(params, x):
        with torch.no_grad():
            return torch.func.functional_call(model, params, (x,))

    return fn, (params, x)


def cnn_config(n: int):
    """The 1-D mesh's round: the JAX dry run's CNN configuration."""
    from colearn_federated_learning_tpu_torch.utils.config import (
        DataConfig, ExperimentConfig, FedConfig, ModelConfig, RunConfig)

    return ExperimentConfig(
        data=DataConfig(dataset="mnist_tiny", num_clients=2 * n,
                        partition="dirichlet", dirichlet_alpha=0.5,
                        max_examples_per_client=16),
        model=ModelConfig(name="cnn", num_classes=10, width=8),
        fed=FedConfig(strategy="fedavg", rounds=1, cohort_size=n,
                      local_steps=1, batch_size=4, lr=0.05, momentum=0.9,
                      dp_clip=1.0, dp_noise_multiplier=0.1, secure_agg=True),
        run=RunConfig(name="dryrun_multichip", backend="auto"))


def bert_sp_layout(n: int) -> tuple[tuple, tuple, str]:
    """The even world's second mesh: ``(axes, sizes, model name)``."""
    if n % 4 == 0:
        return ("clients", "seq", "model"), (n // 4, 2, 2), "moe_bert"
    return ("clients", "seq"), (n // 2, 2), "bert"


def bert_sp_config(n: int):
    """The sequence-parallel round: the JAX dry run's BERT configuration
    (MoE-BERT on the 3-D mesh, dense BERT on the 2-D one)."""
    from colearn_federated_learning_tpu_torch.utils.config import (
        DataConfig, ExperimentConfig, FedConfig, ModelConfig, RunConfig)

    return ExperimentConfig(
        data=DataConfig(dataset="agnews_tiny", num_clients=n,
                        partition="iid", max_examples_per_client=8),
        model=ModelConfig(name=bert_sp_layout(n)[2], num_classes=4, width=16,
                          depth=2, num_heads=2, seq_len=64, vocab_size=2000,
                          num_experts=4, attn_impl="ring"),
        fed=FedConfig(strategy="fedavg", rounds=1, cohort_size=0,
                      local_steps=1, batch_size=4, lr=0.05, momentum=0.9),
        run=RunConfig(name="dryrun_multichip_sp", backend="auto"))


def check_world(n: int, device_type: str) -> None:
    """Refuse a world the device cannot hold: NCCL takes one rank per
    card, so ``n`` may not exceed the host's cards."""
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n}")
    if device_type == "cuda":
        have = torch.cuda.device_count()
        if n > have:
            raise RuntimeError(
                f"dryrun_multichip({n}) needs {n} cards (NCCL takes one "
                f"rank per card); this host has {have}")


def _round(config, mesh, device_type: str) -> dict:
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner

    learner = FederatedLearner(config, device=device_type, mesh=mesh)
    rec = learner.run_round()
    if device_type == "cuda":
        torch.cuda.synchronize()
    if not rec["completed"] >= 1:
        raise AssertionError(f"no client completed: {rec}")
    if not np.isfinite(rec["train_loss"]):
        raise AssertionError(f"train_loss is not finite: {rec}")
    return dict(mesh=dict(zip(mesh.mesh_dim_names, list(mesh.mesh.shape))),
                model=config.model.name, completed=float(rec["completed"]),
                train_loss=float(rec["train_loss"]))


def run_world(n: int, device_type: str) -> list[dict]:
    """Both rounds on the initialised world of ``n`` ranks; returns each
    round's mesh, model, ``completed`` and ``train_loss``."""
    import torch.distributed as dist

    from colearn_federated_learning_tpu_torch.parallel import mesh as mesh_lib

    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"dryrun_multichip({n}) on a world of {world} "
                           "ranks")
    mesh_lib.check_backend(device_type)
    runs = [_round(cnn_config(n), mesh_lib.make_mesh(
        ("clients",), (n,), device_type=device_type), device_type)]
    if n % 2 == 0:
        axes, sizes, _ = bert_sp_layout(n)
        runs.append(_round(bert_sp_config(n), mesh_lib.make_mesh(
            axes, sizes, device_type=device_type), device_type))
    return runs


def _rank_main(rank: int, n: int, tmp: str, device_type: str) -> None:
    """One spawned rank: join the world, run both rounds, rank 0 writes
    the summary."""
    import torch.distributed as dist

    from colearn_federated_learning_tpu_torch.parallel.mesh import BACKENDS

    if device_type == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(BACKENDS[device_type], store=dist.FileStore(
        os.path.join(tmp, "store"), n), rank=rank, world_size=n)
    try:
        runs = run_world(n, device_type)
        if rank == 0:
            with open(os.path.join(tmp, "runs.json"), "w") as f:
                json.dump(runs, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _under_launcher() -> bool:
    """A world started by ``torchrun`` (its environment), not yet joined."""
    return all(k in os.environ for k in ("WORLD_SIZE", "RANK",
                                         "MASTER_ADDR", "MASTER_PORT"))


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One federated round on each of the dry run's meshes over a world of
    ``n_devices`` ranks (see the module docstring); returns
    ``{"n_devices", "runs": [{"mesh", "model", "completed",
    "train_loss"}]}`` and raises on any failed check."""
    import torch.distributed as dist

    from colearn_federated_learning_tpu_torch.parallel import mesh as mesh_lib
    from colearn_federated_learning_tpu_torch.utils.device import (
        resolve_device)

    kind = resolve_device(device).type
    if dist.is_initialized() or _under_launcher():
        mesh_lib.init_world(kind)
        return dict(n_devices=n_devices, runs=run_world(n_devices, kind))
    check_world(n_devices, kind)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="colearn_dryrun_") as tmp:
        mp.start_processes(_rank_main, args=(n_devices, tmp, kind),
                           nprocs=n_devices, start_method="spawn")
        with open(os.path.join(tmp, "runs.json")) as f:
            runs = json.load(f)
    return dict(n_devices=n_devices, runs=runs)

