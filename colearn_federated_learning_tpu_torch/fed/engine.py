"""Federated round orchestration, on one CUDA device or a client mesh.

The counterpart of the JAX package's ``FederatedLearner``: data, model
and server state are built once, then each ``run_round`` samples the
cohort, trains every client, folds the weighted deltas and applies the
server step (``fed/programs.py``).  It validates the privacy and
robustness knobs as the JAX engine does, keeps SCAFFOLD's per-client
variates on the host, carries the adaptive DP clip from round to round
as a device scalar and steps the RDP accountant.

``mesh``: an optional ``DeviceMesh`` (``parallel/mesh.py``) with a
``clients`` axis, and optionally a ``seq`` axis (sequence parallelism,
``attn_impl`` ring or ulysses) or a ``model`` axis (tensor parallelism,
``parallel/tp.py``).  As in JAX the clients are padded with ghosts to a
multiple of the client axis and interleaved, each rank holds its block
of them (and under SP its slice of every sequence), and the round's sums
run over the ``clients`` group.  Without a mesh everything runs on one
device, and a ring or Ulysses config runs the dense core.
:meth:`FederatedLearner.from_config` lays the mesh over the world that
``torchrun`` starts, as JAX's lays it over the visible devices.

``device=None`` means ``"cuda"``; without a card the constructor raises
instead of running somewhere else.  ``device="cpu"`` runs the same round
with every kernel's plain PyTorch version (the tests do this); a mesh's
device type decides for it.

Checkpoints (``ckpt/manager.py``): with ``run.checkpoint_dir`` ``fit``
saves ``(server_state, client_c)`` in the JAX engine's layout (SCAFFOLD's
variates, else ``None``) after the record is logged, every
``run.checkpoint_every`` rounds and always after the last;
``restore_checkpoint`` copies the latest step back into the live
tensors, charges the accountant for the rounds already run and
continues the adaptive clip from the last record.  On a mesh the saved
state is JAX's too: the variates' clients-axis blocks gathered in slot
order and, under TP, the whole params and moments; one rank writes the
step and every rank waits on a barrier of the mesh's axes before it goes
on, and a restore has every rank read the step and keep its block and
its slices.  The step records the clients axis's slot order, and a
SCAFFOLD step is refused by a learner whose slots are in another order
(a clients axis of another size), since its rows would land on other
clients.

Telemetry is JAX's: the spans ``round``, ``h2d_transfer``,
``cohort_sample`` (SCAFFOLD), ``client_update``, ``scatter_variates``,
``sync_metrics``, ``evaluate`` and ``checkpoint`` on the learner's own
tracer, recorded while ``run.trace_dir`` opens a window
(``run.trace_rounds`` bounds it) and written by ``fit`` as Chrome-trace
JSON (``last_trace_path``), and the counters ``engine.rounds_total``, ``engine.round_time_s`` and
``engine.h2d_transfer_s`` in the process registry.  ``client_update`` is
the span ``phase_update_s`` reads; it waits for the card only where the
round already did (``sync=True``) or while spans are recorded.
With ``run.profile_dir`` ``fit`` also opens a ``torch.profiler`` window
over rounds 1..2 (``utils/profiling.py``), the card's activity included,
with a device barrier inside it.  Traced records carry
``flops_per_round`` (:meth:`FederatedLearner.round_cost_analysis`),
counted once and cached across ``fit`` calls.  ``evaluate_detection``
and ``evaluate_personalized`` are JAX's reports.
Departures: SCAFFOLD's variates go back to the host as each contributor
finishes (the device holds O(model) of them), so ``scatter_variates`` is
one span per contributor inside ``client_update``; ``flops_per_round``
counts one client's local step under ``FlopCounterMode`` (matmuls and
convolutions, the flash kernels by formula), where JAX's is XLA's cost
analysis of the round program (elementwise work counted too, a Pallas
call not at all); and the profiler writes a Chrome-trace JSON where
JAX's writes an xplane.  ``hbm_used_gb`` comes from the card's
allocator (``telemetry.sample_device_memory``, which also sets the
``runtime.hbm_*`` gauges), on every round on the card.
"""

from __future__ import annotations

import math
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from colearn_federated_learning_tpu_torch import convert, telemetry
from colearn_federated_learning_tpu_torch.data import partition as partition_lib
from colearn_federated_learning_tpu_torch.data import registry as data_registry
from colearn_federated_learning_tpu_torch.data.sharding import (
    client_rows, gather_block, pad_rows_to_multiple)
from colearn_federated_learning_tpu_torch.fed import evaluation, local, programs
from colearn_federated_learning_tpu_torch.fed import robust, strategies
from colearn_federated_learning_tpu_torch.models import registry as model_registry
from colearn_federated_learning_tpu_torch.parallel import collectives
from colearn_federated_learning_tpu_torch.parallel import mesh as mesh_lib
from colearn_federated_learning_tpu_torch.privacy import dp as dp_lib
from colearn_federated_learning_tpu_torch.privacy.accountant import RdpAccountant
from colearn_federated_learning_tpu_torch.utils import prng
from colearn_federated_learning_tpu_torch.utils.config import ExperimentConfig
from colearn_federated_learning_tpu_torch.utils.device import resolve_device


def check_supported(config: ExperimentConfig) -> None:
    """Refuse what this package does not run yet rather than ignore it.
    ``edge_groups`` is not refused: the hierarchical learner
    (``fed/hierarchical.py``) builds its groups from copies of a config
    that still carries it, as the JAX package's does."""
    f = config.fed
    if f.strategy not in strategies.STRATEGIES:
        raise NotImplementedError(
            f"not ported yet: strategy {f.strategy!r}; see ROADMAP.md "
            "Queue A")


def check_fed_options(fed) -> None:
    """The JAX engine's checks of the secure-aggregation, SCAFFOLD and
    robust-aggregation options, with its messages."""
    if fed.secure_agg and fed.secure_agg_neighbors and (
            fed.secure_agg_neighbors % 2 or fed.secure_agg_neighbors < 2):
        raise ValueError(
            "secure_agg_neighbors must be an even integer >= 2, got "
            f"{fed.secure_agg_neighbors}")
    if fed.secure_agg and not 0.0 < fed.secure_agg_threshold <= 1.0:
        raise ValueError(
            "secure_agg_threshold must be in (0, 1], got "
            f"{fed.secure_agg_threshold}")
    scaffold = fed.strategy == "scaffold"
    if scaffold and (fed.secure_agg or fed.dp_clip > 0.0):
        raise ValueError(
            "scaffold is incompatible with secure_agg/dp hooks: the "
            "control-variate deltas are a second payload the masks and "
            "noise calibration do not cover")
    if fed.aggregator not in robust.AGGREGATORS:
        raise ValueError(
            f"unknown aggregator {fed.aggregator!r}; use {robust.AGGREGATORS}")
    if fed.aggregator != "mean":
        if not 0.0 <= fed.trim_fraction < 0.5:
            raise ValueError(
                f"trim_fraction must be in [0, 0.5), got {fed.trim_fraction}")
        if fed.secure_agg:
            raise ValueError(
                "robust aggregators need the individual updates; "
                "secure-agg masks only cancel in a plain sum")
        if scaffold:
            raise ValueError(
                "scaffold assumes mean aggregation of its control "
                "variates; use aggregator='mean'")
        if fed.dp_noise_multiplier > 0.0:
            raise ValueError(
                "robust aggregation of noised updates is not the "
                "Gaussian mechanism the RDP accountant models; use "
                "dp_clip alone (norm bounding) with robust aggregators")


def check_trim_at_cohort(fed, cohort_size: int) -> None:
    """A trimmed mean or Krum whose floor(trim · cohort) is 0 would be the
    plain mean in disguise: refuse it, as the JAX engine does."""
    if (fed.aggregator not in ("trimmed_mean", "krum")
            or int(fed.trim_fraction * cohort_size + 1e-4) >= 1):
        return
    what = ("trims zero clients" if fed.aggregator == "trimmed_mean"
            else "assumes zero Byzantine clients (f = 0)")
    if cohort_size < 3:
        raise ValueError(
            f"aggregator={fed.aggregator!r} needs a cohort of at "
            f"least 3 (got {cohort_size}); use aggregator='median'")
    ok_frac = math.ceil(1e6 / cohort_size) / 1e6
    raise ValueError(
        f"trim_fraction={fed.trim_fraction} {what} at "
        f"cohort_size={cohort_size}; raise it to at least "
        f"{ok_frac:.6f} (or use aggregator='median')")


class VariateStore:
    """SCAFFOLD's per-client control variates, one row per client, held on
    the host (pinned when the params live on a card): each client's row
    goes to the device for its local update, and a contributor's refreshed
    row comes back, so the device holds O(model) of them, not
    O(clients × model)."""

    def __init__(self, params: dict, num_clients: int, device):
        pin = torch.device(device).type == "cuda"
        self.device = device
        self.rows = [torch.zeros((num_clients,) + p.shape, dtype=p.dtype,
                                 pin_memory=pin) for p in params.values()]

    def gather(self, slot: int) -> list:
        return [r[slot].to(self.device, non_blocking=True) for r in self.rows]

    def scatter(self, slot: int, values: list) -> None:
        for r, v in zip(self.rows, values):
            r[slot].copy_(v)


def _mesh_device(mesh, device) -> torch.device:
    """The device of this rank: the mesh's device type (the current card
    on an NCCL mesh), or ``device`` without a mesh.  A ``device`` of the
    other type than the mesh's is refused."""
    if mesh is None:
        return resolve_device(device)
    kind = mesh.device_type
    if device is not None and torch.device(device).type != kind:
        raise ValueError(f"device {device!r} does not match the mesh's "
                         f"device type {kind!r}")
    if kind == "cuda":
        return resolve_device(torch.device("cuda",
                                           torch.cuda.current_device()))
    return torch.device(kind)


def _tie_parameters(dst: torch.nn.Module, src: torch.nn.Module) -> None:
    """Make every parameter of ``dst`` the same tensor as ``src``'s of
    that name (a twin of the same architecture)."""
    for name, p in src.named_parameters():
        owner, _, leaf = name.rpartition(".")
        setattr(dst.get_submodule(owner) if owner else dst, leaf, p)


def partition_for_config(config: ExperimentConfig, labels: np.ndarray):
    """Per-client index lists for ``config.data`` (iid | dirichlet |
    pathological), as the JAX package's ``fed/setup.py`` derives them."""
    c = config.data
    seed = config.run.seed
    if c.partition == "dirichlet":
        return partition_lib.dirichlet_partition(
            labels, c.num_clients, c.dirichlet_alpha, seed=seed)
    if c.partition == "pathological":
        return partition_lib.pathological_partition(labels, c.num_clients,
                                                    seed=seed)
    if c.partition != "iid":
        raise ValueError(f"unknown data.partition {c.partition!r}; "
                         "use iid | dirichlet | pathological")
    return partition_lib.iid_partition(len(labels), c.num_clients, seed=seed)


def num_steps_for_config(config: ExperimentConfig, capacity: int) -> int:
    """Static per-round local step budget: explicit ``local_steps`` or
    ``local_epochs * ceil(capacity / batch_size)``."""
    c = config.fed
    if c.local_steps > 0:
        return c.local_steps
    return c.local_epochs * max(1, int(np.ceil(capacity / c.batch_size)))


class FederatedLearner:
    """End-to-end federated experiment: data, model, round loop,
    evaluation, on one device or over a client mesh (``mesh``; see the
    module docstring).

    ``partitions``: optional explicit per-client index lists into the
    dataset's train split, overriding ``config.data.partition`` (clustered
    FL injects its members' exact shards this way).

    ``plan``: optional object with the methods of
    :class:`fed.programs.Draws` (``cohort``, ``device_cohort``,
    ``batch_indices``, ``step_budgets``, ``dp_noise``, ``pair_mask``,
    ``ring_order``, ``clip_bit_noise``) supplying the round's random
    draws; by default they come from ``utils/prng``.

    ``last_cohort`` describes the last round's cohort on this rank (numpy
    arrays): ``clients``, ``steps_run`` and ``contributed``, and with the
    options that make them ``nova_a`` (FedNova's coefficients),
    ``partners`` (secure aggregation's partner table) and ``selected``
    (the clients Krum kept, over the whole mesh).
    """

    @classmethod
    def from_config(cls, config: ExperimentConfig,
                    dataset: Optional[data_registry.Dataset] = None,
                    device=None, plan=None) -> "FederatedLearner":
        """A learner laid out as the JAX ``from_config`` lays it: in a
        plain process (a world of one) no mesh; under ``torchrun`` a
        ``(clients,)`` mesh over the world — ``(clients, seq)`` with
        ``attn_impl`` ring or ulysses, ``(clients, model)`` with
        ``run.tp_size > 1`` — on NCCL, or on gloo when ``device`` is the
        CPU.  A ``tp_size`` that does not divide the world warns and runs
        without tensor parallelism."""
        device = resolve_device(device)
        r = config.run
        if config.model.attn_impl in ("ring", "ulysses") and r.tp_size > 1:
            raise ValueError(
                "from_config cannot auto-lay a 3-D (clients, seq, model) "
                "mesh; build it with parallel.mesh.make_mesh and pass "
                "mesh= explicitly")
        world = (torch.distributed.get_world_size()
                 if torch.distributed.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", "1")))
        if r.tp_size > 1 and world % r.tp_size != 0:
            # Observable both ways, as in JAX: a warning, and a labelled
            # counter for dashboards and soaks.
            telemetry.get_registry().counter(
                "fed.mesh_fallback_total",
                labels={"reason": "indivisible_devices"}).inc()
            warnings.warn(
                f"tp_size={r.tp_size} needs a device count that is a "
                f"multiple of it, have {world}; running without tensor "
                "parallelism", stacklevel=2)
        mesh = None
        if world > 1:
            mesh_lib.init_world(device.type)
            kind = device.type
            if config.model.attn_impl in ("ring", "ulysses"):
                mesh = mesh_lib.make_mesh((r.mesh_axis, r.seq_axis),
                                          device_type=kind)
            elif r.tp_size > 1 and world % r.tp_size == 0:
                mesh = mesh_lib.make_mesh((r.mesh_axis, r.tp_axis),
                                          (-1, r.tp_size), device_type=kind)
            else:
                mesh = mesh_lib.make_mesh((r.mesh_axis,), device_type=kind)
        return cls(config, dataset=dataset, device=device, plan=plan,
                   mesh=mesh)

    def __init__(self, config: ExperimentConfig,
                 dataset: Optional[data_registry.Dataset] = None,
                 device=None, plan=None, partitions: Optional[list] = None,
                 mesh=None):
        from colearn_federated_learning_tpu_torch.fed.setup import (
            local_model_config)

        self.config = c = config
        self.mesh = mesh
        self.device = _mesh_device(mesh, device)
        check_supported(c)
        check_fed_options(c.fed)
        local.check_strategy_optimizer(c.fed)
        self.scaffold = c.fed.strategy == "scaffold"
        self.fednova = c.fed.strategy == "fednova"
        self.robust = c.fed.aggregator != "mean"

        # --- mesh axes (the JAX engine's checks and messages) ---------
        self.client_axis = c.run.mesh_axis
        self.seq_axis = c.run.seq_axis
        self.tp_axis = c.run.tp_axis
        if mesh is not None:
            names = tuple(mesh.mesh_dim_names or ())
            if self.client_axis not in names:
                raise ValueError(
                    f"mesh axes {names} lack the client axis "
                    f"{self.client_axis!r}")
            extra = set(names) - {self.client_axis, self.seq_axis,
                                  self.tp_axis}
            if extra:
                raise ValueError(f"unsupported mesh axes {sorted(extra)}")
        self.clients = mesh_lib.axis(mesh, self.client_axis)
        self.seq = mesh_lib.axis(mesh, self.seq_axis)
        self.tp = mesh_lib.axis(mesh, self.tp_axis)
        self.clients_size, self.seq_size = self.clients.size, self.seq.size
        self.tp_size = self.tp.size
        self.sp = self.seq_size > 1
        if self.sp and c.model.attn_impl not in ("ring", "ulysses"):
            raise ValueError(
                f"a {self.seq_size}-way {self.seq_axis!r} mesh axis requires "
                "model.attn_impl='ring' or 'ulysses'")
        if (c.model.attn_impl in ("ring", "ulysses") and mesh is not None
                and not self.sp):
            raise ValueError(
                f"attn_impl={c.model.attn_impl!r} on a mesh requires a "
                f"{self.seq_axis!r} axis of size > 1")

        # --- data -----------------------------------------------------
        self.dataset = dataset or data_registry.get_dataset(
            c.data.dataset, seed=c.run.seed)
        labels = np.asarray(self.dataset.y_train)
        parts = (partitions if partitions is not None
                 else partition_for_config(c, labels))
        # The slots' source rows by index arithmetic on the host; the rows
        # themselves are gathered on the device below.
        rows, counts = client_rows(parts,
                                   capacity=c.data.max_examples_per_client)
        self.real_num_clients = len(counts)   # before ghost padding
        x_train = np.asarray(self.dataset.x_train)
        example_shape = tuple(x_train.shape[1:])
        if self.sp:
            self._check_sp(example_shape)
        if mesh is not None:
            # Ghost-pad to the client axis, then interleave so real clients
            # spread evenly over the devices; ``client_ids[slot]`` is each
            # slot's original client id, on which every draw is keyed.
            rows, counts = pad_rows_to_multiple(rows, counts,
                                                self.clients_size)
            D = self.clients_size
            L = len(counts) // D
            order = np.array([j * D + d for d in range(D) for j in range(L)],
                             dtype=np.int64)
            rows, counts = rows[order], counts[order]
            self.client_ids = order
        else:
            self.client_ids = np.arange(len(counts), dtype=np.int64)
        self.num_clients = len(counts)
        self.counts = counts
        # This rank's block of clients (every client on one device), and
        # under SP its slice of every sequence.
        L = self.num_clients // self.clients_size
        block = slice(self.clients.index * L, (self.clients.index + 1) * L)
        self.block_ids = self.client_ids[block]
        self.block_counts = self.counts[block]
        # Recording stays off until fit() opens a trace window; span()
        # still times either way.
        self.tracer = telemetry.Tracer(process="engine", enabled=False)
        self.last_trace_path: Optional[str] = None
        with self.tracer.span("h2d_transfer") as sp:
            self.x, self.y = gather_block(
                x_train, labels, rows[block], self.device,
                seq_split=((self.seq_size, self.seq.index) if self.sp
                           else None))
        telemetry.get_registry().gauge("engine.h2d_transfer_s").set(
            sp.duration_s)

        # --- model and server state -----------------------------------
        # Under SP the trained module runs on sequence shards; its
        # dense-core twin, sharing its parameters, evaluates full
        # sequences.  Without a seq axis a ring/Ulysses config runs the
        # dense core, as in JAX.
        train_cfg = c.model if self.sp else local_model_config(c.model)
        self.model = model_registry.build_model(
            train_cfg, self.device, generator=prng.init_generator(c.run.seed),
            input_shape=example_shape,
            seq_group=self.seq.group if self.sp else None)
        self.full_shapes = [p.shape for p in self.model.parameters()]
        self.eval_model = self.model
        if self.sp:
            self.eval_model = model_registry.build_model(
                local_model_config(c.model), self.device,
                input_shape=example_shape)
        self.tp_dims = None
        if self.tp_size > 1:
            from colearn_federated_learning_tpu_torch.parallel import tp as tp_lib

            dims = tp_lib.shard_params(self.model, mesh, self.tp_axis)
            if self.eval_model is not self.model:
                tp_lib.shard_params(self.eval_model, mesh, self.tp_axis)
            if any(d is not None for d in dims.values()):
                self.tp_dims = [dims[n] for n, _ in
                                self.model.named_parameters()]
        if self.eval_model is not self.model:
            _tie_parameters(self.eval_model, self.model)
        self.server_state = strategies.init_server_state(
            self._param_copy(), c.fed)
        if self.scaffold and self.tp_size > 1:
            raise ValueError(
                "scaffold with a model (TP) axis is unsupported: the "
                "host-resident variate store is unsharded and the per-round "
                "gather/scatter would funnel TP shards through one host")

        # --- local trainer and cohort ---------------------------------
        local.check_dense_trainer(c.fed)
        self.num_steps = num_steps_for_config(c, rows.shape[1])
        optimizer = local.make_optimizer(c.fed.lr, c.fed.momentum,
                                         c.fed.local_optimizer)
        self.local_update = local.make_local_update(
            self.model, optimizer, self.num_steps,
            prox_mu=c.fed.prox_mu if c.fed.strategy == "fedprox" else 0.0,
            min_steps_fraction=c.fed.straggler_min_fraction,
            aux_loss_weight=(c.model.moe_aux_weight
                             if c.model.name.startswith("moe") else 0.0),
            scaffold=self.scaffold, lr=c.fed.lr,
            grad_sync_group=self.seq.group if self.sp else None,
            tp=self.tp if self.tp_dims is not None else None,
            sharded=(None if self.tp_dims is None
                     else [d is not None for d in self.tp_dims]))
        self.variates = (VariateStore(self.server_state.params,
                                      len(self.block_ids), self.device)
                         if self.scaffold else None)
        cohort = c.fed.cohort_size or self.num_clients
        self.cohort_size = min(cohort, self.num_clients)
        if mesh is not None:
            d = self.clients_size
            # The per-device cohort must be equal on every device.
            self.cohort_per_device = max(1, self.cohort_size // d)
            adjusted = self.cohort_per_device * d
            if adjusted != self.cohort_size:
                warnings.warn(
                    f"cohort_size={self.cohort_size} is not a multiple of the "
                    f"{d}-way client axis; using {adjusted} "
                    f"({self.cohort_per_device}/device)", stacklevel=2)
            self.cohort_size = adjusted
        if self.robust:
            check_trim_at_cohort(c.fed, self.cohort_size)
        self.draws = plan if plan is not None else programs.Draws(c.run.seed)
        self.last_cohort: dict = {}

        # --- DP -------------------------------------------------------
        # Noise is calibrated to the real clients expected to contribute
        # (ghost padding never does).  With adaptive clipping the clip is
        # a device scalar carried from round to round, and the bit
        # query's noise is paid for by inflating the update noise, so the
        # joint mechanism still costs z.
        self.dp_cohort = min(self.cohort_size, self.real_num_clients)
        self.adaptive_clip = c.fed.dp_adaptive_clip
        self.dp_z = self.dp_bit_noise = 0.0
        if self.adaptive_clip:
            if c.fed.dp_clip <= 0.0:
                raise ValueError(
                    "dp_adaptive_clip needs dp_clip > 0 as the initial norm")
            z = c.fed.dp_noise_multiplier
            if z > 0.0:
                self.dp_bit_noise = c.fed.dp_bit_noise or max(
                    self.dp_cohort / 20.0, 1.0)
                self.dp_z = dp_lib.adaptive_noise_multiplier(
                    z, self.dp_bit_noise)
        self.dp_clip = torch.tensor(c.fed.dp_clip, dtype=torch.float32,
                                    device=self.device)
        self.accountant = RdpAccountant.from_config(
            c.fed, sampling_rate=self.dp_cohort / self.real_num_clients)

        self._eval_fn = evaluation.make_eval_fn(
            self.eval_model, self.dataset.x_test, self.dataset.y_test,
            batch=max(c.fed.batch_size, 64), device=self.device)
        self.history: list[dict] = []
        self._ckpt = None
        self._flops_per_round: Optional[float] = None

    def _check_sp(self, example_shape: tuple) -> None:
        """The JAX engine's eager checks of a sequence-parallel layout."""
        c = self.config
        if len(example_shape) != 1:
            raise ValueError(
                "sequence parallelism needs (tokens,)-shaped examples, "
                f"got example shape {example_shape}")
        seq_len = example_shape[-1]
        if seq_len % self.seq_size:
            raise ValueError(
                f"seq_len {seq_len} is not divisible by the "
                f"{self.seq_size}-way {self.seq_axis!r} axis")
        if (c.model.attn_impl == "ulysses"
                and c.model.num_heads % self.seq_size):
            raise ValueError(
                f"attn_impl='ulysses' needs num_heads "
                f"({c.model.num_heads}) divisible by the "
                f"{self.seq_size}-way {self.seq_axis!r} axis; use "
                "attn_impl='ring'")

    def _param_copy(self) -> dict:
        return {name: p.detach().clone()
                for name, p in self.model.named_parameters()}

    def load_flax_params(self, flax_params) -> None:
        """Start from parameters in the JAX package's flax layout (a nested
        dict of numpy arrays), converted exactly by ``convert.py``."""
        sd = convert.flax_to_state_dict(flax_params)
        names = [n for n, _ in self.model.named_parameters()]
        if sorted(sd) != sorted(names):
            raise ValueError(f"flax params do not match the model: "
                             f"{sorted(set(sd) ^ set(names))}")
        dims = dict(zip(names, self.tp_dims or [None] * len(names)))
        from colearn_federated_learning_tpu_torch.parallel import partition

        params = {n: partition.shard(sd[n], dims[n], self.tp_size,
                                     self.tp.index).to(
                      self.device, torch.float32).clone()
                  for n in names}
        self.server_state = strategies.init_server_state(params,
                                                         self.config.fed)

    @property
    def params(self) -> dict:
        """The global model's parameters (name -> f32 tensor; under tensor
        parallelism this rank's slices)."""
        return self.server_state.params

    def full_params(self) -> dict:
        """The global model's whole parameters: under tensor parallelism
        the slices all-gathered over the model group (every rank of it
        must call this), else :attr:`params` itself."""
        return self._whole(self.params)

    def host_shards(self) -> tuple:
        """(x, y) numpy arrays of every client's padded shard in array-slot
        order, read from the device tensors (which a caller may have
        edited); on a mesh the blocks (and sequence slices) are
        all-gathered, so every rank of the mesh must call this."""
        x, y = self.x, self.y
        if self.mesh is not None:
            if self.sp:
                x = collectives.all_gather(x.movedim(-1, 0).contiguous(),
                                           self.seq.group).movedim(0, -1)
            x = collectives.all_gather(x, self.clients.group)
            y = collectives.all_gather(y, self.clients.group)
        return x.cpu().numpy(), y.cpu().numpy().astype(np.int32)

    def _sync(self) -> None:
        """Wait for the card's queued work, so a host clock read after it
        covers that work (nothing to wait for on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_round(self, sync: bool = True) -> dict:
        """One federated round; returns its metrics (one host sync).

        ``phase_update_s`` is the ``client_update`` span: from the cohort
        draw (under SCAFFOLD, after it) until the card has finished the
        round; ``phase_sync_s`` (``sync_metrics``) is the metrics' copy to
        the host; under SCAFFOLD ``phase_cohort_sample_s`` is the cohort
        draw (``cohort_sample``), as in the JAX record.  ``sync=False``
        leaves the metrics on the device and, unless spans are being
        recorded, does not wait for the card, so rounds queue back to back
        (``phase_update_s`` is then the host's time to queue the round);
        :meth:`finalize_history` turns them into floats."""
        r = len(self.history)
        tracer = self.tracer
        sample_sp = None
        if self.scaffold:
            with tracer.span("cohort_sample", round=r) as sample_sp:
                sel = programs.sample_cohort(self, r)
        # The round is one span; it waits for the card where the round
        # already did (sync=True), or while a trace window is open, so
        # the span covers the card's work and not only its queueing.
        with tracer.span("client_update", round=r,
                         cohort=self.cohort_size) as update_sp:
            if sample_sp is None:
                sel = programs.sample_cohort(self, r)
            metrics = programs.run_round(self, r, sel)
            if sync or tracer.enabled:
                self._sync()
        if self.adaptive_clip:
            self.dp_clip = metrics["dp_clip"]
        with tracer.span("sync_metrics", round=r) as sync_sp:
            out = ({k: float(v) for k, v in metrics.items()} if sync
                   else dict(metrics))
        out["round"] = r
        out["phase_update_s"] = update_sp.duration_s
        out["phase_sync_s"] = sync_sp.duration_s
        if sample_sp is not None:
            out["phase_cohort_sample_s"] = sample_sp.duration_s
        telemetry.get_registry().counter("engine.rounds_total").inc()
        if self.accountant is not None:
            self.accountant.step()
            out["dp_epsilon"] = self.accountant.epsilon()
            out["dp_delta"] = self.accountant.delta
        self.history.append(out)
        return out

    def finalize_history(self) -> list[dict]:
        """Turn the device metrics of ``sync=False`` rounds into floats
        (waits for the card)."""
        self.history = [{k: (float(v) if isinstance(v, torch.Tensor) else v)
                         for k, v in rec.items()} for rec in self.history]
        return self.history

    def evaluate(self) -> tuple[float, float]:
        """(mean loss, accuracy) of the global model on the test set."""
        return self._eval_fn(self.server_state.params.values())

    def evaluate_detection(self, benign_class: int = 0) -> dict:
        """Detection-oriented held-out report (per-class precision,
        recall and F1, macro-F1, the alarm view's detection and false-alarm
        rates; ``evaluation.detection_report``) from the global model's
        confusion matrix over the test set, in the evaluation's padded
        batches."""
        if not hasattr(self, "_conf_eval_fn"):
            self._conf_eval_fn = evaluation.make_confusion_eval_fn(
                self.eval_model, self.dataset.x_test, self.dataset.y_test,
                batch=max(self.config.fed.batch_size, 64),
                num_classes=self.config.model.num_classes,
                device=self.device)
        conf = self._conf_eval_fn(self.server_state.params.values())
        return evaluation.detection_report(conf, benign_class=benign_class)

    def evaluate_personalized(self, steps: int = 5,
                              lr: Optional[float] = None) -> dict:
        """Per-client personalization probe: fine-tune the current global
        model on the first half of each client's shard for ``steps`` local
        steps, then score both the global and the personalized model on
        the held-out second half (``programs.build_personalized_eval_fn``).
        Per-client arrays in client-id order and their weighted
        aggregates, as JAX's; clients with fewer than 2 examples have no
        holdout half and are dropped from the aggregates."""
        key = (steps, lr)
        if getattr(self, "_pers_eval_key", None) != key:
            self._pers_eval_fn = programs.build_personalized_eval_fn(
                self, steps, lr if lr is not None else self.config.fed.lr)
            self._pers_eval_key = key
        g_acc, p_acc, n_eval = self._pers_eval_fn(
            self.server_state.params.values())
        order = np.argsort(self.client_ids, kind="stable")
        g_acc, p_acc, n_eval = g_acc[order], p_acc[order], n_eval[order]
        real = n_eval > 0
        g_acc, p_acc, n_eval = g_acc[real], p_acc[real], n_eval[real]
        if n_eval.sum() == 0:
            # No client holds the >= 2 examples a holdout half needs.
            return {
                "global_acc": 0.0, "personalized_acc": 0.0,
                "personalization_gain": 0.0,
                "per_client_global_acc": g_acc,
                "per_client_personalized_acc": p_acc,
                "num_eval_examples": n_eval,
                "num_clients_evaluated": 0,
            }
        w = n_eval / n_eval.sum()
        return {
            "global_acc": float((g_acc * w).sum()),
            "personalized_acc": float((p_acc * w).sum()),
            "personalization_gain": float(((p_acc - g_acc) * w).sum()),
            "per_client_global_acc": g_acc,
            "per_client_personalized_acc": p_acc,
            "num_eval_examples": n_eval,
            "num_clients_evaluated": int(real.sum()),
        }

    def round_cost_analysis(self) -> dict:
        """The round's FLOPs: one client's local step counted under
        ``torch.utils.flop_counter.FlopCounterMode`` (matmuls and
        convolutions, forward and backward; the flash kernels, which it
        cannot see into, by their formula, ``ops.attention.count_flops``),
        times the cohort and ``num_steps``.  ``flops_per_round`` is that
        product; ``flops_per_step`` the one client's step.  The step runs
        from the global params on the first client with examples, with
        fixed batch rows, and leaves the server state and the draws
        untouched."""
        from torch.utils.flop_counter import FlopCounterMode

        from colearn_federated_learning_tpu_torch.ops import attention

        params = list(self.server_state.params.values())
        slot = int(np.argmax(np.asarray(self.block_counts) > 0))
        count = max(int(self.block_counts[slot]), 1)
        idx = torch.zeros((self.num_steps, self.config.fed.batch_size),
                          dtype=torch.long, device=self.device)
        args = (params, self.x[slot], self.y[slot], count, idx, 1)
        if self.scaffold:
            zeros = [torch.zeros_like(p) for p in params]
            args += (zeros, zeros)
        with FlopCounterMode(display=False) as counter, \
                attention.count_flops() as attn:
            res = self.local_update(*args)
            del res
        step = float(counter.get_total_flops() + attn.flops)
        return {"flops_per_step": step,
                "flops_per_round": step * self.cohort_size * self.num_steps}

    def evaluate_per_client(self) -> dict:
        """Score the current global model on every client's own shard:
        per-client arrays in client-id order (``per_client_loss``,
        ``per_client_acc``, ``num_examples``) and their example-weighted
        aggregates and accuracy spread (``evaluation.summarize_per_client``)."""
        loss, acc = programs.build_client_eval_fn(self)(
            self.server_state.params.values())
        # Undo the mesh interleaving and drop ghost clients.
        order = np.argsort(self.client_ids, kind="stable")
        loss, acc, counts = loss[order], acc[order], np.asarray(self.counts)[order]
        real = counts > 0
        loss, acc, counts = loss[real], acc[real], counts[real]
        out = evaluation.summarize_per_client(loss, acc, counts)
        out.update(per_client_loss=loss, per_client_acc=acc,
                   num_examples=counts)
        return out

    def client_update_similarity(self, steps: int = 1) -> np.ndarray:
        """(N, N) cosine similarity of every client's local update from the
        current global model: the clustering signal of clustered FL
        (``fed/clustered.py``).  Clients train one after another; their
        normalised flat updates are stacked and multiplied once."""
        if self.scaffold:
            raise NotImplementedError(
                "clustering uses the plain local trainer; run it with a "
                "stateless strategy")
        sim = programs.build_similarity_fn(self, steps)(
            list(self.server_state.params.values()))
        if self.mesh is not None:
            keep = self.id_order_slots()
            sim = sim[np.ix_(keep, keep)]
        return sim

    def id_order_slots(self) -> np.ndarray:
        """Array slot of every real client in client-id order: the inverse
        of the mesh interleaving with ghost padding dropped (ghosts are
        the ids past the real clients); the identity on one device."""
        if self.mesh is None:
            return np.arange(self.num_clients)
        order = np.argsort(self.client_ids, kind="stable")
        return order[:self.real_num_clients]

    # ---- checkpoint/resume (ckpt/) ------------------------------------
    def _checkpointer(self):
        if self._ckpt is None:
            from colearn_federated_learning_tpu_torch.ckpt import (
                RoundCheckpointer)

            self._ckpt = RoundCheckpointer.for_run(self.config.run)
        return self._ckpt

    def _flax_view(self, named: dict, batch_dims: int = 0) -> dict:
        """A name -> tensor dict as a flax-layout tree of views of the
        same tensors."""
        heads = self.config.model.num_heads
        return convert.nest(convert.leaf_to_flax(n, t, heads, batch_dims)
                            for n, t in named.items())

    def _whole(self, named: Optional[dict]) -> Optional[dict]:
        """A name -> tensor dict of this rank's TP slices gathered whole
        over the model group (every rank of it must call this); the dict
        itself without TP."""
        if named is None or self.tp_dims is None:
            return named
        from colearn_federated_learning_tpu_torch.parallel import tp as tp_lib

        return tp_lib.gather_params(named, dict(zip(named, self.tp_dims)),
                                    self.tp)

    def _checkpoint_state(self) -> tuple:
        """``(server_state, client_c)`` in the JAX engine's layout: the
        server state's trees in the flax layout, ``round_idx`` an int32
        ``()`` array, and SCAFFOLD's per-client variates (client-major,
        in array-slot order) or ``None``.  On one device these are views
        of the live tensors.  On a mesh every rank must call this: the
        clients-axis blocks of the variates are all-gathered, so the rows
        are the ``padded_num_clients`` slots in the interleaved order,
        ghosts included, and under TP the params and moments are
        gathered whole."""
        s = self.server_state

        def view(tree):
            return None if tree is None else self._flax_view(self._whole(tree))

        state = strategies.ServerState(
            params=view(s.params), opt_m=view(s.opt_m), opt_v=view(s.opt_v),
            control=view(s.control),
            round_idx=np.asarray(s.round_idx, np.int32))
        client_c = None
        if self.variates is not None:
            rows = self.variates.rows
            if self.clients.size > 1:
                rows = [collectives.all_gather(r.to(self.device),
                                               self.clients.group).cpu()
                        for r in rows]
            client_c = self._flax_view(dict(zip(s.params, rows)),
                                       batch_dims=1)
        return state, client_c

    def _mesh_lead(self) -> bool:
        """The rank that writes a mesh's checkpoint: index 0 of every
        axis (the only rank without a mesh)."""
        return all(ax.index == 0 for ax in (self.clients, self.seq, self.tp))

    def save_checkpoint(self) -> None:
        """Save ``(server_state, client_c)`` and the history at step
        ``len(history)`` (``sync=False`` records are finalized first).  On
        a mesh every rank must call this: the state is gathered, one rank
        (index 0 of every axis) writes the step, and every rank waits on a
        barrier of each mesh axis, so none goes on before the step is
        committed.  Beside the state the step records the clients axis's
        size and its slot order (``client_ids``), which the variate rows
        follow."""
        if any(isinstance(v, torch.Tensor)
               for rec in self.history for v in rec.values()):
            self.finalize_history()
        state = self._checkpoint_state()
        if self._mesh_lead():
            self._checkpointer().save(
                len(self.history), state, self.history,
                meta={"clients_size": self.clients_size,
                      "client_ids": self.client_ids.tolist()})
        del state
        for ax in (self.clients, self.seq, self.tp):
            if ax.group is not None:
                collectives.barrier(ax.group, self.device)

    def _restore_template(self) -> tuple:
        """The JAX layout of the whole state with stride-0 CPU leaves of
        the whole shapes and the live dtypes (nothing allocated): the
        restore's template."""
        s = self.server_state
        names = list(s.params)

        def zeros(tree, rows=()):
            if tree is None:
                return None
            whole = {n: torch.zeros((), dtype=tree[n].dtype).expand(
                         *rows, *shape)
                     for n, shape in zip(names, self.full_shapes)}
            return self._flax_view(whole, batch_dims=len(rows))

        state = strategies.ServerState(
            params=zeros(s.params), opt_m=zeros(s.opt_m),
            opt_v=zeros(s.opt_v), control=zeros(s.control),
            round_idx=np.asarray(s.round_idx, np.int32))
        client_c = None
        if self.variates is not None:
            client_c = zeros(dict(zip(names, self.variates.rows)),
                             (self.num_clients,))
        return state, client_c

    def _load_whole(self, state, client_c) -> None:
        """Copy a restored whole state into this rank's live tensors: its
        TP slices of every server tree (``partition.shard``, as
        :meth:`load_flax_params` cuts them) and its clients-axis block of
        the variate rows (all of both on one device)."""
        from colearn_federated_learning_tpu_torch.ckpt import streaming
        from colearn_federated_learning_tpu_torch.parallel import partition

        s = self.server_state
        dims = dict(zip(s.params, self.tp_dims or [None] * len(s.params)))
        for field in ("params", "opt_m", "opt_v", "control"):
            live = getattr(s, field)
            if live is None:
                continue
            whole = dict(convert.leaf_to_torch(tuple(path.split("/")), t)
                         for path, t in streaming.flatten_state(
                             getattr(state, field)))
            with torch.no_grad():
                for n, t in live.items():
                    t.copy_(partition.shard(whole[n], dims[n], self.tp_size,
                                            self.tp.index))
        if self.variates is not None:
            L = len(self.block_ids)
            block = slice(self.clients.index * L, (self.clients.index + 1) * L)
            live = self._flax_view(dict(zip(s.params, self.variates.rows)),
                                   batch_dims=1)
            for (_, dst), (_, src) in zip(streaming.flatten_state(live),
                                          streaming.flatten_state(client_c)):
                dst.copy_(src[block])
        s.round_idx = int(state.round_idx)

    def _check_slot_order(self, ckpt) -> None:
        """Refuse a step whose SCAFFOLD variates are in another slot order
        than this learner's: a clients axis of another size interleaves
        the clients otherwise, even where it pads them to the same count.
        As in the JAX engine, no re-permutation maps the rows onto another
        layout.  A step that records no order was saved on one device."""
        if self.variates is None:
            return
        meta = ckpt.step_meta()
        ids = meta.get("client_ids")
        if ids is None:
            rows = [rec["shape"][0] for rec in ckpt.leaf_table()
                    if rec["path"].startswith("1/")]
            if not rows:             # no variates: the restore refuses it
                return
            ids = list(range(rows[0]))
        if ids != self.client_ids.tolist():
            raise ValueError(
                f"checkpoint holds SCAFFOLD's variates for {len(ids)} client "
                f"slots in the slot order of a {meta.get('clients_size', 1)}"
                f"-way clients axis; this learner's {self.clients_size}-way "
                f"clients axis has {self.num_clients} slots "
                f"({self.real_num_clients} clients) in another order, and no "
                "re-permutation maps the rows onto it: restore onto a "
                "clients axis of the saved size")

    def restore_checkpoint(self) -> int:
        """Restore the latest checkpoint into the live tensors; returns the
        resumed round index.  The accountant is charged for every round
        already run, and the adaptive clip continues from the last
        record's.  On a mesh every rank reads the step and keeps its part:
        its TP slices (so a step saved at one tp size restores at any
        other that divides the model's dims, and on one device) and its
        block of the variate rows."""
        ckpt = self._checkpointer()
        self._check_slot_order(ckpt)
        state, history, step = ckpt.restore(self._restore_template())
        self._load_whole(*state)
        self.history = history
        if self.accountant is not None:
            self.accountant.steps = step
        if self.adaptive_clip and history:
            self.dp_clip = torch.tensor(history[-1]["dp_clip"],
                                        dtype=torch.float32,
                                        device=self.device)
        return step

    def fit(self, rounds: Optional[int] = None, log_fn=None) -> list[dict]:
        """Run ``rounds`` more rounds (default: up to ``config.fed.rounds``),
        evaluating every ``run.eval_every`` rounds and after the last, and
        handing every ``run.log_every``-th record and the last to
        ``log_fn``.  ``round_time_s`` is the round alone; an evaluation's
        time is its own ``phase_eval_s``.  On the card the record also
        carries ``hbm_used_gb``, the memory allocated after the round.
        With ``run.trace_dir`` the rounds of the window are traced and the
        trace written (``last_trace_path``), even when a round raises, and
        the records carry ``flops_per_round``; with ``run.profile_dir`` a
        ``torch.profiler`` window covers rounds 1..2 and is closed however
        ``fit`` ends.
        With ``run.checkpoint_dir`` the state is saved after the record is
        logged, every ``run.checkpoint_every`` rounds and always after the
        last, in a ``checkpoint`` span (``phase_checkpoint_s``)."""
        if rounds is None:
            rounds = max(0, self.config.fed.rounds - len(self.history))
        run = self.config.run
        eval_every = max(1, run.eval_every)
        log_every = max(1, run.log_every)
        ckpt_every = max(0, run.checkpoint_every)
        want_ckpt = bool(run.checkpoint_dir)
        last_round = len(self.history) + rounds - 1
        telem = telemetry.RoundTelemetry(run, self.tracer, self.device)
        # The FLOP count rides the trace window, as in JAX: counted once
        # and cached across fit() calls.
        if telem.tracing and self._flops_per_round is None:
            self._flops_per_round = self.round_cost_analysis()[
                "flops_per_round"]
        try:
            for _ in range(rounds):
                t0 = time.perf_counter()
                telem.before_round(len(self.history))
                with self.tracer.span("round", round=len(self.history)):
                    rec = self.run_round()
                    if telem.profiling and not self.tracer.enabled:
                        # The profiler window must hold the round's device
                        # work; the traced round already waited.
                        self._sync()
                    telem.after_round(rec["round"])
                    rec["round_time_s"] = time.perf_counter() - t0
                    stats = telemetry.sample_device_memory(
                        device=self.device)
                    if stats.get("bytes_in_use"):
                        rec["hbm_used_gb"] = round(
                            stats["bytes_in_use"] / 2**30, 3)
                    if self._flops_per_round:
                        rec["flops_per_round"] = self._flops_per_round
                    if (rec["round"] % eval_every == 0
                            or rec["round"] == last_round):
                        with self.tracer.span("evaluate") as ev_sp:
                            rec["eval_loss"], rec["eval_acc"] = \
                                self.evaluate()
                            self._sync()
                        rec["phase_eval_s"] = ev_sp.duration_s
                    if log_fn is not None and (
                            rec["round"] % log_every == 0
                            or rec["round"] == last_round):
                        log_fn(rec)
                    # With a checkpoint_dir the last round always saves,
                    # so --resume works without a cadence.
                    if want_ckpt and (
                            (ckpt_every
                             and (rec["round"] + 1) % ckpt_every == 0)
                            or rec["round"] == last_round):
                        with self.tracer.span("checkpoint") as ck_sp:
                            self.save_checkpoint()
                        rec["phase_checkpoint_s"] = ck_sp.duration_s
                telemetry.get_registry().histogram(
                    "engine.round_time_s").observe(rec["round_time_s"])
                # After the round span closed: an early flush of the
                # window must include the last traced round.
                telem.end_round(rec["round"])
        finally:
            self.last_trace_path = telem.close()
        return self.history
