"""Spawned gloo ranks for the port's multi-rank tests.

The parent (a pytest process, which has JAX loaded) records the JAX
round's draws as numpy arrays and calls :func:`spawn`; every child runs
in a fresh interpreter that imports this module, torch and the port —
never JAX nor the JAX package, so the children stay light.  The ranks
meet through a ``FileStore`` in the test's temporary directory (no TCP
port to collide between test workers), run ``torch.set_num_threads(1)``,
and each runs the named scenarios of :data:`SCENARIOS` in order over the
same world; rank-side results come back as pickles.  A spawn that does
not finish within its timeout is killed and fails the test.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback

import numpy as np
import torch


# ------------------------------------------------------------ parent side
def spawn(world: int, tmp_path, jobs: list, timeout: float = 240.0) -> list:
    """Run ``jobs`` (a list of ``(scenario name, payload)``) on ``world``
    spawned ranks; returns ``results[rank][i]``, the return of job ``i``
    on that rank.  Raises AssertionError on a child's error or on
    timeout."""
    import torch.multiprocessing as mp

    tmp = str(tmp_path)
    with open(os.path.join(tmp, "jobs.pkl"), "wb") as f:
        pickle.dump(jobs, f)
    ctx = mp.start_processes(_child, args=(world, tmp), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise AssertionError(
                    f"spawned ranks did not finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    out = []
    for rank in range(world):
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
            res = pickle.load(f)
        if isinstance(res, str):
            raise AssertionError(f"rank {rank} failed:\n{res}")
        out.append(res)
    return out


def _child(rank: int, world: int, tmp: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    with open(os.path.join(tmp, "jobs.pkl"), "rb") as f:
        jobs = pickle.load(f)
    try:
        res = [SCENARIOS[name](payload) for name, payload in jobs]
    except Exception:
        res = traceback.format_exc()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    if not isinstance(res, str):
        dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------- recorded draws
class RecordedDraws:
    """A ``plan`` serving draws the parent recorded from JAX: the
    per-device cohorts, batch indices and straggler budgets, DP noise and
    pair masks (already in the port's layout and order, full shapes),
    ring scores and the clip bit's noise."""

    def __init__(self, rec: dict):
        self.rec = rec

    def device_cohort(self, round_idx, dev, counts, k):
        return self.rec["cohort"][(round_idx, dev)][:k]

    def batch_indices(self, round_idx, client_id, count, num_steps, batch):
        return self.rec["batch"][(round_idx, int(client_id))]

    def step_budgets(self, round_idx, client_ids, num_steps, prob):
        return np.asarray([self.rec["budget"][(round_idx, int(i))]
                           for i in client_ids])

    def dp_noise(self, round_idx, client_id, shapes, device):
        return iter([torch.from_numpy(a.copy()) for a in
                     self.rec["dp"][(round_idx, int(client_id))]])

    def pair_mask(self, round_idx, a, b, shapes, device, stream=0):
        lo, hi = min(int(a), int(b)), max(int(a), int(b))
        return iter([torch.from_numpy(np.array(x)) for x in
                     self.rec["mask"][(round_idx, lo, hi, stream)]])

    def ring_order(self, round_idx, cohort_ids):
        ids = np.asarray(cohort_ids)
        score = self.rec["ring"][round_idx]
        return ids[np.argsort(score[ids], kind="stable")]

    def clip_bit_noise(self, round_idx, device):
        return torch.tensor(self.rec["clip_bit"][round_idx])


# ------------------------------------------------------------ scenarios
def _mesh(names, sizes):
    from colearn_federated_learning_tpu_torch.parallel import mesh as mesh_lib

    return mesh_lib.make_mesh(names, sizes, device_type="cpu")


def layouts(p: dict) -> dict:
    """The mesh ``FederatedLearner.from_config`` lays over this world for
    each of ``p["configs"]``: its axis names and sizes."""
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner

    out = {}
    for name, cfg in p["configs"].items():
        ln = FederatedLearner.from_config(cfg, device="cpu")
        out[name] = (tuple(ln.mesh.mesh_dim_names), tuple(ln.mesh.mesh.shape))
    return out


def _numpy(params: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in params.items()}


def learner_rounds(p: dict) -> dict:
    """Build the port's learner on a mesh (``p["mesh"]``: names, sizes)
    with the recorded JAX draws and the JAX initial params, run
    ``p["rounds"]`` rounds and report records, last cohort, the whole
    params, an evaluation and, when asked, the per-client evaluation and
    the update similarity."""
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner
    from colearn_federated_learning_tpu_torch.parallel import collectives

    mesh = _mesh(*p["mesh"])
    ln = FederatedLearner(p["config"], dataset=p.get("dataset"), device="cpu",
                          plan=RecordedDraws(p["draws"]), mesh=mesh)
    ln.load_flax_params(p["params"])
    out = {"records": [], "cohorts": [], "counts": []}
    for _ in range(p["rounds"]):
        collectives.reset_counts()
        out["records"].append(ln.run_round())
        out["cohorts"].append(ln.last_cohort)
        out["counts"].append(dict(collectives.counts))
    out["params"] = _numpy(ln.full_params())
    out["eval"] = ln.evaluate()
    out["tp_dims"] = ln.tp_dims
    out["local_shapes"] = {k: tuple(v.shape) for k, v in ln.params.items()}
    if p.get("per_client"):
        out["per_client"] = ln.evaluate_per_client()
        out["similarity"] = ln.client_update_similarity(steps=2)
    return out


def attention(p: dict) -> dict:
    """Ring and Ulysses attention on this rank's sequence block of the
    parent's (B, L, H, D) inputs, forward and the gradients of
    ``sum(out * cot)``; the blocks are returned for the parent to
    assemble."""
    from colearn_federated_learning_tpu_torch.parallel import mesh as mesh_lib
    from colearn_federated_learning_tpu_torch.parallel.ring import (
        ring_attention)
    from colearn_federated_learning_tpu_torch.parallel.ulysses import (
        ulysses_attention)

    mesh = _mesh(("seq",), (p["world"],))
    ax = mesh_lib.axis(mesh, "seq")
    out = {}
    for impl, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        for causal in (False, True):
            blk = {k: torch.from_numpy(p[k]).chunk(ax.size, 1)[ax.index]
                   .clone().requires_grad_(k in "qkv")
                   for k in ("q", "k", "v", "cot")}
            mask = torch.from_numpy(p["mask"]).chunk(ax.size, 1)[ax.index]
            o = fn(blk["q"], blk["k"], blk["v"], mask, group=ax.group,
                   causal=causal)
            grads = torch.autograd.grad((o * blk["cot"]).sum(),
                                        [blk["q"], blk["k"], blk["v"]])
            out[(impl, causal)] = [o.detach().numpy()] + [
                g.numpy() for g in grads]
    try:
        ulysses_attention(blk["q"][:, :, :3], blk["k"][:, :, :3],
                          blk["v"][:, :, :3], group=ax.group)
    except ValueError as e:
        out["ulysses_error"] = str(e)
    return out


def sp_model(p: dict) -> dict:
    """``parallel.sp`` on a (seq,) mesh: the SP BERT's logits and its
    loss and gradients for the parent's full batch."""
    import dataclasses

    from colearn_federated_learning_tpu_torch.fed import losses
    from colearn_federated_learning_tpu_torch.models import registry
    from colearn_federated_learning_tpu_torch.parallel import mesh as mesh_lib
    from colearn_federated_learning_tpu_torch.parallel import sp

    mesh = _mesh(("seq",), (p["world"],))
    out = {}
    for impl in ("ring", "ulysses"):
        cfg = dataclasses.replace(p["model_config"], attn_impl=impl)
        model = registry.build_model(cfg, "cpu", seq_group=mesh_lib.axis(
            mesh, "seq").group)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in p["state_dict"].items()})
        ids = torch.from_numpy(p["ids"]).long()
        y = torch.from_numpy(p["y"]).long()
        logits = sp.make_sp_apply(model, mesh)(ids)
        loss, grads = sp.make_sp_loss_grad(
            model, losses.softmax_cross_entropy, mesh)(ids, y)
        out[impl] = (logits.numpy(), float(loss),
                     [g.numpy() for g in grads])
    return out


def _whole_state(ln) -> dict:
    """A learner's whole server state and every variate row (slot
    order), as numpy: TP slices and clients-axis blocks gathered (every
    rank of the mesh must call this)."""
    from colearn_federated_learning_tpu_torch.ckpt import streaming

    state, client_c = ln._checkpoint_state()
    return {path: (t.detach().cpu().numpy().copy()
                   if isinstance(t, torch.Tensor) else np.asarray(t))
            for path, t in streaming.flatten_state((state, client_c))}


def mesh_resume(p: dict) -> dict:
    """Item 15b on a mesh (``p["mesh"]``): an uninterrupted
    ``p["rounds"]``-round run; a run with ``checkpoint_dir`` that saves
    after round 1; then for each of ``p["resumes"]`` (a mesh spec, or
    None for one device) a fresh learner that restores the step and runs
    the remaining rounds (the last one through ``fit``, which saves
    again; the others through ``run_round``).  Returns the whole states
    (numpy, keyed by checkpoint path): ``straight``, ``saved`` (the
    saving run's after round 1), and per resume ``restored`` (right after
    the restore) and ``resumed``; rank 0 adds the step's leaves as
    written (``leaves``)."""
    import dataclasses

    import torch.distributed as dist

    from colearn_federated_learning_tpu_torch.ckpt import RoundCheckpointer
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner

    cfg, ck = p["config"], p["ckpt_dir"]
    ccfg = cfg.replace(run=dataclasses.replace(cfg.run, checkpoint_dir=ck))
    draws = RecordedDraws(p["draws"])

    def learner(config, spec):
        ln = FederatedLearner(config, device="cpu", plan=draws,
                              mesh=None if spec is None else _mesh(*spec))
        ln.load_flax_params(p["params"])
        return ln

    out = {}
    ln = learner(cfg, p["mesh"])
    ln.fit(rounds=p["rounds"])
    out["straight"] = _whole_state(ln)
    ln = learner(ccfg, p["mesh"])
    ln.fit(rounds=1)
    out["saved"] = _whole_state(ln)
    out["history"] = ln.history
    if dist.get_rank() == 0:
        out["leaves"] = {path: t.numpy().copy() for path, t in
                         RoundCheckpointer(ck).load_leaves()}
    for i, spec in enumerate(p["resumes"]):
        ln = learner(ccfg, spec)
        out[("step", i)] = ln.restore_checkpoint()
        out[("restored", i)] = _whole_state(ln)
        if i == len(p["resumes"]) - 1:
            ln.fit()
        else:
            for _ in range(p["rounds"] - 1):
                ln.run_round()
        out[("resumed", i)] = _whole_state(ln)
        out[("history", i)] = [dict(r) for r in ln.history]
    return out


def mesh_resize(p: dict) -> dict:
    """SCAFFOLD steps restored onto a clients axis of another size; each
    case gives the restore's error (``None`` if it restored) and the
    learner's slot count.  ``pad``: the step of ``p["config"]`` (saved on
    the 4-way axis) on a 2-way axis over ranks 0 and 1 (the other ranks
    build the mesh and stay out).  With ``p["equal"]``, a config whose
    slot count is the same on 4, 2 and 1 devices: ``to2`` and ``to1``, a
    step it saves on the 4-way axis restored on the 2-way axis and on one
    device; ``from1``, a step rank 0 saves on one device
    (``p["equal_one"]`` names its directory) restored on the 4-way
    axis."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from colearn_federated_learning_tpu_torch.fed import FederatedLearner

    rank = dist.get_rank()
    two = DeviceMesh("cpu", torch.arange(p["size"]),
                     mesh_dim_names=("clients",))

    def restore(cfg, mesh):
        ln = FederatedLearner(cfg, device="cpu", mesh=mesh)
        try:
            ln.restore_checkpoint()
        except ValueError as e:
            return {"error": str(e), "slots": ln.num_clients}
        return {"error": None, "slots": ln.num_clients}

    out = {"pad": restore(p["config"], two) if rank < p["size"] else None}
    eq = p["equal"]
    four = _mesh(("clients",), (dist.get_world_size(),))
    FederatedLearner(eq, device="cpu", mesh=four).fit(rounds=1)
    out["to2"] = restore(eq, two) if rank < p["size"] else None
    out["to1"] = restore(eq, None)
    one = eq.replace(run=dataclasses.replace(eq.run,
                                             checkpoint_dir=p["equal_one"]))
    if rank == 0:
        FederatedLearner(one, device="cpu").fit(rounds=1)
    dist.barrier()
    out["from1"] = restore(one, four)
    return out


def personalized(p: dict) -> dict:
    """The port's learner on a ``clients`` mesh of the world with its own
    draws: ``p["rounds"]`` rounds, then ``evaluate_personalized(
    p["steps"])``, each rank fine-tuning and scoring its block."""
    from colearn_federated_learning_tpu_torch.fed import FederatedLearner

    world = torch.distributed.get_world_size()
    ln = FederatedLearner(p["config"], device="cpu",
                          mesh=_mesh(("clients",), (world,)))
    ln.fit(rounds=p["rounds"])
    return ln.evaluate_personalized(steps=p["steps"])


SCENARIOS = {"learner_rounds": learner_rounds, "attention": attention,
             "sp_model": sp_model, "layouts": layouts,
             "mesh_resume": mesh_resume, "mesh_resize": mesh_resize,
             "personalized": personalized}
