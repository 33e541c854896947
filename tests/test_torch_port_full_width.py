"""One registry configuration at full width, the port against the JAX
``FederatedLearner`` client by client, on the CPU.

Both sides start from the same params (the JAX init, converted), and the
port replays the JAX round's own batch draws (``JaxDraws``).  Each sampled
client of round 0 runs its local update on both sides, and its mean loss
and update norm are compared.

Config #1 (``mnist_mlp_fedavg``: 10 iid clients, 188 steps of SGD at lr 0.1
with momentum 0.9) runs as it is.  At that lr two of its ten clients go
unstable on the synthetic MNIST stand-in, on both sides: their losses rise
from step ≈ 16 on and end far above ln 10, while the other eight settle
near 0.07.  Until the instability both sides agree to f32 roundoff; past
it, the roundoff grows without bound and each side ends at a loss of its
own.  So the test holds every client to rtol 1e-5 over the first 16
steps, and over the full 188 steps holds the stable clients to rtol 1e-4
and the unstable ones to being the same clients on both sides.

As a script it prints the same comparison for any configuration (the
first ``--clients`` of round 0's cohort, at each step count of
``--steps``; by default the configuration's own budget):

    JAX_PLATFORMS=cpu python -m tests.test_torch_port_full_width \\
        --config cifar100_resnet18_fedprox --clients 2
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from colearn_federated_learning_tpu.fed import FederatedLearner as JaxLearner
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu.utils import prng as jax_prng
from colearn_federated_learning_tpu_torch.fed import FederatedLearner
from colearn_federated_learning_tpu_torch.utils import config
from tests.test_torch_port_round import JaxDraws

UNSTABLE_LOSS = 1.0          # mean loss of a client that went unstable


def client_updates(name: str, steps_list, n_clients=None):
    """Yield ``(steps, client, jax_loss, jax_norm, port_loss, port_norm)``
    for the first ``n_clients`` of round 0's cohort (all by default) at
    each step count of ``steps_list`` (``None``: the config's budget)."""
    jcfg, tcfg = jax_config.get_config(name), config.get_config(name)
    jl = JaxLearner(jcfg)
    tl = FederatedLearner(tcfg, device="cpu", plan=JaxDraws(jcfg.run.seed))
    tl.load_flax_params(jax.device_get(jl.params))
    if tl.cohort_size < tl.num_clients:
        sel = tl.draws.cohort(0, tl.counts, tl.cohort_size)
    else:
        sel = np.arange(tl.num_clients)
    key = jax_prng.experiment_key(jcfg.run.seed)
    update = jax.jit(jl.local_update)
    params = list(tl.params.values())
    for steps in steps_list or [tl.num_steps]:
        for c in (int(s) for s in sel[:n_clients]):
            count = int(tl.counts[c])
            jr = update(jl.params, jnp.asarray(jl.shards.x[c]),
                        jnp.asarray(jl.shards.y[c]), jnp.int32(count),
                        jax_prng.client_round_key(key, jnp.int32(c),
                                                  jnp.int32(0)),
                        jnp.int32(steps), None)
            jnorm = np.sqrt(sum(float(jnp.sum(jnp.square(d)))
                                for d in jax.tree.leaves(jr.delta)))
            idx = torch.as_tensor(tl.draws.batch_indices(
                0, c, count, tl.num_steps, tcfg.fed.batch_size))
            tr = tl.local_update(params, tl.x[c], tl.y[c], count, idx, steps,
                                 None)
            tnorm = float(torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(tr.delta))))
            yield (steps, c, float(jr.mean_loss), float(jnorm),
                   float(tr.mean_loss), tnorm)


def test_mlp_config_clients_match_jax_until_they_go_unstable():
    rows = list(client_updates("mnist_mlp_fedavg", [16, 188]))
    early = [r for r in rows if r[0] == 16]
    full = [r for r in rows if r[0] == 188]
    assert len(early) == len(full) == 10
    for _, c, jloss, jnorm, tloss, tnorm in early:
        np.testing.assert_allclose([tloss, tnorm], [jloss, jnorm], rtol=1e-5,
                                   err_msg=f"client {c}, 16 steps")
    unstable_jax = {r[1] for r in full if r[2] > UNSTABLE_LOSS}
    unstable_port = {r[1] for r in full if r[4] > UNSTABLE_LOSS}
    assert unstable_jax and unstable_jax == unstable_port
    for _, c, jloss, jnorm, tloss, tnorm in full:
        if c not in unstable_jax:
            np.testing.assert_allclose([tloss, tnorm], [jloss, jnorm],
                                       rtol=1e-4,
                                       err_msg=f"client {c}, 188 steps")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--steps", default="",
                    help="comma-separated step counts (default: the budget)")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    steps = [int(s) for s in args.steps.split(",") if s]
    print("steps client jax_loss jax_norm port_loss port_norm", flush=True)
    for row in client_updates(args.config, steps, args.clients):
        print(*row, flush=True)


if __name__ == "__main__":
    main()
