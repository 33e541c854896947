"""Deterministic fault injection for the federation planes (the
counterpart of the JAX package's ``faults/``): ``plan`` describes what
fails, ``inject`` applies it at the transport's interposer seams, and
``fileplane`` at the file and hierarchical planes' exchange points.
``soak`` and ``procsoak`` run a federation under a plan, in this process
and as real subprocesses with real SIGKILL, and report whether the
robustness machinery (retries, quorum, eviction, CRC framing, checkpoint
resume, the tree's failover, the asynchronous plane's resume and re-home)
held.  ``lockwitness`` checks the lock order and the guarded structures
of the processes it runs in.  Not ported yet: the checkpoint process soak
(ROADMAP.md Queue A item 15)."""

from colearn_federated_learning_tpu_torch.faults.plan import (  # noqa: F401
    ANY, ANY_ROUND, FILE_KINDS, KINDS, FaultPlan, FaultSpec)
from colearn_federated_learning_tpu_torch.faults.inject import (  # noqa: F401
    FaultInjector, active_plan, install, uninstall)
from colearn_federated_learning_tpu_torch.faults.soak import (  # noqa: F401
    canned_plan, default_soak_config, run_soak)
from colearn_federated_learning_tpu_torch.faults.procsoak import (  # noqa: F401
    KillSpec, canned_kill_schedule, run_agg_soak, run_async_soak,
    run_proc_soak, run_tree_async_soak)
