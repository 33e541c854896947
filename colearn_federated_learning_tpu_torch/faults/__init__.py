"""Deterministic fault injection for the federation planes (the
counterpart of the JAX package's ``faults/``): ``plan`` describes what
fails, ``inject`` applies it at the transport's interposer seams, and
``fileplane`` at the file and hierarchical planes' exchange points.  The
soaks (``soak``, ``procsoak``) and the lock witness are not ported yet
(ROADMAP.md Queue A)."""

from colearn_federated_learning_tpu_torch.faults.plan import (  # noqa: F401
    ANY, ANY_ROUND, FILE_KINDS, KINDS, FaultPlan, FaultSpec)
from colearn_federated_learning_tpu_torch.faults.inject import (  # noqa: F401
    FaultInjector, active_plan, install, uninstall)
