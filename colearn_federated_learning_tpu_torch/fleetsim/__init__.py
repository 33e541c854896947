"""Million-device fleet simulation (the counterpart of the JAX package's
``fleetsim/``).

Real sockets cap the process soaks at a handful of workers; this package
simulates 1k -> 1M clients per host by training the cohort in fixed-size
chunks through ``fed/local.py``'s local update:

- :mod:`.population` -- seeded synthetic device population; non-IID data
  shards are materialized on demand from per-device keys (memory stays
  O(chunk), never O(fleet)); a copy of JAX's (numpy only);
- :mod:`.traffic` -- arrival-process availability (Poisson base rate x
  diurnal modulation) driving cohort sampling from available devices; a
  copy of JAX's (numpy only);
- :mod:`.sim` -- the chunked round loop, reusing the engine's
  aggregation semantics and FaultPlan keys ``(device, round, op)`` for
  per-simulated-device drop/straggle/corrupt faults, and the buffered-
  asynchronous plane (flat and two-tier) on a virtual clock.
"""

from colearn_federated_learning_tpu_torch.fleetsim.population import (
    DevicePopulation,
    PopulationSpec,
    SpeedClass,
)
from colearn_federated_learning_tpu_torch.fleetsim.sim import FleetSim
from colearn_federated_learning_tpu_torch.fleetsim.traffic import (
    TrafficModel,
    TrafficSpec,
)

__all__ = [
    "DevicePopulation",
    "PopulationSpec",
    "SpeedClass",
    "FleetSim",
    "TrafficModel",
    "TrafficSpec",
]
