"""Static analysis of the PyTorch port: ``lint`` (``engine``, ``rules``,
``lock_regions``, ``reporters``, ``findings``), the SLO ``sentinel``, and
``metric_catalog``, a verbatim copy of the JAX package's catalog, which
``telemetry/registry.py`` imports.

Kept lazy on purpose, as the JAX package's is: importing the package
must not import the rule set, so the registry can depend on
``analysis.metric_catalog`` without dragging the linter into the runtime
import graph.  Nothing here imports torch.
"""

__all__ = ["engine", "findings", "lock_regions", "metric_catalog",
           "reporters", "rules", "sentinel"]
