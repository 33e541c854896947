"""Analysis support of the PyTorch port: ``metric_catalog``, a verbatim
copy of the JAX package's catalog, which ``telemetry/registry.py``
imports.  The lint and sentinel tools are ROADMAP.md Queue A item 17."""
