"""Cross-process federation: the control plane and the tensor plane (the
counterpart of the JAX package's ``comm/``; the same frames, topics and
requests, so processes of the two packages federate together).

- ``protocol``:    length-prefixed JSON header + binary body framing.
- ``broker``:      the TCP pub/sub broker (the MQTT stand-in).
- ``enrollment``:  device announce -> trainer/evaluator roles.
- ``mud``:         RFC 8520 device profiles and the enrollment gate.
- ``transport``:   per-device tensor server and client.
- ``keyexchange``: DH pair keys for the wire plane's secure aggregation.
- ``downlink``:    serialize-once broadcast and ``compress_down`` deltas.
- ``worker``:      a device process: local shard and trainer on its card.
- ``coordinator``: the synchronous round loop over enrolled devices.
- ``async_coordinator``: the buffered-asynchronous coordinator (FedBuff
  style), flat or through the aggregator tree's slice buffers.
- ``aggregator``:  the aggregator tree's middle tier (slice folds and the
  asynchronous slice buffers).
- ``per_type``:    one federation per MUD device type.
- ``aggregation``: the update folders, with the device fold (B4).

The coordinators' server state may be sharded over a placement
(``parallel.partition.ServerPlacement``, ``run.tp_size``).  The chaos
soaks (``faults/soak.py``, ``faults/procsoak.py``: ``chaos``,
``--secure``, ``--mp``, ``--agg``, ``--async``, ``--tree-async``,
``--ckpt``) drive
this plane under fault plans and real SIGKILLs, with the flight recorder
(``telemetry/flight.py``) on every process; the broker's, the
aggregators' and both coordinators' locks are ``faults/lockwitness.py``'s,
which ``--lock-witness`` turns on.  With ``run.learn_observe`` both
coordinators keep the convergence observatory
(``telemetry/convergence.py``).  Not ported yet, refused naming its
ROADMAP.md Queue A item: the analysis tools (17).
"""

ITEM_ANALYSIS = "ROADMAP.md Queue A item 17 (the analysis tools)"
