"""Multi-device parallelism on ``torch.distributed``: named meshes, the
counted collectives, partition rules, tensor parallelism and sequence
parallelism (ring and Ulysses attention).

The counterpart of the JAX package's ``parallel/``:

- ``mesh``: ``DeviceMesh`` construction over the world (clients × seq ×
  model), the axis helper the engine reads;
- ``collectives``: counted all-reduce/all-gather/all-to-all and the ring
  shift, with the SP and TP gradient conventions;
- ``partition``: the regex rule engine on flax paths, mapped onto the
  port's torch layouts; ``tp``: the tensor-parallel slices;
- ``ring``, ``ulysses``, ``sp``: sequence-parallel attention and model
  execution.
"""
