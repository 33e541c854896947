"""Checkpoints and resume (the counterpart of the JAX package's
``ckpt/``): the round checkpointer, the streaming checkpointer in JAX's
on-disk format, and the round WAL and enrollment ledger."""

from colearn_federated_learning_tpu_torch.ckpt.manager import RoundCheckpointer
from colearn_federated_learning_tpu_torch.ckpt.streaming import (
    StreamingCheckpointer,
    load_generation_host,
)
from colearn_federated_learning_tpu_torch.ckpt.wal import (
    EnrollmentLedger, RoundWal)

__all__ = ["RoundCheckpointer", "StreamingCheckpointer",
           "load_generation_host", "RoundWal", "EnrollmentLedger"]
