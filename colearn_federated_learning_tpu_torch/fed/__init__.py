"""Federated training: local trainer, round program, server strategies,
and the hierarchical and clustered learners built on the round."""

from colearn_federated_learning_tpu_torch.fed.clustered import ClusteredLearner
from colearn_federated_learning_tpu_torch.fed.engine import FederatedLearner
from colearn_federated_learning_tpu_torch.fed.hierarchical import (
    HierarchicalLearner)

__all__ = ["ClusteredLearner", "FederatedLearner", "HierarchicalLearner"]
