"""Federated training: local trainer, round program, server strategies."""

from colearn_federated_learning_tpu_torch.fed.engine import FederatedLearner

__all__ = ["FederatedLearner"]
