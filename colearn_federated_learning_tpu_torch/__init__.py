"""PyTorch/CUDA port of colearn_federated_learning_tpu for NVIDIA Hopper.

The federated round (cohort sampling, local training, weighted
aggregation, server update, evaluation) runs on one CUDA device; the BERT
family's attention goes through hand-written CUDA flash-attention kernels
(``ops/attention.py``).  Entry point: ``fed.FederatedLearner``.
"""
