"""Deterministic synthetic datasets with the shapes of the benchmark corpora.

Without dataset files on disk the registry falls back to class-conditional
synthetic data whose shapes/dtypes match MNIST / CIFAR-10 / CIFAR-100 /
AG-News / FEMNIST.  The generator is a fixed random class-prototype plus
noise, which makes the tasks genuinely learnable — accuracy curves rise
across federated rounds, exercising the same code paths a real corpus
would (the reference validated by watching accuracy curves, SURVEY.md §4).

Generation is numpy on host: it runs once at startup and produces the
static-shape arrays the training round consumes.  A copy of the JAX
package's ``data/synthetic.py``, kept byte-compatible so both packages draw
identical datasets from one seed.
"""

from __future__ import annotations

import numpy as np


def synthetic_image_classification(
    n: int,
    image_shape: tuple[int, int, int],
    n_classes: int,
    seed: int = 0,
    noise: float = 0.35,
    proto_seed: int = 1234,
) -> tuple[np.ndarray, np.ndarray]:
    """Images = smoothed class prototype + Gaussian noise, in [0, 1].

    Prototypes are low-frequency random fields so conv nets (and patching
    ViTs) have spatial structure to exploit, not just a per-pixel bias.
    ``proto_seed`` is SEPARATE from ``seed`` so train and test splits share
    one class structure (generalization is real) while drawing disjoint
    samples.
    """
    rng = np.random.default_rng(seed)
    h, w, c = image_shape
    # Low-res prototype upsampled → low-frequency spatial structure.
    lo = max(2, h // 4), max(2, w // 4)
    proto_rng = np.random.default_rng(proto_seed)
    protos_lo = proto_rng.normal(0.5, 0.5, size=(n_classes, *lo, c))
    protos = np.stack(
        [
            np.kron(p, np.ones((h // lo[0] + 1, w // lo[1] + 1))[..., None])[:h, :w, :]
            for p in protos_lo
        ]
    )
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    x = protos[y] + rng.normal(0.0, noise, size=(n, h, w, c))
    x = np.clip(x, 0.0, 1.0).astype(np.float32)
    return x, y


def synthetic_text_classification(
    n: int,
    seq_len: int,
    vocab_size: int,
    n_classes: int,
    seed: int = 0,
    signal_tokens: int = 48,
) -> tuple[np.ndarray, np.ndarray]:
    """Token sequences where each class over-samples its own token bucket.

    Shapes match a wordpiece-tokenized AG-News batch: int32 ids of
    (n, seq_len) with id 0 reserved for padding.
    """
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    # Class-specific "topic vocabulary" buckets, disjoint, above id 1000.
    base = 1000
    buckets = [
        np.arange(base + k * signal_tokens, base + (k + 1) * signal_tokens)
        for k in range(n_classes)
    ]
    x = rng.integers(1, vocab_size, size=(n, seq_len)).astype(np.int32)
    topic_mask = rng.random((n, seq_len)) < 0.3
    for k in range(n_classes):
        rows = y == k
        topical = rng.choice(buckets[k], size=(int(rows.sum()), seq_len))
        x[rows] = np.where(topic_mask[rows], topical, x[rows])
    # Variable lengths with 0-padding, like real tokenized text.
    lengths = rng.integers(seq_len // 4, seq_len + 1, size=n)
    pad = np.arange(seq_len)[None, :] >= lengths[:, None]
    x[pad] = 0
    return x, y


def synthetic_traffic_classification(
    n: int,
    shape: tuple[int, int],
    n_classes: int,
    seed: int = 0,
    noise: float = 0.4,
    proto_seed: int = 1234,
) -> tuple[np.ndarray, np.ndarray]:
    """IoT network-traffic-like sequences: (T, F) feature windows.

    CoLearn's actual task is network-anomaly detection on IoT traffic
    (SURVEY.md §0); with no corpora on disk this generator produces
    class-conditional TEMPORAL structure a temporal conv net can exploit:
    each class is a smooth per-feature random walk (think rolling
    byte/packet-rate statistics) plus class-specific periodic bursts
    (think beaconing/scan periodicity) — signals that distinguish attack
    families in real flow data.
    """
    t_len, n_feat = shape
    rng = np.random.default_rng(seed)
    proto_rng = np.random.default_rng(proto_seed)
    # Smooth per-class baselines: cumulative sums, normalized.
    base = np.cumsum(
        proto_rng.normal(0.0, 1.0, size=(n_classes, t_len, n_feat)), axis=1
    )
    base /= np.abs(base).max(axis=(1, 2), keepdims=True) + 1e-6
    # Class-periodic bursts on a per-class subset of features.
    t = np.arange(t_len)[None, :, None]
    periods = proto_rng.integers(3, max(4, t_len // 4),
                                 size=(n_classes, 1, 1))
    phase = proto_rng.uniform(0, 2 * np.pi, size=(n_classes, 1, n_feat))
    gates = (proto_rng.uniform(size=(n_classes, 1, n_feat)) < 0.5)
    bursts = np.sin(2 * np.pi * t / periods + phase) * gates
    protos = (base + 0.7 * bursts).astype(np.float32)

    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    x = protos[y] + rng.normal(0.0, noise, size=(n, t_len, n_feat))
    return x.astype(np.float32), y
