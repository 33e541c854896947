"""Dataset registry for the benchmark corpora.

Resolution order per dataset name:
1. A real on-disk copy: ``$COLEARN_DATA_DIR/<name>.npz`` with arrays
   ``x_train, y_train, x_test, y_test`` (the standard keras-style layout).
2. Deterministic synthetic data with identical shapes (data/synthetic.py).

A copy of the JAX package's ``data/registry.py``: the same name and seed
give the same numpy arrays in both packages.
"""

from __future__ import annotations

import dataclasses
import os
import zlib

import numpy as np

from colearn_federated_learning_tpu_torch.data import synthetic


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    kind: str                      # "image" | "text" | "timeseries"
    input_shape: tuple[int, ...]   # per-example shape: image HWC,
                                   # text (seq_len,), timeseries (T, F)
    num_classes: int
    n_train: int                   # synthetic fallback sizes
    n_test: int
    vocab_size: int = 0            # text only


SPECS: dict[str, DatasetSpec] = {
    "mnist": DatasetSpec("mnist", "image", (28, 28, 1), 10, 60_000, 10_000),
    "cifar10": DatasetSpec("cifar10", "image", (32, 32, 3), 10, 50_000, 10_000),
    "cifar100": DatasetSpec("cifar100", "image", (32, 32, 3), 100, 50_000, 10_000),
    "femnist": DatasetSpec("femnist", "image", (28, 28, 1), 62, 80_000, 10_000),
    "agnews": DatasetSpec("agnews", "text", (128,), 4, 120_000, 7_600),
    # Tiny variants for tests / smoke runs (same shapes, far fewer rows).
    "mnist_tiny": DatasetSpec("mnist_tiny", "image", (28, 28, 1), 10, 2_000, 400),
    "cifar10_tiny": DatasetSpec("cifar10_tiny", "image", (32, 32, 3), 10, 2_000, 400),
    "agnews_tiny": DatasetSpec("agnews_tiny", "text", (64,), 4, 1_000, 200, vocab_size=2_000),
    "iot_traffic": DatasetSpec("iot_traffic", "timeseries", (64, 16), 8,
                               40_000, 8_000),
    "iot_traffic_tiny": DatasetSpec("iot_traffic_tiny", "timeseries",
                                    (64, 16), 8, 2_000, 400),
}


@dataclasses.dataclass
class Dataset:
    spec: DatasetSpec
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    source: str  # "disk" | "synthetic"


def _load_disk(spec: DatasetSpec) -> Dataset | None:
    """Load ``$COLEARN_DATA_DIR/<name>.npz``.  A present-but-malformed file
    raises — a user who staged real data must never silently train on
    synthetic."""
    root = os.environ.get("COLEARN_DATA_DIR", "")
    if not root:
        return None
    path = os.path.join(root, f"{spec.name}.npz")
    if not os.path.exists(path):
        return None
    arrays = {}
    with np.load(path) as z:
        missing = [k for k in ("x_train", "y_train", "x_test", "y_test")
                   if k not in z]
        if missing:
            raise ValueError(f"{path} is missing arrays {missing} "
                             "(expected the keras-style x/y train/test "
                             "layout)")
        for split in ("train", "test"):
            x, y = z[f"x_{split}"], z[f"y_{split}"]
            want = spec.input_shape
            # Accept trailing-singleton-channel omission for grayscale
            # images ((N, 28, 28) on disk vs spec (28, 28, 1)).
            if (spec.kind == "image" and x.ndim == len(want)
                    and want[-1] == 1 and x.shape[1:] == want[:-1]):
                x = x[..., None]
            if x.shape[1:] != want:
                raise ValueError(
                    f"{path}: x_{split} per-example shape {x.shape[1:]} "
                    f"does not match the {spec.name} spec {want}")
            if len(x) != len(y):
                raise ValueError(
                    f"{path}: x_{split}/y_{split} row counts differ "
                    f"({len(x)} vs {len(y)})")
            if spec.kind == "image" and x.dtype == np.uint8:
                x = x.astype(np.float32) / 255.0   # keras raw-byte layout
            y = y.reshape(-1)
            # Range-check BEFORE the int32 cast: a corrupt wide integer
            # must not wrap into the valid range and pass.
            if y.size and (int(y.min()) < 0
                           or int(y.max()) >= spec.num_classes):
                raise ValueError(
                    f"{path}: y_{split} labels outside "
                    f"[0, {spec.num_classes})")
            arrays[f"x_{split}"], arrays[f"y_{split}"] = x, y.astype(np.int32)
    return Dataset(spec, arrays["x_train"], arrays["y_train"],
                   arrays["x_test"], arrays["y_test"], "disk")


def _make_synthetic(spec: DatasetSpec, seed: int) -> Dataset:
    # proto_seed shared across splits: one class structure, disjoint draws.
    proto_seed = 7919 * seed + zlib.crc32(spec.name.encode()) % 10_000
    if spec.kind == "timeseries":
        x_tr, y_tr = synthetic.synthetic_traffic_classification(
            spec.n_train, spec.input_shape, spec.num_classes, seed=seed,
            proto_seed=proto_seed,
        )
        x_te, y_te = synthetic.synthetic_traffic_classification(
            spec.n_test, spec.input_shape, spec.num_classes, seed=seed + 1,
            proto_seed=proto_seed,
        )
        return Dataset(spec, x_tr, y_tr, x_te, y_te, "synthetic")
    if spec.kind == "image":
        x_tr, y_tr = synthetic.synthetic_image_classification(
            spec.n_train, spec.input_shape, spec.num_classes, seed=seed,
            proto_seed=proto_seed,
        )
        x_te, y_te = synthetic.synthetic_image_classification(
            spec.n_test, spec.input_shape, spec.num_classes, seed=seed + 1,
            proto_seed=proto_seed,
        )
    else:
        vocab = spec.vocab_size or 30_522
        x_tr, y_tr = synthetic.synthetic_text_classification(
            spec.n_train, spec.input_shape[0], vocab, spec.num_classes, seed=seed
        )
        x_te, y_te = synthetic.synthetic_text_classification(
            spec.n_test, spec.input_shape[0], vocab, spec.num_classes, seed=seed + 1
        )
    return Dataset(spec, x_tr, y_tr, x_te, y_te, "synthetic")


def get_dataset(name: str, seed: int = 0, max_train: int = 0, max_test: int = 0) -> Dataset:
    if name not in SPECS:
        raise KeyError(f"unknown dataset {name!r}; available: {sorted(SPECS)}")
    spec = SPECS[name]
    ds = _load_disk(spec) or _make_synthetic(spec, seed)
    if max_train and len(ds.x_train) > max_train:
        ds = dataclasses.replace(ds, x_train=ds.x_train[:max_train], y_train=ds.y_train[:max_train])
    if max_test and len(ds.x_test) > max_test:
        ds = dataclasses.replace(ds, x_test=ds.x_test[:max_test], y_test=ds.y_test[:max_test])
    return ds
