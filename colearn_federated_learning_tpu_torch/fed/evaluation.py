"""Held-out evaluation over padded test batches with a validity mask
(the counterpart of the JAX package's ``fed/evaluation.py``)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.nn import functional as F


def pad_batches(x_test, y_test, batch: int, device):
    """(xb, yb, mb) tensors on ``device``: the test set padded with zero
    rows to whole ``batch``-sized chunks, and the validity mask."""
    x_test = np.asarray(x_test)
    y_test = np.asarray(y_test)
    n = len(x_test)
    n_batches = int(np.ceil(n / batch))
    pad = n_batches * batch - n
    x_pad = np.concatenate(
        [x_test, np.zeros((pad,) + x_test.shape[1:], x_test.dtype)])
    y_pad = np.concatenate([y_test, np.zeros((pad,), y_test.dtype)])
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    xb = torch.from_numpy(x_pad.reshape((n_batches, batch) + x_test.shape[1:]))
    yb = torch.from_numpy(y_pad.reshape((n_batches, batch)).astype(np.int64))
    mb = torch.from_numpy(mask.reshape((n_batches, batch)))
    return xb.to(device), yb.to(device), mb.to(device)


def make_eval_fn(model: torch.nn.Module, x_test, y_test, batch: int,
                 device) -> Callable:
    """``eval_fn(params) -> (mean_loss, accuracy)`` over the test set;
    ``params`` (a list in ``model.parameters()`` order) are loaded into
    ``model`` first.  One host sync at the end."""
    xb, yb, mb = pad_batches(x_test, y_test, batch, device)
    model_params = list(model.parameters())

    @torch.no_grad()
    def eval_fn(params) -> tuple[float, float]:
        torch._foreach_copy_(model_params, list(params))
        loss_sum = torch.zeros((), dtype=torch.float64, device=device)
        acc_sum = torch.zeros((), dtype=torch.float64, device=device)
        for x, y, m in zip(xb, yb, mb):
            logits = model(x)
            nll = -F.log_softmax(logits.float(), dim=-1).gather(
                1, y[:, None])[:, 0]
            correct = (logits.argmax(dim=-1) == y).float()
            loss_sum += (nll * m).sum()
            acc_sum += (correct * m).sum()
        n = float(mb.sum())
        return float(loss_sum) / n, float(acc_sum) / n

    return eval_fn


def sanitize_report(rep: dict) -> dict:
    """JSON-ready copy of a metrics report (numpy arrays -> lists)."""
    return {k: (v.tolist() if hasattr(v, "tolist") else v)
            for k, v in rep.items()}


def summarize_per_client(losses, accs, counts) -> dict:
    """Example-weighted aggregates and the accuracy spread of per-client
    scores (a copy of the JAX package's definition)."""
    losses = np.asarray(losses, np.float64)
    accs = np.asarray(accs, np.float64)
    counts = np.asarray(counts, np.float64)
    w = counts / counts.sum()
    return {
        "weighted_loss": float((losses * w).sum()),
        "weighted_acc": float((accs * w).sum()),
        "acc_p10": float(np.percentile(accs, 10)),
        "acc_p50": float(np.percentile(accs, 50)),
        "acc_p90": float(np.percentile(accs, 90)),
    }
