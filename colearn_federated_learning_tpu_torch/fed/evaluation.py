"""Held-out evaluation over padded test batches with a validity mask
(the counterpart of the JAX package's ``fed/evaluation.py``): the loss
and accuracy, the confusion matrix, and the detection report built from
it (a copy of JAX's, numpy only)."""

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


def make_confusion_eval_fn(model: torch.nn.Module, x_test, y_test,
                           batch: int, num_classes: int,
                           device) -> Callable:
    """``fn(params) -> (C, C)`` numpy f32 confusion matrix (rows = true
    class, cols = prediction) over the test set: the padded batches of
    :func:`make_eval_fn`, one masked f32 scatter-add per batch, as JAX's
    scan accumulates it.  One host sync at the end."""
    xb, yb, mb = pad_batches(x_test, y_test, batch, device)
    model_params = list(model.parameters())
    C = num_classes

    @torch.no_grad()
    def conf_fn(params) -> np.ndarray:
        torch._foreach_copy_(model_params, list(params))
        conf = torch.zeros(C * C, dtype=torch.float32, device=device)
        for x, y, m in zip(xb, yb, mb):
            pred = model(x).argmax(dim=-1)
            conf.index_add_(0, y * C + pred, m)
        return conf.reshape(C, C).cpu().numpy()

    return conf_fn


def detection_report(conf: np.ndarray, benign_class: int = 0) -> dict:
    """Detection-oriented metrics from a confusion matrix — the quantities
    the reference's IoT network-anomaly deployment actually cares about
    (SURVEY.md §0: MUD-compliant edge anomaly detection), where plain
    accuracy hides a useless always-benign classifier:

    - per-class precision/recall/F1 + macro-F1;
    - binary ALARM view (any non-benign prediction is an alarm):
      ``detection_rate`` = P(alarm | attack), ``false_alarm_rate`` =
      P(alarm | benign).
    """
    conf = np.asarray(conf, np.float64)
    C = conf.shape[0]
    tp = np.diag(conf)
    support = conf.sum(axis=1)
    predicted = conf.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(predicted > 0, tp / predicted, 0.0)
        recall = np.where(support > 0, tp / support, 0.0)
        f1 = np.where(precision + recall > 0,
                      2 * precision * recall / (precision + recall), 0.0)
    attack = np.arange(C) != benign_class
    attack_total = conf[attack].sum()
    benign_total = conf[benign_class].sum()
    alarms_on_attack = conf[attack][:, attack].sum()
    alarms_on_benign = conf[benign_class, attack].sum()
    return {
        "accuracy": float(tp.sum() / max(conf.sum(), 1.0)),
        "per_class_precision": precision,
        "per_class_recall": recall,
        "per_class_f1": f1,
        "macro_f1": float(f1[support > 0].mean()) if (support > 0).any()
        else 0.0,
        "detection_rate": float(alarms_on_attack / max(attack_total, 1.0)),
        "false_alarm_rate": float(alarms_on_benign / max(benign_total, 1.0)),
        "support": support,
    }


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
