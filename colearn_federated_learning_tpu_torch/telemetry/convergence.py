"""Convergence observatory: learning-health signals from the aggregate.

The counterpart of the JAX package's ``telemetry/convergence.py``.  Every
other observability plane (spans, metrics, flight recorder, health
ledger) watches the *machinery*; this one watches the *model*.  Per
round it derives, from the already-materialized mean update, with no
extra communication:

- global update norm and the effective server step it induces
  (``server_lr * ||delta||``);
- cosine similarity to the previous round's update (progress points the
  same way round over round; oscillation flips sign);
- an EWMA'd update-norm trend classified into ``warmup`` / ``progress``
  / ``plateau`` / ``oscillation`` / ``divergence``.

Everything above needs ONLY the aggregate, the one thing secure
aggregation lets a server open.  Per-device and per-cohort skew
attribution (:func:`device_skew`, :func:`cohort_skew`) is for planes where
individual updates are legitimately visible: secure_agg off, or fleetsim.

The tree math walks nested dicts in ``jax.tree``'s sorted-key order and
accumulates in f32, leaf by leaf, as JAX's does.  A leaf is a torch
tensor (on any device), a numpy array, or a
``parallel.partition.ShardedTensor`` of a placed server, whose shards are
each read once and never gathered.  LoRA factor trees
(``{path: {"lora_a": A, "lora_b": B}}``) are nested dicts like any other.

Departure: the observatory keeps a copy of the previous update for the
cosine (JAX keeps a reference to an immutable array; the port's folders
reuse their buffers), on the update's own device: the card for a device
fold.  It holds one model's worth of f32 and only under
``run.learn_observe``.

Feature-gated everywhere: ``--learn-observe`` stamps ``conv_*`` record
keys and ``learn.*`` metrics; default round records stay byte-identical.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable, Optional

import numpy as np

TREND_WARMUP = "warmup"
TREND_PROGRESS = "progress"
TREND_PLATEAU = "plateau"
TREND_OSCILLATION = "oscillation"
TREND_DIVERGENCE = "divergence"
TRENDS = (TREND_WARMUP, TREND_PROGRESS, TREND_PLATEAU,
          TREND_OSCILLATION, TREND_DIVERGENCE)


# ------------------------------------------------------------- tree math --
def _leaves(tree) -> list:
    """Leaves in sorted-key order (a list or tuple in its own order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in _leaves(sub)]
    return [tree]


def _parts(leaf) -> list:
    """A leaf's f32 tensors: a sharded leaf's distinct shards, else the
    leaf itself."""
    import torch

    from colearn_federated_learning_tpu_torch.parallel.partition import (
        ShardedTensor)

    if isinstance(leaf, ShardedTensor):
        return [p.float() for p in leaf.parts]
    if isinstance(leaf, torch.Tensor):
        return [leaf.float()]
    return [torch.from_numpy(np.asarray(leaf, np.float32))]


def _tree_dot(a, b):
    """The f32 inner product of two trees, leaf by leaf (a sharded leaf's
    shards pair up shard by shard), as a CPU scalar tensor.  torch is
    imported here, not with the module: the telemetry package loads in
    processes that never touch a tensor (the broker)."""
    import torch

    total = torch.zeros((), dtype=torch.float32)
    for leaf_a, leaf_b in zip(_leaves(a), _leaves(b)):
        for x, y in zip(_parts(leaf_a), _parts(leaf_b)):
            total = total + torch.dot(x.reshape(-1),
                                      y.to(x.device).reshape(-1)).cpu()
    return total


def tree_norm(tree) -> float:
    """Global L2 norm over every leaf (dense trees and LoRA factor trees
    alike).  Host float — call once per round, never per step."""
    if not _leaves(tree):
        return 0.0
    return float(_tree_dot(tree, tree).sqrt())


def tree_cosine(a, b) -> Optional[float]:
    """Cosine similarity between two trees with identical structure;
    ``None`` (undefined, NOT NaN) when either side has zero norm."""
    dot = float(_tree_dot(a, b)) if _leaves(a) else 0.0
    na, nb = tree_norm(a), tree_norm(b)
    if na <= 0.0 or nb <= 0.0:
        return None
    return max(-1.0, min(1.0, dot / (na * nb)))


def _copy_leaf(leaf):
    import torch

    from colearn_federated_learning_tpu_torch.parallel.partition import (
        ShardedTensor)

    if isinstance(leaf, ShardedTensor):
        return leaf.map_parts(lambda p, _: p.detach().clone())
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone()
    return np.array(leaf, copy=True)


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_tree(v) for v in tree)
    return _copy_leaf(tree)


# ---------------------------------------------------------- observatory --
@dataclasses.dataclass
class ConvergenceObservatory:
    """Stateful per-plane learning-health tracker.

    ``observe(mean_delta, lr=...)`` returns the round's ``conv_*``
    signal dict (record-ready scalars/strings) or ``None`` for a no-op
    round (quorum skip / unmask failure): state is untouched, so the
    trend picks up where it left off.
    """

    ewma_alpha: float = 0.3          # update-norm EWMA smoothing
    divergence_ratio: float = 2.0    # norm > ratio * ewma -> divergence
    plateau_band: float = 0.1        # |norm/ewma - 1| <= band -> plateau
    oscillation_cos: float = -0.2    # cos(prev) below this -> oscillation
    warmup_rounds: int = 2           # observations before classifying
    keep_prev: bool = True           # retain prev update for cosine

    _prev_update: Any = dataclasses.field(default=None, repr=False)
    _ewma: Optional[float] = None
    _seen: int = 0

    def observe(self, mean_delta, *, lr: float = 1.0) -> Optional[dict]:
        if mean_delta is None:
            return None
        norm = tree_norm(mean_delta)
        if not math.isfinite(norm):
            # A non-finite aggregate is the strongest divergence signal
            # there is; classify it directly rather than poisoning the
            # EWMA with inf/NaN.
            self._seen += 1
            self._prev_update = None
            return {"conv_update_norm": norm,
                    "conv_step_size": norm * float(lr),
                    "conv_norm_ewma": float(self._ewma or 0.0),
                    "conv_trend": TREND_DIVERGENCE}
        cos = (tree_cosine(mean_delta, self._prev_update)
               if self._prev_update is not None else None)
        trend = self._classify(norm, cos)
        prev_ewma = self._ewma
        self._ewma = (norm if prev_ewma is None
                      else self.ewma_alpha * norm
                      + (1.0 - self.ewma_alpha) * prev_ewma)
        self._seen += 1
        if self.keep_prev:
            self._prev_update = _copy_tree(mean_delta)
        sig = {
            "conv_update_norm": round(norm, 8),
            "conv_step_size": round(norm * float(lr), 8),
            "conv_norm_ewma": round(self._ewma, 8),
            "conv_trend": trend,
        }
        if cos is not None:
            # Key only present once a previous update exists AND both
            # norms are nonzero — first round stays cosine-free by
            # construction (undefined, not NaN).
            sig["conv_cos_prev"] = round(cos, 6)
        return sig

    def _classify(self, norm: float, cos: Optional[float]) -> str:
        if self._seen < self.warmup_rounds or self._ewma is None:
            return TREND_WARMUP
        if norm > self.divergence_ratio * max(self._ewma, 1e-30):
            return TREND_DIVERGENCE
        if cos is not None and cos < self.oscillation_cos:
            return TREND_OSCILLATION
        if abs(norm / max(self._ewma, 1e-30) - 1.0) <= self.plateau_band:
            return TREND_PLATEAU
        return TREND_PROGRESS

    # -- metric export (learn.* — declared in analysis/metric_catalog.py)
    def export_metrics(self, reg, sig: dict) -> None:
        reg.gauge("learn.update_norm").set(sig["conv_update_norm"])
        reg.gauge("learn.update_norm_ewma").set(sig["conv_norm_ewma"])
        reg.gauge("learn.step_size").set(sig["conv_step_size"])
        if "conv_cos_prev" in sig:
            reg.gauge("learn.cos_prev").set(sig["conv_cos_prev"])
        reg.histogram("learn.update_norm_dist").observe(
            sig["conv_update_norm"])
        reg.counter(
            f"learn.trend_total{{trend={sig['conv_trend']}}}").inc()
        if "conv_cohort_skew" in sig:
            reg.gauge("learn.cohort_skew").set(sig["conv_cohort_skew"])


# ------------------------------------------------- per-device attribution --
def device_skew(norms: Iterable[float], *,
                anomaly_ratio: float = 3.0) -> dict:
    """Summarize per-device update norms: median, p90, and the indices of
    anomalously-large updates (norm > ``anomaly_ratio`` x median — a
    poisoned or diverging device is a health event, same as a straggler).

    Only meaningful where individual updates are visible (secure_agg off,
    or fleetsim).  Returns ``{"median": ..., "p90": ..., "anomalies":
    [idx, ...]}``; empty input -> zeros and no anomalies.
    """
    xs = sorted(float(n) for n in norms)
    if not xs:
        return {"median": 0.0, "p90": 0.0, "anomalies": []}
    def q(p):
        i = min(len(xs) - 1, max(0, int(round(p * (len(xs) - 1)))))
        return xs[i]
    med = q(0.5)
    thresh = anomaly_ratio * max(med, 1e-30)
    anomalies = [i for i, n in enumerate(float(n) for n in norms)
                 if n > thresh]
    return {"median": med, "p90": q(0.9), "anomalies": anomalies}


def cohort_skew(class_sums, class_weights, aggregate) -> dict:
    """Attribute drift to cohorts: cosine of each cohort's weighted-mean
    update (centroid) to the global aggregate.

    ``class_sums`` is a tree whose leaves carry a leading cohort axis
    (per-cohort weighted delta sums); ``class_weights`` the matching
    ``(num_cohorts,)`` weight vector.  Skew is ``1 - min_cos`` over
    populated cohorts — 0 when every cohort pushes the same way (IID),
    approaching/exceeding 1 as a seeded non-IID cluster pulls against
    the aggregate.  Returns record-ready ``conv_cohort_*`` floats.
    """
    w = np.asarray(class_weights, dtype=np.float64)
    coses = []
    for c in range(w.shape[0]):
        if w[c] <= 0.0:
            continue
        centroid = [_parts(x)[0][c] / float(w[c])
                    for x in _leaves(class_sums)]
        cos = tree_cosine(centroid, _leaves(aggregate))
        if cos is not None:
            coses.append(cos)
    if not coses:
        return {"conv_cohort_skew": 0.0, "conv_cohort_cos_min": 1.0}
    return {"conv_cohort_skew": round(1.0 - min(coses), 6),
            "conv_cohort_cos_min": round(min(coses), 6)}


# ------------------------------------------------------------- reporting --
def convergence_records(records: Iterable[dict]) -> list:
    """The sub-sequence of round records carrying learning signals,
    ordered by round when a round key is present."""
    out = [r for r in records if "conv_update_norm" in r]
    key = "round" if all("round" in r for r in out) else None
    if key:
        out.sort(key=lambda r: r[key])
    return out


def render_convergence_report(records: Iterable[dict]) -> str:
    """Round-over-round learning report for ``colearn converge`` from any
    committed JSONL (results dirs, event streams): per-round norm / step
    / EWMA / cosine / trend, then a trend census and the first round each
    non-progress trend appeared."""
    recs = convergence_records(records)
    if not recs:
        return ("no learning signals found "
                "(run with --learn-observe to stamp conv_* keys)")
    lines = ["round  update_norm     step_size       ewma        "
             "cos_prev  trend"]
    for r in recs:
        cos = r.get("conv_cos_prev")
        lines.append(
            "%5s  %-14.6g  %-14.6g  %-10.5g  %-8s  %s" % (
                r.get("round", "-"),
                r["conv_update_norm"],
                r.get("conv_step_size", float("nan")),
                r.get("conv_norm_ewma", float("nan")),
                ("%.4f" % cos) if cos is not None else "-",
                r.get("conv_trend", "-")))
    census: dict = {}
    first: dict = {}
    for r in recs:
        t = r.get("conv_trend", "-")
        census[t] = census.get(t, 0) + 1
        first.setdefault(t, r.get("round", "-"))
    lines.append("")
    lines.append("trends: " + "  ".join(
        f"{t}={census[t]}" for t in TRENDS if t in census))
    for t in (TREND_DIVERGENCE, TREND_OSCILLATION, TREND_PLATEAU):
        if t in first:
            lines.append(f"first {t}: round {first[t]}")
    norms = [r["conv_update_norm"] for r in recs]
    lines.append("update_norm: first=%.6g last=%.6g max=%.6g" % (
        norms[0], norms[-1], max(norms)))
    if any("conv_cohort_skew" in r for r in recs):
        skews = [r["conv_cohort_skew"] for r in recs
                 if "conv_cohort_skew" in r]
        lines.append("cohort_skew: mean=%.4f max=%.4f" % (
            sum(skews) / len(skews), max(skews)))
    return "\n".join(lines)
