"""Rényi-DP accounting for DP-FedAvg (SURVEY.md §5: the reference ships
clip+noise hooks with no privacy-budget statement; the rebuild states the
budget).

Model: each round is one application of the SUBSAMPLED GAUSSIAN mechanism —
a cohort of ``q·N`` clients is sampled, each update is clipped to ``C`` and
the aggregate carries central Gaussian noise ``σ·C`` (privacy/dp.py scales
per-client noise by ``1/sqrt(cohort)`` so the sum has exactly that std).

Accounting is the standard RDP recipe (Abadi et al. 2016 moments
accountant, in the RDP formulation of Mironov 2017 / Mironov-Talwar-Zhang
2019, PAPERS.md — formulas only):

- per-round RDP at integer order α for sampling rate q, noise σ:
    ε_α = 1/(α-1) · log Σ_{k=0..α} C(α,k)(1-q)^{α-k} q^k · e^{(k²-k)/2σ²}
  (at q=1 this collapses to the exact Gaussian value α/2σ²),
- RDP composes additively over rounds: T rounds cost T·ε_α,
- conversion to (ε, δ)-DP:  ε = min_α [ T·ε_α + log(1/δ)/(α-1) ].

Pure numpy in log space; nothing here touches the training path.  A copy
of the JAX package's module of the same name, held to it by
``tests/test_torch_port_guards.py``.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import numpy as np

DEFAULT_ORDERS: tuple[int, ...] = tuple(range(2, 65)) + (128, 256, 512)


def _log_binom(n: int, k: int) -> float:
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def subsampled_gaussian_rdp(q: float, noise_multiplier: float,
                            order: int) -> float:
    """Per-step RDP ε_α of the sampled Gaussian mechanism at INTEGER order.

    Exact for q=1 (plain Gaussian: α/(2σ²)); for q<1 the
    Mironov-Talwar-Zhang binomial-series bound.
    """
    if order < 2 or int(order) != order:
        raise ValueError(f"integer order >= 2 required, got {order}")
    if noise_multiplier <= 0.0:
        return math.inf
    if q <= 0.0:
        return 0.0
    if q > 1.0:
        raise ValueError(f"sampling rate must be <= 1, got {q}")
    sigma2 = noise_multiplier ** 2
    if q == 1.0:
        return order / (2.0 * sigma2)
    a = int(order)
    log_terms = [
        _log_binom(a, k)
        + (a - k) * math.log1p(-q)
        + (k * math.log(q) if k else 0.0)
        + (k * k - k) / (2.0 * sigma2)
        for k in range(a + 1)
    ]
    m = max(log_terms)
    log_sum = m + math.log(sum(math.exp(t - m) for t in log_terms))
    return log_sum / (a - 1)


def rdp_to_eps_delta(total_rdp: np.ndarray, orders: np.ndarray,
                     delta: float) -> float:
    """(ε, δ) from accumulated RDP: ε = min_α [ε_α·T + log(1/δ)/(α-1)]."""
    if delta <= 0.0 or delta >= 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    eps = total_rdp + math.log(1.0 / delta) / (orders - 1.0)
    return float(np.min(eps))


class RdpAccountant:
    """Tracks cumulative (ε, δ) over federated rounds.

    One instance per experiment; call :meth:`step` after each round and read
    :meth:`epsilon`.  The per-round RDP curve is precomputed (every round
    applies the identical mechanism), so per-round cost is one vector min.
    """

    def __init__(self, noise_multiplier: float, sampling_rate: float,
                 delta: float = 1e-5,
                 orders: Optional[Iterable[int]] = None):
        self.noise_multiplier = float(noise_multiplier)
        self.sampling_rate = float(sampling_rate)
        self.delta = float(delta)
        self.orders = np.asarray(sorted(set(orders or DEFAULT_ORDERS)),
                                 dtype=np.float64)
        self._per_round = self._curve(self.sampling_rate)
        self._steps = 0
        self.total_rdp = np.zeros_like(self._per_round)

    @classmethod
    def from_config(cls, fed_config,
                    sampling_rate: float) -> Optional["RdpAccountant"]:
        """The accountant a FedConfig implies, or None when DP is off —
        the ONE place the enable condition lives (engine + coordinator)."""
        if fed_config.dp_clip > 0.0 and fed_config.dp_noise_multiplier > 0.0:
            return cls(noise_multiplier=fed_config.dp_noise_multiplier,
                       sampling_rate=sampling_rate,
                       delta=fed_config.dp_delta)
        return None

    def _curve(self, q: float,
               noise_multiplier: Optional[float] = None) -> np.ndarray:
        z = self.noise_multiplier if noise_multiplier is None else noise_multiplier
        return np.asarray([
            subsampled_gaussian_rdp(q, z, int(a)) for a in self.orders
        ])

    @property
    def steps(self) -> int:
        return self._steps

    @steps.setter
    def steps(self, value: int) -> None:
        """Reset to ``value`` rounds of the CONSTANT configured mechanism
        (checkpoint resume in the on-device engine, whose q never varies)."""
        self._steps = int(value)
        self.total_rdp = self._per_round * self._steps

    def step(self, n: int = 1, sampling_rate: Optional[float] = None,
             noise_multiplier: Optional[float] = None) -> None:
        """Record ``n`` more rounds.  ``sampling_rate`` /
        ``noise_multiplier`` override the configured mechanism for these
        rounds — the socket coordinator's cohort fraction moves as workers
        join/leave, and dropouts shrink the REALIZED central noise below
        nominal; RDP composes additively across heterogeneous rounds."""
        if sampling_rate is None and noise_multiplier is None:
            rdp = self._per_round
        else:
            q = (self.sampling_rate if sampling_rate is None
                 else min(1.0, float(sampling_rate)))
            rdp = self._curve(q, noise_multiplier)
        self.total_rdp = self.total_rdp + n * rdp
        self._steps += n

    def epsilon(self, delta: Optional[float] = None) -> float:
        """Cumulative ε at ``delta`` after the recorded steps."""
        if self._steps == 0:
            return 0.0
        if not np.isfinite(self.total_rdp).any():
            return math.inf
        return rdp_to_eps_delta(self.total_rdp, self.orders,
                                delta if delta is not None else self.delta)
