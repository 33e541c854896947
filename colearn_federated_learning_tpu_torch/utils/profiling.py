"""Profiling a window of rounds with ``torch.profiler``.

The counterpart of the JAX package's ``utils/profiling.py``:
``RoundProfiler`` traces a bounded window of federated rounds — by
default rounds 1..2, skipping round 0 so first-call set-up does not drown
the steady state — into ``RunConfig.profile_dir`` (``--profile-dir``).
It records the host's activity and, when the learner runs on the card,
the card's (CUDA activity: every kernel with its name and device time).

Departure: JAX writes an xplane under the directory for TensorBoard's
profile plugin; this writes one Chrome-trace JSON per window,
``<name>_profile_rounds<first>-<last>_<pid>_<ns>.json`` (open it in
Perfetto or ``chrome://tracing``), where ``last`` is the last round the
window held and ``ns`` the clock when it closed.
"""

from __future__ import annotations

import os
import time
from typing import Optional


class RoundProfiler:
    """Start and stop a ``torch.profiler`` window around a span of
    rounds."""

    def __init__(self, profile_dir: Optional[str], first_round: int = 1,
                 num_rounds: int = 2, device=None, name: str = "default"):
        self.profile_dir = profile_dir
        self.first = first_round
        self.last = first_round + num_rounds - 1
        self.cuda = str(device).startswith("cuda")
        self.name = name
        self.rounds: list[int] = []     # the rounds the open window held
        self._prof = None

    @property
    def active(self) -> bool:
        """Whether a window is open — the engine puts its round barrier up
        only while this is on."""
        return self._prof is not None

    def before_round(self, round_idx: int) -> None:
        if self.profile_dir and self._prof is None \
                and round_idx == self.first:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.rounds = []
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
        if self._prof is not None:
            self.rounds.append(round_idx)

    def after_round(self, round_idx: int) -> None:
        if self._prof is not None and round_idx >= self.last:
            self._stop()

    def close(self) -> None:
        if self._prof is not None:
            self._stop()

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(
            self.profile_dir,
            f"{self.name}_profile_rounds{self.rounds[0]}-{self.rounds[-1]}_"
            f"{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
