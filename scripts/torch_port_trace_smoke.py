"""Trace-pipeline smoke of the port: 2 rounds with ``--trace-dir``
semantics (the counterpart of the JAX package's ``scripts/trace_smoke.py``,
with its phases and its coverage check).

Runs a small ``FederatedLearner`` (config #1's MLP on ``mnist_tiny``, 4
clients) with span tracing on, then asserts that the written Chrome-trace
JSON parses, holds the per-round phase spans of ``REQUIRED_PHASES``, and
that the phase spans cover at least 95 % of the round wall time.  Exits
non-zero on any violation.  On the card unless the caller asks for the CPU:

    python scripts/torch_port_trace_smoke.py [TRACE_DIR] [--device cpu]

Importable: ``main(trace_dir, device=None)`` returns the result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REQUIRED_PHASES = {"round", "client_update", "sync_metrics", "evaluate"}
MIN_COVERAGE = 0.95


def main(trace_dir: str | None = None, device=None) -> dict:
    from colearn_federated_learning_tpu_torch import telemetry
    from colearn_federated_learning_tpu_torch.fed.engine import FederatedLearner
    from colearn_federated_learning_tpu_torch.utils.config import get_config

    trace_dir = trace_dir or tempfile.mkdtemp(prefix="colearn_trace_smoke_")
    cfg = get_config("mnist_mlp_fedavg")
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, dataset="mnist_tiny",
                                 num_clients=4),
        fed=dataclasses.replace(cfg.fed, rounds=2, local_steps=2,
                                batch_size=8, cohort_size=4),
        run=dataclasses.replace(cfg.run, eval_every=1, name="trace_smoke",
                                trace_dir=trace_dir),
    )
    learner = FederatedLearner.from_config(cfg, device=device)
    learner.fit()

    path = learner.last_trace_path
    assert path, "fit() with trace_dir set did not write a trace"
    doc = telemetry.load_trace(path)           # raises if it doesn't parse
    spans = telemetry.trace_spans(doc)
    names = {s.name for s in spans}
    missing = REQUIRED_PHASES - names
    assert not missing, f"trace is missing phase spans: {sorted(missing)}"

    rounds = [s for s in spans if s.name == "round"]
    assert len(rounds) == 2, f"expected 2 round spans, got {len(rounds)}"
    round_total = sum(s.duration_s for s in rounds)
    child_total = sum(
        s.duration_s for s in spans
        if s.parent_id in {r.span_id for r in rounds}
    )
    coverage = child_total / round_total if round_total else 0.0
    assert coverage >= MIN_COVERAGE, (
        f"phase spans cover only {coverage:.1%} of round time"
    )
    assert doc["otherData"]["metrics"]["engine.rounds_total"] >= 2

    return {
        "trace_file": path,
        "spans": len(spans),
        "phases": sorted(names),
        "coverage": coverage,
        "device": str(learner.device),
        "summary": telemetry.summarize_trace(doc),
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace_dir", nargs="?", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = ap.parse_args()
    result = main(a.trace_dir, None if a.device == "cuda" else "cpu")
    print(result["summary"])
    print(json.dumps({k: v for k, v in result.items() if k != "summary"}))
