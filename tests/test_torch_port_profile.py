"""``--profile-dir`` through ``torch.profiler`` and ``flops_per_round``.

- The profiler window (``utils/profiling.RoundProfiler``, held by
  ``telemetry.RoundTelemetry``) is JAX's: it opens before round 1 and
  closes after round 2, writing one Chrome trace; it closes when ``fit``
  raises inside it, and a later ``fit`` profiles again (JAX's
  ``tests/test_advice_fixes.py``).
- ``flops_per_round`` rides the trace window, cached across ``fit``
  calls, as JAX's.  The port counts one client's local step under
  ``FlopCounterMode`` (matmuls and convolutions) times the cohort and the
  steps; JAX's is XLA's cost analysis of the round, which also counts
  elementwise work (the optimizer, activations, the loss, the server's
  mean) and, on the MLP and the CNN, the first layer's input gradient,
  which the port's autograd never forms.  So JAX's count is held to the
  port's from above, within a stated factor per family (measured on
  the CPU: MLP 1.475, CNN 1.039, dense BERT 1.147): MLP <= 1.5, CNN <=
  1.1, dense-attention BERT <= 1.2.
- On flash-attention BERT, whose Pallas call XLA does not count, the
  port's count is held to the hand formula exactly: each Dense layer's
  product and its two backward products, the head's, and the flash
  kernels' 4 + 6 + 8 · B·H·L²·D per block (``ops.attention.count_flops``;
  the CPU's plain versions are counted by the same formula).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.fed import FederatedLearner as JaxLearner
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu_torch import cli
from colearn_federated_learning_tpu_torch.fed import FederatedLearner
from colearn_federated_learning_tpu_torch.ops import attention
from colearn_federated_learning_tpu_torch.utils import config
from colearn_federated_learning_tpu_torch.utils.profiling import RoundProfiler
from test_torch_port_round import FAMILIES

JAX_OVER_PORT = {"mlp": 1.5, "cnn": 1.1, "bert_dense": 1.2}


def _profiling() -> bool:
    return torch.autograd._profiler_enabled()


def _configs(family, fed_kw=None, run_kw=None, model_kw=None):
    data, model, fed = FAMILIES["bert" if family.startswith("bert")
                                else family]
    model = dict(model, **(model_kw or {}))
    if family == "bert_dense":
        model["attn_impl"] = "dense"
    if family == "mlp":
        model["hidden_dim"] = 200
    kw = dict(data=dict(data, num_clients=4), model=model,
              fed=dict(fed, **{**dict(rounds=4, cohort_size=2,
                                       local_steps=3, batch_size=8),
                               **(fed_kw or {})}),
              run=dict(seed=3, name=f"profile_{family}", **(run_kw or {})))
    return [mod.ExperimentConfig(
        data=mod.DataConfig(**kw["data"]), model=mod.ModelConfig(**kw["model"]),
        fed=mod.FedConfig(**kw["fed"]), run=mod.RunConfig(**kw["run"]))
        for mod in (jax_config, config)]


# ----------------------------------------------------------- the window --
def test_round_profiler_window_is_rounds_one_and_two(tmp_path):
    prof = RoundProfiler(str(tmp_path), name="unit")
    seen = []
    for r in range(4):
        prof.before_round(r)
        seen.append(prof.active)
        torch.ones(4) @ torch.ones(4)
        prof.after_round(r)
        seen.append(prof.active)
    prof.close()
    assert seen == [False, False, True, True, True, False, False, False]
    files = os.listdir(tmp_path)
    assert len(files) == 1 and "unit_profile_rounds1-2_" in files[0]
    with open(tmp_path / files[0]) as f:
        assert json.load(f)["traceEvents"]
    assert not _profiling()
    off = RoundProfiler(None)
    off.before_round(1)
    assert not off.active


def test_engine_profiles_rounds_one_and_two(tmp_path):
    _, tcfg = _configs("mlp", run_kw=dict(profile_dir=str(tmp_path)))
    ln = FederatedLearner(tcfg, device="cpu")
    states = []
    ln.fit(log_fn=lambda rec: states.append((rec["round"], _profiling())))
    assert states == [(0, False), (1, True), (2, False), (3, False)]
    files = os.listdir(tmp_path)
    assert len(files) == 1 and "_profile_rounds1-2_" in files[0]
    assert "flops_per_round" not in ln.history[0]      # tracing is off


def test_profiler_closed_when_fit_raises_and_profiles_again(tmp_path):
    _, tcfg = _configs("mlp", run_kw=dict(profile_dir=str(tmp_path)))
    ln = FederatedLearner(tcfg, device="cpu")

    def explode(rec):
        if rec["round"] == 1:          # inside the window: it is open
            raise RuntimeError("mid-window failure")

    with pytest.raises(RuntimeError, match="mid-window"):
        ln.fit(rounds=3, log_fn=explode)
    assert not _profiling()
    assert [f for f in os.listdir(tmp_path) if "rounds1-1_" in f]
    ln.fit(rounds=2)                   # rounds 2, 3: no window, no error
    again = FederatedLearner(tcfg, device="cpu")
    again.fit(rounds=3)                # a new window over its rounds 1, 2
    assert sum("rounds1-2_" in f for f in os.listdir(tmp_path)) == 1
    assert not _profiling()


# -------------------------------------------------------- flops_per_round --
@pytest.mark.parametrize("family", ["mlp", "cnn", "bert_dense"])
def test_flops_per_round_held_to_jax_s(family):
    jcfg, tcfg = _configs(family)
    theirs = JaxLearner(jcfg).round_cost_analysis()["flops_per_round"]
    ours = FederatedLearner(tcfg, device="cpu").round_cost_analysis()
    ratio = theirs / ours["flops_per_round"]
    assert 1.0 <= ratio <= JAX_OVER_PORT[family], ratio
    assert ours["flops_per_round"] == ours["flops_per_step"] * 2 * 3


def bert_step_flops(cfg, seq_len, attention_factor):
    m, B, L = cfg.model, cfg.fed.batch_size, seq_len
    d, H = m.width, m.num_heads
    block = (6 * B * L * (4 * d * d + 2 * d * 4 * d)
             + attention_factor * B * H * L * L * (d // H))
    return m.depth * block + 6 * B * d * m.num_classes


@pytest.mark.parametrize("family,factor", [("bert", 18), ("bert_dense", 12)])
def test_bert_flops_equal_the_formula(family, factor):
    """Flash: 4 + 6 + 8 per block from the kernels' formula; dense: the
    plain einsums' forward 4 and backward 8, counted by the counter."""
    _, tcfg = _configs(family)
    ln = FederatedLearner(tcfg, device="cpu")
    got = ln.round_cost_analysis()
    want = bert_step_flops(tcfg, int(ln.x.shape[-1]), factor)
    assert got["flops_per_step"] == want
    assert got["flops_per_round"] == want * ln.cohort_size * ln.num_steps


def test_attention_tally_counts_the_kernels_by_formula():
    B, L, H, D = 2, 16, 2, 16
    q, k, v = (torch.randn(B, L, H, D, requires_grad=True) for _ in range(3))
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter, \
            attention.count_flops() as tally:
        out = attention.flash_attention(q, k, v)
        torch.autograd.grad(out.sum(), [q, k, v])
    assert tally.flops == 18 * B * H * L * L * D
    assert counter.get_total_flops() == 0     # the plain versions: unseen
    out = attention.flash_attention(q, k, v)  # no tally open: nothing kept
    assert tally.flops == 18 * B * H * L * L * D


def test_traced_records_carry_flops_cached_across_fits(tmp_path,
                                                       monkeypatch):
    jcfg, tcfg = _configs("mlp", run_kw=dict(trace_dir=str(tmp_path)),
                          fed_kw=dict(rounds=2))
    calls = []
    orig = FederatedLearner.round_cost_analysis

    def counted(self):
        calls.append(1)
        return orig(self)

    monkeypatch.setattr(FederatedLearner, "round_cost_analysis", counted)
    ln = FederatedLearner(tcfg, device="cpu")
    ln.fit()
    ln.fit(rounds=1)
    assert len(calls) == 1
    flops = [r["flops_per_round"] for r in ln.history]
    assert flops == [orig(ln)["flops_per_round"]] * 3
    jl = JaxLearner(jcfg.replace(run=dataclasses.replace(
        jcfg.run, trace_dir=str(tmp_path / "jax"))))
    jl.fit()
    assert [sorted(r) for r in ln.history[:2]] == [sorted(r)
                                                   for r in jl.history]


def test_cli_train_profile_dir(tmp_path, capsys):
    out = cli.main(["train", "--backend", "cpu", "--config",
                    "mnist_mlp_fedavg", "--dataset", "mnist_tiny",
                    "--num-clients", "4", "--rounds", "2", "--local-steps",
                    "2", "--profile-dir", str(tmp_path)])
    capsys.readouterr()
    assert out["rounds"] == 2
    files = os.listdir(tmp_path)
    assert len(files) == 1 and "_profile_rounds1-1_" in files[0]
    with open(tmp_path / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    assert np.isfinite(out["final_loss"])
