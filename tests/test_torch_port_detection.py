"""The port's detection evaluation against the JAX package's.

- ``evaluation.detection_report`` (a copy of JAX's, numpy only) gives
  JAX's report exactly, for every benign class, empty rows and columns.
- ``make_confusion_eval_fn`` counts JAX's confusion matrix on converted
  params (the MLP and the IoT deployment's TCN), exactly: both score the
  same padded batches and an f32 count of 0/1 masks is exact.
- ``FederatedLearner.evaluate_detection`` on the IoT config
  (``iot_traffic_tcn_fedavg``'s TCN on its tiny dataset) and ``eval
  --detection-eval`` on a global-model file give JAX's reports: counts
  exactly, rates and F1 to f64 rounding (rtol 1e-12); the file's
  ``eval_acc`` to f32 rounding (JAX divides it in f32).
"""

import json

import jax
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu.cli import main as jax_main
from colearn_federated_learning_tpu.fed import FederatedLearner as JaxLearner
from colearn_federated_learning_tpu.fed import evaluation as jax_eval
from colearn_federated_learning_tpu.models import registry as jax_registry
from colearn_federated_learning_tpu.fed import setup as jax_setup
from colearn_federated_learning_tpu.utils import config as jax_config
from colearn_federated_learning_tpu_torch import cli
from colearn_federated_learning_tpu_torch.fed import FederatedLearner
from colearn_federated_learning_tpu_torch.fed import evaluation
from colearn_federated_learning_tpu_torch.fed import setup as setup_lib
from colearn_federated_learning_tpu_torch.models import registry
from colearn_federated_learning_tpu_torch.utils import config
from test_torch_port_round import JaxDraws

ARRAYS = ("per_class_precision", "per_class_recall", "per_class_f1",
          "support")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def assert_reports_equal(ours, theirs, rtol=0.0):
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        if k in ARRAYS:
            np.testing.assert_allclose(np.asarray(ours[k]), np.asarray(v),
                                       rtol=rtol, atol=0.0, err_msg=k)
            if k == "support":
                np.testing.assert_array_equal(ours[k], v)
        else:
            assert ours[k] == pytest.approx(v, rel=rtol, abs=0.0), k


def _confusions():
    rng = np.random.default_rng(7)
    out = [rng.integers(0, 50, (8, 8)).astype(np.float32)]
    c = rng.integers(0, 9, (5, 5)).astype(np.float32)
    c[2] = 0                      # a class with no support
    c[:, 3] = 0                   # a class never predicted
    out.append(c)
    out.append(np.diag([10.0, 0.0, 4.0]).astype(np.float32))
    out.append(np.zeros((4, 4), np.float32))
    return out


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("benign", [0, 1])
def test_detection_report_is_jax_s(case, benign):
    conf = _confusions()[case]
    assert_reports_equal(evaluation.detection_report(conf, benign),
                         jax_eval.detection_report(conf, benign))


def _configs(family, **fed_kw):
    if family == "tcn":
        data = dict(dataset="iot_traffic_tiny", partition="dirichlet",
                    dirichlet_alpha=0.3)
        model = dict(name="tcn", num_classes=8, width=8, depth=3)
    else:
        data = dict(dataset="mnist_tiny", partition="iid")
        model = dict(name="mlp", num_classes=10, hidden_dim=32, depth=2)
    kw = dict(data=dict(data, num_clients=4), model=model,
              fed=dict(strategy="fedavg", rounds=2, cohort_size=0,
                       local_steps=3, batch_size=16, lr=0.05, momentum=0.9,
                       **fed_kw),
              run=dict(seed=3, name=f"detection_{family}"))
    return [mod.ExperimentConfig(
        data=mod.DataConfig(**kw["data"]), model=mod.ModelConfig(**kw["model"]),
        fed=mod.FedConfig(**kw["fed"]), run=mod.RunConfig(**kw["run"]))
        for mod in (jax_config, config)]


@pytest.mark.parametrize("family", ["mlp", "tcn"])
def test_confusion_counts_are_jax_s_on_converted_params(family):
    jcfg, tcfg = _configs(family)
    jl = JaxLearner(jcfg)
    jl.fit(rounds=1)
    params = jax.device_get(jl.server_state.params)
    ds = jl.dataset
    jmodel = jax_registry.build_model(jax_setup.local_model_config(
        jcfg.model))
    want = np.asarray(jax_eval.make_confusion_eval_fn(
        jmodel.apply, ds.x_test, ds.y_test, batch=64,
        num_classes=jcfg.model.num_classes)(params))
    model = registry.build_model(
        setup_lib.local_model_config(tcfg.model), "cpu",
        input_shape=np.asarray(ds.x_test).shape[1:])
    got = evaluation.make_confusion_eval_fn(
        model, ds.x_test, ds.y_test, batch=64,
        num_classes=tcfg.model.num_classes, device="cpu")(
            setup_lib.flax_to_params(model, params, "cpu"))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.sum() == len(ds.y_test)


@pytest.mark.parametrize("benign", [0, 3])
def test_engine_detection_report_on_the_iot_config_is_jax_s(benign):
    """The IoT deployment's report from the trained global model: the
    port's learner trains with JAX's draws from JAX's init, then both
    score their own params (held to rtol 1e-4 elsewhere), so the counts
    match exactly here and the rates to f64 rounding."""
    jcfg, tcfg = _configs("tcn")
    jl = JaxLearner(jcfg)
    tl = FederatedLearner(tcfg, device="cpu", plan=JaxDraws(tcfg.run.seed))
    tl.load_flax_params(jax.device_get(jl.params))
    jl.fit()
    tl.fit()
    ours = tl.evaluate_detection(benign_class=benign)
    theirs = jl.evaluate_detection(benign_class=benign)
    assert_reports_equal(ours, theirs, rtol=1e-12)
    loss, acc = tl.evaluate()
    assert ours["accuracy"] == pytest.approx(acc, abs=1e-12)


def test_eval_detection_eval_is_jax_s(tmp_path, capsys):
    """``eval --detection-eval`` on a JAX global-model file: JAX's keys
    (the report less its ``accuracy``, ``eval_acc`` being canonical) and
    values; the loss to 1e-5 as the file plane's test holds it."""
    g0 = str(tmp_path / "g0.npz")
    common = ["--config", "iot_traffic_tcn_fedavg", "--dataset",
              "iot_traffic_tiny", "--width", "8"]
    assert jax_main(["init", *common, "--out", g0]) == 0
    capsys.readouterr()
    argv = ["eval", *common, "--global-model", g0, "--detection-eval"]
    assert jax_main(argv) == 0
    theirs = json.loads(capsys.readouterr().out.splitlines()[-1])
    ours = cli.main([argv[0], "--backend", "cpu", *argv[1:]])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == ours
    assert sorted(ours) == sorted(theirs)
    assert "accuracy" not in ours and "macro_f1" in ours
    assert ours.pop("eval_loss") == pytest.approx(theirs.pop("eval_loss"),
                                                  rel=1e-5)
    # JAX divides the accuracy in f32, the port in f64.
    assert ours.pop("eval_acc") == pytest.approx(theirs.pop("eval_acc"),
                                                 rel=1e-6)
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k], v, rtol=1e-12, err_msg=k)
    plain = cli.main(["eval", "--backend", "cpu", *common,
                      "--global-model", g0])
    assert sorted(plain) == ["eval_acc", "eval_loss", "round"]


def test_cli_train_dumps_the_detection_report(capsys):
    out = cli.main(["train", "--backend", "cpu", "--config",
                    "iot_traffic_tcn_fedavg", "--dataset",
                    "iot_traffic_tiny", "--width", "8", "--num-clients",
                    "4", "--rounds", "1", "--local-steps", "2",
                    "--detection-eval"])
    rep = json.loads(capsys.readouterr().err.splitlines()[-1])
    assert out["rounds"] == 1
    assert sorted(rep) == sorted(["accuracy", "per_class_precision",
                                  "per_class_recall", "per_class_f1",
                                  "macro_f1", "detection_rate",
                                  "false_alarm_rate", "support"])
    assert rep["accuracy"] == pytest.approx(out["final_acc"], abs=1e-12)
