"""The port's ``lint`` (``colearn_federated_learning_tpu_torch/analysis``)
against the JAX package's.

- Every source snippet of ``tests/test_lint.py`` and
  ``tests/test_lint_concurrency.py`` (copied into
  ``tests/torch_port_lint_cases.py``) gives the same ``(rule, line, col,
  message)`` list and the same suppressed, baselined and dead-suppression
  counts under both engines.  The port has no CL001 and no traced-region
  half of CL006 (it traces nothing), so JAX's engine runs here with the
  port's rule ids and with its traced-region finder stubbed to find no
  region: what is left of JAX's rules is what the port claims to equal.
- Both engines over the JAX package: the same findings less CL001 (none
  today), the same files and suppressions.
- The torch calls the port adds to CL006, CL012 and CL013 are found in a
  ``# colearn: hot`` region and nowhere else (JAX's engine sees none).
- The reporters render the same findings byte for byte (text, JSON,
  SARIF; the SARIF tool keeps JAX's name, ``colearn-lint``).
- ``cli lint`` against JAX's ``colearn lint`` on the same trees: exit
  codes 0, 1 and 2, ``--gate`` on a non-empty baseline, ``--write-baseline``
  then a clean run, the output; and the repo's own port package clean
  under ``--gate``.
"""

import ast
import json
import os
import sys
import textwrap
from pathlib import Path

import pytest

from colearn_federated_learning_tpu import cli as jax_cli
from colearn_federated_learning_tpu.analysis import engine as jax_engine
from colearn_federated_learning_tpu.analysis import reporters as jax_reporters
from colearn_federated_learning_tpu.analysis import rules as jax_rules
from colearn_federated_learning_tpu_torch import cli
from colearn_federated_learning_tpu_torch.analysis import engine
from colearn_federated_learning_tpu_torch.analysis import reporters

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_lint_cases import CASES  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_PKG = ROOT / "colearn_federated_learning_tpu_torch"
JAX_PKG = ROOT / "colearn_federated_learning_tpu"
PORT_RULES = sorted(engine.registered_rules())


def _write(tmp_path, relpath, source):
    path = tmp_path / relpath
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return path


def _keys(result):
    return [(f.rule, f.line, f.col, f.message) for f in result.findings]


def _dead(result):
    return sum(f.rule == engine.DEAD_SUPPRESSION_RULE for f in result.findings)


def _port_exit(argv) -> int:
    """The port command's exit code: 0 when it returns."""
    try:
        cli.main(argv)
    except SystemExit as e:
        return e.code
    return 0


def test_the_port_keeps_every_rule_but_cl001():
    theirs = set(jax_engine.registered_rules())
    assert set(PORT_RULES) == theirs - {"CL001"}
    assert len(PORT_RULES) == 21
    for rid in PORT_RULES:
        ours, jax = (engine.registered_rules()[rid],
                     jax_engine.registered_rules()[rid])
        assert (ours.title, ours.hint) == (jax.title, jax.hint), rid


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_lint_parity_on_the_jax_fixtures(case, tmp_path, monkeypatch):
    _, relpath, rules, source = case
    path = _write(tmp_path, relpath, source)
    try:
        traced = jax_rules.traced_regions(ast.parse(source))
    except SyntaxError:
        traced = []
    jax_full = jax_engine.LintEngine(
        config=jax_engine.LintConfig(enable=rules), root=str(tmp_path)).run(
        [str(path)], baseline_path="")
    monkeypatch.setattr(jax_rules, "traced_regions", lambda tree: [])
    theirs = jax_engine.LintEngine(
        config=jax_engine.LintConfig(enable=rules or PORT_RULES),
        root=str(tmp_path)).run([str(path)], baseline_path="")
    ours = engine.LintEngine(
        config=engine.LintConfig(enable=rules), root=str(tmp_path)).run(
        [str(path)], baseline_path="")
    assert _keys(ours) == _keys(theirs)
    assert [f.hint for f in ours.findings] == [f.hint for f in theirs.findings]
    assert (ours.suppressed, ours.baselined, ours.files, _dead(ours)) == (
        theirs.suppressed, theirs.baselined, theirs.files, _dead(theirs))
    # The departures: whatever JAX finds in a traced body, the port does
    # not; a source with no traced body gets JAX's own findings.
    assert not any(f.rule == "CL001" or "traced function" in f.message
                   for f in ours.findings)
    if not traced:
        assert _keys(ours) == [k for k in _keys(jax_full)
                               if rules is not None or k[0] != "CL001"]


def test_the_port_lints_the_jax_package_as_jax_does():
    config = jax_engine.LintConfig.from_pyproject(str(ROOT))
    theirs = jax_engine.LintEngine(config=config, root=str(ROOT)).run(
        [str(JAX_PKG)])
    ours = engine.LintEngine(
        config=engine.LintConfig.from_pyproject(str(ROOT)),
        root=str(ROOT)).run([str(JAX_PKG)])
    assert _keys(ours) == [k for k in _keys(theirs) if k[0] != "CL001"]
    assert ours.findings == [] and theirs.findings == []
    assert (ours.files, ours.suppressed, ours.baselined) == (
        theirs.files, theirs.suppressed, theirs.baselined)
    assert ours.files > 100


def test_config_disable_and_unknown_ids_match_jax(tmp_path):
    path = _write(tmp_path, "pkg/comm/mod.py", """
        def drain(sock):
            return sock.recv(4)
    """)
    for disable in ((), ("CL002",)):
        ours = engine.LintEngine(config=engine.LintConfig(disable=disable),
                                 root=str(tmp_path)).run([str(path)], "")
        theirs = jax_engine.LintEngine(
            config=jax_engine.LintConfig(disable=disable),
            root=str(tmp_path)).run([str(path)], "")
        assert _keys(ours) == _keys(theirs) == (
            [] if disable else [("CL002", 3, 11, theirs.findings[0].message)])
    with pytest.raises(ValueError, match="unknown lint rule 'CL001'"):
        engine.LintEngine(config=engine.LintConfig(enable=["CL001"]))


# ------------------------------------------------ the torch call sets ----
# (rule, relpath, the call, the message's opening): each call is one the
# port adds to JAX's sets.
TORCH_CASES = [
    ("CL006", "pkg/fed/mod.py", "x.cpu()", ".cpu()"),
    ("CL006", "pkg/fed/mod.py", "x.tolist()", ".tolist()"),
    ("CL006", "pkg/fed/mod.py", "x.numpy()", ".numpy()"),
    ("CL006", "pkg/fed/mod.py", "torch.cuda.synchronize()",
     "torch.cuda.synchronize()"),
    ("CL012", "pkg/comm/mod.py", "x.cpu()", ".cpu()"),
    ("CL012", "pkg/comm/mod.py", "x.item()", ".item()"),
    ("CL012", "pkg/comm/mod.py", "x.tolist()", ".tolist()"),
    ("CL012", "pkg/comm/mod.py", "x.numpy()", ".numpy()"),
    ("CL012", "pkg/comm/mod.py", "torch.cuda.synchronize()",
     "torch.cuda.synchronize()"),
    ("CL012", "pkg/comm/mod.py", "trees.map_leaves(np.asarray, x)",
     "trees.map_leaves(np.asarray, ...)"),
    ("CL012", "pkg/comm/mod.py", "map_leaves(np.array, x)",
     "map_leaves(np.array, ...)"),
    ("CL013", "pkg/comm/mod.py", "torch.zeros(x.shape)",
     "torch.zeros(...) allocates a full-shape buffer"),
    ("CL013", "pkg/comm/mod.py", "torch.zeros_like(x)",
     "torch.zeros_like(...) allocates a full-shape buffer"),
    ("CL013", "pkg/comm/mod.py", "torch.empty(x.shape)",
     "torch.empty(...) allocates a full-shape buffer"),
    ("CL013", "pkg/comm/mod.py", "torch.empty_like(x)",
     "torch.empty_like(...) allocates a full-shape buffer"),
    ("CL013", "pkg/comm/mod.py", "torch.full(x.shape, 0.0)",
     "torch.full(...) allocates a full-shape buffer"),
    ("CL013", "pkg/comm/mod.py", "torch.full_like(x, 0.0)",
     "torch.full_like(...) allocates a full-shape buffer"),
]


def _torch_source(call: str, hot: bool) -> str:
    mark = "  # colearn: hot" if hot else ""
    return (f"import numpy as np\nimport torch\nfrom pkg import trees\n\n\n"
            f"def step(batches):\n    for x in batches:{mark}\n"
            f"        y = {call}\n    return y\n")


@pytest.mark.parametrize("rule,relpath,call,what", TORCH_CASES,
                         ids=[f"{c[0]}-{c[2]}" for c in TORCH_CASES])
@pytest.mark.parametrize("hot", [True, False], ids=["hot", "cold"])
def test_torch_calls_are_found_in_hot_regions_only(rule, relpath, call, what,
                                                   hot, tmp_path):
    path = _write(tmp_path, relpath, _torch_source(call, hot))
    ours = engine.LintEngine(config=engine.LintConfig(enable=[rule]),
                             root=str(tmp_path)).run([str(path)], "")
    theirs = jax_engine.LintEngine(
        config=jax_engine.LintConfig(enable=[rule]),
        root=str(tmp_path)).run([str(path)], "")
    if not hot:
        assert ours.findings == []
        return
    (f,) = ours.findings
    assert (f.rule, f.line) == (rule, 8)
    assert f.message.startswith(f"{what} inside a `# colearn: hot`")
    # JAX's sets hold none of these (JAX's CL006 has .item() already).
    assert theirs.findings == []


# ------------------------------------------------------------ reporters --
def _mixed_result(tmp_path, lint_engine):
    _write(tmp_path, "pkg/comm/mod.py", """
        import time

        def drain(sock):
            try:
                return sock.recv(4)
            except OSError:
                pass

        def tick(q):
            while q:  # colearn: hot
                time.sleep(0.1)
                time.sleep(0.2)  # colearn: noqa(CL015)
                q.pop().block_until_ready()
        X = 1  # colearn: noqa(CL002)
        Y = 2  # colearn: noqa
    """)
    _write(tmp_path, "pkg/fed/broken.py", "def broken(:\n")
    eng = lint_engine.LintEngine(config=lint_engine.LintConfig(),
                                 root=str(tmp_path))
    if lint_engine is jax_engine:
        eng.rules = [r for r in eng.rules if r.id != "CL001"]
    return eng.run([str(tmp_path / "pkg")], baseline_path="")


@pytest.mark.parametrize("fmt", ["text", "json", "sarif"])
def test_reporters_render_jax_s_output(fmt, tmp_path):
    ours = _mixed_result(tmp_path, engine)
    theirs = _mixed_result(tmp_path, jax_engine)
    assert {f.rule for f in ours.findings} >= {
        "CL000", "CL002", "CL003", "CL006", "CL015", "CL022", "CL999"}
    assert _keys(ours) == _keys(theirs)
    render = {"text": "render_text", "json": "render_json",
              "sarif": "render_sarif"}[fmt]
    assert (getattr(reporters, render)(ours)
            == getattr(jax_reporters, render)(theirs))
    if fmt == "sarif":
        doc = json.loads(reporters.render_sarif(ours))
        assert doc["runs"][0]["tool"]["driver"]["name"] == "colearn-lint"


# ------------------------------------------------------------------ CLI --
_BAD = """
    def drain(sock):
        return sock.recv(4)
"""


def _both(argv, capsys):
    """(exit, stdout, stderr) of JAX's command and of the port's."""
    rc_jax = jax_cli.main(argv)
    out_jax = capsys.readouterr()
    rc_port = _port_exit(argv)
    out_port = capsys.readouterr()
    return ((rc_jax, out_jax.out, out_jax.err),
            (rc_port, out_port.out, out_port.err))


@pytest.mark.parametrize("fmt", ["text", "json", "sarif"])
def test_cli_clean_tree_exits_0_as_jax(fmt, tmp_path, capsys):
    clean = _write(tmp_path, "pkg/comm/mod.py", "X = 1\n")
    theirs, ours = _both(["lint", str(clean), "--root", str(tmp_path),
                          "--format", fmt], capsys)
    assert ours == theirs and ours[0] == 0


@pytest.mark.parametrize("fmt", ["text", "json", "sarif"])
def test_cli_finding_exits_1_as_jax(fmt, tmp_path, capsys):
    bad = _write(tmp_path, "pkg/comm/mod.py", _BAD)
    theirs, ours = _both(["lint", str(bad), "--root", str(tmp_path),
                          "--format", fmt], capsys)
    assert ours == theirs and ours[0] == 1
    if fmt == "json":
        doc = json.loads(ours[1])
        assert doc["counts"] == {"CL002": 1}
        assert doc["findings"][0]["line"] == 3


@pytest.mark.parametrize("rules", ["CL404", "CL001"])
def test_cli_unknown_rule_exits_2(rules, tmp_path, capsys):
    """An unknown id is a usage error in both (the message lists the
    registered ids: JAX's less CL001); CL001 is unknown only to the
    port."""
    clean = _write(tmp_path, "pkg/comm/mod.py", "X = 1\n")
    argv = ["lint", str(clean), "--root", str(tmp_path), "--rules", rules]
    theirs, ours = _both(argv, capsys)
    assert ours[:2] == (2, "")
    assert ours[2] == (f"colearn lint: unknown lint rule {rules!r}; "
                       f"registered: {PORT_RULES}\n")
    assert theirs[0] == (2 if rules == "CL404" else 0)
    if rules == "CL404":
        assert theirs[2] == ours[2].replace("['CL002'", "['CL001', 'CL002'")


def test_cli_gate_fails_on_a_non_empty_baseline(tmp_path, capsys):
    bad = _write(tmp_path, "pkg/comm/mod.py", _BAD)
    res = engine.LintEngine(config=engine.LintConfig(),
                            root=str(tmp_path)).run([str(bad)], "")
    engine.write_baseline(str(tmp_path / "lint_baseline.json"), res.findings)
    argv = ["lint", str(bad), "--root", str(tmp_path), "--gate"]
    theirs, ours = _both(argv, capsys)
    assert ours == theirs and ours[0] == 1
    assert "baseline" in ours[2] and "1 fingerprint(s)" in ours[2]
    # Without --gate the baseline absorbs the finding.
    theirs, ours = _both(argv[:-1], capsys)
    assert ours == theirs and ours[0] == 0 and "1 baselined" in ours[1]


def test_cli_write_baseline_then_clean(tmp_path, capsys):
    _write(tmp_path, "pkg/comm/mod.py", _BAD)
    target = str(tmp_path / "pkg")
    argv = ["lint", target, "--root", str(tmp_path), "--write-baseline"]
    assert jax_cli.main(argv) == 0
    theirs = (tmp_path / "lint_baseline.json").read_text()
    (tmp_path / "lint_baseline.json").unlink()
    assert _port_exit(argv) == 0
    assert (tmp_path / "lint_baseline.json").read_text() == theirs
    out = capsys.readouterr().out
    assert "baselined 1 finding(s) (1 fingerprint(s))" in out
    assert _port_exit(["lint", target, "--root", str(tmp_path)]) == 0
    assert "clean" in capsys.readouterr().out


def test_the_port_package_is_clean_under_the_gate(capsys):
    """``lint --gate`` from the repo root: the port's package (the
    default path) with the repo's baseline, which stays empty."""
    assert json.loads((ROOT / "lint_baseline.json").read_text())[
        "entries"] == {}
    assert _port_exit(["lint", "--gate", "--format", "json", "--root",
                       str(ROOT)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["findings"] == [] and doc["baselined"] == 0
    assert doc["files"] == len(list(PORT_PKG.rglob("*.py")))
    assert doc["suppressed"] >= 24
