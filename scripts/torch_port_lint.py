#!/usr/bin/env python
"""Lint gate of the port: ``python scripts/torch_port_lint.py [paths...]``
(the counterpart of the JAX package's ``scripts/lint.py``).

A thin wrapper over the port's ``lint`` command that pins the repo root to
this checkout, so that CI and pre-test hooks get the checked-in
``pyproject.toml`` configuration and baseline whatever the working
directory.  It imports no torch and touches no device.  Exits with the
command's code: 0 clean, 1 on a finding, 2 on a usage error.
"""

import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    sys.path.insert(0, REPO_ROOT)
    from colearn_federated_learning_tpu_torch.cli import main as cli_main

    args = list(sys.argv[1:] if argv is None else argv)
    try:
        rc = cli_main(["lint", "--root", REPO_ROOT, *args])
    except SystemExit as e:             # the command's 1 and 2
        rc = e.code
    return int(rc or 0)


if __name__ == "__main__":
    raise SystemExit(main())
