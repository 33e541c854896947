"""The JAX package's native library, built privately for one test module.

The port's native-parity tests compare against the JAX package's native
library (``colearn_federated_learning_tpu.native``), not its numpy
fallback, which breaks ties in another order.  That package builds the
library lazily, on first use, into one shared file
(``native/_build/libcolearn_native_v*.so``): its compiler writes straight
onto that path, with no lock and no temporary file, and ``needs_build``
only compares mtimes.  Under pytest-xdist a worker that arrives while
another worker's compiler is still writing takes the file as built,
dlopens a torn library, and ``load`` caches ``None`` for the life of that
worker.

:func:`private_native` side-steps the shared file without changing the
JAX package: for the length of a block it points the package's ``LIB`` at
a file of the same name in a directory of the caller's (per test module,
per worker) and forgets any earlier load, so the package's own
``needs_build``/``build`` compile its own sources with its own command
and flags there.  On leaving the block ``LIB``, ``_tried`` and ``_lib``
are put back, so later tests in the same worker load the shared library
as before.  :func:`native_lib` is the module-scoped autouse fixture that
the parity modules import.
"""

from __future__ import annotations

import contextlib
import ctypes
import pathlib
from typing import Iterator, Optional

import pytest

from colearn_federated_learning_tpu import native
from colearn_federated_learning_tpu.native import build as build_mod


@contextlib.contextmanager
def private_native(directory) -> Iterator[Optional[ctypes.CDLL]]:
    """Within the block, the JAX package's native library is built and
    loaded from ``directory`` alone; yields what ``native.load()`` gave
    there (``None`` if it did not load)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build_mod, "LIB",
                   pathlib.Path(directory) / build_mod.LIB.name)
        mp.setattr(native, "_tried", False)
        mp.setattr(native, "_lib", None)
        yield native.load()


@pytest.fixture(scope="module", autouse=True)
def native_lib(tmp_path_factory) -> Iterator[ctypes.CDLL]:
    """The JAX package's native library, built for this module in this
    worker's own temporary directory; the module's tests run inside it."""
    with private_native(tmp_path_factory.mktemp("native")) as lib:
        assert lib is not None, "the JAX package's native library"
        yield lib
