"""The private build of the JAX package's native library
(``torch_port_native_lib``) against a torn shared build.

The JAX package builds its native library lazily, straight onto one
shared path, and ``needs_build`` takes any file there that is newer than
the sources as built.  A pytest-xdist worker that dlopens that file while
another worker's compiler is still writing it caches ``None`` for the
rest of its life (a file cut inside its segments can even kill the
worker with SIGBUS, so none is made here).  These tests make such a torn
file on purpose, in the test's temporary directory and never at the
package's own path:

- a bare ``native.load()`` gives ``None`` there, the fact about the
  reference that the port's parity modules must get round;
- ``private_native`` still builds and loads a library whose selector
  picks the largest |x| with ties to the lower index, and leaves the
  torn file as it was;
- leaving it puts ``LIB``, ``_tried`` and ``_lib`` back as they were.
"""

import os
import pathlib

import numpy as np
import pytest

from colearn_federated_learning_tpu import native
from colearn_federated_learning_tpu.native import build as build_mod
from torch_port_native_lib import native_lib  # noqa: F401  (autouse)
from torch_port_native_lib import private_native

# Prefixes of a real build that ``dlopen`` refuses with an error: nothing,
# the ELF identification, the ELF header without its program headers.
TORN = {"empty": 0, "ELF identification": 16, "ELF header": 64}


def _torn_shared_build(tmp_path, whole: bytes, size: int) -> pathlib.Path:
    shared = tmp_path / "shared" / build_mod.LIB.name
    shared.parent.mkdir()
    shared.write_bytes(whole[:size])
    newer = max(s.stat().st_mtime for s in build_mod.SOURCES) + 60.0
    os.utime(shared, (newer, newer))
    return shared


@pytest.mark.parametrize("torn", sorted(TORN))
def test_private_build_loads_where_a_torn_shared_build_gives_none(
        torn, tmp_path, native_lib):  # noqa: F811
    whole = pathlib.Path(native_lib._name).read_bytes()
    shared = _torn_shared_build(tmp_path, whole, TORN[torn])
    outer = (build_mod.LIB, native._tried, native._lib)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build_mod, "LIB", shared)
        mp.setattr(native, "_tried", False)
        mp.setattr(native, "_lib", None)
        assert not build_mod.needs_build()
        assert native.load() is None
        assert native.load() is None, "None is cached for the process"

        private = tmp_path / "private"
        with private_native(private) as lib:
            assert lib is not None, "the JAX package's native library"
            assert build_mod.LIB == private / shared.name
            assert native.load() is lib
            rng = np.random.default_rng(26)
            x = rng.integers(-3, 4, 10_007).astype(np.float32)
            for k in (1, 1_000, 4_321, x.size):
                got_i, got_v = native.topk_abs(x, k)
                want = np.sort(np.argsort(-np.abs(x), kind="stable")[:k])
                np.testing.assert_array_equal(got_i, want.astype(np.int32))
                np.testing.assert_array_equal(got_v.view(np.uint32),
                                              x[want].view(np.uint32))

        assert build_mod.LIB is shared
        assert native._tried is True and native._lib is None
        assert shared.read_bytes() == whole[:TORN[torn]]
    assert (build_mod.LIB, native._tried, native._lib) == outer


def test_native_lib_builds_in_its_own_directory(native_lib):  # noqa: F811
    """The module's library was built from the JAX package's sources into
    a file of the package's own name outside the package's tree."""
    built = pathlib.Path(native_lib._name)
    assert build_mod.LIB == built
    assert built.name == f"libcolearn_native_v{build_mod.ABI_VERSION}.so"
    package = pathlib.Path(build_mod.__file__).resolve().parent
    assert package not in built.resolve().parents
    assert not build_mod.needs_build()
    assert native_lib.cl_abi_version() == build_mod.ABI_VERSION
    assert native.load() is native_lib
