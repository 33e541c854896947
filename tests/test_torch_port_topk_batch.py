"""The port's batched top-k selector (``ops/topk.py``'s
``topk_abs_many``, N1 for a whole tree in one call) on the CPU, against
the JAX package's native selector.

On the CPU the wrapper runs its plain version (the card's kernels are
held to it bit for bit by ``tests/test_torch_port_cuda.py`` and
``chip_smoke.py`` 24a).  Here:

- one tree mixing leaves of 1, 7, 700, 4,096 and 100,003 entries with the
  degenerate leaves (all zeros, a constant, mixed ±0.0, ties of both
  signs, NaN, ±inf and denormals) gives, leaf by leaf, JAX's
  ``native.topk_abs`` indices and value bits at k = 1, 5 % and n, inputs
  drawn with numpy from a seed (the library is built for this module in
  the worker's own temporary directory, ``torch_port_native_lib``);
- the batch refuses what ``topk_abs`` refuses, and lists of unequal
  length;
- the kernel's table puts the large leaves first with their offsets;
- ``compress_delta``, ``compress_decode`` and ``feedback_compress`` on a
  tree of tensors call the selector once per delta.
"""

import math

import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu import native
from colearn_federated_learning_tpu_torch.fed import compression
from colearn_federated_learning_tpu_torch.ops import topk
from torch_port_native_lib import native_lib  # noqa: F401  (autouse)


def _tree() -> list[np.ndarray]:
    rng = np.random.default_rng(25)
    normal = [rng.standard_normal(n).astype(np.float32)
              for n in (1, 7, 700, 4096, 100_003)]
    specials = rng.standard_normal(100_003).astype(np.float32)
    specials[::7] = np.float32(1e-40)
    specials[3::11] = -np.float32(1e-42)
    specials[5], specials[9], specials[11] = np.inf, -np.inf, np.nan
    specials[12] = -np.float32(np.nan)
    signed = np.where(rng.random(5_000) < 0.5, np.float32(0.0),
                      np.float32(-0.0)).astype(np.float32)
    return [normal[0], np.zeros(70_000, np.float32), normal[1],
            np.full(9_000, -2.5, np.float32), normal[2], signed, normal[3],
            rng.integers(-3, 4, 100_003).astype(np.float32), normal[4],
            specials]


K_OF = {"k = 1": lambda n: 1, "k = 5 %": lambda n: math.ceil(0.05 * n),
        "k = n": lambda n: n}


@pytest.mark.parametrize("rule", sorted(K_OF))
def test_batch_equals_the_native_selector_leaf_by_leaf(rule):
    arrays = _tree()
    ks = [K_OF[rule](a.size) for a in arrays]
    idx, val = topk.topk_abs_many([torch.from_numpy(a.copy())
                                   for a in arrays], ks)
    assert idx.dtype == torch.int32 and val.dtype == torch.float32
    assert idx.numel() == val.numel() == sum(ks)
    off = 0
    for a, k in zip(arrays, ks):
        want_i, want_v = native.topk_abs(a, k)
        np.testing.assert_array_equal(idx[off:off + k].numpy(), want_i)
        np.testing.assert_array_equal(
            val[off:off + k].numpy().view(np.uint32),
            np.asarray(want_v).view(np.uint32))
        off += k


def test_batch_fills_given_buffers_and_takes_an_empty_batch():
    arrays = _tree()[:5]
    flats = [torch.from_numpy(a) for a in arrays]
    ks = [max(1, a.size // 3) for a in arrays]
    out_i = torch.full((sum(ks),), -1, dtype=torch.int32)
    out_v = torch.zeros(sum(ks))
    got_i, got_v = topk.topk_abs_many(flats, ks, out_i, out_v)
    assert got_i is out_i and got_v is out_v
    want_i, want_v = topk.topk_abs_many_reference(flats, ks)
    assert torch.equal(out_i, want_i)
    assert torch.equal(out_v.view(torch.int32), want_v.view(torch.int32))
    for i, v in (topk.topk_abs_many([], []),
                 topk.topk_abs_many_reference([], [])):
        assert i.numel() == v.numel() == 0


def _refusal(case):
    x = torch.ones(5)
    return {
        "k = 0": ([x, x], [2, 0]),
        "k > n": ([x, x], [2, 6]),
        "float64": ([x, torch.ones(5, dtype=torch.float64)], [2, 2]),
        "2-D": ([x, torch.ones(2, 3)], [2, 2]),
        "unequal lengths": ([x, x], [2]),
        "out_idx size": ([x, x], [2, 2], torch.empty(3, dtype=torch.int32),
                         torch.empty(4)),
        "out_idx dtype": ([x, x], [2, 2], torch.empty(4, dtype=torch.int64),
                          torch.empty(4)),
        "out_val dtype": ([x, x], [2, 2], torch.empty(4, dtype=torch.int32),
                          torch.empty(4, dtype=torch.float64)),
        "out_val strided": ([x, x], [2, 2],
                            torch.empty(4, dtype=torch.int32),
                            torch.empty(8)[::2]),
    }[case]


@pytest.mark.parametrize("case", [
    "k = 0", "k > n", "float64", "2-D", "unequal lengths", "out_idx size",
    "out_idx dtype", "out_val dtype", "out_val strided"])
def test_batch_refuses_what_topk_abs_refuses(case):
    match = {"k = 0": "out of range", "k > n": "out of range",
             "float64": "flat float32", "2-D": "flat float32",
             "unequal lengths": "2 leaves but 1"}.get(
                 case, "contiguous int32 and float32")
    with pytest.raises(ValueError, match=match):
        topk.topk_abs_many(*_refusal(case))


class _Lib:
    """The library's constants, as ``csrc/topk.cu`` gives them."""

    @staticmethod
    def topk_constant(which):
        return (8192, 8192, 4096)[which]


def test_table_puts_large_leaves_first_with_their_offsets():
    sizes = [5, 20_000, 8192, 8193, 300_000]
    flats = [torch.zeros(n) for n in sizes]
    ks = [1, 1000, 8192, 3, 15_000]
    rows, totals = topk._plan(_Lib(), flats, ks)
    outs = np.cumsum([0] + ks)[:-1]
    assert [r[0] for r in rows] == [flats[j].data_ptr()
                                    for j in (1, 3, 4, 0, 2)]
    assert [r[1] for r in rows] == [outs[j] for j in (1, 3, 4, 0, 2)]
    # a_off, b_off (a multiple of 4), first tile, first merge block of
    # each large leaf
    assert [r[4:] for r in rows[:3]] == [
        (0, 0, 0, 0), (1000, 20_000, 3, 1), (1003, 28_196, 5, 2)]
    assert all(r[4:] == (0, 0, 0, 0) for r in rows[3:])
    assert totals == dict(nl=3, ns=2, tiles=5 + 37, merges=2 + 4,
                          sum_n=328_196, sum_k=16_003)


def _delta(rng) -> dict:
    shapes = {"Dense_0": {"kernel": (300, 40), "bias": (40,)}, "s": (7,),
              "Embed_0": {"embedding": (2000, 32)}}

    def leaf(shape):
        return torch.from_numpy(
            (0.01 * rng.standard_normal(shape)).astype(np.float32))

    return {k: ({kk: leaf(s) for kk, s in v.items()} if isinstance(v, dict)
                else leaf(v)) for k, v in shapes.items()}


@pytest.mark.parametrize("scheme", ["topk", "topk8"])
@pytest.mark.parametrize("entry", ["compress_delta", "compress_decode",
                                   "feedback_compress"])
def test_one_selector_call_per_delta(monkeypatch, entry, scheme):
    calls = []
    batch = topk.topk_abs_many

    def spy(flats, ks, *args):
        calls.append(len(flats))
        return batch(flats, ks, *args)

    monkeypatch.setattr(topk, "topk_abs_many", spy)
    rng = np.random.default_rng(3)
    residual = None
    for r in range(3):
        delta = _delta(rng)
        if entry == "feedback_compress":
            _, _, residual = compression.feedback_compress(
                delta, residual, scheme, topk_fraction=0.1)
        else:
            getattr(compression, entry)(delta, scheme, topk_fraction=0.1)
        assert calls == [4] * (r + 1)
