#!/usr/bin/env python3
"""Device time of the sparse fold kernel under other work layouts.

    python3 scripts/torch_port_fold_layouts.py

Builds ``scripts/fold_layouts.cu`` (variants of the package's sparse fold
kernel that differ only in how work is laid out: threads a block, entries
a thread, consecutive entries a lane, blocks) beside the package's own
kernels, draws phase 9a's topk8 and topk batches at BERT-base's slot layout
(``chip_smoke.sparse_batch``), and for each layout checks the result bit
for bit against the plain version (from zeros) and takes its device time
per contribution onto a standing accumulator by CUDA-graph replay
(``chip_smoke.device_ms``), in two passes in opposite orders, with the
package's kernel timed in each pass beside them.  Prints one line per
layout (both passes' µs), then all of them as one JSON line beside the
card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from colearn_federated_learning_tpu_torch.fed import setup  # noqa: E402
from colearn_federated_learning_tpu_torch.ops import _build  # noqa: E402
from colearn_federated_learning_tpu_torch.ops import fold as F  # noqa: E402
from colearn_federated_learning_tpu_torch.utils import trees  # noqa: E402

# (label, threads a block, entries a thread, consecutive entries a lane,
# blocks; 0: as many as the SMs hold at once)
LAYOUTS = [
    ("lane-contiguous x8, 16-byte loads, full occupancy", 256, 8, 8, 0),
    ("lane-contiguous x8, 16-byte loads, 132 blocks", 256, 8, 8, 132),
    ("lanes 32 apart, 256 x 8, full occupancy", 256, 8, 1, 0),
    ("lanes 32 apart, 256 x 8, 264 blocks", 256, 8, 1, 264),
    ("lanes 32 apart, 256 x 8, 132 blocks", 256, 8, 1, 132),
    ("lanes 32 apart, 256 x 8, 66 blocks", 256, 8, 1, 66),
    ("lanes 32 apart, 256 x 4, 132 blocks", 256, 4, 1, 132),
    ("lanes 32 apart, 128 x 8, 132 blocks (the package's)", 128, 8, 1, 132),
    ("lanes 32 apart, 128 x 8, 66 blocks", 128, 8, 1, 66),
]


def build() -> ctypes.CDLL:
    src = os.path.join(HERE, "scripts", "fold_layouts.cu")
    digest = hashlib.sha256(open(src, "rb").read()
                            + " ".join(_build.NVCC_FLAGS).encode())
    out = _build.BUILD_DIR / f"fold_layouts-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        log = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                              str(out), src], capture_output=True, text=True)
        if log.returncode != 0:
            raise RuntimeError(log.stdout + log.stderr)
        if re.search(r"[1-9]\d* bytes spill stores", log.stdout + log.stderr):
            print("  note: a variant spills registers", flush=True)
    lib = ctypes.CDLL(str(out))
    P, I, L, Fl = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    lib.fold_sparse_layout.argtypes = [P, P, P, I, P, P, P, P, P, L, Fl, I,
                                       P, I, I, I, I]
    lib.fold_sparse_layout.restype = I
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_port_fold_layouts: no CUDA device", file=sys.stderr)
        return 1
    card = S.card()
    _build.build_all()
    lib = build()
    shapes = setup.init_global_params(S.main_path_config(), "cuda")
    sizes = [int(np.asarray(l).size) for l in trees.leaves(shapes)]
    del shapes
    kernel = F.get_kernel(sizes)
    tile = F.TILE
    rows = []
    for int8, label in ((True, "topk8"), (False, "topk")):
        batch = S.sparse_batch(sizes, S.FOLD_ROWS, int8, 90 + int(int8))
        staged = {}
        for thr, u in {(t, u) for _, t, u, _, _ in LAYOUTS}:
            F.TILE = thr * u               # the variant's tile table
            staged[thr * u] = kernel.stage_sparse(batch)
        F.TILE = tile
        ours = kernel.stage_sparse(batch)
        want = S.plain_sparse(F, kernel, ours, None)

        def run(acc, st, thr, u, vec, blocks):
            for part in st.parts:
                set_mode = acc is None
                if set_mode:
                    acc = torch.zeros(kernel.total, dtype=torch.float32,
                                      device="cuda")
                err = lib.fold_sparse_layout(
                    acc.data_ptr(), part.idx.data_ptr(), part.vals.data_ptr(),
                    int(int8), part.begin.data_ptr(), part.scales.data_ptr(),
                    part.tiles.data_ptr(), kernel.slot_off.data_ptr(),
                    kernel.slot_size.data_ptr(), int(part.begin_host[-1]),
                    float(part.weight), int(set_mode),
                    torch.cuda.current_stream().cuda_stream, thr, u, vec,
                    blocks)
                if err:
                    raise RuntimeError(f"layout launch failed: {err}")
            return acc

        acc = torch.zeros(kernel.total, dtype=torch.float32, device="cuda")
        times = {name: [] for name, *_ in LAYOUTS}
        times["the package's kernel (fold_sparse_staged)"] = []
        for order in (LAYOUTS, LAYOUTS[::-1]):
            for name, thr, u, vec, blocks in order:
                st = staged[thr * u]
                S.bits_equal(f"{label} {name}",
                             run(None, st, thr, u, vec, blocks), want)
                times[name].append(1e3 * S.device_ms(
                    lambda s: run(acc, s, thr, u, vec, blocks), [st])
                    / S.FOLD_ROWS)
            times["the package's kernel (fold_sparse_staged)"].append(
                1e3 * S.device_ms(lambda s: kernel.fold_sparse_staged(acc, s),
                                  [ours]) / S.FOLD_ROWS)
        for name, us in times.items():
            row = {"values": label, "layout": name, "us": us, "card": card}
            rows.append(row)
            print(f"  {label:5s} {name:55s} "
                  + ", ".join(f"{t:.2f}" for t in us) + " us", flush=True)
        del want, acc, staged, ours
    print(json.dumps(rows), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
