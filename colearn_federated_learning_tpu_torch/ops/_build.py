"""Build the package's CUDA sources into plain C shared libraries.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into ``_build/<name>-<hash>.so`` at first use and loaded with ``ctypes``;
the hash covers every file in ``csrc/`` and the flags, so an edit rebuilds
and an unchanged tree reuses the library.  All sources compile in
parallel, one ``nvcc`` each.  The kernels' wrappers call :func:`load` at
their first launch, so the CPU never needs a build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _tree_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh", ".h"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_tree_hash()}.so"


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` whose library is missing, all at once;
    raise with the compiler's output if any fails.  Returns the compiler
    output (``-Xptxas -v``: registers, spills) of each source it built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: library_path(src.stem)
               for src in sorted(CSRC_DIR.glob("*.cu"))}
    procs = {}
    for name, target in targets.items():
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{logs[name]}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it if needed."""
    path = library_path(name)
    if not path.exists():
        build_all()
    return ctypes.CDLL(str(path))
