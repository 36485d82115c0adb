"""Build the CUDA C++ sources in ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` exports plain C functions and is compiled on
first use into ``build/kernels/<name>-<hash>.so`` beside the package (the
hash covers the source, the shared headers ``csrc/*.cuh`` and the flags,
so a stale library never loads),
then opened with ``ctypes``. Several sources build in parallel, one
``nvcc`` process each. A failed build raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Iterable, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "host with the CUDA toolkit")
    return path


def _paths(name: str) -> Tuple[pathlib.Path, pathlib.Path]:
    """The source and its library's path, whose hash covers the source,
    every shared header ``csrc/*.cuh`` (any source may include any of
    them) and the flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, all at once.

    Returns the compiler's output (``-Xptxas -v``: registers, shared
    memory, spills) for each source that was compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, lib = _paths(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    logs = {}
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
        os.replace(tmp, lib)
        logs[name] = out
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build((name,))
    return ctypes.CDLL(str(_paths(name)[1]))
