"""Build the C++ sources in ``csrc/`` and load them with ``ctypes``.

Two routes, by the source's suffix; each source exports plain C functions:

- ``csrc/<name>.cu``, CUDA C++ for the card: ``nvcc`` into
  ``build/kernels/<name>-<hash>.so`` (the hash covers the source, the
  shared headers ``csrc/*.cuh`` and the flags);
- ``csrc/<name>.cc``, C++ for the host (the npz codec): ``g++`` with zlib
  and threads into ``build/native/<name>-<hash>.so`` (the hash covers the
  source and the flags).

``build/`` sits beside the package; a stale library never loads. Every
build writes a temporary file and moves it into place, so processes that
build the same source at once do not see each other's half-written file.
Several sources build in parallel, one compiler process each. A failed
build raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "kernels"
NATIVE_DIR = BUILD_DIR.parent / "native"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
GXX_LIBS = ("-lz", "-lpthread")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "host with the CUDA toolkit")
    return path


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the host C++ sources need a C++17 "
                           "compiler and zlib's header")
    return path


def _paths(name: str) -> Tuple[pathlib.Path, pathlib.Path]:
    """The source and its library's path, whose hash covers the source,
    the flags and, for a ``.cu``, every shared header ``csrc/*.cuh`` (any
    CUDA source may include any of them)."""
    src = CSRC / f"{name}.cc"
    if src.exists():
        h = hashlib.sha256(src.read_bytes())
        h.update(" ".join(GXX_FLAGS + GXX_LIBS).encode())
        return src, NATIVE_DIR / f"{name}-{h.hexdigest()[:12]}.so"
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _command(src: pathlib.Path, out: pathlib.Path) -> list:
    if src.suffix == ".cc":
        return [_gxx(), *GXX_FLAGS, "-o", str(out), str(src), *GXX_LIBS]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, all at once.

    Returns the compiler's output (for a ``.cu``, ``-Xptxas -v``:
    registers, shared memory, spills) for each source that was compiled."""
    procs = {}
    for name in names:
        src, lib = _paths(name)
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(
            f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(src, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), src, tmp, lib)
    logs = {}
    for name, (proc, src, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{proc.args[0]} failed for csrc/{src.name}:"
                               f"\n{out}")
        os.replace(tmp, lib)
        logs[name] = out
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.cc``, built first if
    needed."""
    build((name,))
    return ctypes.CDLL(str(_paths(name)[1]))
