"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/<name>-<hash>.so`` at the repository root, where ``<hash>`` covers the
source, every header of ``csrc/`` it includes (``#include "x.cuh"``, followed
through headers) and the flags, so an edited source or header is rebuilt and
an unchanged one is loaded as it is. The libraries expose plain C functions
that the kernel wrappers call through ``ctypes``. Nothing is built when a module is imported:
the first call of a kernel's wrapper builds its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels can only be built on a machine with "
                           "the CUDA toolkit")
    return path


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the local headers it includes, directly or
    through other headers, in the order they are first included."""
    order: list[Path] = []

    def visit(path: Path) -> None:
        if path in order:
            return
        order.append(path)
        for inc in _LOCAL_INCLUDE.findall(path.read_text()):
            if (path.parent / inc).is_file():
                visit(path.parent / inc)

    visit(CSRC / f"{name}.cu")
    return order


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, dict]:
    """Compile every source not yet built, one ``nvcc`` each, all at once.

    Returns {name: {"path", "seconds", "log"}}: ``log`` is nvcc's output
    (ptxas's registers and spills), kept beside the library as
    ``<name>-<hash>.log``; ``seconds`` is 0.0 for a library already built."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else names
    out, procs = {}, {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            log = lib.with_suffix(".log")
            out[name] = {"path": lib, "seconds": 0.0,
                         "log": log.read_text() if log.exists() else ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, time.perf_counter())
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
        out[name] = {"path": lib, "seconds": time.perf_counter() - t0, "log": log}
    return out


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build_all([name])[name]["path"]))
    return _loaded[name]
