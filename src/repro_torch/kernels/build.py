"""Build the port's CUDA sources and load them with ctypes.

Each ``kernels/csrc/<name>.cu`` exports a plain C interface and is compiled
by ``nvcc`` for ``sm_90a`` into ``build/repro_torch/lib<name>-<hash>.so``
at the checkout's root (listed in ``.gitignore``), at first use. The hash
covers every file under ``csrc/`` and the flags, so an edited source is
rebuilt and a stale library is never loaded. Sources that need a build are
compiled in parallel, one ``nvcc`` each, all started together. Nothing
here runs at import time: the CPU tests import every module.

Several processes may build and load at once (the rank processes of
``launch/mesh.py``): ``nvcc`` writes to a name of its own process's
(``.tmp<pid>``), renamed onto the library's name in one step once it is
complete, so no process ever loads a half-written library; two processes
that both find it missing both compile, and the second rename replaces
the first with the same bytes. ``run_ranks`` builds in the parent before
it spawns, so the ranks find the libraries finished.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build(names: Sequence[str]) -> dict[str, float]:
    """Compile every named source whose library is missing, all in
    parallel; returns ``name -> seconds`` for those built (0.0 when the
    library was already there). Raises with nvcc's output on failure. The
    ptxas report (registers, shared memory, spills) is kept beside each
    library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        out.with_suffix(".so.log").write_text(log)
        os.replace(tmp, out)  # atomic: concurrent loaders never see a partial file
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return seconds


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
