"""Build and load the port's CUDA kernels (``paddle_tpu_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``. A library is
built at first use and cached under ``paddle_tpu_torch/_build/`` by a hash
of its source, the headers in ``csrc/`` and the flags, so an edited source
rebuilds and an unchanged one loads at once. :func:`build_all` starts one
``nvcc`` per source, all at once, and waits for them.

Conventions the wrappers follow: every pointer and the stream go through
``ctypes.c_void_p`` (a bare int would be cut to 32 bits); kernels launch
on ``torch.cuda.current_stream()`` and allocate nothing (the wrapper
allocates outputs with ``torch.empty``); every C entry point returns
``cudaGetLastError()`` and :func:`check` raises when it is not 0.

This module imports where there is no ``nvcc``; only a build needs it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "build_all",
           "load", "check", "library_path"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$NVCC``, then ``PATH``, then the toolkit under
    ``$CUDA_HOME`` or its default install prefix. Raises if none exists."""
    cands = [os.environ.get("NVCC"), shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home:
            cands.append(os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH, $CUDA_HOME/bin): the CUDA "
        "kernels of paddle_tpu_torch are built from source at first use")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: the name
    carries a hash of everything that goes into the build."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> float:
    """Build every library in ``names`` (default: every ``csrc/*.cu``)
    that is not cached yet, one ``nvcc`` per source, all started
    together. Returns the seconds spent; raises with the compiler's
    output if any build fails. The compiler's report (``-Xptxas -v``:
    registers, shared memory, spills) is kept beside each library as
    ``<library>.log``."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        if not jobs:
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{log}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_name(out.name + ".log").write_text(log)
        os.replace(tmp, out)    # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point of ``lib`` returned a CUDA error (a
    refused launch never runs, and a later synchronise would not report
    it). Every library exports ``cuda_error_string`` (csrc/common.cuh)."""
    if err != 0:
        fn = lib.cuda_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"{what}: CUDA error {err} ({fn(err).decode()})")
