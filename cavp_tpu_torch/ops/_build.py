"""Build and load the port's CUDA kernels.

At first CUDA use, ``nvcc`` compiles every ``.cu`` source under
``cavp_tpu_torch/csrc/`` (and nothing else) for ``sm_90a``, one compiler
process per source and all started together, and links the objects into
one shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``build/cavp_tpu_torch/`` at the repository root,
named by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads the existing file. Nothing here runs at
import time; on a machine without ``nvcc`` the build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cavp_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the driver API, for the TMA tensor maps of csrc/fusion_chain_sm90.cuh
LINK_FLAGS = ("-lcuda",)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("no nvcc found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built on this machine")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libcavp_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> Tuple[Path, str]:
    """Compile the kernels unless an up-to-date library exists.

    Returns (path, compiler log); the log holds ptxas's register and
    shared-memory report, and is empty when nothing was compiled."""
    so = library_path()
    if so.exists():
        return so, ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    cu, _ = _sources()
    objects = [BUILD_DIR / f"{tag}.{f.stem}.o" for f in cu]
    tmp = so.with_name(f"{tag}.tmp")
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(f)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for f, o in zip(cu, objects)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(f"[{f.name}]\n{out}" for f, out in zip(cu, logs))
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objects), *LINK_FLAGS],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    finally:
        for f in (*objects, tmp):
            f.unlink(missing_ok=True)
    return so, log


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernel library (once per process)."""
    so, _ = build_library()
    return ctypes.CDLL(str(so))
