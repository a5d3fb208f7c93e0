"""Build the package's CUDA sources (csrc/) into shared libraries at first use.

Each source is compiled by `nvcc` for sm_90a into one shared library with a
plain C interface, loaded with ctypes. The library lands in `build/kernels/`
beside the package, or in `$ORIET_COMPILE_CACHE/kernels` where that
variable names a directory (the port's counterpart of the JAX package's
persistent compile cache: the kernels are all the port compiles; read at
build time), in a directory keyed by a hash of the source, the shared
headers (csrc/*.cuh) and the flags, so an edited source or header rebuilds
and an unchanged one is reused.
`build_all` starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
CACHE_ENV = "ORIET_COMPILE_CACHE"

# kernel library name -> its source under csrc/
SOURCES: Dict[str, str] = {"qconv_int8": "qconv_int8.cu",
                           "qconv_grouped_int8": "qconv_grouped_int8.cu",
                           "qmatmul_int8": "qmatmul_int8.cu",
                           "qmatmul_int4": "qmatmul_int4.cu",
                           "decode_attn": "decode_attn.cu"}

# -split-compile=0: nvcc optimises a source's kernel instances in parallel,
# one thread a core (qconv_int8.cu's 96 build in 29 s rather than 60 s on an
# 8-core H100 host)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0")


@dataclasses.dataclass
class BuildInfo:
    path: str
    log: str  # nvcc's output (ptxas register and shared-memory lines); "" if reused


_BUILT: Dict[str, BuildInfo] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled from "
        f"{CSRC_DIR} at first use and need the CUDA toolkit (put nvcc on "
        "PATH or set CUDA_HOME)")


def build_dir() -> str:
    """Where the libraries go: `$ORIET_COMPILE_CACHE/kernels`, else
    BUILD_DIR."""
    cache = os.environ.get(CACHE_ENV)
    return os.path.join(cache, "kernels") if cache else BUILD_DIR


def _target(name: str) -> str:
    src = os.path.join(CSRC_DIR, SOURCES[name])
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"{name}-{h.hexdigest()[:16]}",
                        f"lib{name}.so")


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, BuildInfo]:
    """Compile every named kernel library (default: all) that is not built
    yet, one nvcc process per source, all running together."""
    names = list(SOURCES if names is None else names)
    procs = {}
    for name in names:
        if name in _BUILT:
            continue
        so = _target(name)
        if os.path.exists(so):
            _BUILT[name] = BuildInfo(so, "")
            continue
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, SOURCES[name])]
        procs[name] = (so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (so, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        _BUILT[name] = BuildInfo(so, log)
    return {n: _BUILT[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one kernel, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_all([name])[name].path)
        _LOADED[name] = lib
    return lib
