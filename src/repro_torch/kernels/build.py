"""Build the port's CUDA kernels from the sources in this package.

Each kernel is one ``.cu`` file with a plain C interface, compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries go
into ``src/repro_torch/_build/`` (listed in ``.gitignore``), named by a
hash of the source and flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing here runs at import time: a kernel
builds on its first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

#: kernel name -> CUDA source, relative to this package
SOURCES: Dict[str, str] = {
    "radix_partition": os.path.join("radix_partition", "radix_partition.cu"),
    "segmented_sum": os.path.join("segmented_reduce", "segmented_reduce.cu"),
    "flash_attention": os.path.join("flash_attention", "flash_attention.cu"),
    "ssd_scan": os.path.join("ssd_scan", "ssd_scan.cu"),
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> str:
    src = os.path.join(_HERE, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile one kernel with nvcc unless its library is already built;
    returns the library's path.  The compiler's output goes to
    ``_build/<name>.log``."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_HERE, SOURCES[name])]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v`` register and shared-memory
    report) from the last build of ``name``, or "" if it was not built
    in this checkout."""
    path = os.path.join(BUILD_DIR, f"{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build(name))
    return _loaded[name]
