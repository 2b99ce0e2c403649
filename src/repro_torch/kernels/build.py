"""Build the port's CUDA kernels from the sources in this package.

Each kernel is one ``.cu`` file with a plain C interface, compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries go
into ``src/repro_torch/_build/`` (listed in ``.gitignore``), named by a
hash of the source and flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing here runs at import time: a kernel
builds on its first use.

Threads may build and load at once (the query scheduler's workers do):
each kernel name has a lock, so one thread runs ``nvcc`` while the others
wait for its library, and the temporary output is named by process and
thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Tuple

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
#: one lock per kernel name, held across its build and load
_locks: Dict[str, threading.Lock] = {name: threading.Lock()
                                     for name in SOURCES}


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
    with _locks[name]:
        return _build_locked(name)


def _build_locked(name: str) -> str:
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
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


def ptxas_report(name: str) -> List[Tuple[str, int, int, int]]:
    """(kernel function, registers, spill-store bytes, spill-load bytes)
    of each function in the last build's ``-Xptxas -v`` report; names
    are the mangled ones cut to the template arguments (for example
    ``flash_wgmmaILi128`` for ``flash_wgmma<128>``), or to the bare name
    of a function that is not a template (``ssd_chunk_scan``)."""
    out, fn, spills = [], None, (0, 0)
    for line in build_log(name).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_\w{8}\d+", "",
                        m.group(1))
            fn = (fn.split("EEEv")[0] if "EEEv" in fn
                  else re.match(r"[a-z0-9_]*", fn).group(0) or fn)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            out.append((fn, int(m.group(1)), *spills))
            fn, spills = None, (0, 0)
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    with _locks[name]:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(_build_locked(name))
        return _loaded[name]
