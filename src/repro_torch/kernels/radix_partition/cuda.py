"""Python wrapper of the CUDA radix-partition kernel (``radix_partition.cu``).

Checks its input, allocates the outputs and scratch with ``torch.empty``,
launches the kernel on PyTorch's current stream through ``ctypes`` and
raises if the launch fails.  It never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..build import load

#: rows per tile, as ``kTileRows`` in the source
TILE_ROWS = 8192
#: largest bucket count: one warp's (nb,) int32 counters must fit in
#: shared memory
MAX_BUCKETS = 32768
#: shared memory the per-warp counter table may take in one block
_SMEM_BUDGET = 64 * 1024


def warps_for(num_buckets: int) -> int:
    """Warps per block: 8, halved until the (warps x nb) table fits."""
    warps = 8
    while warps > 1 and warps * num_buckets * 4 > _SMEM_BUDGET:
        warps //= 2
    return warps


class RadixPartitionCuda:
    """Callable wrapper; ``launches`` counts the calls that launched the
    kernel (nothing else adds to it)."""

    name = "radix_partition"
    source = "src/repro_torch/kernels/radix_partition/radix_partition.cu"
    #: the Pallas TPU kernel this one replaces (file:line of its function)
    replaces = "src/repro/kernels/radix_partition/radix_partition.py:57"

    def __init__(self):
        self.launches = 0
        self._fn = None
        self._err = None

    def _load(self):
        if self._fn is None:
            lib = load(self.name)
            fn = lib.radix_partition_launch
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = lib.radix_partition_error
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def __call__(self, dest: torch.Tensor, num_buckets: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        if not dest.is_cuda:
            raise ValueError("radix_partition CUDA kernel needs a CUDA "
                             f"tensor, got one on {dest.device}")
        if dest.dtype != torch.int32 or dest.dim() != 2:
            raise ValueError("radix_partition CUDA kernel needs (p, n) "
                             f"int32, got {tuple(dest.shape)} {dest.dtype}")
        if not dest.is_contiguous():
            raise ValueError("radix_partition CUDA kernel needs a "
                             "contiguous dest")
        if not 1 <= num_buckets <= MAX_BUCKETS:
            raise ValueError(f"num_buckets must be in [1, {MAX_BUCKETS}], "
                             f"got {num_buckets}")
        p, n = dest.shape
        if n >= 2 ** 31 - TILE_ROWS or p > 65535:
            raise ValueError(f"radix_partition CUDA kernel takes n < 2**31 "
                             f"and p <= 65535, got {tuple(dest.shape)}")
        ranks = torch.empty((p, n), dtype=torch.int32, device=dest.device)
        hist = torch.empty((p, num_buckets), dtype=torch.int32,
                           device=dest.device)
        if p == 0:
            return ranks, hist
        tiles = -(-n // TILE_ROWS)
        scratch = torch.empty((max(1, 2 * p * num_buckets * tiles),),
                              dtype=torch.int32, device=dest.device)
        fn = self._load()
        with torch.cuda.device(dest.device):
            stream = torch.cuda.current_stream(dest.device).cuda_stream
            code = fn(dest.data_ptr(), ranks.data_ptr(), hist.data_ptr(),
                      scratch.data_ptr(), p, n, num_buckets,
                      warps_for(num_buckets), stream)
        if code != 0:
            raise RuntimeError(
                f"radix_partition CUDA launch failed: "
                f"{self._err(code).decode()} (code {code})")
        self.launches += 1
        return ranks, hist


radix_partition_cuda = RadixPartitionCuda()
