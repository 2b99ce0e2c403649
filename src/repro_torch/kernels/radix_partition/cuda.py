"""Python wrapper of the CUDA radix-partition kernels (``radix_partition.cu``).

Checks its input, picks the route by the bucket count alone, allocates the
outputs and scratch with ``torch.empty``, launches on PyTorch's current
stream through ``ctypes`` and raises if the launch fails.  It never falls
back to the other route or to the plain version.

Routes (``route_for``): ``onepass``, one launch with decoupled look-back,
for nb up to ``ONEPASS_MAX_BUCKETS`` (every shuffle of p <= 255 ranks,
nb = p + 1); ``threepass`` (count, scan, rank) above it, up to
``MAX_BUCKETS``.  The constants mirror the kernel's; ``kernel_constants``
reads the kernel's own, and the card's tests hold the two equal.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..build import load
from ..common import LaunchCounter

#: rows per tile of the threepass route, as ``kTileRows`` in the source
TILE_ROWS = 8192
#: rows per tile of the onepass route (256 threads x 32 rows), ``kOneTile``
ONEPASS_TILE_ROWS = 8192
#: largest bucket count of the onepass route (one look-back thread per
#: bucket), ``kMaxOneBuckets``
ONEPASS_MAX_BUCKETS = 256
#: largest bucket count: one warp's (nb,) int32 counters must fit in
#: shared memory
MAX_BUCKETS = 32768
ROUTES = ("onepass", "threepass")
#: shared memory the per-warp counter table may take in one block
_SMEM_BUDGET = 64 * 1024


def route_for(num_buckets: int) -> str:
    """``onepass`` up to ``ONEPASS_MAX_BUCKETS`` buckets, ``threepass``
    above: there a look-back over nb status words per tile would cost more
    than the two extra launches."""
    return "onepass" if num_buckets <= ONEPASS_MAX_BUCKETS else "threepass"


def onepass_scratch_bytes(p: int, n: int, num_buckets: int) -> int:
    """Scratch of one onepass call: a 64-bit status word per (rank,
    bucket, tile) and the tile ticket."""
    tiles = -(-n // ONEPASS_TILE_ROWS)
    return 8 * (p * num_buckets * tiles + 1)


def warps_for(num_buckets: int) -> int:
    """Warps per threepass block: 8, halved until the (warps x nb) table
    fits."""
    warps = 8
    while warps > 1 and warps * num_buckets * 4 > _SMEM_BUDGET:
        warps //= 2
    return warps


def check_inputs(dest: torch.Tensor, num_buckets: int) -> None:
    """Raise ``ValueError`` for what the kernels do not take.  Reads only
    the device, dtype and shape, so the operator's fake implementation
    runs it too."""
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
    if (route_for(num_buckets) == "onepass"
            and p * -(-n // ONEPASS_TILE_ROWS) >= 2 ** 31):
        raise ValueError(f"radix_partition onepass route takes fewer than "
                         f"2**31 tiles, got {tuple(dest.shape)}")


class RadixPartitionCuda(LaunchCounter):
    """Callable wrapper; ``launches`` counts the calls that launched the
    kernel (nothing else adds to it), and ``route_launches`` the same calls
    by route."""

    name = "radix_partition"
    source = "src/repro_torch/kernels/radix_partition/radix_partition.cu"
    #: the Pallas TPU kernel this one replaces (file:line of its function)
    replaces = "src/repro/kernels/radix_partition/radix_partition.py:57"

    def __init__(self):
        LaunchCounter.__init__(self, ROUTES)
        self._lib = None

    def _load(self):
        if self._lib is None:
            lib = load(self.name)
            for fn in (lib.radix_partition_onepass,
                       lib.radix_partition_launch):
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.radix_partition_onepass_scratch.argtypes = [ctypes.c_int] * 3
            lib.radix_partition_onepass_scratch.restype = ctypes.c_longlong
            lib.radix_partition_constants.argtypes = [
                ctypes.POINTER(ctypes.c_int)]
            lib.radix_partition_constants.restype = None
            lib.radix_partition_error.argtypes = [ctypes.c_int]
            lib.radix_partition_error.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def kernel_constants(self) -> Tuple[int, int, int]:
        """(onepass tile rows, onepass largest nb, threepass tile rows) as
        the built kernel has them."""
        out = (ctypes.c_int * 3)()
        self._load().radix_partition_constants(out)
        return tuple(out)

    def kernel_scratch_bytes(self, p: int, n: int, num_buckets: int) -> int:
        """The onepass scratch size as the built kernel computes it."""
        return int(self._load().radix_partition_onepass_scratch(
            p, n, num_buckets))

    def __call__(self, dest: torch.Tensor, num_buckets: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        check_inputs(dest, num_buckets)
        p, n = dest.shape
        ranks = torch.empty((p, n), dtype=torch.int32, device=dest.device)
        hist = torch.empty((p, num_buckets), dtype=torch.int32,
                           device=dest.device)
        if p == 0:
            return ranks, hist
        route = route_for(num_buckets)
        if route == "onepass":
            scratch = torch.empty((onepass_scratch_bytes(p, n, num_buckets),),
                                  dtype=torch.uint8, device=dest.device)
            vec = (n % 4 == 0 and dest.data_ptr() % 16 == 0
                   and ranks.data_ptr() % 16 == 0)
            fn, last = self._load().radix_partition_onepass, int(vec)
        else:
            tiles = -(-n // TILE_ROWS)
            scratch = torch.empty((max(1, 2 * p * num_buckets * tiles),),
                                  dtype=torch.int32, device=dest.device)
            fn, last = (self._load().radix_partition_launch,
                        warps_for(num_buckets))
        with torch.cuda.device(dest.device):
            stream = torch.cuda.current_stream(dest.device).cuda_stream
            code = fn(dest.data_ptr(), ranks.data_ptr(), hist.data_ptr(),
                      scratch.data_ptr(), p, n, num_buckets, last, stream)
        if code != 0:
            raise RuntimeError(
                f"radix_partition CUDA launch ({route}) failed: "
                f"{self._lib.radix_partition_error(code).decode()} "
                f"(code {code})")
        self._count(route)
        return ranks, hist


radix_partition_cuda = RadixPartitionCuda()
