"""Python wrapper of the CUDA segmented-sum kernels (``segmented_reduce.cu``).

Checks its inputs, picks the route from the caller's ``sorted_ids`` alone,
allocates the output and, for the sorted route, this call's scratch on the
inputs' device (``new_empty``, PyTorch's allocator on the current stream),
launches on that stream through ``ctypes`` and raises if the launch fails.
It never falls back to the other route or to the plain version.

Routes (``route_for``): ``sorted``, a single-pass reduce-by-key with
decoupled look-back for ids non-decreasing within each rank (every output
slot written once, no zero-fill, no atomics; float sums bit-identical from
run to run); ``atomic`` for ids in any order (the launcher zero-fills the
output and runs add into it with ``atomicAdd``).  ``kernel_constants``
reads the sorted route's tile rows from the built kernel, for tests at its
edges.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Tuple

import torch

from ..build import load
from ..common import LaunchCounter

#: value dtypes the kernels take, by launcher code
DTYPES = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
          torch.int64: 3}
ROUTES = ("atomic", "sorted")


def route_for(sorted_ids: bool) -> str:
    """``sorted`` when the caller states that the ids are non-decreasing
    within each rank, ``atomic`` otherwise."""
    return "sorted" if sorted_ids else "atomic"


class SegmentedSumCuda(LaunchCounter):
    """Callable wrapper; ``launches`` counts the calls that launched a
    kernel (nothing else adds to it), and ``route_launches`` the same calls
    by route."""

    name = "segmented_sum"
    source = "src/repro_torch/kernels/segmented_reduce/segmented_reduce.cu"
    #: the Pallas TPU kernel this one replaces (file:line of its function)
    replaces = "src/repro/kernels/segmented_reduce/segmented_reduce.py:50"

    def __init__(self):
        LaunchCounter.__init__(self, ROUTES)
        self._lib = None

    def _load(self):
        if self._lib is None:
            lib = load(self.name)
            lib.segmented_sum_launch.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
            lib.segmented_sum_launch.restype = ctypes.c_int
            lib.segmented_sum_sorted.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
            lib.segmented_sum_sorted.restype = ctypes.c_int
            lib.segmented_sum_sorted_scratch.argtypes = [ctypes.c_int] * 5
            lib.segmented_sum_sorted_scratch.restype = ctypes.c_longlong
            lib.segmented_sum_constants.argtypes = [
                ctypes.POINTER(ctypes.c_int)]
            lib.segmented_sum_constants.restype = None
            lib.segmented_sum_error.argtypes = [ctypes.c_int]
            lib.segmented_sum_error.restype = ctypes.c_char_p
            # ``_lib`` last: another thread reads it as "loaded"
            self._lib = lib
        return self._lib

    def kernel_constants(self) -> Tuple[int, int, int]:
        """(sorted tile rows of 4-byte values, of 8-byte values, slots per
        long-gap piece) as the built kernel has them."""
        out = (ctypes.c_int * 3)()
        self._load().segmented_sum_constants(out)
        return tuple(out)

    def __call__(self, seg_ids: torch.Tensor, values: torch.Tensor,
                 num_segments: int, *, sorted_ids: bool = False
                 ) -> torch.Tensor:
        """seg_ids (p, n) int32; values (p, n) or (p, n, C) float32,
        float64, int32 or int64, both contiguous on one card ->
        (p, num_segments) or (p, num_segments, C) in values' dtype.  With
        ``sorted_ids`` the ids must be non-decreasing within each rank
        (otherwise the sums are undefined)."""
        if not seg_ids.is_cuda or values.device != seg_ids.device:
            raise ValueError(f"segmented_sum CUDA kernel needs both inputs "
                             f"on one CUDA device, got {seg_ids.device} and "
                             f"{values.device}")
        if seg_ids.dtype != torch.int32 or seg_ids.dim() != 2:
            raise ValueError(f"segmented_sum CUDA kernel needs (p, n) int32 "
                             f"ids, got {tuple(seg_ids.shape)} "
                             f"{seg_ids.dtype}")
        if values.dim() not in (2, 3) or values.shape[:2] != seg_ids.shape:
            raise ValueError(f"segmented_sum: values {tuple(values.shape)} "
                             f"do not match ids {tuple(seg_ids.shape)}")
        if values.dtype not in DTYPES:
            raise ValueError(f"segmented_sum CUDA kernel takes "
                             f"{sorted(str(d) for d in DTYPES)} values, got "
                             f"{values.dtype}")
        if not (seg_ids.is_contiguous() and values.is_contiguous()):
            raise ValueError("segmented_sum CUDA kernel needs contiguous "
                             "inputs")
        p, n = seg_ids.shape
        c = values.shape[2] if values.dim() == 3 else 1
        if p > 65535 or max(n, num_segments) >= 2 ** 31 or num_segments < 0:
            raise ValueError(f"segmented_sum CUDA kernel takes p <= 65535 "
                             f"and 0 <= n, num_segments < 2**31, got "
                             f"p={p}, n={n}, num_segments={num_segments}")
        shape = (p, num_segments) + tuple(values.shape[2:])
        if p == 0 or n == 0 or num_segments == 0 or c == 0:
            return torch.zeros(shape, dtype=values.dtype,
                               device=values.device)
        route = route_for(sorted_ids)
        code = DTYPES[values.dtype]
        lib = self._load()
        dev = values.device
        out = values.new_empty(shape)
        # the launch goes to the current device: switch only when needed
        switch = (contextlib.nullcontext() if dev.index in (
            None, torch.cuda.current_device()) else torch.cuda.device(dev))
        with switch:
            # the raw handle: ``current_stream(dev).cuda_stream`` builds a
            # Stream object, several microseconds of host time a call
            stream = torch._C._cuda_getCurrentRawStream(dev.index)
            if route == "sorted":
                nbytes = lib.segmented_sum_sorted_scratch(
                    p, n, num_segments, c, code)
                if nbytes < 0:
                    raise ValueError(f"segmented_sum sorted route: the "
                                     f"long-gap list of p={p}, num_segments"
                                     f"={num_segments} passes 2**31 - 1 "
                                     f"pieces")
                # flags, ticket, partials and the gap list of this call
                # alone, on this stream: several streams may call at once
                scratch = values.new_empty((nbytes,), dtype=torch.uint8)
                err = lib.segmented_sum_sorted(
                    seg_ids.data_ptr(), values.data_ptr(), out.data_ptr(),
                    scratch.data_ptr(), p, n, num_segments, c, code, stream)
            else:
                err = lib.segmented_sum_launch(
                    seg_ids.data_ptr(), values.data_ptr(), out.data_ptr(),
                    p, n, num_segments, c, code, stream)
        if err != 0:
            raise RuntimeError(f"segmented_sum CUDA launch ({route}) "
                               f"failed: {lib.segmented_sum_error(err).decode()}"
                               f" (code {err})")
        self._count(route)
        return out


segmented_sum_cuda = SegmentedSumCuda()
