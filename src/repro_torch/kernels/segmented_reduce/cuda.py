"""Python wrapper of the CUDA segmented-sum kernel (``segmented_reduce.cu``).

Checks its inputs, allocates the output with ``torch.empty`` (the launcher
zero-fills it), launches the kernel on PyTorch's current stream through
``ctypes`` and raises if the launch fails.  It never falls back to the
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import load
from ..common import LaunchCounter

#: value dtypes the kernel's atomicAdd overloads cover, by launcher code
DTYPES = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
          torch.int64: 3}


class SegmentedSumCuda(LaunchCounter):
    """Callable wrapper; ``launches`` counts the calls that launched the
    kernel (nothing else adds to it)."""

    name = "segmented_sum"
    source = "src/repro_torch/kernels/segmented_reduce/segmented_reduce.cu"
    #: the Pallas TPU kernel this one replaces (file:line of its function)
    replaces = "src/repro/kernels/segmented_reduce/segmented_reduce.py:50"

    def __init__(self):
        LaunchCounter.__init__(self)
        self._fn = None
        self._err = None

    def _load(self):
        if self._fn is None:
            lib = load(self.name)
            fn = lib.segmented_sum_launch
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = lib.segmented_sum_error
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            # ``_fn`` last: another thread reads it as "loaded"
            self._err, self._fn = err, fn
        return self._fn

    def __call__(self, seg_ids: torch.Tensor, values: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
        """seg_ids (p, n) int32; values (p, n) or (p, n, C) float32,
        float64, int32 or int64, both contiguous on one card ->
        (p, num_segments) or (p, num_segments, C) in values' dtype."""
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
        out = torch.empty(shape, dtype=values.dtype, device=values.device)
        fn = self._load()
        with torch.cuda.device(values.device):
            stream = torch.cuda.current_stream(values.device).cuda_stream
            code = fn(seg_ids.data_ptr(), values.data_ptr(), out.data_ptr(),
                      p, n, num_segments, c, DTYPES[values.dtype], stream)
        if code != 0:
            raise RuntimeError(f"segmented_sum CUDA launch failed: "
                               f"{self._err(code).decode()} (code {code})")
        self._count()
        return out


segmented_sum_cuda = SegmentedSumCuda()
