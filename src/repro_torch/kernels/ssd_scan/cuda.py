"""Python wrapper of the CUDA SSD-scan kernel (``ssd_scan.cu``).

Checks its inputs, allocates the outputs with ``torch.empty``, launches
the kernel on PyTorch's current stream through ``ctypes`` and raises if
the launch fails.  It never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..build import load

#: largest head dim P, state size N and chunk length the kernel takes
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 128


class SsdScanCuda:
    """Callable wrapper; ``launches`` counts the calls that launched the
    kernel (nothing else adds to it)."""

    name = "ssd_scan"
    source = "src/repro_torch/kernels/ssd_scan/ssd_scan.cu"
    #: the Pallas TPU kernel this one replaces (file:line of its function)
    replaces = "src/repro/kernels/ssd_scan/ssd_scan.py:81"

    def __init__(self):
        self.launches = 0
        self._fn = None
        self._err = None

    def _load(self):
        if self._fn is None:
            lib = load(self.name)
            fn = lib.ssd_scan_launch
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = lib.ssd_scan_error
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def __call__(self, x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (BH, T, P); dt: (BH, T, 1); a: (BH, 1); b, c: (BH, T, N);
        all float32, contiguous, on one card.  ``chunk`` is the chunk
        length itself (the dispatcher applies the JAX wrapper's rule).
        Returns (y (BH, T, P), h_final (BH, N, P))."""
        if x.dim() != 3 or b.dim() != 3:
            raise ValueError(f"ssd_scan CUDA kernel needs x (BH, T, P) and "
                             f"b, c (BH, T, N), got {tuple(x.shape)}, "
                             f"{tuple(b.shape)}")
        bh, t, p = x.shape
        n = b.shape[-1]
        want = {"x": (bh, t, p), "dt": (bh, t, 1), "a": (bh, 1),
                "b": (bh, t, n), "c": (bh, t, n)}
        for name, v in (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)):
            if not v.is_cuda or v.device != x.device:
                raise ValueError(f"ssd_scan CUDA kernel needs every input on "
                                 f"one CUDA device, got {name} on "
                                 f"{v.device}")
            if v.dtype != torch.float32 or not v.is_contiguous():
                raise ValueError(f"ssd_scan CUDA kernel needs contiguous "
                                 f"float32 inputs, got {name} {v.dtype}")
            if tuple(v.shape) != want[name]:
                raise ValueError(f"ssd_scan: {name} has shape "
                                 f"{tuple(v.shape)}, want {want[name]}")
        if not (1 <= p <= MAX_P and 1 <= n <= MAX_N
                and 1 <= chunk <= MAX_CHUNK and t >= 1):
            raise ValueError(f"ssd_scan CUDA kernel takes P <= {MAX_P}, "
                             f"N <= {MAX_N}, 1 <= chunk <= {MAX_CHUNK}, "
                             f"T >= 1; got P={p}, N={n}, chunk={chunk}, "
                             f"T={t}")
        y = torch.empty_like(x)
        h = torch.empty((bh, n, p), dtype=torch.float32, device=x.device)
        if bh == 0:
            return y, h
        fn = self._load()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                      b.data_ptr(), c.data_ptr(), y.data_ptr(),
                      h.data_ptr(), bh, t, p, n, chunk, stream)
        if code != 0:
            raise RuntimeError(f"ssd_scan CUDA launch failed: "
                               f"{self._err(code).decode()} (code {code})")
        self.launches += 1
        return y, h


ssd_scan_cuda = SsdScanCuda()
