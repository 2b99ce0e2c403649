"""Python wrapper of the CUDA flash-attention kernel (``flash_attention.cu``).

Checks its inputs, allocates the output with ``torch.empty``, launches the
kernel on PyTorch's current stream through ``ctypes`` and raises if the
launch fails.  It never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..build import load

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class FlashAttentionCuda:
    """Callable wrapper; ``launches`` counts the calls that launched the
    kernel (nothing else adds to it)."""

    name = "flash_attention"
    source = "src/repro_torch/kernels/flash_attention/flash_attention.cu"
    #: the Pallas TPU kernel this one replaces (file:line of its function)
    replaces = "src/repro/kernels/flash_attention/flash_attention.py:78"

    def __init__(self):
        self.launches = 0
        self._fn = None
        self._err = None

    def _load(self):
        if self._fn is None:
            lib = load(self.name)
            fn = lib.flash_attention_launch
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            err = lib.flash_attention_error
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool = True, scale: Optional[float] = None
                 ) -> torch.Tensor:
        """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), contiguous, all
        float32 or all bfloat16 on one card -> (B, Hq, Sq, D)."""
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not t.is_cuda or t.device != q.device:
                raise ValueError(f"flash_attention CUDA kernel needs q, k, v "
                                 f"on one CUDA device, got {name} on "
                                 f"{t.device}")
            if t.dtype != q.dtype or t.dtype not in _DTYPES:
                raise ValueError(f"flash_attention CUDA kernel takes all "
                                 f"float32 or all bfloat16, got {name} "
                                 f"{t.dtype} with q {q.dtype}")
            if t.dim() != 4 or not t.is_contiguous():
                raise ValueError(f"flash_attention CUDA kernel needs "
                                 f"contiguous 4-d tensors, got {name} "
                                 f"{tuple(t.shape)}")
        b, hq, sq, d = q.shape
        bk, hkv, sk, dk = k.shape
        if (bk, dk) != (b, d) or tuple(v.shape) != tuple(k.shape):
            raise ValueError(f"flash_attention shapes disagree: q "
                             f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                             f"{tuple(v.shape)}")
        if d not in HEAD_DIMS:
            raise ValueError(f"flash_attention CUDA kernel takes head dims "
                             f"{HEAD_DIMS}, got {d}")
        if hkv == 0 or hq % hkv:
            raise ValueError(f"q heads {hq} are not a multiple of kv heads "
                             f"{hkv}")
        if sk == 0 or (causal and sq > sk):
            raise ValueError(f"flash_attention needs 1 <= Sk and, when "
                             f"causal, Sq <= Sk; got Sq={sq}, Sk={sk}")
        if b * hq > 65535:
            raise ValueError(f"flash_attention CUDA kernel takes B*Hq <= "
                             f"65535, got {b * hq}")
        out = torch.empty_like(q)
        if b * hq * sq == 0:
            return out
        scale = scale if scale is not None else 1.0 / math.sqrt(d)
        fn = self._load()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, hq, hkv, sq, sk, d, int(causal),
                      float(scale), _DTYPES[q.dtype], stream)
        if code != 0:
            raise RuntimeError(
                f"flash_attention CUDA launch failed: "
                f"{self._err(code).decode()} (code {code})")
        self.launches += 1
        return out


flash_attention_cuda = FlashAttentionCuda()
