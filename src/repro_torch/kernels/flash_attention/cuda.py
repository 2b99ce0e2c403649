"""Python wrapper of the CUDA flash-attention kernel (``flash_attention.cu``).

Checks its inputs, picks the kernel's route, allocates the output with
``torch.empty``, launches the kernel on PyTorch's current stream through
``ctypes`` and raises if the launch fails.  It never falls back to the
plain version.

The route and launch geometry are computed here in Python, mirroring the
kernel's constants, so that the CPU tests reach them; the kernel exports
``flash_attention_geometry`` and the card's tests hold the two equal.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from ..build import load
from ..common import LaunchCounter

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: route name -> the kernel's route code
ROUTES = {"simt": 0, "wgmma": 1}
#: head dims whose bf16 rows fill the 128-byte swizzle of the wgmma route
WGMMA_HEAD_DIMS = (64, 128)
#: dynamic shared memory one block may take on an H100 (bytes)
SMEM_LIMIT = 232_448

# kernel constants (flash_attention.cu): queries per block, keys per tile,
# threads per block, K/V ring stages of the wgmma route
_SIMT_BQ, _SIMT_BK, _SIMT_THREADS = 64, 64, 256
_WGMMA_BQ, _WGMMA_BK, _WGMMA_THREADS, _WGMMA_STAGES = 128, 128, 384, 3


class Geometry(NamedTuple):
    route: str
    block_q: int       # queries per block
    threads: int       # threads per block
    smem_bytes: int    # dynamic shared memory per block
    q_tiles: int       # query tiles per (batch, head)
    grid: int          # blocks: q_tiles x B*Hq, flattened


def route_for(dtype: torch.dtype, d: int) -> str:
    """``wgmma`` (tensor cores, TMA) for bf16 at D = 64 or 128; ``simt``
    (IEEE f32 on CUDA cores) for f32, and for bf16 at D = 16, 32 or 256
    (whose ring of 128-key tiles would not fit shared memory)."""
    return ("wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS
            else "simt")


def smem_bytes(route: str, d: int) -> int:
    """Dynamic shared memory of one block of ``route`` at head dim ``d``."""
    if route == "wgmma":
        # Q tile + a ring of K and V tiles (bf16), 1 + 3 per slot
        # mbarriers, and 1024 bytes to round the base up to the swizzle's
        # alignment
        tile = 2 * d
        return (1024 + _WGMMA_BQ * tile
                + 2 * _WGMMA_STAGES * _WGMMA_BK * tile
                + 8 * (1 + 3 * _WGMMA_STAGES))
    # Q, K and V tiles of 64 rows and the 64 x 64 P tile, float32: two
    # blocks an SM up to D = 128, one at D = 256 (212,992 bytes)
    return 4 * (3 * _SIMT_BQ * d + _SIMT_BQ * _SIMT_BK)


def launch_geometry(b: int, hq: int, sq: int, d: int,
                    dtype: torch.dtype) -> Geometry:
    """Route, block shape, shared memory and the flattened grid of one
    call: ``q_tiles`` query tiles (the last one ragged) for each of the
    ``b * hq`` heads."""
    route = route_for(dtype, d)
    bq, threads = ((_WGMMA_BQ, _WGMMA_THREADS) if route == "wgmma"
                   else (_SIMT_BQ, _SIMT_THREADS))
    q_tiles = -(-sq // bq)
    return Geometry(route, bq, threads, smem_bytes(route, d), q_tiles,
                    q_tiles * b * hq)


def block_work(block: int, geo: Geometry, bhq: int):
    """(batch*head, query tile) that block ``block`` computes: blocks go
    through the query tiles from the last (the heaviest under the causal
    mask) to the first, every head of one tile before the next tile."""
    return block % bhq, geo.q_tiles - 1 - block // bhq


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> Geometry:
    """Raise ``ValueError`` for what the kernel does not take; the launch
    geometry of a call it takes.  Reads only devices, dtypes and shapes,
    so the operator's fake implementation runs it too."""
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
    geo = launch_geometry(b, hq, sq, d, q.dtype)
    if geo.grid > 2**31 - 1:
        raise ValueError(f"flash_attention CUDA kernel takes at most "
                         f"2**31 - 1 blocks, got {geo.grid}")
    return geo


class FlashAttentionCuda(LaunchCounter):
    """Callable wrapper; ``launches`` counts the calls that launched the
    kernel (nothing else adds to it), and ``route_launches`` the same
    calls by route."""

    name = "flash_attention"
    source = "src/repro_torch/kernels/flash_attention/flash_attention.cu"
    #: the Pallas TPU kernel this one replaces (file:line of its function)
    replaces = "src/repro/kernels/flash_attention/flash_attention.py:78"

    def __init__(self):
        LaunchCounter.__init__(self, ROUTES)
        self._fn = None
        self._err = None
        self._geo = None

    def _load(self):
        if self._fn is None:
            lib = load(self.name)
            fn = lib.flash_attention_launch
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            err = lib.flash_attention_error
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            geo = lib.flash_attention_geometry
            geo.argtypes = [ctypes.c_int, ctypes.c_int,
                            ctypes.POINTER(ctypes.c_int)]
            geo.restype = ctypes.c_int
            # ``_fn`` last: another thread reads it as "loaded"
            self._err, self._geo, self._fn = err, geo, fn
        return self._fn

    def kernel_geometry(self, route: str, d: int):
        """The kernel's own (queries per block, threads, shared bytes) for
        ``route`` at head dim ``d``, or None if it does not take them."""
        self._load()
        out = (ctypes.c_int * 3)()
        if self._geo(ROUTES[route], d, out) != 0:
            return None
        return tuple(out)

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool = True, scale: Optional[float] = None
                 ) -> torch.Tensor:
        """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), contiguous, all
        float32 or all bfloat16 on one card -> (B, Hq, Sq, D)."""
        geo = check_inputs(q, k, v, causal)
        b, hq, sq, d = q.shape
        hkv, sk = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        if b * hq * sq == 0:
            return out
        scale = scale if scale is not None else 1.0 / math.sqrt(d)
        fn = self._load()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, hq, hkv, sq, sk, d, int(causal),
                      float(scale), _DTYPES[q.dtype], ROUTES[geo.route],
                      stream)
        if code != 0:
            raise RuntimeError(
                f"flash_attention CUDA launch failed: "
                f"{self._err(code).decode()} (code {code})")
        self._count(geo.route)
        return out


flash_attention_cuda = FlashAttentionCuda()
