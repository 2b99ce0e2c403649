"""Python wrapper of the CUDA SSD-scan kernels (``ssd_scan.cu``).

Checks its inputs, allocates the outputs and the two scratch buffers
(``cum`` (BH, T) float64, ``state`` (BH, NC, N, P) float32) with
``torch.empty``, launches the three kernels (chunk state, state pass,
chunk scan) on PyTorch's current stream through one ``ctypes`` call and
raises if a launch fails.  It never falls back to the plain version.

The launch geometry and scratch sizes are computed here in Python,
mirroring the kernel's constants, so that the CPU tests reach them; the
kernel exports ``ssd_scan_geometry`` and the card's tests hold the two
equal.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..build import load
from ..common import LaunchCounter

#: largest head dim P, state size N and chunk length the kernel takes
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 128
#: dynamic shared memory one block may take on an H100 (bytes)
SMEM_LIMIT = 232_448

# kernel constants (ssd_scan.cu): threads per chunk-state block and per
# state-pass and chunk-scan block, rows of a chunk-scan block, state
# columns per slice of C and B, state entries per state-pass block, chunk
# rows per chunk-state stage
_STATE_THREADS, _THREADS = 128, 256
_HALF, _K_SLICE, _STATE_TILE, _STATE_ROWS = 64, 32, 1024, 32
_L, _NM, _PM = MAX_CHUNK, MAX_N, MAX_P


class Geometry(NamedTuple):
    n_chunks: int            # NC = ceil(T / chunk)
    halves: int              # 64-row chunk-scan blocks per chunk
    state_threads: int       # threads per ssd_chunk_state block
    threads: int             # threads per ssd_state_pass, ssd_chunk_scan block
    state_blocks: int        # ssd_chunk_state: BH x NC
    pass_blocks: int         # ssd_state_pass: BH x ceil(N P / 1024)
    scan_blocks: int         # ssd_chunk_scan: BH x NC x halves
    state_smem: int          # dynamic shared bytes of ssd_chunk_state
    scan_smem: int           # dynamic shared bytes of ssd_chunk_scan
    cum_shape: Tuple[int, int]                 # (BH, T) float64
    state_shape: Tuple[int, int, int, int]     # (BH, NC, N, P) float32


def smem_bytes() -> Tuple[int, int]:
    """Dynamic shared memory of one ``ssd_chunk_state`` block (cum in
    float64, two stages of 32 rows of B and X, dt, w) and of one
    ``ssd_chunk_scan`` block (two stages of C, B and h_start slices, then
    cum in float64 and dt)."""
    state = 8 * _L + 4 * (2 * _STATE_ROWS * (_NM + _PM) + 2 * _L)
    stage = (_HALF + _L) * (_K_SLICE + 4) + _K_SLICE * _PM
    return state, 4 * 2 * stage + 8 * _L + 4 * _L


def launch_geometry(bh: int, t: int, p: int, n: int, chunk: int
                    ) -> Geometry:
    """Blocks of the three kernels and the scratch shapes of one call;
    ``chunk`` is the chunk length itself (the last chunk may be ragged)."""
    nc = -(-t // chunk)
    halves = -(-chunk // _HALF)
    state_smem, scan_smem = smem_bytes()
    return Geometry(nc, halves, _STATE_THREADS, _THREADS, bh * nc,
                    bh * -(-(n * p) // _STATE_TILE), bh * nc * halves,
                    state_smem, scan_smem, (bh, t), (bh, nc, n, p))


def check_inputs(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, chunk: int) -> Geometry:
    """Raise ``ValueError`` for what the kernels do not take; the launch
    geometry of a call they take.  Reads only devices, dtypes and shapes,
    so the operator's fake implementation runs it too."""
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
    geo = launch_geometry(bh, t, p, n, chunk)
    if geo.scan_blocks > 2**31 - 1:
        raise ValueError(f"ssd_scan CUDA kernel takes at most 2**31 - 1 "
                         f"blocks, got {geo.scan_blocks}")
    return geo


class SsdScanCuda(LaunchCounter):
    """Callable wrapper; ``launches`` counts the calls that launched the
    kernels (one per call, for its three kernels; nothing else adds to
    it)."""

    name = "ssd_scan"
    source = "src/repro_torch/kernels/ssd_scan/ssd_scan.cu"
    #: the Pallas TPU kernel this one replaces (file:line of its function)
    replaces = "src/repro/kernels/ssd_scan/ssd_scan.py:81"
    #: the CUDA kernels one call launches, in order
    kernels = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")

    def __init__(self):
        LaunchCounter.__init__(self)
        self._fn = None
        self._err = None
        self._geo = None

    def _load(self):
        if self._fn is None:
            lib = load(self.name)
            fn = lib.ssd_scan_launch
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = lib.ssd_scan_error
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            geo = lib.ssd_scan_geometry
            geo.argtypes = [ctypes.POINTER(ctypes.c_int)]
            geo.restype = ctypes.c_int
            # ``_fn`` last: another thread reads it as "loaded"
            self._err, self._geo, self._fn = err, geo, fn
        return self._fn

    def kernel_geometry(self) -> Tuple[int, ...]:
        """The kernel's own (chunk-state threads, state-pass and chunk-scan
        threads, rows per chunk-scan block, entries per state-pass block,
        chunk-state shared bytes, chunk-scan shared bytes)."""
        self._load()
        out = (ctypes.c_int * 6)()
        self._geo(out)
        return tuple(out)

    def __call__(self, x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (BH, T, P); dt: (BH, T, 1); a: (BH, 1); b, c: (BH, T, N);
        all float32, contiguous, on one card.  ``chunk`` is the chunk
        length itself (the dispatcher applies the JAX wrapper's rule).
        Returns (y (BH, T, P), h_final (BH, N, P))."""
        geo = check_inputs(x, dt, a, b, c, chunk)
        bh, t, p = x.shape
        n = b.shape[-1]
        y = torch.empty_like(x)
        h = torch.empty((bh, n, p), dtype=torch.float32, device=x.device)
        if bh == 0:
            return y, h
        cum = torch.empty(geo.cum_shape, dtype=torch.float64,
                          device=x.device)
        state = torch.empty(geo.state_shape, dtype=torch.float32,
                            device=x.device)
        fn = self._load()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                      b.data_ptr(), c.data_ptr(), y.data_ptr(),
                      h.data_ptr(), cum.data_ptr(), state.data_ptr(), bh, t,
                      p, n, chunk, stream)
        if code != 0:
            raise RuntimeError(f"ssd_scan CUDA launch failed: "
                               f"{self._err(code).decode()} (code {code})")
        self._count()
        return y, h


ssd_scan_cuda = SsdScanCuda()
