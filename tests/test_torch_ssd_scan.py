"""The port's SSD scan against the JAX package's.

On a CPU tensor ``repro_torch.kernels.ssd_scan`` runs the plain chunked
version (``ssd_scan_chunked``, with the JAX wrapper's chunk rule).  It
must match the JAX wrapper, whose Pallas TPU kernel runs here in
interpret mode (the shape sweep of ``tests/test_kernels.py``), the JAX
chunked version and the naive recurrence of both packages.  Tolerance
3e-3, as ``tests/test_kernels.py`` (the chunked form sums in another
order than the recurrence).  The CUDA kernel's own check against the
plain version is ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as jax_ssd
from repro.kernels.ssd_scan import ssd_scan_chunked_jnp as jax_chunked
from repro.kernels.ssd_scan import ssd_scan_ref as jax_ref
from repro_torch.kernels import (ssd_scan, ssd_scan_chunked, ssd_scan_cuda,
                                 ssd_scan_ref)

ATOL = 3e-3
SWEEP = [(2, 64, 16, 8, 32), (3, 256, 16, 8, 64), (1, 100, 8, 4, 32),
         (4, 128, 64, 128, 128)]


def _inputs(bh, t, p, n, seed=0):
    rng = np.random.default_rng(seed + bh * t + p + n)
    return (rng.standard_normal((bh, t, p)).astype(np.float32),
            (rng.random((bh, t, 1)) * 0.1 + 0.01).astype(np.float32),
            (-rng.random((bh, 1)) - 0.05).astype(np.float32),
            rng.standard_normal((bh, t, n)).astype(np.float32),
            rng.standard_normal((bh, t, n)).astype(np.float32))


@pytest.mark.parametrize("bh,t,p,n,chunk", SWEEP)
def test_plain_matches_jax_kernel_and_refs(bh, t, p, n, chunk):
    args = _inputs(bh, t, p, n)
    y, h = ssd_scan(*map(torch.from_numpy, args), chunk=chunk)
    assert y.shape == (bh, t, p) and h.shape == (bh, n, p)
    y_k, h_k = jax_ssd(*map(jnp.asarray, args), chunk=chunk)
    y_r, h_r = jax_ref(*map(jnp.asarray, args))
    for want_y, want_h in ((y_k, h_k), (y_r, h_r)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=ATOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL)


@pytest.mark.parametrize("bh,t,p,n,chunk", SWEEP + [(2, 20, 8, 4, 32)])
def test_chunked_and_naive_match_jax(bh, t, p, n, chunk):
    # same algorithm, same chunking: float32 rounding only
    args = _inputs(bh, t, p, n, seed=1)
    y, h = ssd_scan_chunked(*map(torch.from_numpy, args), chunk=chunk)
    y_j, h_j = jax_chunked(*map(jnp.asarray, args), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), atol=1e-4)
    y, h = ssd_scan_ref(*map(torch.from_numpy, args))
    y_j, h_j = jax_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), atol=1e-4)


def test_ragged_last_chunk_is_inert():
    # t = 100 with chunk 32: the last chunk holds 4 steps; zero-dt
    # padding must leave y and the final state as the recurrence has them
    args = [torch.from_numpy(a) for a in _inputs(2, 100, 8, 4, seed=2)]
    y, h = ssd_scan(*args, chunk=32)
    y_r, h_r = ssd_scan_ref(*args)
    np.testing.assert_allclose(y.numpy(), y_r.numpy(), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), h_r.numpy(), atol=ATOL)


def test_cuda_wrapper_refuses_cpu_tensors():
    args = [torch.from_numpy(a) for a in _inputs(1, 8, 4, 4)]
    before = ssd_scan_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(*args, chunk=8)
    assert ssd_scan_cuda.launches == before


# ---------------------------------------------------------------------- #
# what surrounds the CUDA kernels: launch geometry, scratch, refusals
# ---------------------------------------------------------------------- #
from repro_torch.kernels.ssd_scan import cuda as ssd_cuda  # noqa: E402


@pytest.mark.parametrize("chunk", [8, 32, 64, 100, 128])
@pytest.mark.parametrize("t", [1, 13, 100, 333, 1013, 4096])
def test_geometry_chunks_and_scratch(t, chunk):
    # NC chunks cover T, the last one ragged; the scratch holds cum for
    # every step and one N x P state per chunk; one chunk-scan block per
    # 64 rows of a chunk
    bh, p, n = 3, 64, 128
    geo = ssd_cuda.launch_geometry(bh, t, p, n, chunk)
    nc = geo.n_chunks
    assert (nc - 1) * chunk < t <= nc * chunk
    assert geo.cum_shape == (bh, t)
    assert geo.state_shape == (bh, nc, n, p)
    assert geo.halves == (1 if chunk <= 64 else 2)
    assert geo.state_blocks == bh * nc
    assert geo.scan_blocks == bh * nc * geo.halves
    assert geo.pass_blocks == bh * 8          # N P = 8192 entries, 1024 each


def test_geometry_main_shape():
    # the mamba2-780m prefill at a 4096-token prompt: the grid scales with
    # BH x chunks (a block per sequence would be 192 blocks), and the
    # state scratch is 201 MB
    geo = ssd_cuda.launch_geometry(192, 4096, 64, 128, 128)
    assert (geo.n_chunks, geo.halves) == (32, 2)
    assert (geo.state_blocks, geo.pass_blocks, geo.scan_blocks) == (
        6144, 1536, 12288)
    assert 4 * np.prod(geo.state_shape) == 201_326_592
    assert 8 * np.prod(geo.cum_shape) == 6_291_456


def test_geometry_past_65535_blocks():
    # one flattened grid: BH x NC may pass a grid's y limit
    geo = ssd_cuda.launch_geometry(16384, 512, 4, 4, 8)
    assert geo.state_blocks == geo.scan_blocks == 16384 * 64 > 65_535
    assert geo.pass_blocks == 16384


def test_shared_memory_within_budget():
    # each block within the 227 KB a block may take, and at least 16 warps
    # on an SM for both kernels that use shared memory: an H100 SM holds
    # 228 KB for its blocks, each of which also reserves 1 KB
    geo = ssd_cuda.launch_geometry(1, 128, 64, 128, 128)
    assert geo.state_smem <= ssd_cuda.SMEM_LIMIT
    assert geo.scan_smem <= ssd_cuda.SMEM_LIMIT
    for smem, threads, min_blocks in ((geo.state_smem, geo.state_threads, 4),
                                      (geo.scan_smem, geo.threads, 2)):
        blocks = 233_472 // (smem + 1024)
        assert blocks >= min_blocks          # the kernels' launch bounds
        assert min(blocks, min_blocks) * threads // 32 >= 16
    assert ssd_cuda.smem_bytes() == (geo.state_smem, geo.scan_smem)


def test_wrapper_refuses_before_allocating(monkeypatch):
    # CPU tensors and bad shapes raise ValueError before any buffer is
    # allocated and before the kernel is built or counted
    def no_alloc(*args, **kwargs):
        raise AssertionError("allocated before checking its inputs")
    monkeypatch.setattr(torch, "empty", no_alloc)
    monkeypatch.setattr(torch, "empty_like", no_alloc)
    args = [torch.from_numpy(a) for a in _inputs(1, 8, 4, 4)]
    before = ssd_scan_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(*args, chunk=8)
    with pytest.raises(ValueError, match="BH, T, P"):
        ssd_scan_cuda(args[0][0], *args[1:], chunk=8)
    assert ssd_scan_cuda.launches == before
    assert ssd_scan_cuda._fn is None


def test_ptxas_report_names(monkeypatch):
    # the build report names template kernels up to their arguments and
    # plain kernels by their bare names
    from repro_torch.kernels import build
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__e04906"
        "59_11_ssd_scan_cu_18d893fe14ssd_chunk_scanEPKfS1_S1_S1_PKdS1_Pfiiii"
        "iii' for 'sm_90a'",
        "    16 bytes stack frame, 16 bytes spill stores, 92 bytes spill "
        "loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__e04906"
        "59_18_flash_attention_cu_18d893fe11flash_wgmmaILi128EEEvPKfi' for "
        "'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers"])
    monkeypatch.setattr(build, "build_log", lambda name: log)
    assert build.ptxas_report("any") == [("ssd_chunk_scan", 128, 16, 92),
                                         ("flash_wgmmaILi128", 168, 0, 0)]
