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
