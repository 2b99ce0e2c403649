"""The port's plain radix partition against the JAX package's kernels.

``repro_torch.kernels.radix_partition`` on a CPU tensor runs the plain
PyTorch version (dense and blocked segment cumsum).  It must equal the
JAX sort-based oracle ``radix_partition_ref`` and the Pallas TPU kernel
``radix_partition_pallas`` run in interpret mode (through its padding
wrapper), exactly: ranks and histograms are integers.  The CUDA kernel's
own check against the plain version is ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.radix_partition import radix_partition as jax_radix
from repro.kernels.radix_partition import radix_partition_ref as jax_ref
from repro_torch.kernels import radix_partition, radix_partition_cuda
from repro_torch.kernels.radix_partition import (radix_partition_blocked,
                                                 radix_partition_dense,
                                                 radix_partition_ref)


def make_dest(p, n, nb, seed=0):
    return np.random.default_rng(seed + n + nb).integers(
        0, nb, (p, n)).astype(np.int32)


# nb <= 9 (the shuffle's p + 1) and nb >= 1024; n off the 256-row block
# and n = 0
CASES = [(3, 1000, 9), (2, 257, 2), (1, 0, 9), (2, 300, 1024),
         (1, 700, 1536), (4, 64, 1)]


@pytest.mark.parametrize("p,n,nb", CASES)
def test_plain_equals_jax_ref(p, n, nb):
    d = make_dest(p, n, nb)
    ranks, hist = radix_partition(torch.as_tensor(d), nb)
    for r in range(p):
        want_r, want_h = jax_ref(jnp.asarray(d[r]), nb)
        np.testing.assert_array_equal(ranks[r].numpy(), np.asarray(want_r))
        np.testing.assert_array_equal(hist[r].numpy(), np.asarray(want_h))


@pytest.mark.parametrize("p,n,nb", [(2, 1000, 9), (1, 300, 1024),
                                    (1, 0, 9)])
def test_plain_equals_pallas_interpret(p, n, nb):
    d = make_dest(p, n, nb, seed=1)
    ranks, hist = radix_partition(torch.as_tensor(d), nb)
    for r in range(p):
        want_r, want_h = jax_radix(jnp.asarray(d[r]), nb, impl="pallas",
                                   interpret=True)
        np.testing.assert_array_equal(ranks[r].numpy(), np.asarray(want_r))
        np.testing.assert_array_equal(hist[r].numpy(), np.asarray(want_h))


@pytest.mark.parametrize("block_rows", [64, 256, 4096])
@pytest.mark.parametrize("p,n,nb", [(3, 1000, 9), (2, 777, 1024)])
def test_dense_equals_blocked(p, n, nb, block_rows):
    d = torch.as_tensor(make_dest(p, n, nb, seed=2))
    dr, dh = radix_partition_dense(d, nb)
    br, bh = radix_partition_blocked(d, nb, block_rows)
    assert torch.equal(dr, br) and torch.equal(dh, bh)
    fr, fh = radix_partition_ref(d, nb, block_rows=block_rows)
    assert torch.equal(fr, br) and torch.equal(fh, bh)


def test_cuda_wrapper_refuses_cpu_tensors():
    # on a CPU tensor the dispatcher takes the plain version; the kernel's
    # wrapper itself never runs a CPU tensor
    d = torch.zeros((2, 16), dtype=torch.int32)
    before = radix_partition_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        radix_partition_cuda(d, 3)
    assert radix_partition_cuda.launches == before
    ranks, hist = radix_partition(d, 3)
    assert radix_partition_cuda.launches == before
    assert hist.tolist() == [[16, 0, 0], [16, 0, 0]]


@pytest.mark.parametrize("nb,route", [(1, "onepass"), (9, "onepass"),
                                      (256, "onepass"), (257, "threepass"),
                                      (32768, "threepass")])
def test_route_follows_the_bucket_count(nb, route):
    # onepass (one launch, decoupled look-back) covers every shuffle of up
    # to 255 ranks (nb = p + 1); larger nb take the three-kernel route
    from repro_torch.kernels.radix_partition.cuda import route_for
    assert route_for(nb) == route


def test_onepass_scratch_holds_a_word_per_rank_bucket_and_tile():
    # 64-bit status words per (rank, bucket, 8192-row tile) plus the ticket
    from repro_torch.kernels.radix_partition.cuda import (
        ONEPASS_TILE_ROWS, onepass_scratch_bytes)
    assert ONEPASS_TILE_ROWS == 8192
    assert onepass_scratch_bytes(8, 4_718_592, 9) == 8 * (8 * 9 * 576 + 1)
    assert onepass_scratch_bytes(3, 8193, 256) == 8 * (3 * 256 * 2 + 1)
    assert onepass_scratch_bytes(8, 0, 9) == 8
