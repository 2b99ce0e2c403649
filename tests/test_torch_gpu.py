"""CUDA kernels of repro_torch against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  They import
torch and repro_torch only (no JAX), so they run on a machine that has
the CUDA toolkit but not the JAX package's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import radix_partition_cuda, radix_partition_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (p, n, nb): the shuffle's nb = p + 1; a large nb that forces fewer warps
# per block; ragged n; n = 0; one rank
CASES = [(8, 100_003, 9), (1, 1_000_003, 4096), (3, 0, 9), (1, 1, 1),
         (2, 8192, 1024), (4, 20_000, 32768), (5, 70_001, 2)]


@pytest.mark.parametrize("p,n,nb", CASES)
def test_radix_partition_cuda_equals_plain(cuda, p, n, nb):
    # exact: ranks and histograms are integers
    rng = np.random.default_rng(p * 1_000_003 + n + nb)
    dest = torch.as_tensor(rng.integers(0, nb, (p, n), dtype=np.int32),
                           device=cuda)
    before = radix_partition_cuda.launches
    ranks, hist = radix_partition_cuda(dest, nb)
    torch.cuda.synchronize()
    assert radix_partition_cuda.launches == before + 1
    want_r, want_h = radix_partition_ref(dest, nb)
    assert torch.equal(ranks, want_r)
    assert torch.equal(hist, want_h)


def test_radix_partition_cuda_skewed(cuda):
    # one bucket takes 99% of the rows: long runs of one value per warp
    rng = np.random.default_rng(3)
    d = np.where(rng.random((8, 300_000)) < 0.99, 4,
                 rng.integers(0, 9, (8, 300_000))).astype(np.int32)
    dest = torch.as_tensor(d, device=cuda)
    ranks, hist = radix_partition_cuda(dest, 9)
    want_r, want_h = radix_partition_ref(dest, 9)
    assert torch.equal(ranks, want_r) and torch.equal(hist, want_h)


def test_radix_partition_cuda_rejects_bad_input(cuda):
    with pytest.raises(ValueError):
        radix_partition_cuda(torch.zeros((2, 8), dtype=torch.int64,
                                         device=cuda), 4)
    with pytest.raises(ValueError):
        radix_partition_cuda(torch.zeros((2, 8), dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        radix_partition_cuda(torch.zeros((2, 8), dtype=torch.int32,
                                         device=cuda), 0)
