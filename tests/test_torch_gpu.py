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


# ---------------------------------------------------------------------- #
# flash attention: kernel vs plain version (attention_ref) on the card
# ---------------------------------------------------------------------- #
# (b, hq, hkv, sq, sk, d, causal): square, GQA, MQA, ragged lengths,
# Sq != Sk (queries aligned to the end of the keys), non-causal with
# ragged keys, every head dim the kernel takes
FLASH_CASES = [(1, 4, 4, 128, 128, 64, True), (2, 8, 2, 256, 256, 64, True),
               (1, 4, 1, 128, 128, 128, True), (1, 2, 2, 100, 100, 32, True),
               (1, 4, 2, 128, 384, 64, True), (2, 4, 2, 70, 333, 16, True),
               (1, 2, 2, 100, 130, 128, False), (1, 2, 1, 1, 77, 32, True)]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cuda_equals_plain(cuda, b, hq, hkv, sq, sk, d,
                                           causal, dtype):
    from repro_torch.kernels import attention_ref, flash_attention_cuda
    # tests/test_kernels.py's tolerances: 2e-3 in f32; 2e-2 in bf16, held
    # relative to each output (plus 2e-3), as chip_smoke.py holds it
    atol, rtol = (2e-3, 0) if dtype == torch.float32 else (2e-3, 2e-2)
    g = torch.Generator(device=cuda).manual_seed(sq * 1000 + sk + d)
    q = torch.randn(b, hq, sq, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, hkv, sk, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, hkv, sk, d, generator=g, device=cuda).to(dtype)
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = attention_ref(q, k, v, causal)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def test_flash_attention_cuda_rejects_bad_input(cuda):
    from repro_torch.kernels import flash_attention_cuda
    q = torch.zeros((1, 2, 8, 48), device=cuda)          # head dim 48
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q)
    q = torch.zeros((1, 2, 8, 16), device=cuda)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError):
        flash_attention_cuda(q.transpose(2, 3).contiguous().transpose(2, 3),
                             q, q)


# ---------------------------------------------------------------------- #
# SSD scan: kernel vs plain chunked version on the card
# ---------------------------------------------------------------------- #
# (bh, t, p, n, chunk): the CPU sweep, a ragged last chunk, t shorter
# than a chunk and off the 8-row grid, the main path's (P, N, L) at a
# shorter T, N not a multiple of the 32-row slice
SSD_CASES = [(2, 64, 16, 8, 32), (3, 256, 16, 8, 64), (1, 100, 8, 4, 32),
             (4, 128, 64, 128, 128), (3, 300, 64, 128, 128),
             (2, 13, 64, 128, 128), (8, 1024, 64, 128, 128),
             (2, 200, 32, 48, 128)]


@pytest.mark.parametrize("bh,t,p,n,chunk", SSD_CASES)
def test_ssd_scan_cuda_equals_plain(cuda, bh, t, p, n, chunk):
    from repro_torch.kernels import ssd_scan, ssd_scan_chunked, ssd_scan_cuda
    from repro_torch.kernels.common import round_up
    g = torch.Generator(device=cuda).manual_seed(bh * t + p + n)
    x = torch.randn(bh, t, p, generator=g, device=cuda)
    dt = torch.rand(bh, t, 1, generator=g, device=cuda) * 0.1 + 0.01
    a = -torch.rand(bh, 1, generator=g, device=cuda) - 0.05
    b = torch.randn(bh, t, n, generator=g, device=cuda)
    c = torch.randn(bh, t, n, generator=g, device=cuda)
    before = ssd_scan_cuda.launches
    y, h = ssd_scan(x, dt, a, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan_cuda.launches == before + 1
    y_p, h_p = ssd_scan_chunked(x, dt, a, b, c,
                                chunk=min(chunk, round_up(t, 8)))
    # tests/test_kernels.py's tolerance for the SSD scan
    torch.testing.assert_close(y, y_p, atol=3e-3, rtol=0)
    torch.testing.assert_close(h, h_p, atol=3e-3, rtol=0)


def test_ssd_scan_cuda_rejects_bad_input(cuda):
    from repro_torch.kernels import ssd_scan_cuda
    x = torch.zeros((1, 8, 128), device=cuda)            # P = 128 > 64
    dt, a = torch.zeros((1, 8, 1), device=cuda), torch.zeros((1, 1),
                                                             device=cuda)
    b = torch.zeros((1, 8, 16), device=cuda)
    with pytest.raises(ValueError):
        ssd_scan_cuda(x, dt, a, b, b, chunk=8)
    with pytest.raises(ValueError):
        ssd_scan_cuda(x[..., :64].contiguous().double(), dt, a, b, b,
                      chunk=8)


# (p, n, S, C, dtype, order): sorted and unsorted ids, ragged n, n = 0,
# C > 1, every dtype the kernel takes, ids outside [0, S), one segment
SEGSUM_CASES = [(8, 100_003, 5_000, 1, "float32", "sorted"),
                (2, 1_000_003, 70_000, 1, "float32", "random"),
                (3, 8192 * 3 + 5, 400, 4, "float64", "sorted"),
                (4, 50_001, 1_000, 1, "int32", "random"),
                (1, 20_000, 33, 2, "int64", "sorted"),
                (8, 0, 16, 1, "float32", "sorted"),
                (2, 40_000, 1_000, 1, "int32", "out-of-range"),
                (1, 9_000, 1, 3, "float32", "sorted")]


@pytest.mark.parametrize("p,n,s,c,dtype,order", SEGSUM_CASES)
def test_segmented_sum_cuda_equals_plain(cuda, p, n, s, c, dtype, order):
    # integers exact; floats to 1e-5 (tests/test_kernels.py): the kernel
    # adds in scan order within a run and in atomic order across warps
    from repro_torch.kernels import segmented_sum_cuda, segmented_sum_ref
    rng = np.random.default_rng(p * 7919 + n + s + c)
    lo, hi = (-3, s + 3) if order == "out-of-range" else (0, s)
    ids = rng.integers(lo, hi, (p, n)).astype(np.int32)
    if order == "sorted":
        ids = np.sort(ids, axis=1)
    shape = (p, n) if c == 1 else (p, n, c)
    vals = (rng.integers(-50, 50, shape) if dtype.startswith("int")
            else rng.random(shape)).astype(dtype)
    seg = torch.as_tensor(ids, device=cuda)
    v = torch.as_tensor(vals, device=cuda)
    before = segmented_sum_cuda.launches
    got = segmented_sum_cuda(seg, v, s)
    torch.cuda.synchronize()
    assert segmented_sum_cuda.launches == before + (1 if n else 0)
    want = segmented_sum_ref(seg, v, s)
    assert got.shape == want.shape == (p, s) + shape[2:]
    if dtype.startswith("int"):
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_segmented_sum_cuda_rejects_bad_input(cuda):
    from repro_torch.kernels import segmented_sum_cuda
    ids = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        segmented_sum_cuda(ids.long(), torch.zeros((2, 8), device=cuda), 4)
    with pytest.raises(ValueError):   # no atomicAdd overload for int16
        segmented_sum_cuda(ids, torch.zeros((2, 8), dtype=torch.int16,
                                            device=cuda), 4)
    with pytest.raises(ValueError):
        segmented_sum_cuda(ids, torch.zeros((2, 9), device=cuda), 4)
    with pytest.raises(ValueError):
        segmented_sum_cuda(ids.cpu(), torch.zeros((2, 8)), 4)


def test_groupby_local_sums_go_through_the_kernel(cuda):
    # on the card, sum / count / size take the kernel, never scatter_add_
    from repro_torch.dataframe import Table, groupby_local
    from repro_torch.kernels import segmented_sum_cuda
    rng = np.random.default_rng(11)
    k = torch.as_tensor(rng.integers(0, 50, (4, 300)).astype(np.int32),
                        device=cuda)
    v = torch.as_tensor(rng.random((4, 300)).astype(np.float32),
                        device=cuda)
    t = Table({"k": k, "v": v},
              torch.tensor([300, 250, 0, 17], dtype=torch.int32, device=cuda))
    before = segmented_sum_cuda.launches
    out = groupby_local(t, ["k"], {"v": ["sum", "count", "size", "max"]})
    assert segmented_sum_cuda.launches == before + 3
    cpu = groupby_local(Table({n: c.cpu() for n, c in t.columns.items()},
                              t.row_count.cpu()),
                        ["k"], {"v": ["sum", "count", "size", "max"]})
    for name in ("k", "v_count", "v_size", "v_max"):
        assert torch.equal(out.columns[name].cpu(), cpu.columns[name]), name
    torch.testing.assert_close(out.columns["v_sum"].cpu(),
                               cpu.columns["v_sum"], rtol=1e-5, atol=1e-6)
