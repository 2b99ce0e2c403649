"""CUDA kernels of repro_torch against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  They import
torch and repro_torch only (no JAX), so they run on a machine that has
the CUDA toolkit but not the JAX package's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import os
import re
import time

import numpy as np
import pytest
import torch

from repro_torch.kernels import radix_partition_cuda, radix_partition_ref
from repro_torch.kernels.radix_partition.cuda import route_for

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _radix_check(dest, nb, route):
    # exact: ranks and histograms are integers; one launch, on ``route``
    assert route_for(nb) == route
    before = radix_partition_cuda.launches
    before_route = radix_partition_cuda.route_launches[route]
    ranks, hist = radix_partition_cuda(dest, nb)
    torch.cuda.synchronize()
    assert radix_partition_cuda.launches == before + 1
    assert radix_partition_cuda.route_launches[route] == before_route + 1
    want_r, want_h = radix_partition_ref(dest, nb)
    assert torch.equal(ranks, want_r)
    assert torch.equal(hist, want_h)


# (p, n, nb): the shuffle's nb = p + 1; a large nb that forces fewer warps
# per block; ragged n; n = 0; one rank.  Each case is labelled with the
# route its nb takes (onepass up to 256 buckets, threepass above).
CASES = [(8, 100_003, 9), (1, 1_000_003, 4096), (3, 0, 9), (1, 1, 1),
         (2, 8192, 1024), (4, 20_000, 32768), (5, 70_001, 2)]


@pytest.mark.parametrize("p,n,nb,route", [
    pytest.param(p, n, nb, route_for(nb), id=f"{route_for(nb)}-{p}-{n}-{nb}")
    for p, n, nb in CASES])
def test_radix_partition_cuda_equals_plain(cuda, p, n, nb, route):
    rng = np.random.default_rng(p * 1_000_003 + n + nb)
    dest = torch.as_tensor(rng.integers(0, nb, (p, n), dtype=np.int32),
                           device=cuda)
    _radix_check(dest, nb, route)


def test_radix_partition_cuda_skewed(cuda):
    # one bucket takes 99% of the rows: long runs of one value per warp
    rng = np.random.default_rng(3)
    d = np.where(rng.random((8, 300_000)) < 0.99, 4,
                 rng.integers(0, 9, (8, 300_000))).astype(np.int32)
    dest = torch.as_tensor(d, device=cuda)
    _radix_check(dest, 9, "onepass")


# onepass edge cases: the route boundary; n = 1, 3, 4, 5 (16-byte loads
# only when n is a multiple of 4); one row past an 8192-row tile; p = 8
# with a ragged last tile on every rank, with and without 16-byte loads
@pytest.mark.parametrize("p,n,nb,route", [
    (2, 50_000, 256, "onepass"), (2, 50_000, 257, "threepass"),
    (3, 1, 9, "onepass"), (3, 3, 9, "onepass"), (3, 4, 9, "onepass"),
    (3, 5, 9, "onepass"), (2, 8193, 3, "onepass"),
    (8, 5 * 8192 + 124, 9, "onepass"), (8, 5 * 8192 + 123, 9, "onepass")])
def test_radix_partition_cuda_edges(cuda, p, n, nb, route):
    rng = np.random.default_rng(p * 7 + n + nb)
    dest = torch.as_tensor(rng.integers(0, nb, (p, n), dtype=np.int32),
                           device=cuda)
    _radix_check(dest, nb, route)


def test_radix_partition_cuda_padding_tiles(cuda):
    # the shuffle's layout: per rank a uniform prefix of valid rows, then
    # a tail in the pad bucket p (= nb - 1), several whole tiles of it;
    # one rank all padding, one with no padding
    p, n = 8, 70_000
    rng = np.random.default_rng(5)
    d = rng.integers(0, p, (p, n)).astype(np.int32)
    for r, valid in enumerate([n, 0, 1, 8191, 8192, 12_345, 50_001, 7]):
        d[r, valid:] = p
    _radix_check(torch.as_tensor(d, device=cuda), p + 1, "onepass")


def test_radix_partition_cuda_back_to_back(cuda):
    # two calls in a row on one stream, no sync between: the second must
    # not see the first's status words (its scratch is the same size and
    # the caching allocator hands back the same block)
    rng = np.random.default_rng(9)
    a, b = (torch.as_tensor(rng.integers(0, 9, (8, 70_000), dtype=np.int32),
                            device=cuda) for _ in range(2))
    b[3, 10_000:] = 8
    ra, ha = radix_partition_cuda(a, 9)
    rb, hb = radix_partition_cuda(b, 9)
    torch.cuda.synchronize()
    for dest, r, h in ((a, ra, ha), (b, rb, hb)):
        want_r, want_h = radix_partition_ref(dest, 9)
        assert torch.equal(r, want_r) and torch.equal(h, want_h)


def test_radix_partition_constants_match_kernel(cuda):
    from repro_torch.kernels.radix_partition import cuda as rp
    assert radix_partition_cuda.kernel_constants() == (
        rp.ONEPASS_TILE_ROWS, rp.ONEPASS_MAX_BUCKETS, rp.TILE_ROWS)
    for p, n, nb in [(8, 4_718_592, 9), (1, 1, 1), (3, 8193, 256)]:
        assert radix_partition_cuda.kernel_scratch_bytes(p, n, nb) == \
            rp.onepass_scratch_bytes(p, n, nb)


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
# ragged keys, every head dim the kernel takes; then Sk off the 64- and
# 128-key tiles with three or more tiles (the K/V ring wraps), Sq = 1 and
# Sq < Sk at D = 128, GQA group 4 and MQA at D = 64 and 128, non-causal at
# D = 64, and B*Hq = 70,400 blocks' worth of heads at a tiny S (more than
# the 65,535 a grid's y dimension takes)
FLASH_CASES = [(1, 4, 4, 128, 128, 64, True), (2, 8, 2, 256, 256, 64, True),
               (1, 4, 1, 128, 128, 128, True), (1, 2, 2, 100, 100, 32, True),
               (1, 4, 2, 128, 384, 64, True), (2, 4, 2, 70, 333, 16, True),
               (1, 2, 2, 100, 130, 128, False), (1, 2, 1, 1, 77, 32, True),
               (1, 8, 2, 4000, 4000, 128, True),
               (2, 4, 2, 333, 333, 64, True),
               (2, 8, 2, 1, 1000, 128, True), (1, 4, 1, 70, 1000, 128, True),
               (1, 16, 4, 256, 256, 128, True), (1, 8, 2, 260, 600, 64, True),
               (1, 8, 1, 200, 520, 64, True), (1, 8, 1, 300, 700, 128, True),
               (1, 4, 2, 190, 700, 64, False),
               (1100, 64, 8, 4, 4, 64, True),
               # gemma-7b's head dim 256, simt in both dtypes: causal,
               # ragged with GQA, MQA with Sq < Sk, non-causal ragged keys
               (1, 4, 4, 256, 256, 256, True),
               (1, 4, 2, 333, 333, 256, True),
               (2, 4, 1, 70, 1000, 256, True),
               (1, 2, 2, 100, 301, 256, False),
               # llava-next-34b's GQA group 7 (56 q heads over 8) and
               # musicgen-large's MHA at head dim 64, off the tiles
               (1, 56, 8, 300, 300, 128, True),
               (1, 32, 32, 300, 300, 64, True)]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cuda_equals_plain(cuda, b, hq, hkv, sq, sk, d,
                                           causal, dtype):
    from repro_torch.kernels import attention_ref, flash_attention_cuda
    from repro_torch.kernels.flash_attention.cuda import route_for
    # tests/test_kernels.py's tolerances: 2e-3 in f32; 2e-2 in bf16, held
    # relative to each output (plus 2e-3), as chip_smoke.py holds it
    atol, rtol = (2e-3, 0) if dtype == torch.float32 else (2e-3, 2e-2)
    g = torch.Generator(device=cuda).manual_seed(sq * 1000 + sk + d)
    q = torch.randn(b, hq, sq, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, hkv, sk, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, hkv, sk, d, generator=g, device=cuda).to(dtype)
    route = route_for(dtype, d)
    before = flash_attention_cuda.launches
    before_route = flash_attention_cuda.route_launches[route]
    got = flash_attention_cuda(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert flash_attention_cuda.route_launches[route] == before_route + 1
    assert route == ("wgmma" if dtype == torch.bfloat16 and d in (64, 128)
                     else "simt")
    assert got.dtype == dtype and got.shape == q.shape
    want = attention_ref(q, k, v, causal)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("route,d", [("simt", 16), ("simt", 32),
                                     ("simt", 64), ("simt", 128),
                                     ("simt", 256),
                                     ("wgmma", 64), ("wgmma", 128)])
def test_flash_attention_geometry_matches_kernel(cuda, route, d):
    # the wrapper's mirror of the launch geometry is the kernel's own
    from repro_torch.kernels import flash_attention_cuda
    from repro_torch.kernels.flash_attention.cuda import launch_geometry
    dtype = torch.bfloat16 if route == "wgmma" else torch.float32
    geo = launch_geometry(1, 1, 1, d, dtype)
    assert geo.route == route
    assert flash_attention_cuda.kernel_geometry(route, d) == (
        geo.block_q, geo.threads, geo.smem_bytes)


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
# shorter T, N not a multiple of the 32-column slice; then 64 chunks of
# 32, chunk 100 with T off the chunk and the 8-row grids, chunk 64 and 8
# with ragged T, P and N off the 4-float grid (scalar copies), T = 1, and
# BH x NC = 1,048,576 blocks at tiny P and N (more than 65,535)
SSD_CASES = [(2, 64, 16, 8, 32), (3, 256, 16, 8, 64), (1, 100, 8, 4, 32),
             (4, 128, 64, 128, 128), (3, 300, 64, 128, 128),
             (2, 13, 64, 128, 128), (8, 1024, 64, 128, 128),
             (2, 200, 32, 48, 128),
             (4, 2048, 64, 128, 32), (3, 1013, 64, 128, 100),
             (2, 300, 64, 128, 64), (2, 77, 16, 16, 8),
             (2, 150, 7, 5, 64), (2, 333, 61, 127, 100),
             (3, 1, 64, 128, 128), (16384, 512, 4, 4, 8)]


def _ssd_inputs(cuda, bh, t, p, n, a_top=-0.05, a_span=1.0, dt_span=0.1):
    # dt in [0.01, 0.01 + dt_span), a in (a_top - a_span, a_top]
    g = torch.Generator(device=cuda).manual_seed(bh * t + p + n)
    x = torch.randn(bh, t, p, generator=g, device=cuda)
    dt = torch.rand(bh, t, 1, generator=g, device=cuda) * dt_span + 0.01
    a = -torch.rand(bh, 1, generator=g, device=cuda) * a_span + a_top
    b = torch.randn(bh, t, n, generator=g, device=cuda)
    c = torch.randn(bh, t, n, generator=g, device=cuda)
    return x, dt, a, b, c


def _check_ssd(x, dt, a, b, c, chunk):
    from repro_torch.kernels import ssd_scan, ssd_scan_chunked, ssd_scan_cuda
    from repro_torch.kernels.common import round_up
    t = x.shape[1]
    before = ssd_scan_cuda.launches
    y, h = ssd_scan(x, dt, a, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan_cuda.launches == before + 1
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    y_p, h_p = ssd_scan_chunked(x, dt, a, b, c,
                                chunk=min(chunk, round_up(t, 8)))
    # tests/test_kernels.py's tolerance for the SSD scan
    torch.testing.assert_close(y, y_p, atol=3e-3, rtol=0)
    torch.testing.assert_close(h, h_p, atol=3e-3, rtol=0)


@pytest.mark.parametrize("bh,t,p,n,chunk", SSD_CASES)
def test_ssd_scan_cuda_equals_plain(cuda, bh, t, p, n, chunk):
    _check_ssd(*_ssd_inputs(cuda, bh, t, p, n), chunk)


@pytest.mark.parametrize("bh,t,p,n,chunk", [(4, 1024, 64, 128, 128),
                                            (3, 1013, 64, 128, 100),
                                            (2, 300, 16, 16, 8)])
def test_ssd_scan_cuda_strong_decay(cuda, bh, t, p, n, chunk):
    # a = -8, dt up to 1: exp(total) underflows to 0 and the masked
    # exponentials above the diagonal would overflow; y stays finite.
    # Also within 3e-3 of the recurrence in float64 (the exact answer)
    from repro_torch.kernels import ssd_scan
    args = _ssd_inputs(cuda, bh, t, p, n, a_top=-8.0, a_span=0.0,
                       dt_span=0.99)
    _check_ssd(*args, chunk)
    y, h = ssd_scan(*args, chunk=chunk)
    x, dt, a, b, c = (v.double() for v in args)
    h_e = torch.zeros((bh, n, p), dtype=torch.float64, device=cuda)
    ys = []
    for i in range(t):
        h_e = torch.exp(a * dt[:, i])[:, :, None] * h_e + (
            (b[:, i] * dt[:, i])[:, :, None] * x[:, i, None, :])
        ys.append(torch.einsum("zn,znp->zp", c[:, i], h_e))
    torch.testing.assert_close(y.double(), torch.stack(ys, dim=1),
                               atol=3e-3, rtol=0)
    torch.testing.assert_close(h.double(), h_e, atol=3e-3, rtol=0)


def test_ssd_scan_geometry_matches_kernel(cuda):
    # the wrapper's mirror of the launch constants is the kernel's own
    from repro_torch.kernels import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.cuda import launch_geometry
    geo = launch_geometry(192, 4096, 64, 128, 128)
    assert ssd_scan_cuda.kernel_geometry() == (
        geo.state_threads, geo.threads, 64, 1024, geo.state_smem,
        geo.scan_smem)


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
    sorted0 = segmented_sum_cuda.route_launches["sorted"]
    out = groupby_local(t, ["k"], {"v": ["sum", "count", "size", "max"]})
    assert segmented_sum_cuda.launches == before + 3
    # the groupby's ids are sorted per rank: all three on the sorted route
    assert segmented_sum_cuda.route_launches["sorted"] == sorted0 + 3
    cpu = groupby_local(Table({n: c.cpu() for n, c in t.columns.items()},
                              t.row_count.cpu()),
                        ["k"], {"v": ["sum", "count", "size", "max"]})
    for name in ("k", "v_count", "v_size", "v_max"):
        assert torch.equal(out.columns[name].cpu(), cpu.columns[name]), name
    torch.testing.assert_close(out.columns["v_sum"].cpu(),
                               cpu.columns["v_sum"], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------- #
# The segmented sum's sorted route (single-pass reduce-by-key)
# ---------------------------------------------------------------------- #
def _sorted_check(seg, vals, s):
    """One sorted-route launch held to the plain version (integers exact,
    floats to 1e-5 as above) and bit-identical to a second call."""
    from repro_torch.kernels import segmented_sum_cuda, segmented_sum_ref
    from repro_torch.kernels.segmented_reduce.cuda import route_for
    assert route_for(True) == "sorted" and route_for(False) == "atomic"
    before = dict(segmented_sum_cuda.route_launches)
    got = segmented_sum_cuda(seg, vals, s, sorted_ids=True)
    again = segmented_sum_cuda(seg, vals, s, sorted_ids=True)
    torch.cuda.synchronize()
    assert segmented_sum_cuda.route_launches == {
        "atomic": before["atomic"], "sorted": before["sorted"] + 2}
    want = segmented_sum_ref(seg, vals, s)
    assert got.shape == want.shape and got.dtype == want.dtype
    if vals.dtype.is_floating_point:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got, want)
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))


def _sorted_values(rng, shape, dtype, cuda, exact=False):
    # ``exact``: integer-valued floats, whose sums of millions of rows are
    # exact in any order (random float32 sums of 9 M rows differ beyond
    # 1e-5 between orders)
    vals = (rng.integers(-50, 50, shape) if dtype.startswith("int") or exact
            else rng.random(shape)).astype(dtype)
    return torch.as_tensor(vals, device=cuda)


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64"])
def test_segmented_sum_sorted_route_equals_plain(cuda, dtype, c):
    # several tiles a rank, a ragged n (no 16-byte loads) and an aligned
    # one, ids sorted per rank as the groupby hands them over
    rng = np.random.default_rng(len(dtype) * 10 + c)
    for p, n, s in ((3, 50_003, 7_000), (2, 40_960, 9_000)):
        ids = np.sort(rng.integers(0, s, (p, n)), axis=1).astype(np.int32)
        shape = (p, n) if c == 1 else (p, n, c)
        _sorted_check(torch.as_tensor(ids, device=cuda),
                      _sorted_values(rng, shape, dtype, cuda), s)


def _edge_ids(case, rows):
    """(p, n) sorted int32 ids and S for one layout; ``rows`` is a tile of
    the sorted route."""
    n = 6 * rows
    i = np.arange(n)
    if case == "tile-boundary":     # every run ends exactly on a tile edge
        return np.stack([i // rows * 3, i // rows * 3 + 1]), 20
    if case == "one-run":           # one run spans every tile
        return np.full((2, n), 5), 9
    if case == "hot":               # 99% of the rows in one run
        rng = np.random.default_rng(5)
        ids = np.where(rng.random((2, n)) < 0.99, 7,
                       rng.integers(0, n, (2, n)))
        return np.sort(ids, axis=1), n
    if case == "gaps":              # at the start, a long one, at the end
        row = np.where(i < n // 2, 9_000 + i // 3, 60_000 + i // 2)
        return np.stack([row, row + 1]), 60_000 + n
    if case == "out-of-range":      # ids below 0 and at or above S, sorted
        rng = np.random.default_rng(6)
        return np.sort(rng.integers(-300, 5_300, (2, n)), axis=1), 5_000
    if case == "padding":           # the groupby: dense ids, then cap - 1
        return np.stack([np.where(i < 5_000 + r, i // 2, n - 1)
                         for r in range(2)]), n
    if case == "long-padding":      # a padding run over 2,196 tiles: its
        # last tile looks back in four rounds (32, then 1,024 a round)
        n = 2_200 * rows
        i = np.arange(n)
        return np.stack([np.where(i < 3 * rows + 17 + r, i // 2, n - 1)
                         for r in range(2)]), n
    if case == "sparse":            # n far below S: gaps of every length
        rng = np.random.default_rng(7)
        return np.sort(rng.integers(0, 3_000_000, (2, n)), axis=1), 3_000_000
    raise ValueError(case)


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64"])
@pytest.mark.parametrize("case", ["tile-boundary", "one-run", "hot", "gaps",
                                  "out-of-range", "padding", "long-padding",
                                  "sparse"])
def test_segmented_sum_sorted_route_edges(cuda, case, dtype):
    from repro_torch.kernels import segmented_sum_cuda
    rows = segmented_sum_cuda.kernel_constants()[
        0 if np.dtype(dtype).itemsize == 4 else 1]
    ids, s = _edge_ids(case, rows)
    rng = np.random.default_rng(8)
    exact = case == "long-padding"
    _sorted_check(torch.as_tensor(ids.astype(np.int32), device=cuda),
                  _sorted_values(rng, ids.shape, dtype, cuda, exact), s)
    if case in ("gaps", "long-padding"):  # C > 1 too
        _sorted_check(torch.as_tensor(ids.astype(np.int32), device=cuda),
                      _sorted_values(rng, ids.shape + (3,), dtype, cuda,
                                     exact), s)


@pytest.mark.parametrize("p,n,s", [(1, 1, 1), (2, 64, 5), (4, 3, 9_000),
                                   (1, 300, 1), (3, 4_097, 4_096)])
def test_segmented_sum_sorted_route_small(cuda, p, n, s):
    # one row, one segment, S above n, a tile plus one row
    rng = np.random.default_rng(p + n + s)
    ids = np.sort(rng.integers(0, s, (p, n)), axis=1).astype(np.int32)
    for dtype in ("float32", "int64"):
        _sorted_check(torch.as_tensor(ids, device=cuda),
                      _sorted_values(rng, (p, n), dtype, cuda), s)


def test_segmented_sum_sorted_route_on_four_streams(cuda):
    # four threads, each on a stream of its own, call the sorted route at
    # once (scratch per call): each result exact, every launch counted
    import threading
    from repro_torch.kernels import segmented_sum_cuda, segmented_sum_ref
    rng = np.random.default_rng(9)
    inputs = []
    for t in range(4):
        n = 60_000 + 4 * t
        ids = np.sort(rng.integers(0, 20_000 * (t + 1), (2, n)), axis=1)
        inputs.append((torch.as_tensor(ids.astype(np.int32), device=cuda),
                       torch.as_tensor(rng.integers(-9, 9, (2, n)).astype(
                           np.int32), device=cuda), 20_000 * (t + 1)))
    wants = [segmented_sum_ref(*x) for x in inputs]
    s0 = segmented_sum_cuda.route_launches["sorted"]
    barrier = threading.Barrier(4)
    errors = []

    def worker(t):
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda)):
                barrier.wait()
                for _ in range(50):
                    got = segmented_sum_cuda(*inputs[t], sorted_ids=True)
                    torch.cuda.current_stream(cuda).synchronize()
                    if not torch.equal(got, wants[t]):
                        errors.append(f"thread {t}: sums differ")
                        return
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)
    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert segmented_sum_cuda.route_launches["sorted"] - s0 == 200


# narrow value dtypes: the dispatcher sums them wider on the card (int32,
# int64 for uint32, float32 for halves) and casts back; integer sums wrap
# as the CPU path's do, bit for bit; half sums are within 1e-2 relative of
# the CPU path, which accumulates in the half type (a rounding per row:
# segments of 4 rows keep that within 0.6% for bfloat16)
NARROW_TOP = {"int8": 100, "int16": 1_000, "uint8": 200, "uint16": 3_000,
              "uint32": 2 ** 31}


def _narrow_inputs(cuda, dtype, rows_per_seg, segs=500, p=4):
    rng = np.random.default_rng(rows_per_seg * 13 + len(dtype))
    n = rows_per_seg * segs
    ids = np.sort(rng.integers(0, segs, (p, n)), axis=1).astype(np.int32)
    if dtype in NARROW_TOP:
        vals = torch.as_tensor(rng.integers(0, NARROW_TOP[dtype], (p, n))
                               .astype(dtype))
    else:
        vals = torch.as_tensor(rng.integers(32, 64, (p, n)) / 64.0).to(
            getattr(torch, dtype))
    return torch.as_tensor(ids), vals


@pytest.mark.parametrize("dtype", ["int8", "int16", "uint8", "uint16",
                                   "uint32", "float16", "bfloat16"])
def test_segmented_sum_narrow_dtypes_card_equals_cpu(cuda, dtype):
    from repro_torch.kernels import segmented_sum, segmented_sum_cuda
    ids, vals = _narrow_inputs(cuda, dtype,
                               50 if dtype in NARROW_TOP else 4)
    before = segmented_sum_cuda.launches
    got = segmented_sum(ids.to(cuda), vals.to(cuda), 500)
    torch.cuda.synchronize()
    assert segmented_sum_cuda.launches == before + 1
    want = segmented_sum(ids, vals, 500)
    assert got.dtype == want.dtype == vals.dtype
    if dtype in NARROW_TOP:
        assert torch.equal(got.cpu(), want)
    else:
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=1e-2, atol=1e-2)


def test_segmented_sum_bool_still_raises(cuda):
    # the JAX package raises for a bool sum too
    from repro_torch.kernels import segmented_sum
    with pytest.raises(ValueError):
        segmented_sum(torch.zeros((1, 8), dtype=torch.int32, device=cuda),
                      torch.ones((1, 8), dtype=torch.bool, device=cuda), 2)


@pytest.mark.parametrize("dtype", ["int8", "int16", "uint8", "float16",
                                   "bfloat16"])
def test_groupby_sum_narrow_dtypes_card_equals_cpu(cuda, dtype):
    # the user's path: a groupby sum over a narrow column on the card
    # returns the CPU path's result instead of raising
    from repro_torch.dataframe import Table, groupby_local
    rng = np.random.default_rng(17)
    rows_per_key = 50 if dtype in NARROW_TOP else 4
    k = torch.as_tensor(rng.integers(0, 300, (4, 300 * rows_per_key))
                        .astype(np.int32))
    _, v = _narrow_inputs(cuda, dtype, rows_per_key, segs=300)
    counts = torch.tensor([k.shape[1], 1000, 0, 17], dtype=torch.int32)
    cpu = groupby_local(Table({"k": k, "v": v}, counts), ["k"],
                        {"v": ["sum"]})
    out = groupby_local(Table({"k": k.to(cuda), "v": v.to(cuda)},
                              counts.to(cuda)), ["k"], {"v": ["sum"]})
    assert torch.equal(out.columns["k"].cpu(), cpu.columns["k"])
    got, want = out.columns["v_sum"].cpu(), cpu.columns["v_sum"]
    assert got.dtype == want.dtype == v.dtype
    if dtype in NARROW_TOP:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-2)


# ---------------------------------------------------------------------- #
# Out-of-core morsel execution and unsigned columns on the card
# ---------------------------------------------------------------------- #
def _ooc_fig9(rows=4000, p=8, seed=7):
    """``tests/md_scripts/out_of_core_parity.py``'s recipe: int32 keys at
    90% cardinality, integer-valued float32 payloads (exact sums)."""
    from repro_torch.core import Plan
    rng = np.random.default_rng(seed)
    ld = {"k": rng.integers(0, int(rows * 0.9), rows).astype(np.int32),
          "v0": rng.integers(0, 100, rows).astype(np.float32)}
    rd = {"k": rng.integers(0, int(rows * 0.9), rows).astype(np.int32),
          "w": rng.integers(0, 100, rows).astype(np.float32)}
    cap = -(-(-(-rows // p) + rows // p // 8) // 8) * 8
    plan = (Plan.scan("l").join(Plan.scan("r"), on="k", out_capacity=4 * cap)
            .groupby(["k"], {"v0": ["sum", "mean"]}).sort(["k"])
            .add_scalar(1.0, cols=["v0_sum"]))
    morsel = -(-(-(-rows // p) // 8) // 8) * 8
    return ld, rd, plan, morsel


def _ooc_run(device, env=None, p=8):
    from repro_torch.core import CylonEnv, execute
    ld, rd, plan, morsel = _ooc_fig9(p=p)
    env = env if env is not None else CylonEnv(p, device=device)
    return execute(plan, env, {"l": ld, "r": rd}, collect_stats=True,
                   morsel_rows=morsel, capacity_factor=4.0)


def _same_spill(got, want):
    g, w = got.to_numpy(), want.to_numpy()
    assert sorted(g) == sorted(w)
    for c in w:
        assert g[c].dtype == w[c].dtype and np.array_equal(g[c], w[c]), c
    assert [got.rank_rows(r) for r in range(got.parallelism)] == \
        [want.rank_rows(r) for r in range(want.parallelism)]


def test_morsel_fig9_card_equals_cpu(cuda):
    # bit for bit (integer-valued payloads), with the kernels launched
    from repro_torch.kernels import reset_launches, segmented_sum_cuda
    reset_launches()
    got, gst = _ooc_run(cuda)
    torch.cuda.synchronize()
    assert radix_partition_cuda.launches > 0
    assert segmented_sum_cuda.launches > 0
    want, wst = _ooc_run("cpu")
    _same_spill(got, want)
    assert gst.rows_dropped == wst.rows_dropped == 0
    for k in ("morsels", "rows_shuffled", "spill_bytes", "h2d_bytes",
              "d2h_bytes", "d2h_copied_bytes", "dispatches", "cache_misses"):
        assert getattr(gst, k) == getattr(wst, k), k


def test_morsel_runs_back_to_back_reuse_staging(cuda):
    # two morsel runs on one env: the second reuses every stage and the
    # staging buffers' copy events order each refill after its last read
    from repro_torch.core import CylonEnv
    env = CylonEnv(8, device=cuda)
    first, st1 = _ooc_run(cuda, env)
    second, st2 = _ooc_run(cuda, env)
    _same_spill(second, first)
    assert st2.cache_misses == 0 and st2.cache_hits == st1.cache_hits + \
        st1.cache_misses


def test_spilled_chunks_leave_the_pinned_staging(cuda):
    # D2H copies land in one reused pinned buffer per column; the spilled
    # chunks are pageable copies that share no memory with it
    from repro_torch.core import DistTable, SpillTable
    from repro_torch.planner.morsel import _Acc, _append_out, _schema_of
    rng = np.random.default_rng(5)
    data = {"k": rng.integers(0, 100, 300).astype(np.int32),
            "v": rng.integers(0, 100, 300).astype(np.float32)}
    t = DistTable.from_numpy(data, 4, capacity=128, device=cuda)
    out, acc = SpillTable(4, schema=_schema_of(t)), _Acc()
    _append_out(out, t, acc)
    bufs = acc.staging.buffers()
    ptrs = [b.data_ptr() for b in bufs]
    assert len(bufs) == 2 and all(b.is_pinned() for b in bufs)
    _append_out(out, t, acc)
    assert [b.data_ptr() for b in acc.staging.buffers()] == ptrs
    for r in range(4):
        for c in out._chunks[r]:
            for k, a in c.items():
                assert a.flags.owndata, k
                assert not torch.from_numpy(a).is_pinned(), k
                assert not any(np.shares_memory(a, b.numpy()) for b in bufs)
    want = SpillTable.from_dist(DistTable.from_numpy(data, 4, capacity=128,
                                                     device="cpu"))
    for r in range(4):
        w = want.rank_concat(r)
        g = out.rank_concat(r)
        for k in w:
            assert np.array_equal(g[k], np.concatenate([w[k], w[k]])), k


def test_morsel_source_double_buffers_on_the_card(cuda):
    # every morsel is on the card, in order, with the rows the CPU source
    # yields; the source's copy events have all completed once iteration
    # ends (no copy left writing into freed blocks)
    from repro_torch.core import MorselSource, SpillTable
    rng = np.random.default_rng(11)
    data = {"k": rng.integers(0, 1000, 10_000).astype(np.int32),
            "v": rng.random(10_000),        # float64: narrows on upload
            "u": rng.integers(0, 2**32, 10_000, dtype=np.uint64).astype(
                np.uint32)}
    spill = SpillTable.from_numpy(data, 4, chunk_rows=999)
    card = list(MorselSource(spill, 256, device=cuda))
    host = list(MorselSource(spill, 256, device="cpu"))
    assert len(card) == len(host) == spill.num_morsels(256) == 10
    for c, h in zip(card, host):
        assert c.device.type == "cuda"
        for n in h.columns:
            assert c.columns[n].dtype == h.columns[n].dtype
            assert torch.equal(c.columns[n].cpu(), h.columns[n]), n
        assert torch.equal(c.row_counts.cpu(), h.row_counts)


def test_in_core_degrade_on_the_card(cuda):
    # the default policy recovers every row of an under-capacitated join
    # on the card, and the rows equal the CPU's
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    ld = {"k": np.zeros(32, np.int32), "v0": np.arange(32, dtype=np.float32)}
    rd = {"k": np.zeros(32, np.int32), "w": np.arange(32, dtype=np.float32)}
    plan = Plan.scan("l").join(Plan.scan("r"), on="k", out_capacity=64)
    out = {}
    for device in (cuda, "cpu"):
        env = CylonEnv(4, device=device)
        res, st = execute(plan, env, {
            n: DistTable.from_numpy(d, 4, device=device)
            for n, d in (("l", ld), ("r", rd))},
            optimize=False, collect_stats=True)
        assert isinstance(res, DistTable) and res.device == env.device
        assert st.rows_dropped == 0 and st.degraded > 0
        assert res.total_rows() == 32 * 32
        out[str(device)] = res.to_reference()
    (gc, gn), (cc, cn) = out[str(cuda)], out["cpu"]
    assert np.array_equal(gn, cn)
    for c in cc:
        assert np.array_equal(gc[c], cc[c]), c


@pytest.mark.parametrize("plan_name", ["groupby_key", "groupby_sum", "sort",
                                       "join", "minmax", "filter"])
@pytest.mark.parametrize("dt", [np.uint16, np.uint32],
                         ids=lambda d: d.__name__)
def test_unsigned_columns_card_equals_cpu(cuda, dt, plan_name):
    # CUDA has no torch.where, sort or comparison for uint16/uint32 in
    # every build; the port moves them as bits and compares them widened
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    from repro_torch.expr import col
    rng = np.random.default_rng(5)
    top = int(np.iinfo(dt).max)
    n = 3000
    left = {"k": rng.integers(0, 64, n).astype(np.int32),
            "u": rng.integers(top - 2000, top, n, endpoint=True,
                              dtype=np.uint64).astype(dt),
            "v0": rng.integers(0, 100, n).astype(np.float32)}
    right = {"k": rng.integers(0, 64, n).astype(np.int32),
             "w": rng.integers(0, top, n, endpoint=True,
                               dtype=np.uint64).astype(dt)}
    plan = {"groupby_key": Plan.scan("l").groupby(["u"], {"v0": ["sum"]}),
            "groupby_sum": Plan.scan("l").groupby(["k"], {"u": ["sum"]}),
            "sort": Plan.scan("l").sort(["u"]),
            "join": Plan.scan("l").join(Plan.scan("r"), on="k",
                                        out_capacity=1 << 17),
            "minmax": Plan.scan("l").groupby(["k"], {"u": ["min", "max"]}),
            "filter": Plan.scan("l").filter(col("u") > top // 2)}[plan_name]
    out = {}
    for device in (cuda, "cpu"):
        tables = {nm: DistTable.from_numpy(d, 8, capacity=1024,
                                           device=device)
                  for nm, d in (("l", left), ("r", right))}
        res, st = execute(plan, CylonEnv(8, device=device), tables,
                          collect_stats=True)
        assert st.rows_dropped == 0
        out[str(device)] = res.to_reference()
    (gc, gn), (cc, cn) = out[str(cuda)], out["cpu"]
    assert np.array_equal(gn, cn)
    assert sorted(gc) == sorted(cc)
    for c in cc:
        assert gc[c].dtype == cc[c].dtype and np.array_equal(gc[c], cc[c]), c
    assert any(cc[c].dtype == dt for c in cc)


@pytest.mark.parametrize("keys", [["k"], ["k", "f"], ["u", "k", "f"],
                                  ["h", "u"]])
def test_hash_columns_np_matches_card_hash(cuda, keys):
    # the host mirror the combiner sub-buckets with equals the card's hash
    from repro_torch.dataframe import Table
    from repro_torch.dataframe.ops_local import hash_columns, hash_columns_np
    rng = np.random.default_rng(13)
    cols = {"k": rng.integers(-1000, 1000, 4096).astype(np.int32),
            "f": rng.random(4096).astype(np.float32),
            "u": rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(
                np.uint32),
            "h": rng.integers(0, 2**16, 4096).astype(np.uint16)}
    t = Table({k: torch.as_tensor(v[None]).to(cuda)
               for k, v in cols.items()},
              torch.tensor([4096], dtype=torch.int32, device=cuda))
    dev = hash_columns(t, keys)
    assert dev.is_cuda
    np.testing.assert_array_equal(dev[0].cpu().numpy().astype(np.uint32),
                                  hash_columns_np(cols, keys))


# ---------------------------------------------------------------------- #
# File ingest and observability on the card
# ---------------------------------------------------------------------- #
def _ingest_files(tmp_path, rows=6000, nfiles=3, seed=9):
    """Parquet files of ``_ooc_fig9``'s left and right inputs, with a
    string column holding 10% nulls on the left side."""
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq
    rng = np.random.default_rng(seed)
    ld = {"k": rng.integers(0, int(rows * 0.9), rows).astype(np.int32),
          "v0": rng.integers(0, 100, rows).astype(np.float32),
          "s": np.array([f"s{i % 37:03d}" if rng.random() > 0.1 else None
                         for i in range(rows)], dtype=object)}
    rd = {"k": rng.integers(0, int(rows * 0.9), rows).astype(np.int32),
          "w": rng.integers(0, 100, rows).astype(np.float32)}
    out = {}
    for side, data in (("l", ld), ("r", rd)):
        paths = []
        for f in range(nfiles):
            sl = slice(f * rows // nfiles, (f + 1) * rows // nfiles)
            p = tmp_path / f"{side}{f}.parquet"
            pq.write_table(pa.table({c: v[sl] for c, v in data.items()}),
                           str(p), row_group_size=1000)
            paths.append(str(p))
        out[side] = paths
    return out


def _ingest_fig9(rdf, files, env):
    from repro_torch.io import DictionaryCache
    l_df = rdf.read_parquet(files["l"], env=env, batch_rows=512,
                            dict_cache=DictionaryCache(), name="l")
    r_df = rdf.read_parquet(files["r"], env=env, batch_rows=512,
                            dict_cache=DictionaryCache(), name="r")
    return (l_df.merge(r_df, on="k", out_capacity=8192)
            .groupby("k").agg({"v0": ["sum", "mean"], "s": "max"})
            .sort_values("k"))


@pytest.mark.parametrize("morsel_rows", [None, 128])
def test_read_parquet_collect_card_equals_cpu(cuda, tmp_path, morsel_rows):
    import repro_torch.df as rdf
    from repro_torch.core import CylonEnv
    from repro_torch.kernels import reset_launches, segmented_sum_cuda
    files = _ingest_files(tmp_path)
    out = {}
    for dev in (cuda, "cpu"):
        env = CylonEnv(8, device=dev)
        q = _ingest_fig9(rdf, files, env)
        reset_launches()
        kw = {} if morsel_rows is None else dict(morsel_rows=morsel_rows,
                                                 capacity_factor=4.0)
        res, st = q.collect(collect_stats=True, **kw)
        torch.cuda.synchronize()
        launches = (radix_partition_cuda.launches,
                    segmented_sum_cuda.launches)
        out[str(dev)] = (res.to_numpy(nulls="mask"), st, launches)
    (g, gst, gl), (w, wst, wl) = out[str(cuda)], out["cpu"]
    assert sorted(g) == sorted(w)
    for c in w:
        assert g[c].dtype == w[c].dtype and np.array_equal(g[c], w[c]), c
    assert gl[0] > 0 and gl[1] > 0 and wl == (0, 0)
    assert gst.rows_dropped == wst.rows_dropped == 0
    for k in ("rows_read", "bytes_read", "rows_shuffled", "dispatches"):
        assert getattr(gst, k) == getattr(wst, k), k
    assert gst.bytes_read == sum(os.path.getsize(p)
                                 for p in files["l"] + files["r"])


def test_tracing_invisible_on_the_card(cuda, tmp_path):
    import repro_torch.df as rdf
    from repro_torch.core import CylonEnv
    from repro_torch.kernels import reset_launches, segmented_sum_cuda
    from repro_torch.obs import Tracer
    files = _ingest_files(tmp_path)
    env = CylonEnv(8, device=cuda)
    q = _ingest_fig9(rdf, files, env)
    q.collect(mode="bsp_staged", collect_stats=True)   # builds the stages
    runs = []
    for trace in (None, Tracer("card")):
        reset_launches()
        res, st = q.collect(mode="bsp_staged", collect_stats=True,
                            trace=trace)
        torch.cuda.synchronize()
        runs.append((res.to_numpy(nulls="mask"), st,
                     (radix_partition_cuda.launches,
                      segmented_sum_cuda.launches)))
    (a, ast, al), (b, bst, bl) = runs
    for c in a:
        assert np.array_equal(a[c], b[c]), c
    assert al == bl and al[0] > 0
    assert ast.cache_misses == bst.cache_misses == 0


def test_stage_span_covers_device_time_of_its_kernel(cuda):
    # every radix launch is timed with CUDA events; a stage span, which
    # ends after the card is synchronized, lasts at least as long as the
    # device time of the launches made inside it
    import importlib
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    from repro_torch.obs import Tracer
    rows, p = 1 << 22, 8
    rng = np.random.default_rng(1)
    data = {"k": rng.integers(0, rows, rows).astype(np.int32),
            "v0": rng.integers(0, 100, rows).astype(np.float32)}
    cap = -(-(rows // p + rows // p // 8) // 8) * 8
    env = CylonEnv(p, device=cuda)
    t = DistTable.from_numpy(data, p, capacity=cap, device=cuda)
    plan = Plan.scan("l").shuffle(["k"]).sort(["k"])
    execute(plan, env, {"l": t}, mode="bsp_staged", optimize=False)
    tr = Tracer("timed")
    timed = []
    # the module (the package's ``shuffle`` attribute is the function)
    shuffle_mod = importlib.import_module("repro_torch.dataframe.shuffle")
    inner = shuffle_mod.radix_partition

    def timed_radix(dest, nb):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(dest, nb)
        end.record()
        timed.append((tr._stack[-1].name, start, end))
        return out

    shuffle_mod.radix_partition = timed_radix
    try:
        execute(plan, env, {"l": t}, mode="bsp_staged", optimize=False,
                trace=tr)
    finally:
        shuffle_mod.radix_partition = inner
    torch.cuda.synchronize()
    spans = {s.name: s for s in tr.finish().find("stage")}
    assert timed and {name for name, _, _ in timed} <= set(spans)
    for name in spans:
        ms = sum(a.elapsed_time(b) for n, a, b in timed if n == name)
        assert spans[name].duration_s * 1e3 >= ms, (name, ms)
    # Span.fence: the span of one launch ends after its CUDA event
    dest = torch.as_tensor(rng.integers(0, 9, (8, 1 << 22),
                                        dtype=np.int32), device=cuda)
    tr2 = Tracer()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with tr2.span("launch") as h:
        start.record()
        out = radix_partition_cuda(dest, 9)
        end.record()
        h.fence(out)
    span = tr2.finish().root()
    assert span.duration_s * 1e3 >= start.elapsed_time(end)


def test_debug_overflow_warns_on_the_card(cuda):
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    env = CylonEnv(2, device=cuda)
    data = {"k": np.zeros(256, np.int32), "v0": np.ones(256, np.float32)}
    t = DistTable.from_numpy(data, 2, device=cuda)
    plan = Plan.scan("l").shuffle(["k"], out_capacity=32,
                                  debug_overflow=True)
    with pytest.warns(RuntimeWarning, match=r"shuffle\(k\) @ rank 0 "
                                            r"dropped rows"):
        execute(plan, env, {"l": t}, optimize=False)
    with pytest.warns(RuntimeWarning, match=r"shuffle\(k\) @ rank 0 "
                                            r"dropped rows"):
        execute(Plan.scan("l").shuffle(["k"]), env, {"l": data},
                optimize=False, morsel_rows=32, capacity_factor=1.0,
                overflow="warn", debug_overflow=True)


def test_card_roofline_table_and_unknown_device(cuda, monkeypatch):
    import repro_torch.launch.roofline as roofline
    from repro_torch.core import CylonEnv, DistTable, Plan
    from repro_torch.obs import run_analyzed
    name = torch.cuda.get_device_properties(cuda).name
    rng = np.random.default_rng(2)
    data = {"k": rng.integers(0, 5000, 1 << 16).astype(np.int32),
            "v0": rng.integers(0, 100, 1 << 16).astype(np.float32)}
    env = CylonEnv(8, device=cuda)
    t = DistTable.from_numpy(data, 8, capacity=9216, device=cuda)
    plan = Plan.scan("l").groupby(["k"], {"v0": ["sum"]}).sort(["k"])
    _, report = run_analyzed(plan, env, {"l": t})
    if name in roofline.DEVICE_PEAKS:
        rows = report.stage_table()
        assert report.to_dict()["device"] == name
        assert all(r["roofline_fraction"] <= 1.05 for r in rows)
        assert any(r["bound_s"] > 0 for r in rows)
    monkeypatch.setattr(roofline, "DEVICE_PEAKS", {})
    _, report = run_analyzed(plan, env, {"l": t})
    with pytest.raises(ValueError, match=re.escape(repr(name))):
        report.roofline_table()
    with pytest.raises(ValueError, match="no roofline peaks"):
        roofline.device_peaks(cuda)


# ---------------------------------------------------------------------- #
# Skewed traffic (salting) and fault recovery on the card
# ---------------------------------------------------------------------- #
def test_segmented_sum_cuda_hot_segment(cuda):
    # one segment holds 99% of the rows: every warp-run of it adds into
    # one address (integers exact, floats to 1e-5 as above)
    from repro_torch.kernels import segmented_sum_cuda, segmented_sum_ref
    rng = np.random.default_rng(17)
    p, n = 8, 300_000
    ids = np.where(rng.random((p, n)) < 0.99, 5,
                   rng.integers(0, n, (p, n))).astype(np.int32)
    ids = torch.as_tensor(ids, device=cuda)
    for dtype in (torch.int32, torch.float32):
        vals = torch.as_tensor(rng.integers(0, 100, (p, n)), device=cuda
                               ).to(dtype)
        got = segmented_sum_cuda(ids, vals, n)
        want = segmented_sum_ref(ids, vals, n)
        if dtype == torch.int32:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


def _skew_case(device, env=None, hot=7, n=40_000):
    """skew_parity.py's one-key table on 8 ranks of ``device``: the raw
    groupby + sort and the join, in-core (bsp, bsp_staged) and 16-morsel,
    at the default adaptive."""
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    rng = np.random.default_rng(11)
    keys = np.where(rng.random(n) < 0.99, hot,
                    rng.integers(0, 1000, n)).astype(np.int32)
    data = {"k": keys, "v": rng.integers(0, 100, n).astype(np.float32)}
    build = {"k": np.arange(64, dtype=np.int32),
             "w": rng.integers(0, 100, 64).astype(np.float32)}
    env = env if env is not None else CylonEnv(8, device=device)
    t = DistTable.from_numpy(data, 8, capacity=2 * n // 8, device=device)
    bt = DistTable.from_numpy(build, 8, device=device)
    g = (Plan.scan("t").groupby(["k"], {"v": ["sum", "count"]},
                                pre_aggregate=False).sort(["k"]))
    j = Plan.scan("t").join(Plan.scan("r"), on="k", bucket_capacity=n,
                            shuffle_out_capacity=n, out_capacity=n)
    out = {}
    for name, plan, tables, kw in (
            ("g/bsp", g, {"t": t}, dict(mode="bsp")),
            ("g/bsp_staged", g, {"t": t}, dict(mode="bsp_staged")),
            ("j/bsp", j, {"t": t, "r": bt}, dict(mode="bsp")),
            ("g/morsel", g, {"t": data}, dict(morsel_rows=320,
                                              capacity_factor=4.0)),
            ("j/morsel", j, {"t": data, "r": build},
             dict(morsel_rows=320, capacity_factor=4.0))):
        res, st = execute(plan, env, tables, optimize=False,
                          collect_stats=True, **kw)
        assert st.rows_dropped == 0 and st.salted_shuffles == 1, name
        assert st.degraded == 0, name
        out[name] = res.to_numpy()
    return out


def test_salted_operators_card_equal_cpu(cuda):
    # integer payloads, sums below 2**24: bit for bit, with the radix and
    # segmented-sum kernels launched on the one-key traffic
    from repro_torch.kernels import reset_launches, segmented_sum_cuda
    reset_launches()
    got = _skew_case(cuda)
    torch.cuda.synchronize()
    assert radix_partition_cuda.launches > 0
    assert segmented_sum_cuda.launches > 0
    want = _skew_case("cpu")
    for name in want:
        for c in want[name]:
            assert np.array_equal(got[name][c], want[name][c]), (name, c)


def test_two_hot_keys_in_a_row_on_the_card(cuda):
    # one env, two queries with different hot keys: the second builds its
    # own salted stages (their keys carry the hot hashes)
    from repro_torch.core import CylonEnv
    env = CylonEnv(8, device=cuda)
    for hot in (7, 11):
        got = _skew_case(cuda, env, hot=hot, n=8_000)
        want = _skew_case("cpu", hot=hot, n=8_000)
        for name in want:
            for c in want[name]:
                assert np.array_equal(got[name][c], want[name][c]), \
                    (hot, name, c)


@pytest.mark.parametrize("site", ["transfer:h2d@1", "transfer:d2h@1",
                                  "morsel:execute@2", "spill:combine@0",
                                  "build:resident@0"])
def test_fault_recovery_on_the_card(cuda, site):
    # a fault mid-segment unwinds while uploads may be in flight; the
    # replay refills fresh staging from the checkpoint and the result is
    # the fault-free one, bit for bit
    from repro_torch.core import CylonEnv, execute
    env = CylonEnv(8, device=cuda)
    ld, rd, plan, morsel = _ooc_fig9(p=8)
    clean, cst = execute(plan, env, {"l": ld, "r": rd}, collect_stats=True,
                         morsel_rows=morsel, capacity_factor=4.0)
    got, st = execute(plan, env, {"l": ld, "r": rd}, collect_stats=True,
                      morsel_rows=morsel, capacity_factor=4.0,
                      faults=f"{site}=raise")
    assert st.faults_injected == 1 and st.retries == 1
    assert st.rows_dropped == 0
    _same_spill(got, clean)


def test_morsel_source_fault_waits_for_its_copies(cuda):
    # an h2d fault raised while earlier uploads are queued: the iterator
    # waits on their events before it lets go of the pinned sets, and a
    # new source over the same spill yields the rows the CPU source does
    from repro_torch.core import MorselSource, SpillTable
    from repro_torch.faults import InjectedFault, resolve_faults
    rng = np.random.default_rng(2)
    data = {"k": rng.integers(0, 1000, 200_000).astype(np.int32),
            "v": rng.random(200_000).astype(np.float32)}
    spill = SpillTable.from_numpy(data, 4, chunk_rows=9_999)
    src = MorselSource(spill, 8192, device=cuda,
                       faults=resolve_faults("transfer:h2d@3=raise"))
    with pytest.raises(InjectedFault):
        for _ in src:
            pass
    card = list(MorselSource(spill, 8192, device=cuda))
    host = list(MorselSource(spill, 8192, device="cpu"))
    for c, h in zip(card, host):
        for n in h.columns:
            assert torch.equal(c.columns[n].cpu(), h.columns[n]), n


# --------------------------------------------------------------------- #
# Query serving: gangs of stacked ranks on streams of their own
# --------------------------------------------------------------------- #
def _serve_data(rows=1 << 16):
    rng = np.random.default_rng(11)
    nk = int(rows * 0.9)
    ld = {"k": rng.integers(0, nk, rows).astype(np.int32),
          "v0": rng.integers(0, 256, rows).astype(np.float32)}
    rd = {"k": rng.integers(0, nk, rows).astype(np.int32),
          "w": rng.integers(0, 256, rows).astype(np.float32)}
    return ld, rd


def _serve_queries(left, right):
    from repro_torch.expr import col
    cap = next(iter(left.sources.values())).capacity
    jkw = dict(out_capacity=cap * 4, bucket_capacity=cap * 2,
               shuffle_out_capacity=cap * 2)
    return {
        "join": lambda: (left.merge(right, on="k", **jkw)
                         [(col("v0") > 4) & (col("w") < 250)]
                         .groupby("k").agg({"v0": ["sum"]})
                         .sort_values("k")),
        "groupby": lambda: (left.groupby("k").agg({"v0": ["sum", "mean"]})
                            .sort_values("k")),
        "filter": lambda: left[col("v0") > 64].sort_values("k"),
    }


def _same_np(got, want):
    assert sorted(got) == sorted(want)
    for c in want:
        assert got[c].dtype == want[c].dtype, c
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)


def test_four_gangs_on_streams_equal_sequential_runs(cuda):
    import repro_torch.df as rdf
    from repro_torch.core import CylonEnv, DevicePool
    from repro_torch.kernels import reset_launches, segmented_sum_cuda
    from repro_torch.serve import ProgramCache, QueryScheduler
    pool = DevicePool(slots=8, device=cuda)
    shared = ProgramCache(registry=False)
    sched = QueryScheduler(pool=pool, gang_size=2, max_inflight=4,
                           program_cache=shared)
    ld, rd = _serve_data()
    with rdf.session(scheduler=sched):
        left = rdf.read_numpy(ld, name="l")
        right = rdf.read_numpy(rd, name="r")
    queries = _serve_queries(left, right)
    refs = {}
    for g in range(4):
        env = CylonEnv(devices=pool.devices[2 * g:2 * g + 2],
                       program_cache=shared)
        for name, q in queries.items():
            out = q().collect(env=env).to_numpy()
            if name in refs:
                _same_np(out, refs[name])
            refs[name] = out
    torch.cuda.synchronize()
    reset_launches()
    handles = [(n, sched.submit(queries[n]())) for n in sorted(queries) * 4]
    for name, h in handles:
        _same_np(h.result(timeout=300).to_numpy(), refs[name])
        assert h.stats["cache_misses"] == 0
    assert radix_partition_cuda.launches > 0
    assert segmented_sum_cuda.launches > 0
    sched.close()
    assert pool.available == 8


def test_launch_counts_exact_under_threads(cuda):
    # R2: four threads, each on a stream of its own, launch the radix and
    # segmented-sum kernels; no count is lost
    import threading
    from repro_torch.kernels import segmented_sum_cuda
    rng = np.random.default_rng(4)
    dest = torch.as_tensor(rng.integers(0, 9, (8, 40_000), dtype=np.int32),
                           device=cuda)
    ids = torch.as_tensor(rng.integers(0, 500, (8, 40_000), dtype=np.int32),
                          device=cuda)
    vals = torch.ones((8, 40_000), dtype=torch.float32, device=cuda)
    r0 = radix_partition_cuda.launches
    o0 = radix_partition_cuda.route_launches["onepass"]
    s0 = segmented_sum_cuda.launches
    barrier = threading.Barrier(4)
    errors = []

    def worker():
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda)):
                barrier.wait()
                for _ in range(100):
                    radix_partition_cuda(dest, 9)
                    segmented_sum_cuda(ids, vals, 500)
                torch.cuda.current_stream(cuda).synchronize()
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)
    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert radix_partition_cuda.launches - r0 == 400
    assert radix_partition_cuda.route_launches["onepass"] - o0 == 400
    assert segmented_sum_cuda.launches - s0 == 400


def test_threads_loading_one_kernel_build_it_once(cuda, tmp_path,
                                                  monkeypatch):
    # R1: eight threads ask for a kernel that is not built yet; nvcc runs
    # once, into a temporary file of its own, and all get one library
    import subprocess
    import threading
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_loaded", {})
    runs = []
    real = subprocess.run

    def counting(cmd, *a, **kw):
        runs.append(cmd[cmd.index("-o") + 1])
        return real(cmd, *a, **kw)
    monkeypatch.setattr(build.subprocess, "run", counting)
    barrier = threading.Barrier(8)
    libs, errors = [], []

    def loader():
        try:
            barrier.wait()
            libs.append(build.load("segmented_sum"))
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)
    threads = [threading.Thread(target=loader) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors, errors
    assert len(runs) == 1 and runs[0].endswith(".tmp")
    assert len({id(lib) for lib in libs}) == 1 and len(libs) == 8
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(build.library_path("segmented_sum")),
         "segmented_sum.log"])


def test_query_waits_for_the_submitters_upload(cuda):
    # the submit event: the submitter's stream is busy, then uploads the
    # table with a non_blocking copy and submits at once; the worker's
    # stream waits for that copy before the query reads the rows
    import repro_torch.df as rdf
    from repro_torch.core import CylonEnv, DistTable
    from repro_torch.serve import QueryScheduler
    ld, _ = _serve_data(1 << 18)
    host = DistTable.from_numpy(ld, 2, device="cpu")
    want = (rdf.from_table(host).groupby("k").agg({"v0": ["sum"]})
            .sort_values("k").collect(env=CylonEnv(2, device="cpu"))
            .to_numpy())
    with QueryScheduler(slots=2, gang_size=2, device=cuda) as sched:
        for _ in range(2):
            cols = {}
            torch.cuda._sleep(200_000_000)    # keep the stream busy
            for n, v in host.columns.items():
                cols[n] = torch.empty(v.shape, dtype=v.dtype, device=cuda)
                cols[n].copy_(v.pin_memory(), non_blocking=True)
            counts = torch.empty_like(host.row_counts, device=cuda)
            counts.copy_(host.row_counts.pin_memory(), non_blocking=True)
            df = rdf.from_table(DistTable(cols, counts, host.capacity))
            h = sched.submit(df.groupby("k").agg({"v0": ["sum"]})
                             .sort_values("k"))
            _same_np(h.result(timeout=300).to_numpy(), want)


def test_dropped_result_outlives_the_callers_reads(cuda):
    # result() marks the result's tensors as used on the caller's stream:
    # the caller queues a slow read of a result and drops it while the
    # same worker runs another query (submitted from an idle stream, so it
    # starts at once); that query's allocations must not take the result's
    # blocks before the read has run
    import repro_torch.df as rdf
    from repro_torch.core import DistTable
    from repro_torch.serve import QueryScheduler
    ld, _ = _serve_data(1 << 18)
    other = {"k": ld["k"], "v0": 255 - ld["v0"]}
    with QueryScheduler(slots=2, gang_size=2, max_inflight=1,
                        device=cuda) as sched:
        with rdf.session(scheduler=sched):
            df, df2 = rdf.read_numpy(ld), rdf.read_numpy(other)
        q = df.groupby("k").agg({"v0": ["sum"]}).sort_values("k")
        q2 = df2.groupby("k").agg({"v0": ["sum"]}).sort_values("k")
        want = sched.submit(q).result(timeout=300).to_numpy()
        sched.submit(q2).result(timeout=300)
        idle = torch.cuda.Stream(cuda)
        for _ in range(3):
            out = sched.submit(q).result(timeout=300)
            host = {n: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    for n, v in out.columns.items()}
            counts = torch.empty(out.row_counts.shape,
                                 dtype=out.row_counts.dtype, pin_memory=True)
            capacity = out.capacity
            torch.cuda._sleep(1_000_000_000)  # the caller's stream is busy
            for n in host:
                host[n].copy_(out.columns[n], non_blocking=True)
            counts.copy_(out.row_counts, non_blocking=True)
            del out
            with torch.cuda.stream(idle):
                h = sched.submit(q2)
            h.result(timeout=300)
            assert not torch.cuda.current_stream(cuda).query(), \
                "the caller's read ran before the other query finished"
            torch.cuda.current_stream(cuda).synchronize()
            _same_np(DistTable(host, counts, capacity).to_numpy(), want)


def test_wall_is_not_inflated_by_another_gangs_work(cuda):
    # R4: a query's completion barrier waits on its own stream only, so
    # another stream's long kernel does not count in its wall_s
    import repro_torch.df as rdf
    from repro_torch.serve import QueryScheduler
    ld, _ = _serve_data(1 << 14)
    with QueryScheduler(slots=2, gang_size=1, device=cuda) as sched:
        with rdf.session(scheduler=sched):
            df = rdf.read_numpy(ld)
        q = df.groupby("k").agg({"v0": ["sum"]}).sort_values("k")
        sched.submit(q).result(timeout=300)   # builds, warms the stream
        other = torch.cuda.Stream(cuda)
        t0 = time.monotonic()
        with torch.cuda.stream(other):
            torch.cuda._sleep(3_000_000_000)  # about 1.5 s on the card
        h = sched.submit(q)
        h.result(timeout=300)
        busy = not other.query()
        other.synchronize()
        other_s = time.monotonic() - t0
    assert busy, "the other stream finished before the query did"
    assert other_s > 0.5
    assert h.stats["wall_s"] < other_s / 2, (h.stats["wall_s"], other_s)


# ---------------------------------------------------------------------- #
# The training slice: the SSD scan's gradient, a train step, the §IV-C
# pipeline
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("bh,t,p,n,chunk", [(8, 1024, 64, 128, 128),
                                            (6, 200, 16, 16, 32)])
def test_ssd_autograd_function_equals_plain_gradient(cuda, bh, t, p, n,
                                                     chunk):
    # the Function's forward is the kernel (one launch): y and the final
    # state within the kernel's 3e-3 of the plain version.  Its backward
    # is the plain version recomputed (one backward pass), so the gradients
    # check the Function's wiring: every input's within 3e-3
    from repro_torch.kernels import (ssd_scan, ssd_scan_backward,
                                     ssd_scan_chunked, ssd_scan_cuda)
    args = _ssd_inputs(cuda, bh, t, p, n)
    g = torch.Generator(device=cuda).manual_seed(5)
    gy = torch.randn(bh, t, p, generator=g, device=cuda)
    grads, outs = [], []
    for fn in (ssd_scan, ssd_scan_chunked):
        ins = [v.clone().requires_grad_(True) for v in args]
        f0, b0 = ssd_scan_cuda.launches, ssd_scan_backward.launches
        y, h = fn(*ins, chunk=chunk)
        (y * gy).sum().backward()
        torch.cuda.synchronize()
        kernel = fn is ssd_scan
        assert ssd_scan_cuda.launches - f0 == int(kernel)
        assert ssd_scan_backward.launches - b0 == int(kernel)
        grads.append([v.grad for v in ins])
        outs.append((y.detach(), h.detach()))
    for got, want in zip(*outs):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, atol=3e-3, rtol=3e-3)
    for got, want in zip(*grads):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, atol=3e-3, rtol=3e-3)


def test_flash_attention_refuses_gradients_on_card(cuda):
    # the kernel has no backward: a grad-enabled call raises at once, and a
    # dense train step whose keys exceed 2048 (impl='auto' -> flash) says so
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention, flash_attention_cuda
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    q = torch.randn(1, 2, 64, 32, device=cuda, requires_grad=True)
    before = flash_attention_cuda.launches
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_attention(q, q, q)
    with torch.no_grad():
        assert flash_attention(q, q, q).shape == q.shape
    assert flash_attention_cuda.launches == before + 1
    cfg = get_smoke_config("qwen3-8b")
    state = init_train_state(cfg, torch.Generator(device=cuda).manual_seed(0),
                             torch.float32, cuda)
    step = make_train_step(cfg, AdamWConfig(warmup_steps=1, total_steps=1),
                           "auto", True, 64)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 2050))
    with pytest.raises(NotImplementedError, match="ROADMAP item 13.1"):
        step(state, {"tokens": toks[:, :-1].astype(np.int32),
                     "labels": toks[:, 1:].astype(np.int32)})


def test_mamba2_smoke_train_step_card_equals_cpu(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ssd_scan_cuda
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    cfg = get_smoke_config("mamba2-780m")
    cpu = init_train_state(cfg, torch.Generator().manual_seed(0),
                           torch.float32, "cpu")
    card = {"params": {k: v.to(cuda) for k, v in cpu["params"].items()},
            "opt": {"step": cpu["opt"]["step"].to(cuda),
                    "m": {k: v.to(cuda) for k, v in cpu["opt"]["m"].items()},
                    "v": {k: v.to(cuda)
                          for k, v in cpu["opt"]["v"].items()}}}
    ocfg = AdamWConfig(warmup_steps=1, total_steps=3)
    step_card = make_train_step(cfg, ocfg, "kernel", True, 16)
    step_cpu = make_train_step(cfg, ocfg, "chunked", True, 16)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 97))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    before = ssd_scan_cuda.launches
    card, m_card = step_card(card, batch)
    torch.cuda.synchronize()
    # 2 layers: the forward and the recomputation under remat
    assert ssd_scan_cuda.launches - before == 2 * cfg.num_layers
    cpu, m_cpu = step_cpu(cpu, batch)
    for k in ("loss", "grad_norm"):
        assert float(m_card[k]) == pytest.approx(float(m_cpu[k]), rel=1e-3)
    for k, v in cpu["params"].items():
        torch.testing.assert_close(card["params"][k].cpu(), v, atol=1e-4,
                                   rtol=1e-3)


def test_data_pipeline_card_equals_cpu(cuda):
    from repro_torch.core import CylonExecutor, CylonStore
    from repro_torch.data import (CorpusConfig, batches_from_table,
                                  preprocess, source_weights, synth_corpus)
    from repro_torch.kernels import radix_partition_cuda
    cfg = CorpusConfig(num_docs=4096, payload_tokens=64, vocab_size=1000,
                       dup_rate=0.4, seed=3)
    runs = {}
    for dev in (cuda, "cpu"):
        store = CylonStore()
        gang = CylonExecutor(parallelism=8, device=dev)
        before = radix_partition_cuda.launches
        preprocess(gang, synth_corpus(cfg, 8, device=dev),
                   source_weights(cfg.num_sources, 8, device=dev),
                   store=store)
        got = store.get("train_corpus", target_parallelism=4, device=dev)
        if dev is cuda:
            torch.cuda.synchronize()
            # the dedup groupby, two shuffles per join, the repartition
            assert radix_partition_cuda.launches - before == 6
        batch = next(batches_from_table(got, 4, 32))
        runs[str(dev)] = (store.get("train_corpus").to_reference(),
                          got.to_reference(), batch)
    (a_out, a_got, a_b), (b_out, b_got, b_b) = runs.values()
    for (ca, na), (cb, nb) in ((a_out, b_out), (a_got, b_got)):
        np.testing.assert_array_equal(na, nb)
        assert sorted(ca) == sorted(cb)
        for k in ca:
            np.testing.assert_array_equal(ca[k], cb[k], err_msg=k)
    for k in a_b:
        np.testing.assert_array_equal(a_b[k], b_b[k])


# ---------------------------------------------------------------------- #
# Mixture-of-Experts (models/moe.py): the dispatch ranks from the kernel
# ---------------------------------------------------------------------- #
# (p, n, nb) of the MoE paths: olmoe prefill (4 rows of 4,096 tokens x
# top-8 over 64 experts) and decode (one token), jamba prefill (top-2
# over 16) and decode; the shuffle dispatch's shuffles and its local
# group-by-expert at olmoe width over 8 stacked ranks
MOE_RADIX_CASES = [(4, 32_768, 64), (4, 8, 64), (4, 8_192, 16), (4, 2, 16),
                   (8, 16_384, 9), (8, 131_072, 9)]


@pytest.mark.parametrize("p,n,nb", MOE_RADIX_CASES)
def test_radix_partition_cuda_at_moe_shapes(cuda, p, n, nb):
    rng = np.random.default_rng(p * 31 + n + nb)
    dest = torch.as_tensor(rng.integers(0, nb, (p, n), dtype=np.int32),
                           device=cuda)
    _radix_check(dest, nb, "onepass")


def test_ssd_scan_cuda_at_jamba_state_size(cuda):
    # jamba's mamba layers: N = 16 fills half of the kernel's 32-column
    # slice of the state
    _check_ssd(*_ssd_inputs(cuda, 8, 300, 64, 16), 128)


def _moe_smoke(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.moe import moe_init
    cfg = get_smoke_config("olmoe-1b-7b")
    params = moe_init(torch.Generator().manual_seed(5), cfg, torch.float32,
                      "cpu")
    return cfg, params


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.parametrize("cf", [None, 1.0])
def test_moe_grouped_card_equals_cpu(cuda, cf):
    import dataclasses
    from repro_torch.models import moe
    cfg, params = _moe_smoke(cuda)
    if cf is not None:           # tokens drop at capacity factor 1
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    x = torch.randn(4, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(6))
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cap = moe.expert_capacity(cfg, 64)
    slots, outs = {}, {}
    for dev in (cuda, "cpu"):
        p, xd = _to(params, dev), x.to(dev)
        _, topi, _ = moe._route(p, xd, cfg)
        before = radix_partition_cuda.launches
        slots[str(dev)] = moe.dispatch_slots(
            topi.reshape(4, -1).to(torch.int32), e, cap).cpu()
        outs[str(dev)] = [t.cpu() for t in moe.moe_apply_grouped(p, xd, cfg)]
        if dev is cuda:
            torch.cuda.synchronize()
            # dispatch_slots, then moe_apply_grouped: one launch each
            assert radix_partition_cuda.launches - before == 2
    assert torch.equal(slots["cuda"], slots["cpu"])
    assert bool((slots["cpu"] == e * cap).any()) == (cf is not None)
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(outs["cuda"][1], outs["cpu"][1], atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("comm", ["xla", "ring", "bruck"])
def test_moe_shuffle_dispatch_card_equals_cpu(cuda, comm):
    import dataclasses
    from repro_torch.models import moe
    cfg, params = _moe_smoke(cuda)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0, communicator=comm))
    x = torch.randn(4, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(7))
    outs = {}
    for dev in (cuda, "cpu"):
        before = radix_partition_cuda.launches
        outs[str(dev)] = [t.cpu() for t in moe.moe_apply_shuffle(
            _to(params, dev), x.to(dev), cfg, 4)]
        if dev is cuda:
            torch.cuda.synchronize()
            # two shuffles and the local group-by-expert
            assert radix_partition_cuda.launches - before == 3
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(outs["cuda"][1], outs["cpu"][1], atol=1e-6,
                               rtol=1e-5)
    # and the grouped dispatch at this ample capacity
    y_g, _ = moe.moe_apply_grouped(_to(params, cuda), x.to(cuda), cfg)
    torch.testing.assert_close(outs["cuda"][0], y_g.cpu(), atol=2e-4,
                               rtol=1e-3)


def test_olmoe_smoke_transformer_refuses_cpu_fallback(monkeypatch):
    # built with no device named and no card, the model raises instead of
    # falling back to the CPU, as the other archs' constructors do
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("olmoe-1b-7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_caches(cfg, 1, 8)


# ---------------------------------------------------------------------- #
# The remaining text archs: MLA (deepseek-v2-lite-16b) and the flash
# kernel at head dim 256 inside a model (gemma-7b)
# ---------------------------------------------------------------------- #
def _smoke_pair(cuda, cfg, seed=3):
    import copy
    from repro_torch.models import transformer
    base = transformer.init_params(cfg, torch.Generator().manual_seed(seed),
                                   torch.float32, "cpu")
    return {"cpu": base, "cuda": copy.deepcopy(base).to(cuda)}


def _prefill_decode(model, prompts, impl, steps, dev):
    # prefill, then greedy decode; the radix launches of each decode step
    from repro_torch.models import transformer
    b, s = prompts.shape
    logits, caches = transformer.prefill(
        model, torch.as_tensor(prompts, device=dev), s + steps, impl)
    out, radix = [logits.cpu()], []
    for step in range(steps):
        tok = torch.argmax(logits, dim=-1)
        before = radix_partition_cuda.launches
        logits = transformer.decode_step(
            model, caches, tok[:, None],
            torch.full((b,), s + step, dtype=torch.int32, device=dev))
        radix.append(radix_partition_cuda.launches - before)
        out.append(logits.cpu())
    return out, [{k: v.cpu() for k, v in c.items()} for c in caches], radix


@pytest.mark.parametrize("s", [40, 2100])
def test_mla_smoke_prefill_and_decode_card_equals_cpu(cuda, s):
    # deepseek-v2-lite-16b SMOKE: MLA dense (40 keys) and chunked (2,100)
    # in prefill, the absorbed decode, the latent caches; card == CPU
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    models = _smoke_pair(cuda, cfg)
    prompts = torch.as_tensor(np.random.default_rng(s).integers(
        0, cfg.vocab_size, (2, s)))
    got = {dev: _prefill_decode(models[str(dev)], prompts, "auto", 4, dev)
           for dev in (cuda, "cpu")}
    for a, b in zip(got[cuda][0], got["cpu"][0]):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)
    for ca, cb in zip(got[cuda][1], got["cpu"][1]):
        assert sorted(ca) == ["ckv"]
        torch.testing.assert_close(ca["ckv"], cb["ckv"], atol=1e-4,
                                   rtol=1e-4)


def test_deepseek_smoke_radix_launches_per_decode_step(cuda):
    # one radix launch per MoE layer in every decode step (the dense
    # prefix layer launches none)
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    assert moe_layers == cfg.num_layers - 1 == 2
    model = _smoke_pair(cuda, cfg)["cuda"]
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))
    before = radix_partition_cuda.launches
    _, _, radix = _prefill_decode(model, prompts, "auto", 3, cuda)
    assert radix == [moe_layers] * 3
    assert radix_partition_cuda.launches - before == 4 * moe_layers


def test_gemma_smoke_at_head_dim_256_card_equals_cpu(cuda):
    # gemma-7b SMOKE widened to head dim 256: every attention layer's
    # prefill goes through the flash kernel's D = 256 simt route
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention_cuda
    cfg = dataclasses.replace(get_smoke_config("gemma-7b"), head_dim=256)
    models = _smoke_pair(cuda, cfg)
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 160)))
    before = flash_attention_cuda.route_launches["simt"]
    got = {dev: _prefill_decode(models[str(dev)], prompts, "flash", 4, dev)
           for dev in (cuda, "cpu")}
    assert (flash_attention_cuda.route_launches["simt"] - before
            == cfg.num_layers)
    for a, b in zip(got[cuda][0], got["cpu"][0]):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------- #
# The VLM and audio frontends (llava-next-34b, musicgen-large)
# ---------------------------------------------------------------------- #
def _frontend_inputs(cfg, s, seed, labels=False):
    # audio: (2, s, K) tokens; vlm: 8 patch embeddings and s - 8 tokens
    rng = np.random.default_rng(seed)
    k = (cfg.num_codebooks,) if cfg.family == "audio" else ()
    n = s - 8 if cfg.family == "vlm" else s
    toks = rng.integers(0, cfg.vocab_size, (2, n + 1) + k).astype(np.int32)
    batch = {"tokens": toks[:, :-1]}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (2, 8, cfg.d_model)).astype(np.float32)
    if labels:
        batch["labels"] = toks[:, 1:]
    return batch


@pytest.mark.parametrize("arch", ["llava-next-34b", "musicgen-large"])
def test_frontend_smoke_serve_and_train_step_card_equals_cpu(cuda, arch):
    # prefill through the flash kernel (one launch a layer), 4 greedy
    # decode steps (none), then one train step; card == CPU
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention_cuda
    from repro_torch.models import transformer
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    cfg = get_smoke_config(arch)
    models = _smoke_pair(cuda, cfg)
    s, steps = 160, 4
    batch = _frontend_inputs(cfg, s, seed=5)
    got = {}
    for dev in (cuda, "cpu"):
        t = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        before = flash_attention_cuda.route_launches["simt"]
        logits, caches = transformer.prefill(
            models[str(dev)], t["tokens"].long(), s + steps, "flash",
            t.get("patch_embeds"))
        launched = flash_attention_cuda.route_launches["simt"] - before
        assert launched == (cfg.num_layers if dev == cuda else 0)
        out = [logits.cpu()]
        for step in range(steps):
            tok = torch.argmax(logits, dim=-1)
            logits = transformer.decode_step(
                models[str(dev)], caches, tok[:, None],
                torch.full((2,), s + step, dtype=torch.int32, device=dev))
            out.append(logits.cpu())
        assert flash_attention_cuda.route_launches["simt"] - before \
            == launched
        got[str(dev)] = out
    for a, b in zip(got[str(cuda)], got["cpu"]):
        if cfg.family == "audio":
            assert a.shape == (2, cfg.num_codebooks, cfg.padded_vocab)
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)
    # one train step from one state: dense attention on both (160 keys)
    cpu = init_train_state(cfg, torch.Generator().manual_seed(0),
                           torch.float32, "cpu")
    card = {"params": {k: v.to(cuda) for k, v in cpu["params"].items()},
            "opt": {"step": cpu["opt"]["step"].to(cuda),
                    "m": {k: v.to(cuda) for k, v in cpu["opt"]["m"].items()},
                    "v": {k: v.to(cuda)
                          for k, v in cpu["opt"]["v"].items()}}}
    ocfg = AdamWConfig(warmup_steps=1, total_steps=3)
    batch = _frontend_inputs(cfg, 96, seed=6, labels=True)
    card, m_card = make_train_step(cfg, ocfg, "auto", True, 32)(card, batch)
    cpu, m_cpu = make_train_step(cfg, ocfg, "chunked", True, 32)(cpu, batch)
    for k in ("loss", "grad_norm"):
        assert float(m_card[k]) == pytest.approx(float(m_cpu[k]), rel=1e-3)
    for k, v in cpu["params"].items():
        torch.testing.assert_close(card["params"][k].cpu(), v, atol=1e-4,
                                   rtol=1e-3)


def test_integer_division_by_zero_card_equals_cpu(cuda):
    # CUDA integer division does not trap; the port masks zero divisors
    # itself, so the card gives the CPU's (and the JAX package's) values
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    from repro_torch.expr import col
    data = {"a": np.array([5, 0, -3, 7, 2**31 - 1, -2**31, 9, -1], np.int32),
            "m": np.array([0, 0, 0, 2, -1, -1, 4, 0], np.int32),
            "u": np.array([5, 0, 3, 2**32 - 1, 1, 7, 0, 9], np.uint32),
            "f": np.array([1.5, -2.5, 0.0, 7.0, np.inf, np.nan, 3.0, -0.0],
                          np.float32)}
    exprs = {"q": col("a") // col("m"), "r": col("a") % col("m"),
             "q0": col("a") // 0, "r0": col("a") % 0,
             "uq": col("u") // col("m").abs(), "ur": col("u") % 0,
             "fq": col("f") // 0.0, "fr": col("f") % col("m")}
    out = {}
    for device in (cuda, "cpu"):
        t = DistTable.from_numpy(data, 2, device=device)
        res = execute(Plan.scan("t").with_columns(exprs),
                      CylonEnv(2, device=device), {"t": t})
        out[str(device)] = res.to_numpy()
    card, cpu = out[str(cuda)], out["cpu"]
    np.testing.assert_array_equal(cpu["q0"], [-2, -1, -2, -2, -2, -2, -2,
                                              -2])
    for name in exprs:
        assert card[name].dtype == cpu[name].dtype, name
        np.testing.assert_array_equal(card[name], cpu[name], err_msg=name)
