"""The port's flash-attention dispatcher against the JAX package's.

On a CPU tensor ``repro_torch.kernels.flash_attention`` runs the plain
version (``attention_ref``).  It must match the JAX wrapper, whose Pallas
TPU kernel runs here in interpret mode (64 x 64 blocks, the shape sweep of
``tests/test_kernels.py``), and the JAX ``attention_ref``.  Tolerances are
those of ``tests/test_kernels.py``: 2e-3 in float32 (online vs one-shot
softmax), 2e-2 in bfloat16 (the output is rounded to bf16).  The CUDA
kernel's own check against the plain version is ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import (attention_ref, flash_attention,
                                 flash_attention_cuda)

SWEEP = [
    (1, 4, 4, 128, 128, 64),    # MHA square
    (2, 8, 2, 256, 256, 64),    # GQA
    (1, 4, 1, 128, 128, 128),   # MQA
    (1, 2, 2, 100, 100, 32),    # non-multiple seq (padding path)
    (1, 4, 2, 128, 384, 64),    # cross lengths (kv longer)
    (1, 2, 1, 128, 192, 256),   # gemma-7b's head dim, MQA, kv longer
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(b, hq, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed + sq + sk + d)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


def _torch(a, tdt):
    return torch.from_numpy(a).to(tdt)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", SWEEP)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_jax_kernel_and_ref(b, hq, hkv, sq, sk, d, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    q, k, v = _inputs(b, hq, hkv, sq, sk, d)
    qj, kj, vj = (jnp.asarray(a, jdt) for a in (q, k, v))
    got = flash_attention(*(_torch(a, tdt) for a in (q, k, v)), causal=True)
    assert got.dtype == tdt and got.shape == (b, hq, sq, d)
    got = got.float().numpy()
    want_k = np.asarray(jax_flash(qj, kj, vj, causal=True, block_q=64,
                                  block_k=64).astype(jnp.float32))
    want_r = np.asarray(jax_ref(qj, kj, vj, causal=True).astype(jnp.float32))
    np.testing.assert_allclose(got, want_k, atol=atol)
    np.testing.assert_allclose(got, want_r, atol=atol)


@pytest.mark.parametrize("sk", [128, 100])
def test_non_causal(sk):
    # sk = 100 is the ragged-key case the JAX wrapper hands to its ref
    q, k, v = _inputs(1, 2, 2, 128, sk, 32)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=False, block_q=64, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


@pytest.mark.parametrize("shape,causal", [((2, 4, 2, 33, 97, 16), True),
                                          ((1, 6, 3, 70, 70, 64), False)])
def test_torch_ref_equals_jax_ref(shape, causal):
    q, k, v = _inputs(*shape)
    got = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                        scale=0.3)
    want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_dispatcher_rejects_rows_without_keys():
    q, k, v = _inputs(1, 2, 2, 64, 32, 16)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 8, 8, 16))
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    assert flash_attention_cuda.launches == before


# ---------------------------------------------------------------------- #
# what surrounds the CUDA kernel: route, launch geometry, shared memory
# (the kernel mirrors these; tests/test_torch_gpu.py holds them equal to
# the kernel's own on the card)
# ---------------------------------------------------------------------- #
SM_SHARED_BYTES = 233_472     # an H100 SM's shared memory (228 KB)
BLOCK_RESERVED_BYTES = 1_024  # reserved by the system for each block


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_by_dtype_and_head_dim(d, dtype):
    from repro_torch.kernels.flash_attention.cuda import route_for
    # bf16 at D = 256 stays on simt: the wgmma ring would not fit
    want = "wgmma" if dtype == "bfloat16" and d in (64, 128) else "simt"
    assert route_for(getattr(torch, dtype), d) == want


@pytest.mark.parametrize("route,d", [("simt", 16), ("simt", 32),
                                     ("simt", 64), ("simt", 128),
                                     ("simt", 256),
                                     ("wgmma", 64), ("wgmma", 128)])
def test_shared_memory_fits(route, d):
    from repro_torch.kernels.flash_attention.cuda import (SMEM_LIMIT,
                                                          smem_bytes)
    smem = smem_bytes(route, d)
    assert 0 < smem <= SMEM_LIMIT == 232_448
    if route == "simt":
        # two blocks of 8 warps (16 warps) fit on an SM up to D = 128;
        # at D = 256 one block does
        blocks = 2 if d <= 128 else 1
        assert blocks * (smem + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES


def test_shared_memory_of_the_main_shapes():
    # Q + 3 stages of K and V (bf16, 128 rows) + 10 mbarriers + alignment;
    # Q, K, V (64 rows) + P (64 x 64), float32
    from repro_torch.kernels.flash_attention.cuda import smem_bytes
    assert smem_bytes("wgmma", 128) == 1024 + 32_768 + 196_608 + 80
    assert smem_bytes("wgmma", 64) == 1024 + 16_384 + 98_304 + 80
    assert smem_bytes("simt", 128) == 3 * 32_768 + 16_384
    assert smem_bytes("simt", 256) == 3 * 65_536 + 16_384 == 212_992


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launch_geometry_at_head_dim_256(dtype):
    # gemma-7b's prefill: (B, Hq, S) = (4, 16, 4096) at D = 256 on the
    # simt route in both dtypes, 64-query tiles, one 8-warp block an SM
    from repro_torch.kernels.flash_attention.cuda import (HEAD_DIMS,
                                                          launch_geometry)
    assert 256 in HEAD_DIMS
    geo = launch_geometry(4, 16, 4096, 256, getattr(torch, dtype))
    assert geo == ("simt", 64, 256, 212_992, 64, 64 * 4 * 16)


@pytest.mark.parametrize("sq,dtype,d,want_tiles", [
    (4096, "bfloat16", 128, 32), (4000, "bfloat16", 128, 32),
    (4000, "float32", 128, 63), (70, "bfloat16", 64, 1),
    (70, "float32", 64, 2), (1, "bfloat16", 128, 1), (1, "float32", 16, 1),
    (129, "bfloat16", 128, 2), (4000, "bfloat16", 256, 63)])
def test_grid_covers_ragged_queries(sq, dtype, d, want_tiles):
    from repro_torch.kernels.flash_attention.cuda import launch_geometry
    geo = launch_geometry(4, 32, sq, d, getattr(torch, dtype))
    assert geo.q_tiles == want_tiles
    assert (geo.q_tiles - 1) * geo.block_q < sq <= geo.q_tiles * geo.block_q
    assert geo.grid == want_tiles * 4 * 32
    assert geo.threads == (384 if geo.route == "wgmma" else 256)


@pytest.mark.parametrize("b,hq,sq,dtype", [(2, 3, 300, "float32"),
                                           (1, 4, 1000, "bfloat16"),
                                           (3, 2, 64, "float32")])
def test_blocks_go_heaviest_first_and_cover_every_tile(b, hq, sq, dtype):
    from repro_torch.kernels.flash_attention.cuda import (block_work,
                                                          launch_geometry)
    geo = launch_geometry(b, hq, sq, 64, getattr(torch, dtype))
    work = [block_work(i, geo, b * hq) for i in range(geo.grid)]
    assert sorted(work) == [(bh, t) for bh in range(b * hq)
                            for t in range(geo.q_tiles)]
    tiles = [t for _, t in work]
    # causal work grows with the query tile: the last tile comes first
    assert tiles == sorted(tiles, reverse=True)
    assert tiles[0] == geo.q_tiles - 1


def test_grid_takes_more_than_65535_heads():
    # the flattened grid has no B*Hq <= 65535 limit (a grid's y dimension)
    from repro_torch.kernels.flash_attention.cuda import launch_geometry
    for dtype in (torch.float32, torch.bfloat16):
        geo = launch_geometry(1100, 64, 4, 64, dtype)
        assert geo.grid == 1100 * 64 > 65_535
        assert geo.grid <= 2**31 - 1
