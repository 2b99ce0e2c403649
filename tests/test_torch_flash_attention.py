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
