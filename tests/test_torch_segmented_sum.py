"""The port's segmented sum against the JAX package's.

``repro_torch.kernels.segmented_sum`` takes the CPU path here (its plain
version, ``segmented_sum_ref``); it is held to the JAX wrapper
``repro.kernels.segmented_sum`` run as ``tests/test_kernels.py`` runs it
(the Pallas kernel in interpret mode on the CPU) and to the JAX oracle
``segmented_sum_ref``, on inputs made with numpy from a seed.  Integer
sums must be exact; float sums are held to ``rtol=1e-5`` (the two add in
another order), the tolerance of ``tests/test_kernels.py``.  The kernel
itself runs only on the card (``tests/test_torch_gpu.py``).

This file also checks that the port's ``groupby_local`` reduces every
sum, count and size through the dispatcher, once per aggregate, as
``chip_smoke.py`` counts the kernel's launches on the card.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import segmented_sum as jax_segmented_sum
from repro.kernels import segmented_sum_ref as jax_segmented_sum_ref
from repro_torch.kernels import (segmented_sum, segmented_sum_cuda,
                                 segmented_sum_ref)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = ATOL = 1e-5     # float sums in another order (tests/test_kernels.py)


def _check(got, want, integer):
    got = got.numpy()
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# the sweep of tests/test_kernels.py::test_segmented_sum_sweep
@pytest.mark.parametrize("n,segs,cols", [(64, 5, 1), (500, 37, 3),
                                         (1024, 512, 2), (300, 1, 4)])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_sweep_matches_jax(n, segs, cols, dtype):
    rng = np.random.default_rng(n * 31 + segs + cols)
    seg = np.sort(rng.integers(0, segs, n)).astype(np.int32)
    vals = (rng.random((n, cols)) if dtype == "float32"
            else rng.integers(-50, 50, (n, cols))).astype(dtype)
    got = segmented_sum(torch.as_tensor(seg[None]),
                        torch.as_tensor(vals[None]), segs)[0]
    assert got.shape == (segs, cols) and got.dtype == getattr(torch, dtype)
    integer = dtype == "int32"
    _check(got, np.asarray(jax_segmented_sum(jnp.asarray(seg),
                                             jnp.asarray(vals), segs)),
           integer)
    _check(got, np.asarray(jax_segmented_sum_ref(jnp.asarray(seg),
                                                 jnp.asarray(vals), segs)),
           integer)


def test_1d_values_match_jax():
    # tests/test_kernels.py::test_segmented_sum_1d: (n,) values -> (S,)
    rng = np.random.default_rng(1)
    seg = np.sort(rng.integers(0, 9, 100)).astype(np.int32)
    vals = rng.random(100).astype(np.float32)
    got = segmented_sum(torch.as_tensor(seg[None]), torch.as_tensor(vals[None]),
                        9)[0]
    assert got.shape == (9,)
    _check(got, np.asarray(jax_segmented_sum(jnp.asarray(seg),
                                             jnp.asarray(vals), 9)), False)


def test_empty_rows_give_zero_sums():
    seg = np.zeros((0,), np.int32)
    vals = np.zeros((0, 2), np.float32)
    got = segmented_sum(torch.zeros((3, 0), dtype=torch.int32),
                        torch.zeros((3, 0, 2)), 7)
    assert got.shape == (3, 7, 2) and not got.any()
    _check(got[0], np.asarray(jax_segmented_sum(jnp.asarray(seg),
                                                jnp.asarray(vals), 7)), False)


@pytest.mark.parametrize("order", ["sorted", "random"])
def test_out_of_range_ids_add_nothing(order):
    # JAX drops segment updates outside [0, S); the port sends them to a
    # trash slot.  Unsorted ids are part of the contract too.
    rng = np.random.default_rng(2)
    seg = rng.integers(-4, 24, 400).astype(np.int32)
    if order == "sorted":
        seg = np.sort(seg)
    vals = rng.integers(-9, 9, 400).astype(np.int32)
    got = segmented_sum(torch.as_tensor(seg[None]),
                        torch.as_tensor(vals[None]), 20)[0]
    want = np.asarray(jax_segmented_sum_ref(jnp.asarray(seg),
                                            jnp.asarray(vals), 20))
    _check(got, want, True)
    _check(got, np.asarray(jax_segmented_sum(jnp.asarray(seg),
                                             jnp.asarray(vals), 20)), True)


def test_rank_axis_is_per_rank():
    # (p, n) ids: each rank reduces its own rows into its own sums
    rng = np.random.default_rng(3)
    p, n, s = 4, 257, 31
    seg = np.sort(rng.integers(0, s, (p, n)), axis=1).astype(np.int32)
    vals = rng.random((p, n, 2)).astype(np.float32)
    got = segmented_sum(torch.as_tensor(seg), torch.as_tensor(vals), s)
    assert got.shape == (p, s, 2)
    for r in range(p):
        _check(got[r], np.asarray(jax_segmented_sum_ref(
            jnp.asarray(seg[r]), jnp.asarray(vals[r]), s)), False)
    torch.testing.assert_close(
        got, segmented_sum_ref(torch.as_tensor(seg), torch.as_tensor(vals),
                               s), rtol=0, atol=0)


def test_dispatch_follows_the_tensor():
    # a CPU tensor takes the plain version and launches nothing; the CUDA
    # wrapper refuses CPU tensors rather than running them itself
    before = segmented_sum_cuda.launches
    segmented_sum(torch.zeros((1, 4), dtype=torch.int32), torch.ones((1, 4)),
                  2)
    assert segmented_sum_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        segmented_sum_cuda(torch.zeros((1, 4), dtype=torch.int32),
                           torch.ones((1, 4)), 2)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        segmented_sum(torch.zeros((1, 4), dtype=torch.int32, device="meta"),
                      torch.ones((1, 4), device="meta"), 2)
    with pytest.raises(ValueError, match="values"):
        segmented_sum_ref(torch.zeros((1, 4), dtype=torch.int32),
                          torch.ones((1, 5)), 2)


# ---------------------------------------------------------------------- #
# groupby_local's sums go through the dispatcher, once per aggregate
# ---------------------------------------------------------------------- #
def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def test_groupby_calls_match_the_launch_count_chip_smoke_expects(
        monkeypatch):
    # chip_smoke.py holds the card's segmented_sum launches to
    # ``segsum_launches_expected``; on the CPU the same count is the
    # number of dispatcher calls, for plans with and without a mean,
    # pre-aggregation and a shuffle-elided groupby, in every mode
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    from repro_torch.dataframe import ops_local
    from repro_torch.planner import compile_plan
    cs = _chip_smoke()
    calls = []
    real = ops_local.segmented_sum

    def counted(seg, vals, s):
        assert seg.dtype == torch.int32      # the kernel's id type
        calls.append(s)
        return real(seg, vals, s)

    monkeypatch.setattr(ops_local, "segmented_sum", counted)
    env = CylonEnv(4, device="cpu")
    cap = 2 * cs.capacity_for(600, 4)
    tables = {n: DistTable.from_numpy(cs.make_table_data(600, seed), 4,
                                      capacity=cap, device="cpu")
              for n, seed in (("l", 0), ("r", 1))}
    plans = [cs.fig9_plan(Plan, cap), cs.fig9_with_plan(Plan, cap),
             Plan.scan("l").groupby(["k"], {"v0": ["sum", "mean", "size",
                                                   "max"]},
                                    pre_aggregate=True),
             Plan.scan("l").groupby(["k"], {"v0": ["count", "min"]})]
    for plan in plans:
        for opt in (True, False):
            pplan = compile_plan(plan, tables, opt)
            for mode in ("bsp", "bsp_staged", "amt"):
                calls.clear()
                execute(plan, env, tables, mode=mode, optimize=opt)
                assert len(calls) == cs.segsum_launches_expected(
                    pplan, mode) > 0, (plan, opt, mode)
