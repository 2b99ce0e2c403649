"""The dtype a host array takes on the device, as in the JAX package.

The JAX package stores every ingested column with ``jnp.asarray``, and
JAX runs with 64-bit types disabled, so a 64-bit numpy array lands on the
device as its 32-bit counterpart: int64 as int32 and uint64 as uint32
(both wrapping, as numpy's ``astype`` does), float64 as float32 and
complex128 as complex64.  Every other dtype is kept.  The port applies
the same rule wherever host data enters it, so its device columns have
the reference's dtypes and values, slot for slot.
"""

from __future__ import annotations

import numpy as np

#: 64-bit numpy dtype -> the dtype ``jnp.asarray`` gives it with x64 off
X32 = {np.dtype(np.int64): np.dtype(np.int32),
       np.dtype(np.uint64): np.dtype(np.uint32),
       np.dtype(np.float64): np.dtype(np.float32),
       np.dtype(np.complex128): np.dtype(np.complex64)}


def x32_dtype(dtype) -> np.dtype:
    """The device dtype of a host array of ``dtype``."""
    dtype = np.dtype(dtype)
    return X32.get(dtype, dtype)


def to_x32(a: np.ndarray) -> np.ndarray:
    """``a`` cast to its device dtype (wrapping integers, rounding floats,
    no clipping and no error); ``a`` itself when the dtype is kept."""
    a = np.asarray(a)
    want = x32_dtype(a.dtype)
    if want == a.dtype:
        return a
    with np.errstate(over="ignore", invalid="ignore"):
        return a.astype(want)
