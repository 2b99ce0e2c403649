"""The dtype a host array takes on the device, as in the JAX package.

The JAX package stores every ingested column with ``jnp.asarray``, and
JAX runs with 64-bit types disabled, so a 64-bit numpy array lands on the
device as its 32-bit counterpart: int64 as int32 and uint64 as uint32
(both wrapping, as numpy's ``astype`` does), float64 as float32 and
complex128 as complex64.  Every other dtype is kept.  The port applies
the same rule wherever host data enters it, so its device columns have
the reference's dtypes and values, slot for slot.

It also holds the numpy <-> torch dtype mapping and how the port handles
the unsigned dtypes torch supports only in part (``signed_view``,
``order_view``).
"""

from __future__ import annotations

import numpy as np
import torch

#: 64-bit numpy dtype -> the dtype ``jnp.asarray`` gives it with x64 off
X32 = {np.dtype(np.int64): np.dtype(np.int32),
       np.dtype(np.uint64): np.dtype(np.uint32),
       np.dtype(np.float64): np.dtype(np.float32),
       np.dtype(np.complex128): np.dtype(np.complex64)}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy ``dtype``."""
    return torch.from_numpy(np.empty((0,), dtype)).dtype


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch ``dtype``."""
    return torch.empty((0,), dtype=dtype).numpy().dtype


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


# torch has gather, scatter, comparisons and searchsorted for uint16,
# uint32 and uint64 on no device for certain (none of them on the CPU), so
# the port moves such columns as bits and compares them as values.
#: unsigned dtype -> the signed dtype of the same width (row movers)
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}
#: unsigned dtype -> a wider signed dtype that holds every value (order)
_WIDER = {torch.uint16: torch.int32, torch.uint32: torch.int64}


def signed_view(v: torch.Tensor) -> torch.Tensor:
    """``v``'s bits as the signed dtype of its width (``v`` itself unless
    it is unsigned): for moving rows, never for comparing them."""
    s = _SIGNED.get(v.dtype)
    return v if s is None else v.view(s)


def bits_as(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``v``'s bits as ``dtype``: the inverse of ``signed_view``, and ``v``
    itself when it has that dtype already (a view to the same dtype would
    cut the autograd graph of the float columns that move through it)."""
    return v if v.dtype == dtype else v.view(dtype)


def order_view(v: torch.Tensor) -> torch.Tensor:
    """``v`` in a dtype that compares and sorts as ``v``'s values do:
    uint16 widens to int32 and uint32 to int64; other dtypes pass
    through.  A signed view would misorder values from half the range
    up."""
    w = _WIDER.get(v.dtype)
    return v if w is None else v.to(w)
