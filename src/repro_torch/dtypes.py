"""The dtype a host array takes on the device, as in the JAX package.

The JAX package stores every ingested column with ``jnp.asarray``, and
JAX runs with 64-bit types disabled, so a 64-bit numpy array lands on the
device as its 32-bit counterpart: int64 as int32 and uint64 as uint32
(both wrapping, as numpy's ``astype`` does), float64 as float32 and
complex128 as complex64.  Every other dtype is kept.  The port applies
the same rule wherever host data enters it, so its device columns have
the reference's dtypes and values, slot for slot.

It also holds the numpy <-> torch dtype mapping, how the port handles
the unsigned dtypes torch supports only in part (``signed_view``,
``order_view``), and its own copy of JAX's dtype promotion lattice with
64-bit types off (``result_dtype``), which the expression AST follows.
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


# ---------------------------------------------------------------------- #
# JAX's dtype promotion with 64-bit types off
# ---------------------------------------------------------------------- #
# The JAX package's expressions promote as ``jnp`` does: a lattice over the
# dtypes and three *weak* kinds (``i*``, ``f*``, ``c*``: Python ints,
# floats and complexes, which take the other operand's dtype where it can
# hold their kind), and the least upper bound of the operands' nodes.
# With 64-bit types off no 64-bit node is ever formed from narrower ones,
# so the 64-bit nodes are left out and their edges joined up (int32 and
# the unsigned types reach ``f*`` through them; float32 reaches complex64).
_LATTICE = {
    "bool": ("i*",),
    "i*": ("uint8", "int8"),
    "uint8": ("int16", "uint16"),
    "uint16": ("int32", "uint32"),
    "uint32": ("int32",),
    "int8": ("int16",),
    "int16": ("int32",),
    "int32": ("f*",),
    "f*": ("bfloat16", "float16", "c*"),
    "bfloat16": ("float32",),
    "float16": ("float32",),
    "float32": ("complex64",),
    "c*": ("complex64",),
    "complex64": (),
}
#: a weak kind's dtype when the result stays weak
WEAK_DEFAULT = {"i*": torch.int32, "f*": torch.float32,
                "c*": torch.complex64}
_NODE = {getattr(torch, n): n for n in _LATTICE if "*" not in n}


def _upper_bounds(node: str) -> frozenset:
    seen, todo = set(), [node]
    while todo:
        n = todo.pop()
        if n not in seen:
            seen.add(n)
            todo.extend(_LATTICE[n])
    return frozenset(seen)


_UB = {n: _upper_bounds(n) for n in _LATTICE}


def lattice_node(dtype: torch.dtype) -> str:
    """The promotion-lattice node of a device dtype (64-bit dtypes have
    none: the port's columns never hold them)."""
    try:
        return _NODE[dtype]
    except KeyError:
        raise TypeError(f"{dtype} takes no part in the JAX package's "
                        f"promotion with 64-bit types off") from None


def result_dtype(*nodes: str) -> torch.dtype:
    """``jnp.result_type`` of operands given by their lattice nodes (a
    dtype's name, or ``i*`` / ``f*`` / ``c*`` for Python scalars): the
    least upper bound, a weak result taking its kind's default dtype."""
    if all("*" in n for n in nodes):
        # only weak operands: the bound of their strong defaults, as jnp
        nodes = tuple(lattice_node(WEAK_DEFAULT[n]) for n in nodes)
    todo = set(nodes)
    common = frozenset.intersection(*(_UB[n] for n in todo))
    lub = (common & todo) or {c for c in common if common <= _UB[c]}
    (node,) = lub
    return WEAK_DEFAULT[node] if node in WEAK_DEFAULT else getattr(torch, node)
