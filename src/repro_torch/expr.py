"""Typed column-expression AST — the declarative frontend of the planner.

The torch counterpart of ``repro.expr``: the same tree, rendering and
fingerprints; ``evaluate`` lowers to torch operations on the batched
``(p, capacity)`` columns of ``repro_torch.dataframe.Table``.

The original ``Plan.filter`` / ``Plan.map_columns`` took opaque Python
callables, which blinded every layer that wants to *reason* about the
computation: predicate pushdown could not tell which columns a lambda
touches, projection pushdown had to keep every input column alive, and the
structural-fingerprint compile cache could only key a callable by its
bytecode + closure (so two semantically identical lambdas from different
source lines forced separate compilations).

``Expr`` fixes all three at once.  An expression is a small immutable tree

    col("v") * 2 > lit(5)          # BinOp(">", BinOp("*", Col, Lit), Lit)

supporting arithmetic (``+ - * / // % **``), comparisons
(``< <= > >= == !=``), boolean algebra (``& | ^ ~``) and unary ops
(``-x``, ``abs``), and it exposes exactly the three views the engine needs:

* ``columns()``     — the set of input columns read (exact liveness for
                      projection pushdown and join-side predicate routing),
* ``fingerprint()`` — a canonical value-based string: equal for any two
                      structurally equal expressions however/wherever they
                      were built (stable compile-cache keys),
* ``evaluate(t)``   — lowering to torch operations over ``Table`` columns.

``OpaqueExpr`` wraps a legacy callable so the deprecated
``Plan.filter(callable)`` / ``Plan.map_columns`` paths keep executing; it
pins its *declared* columns (or ``None`` = unknown, blocking pushdown past
schema-changing boundaries, exactly the old conservative behaviour) and
fingerprints by bytecode + captured values, the best a callable allows.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, FrozenSet, Optional, Sequence

import numpy as np
import torch

from .dtypes import lattice_node, order_view, result_dtype, to_x32
from .nulls import mask_name

__all__ = ["Expr", "Col", "Lit", "BinOp", "UnaryOp", "OpaqueExpr", "IsNull",
           "FillNull", "col", "lit", "ensure_expr", "token"]


# ---------------------------------------------------------------------- #
# Canonical value tokens (shared with the planner's structural fingerprint)
# ---------------------------------------------------------------------- #
def token(v: Any) -> str:
    """Canonical string for a parameter value, usable as a cache-key part.

    Expressions delegate to their value-based ``fingerprint``; callables
    are hashed by bytecode + defaults + captured closure values (bytecode
    alone is not identity — two lambdas from one source line may differ
    only in captured values); arrays are hashed by raw bytes (repr
    truncates large arrays).
    """
    if isinstance(v, Expr):
        return f"expr:{v.fingerprint()}"
    if callable(v):
        code = getattr(v, "__code__", None)
        if code is None:
            return f"fn:{getattr(v, '__qualname__', repr(v))}"
        cells = []
        for c in (v.__closure__ or ()):
            try:
                cells.append(token(c.cell_contents))
            except ValueError:           # empty cell
                cells.append("<empty>")
        extras = (token(v.__defaults__ or ())
                  + token(getattr(v, "__kwdefaults__", None) or {})
                  + "|".join(cells))
        h = hashlib.sha1(code.co_code + repr(code.co_consts).encode()
                         + extras.encode())
        return f"fn:{v.__module__}.{v.__qualname__}:{h.hexdigest()[:12]}"
    if isinstance(v, dict):
        return "{" + ",".join(f"{k}:{token(v[k])}" for k in sorted(v)) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(token(x) for x in v) + "]"
    if isinstance(v, (np.ndarray, torch.Tensor)):
        a = _to_numpy(v)
        return (f"arr:{a.dtype}:{a.shape}:"
                f"{hashlib.sha1(a.tobytes()).hexdigest()[:12]}")
    return repr(v)


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


# ---------------------------------------------------------------------- #
# Operators, computed as the JAX package's jnp functions compute them
# ---------------------------------------------------------------------- #
# Operands promote as jnp promotes them, with 64-bit types off
# (``dtypes.result_dtype``): a Python scalar is weak (``int8 column + 1``
# stays int8, ``float16 column * 70000`` is float16: inf), a numpy scalar
# literal pins its dtype (``uint8 column + np.int8(3)`` is int16), a bool
# joins an int literal as int32.  Each operator then follows its jnp
# definition in the promoted dtype, division by zero included; nothing
# is left to what a device does with it.  Integer division and anything
# torch lacks for uint16 / uint32 run in int64 and wrap back.
_WIDE = (torch.uint16, torch.uint32)


def _node(v) -> str:
    if isinstance(v, torch.Tensor):
        return lattice_node(v.dtype)
    if isinstance(v, (bool, np.bool_)):
        return "bool"
    if isinstance(v, int):
        return "i*"
    if isinstance(v, float):
        return "f*"
    if isinstance(v, complex):
        return "c*"
    raise TypeError(f"cannot use {type(v).__name__} in a column expression")


def _convert(v, dtype: torch.dtype, device) -> torch.Tensor:
    """``v`` in ``dtype``, wrapping integers as jnp's conversion does.  A
    Python float reaches it through float32, as jnp's weak float does."""
    if not isinstance(v, torch.Tensor):
        if isinstance(v, float):
            v = torch.tensor(v, dtype=torch.float32, device=device)
        elif isinstance(v, (bool, np.bool_)):
            v = torch.tensor(bool(v), device=device)
        elif isinstance(v, int):
            v = torch.tensor(v, dtype=torch.int64, device=device)
        else:
            v = torch.tensor(v, dtype=torch.complex64, device=device)
    return v if v.dtype == dtype else v.to(dtype)


def _promote(op: str, va, vb, device):
    """Both operands converted to the dtype jnp computes ``op`` in: their
    result dtype, made numeric (bool as int32) for ``// % **`` and
    inexact (float32 for bool and integers) for ``/``."""
    dtype = result_dtype(_node(va), _node(vb))
    if op in _NUMERIC and dtype == torch.bool:
        dtype = torch.int32
    if op == "/" and not (dtype.is_floating_point or dtype.is_complex):
        dtype = torch.float32
    return (_flush(_convert(va, dtype, device)),
            _flush(_convert(vb, dtype, device)), dtype)


def _flush(v):
    """float32 subnormals as signed zeros: XLA's CPU backend runs with
    denormals flushed on input and output (so does a TPU), and the JAX
    package's expressions compute under it."""
    if isinstance(v, torch.Tensor) and v.dtype == torch.float32:
        return torch.where(v.abs() < _TINY, v * 0, v)
    return v


_TINY = torch.finfo(torch.float32).tiny


def _is_int(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def _ring(fn, a, b, dtype):
    """An integer op that wraps in ``dtype``: native where torch has it,
    else in int64, wrapped back."""
    if dtype in _WIDE:
        return fn(a.to(torch.int64), b.to(torch.int64)).to(dtype)
    return fn(a, b)


def _refuse(name, dtype):
    raise TypeError(f"{name} does not accept dtype {dtype}")


def _add(a, b, dtype):
    if dtype == torch.bool:
        return a | b
    return _ring(torch.add, a, b, dtype)


def _sub(a, b, dtype):
    if dtype == torch.bool:
        _refuse("sub", dtype)
    return _ring(torch.sub, a, b, dtype)


def _mul(a, b, dtype):
    if dtype == torch.bool:
        return a & b
    return _ring(torch.mul, a, b, dtype)


def _truediv(a, b, dtype):
    return a / b


def _int_parts(a, b):
    """Truncating quotient and remainder as XLA divides: x / 0 is -1
    (all ones unsigned) and x % 0 is x; int64 holds every quotient."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    zero = b == 0
    q = torch.div(a, torch.where(zero, 1, b), rounding_mode="trunc")
    q = torch.where(zero, -1, q)
    return a, b, q, torch.where(zero, a, a - q * b)


def _round_away(x):
    t = torch.trunc(x)
    return torch.where((x - t).abs() >= 0.5, t + torch.sign(x), t)


def _floordiv(a, b, dtype):
    if _is_int(dtype):
        a, b, q, r = _int_parts(a, b)
        if dtype.is_signed:
            q = torch.where((torch.sign(a) != torch.sign(b)) & (r != 0),
                            q - 1, q)
        return q.to(dtype)
    if dtype.is_complex:
        _refuse("floor_divide", dtype)
    # jnp's _float_divmod (CPython's float_divmod), rounded away from 0
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    ind = (mod != 0) & (torch.sign(b) != torch.sign(mod))
    return _round_away(torch.where(ind, div - 1, div))


def _mod(a, b, dtype):
    if _is_int(dtype):
        # jnp.remainder takes a zero divisor as 1, so x % 0 is 0 (in int64:
        # the card compares no uint32)
        a, b = a.to(torch.int64), b.to(torch.int64)
        b = torch.where(b == 0, 1, b)
        tm = a - torch.div(a, b, rounding_mode="trunc") * b
    elif dtype.is_complex:
        _refuse("remainder", dtype)
    else:
        tm = torch.fmod(a, b)
    plus = ((tm < 0) != (b < 0)) & (tm != 0)
    return torch.where(plus, tm + b, tm).to(dtype)


def _integer_pow(x, y: int):
    """``lax.integer_pow``: binary exponentiation with the exponent known,
    in ``x``'s dtype (int64 for integers, wrapped back)."""
    dtype = x.dtype
    if y < 0 and _is_int(dtype):
        raise TypeError(f"Integers cannot be raised to negative powers, "
                        f"got integer_pow({dtype}, {y})")
    if y == 0:
        return torch.ones_like(x)
    w = x.to(torch.int64) if _is_int(dtype) else x
    acc, n = None, abs(y)
    while n > 0:
        if n & 1:
            acc = w if acc is None else acc * w
        n >>= 1
        if n > 0:
            w = w * w
    if y < 0:
        acc = 1 / acc
    return acc.to(dtype)


def _pow(a, b, dtype):
    if not _is_int(dtype):
        return torch.pow(a, b)
    # jnp's _pow_int_int: six rounds of binary exponentiation over the
    # exponent's low bits (logical shifts), wrapping in the dtype
    bits = 8 * b.element_size()
    x, y = a.to(torch.int64), b.to(torch.int64) & ((1 << bits) - 1)
    acc = torch.where((x == 0) & (y != 0), 0, 1)
    for _ in range(6):
        acc = torch.where((y & 1) != 0, acc * x, acc)
        x = x * x
        y = y >> 1
    return acc.to(dtype)


def _bitwise(fn):
    def op(a, b, dtype):
        if not (_is_int(dtype) or dtype == torch.bool):
            _refuse(fn.__name__, dtype)
        return _ring(fn, a, b, dtype)
    return op


def _compare(fn):
    def op(a, b, dtype):
        if dtype in _WIDE:
            a, b = order_view(a), order_view(b)
        return fn(a, b)
    return op


_ARITH = {
    "+": _add, "-": _sub, "*": _mul, "/": _truediv, "//": _floordiv,
    "%": _mod, "**": _pow,
}
_COMPARE = {
    ">": _compare(torch.gt), ">=": _compare(torch.ge),
    "<": _compare(torch.lt), "<=": _compare(torch.le),
    "==": _compare(torch.eq), "!=": _compare(torch.ne),
}
_BOOL = {
    "&": _bitwise(torch.bitwise_and), "|": _bitwise(torch.bitwise_or),
    "^": _bitwise(torch.bitwise_xor),
}
_BINOPS = {**_ARITH, **_COMPARE, **_BOOL}
#: operators whose bool operands count as int32 (``promote_args_numeric``)
_NUMERIC = ("//", "%", "**")


def _neg(x):
    if x.dtype == torch.bool:
        _refuse("neg", x.dtype)
    if x.dtype in _WIDE:
        return (-x.to(torch.int64)).to(x.dtype)
    return -x


def _abs(x):
    if x.dtype == torch.bool or not (x.dtype.is_signed
                                     or x.dtype.is_complex):
        return x
    return torch.abs(x)


def _invert(x):
    if x.dtype == torch.bool:
        return ~x
    if not _is_int(x.dtype):
        _refuse("not", x.dtype)
    if x.dtype in _WIDE:
        return (~x.to(torch.int64)).to(x.dtype)
    return ~x


_UNARY = {"-": _neg, "abs": _abs, "~": _invert}


def _int_literal(e) -> Optional[int]:
    """The exponent of ``x ** e`` when ``e`` is a literal integer (jnp
    lowers that to ``lax.integer_pow``), else None."""
    if isinstance(e, Lit) and isinstance(e.value, (bool, np.bool_, int,
                                                  np.integer)):
        return int(e.value)
    return None

#: precedence for minimal-paren pretty printing — matches *Python's* table
#: (comparisons bind looser than & | ^), so rendered expressions parse back
#: to the same tree
_PREC = {"==": 1, "!=": 1, "<": 1, "<=": 1, ">": 1, ">=": 1,
         "|": 2, "^": 3, "&": 4,
         "+": 5, "-": 5, "*": 6, "/": 6, "//": 6, "%": 6, "**": 8}


# ---------------------------------------------------------------------- #
# Three-valued (Kleene) helpers
# ---------------------------------------------------------------------- #
def _is_bool(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.dtype == torch.bool
    return isinstance(v, (bool, np.bool_))


def as_tensor(v, device=None) -> torch.Tensor:
    """A tensor of ``v``; Python scalars take jnp's default dtypes (int32,
    float32, bool) rather than torch's int64."""
    if isinstance(v, torch.Tensor):
        return v if device is None else v.to(device)
    if isinstance(v, (bool, np.bool_)):
        return torch.tensor(bool(v), device=device)
    if isinstance(v, int):
        return torch.tensor(v, dtype=torch.int32, device=device)
    if isinstance(v, float):
        return torch.tensor(v, dtype=torch.float32, device=device)
    # JAX runs with 64-bit types disabled: numpy 64-bit values are 32-bit
    return torch.as_tensor(to_x32(v), device=device)


def _canon(value, valid):
    """Re-establish the canonical-zero invariant on a masked value."""
    if valid is None:
        return value
    value = as_tensor(value, valid.device)
    return torch.where(valid, value, torch.zeros_like(value))


def _and_valid(ma, mb):
    """Null-propagating validity combine (None = provably all-valid)."""
    if ma is None:
        return mb
    if mb is None:
        return ma
    return ma & mb


class Expr:
    """Base class: operator overloads build the tree; subclasses store it."""

    __slots__ = ()

    # -- engine-facing views (implemented by subclasses) ----------------- #
    def columns(self) -> Optional[FrozenSet[str]]:
        """Exact set of input columns read, or ``None`` if unknown
        (opaque callables without declared columns)."""
        raise NotImplementedError

    def fingerprint(self) -> str:
        """Canonical value-based identity (compile-cache key component)."""
        raise NotImplementedError

    def evaluate(self, table):
        """Lower to a torch value over ``table``'s columns."""
        raise NotImplementedError

    def evaluate_masked(self, table):
        """Kleene three-valued lowering: ``(value, valid)`` where ``valid``
        is a boolean validity array or ``None`` (provably all-valid — the
        common case, compiling to exactly the unmasked program).

        Invariant: wherever ``valid`` is False the returned ``value`` holds
        the canonical zero of its dtype (see ``repro.nulls``), so masked
        results hash / pack / compare bit-identically.
        """
        return self.evaluate(table), None

    def nullable(self, nulls) -> bool:
        """May this expression yield null, given ``nulls`` = the set of
        nullable input columns?  Conservative (True when unknown): the
        planner uses False to elide mask work, never to require it."""
        return True

    def is_boolean(self) -> bool:
        """True if this expression provably yields a boolean mask — the
        requirement for ``&``-conjunction splitting to be a sound rewrite
        (on integers ``&`` is bitwise, not logical)."""
        return False

    # -- operator overloads --------------------------------------------- #
    def _bin(self, op: str, other: Any, swap: bool = False) -> "BinOp":
        other = ensure_expr(other)
        return BinOp(op, other, self) if swap else BinOp(op, self, other)

    def __add__(self, o):
        return self._bin("+", o)

    def __radd__(self, o):
        return self._bin("+", o, swap=True)

    def __sub__(self, o):
        return self._bin("-", o)

    def __rsub__(self, o):
        return self._bin("-", o, swap=True)

    def __mul__(self, o):
        return self._bin("*", o)

    def __rmul__(self, o):
        return self._bin("*", o, swap=True)

    def __truediv__(self, o):
        return self._bin("/", o)

    def __rtruediv__(self, o):
        return self._bin("/", o, swap=True)

    def __floordiv__(self, o):
        return self._bin("//", o)

    def __rfloordiv__(self, o):
        return self._bin("//", o, swap=True)

    def __mod__(self, o):
        return self._bin("%", o)

    def __rmod__(self, o):
        return self._bin("%", o, swap=True)

    def __pow__(self, o):
        return self._bin("**", o)

    def __rpow__(self, o):
        return self._bin("**", o, swap=True)

    def __gt__(self, o):
        return self._bin(">", o)

    def __ge__(self, o):
        return self._bin(">=", o)

    def __lt__(self, o):
        return self._bin("<", o)

    def __le__(self, o):
        return self._bin("<=", o)

    # NOTE: == / != build expressions, so Exprs are not usefully hashable
    # by value and must not be used as dict keys / in sets.
    def __eq__(self, o):  # type: ignore[override]
        return self._bin("==", o)

    def __ne__(self, o):  # type: ignore[override]
        return self._bin("!=", o)

    __hash__ = None  # type: ignore[assignment]

    def __and__(self, o):
        return self._bin("&", o)

    def __rand__(self, o):
        return self._bin("&", o, swap=True)

    def __or__(self, o):
        return self._bin("|", o)

    def __ror__(self, o):
        return self._bin("|", o, swap=True)

    def __xor__(self, o):
        return self._bin("^", o)

    def __rxor__(self, o):
        return self._bin("^", o, swap=True)

    def __neg__(self):
        return UnaryOp("-", self)

    def __abs__(self):
        return UnaryOp("abs", self)

    def abs(self) -> "UnaryOp":
        return UnaryOp("abs", self)

    def is_null(self) -> "IsNull":
        """True where this expression is null (never null itself)."""
        return IsNull(self)

    def fill_null(self, value) -> "FillNull":
        """Replace null slots with ``value`` (scalar or expression)."""
        return FillNull(self, ensure_expr(value))

    def __invert__(self):
        return UnaryOp("~", self)

    def __bool__(self):
        raise TypeError(
            "an Expr has no truth value (it is a lazy column expression); "
            "use & | ~ for boolean logic, not `and`/`or`/`not`")

    def __repr__(self) -> str:
        return self._render(0)

    def _render(self, parent_prec: int) -> str:
        raise NotImplementedError


class Col(Expr):
    """Reference to a named input column."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        if not isinstance(name, str):
            raise TypeError(f"column name must be a str, got {type(name)}")
        object.__setattr__(self, "name", name)

    def __setattr__(self, *_):
        raise AttributeError("Expr nodes are immutable")

    def columns(self) -> FrozenSet[str]:
        return frozenset((self.name,))

    def fingerprint(self) -> str:
        return f"col({self.name})"

    def evaluate(self, table) -> torch.Tensor:
        try:
            return table.columns[self.name]
        except KeyError:
            raise KeyError(
                f"column {self.name!r} not in table "
                f"(have {list(table.column_names)})") from None

    def evaluate_masked(self, table):
        # null slots already hold canonical zero (ingest invariant)
        return self.evaluate(table), table.columns.get(mask_name(self.name))

    def nullable(self, nulls) -> bool:
        return self.name in nulls

    def _render(self, parent_prec: int) -> str:
        return self.name


class Lit(Expr):
    """Literal scalar.  Python scalars stay weakly typed (so ``col + 1.0``
    follows the weak-promotion rules of torch and jnp alike); numpy scalars
    pin their dtype.

    String literals are allowed in the tree (``col("s") == "oak"``) but
    never reach the device: the planner lowers them into int32 code
    comparisons against the column's dictionary
    (``dataframe.schema.lower_expr``) before compilation."""

    __slots__ = ("value",)

    def __init__(self, value):
        if isinstance(value, Expr):
            raise TypeError("lit() of an Expr — pass a scalar")
        if isinstance(value, (np.ndarray, torch.Tensor)) \
                and np.ndim(value) != 0:
            raise TypeError("lit() takes a scalar, not an array")
        object.__setattr__(self, "value", value)

    def __setattr__(self, *_):
        raise AttributeError("Expr nodes are immutable")

    def columns(self) -> FrozenSet[str]:
        return frozenset()

    def fingerprint(self) -> str:
        v = self.value
        if isinstance(v, (np.generic, np.ndarray, torch.Tensor)):
            a = _to_numpy(v)
            return f"lit({a.dtype}:{a.item()!r})"
        return f"lit({type(v).__name__}:{v!r})"

    def is_boolean(self) -> bool:
        return isinstance(self.value, (bool, np.bool_))

    def evaluate(self, table):
        if isinstance(self.value, (str, np.str_)):
            raise TypeError(
                f"string literal {self.value!r} reached evaluation without "
                f"being lowered against a column dictionary; string "
                f"literals are only usable in comparisons against a "
                f"dictionary-encoded column (the planner lowers them — "
                f"see docs/data_model.md)")
        if isinstance(self.value, np.generic):
            return as_tensor(self.value, table.device)  # pinned dtype
        return self.value  # torch ops promote python scalars weakly

    def nullable(self, nulls) -> bool:
        return False

    def _render(self, parent_prec: int) -> str:
        return repr(self.value)


class BinOp(Expr):
    __slots__ = ("op", "left", "right")

    def __init__(self, op: str, left: Expr, right: Expr):
        if op not in _BINOPS:
            raise ValueError(f"unknown binary op {op!r}")
        object.__setattr__(self, "op", op)
        object.__setattr__(self, "left", ensure_expr(left))
        object.__setattr__(self, "right", ensure_expr(right))

    def __setattr__(self, *_):
        raise AttributeError("Expr nodes are immutable")

    def columns(self) -> Optional[FrozenSet[str]]:
        l, r = self.left.columns(), self.right.columns()
        if l is None or r is None:
            return None
        return l | r

    def fingerprint(self) -> str:
        return (f"({self.left.fingerprint()}{self.op}"
                f"{self.right.fingerprint()})")

    def is_boolean(self) -> bool:
        if self.op in _COMPARE:
            return True
        if self.op in _BOOL:
            return self.left.is_boolean() and self.right.is_boolean()
        return False

    def _apply(self, va, vb, device):
        if self.op == "**":
            n = _int_literal(self.right)
            if n is not None:
                # jnp.power: an integer literal exponent is lax.integer_pow
                # of the base alone (bool bases count as int32)
                x = _convert(va, result_dtype(_node(va)), device)
                if x.dtype == torch.bool:
                    x = x.to(torch.int32)
                return _flush(_integer_pow(_flush(x), n))
            if isinstance(va, torch.Tensor) and isinstance(vb, torch.Tensor) \
                    and va.dtype.is_floating_point and _is_int(vb.dtype):
                return _flush(torch.pow(_flush(va), vb.to(va.dtype)))
        a, b, dtype = _promote(self.op, va, vb, device)
        if dtype.is_floating_point:
            # XLA rewrites a bool operand of a float product as a select:
            # x * bool is select(bool, x, 0), so False * -2.5, False * inf
            # and False * NaN are all +0; and bool column / scalar is
            # select(bool, 1 / scalar, 0), so False / 0 is +0
            if self.op == "*" and (_is_bool(va) or _is_bool(vb)):
                mask, x = (va, b) if _is_bool(va) else (vb, a)
                return _flush(torch.where(_convert(mask, torch.bool, device),
                                          x, torch.zeros_like(x)))
            if self.op == "/" and isinstance(va, torch.Tensor) \
                    and va.dtype == torch.bool and va.dim() \
                    and not (isinstance(vb, torch.Tensor) and vb.dim()):
                return _flush(torch.where(va, 1 / b, torch.zeros_like(b)))
        return _flush(_BINOPS[self.op](a, b, dtype))

    def evaluate(self, table):
        return self._apply(self.left.evaluate(table),
                           self.right.evaluate(table), table.device)

    def evaluate_masked(self, table):
        va, ma = self.left.evaluate_masked(table)
        vb, mb = self.right.evaluate_masked(table)
        value = self._apply(va, vb, table.device)
        if ma is None and mb is None:
            return value, None
        if self.op in ("&", "|") and _is_bool(va) and _is_bool(vb):
            # Kleene: a known false (&) / true (|) side decides the result
            # even when the other side is null.  Canonical zero means null
            # value slots already read as False.
            a_ok = True if ma is None else ma
            b_ok = True if mb is None else mb
            if self.op == "&":
                valid = (a_ok & b_ok) | (a_ok & ~va) | (b_ok & ~vb)
            else:
                valid = (a_ok & b_ok) | (a_ok & va) | (b_ok & vb)
        else:
            valid = _and_valid(ma, mb)
        return _canon(value, valid), valid

    def nullable(self, nulls) -> bool:
        return self.left.nullable(nulls) or self.right.nullable(nulls)

    def _render(self, parent_prec: int) -> str:
        prec = _PREC[self.op]
        if self.op == "**":    # right-associative: (a**b)**c needs parens
            s = (f"{self.left._render(prec + 1)} ** "
                 f"{self.right._render(prec)}")
        else:
            s = (f"{self.left._render(prec)} {self.op} "
                 f"{self.right._render(prec + 1)}")
        return f"({s})" if prec < parent_prec else s


class UnaryOp(Expr):
    __slots__ = ("op", "operand")

    def __init__(self, op: str, operand: Expr):
        if op not in _UNARY:
            raise ValueError(f"unknown unary op {op!r}")
        object.__setattr__(self, "op", op)
        object.__setattr__(self, "operand", ensure_expr(operand))

    def __setattr__(self, *_):
        raise AttributeError("Expr nodes are immutable")

    def columns(self) -> Optional[FrozenSet[str]]:
        return self.operand.columns()

    def fingerprint(self) -> str:
        return f"{self.op}({self.operand.fingerprint()})"

    def is_boolean(self) -> bool:
        return self.op == "~" and self.operand.is_boolean()

    def _apply(self, v, device):
        return _flush(_UNARY[self.op](_flush(as_tensor(v, device))))

    def evaluate(self, table):
        return self._apply(self.operand.evaluate(table), table.device)

    def evaluate_masked(self, table):
        v, m = self.operand.evaluate_masked(table)
        return _canon(self._apply(v, table.device), m), m

    def nullable(self, nulls) -> bool:
        return self.operand.nullable(nulls)

    def _render(self, parent_prec: int) -> str:
        if self.op == "abs":
            return f"abs({self.operand._render(0)})"
        # unary - / ~ bind at 7: looser than ** (so (-a)**2 needs parens —
        # Python parses "-a ** 2" as -(a**2)), tighter than * and /
        s = f"{self.op}{self.operand._render(7)}"
        return f"({s})" if parent_prec > 7 else s


class IsNull(Expr):
    """``expr.is_null()`` — True where the operand is null; never null
    itself (the SQL ``IS NULL`` escape from three-valued logic)."""

    __slots__ = ("operand",)

    def __init__(self, operand: Expr):
        object.__setattr__(self, "operand", ensure_expr(operand))

    def __setattr__(self, *_):
        raise AttributeError("Expr nodes are immutable")

    def columns(self) -> Optional[FrozenSet[str]]:
        return self.operand.columns()

    def fingerprint(self) -> str:
        return f"isnull({self.operand.fingerprint()})"

    def is_boolean(self) -> bool:
        return True

    def nullable(self, nulls) -> bool:
        return False

    def evaluate(self, table) -> torch.Tensor:
        # unmasked path: the operand is provably non-null
        v = as_tensor(self.operand.evaluate(table), table.device)
        return torch.zeros(v.shape, dtype=torch.bool, device=table.device)

    def evaluate_masked(self, table):
        v, m = self.operand.evaluate_masked(table)
        if m is None:
            v = as_tensor(v, table.device)
            return torch.zeros(v.shape, dtype=torch.bool,
                               device=table.device), None
        return ~m, None

    def _render(self, parent_prec: int) -> str:
        return f"is_null({self.operand._render(0)})"


class FillNull(Expr):
    """``expr.fill_null(v)`` — the operand with null slots replaced by
    ``v`` (a scalar or expression); null only where both are null."""

    __slots__ = ("operand", "fill")

    def __init__(self, operand: Expr, fill: Expr):
        object.__setattr__(self, "operand", ensure_expr(operand))
        object.__setattr__(self, "fill", ensure_expr(fill))

    def __setattr__(self, *_):
        raise AttributeError("Expr nodes are immutable")

    def columns(self) -> Optional[FrozenSet[str]]:
        a, b = self.operand.columns(), self.fill.columns()
        if a is None or b is None:
            return None
        return a | b

    def fingerprint(self) -> str:
        return (f"fillnull({self.operand.fingerprint()};"
                f"{self.fill.fingerprint()})")

    def is_boolean(self) -> bool:
        return self.operand.is_boolean() and self.fill.is_boolean()

    def nullable(self, nulls) -> bool:
        return self.fill.nullable(nulls)

    def evaluate(self, table):
        # unmasked path: nothing to fill
        return self.operand.evaluate(table)

    def evaluate_masked(self, table):
        vo, mo = self.operand.evaluate_masked(table)
        if mo is None:
            return vo, None
        vf, mf = self.fill.evaluate_masked(table)
        value = torch.where(mo, as_tensor(vo, mo.device),
                            as_tensor(vf, mo.device))
        valid = None if mf is None else (mo | mf)
        return _canon(value, valid), valid

    def _render(self, parent_prec: int) -> str:
        return (f"fill_null({self.operand._render(0)}, "
                f"{self.fill._render(0)})")


class OpaqueExpr(Expr):
    """Legacy-callable escape hatch (``fn(Table) -> Array``).

    ``cols`` pins the columns the callable reads; ``None`` means unknown,
    which forces the optimizer into the old conservative behaviour (no
    pushdown past schema-changing boundaries, full-schema liveness).  The
    fingerprint falls back to bytecode + captured values — stable for the
    *same* function object or closures over equal values, but distinct
    lambdas that compute the same thing still miss the cache (the
    instability typed expressions exist to fix).
    """

    __slots__ = ("fn", "_cols", "label")

    def __init__(self, fn: Callable, cols: Optional[Sequence[str]] = None,
                 label: Optional[str] = None):
        if not callable(fn):
            raise TypeError(f"OpaqueExpr needs a callable, got {type(fn)}")
        object.__setattr__(self, "fn", fn)
        object.__setattr__(self, "_cols",
                           None if cols is None else tuple(cols))
        object.__setattr__(self, "label",
                           label or getattr(fn, "__name__", "opaque"))

    def __setattr__(self, *_):
        raise AttributeError("Expr nodes are immutable")

    def columns(self) -> Optional[FrozenSet[str]]:
        return None if self._cols is None else frozenset(self._cols)

    def fingerprint(self) -> str:
        return f"opaque({token(self.fn)};cols={self._cols})"

    def evaluate(self, table):
        return self.fn(table)

    def _render(self, parent_prec: int) -> str:
        decl = ",".join(self._cols) if self._cols else "?"
        return f"<{self.label}:{decl}>"


# ---------------------------------------------------------------------- #
# Factories
# ---------------------------------------------------------------------- #
def col(name: str) -> Col:
    """Reference an input column: ``col("v") * 2 > lit(5)``."""
    return Col(name)


def lit(value) -> Lit:
    """Literal scalar (explicit form; bare scalars auto-lift in operators)."""
    return Lit(value)


def ensure_expr(v: Any) -> Expr:
    """Lift scalars to ``Lit``; pass ``Expr`` through; reject the rest.

    Strings lift too (``col("s") == "oak"``): they are lowered into
    dictionary-code comparisons by the planner, never evaluated raw."""
    if isinstance(v, Expr):
        return v
    if isinstance(v, (bool, int, float, complex, str, np.generic)):
        return Lit(v)
    if isinstance(v, (np.ndarray, torch.Tensor)) and np.ndim(v) == 0:
        return Lit(v)
    raise TypeError(f"cannot use {type(v).__name__} in a column expression; "
                    f"expected an Expr or a scalar")
