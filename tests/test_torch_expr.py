"""The port's expression AST (``repro_torch.expr``) against the JAX
package's (``repro.expr``) on the CPU.

Three parts:

* the JAX package's own ``tests/test_expr.py`` cases, aimed at the port;
* each class of the faults F4-F7 (``ROADMAP.md`` section 3) through
  ``with_columns`` and ``filter`` under ``execute`` in both packages, on
  the same numpy inputs, dtypes and values compared exactly: division by
  zero, unsigned columns in arithmetic and mixed comparisons, numpy-scalar
  literals, bool columns in arithmetic;
* a grid: 13 binary operators x 11 column dtypes, each column against
  every column and against 13 literals on either side, plus 3 unary
  operators (5,324 cases), evaluated by both packages.  Where the
  reference computes, the port gives the same dtype and the same bits;
  where the reference raises, the port raises.

Two cases have no contract and are left out of the grid's comparison:

* a Python int literal at or above 2**31: the reference raises
  ``OverflowError`` (it cannot pass such a literal to a jitted
  computation); the port wraps it to 32 bits;
* an integer ``**`` with a negative exponent: the reference's binary
  exponentiation walks the exponent's two's-complement bits.

The reference's grid runs its expressions under ``jax.jit``, one program
per operator, with each literal passed as a weakly typed argument (as
jnp's own jitted operators receive it; an integer exponent of ``**``
stays a constant, as jnp lowers it to ``lax.integer_pow``): the values
are the eager evaluation's, and the grid takes seconds instead of the
minutes one compilation per case would.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \\
        tests/test_torch_expr.py
"""

import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.dataframe.ops_local import filter_expr, with_columns
from repro_torch.dataframe.table import Table
from repro_torch.expr import (BinOp, Col, Lit, OpaqueExpr, col,
                              ensure_expr, lit, token)

N = 12
DTYPES = ("bool", "int8", "uint8", "int16", "uint16", "int32", "uint32",
          "int64", "float16", "float32", "float64")
LITS = (0, 2, -3, 70000, 2**31, 0.0, 2.5, True, np.int8(3), np.uint32(7),
        np.int64(5), np.float16(1.5), np.float32(1.5))
BINOPS = ("+", "-", "*", "/", "//", "%", "**",
          ">", ">=", "<", "<=", "==", "!=")
UNOPS = ("-", "abs", "~")
#: the literal the reference cannot take (no contract)
BIG = 2**31


def make_table(**cols):
    """One rank's columns as the port's (1, n) table on the CPU."""
    return Table.from_arrays({k: np.asarray(v)[None] for k, v in
                              cols.items()}, device="cpu")


def ev(e, t):
    """``e`` over ``t``, as numpy (a scalar result stays 0-d)."""
    v = e.evaluate(t)
    v = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
    return v.numpy()[0] if v.dim() == 2 else v.numpy()


# ---------------------------------------------------------------------- #
# The JAX package's tests/test_expr.py, aimed at the port
# ---------------------------------------------------------------------- #
def test_operator_overloads_build_tree():
    e = col("v") * 2 > lit(5)
    assert isinstance(e, BinOp) and e.op == ">"
    assert isinstance(e.left, BinOp) and e.left.op == "*"
    assert isinstance(e.left.left, Col) and e.left.left.name == "v"
    assert isinstance(e.right, Lit) and e.right.value == 5


def test_columns_exact_liveness():
    e = (col("a") + col("b") * col("a")) > -col("c")
    assert e.columns() == frozenset({"a", "b", "c"})
    assert lit(3).columns() == frozenset()


def test_reflected_scalars():
    a = 2 * col("v")
    b = col("v") * 2
    assert a.fingerprint() != b.fingerprint()
    r = 0.5 < col("v")
    assert r.op == ">" and isinstance(r.left, Col)


def test_is_boolean_classification():
    assert (col("v") > 0).is_boolean()
    assert ((col("v") > 0) & (col("w") < 1)).is_boolean()
    assert (~(col("v") > 0)).is_boolean()
    assert not (col("v") & col("w")).is_boolean()
    assert not (col("v") + 1).is_boolean()
    assert not OpaqueExpr(lambda t: t.col("v") > 0).is_boolean()


def test_no_truthiness():
    with pytest.raises(TypeError, match="truth value"):
        bool(col("v") > 0)


def test_immutability_and_validation():
    e = col("v")
    with pytest.raises(AttributeError):
        e.name = "w"
    with pytest.raises(TypeError):
        ensure_expr(["not", "a", "scalar"])
    with pytest.raises(TypeError):
        lit(np.arange(3))
    with pytest.raises(ValueError):
        BinOp("??", col("a"), col("b"))


def test_string_literals_lift_but_never_evaluate_raw():
    e = ensure_expr("oak")
    assert isinstance(e, Lit) and e.value == "oak"
    cmp = col("s") == "oak"
    assert isinstance(cmp.right, Lit) and cmp.right.value == "oak"
    t = make_table(s=np.arange(4, dtype=np.int32))
    with pytest.raises(TypeError, match="lowered against a column dict"):
        cmp.evaluate(t)


def test_fingerprint_value_based_across_construction_sites():
    def site_a():
        return (col("v") * 2 > lit(5)) & (col("w") != 0)

    def site_b():
        left = BinOp(">", BinOp("*", Col("v"), Lit(2)), Lit(5))
        return left & (col("w") != 0)
    assert site_a().fingerprint() == site_b().fingerprint()


def test_fingerprint_distinguishes_values_and_dtypes():
    assert (col("v") > 1).fingerprint() != (col("v") > 2).fingerprint()
    assert (col("v") > 1).fingerprint() != (col("v") > 1.0).fingerprint()
    assert (col("v") > np.float32(1)).fingerprint() != \
        (col("v") > 1.0).fingerprint()
    assert (col("v") > 1).fingerprint() != (col("w") > 1).fingerprint()
    assert (col("a") - col("b")).fingerprint() != \
        (col("b") - col("a")).fingerprint()


def test_token_delegates_to_expr_fingerprint():
    e = col("v") + 1
    assert token(e) == f"expr:{e.fingerprint()}"
    assert token({"x": e}) == "{" + f"x:expr:{e.fingerprint()}" + "}"


def test_arithmetic_matches_numpy_oracle():
    rng = np.random.default_rng(0)
    a = rng.random(64).astype(np.float32) + 0.5
    b = rng.random(64).astype(np.float32) + 0.5
    t = make_table(a=a, b=b)
    cases = {
        "add": (col("a") + col("b"), a + b),
        "sub": (col("a") - col("b"), a - b),
        "mul": (col("a") * col("b"), a * b),
        "div": (col("a") / col("b"), a / b),
        "floordiv": (col("a") // col("b"), np.floor_divide(a, b)),
        "mod": (col("a") % col("b"), np.mod(a, b)),
        "pow": (col("a") ** 2, a ** 2),
        "neg": (-col("a"), -a),
        "abs": (abs(col("a") - col("b")), np.abs(a - b)),
    }
    for name, (expr, want) in cases.items():
        got = ev(expr, t)
        assert got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)


def test_comparisons_and_boolean_algebra_match_numpy():
    a = np.array([1, 5, 3, 7, 2], np.int32)
    b = np.array([4, 5, 1, 0, 2], np.int32)
    t = make_table(a=a, b=b)
    for op, np_op in ((">", np.greater), (">=", np.greater_equal),
                      ("<", np.less), ("<=", np.less_equal),
                      ("==", np.equal), ("!=", np.not_equal)):
        got = ev(BinOp(op, col("a"), col("b")), t)
        assert got.dtype == np.bool_
        np.testing.assert_array_equal(got, np_op(a, b), err_msg=op)
    e = ((col("a") > 2) & (col("b") < 4)) | ~(col("a") == col("b"))
    want = ((a > 2) & (b < 4)) | ~(a == b)
    np.testing.assert_array_equal(ev(e, t), want)


def test_dtype_promotion_int_float():
    i = np.arange(8, dtype=np.int32)
    f = np.linspace(0, 1, 8, dtype=np.float32)
    t = make_table(i=i, f=f)
    assert ev(col("i") + col("f"), t).dtype == np.float32
    assert ev(col("i") + 1, t).dtype == np.int32
    got = ev(col("i") * 1.5, t)
    assert np.issubdtype(got.dtype, np.floating)
    np.testing.assert_allclose(got, i * 1.5)


def test_nan_comparison_semantics():
    v = np.array([1.0, np.nan, 3.0, np.nan], np.float32)
    t = make_table(v=v)
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(ev(col("v") > 2.0, t), v > 2.0)
        np.testing.assert_array_equal(ev(col("v") == col("v"), t), v == v)
    kept = filter_expr(t, col("v") > 0).to_numpy()["v"]
    np.testing.assert_array_equal(kept, np.array([1.0, 3.0], np.float32))


def test_opaque_expr_evaluates_and_declares():
    t = make_table(v=np.array([1.0, -2.0, 3.0], np.float32))
    e = OpaqueExpr(lambda tb: tb.col("v") > 0, cols=("v",))
    assert e.columns() == frozenset({"v"})
    np.testing.assert_array_equal(ev(e, t), [True, False, True])
    assert OpaqueExpr(lambda tb: tb.col("v")).columns() is None


def test_filter_expr_requires_boolean():
    t = make_table(v=np.arange(4, dtype=np.int32))
    with pytest.raises(TypeError, match="must be boolean"):
        filter_expr(t, col("v") + 1)


def test_filter_expr_respects_padding():
    t = Table.from_arrays({"v": np.array([[5, -1, 7]], np.int32)},
                          capacity=8, device="cpu")
    out = filter_expr(t, col("v") > 0)
    assert int(out.row_count[0]) == 2
    np.testing.assert_array_equal(out.to_numpy()["v"], [5, 7])


def test_with_columns_simultaneous_and_broadcast():
    t = make_table(a=np.array([1.0, 2.0], np.float32),
                   b=np.array([10.0, 20.0], np.float32))
    out = with_columns(t, {"a": col("b"), "b": col("a"), "c": lit(7.0),
                           "d": col("a") * col("b")})
    o = out.to_numpy()
    np.testing.assert_array_equal(o["a"], [10.0, 20.0])
    np.testing.assert_array_equal(o["b"], [1.0, 2.0])
    np.testing.assert_array_equal(o["c"], [7.0, 7.0])
    np.testing.assert_array_equal(o["d"], [10.0, 40.0])


def test_missing_column_error_names_have():
    t = make_table(v=np.arange(4, dtype=np.int32))
    with pytest.raises(KeyError, match="not in table"):
        col("nope").evaluate(t)


def test_render_minimal_python_accurate_parens():
    assert repr(col("v") * 2 > lit(5)) == "v * 2 > 5"
    assert repr((col("a") > 0) & (col("b") < 1)) == "(a > 0) & (b < 1)"
    assert repr((col("a") + col("b")) * col("c")) == "(a + b) * c"
    assert repr(-col("v") + 1) == "-v + 1"
    assert repr(~(col("a") > 0)) == "~(a > 0)"
    assert repr(abs(col("a") - col("b"))) == "abs(a - b)"


def test_render_parses_back_to_same_tree():
    cases = [
        col("v") * 2 > lit(5),
        (col("a") > 0) & ((col("b") < 1) | (col("a") == col("b"))),
        -col("a") + col("b") * col("c"),
        col("a") % 3 != 0,
        (col("a") ** col("b")) ** col("c"),
        col("a") ** (col("b") ** col("c")),
        (-col("a")) ** 2,
        -(col("a") ** 2),
    ]
    names = {"a": col("a"), "b": col("b"), "c": col("c"), "v": col("v")}
    for e in cases:
        rebuilt = eval(repr(e), {"__builtins__": {}}, dict(names))
        assert rebuilt.fingerprint() == e.fingerprint(), repr(e)


# ---------------------------------------------------------------------- #
# F4-F7 end to end: with_columns and filter under execute, both packages
# ---------------------------------------------------------------------- #
FAULT_DATA = {
    # F4: the ROADMAP's a = [5, 0, -3, 7] and a zero divisor, per dtype
    "a": np.array([5, 0, -3, 7, 2**31 - 1, -2**31, 1, -1, 9, 0, 4, -8],
                  np.int32),
    "z": np.zeros(12, np.int32),
    "m": np.array([2, 0, -2, 3, -1, -1, 0, 5, -4, 7, 0, 3], np.int32),
    "u": np.array([0, 1, 5, 2**31, 2**32 - 1, 7, 3, 2**31 + 5, 9, 0, 4,
                   100], np.uint32),
    "u16": np.array([0, 1, 65535, 40000, 7, 3, 2, 32768, 9, 0, 4, 100],
                    np.uint16),
    "i": np.array([-1, 2, -3, 4, 5, -6, 7, -8, 9, -10, 11, 2**31 - 1],
                  np.int32),
    "u8": np.array([0, 1, 250, 128, 7, 3, 2, 200, 9, 0, 4, 100], np.uint8),
    "i8": np.array([0, 1, -128, 127, 7, -3, 2, -100, 9, 0, 4, 100],
                   np.int8),
    "f": np.array([1.5, -2.5, 0.0, -0.0, 7.0, np.inf, -np.inf, np.nan, 1e3,
                   -1e-3, 3.0, 4.0], np.float32),
    "fz": np.zeros(12, np.float32),
    "f16": np.array([1.5, -2.5, 0.0, -0.0, 7.0, 0.5, 100.0, -3.0, 60000.0,
                     1e-3, 2.0, -1.0], np.float16),
}


def _fault_cases(m):
    """(label, exprs for with_columns, predicate for filter or None) over
    the expression module ``m`` — one entry per ROADMAP example."""
    c = m.col
    return [
        # F4: division by zero, integer and float, signed and unsigned
        ("F4 int32 // and % by 0",
         {"q": c("a") // c("z"), "r": c("a") % c("z")},
         c("a") // c("z") < -1),
        ("F4 int32 // and % by literal 0",
         {"q": c("a") // 0, "r": c("a") % 0}, None),
        ("F4 int32 // and % by a mixed divisor",
         {"q": c("a") // c("m"), "r": c("a") % c("m")}, c("a") % c("m") == 0),
        ("F4 uint32 // and % by 0",
         {"q": c("u") // c("z"), "r": c("u") % 0}, None),
        ("F4 float // and % by 0",
         {"q": c("f") // c("fz"), "r": c("f") % c("fz"), "p": c("f") // 0.0},
         None),
        # F5: unsigned arithmetic and mixed comparisons
        ("F5 uint32 + 1", {"x": c("u") + 1, "y": c("u") * 3 - 2}, None),
        ("F5 int32 + uint32 and int32 + uint16",
         {"x": c("i") + c("u"), "y": c("i") + c("u16"),
          "z": c("u16") - c("i")}, None),
        ("F5 filter int32 < uint32", {"x": c("i") < c("u")},
         c("i") < c("u")),
        ("F5 filter uint16 >= int32", {"x": c("u16") >= c("i")},
         c("u16") >= c("i")),
        # F6: numpy-scalar literals pin their dtype
        ("F6 uint8 + np.int8", {"x": c("u8") + np.int8(3)},
         c("u8") + np.int8(3) > 100),
        ("F6 float16 + np.float32", {"x": c("f16") + np.float32(1.5)}, None),
        ("F6 int8 + np.uint32", {"x": c("i8") + np.uint32(7)}, None),
        ("F6 float16 * 70000", {"x": c("f16") * 70000, "y": 70000 * c("f16")},
         c("f16") * 70000 > 0),
    ]


def _bool_cases(m):
    c = m.col
    return [("F7 bool * 2", {"x": c("flag") * 2}),
            ("F7 1 - bool", {"x": 1 - c("flag")}),
            ("F7 abs(bool)", {"x": abs(c("flag"))}),
            ("F7 bool // 2", {"x": c("flag") // 2}),
            ("F7 bool % 2 and bool ** 3",
             {"x": c("flag") % 2, "y": c("flag") ** 3})]


def _reference_fault_runs():
    import repro.expr as rexpr
    from repro.core import CylonEnv, DistTable, Plan, execute
    env = CylonEnv()
    t = DistTable.from_numpy(FAULT_DATA, 1)
    out = {}
    for label, exprs, pred in _fault_cases(rexpr):
        out[label] = execute(Plan.scan("t").with_columns(exprs), env,
                             {"t": t}).to_numpy()
        if pred is not None:
            out[label + "/filter"] = execute(Plan.scan("t").filter(pred),
                                             env, {"t": t}).to_numpy()
    return out


@pytest.fixture(scope="module")
def fault_reference():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return _reference_fault_runs()


def _bits_equal(got, want) -> bool:
    """Equal values, bit for bit (signed zeros included); a NaN equals
    any NaN, as NaN's sign and payload depend on the device that made
    it."""
    if want.dtype.kind != "f":
        return np.array_equal(got, want)
    nan = np.isnan(want)
    return (np.array_equal(nan, np.isnan(got))
            and np.array_equal(got[~nan].view(f"u{got.itemsize}"),
                               want[~nan].view(f"u{want.itemsize}")))


def _same(got, want, what):
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert _bits_equal(got, want), (what, got, want)


@pytest.mark.parametrize("label", [c[0] for c in _fault_cases(
    __import__("repro_torch.expr", fromlist=["col"]))])
def test_fault_class_through_execute(fault_reference, label):
    import repro_torch.expr as pexpr
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    env = CylonEnv(1, device="cpu")
    t = DistTable.from_numpy(FAULT_DATA, 1, device="cpu")
    _, exprs, pred = next(c for c in _fault_cases(pexpr) if c[0] == label)
    got = execute(Plan.scan("t").with_columns(exprs), env,
                  {"t": t}).to_numpy()
    want = fault_reference[label]
    assert sorted(got) == sorted(want)
    for name in want:
        _same(got[name], want[name], f"{label}: {name}")
    if pred is not None:
        got = execute(Plan.scan("t").filter(pred), env, {"t": t}).to_numpy()
        want = fault_reference[label + "/filter"]
        for name in want:
            _same(got[name], want[name], f"{label} filter: {name}")


def test_fault_examples_as_the_roadmap_states_them(fault_reference):
    # F4's values as the reference computes them: x // 0 is -1 at x = 0
    # and -2 elsewhere, x % 0 is 0; float x // 0 is NaN
    q = fault_reference["F4 int32 // and % by 0"]
    np.testing.assert_array_equal(q["q"][:4], [-2, -1, -2, -2])
    np.testing.assert_array_equal(q["r"][:4], [0, 0, 0, 0])
    assert np.isnan(fault_reference["F4 float // and % by 0"]["p"]).all()
    # F5: the filter keeps what the reference keeps after x32 promotion
    kept = fault_reference["F5 filter int32 < uint32/filter"]["i"]
    assert len(kept) == int(((FAULT_DATA["i"]) <
                             FAULT_DATA["u"].astype(np.int32)).sum())
    # F6: the reference's result dtypes
    assert fault_reference["F6 uint8 + np.int8"]["x"].dtype == np.int16
    assert fault_reference["F6 float16 + np.float32"]["x"].dtype == \
        np.float32
    assert fault_reference["F6 int8 + np.uint32"]["x"].dtype == np.int32
    assert np.isinf(fault_reference["F6 float16 * 70000"]["x"][:2]).all()


def _frontend_bool_run(rdf, m, env_kw):
    """``assign(flag=df.a > 0)`` and arithmetic on the flag (F7)."""
    a = np.array([3, -1, 0, 7, -5, 2, 9, -4], np.int32)
    with rdf.session(**env_kw):
        df = rdf.read_numpy({"a": a})
        df = df.assign(flag=df.a > 0)
        return {label: df.assign(**exprs).to_numpy()
                for label, exprs in _bool_cases(m)}


def test_bool_columns_through_the_frontend():
    import repro.df as jdf
    import repro.expr as jexpr
    import repro_torch.df as tdf
    import repro_torch.expr as texpr
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _frontend_bool_run(jdf, jexpr, {})
    got = _frontend_bool_run(tdf, texpr, {"device": "cpu"})
    for label in want:
        for name in want[label]:
            _same(got[label][name], want[label][name], f"{label}: {name}")
    assert want["F7 bool * 2"]["x"].dtype == np.int32


# ---------------------------------------------------------------------- #
# The grid
# ---------------------------------------------------------------------- #
def _grid_data():
    rng = np.random.default_rng(0)
    out = {}
    for d in DTYPES:
        dt = np.dtype(d)
        if dt == np.bool_:
            v = rng.integers(0, 2, N).astype(bool)
        elif dt.kind == "u":
            v = rng.integers(0, min(np.iinfo(dt).max, 300) + 1, N)
            v[:3] = [0, 1, np.iinfo(dt).max]
        elif dt.kind == "i":
            v = rng.integers(-100, 101, N)
            v[:4] = [0, 1, -1, min(np.iinfo(dt).max, 2**31 - 1)]
        else:
            v = rng.standard_normal(N) * 50
            v[:4] = [0.0, -0.0, 1.5, -2.5]
        out[f"c_{d}"] = v.astype(dt)
    return out


def _grid_specs():
    """(name, op, kind, column, other): ``kind`` is cc (column op
    column), cl (column op literal ``LITS[other]``), lc or u (unary)."""
    specs = []
    for op in BINOPS:
        for a in DTYPES:
            specs += [(f"c_{a} {op} c_{b}", op, "cc", a, b) for b in DTYPES]
            for i, v in enumerate(LITS):
                specs.append((f"c_{a} {op} {v!r}", op, "cl", a, i))
                specs.append((f"{v!r} {op} c_{a}", op, "lc", a, i))
    specs += [(f"{op}(c_{a})", op, "u", a, None) for op in UNOPS
              for a in DTYPES]
    return specs


def _build(m, spec, lits):
    _, op, kind, a, b = spec
    if kind == "u":
        return m.UnaryOp(op, m.col(f"c_{a}"))
    if kind == "cc":
        return m.BinOp(op, m.col(f"c_{a}"), m.col(f"c_{b}"))
    v = m.Lit(lits[b])
    return (m.BinOp(op, m.col(f"c_{a}"), v) if kind == "cl"
            else m.BinOp(op, v, m.col(f"c_{a}")))


def _integer_exponent(spec) -> bool:
    """jnp lowers ``x ** k`` with a literal integer ``k`` to integer_pow:
    that literal must stay a constant in the reference's program."""
    _, op, kind, _, b = spec
    return (op == "**" and kind == "cl"
            and isinstance(LITS[b], (bool, int, np.integer)))


def _reference_grid():
    """name -> ("ok", array) | ("raise", message) from the JAX package."""
    import jax
    import repro.expr as rexpr
    from repro.dataframe.table import Table as JTable
    t = JTable.from_arrays(_grid_data())
    # Python ints past int32 cannot be jit arguments; their cases raise
    # in the reference either way (no contract)
    args = [0 if isinstance(v, int) and abs(v) >= BIG else v for v in LITS]
    groups = {}
    for spec in _grid_specs():
        groups.setdefault((spec[1], spec[2] == "u"), []).append(spec)
    out, lowered = {}, []
    for specs in groups.values():
        raised = {}

        def program(cols, lits, specs=specs, raised=raised):
            tb = JTable(cols, t.row_count)
            vals = []
            for spec in specs:
                use = [LITS[i] if _integer_exponent(spec) or
                       (isinstance(LITS[i], int) and abs(LITS[i]) >= BIG)
                       else lits[i] for i in range(len(LITS))]
                try:
                    vals.append(_build(rexpr, spec, use).evaluate(tb))
                except Exception as e:  # the reference refuses the case
                    raised[spec[0]] = f"{type(e).__name__}: {e}"
                    vals.append(None)
            return vals

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            lowered.append((specs, raised,
                            jax.jit(program).lower(t.columns, args)))
    # the programs compile side by side (tracing above holds the GIL)
    with ThreadPoolExecutor(4) as pool:
        built = list(pool.map(lambda x: x[2].compile(), lowered))
    for (specs, raised, _), program in zip(lowered, built):
        vals = program(t.columns, args)
        for spec, v in zip(specs, vals):
            out[spec[0]] = (("raise", raised[spec[0]]) if spec[0] in raised
                            else ("ok", np.asarray(v)))
    return out


@pytest.fixture(scope="module")
def grid_reference():
    return _reference_grid()


def _port_grid():
    import repro_torch.expr as pexpr
    from repro_torch.dtypes import to_x32
    # device columns hold what ingest gives them: 64-bit narrowed
    t = make_table(**{k: to_x32(v) for k, v in _grid_data().items()})
    out = {}
    for spec in _grid_specs():
        try:
            out[spec[0]] = ("ok", ev(_build(pexpr, spec, LITS), t))
        except Exception as e:
            out[spec[0]] = ("raise", f"{type(e).__name__}: {e}")
    return out


@pytest.fixture(scope="module")
def grid_port():
    return _port_grid()


def _negative_int_exponent(spec, want):
    """Elements of an integer ``**`` whose exponent is negative (no
    contract), as a mask over the result."""
    _, op, kind, a, b = spec
    if op != "**" or want.dtype.kind not in "iu":
        return None
    data = _grid_data()
    if kind == "cc":
        e = data[f"c_{b}"]
    elif kind == "cl":
        e = np.asarray(LITS[b])
    elif kind == "lc":
        e = data[f"c_{a}"]
    else:
        return None
    if e.dtype.kind == "b":
        return None
    return np.broadcast_to(e < 0, want.shape)


def _departures(specs, ref, port):
    bad = []
    for spec in specs:
        name = spec[0]
        if spec[2] in ("cl", "lc") and LITS[spec[4]] is BIG:
            continue  # no contract (module docstring)
        (rk, rv), (pk, pv) = ref[name], port[name]
        if rk == "raise":
            if pk != "raise":
                bad.append((name, "the reference raises", rv[:80], pv))
            continue
        if pk == "raise":
            bad.append((name, "the port raises", pv[:80]))
            continue
        want = np.broadcast_to(rv, (N,))
        got = np.broadcast_to(pv, (N,))
        if got.dtype != want.dtype:
            bad.append((name, "dtype", want.dtype, got.dtype))
            continue
        skip = _negative_int_exponent(spec, want)
        if skip is not None:
            want, got = want[~skip], got[~skip]
        if not _bits_equal(got, want):
            bad.append((name, "values", want, got))
    return bad


@pytest.mark.parametrize("op", BINOPS + ("unary",))
def test_grid_equals_the_reference(grid_reference, grid_port, op):
    specs = [s for s in _grid_specs()
             if (s[2] == "u") == (op == "unary")
             and (op == "unary" or s[1] == op)]
    assert len(specs) == (33 if op == "unary" else 407)
    bad = _departures(specs, grid_reference, grid_port)
    assert not bad, f"{len(bad)} departures, first: {bad[:5]}"


def test_grid_covers_every_class(grid_reference):
    # 5,324 cases; the reference computes most and refuses some (bool
    # subtraction and negation, ~ on floats, the 2**31 literal, ...)
    assert len(grid_reference) == 13 * 407 + 33
    kinds = [k for k, _ in grid_reference.values()]
    assert kinds.count("ok") > 4500 and kinds.count("raise") > 250


def test_integer_division_by_zero_on_a_card_tensor_path_is_masked():
    # the divisor is masked explicitly, so nothing is left to how a
    # device divides by zero: the CPU gives what the card gives
    t = make_table(a=np.array([5, 0, -3, 7], np.int32),
                   u=np.array([5, 0, 3, 7], np.uint32))
    np.testing.assert_array_equal(ev(col("a") // 0, t), [-2, -1, -2, -2])
    np.testing.assert_array_equal(ev(col("a") % 0, t), [0, 0, 0, 0])
    assert (ev(col("u") // 0, t) == np.iinfo(np.uint32).max).all()
    np.testing.assert_array_equal(ev(col("u") % 0, t), [0, 0, 0, 0])
