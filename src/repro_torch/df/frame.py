"""Lazy ``DataFrame``: pandas/Dask-style frontend over the planner.

The torch counterpart of ``repro.df.frame``.  A ``DataFrame`` is a
*recipe*: it wraps a ``core.plan.Plan`` tree plus the source tables its
scans refer to, and tracks the output schema so column references are
validated at build time.  Nothing executes until ``collect()`` /
``to_numpy()``; ``explain()`` shows the optimized plan.  Every
transformation returns a new DataFrame (plans are immutable), so partial
pipelines can be shared and extended freely — the structural-fingerprint
stage cache means two DataFrames that describe the same computation share
one built stage per env.

Column references are typed expressions (``repro_torch.expr``): ``df.v``
/ ``df["v"]`` is ``col("v")``, so ``df[df.v * 2 > 5]`` builds a
declarative predicate the optimizer can split, push past joins, and prune
columns through.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
queue-1 item: out-of-core sources and runs (``read_numpy(spill=True)``,
``from_table`` of a host column dict, ``collect(morsel_rows=)``; item 7),
``read_parquet`` / ``read_csv`` (item 8), ``collect(analyze=, trace=)``
and ``explain_analyze`` (item 9), and the fault-tolerance and adaptive
options of ``collect`` (item 10).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.env import CylonEnv, DistTable
from ..core.plan import Plan, execute
from ..expr import Col, Expr, ensure_expr
from ..nulls import data_columns
from ..planner.logical import groupby_schema, join_schema
from .session import get_env, not_ported, refuse_deferred

__all__ = ["DataFrame", "GroupBy", "read_numpy", "from_pandas", "from_table",
           "read_parquet", "read_csv"]

_src_ids = itertools.count()


class DataFrame:
    """Lazy distributed dataframe (see module docstring).

    Do not construct directly — use ``read_numpy`` / ``from_pandas`` /
    ``from_table``, or derive from an existing DataFrame.
    """

    __slots__ = ("plan", "sources", "_schema", "_env")

    def __init__(self, plan: Plan, sources: Dict[str, Any],
                 schema: Sequence[str], env: Optional[CylonEnv] = None):
        object.__setattr__(self, "plan", plan)
        object.__setattr__(self, "sources", sources)
        object.__setattr__(self, "_schema", tuple(sorted(schema)))
        # env the data was ingested for (read_numpy(env=...)); preferred
        # over the ambient session at collect() so the frame keeps running
        # on the gang its tables are partitioned for
        object.__setattr__(self, "_env", env)

    def __setattr__(self, name, value):
        raise AttributeError(
            "DataFrames are immutable; use assign(...) to add columns")

    # ------------------------------------------------------------------ #
    # schema / column access
    # ------------------------------------------------------------------ #
    @property
    def columns(self) -> Tuple[str, ...]:
        return self._schema

    def _check_cols(self, cols, what: str) -> None:
        missing = sorted(set(cols) - set(self._schema))
        if missing:
            raise KeyError(f"{what} references unknown column(s) {missing}; "
                           f"have {list(self._schema)}")

    def _derive(self, plan: Plan, schema: Sequence[str],
                sources: Optional[Dict[str, Any]] = None,
                env: Optional[CylonEnv] = None) -> "DataFrame":
        return DataFrame(plan, self.sources if sources is None else sources,
                         schema, env if env is not None else self._env)

    def __getattr__(self, name: str) -> Col:
        # only reached when normal attribute lookup fails; shadowed column
        # names (e.g. a column called "merge") are reachable via df["merge"]
        if not name.startswith("_") and name in self._schema:
            return Col(name)
        raise AttributeError(f"no attribute or column {name!r} "
                             f"(columns: {list(self._schema)})")

    def __dir__(self) -> List[str]:
        return sorted(set(super().__dir__()) | set(self._schema))

    def __getitem__(self, key):
        if isinstance(key, Expr):
            return self.filter(key)
        if isinstance(key, str):
            self._check_cols([key], "df[...]")
            return Col(key)
        if isinstance(key, (list, tuple)):
            return self.select(key)
        raise TypeError(f"cannot index a DataFrame with {type(key).__name__}")

    # ------------------------------------------------------------------ #
    # transformations (all lazy)
    # ------------------------------------------------------------------ #
    def filter(self, pred: Expr) -> "DataFrame":
        """Keep rows where the boolean expression holds
        (``df[df.v > 0]`` is sugar for ``df.filter(df.v > 0)``)."""
        if not isinstance(pred, Expr):
            raise TypeError(
                "filter takes a typed expression (df.v > 0); for a legacy "
                "callable use the core Plan's deprecated shim")
        cols = pred.columns()
        if cols is not None:
            self._check_cols(cols, "filter predicate")
        return self._derive(self.plan.filter(pred), self._schema)

    def select(self, cols: Sequence[str]) -> "DataFrame":
        """Projection: ``df[["k", "v"]]``."""
        cols = list(cols)
        self._check_cols(cols, "select")
        return self._derive(self.plan.project(cols), cols)

    def assign(self, **exprs: Union[Expr, Any]) -> "DataFrame":
        """Add or replace columns: ``df.assign(v2=df.v * 2)``.

        All expressions read the *input* frame (simultaneous assignment,
        like pandas); bare scalars broadcast to constant columns.
        """
        return self.with_columns(exprs)

    def with_columns(self, exprs: Mapping[str, Union[Expr, Any]]
                     ) -> "DataFrame":
        """Dict form of ``assign`` (allows non-identifier column names)."""
        mapping = {name: ensure_expr(e) for name, e in exprs.items()}
        for name, e in mapping.items():
            cols = e.columns()
            if cols is not None:
                self._check_cols(cols, f"assign {name!r}")
        return self._derive(self.plan.with_columns(mapping),
                            set(self._schema) | set(mapping))

    def merge(self, other: "DataFrame", on: str, **kw) -> "DataFrame":
        """Inner equi-join (hash-partitioned on ``on``); colliding right
        columns get the ``_r`` suffix.  Extra ``kw`` (``out_capacity``,
        ``bucket_capacity``, ``shuffle_out_capacity``, ...) pass through to
        the join operator."""
        if not isinstance(other, DataFrame):
            raise TypeError("merge expects another repro_torch.df.DataFrame")
        self._check_cols([on], "merge key")
        other._check_cols([on], "merge key")
        clash = [n for n in self.sources
                 if n in other.sources
                 and other.sources[n] is not self.sources[n]]
        if clash:
            # silently keeping one side would make both scans read the
            # same table and return wrong data
            raise ValueError(
                f"merge source name collision on {clash}: the frames were "
                f"built from different tables under the same scan name — "
                f"pass distinct name= to from_table/read_numpy")
        if (self._env is not None and other._env is not None
                and other._env is not self._env):
            raise ValueError(
                "merge of frames ingested for different envs; re-ingest "
                "one side (read_numpy(..., env=...)) on a common env")
        sources = {**self.sources, **other.sources}
        schema = join_schema(self._schema, other._schema, on)
        return self._derive(self.plan.join(other.plan, on=on, **kw),
                            schema, sources, env=self._env or other._env)

    def groupby(self, keys: Union[str, Sequence[str]], **kw) -> "GroupBy":
        """Group by key column(s); terminate with ``.agg(...)``.  Extra
        ``kw`` (``bucket_capacity``, ``out_capacity``, ``pre_aggregate``,
        ...) pass through to the groupby operator."""
        keys = [keys] if isinstance(keys, str) else list(keys)
        self._check_cols(keys, "groupby keys")
        return GroupBy(self, keys, kw)

    def sort_values(self, by: Union[str, Sequence[str]], **kw) -> "DataFrame":
        """Globally sort (ascending) by column(s): sample-sort range
        partitioning + local sort."""
        by = [by] if isinstance(by, str) else list(by)
        self._check_cols(by, "sort_values")
        return self._derive(self.plan.sort(by, **kw), self._schema)

    # -- missing data ---------------------------------------------------- #
    def dropna(self, subset: Optional[Sequence[str]] = None) -> "DataFrame":
        """Drop rows that are null in any of ``subset`` (default: any
        column).  Lowers to a null-aware filter, so the optimizer elides
        the check entirely for provably non-null columns."""
        cols = list(self._schema) if subset is None else list(subset)
        if subset is not None:
            self._check_cols(cols, "dropna subset")
        if not cols:
            return self
        pred: Expr = ~Col(cols[0]).is_null()
        for c in cols[1:]:
            pred = pred & ~Col(c).is_null()
        return self.filter(pred)

    def fillna(self, value: Union[Mapping[str, Any], Any],
               subset: Optional[Sequence[str]] = None) -> "DataFrame":
        """Replace nulls: a ``{column: fill}`` mapping, or one fill value
        for ``subset`` (default: every column).  String columns need a
        fill value present in their dictionary."""
        if isinstance(value, Mapping):
            if subset is not None:
                raise TypeError("pass either a mapping or subset=, not both")
            fills = dict(value)
        else:
            cols = list(self._schema) if subset is None else list(subset)
            fills = {c: value for c in cols}
        self._check_cols(fills, "fillna")
        return self.with_columns(
            {c: Col(c).fill_null(ensure_expr(v)) for c, v in fills.items()})

    def isna(self, subset: Optional[Sequence[str]] = None) -> "DataFrame":
        """Replace ``subset`` columns (default: all) by booleans that are
        True where the value is null (pandas ``df.isna()``)."""
        cols = list(self._schema) if subset is None else list(subset)
        if subset is not None:
            self._check_cols(cols, "isna subset")
        return self.with_columns({c: Col(c).is_null() for c in cols})

    def repartition(self, on: Union[str, Sequence[str]], **kw) -> "DataFrame":
        """Hash-partition rows by key column(s) (an explicit shuffle; the
        optimizer elides it if placement already holds)."""
        on = [on] if isinstance(on, str) else list(on)
        self._check_cols(on, "repartition")
        return self._derive(self.plan.shuffle(on, **kw), self._schema)

    # ------------------------------------------------------------------ #
    # execution
    # ------------------------------------------------------------------ #
    def collect(self, env: Optional[CylonEnv] = None, mode: str = "bsp",
                optimize: bool = True, collect_stats: bool = False,
                morsel_rows: Optional[int] = None, analyze: bool = False,
                trace: Any = None, timeout: Any = None, retries: Any = None,
                overflow: Any = None, faults: Any = None,
                adaptive: Any = None, **kw):
        """Run the accumulated plan; returns a ``DistTable`` (and a
        ``(result, ExecStats)`` pair with ``collect_stats=True``).

        ``env`` resolution: explicit argument > the env the data was
        ingested for (``read_numpy(env=...)``) > the active session env
        (``repro_torch.df.session``).  Extra ``kw`` (``shuffle_impl``,
        ``a2a_chunks``) pass through to ``core.plan.execute``.

        ``morsel_rows`` (ROADMAP item 7), ``analyze`` / ``trace`` (item 9)
        and ``timeout`` / ``retries`` / ``overflow`` / ``faults`` /
        ``adaptive`` (item 10) are not ported yet and raise
        ``NotImplementedError``.
        """
        if morsel_rows is not None:
            raise not_ported("collect(morsel_rows=...)", 7)
        if analyze or trace is not None:
            raise not_ported("collect(analyze=..., trace=...)", 9)
        refuse_deferred("collect", timeout=timeout, retries=retries,
                        overflow=overflow, faults=faults, adaptive=adaptive)
        if env is None:
            env = self._env if self._env is not None else get_env()
        # catch gang mismatches here with a clear message instead of a
        # shape error deep inside a stage
        for sname, t in self.sources.items():
            if isinstance(t, DistTable) and t.parallelism != env.parallelism:
                raise ValueError(
                    f"source {sname!r} is partitioned for "
                    f"{t.parallelism} ranks but the resolved env has "
                    f"{env.parallelism}; pass collect(env=<ingest "
                    f"env>) or re-ingest under this session")
        return execute(self.plan, env, self.sources, mode=mode,
                       optimize=optimize, collect_stats=collect_stats, **kw)

    def to_numpy(self, nulls: str = "pandas", **kw) -> Dict[str, np.ndarray]:
        """``collect`` + gather valid rows to host numpy columns (string
        columns decoded).

        ``nulls="pandas"`` (default) re-materializes validity masks as
        NaN / ``None``; ``nulls="mask"`` returns the raw physical layout
        (canonical-zero data + ``__m_*`` bool masks) for bit-identity
        checks."""
        return self.collect(**kw).to_numpy(nulls=nulls)

    def to_pandas(self, **kw):
        """``collect`` + convert to a ``pandas.DataFrame`` (pandas is
        imported here, not by the package)."""
        import pandas as pd
        return pd.DataFrame(self.to_numpy(**kw))

    def explain(self, **kw) -> str:
        """EXPLAIN the optimized plan (stages, partitioning, fired rules)."""
        return self.plan.explain(self.sources, **kw)

    def explain_analyze(self, env: Optional[CylonEnv] = None,
                        mode: str = "bsp_staged", **kw) -> str:
        """EXPLAIN ANALYZE: not ported yet (ROADMAP item 9)."""
        raise not_ported("explain_analyze", 9)

    def num_stages(self) -> int:
        return self.plan.num_stages()

    def __repr__(self) -> str:
        return (f"<repro_torch.df.DataFrame cols={list(self._schema)} "
                f"sources={sorted(self.sources)} lazy>")


class GroupBy:
    """Intermediate ``df.groupby(keys)`` holder; ``agg`` builds the plan."""

    __slots__ = ("_df", "_keys", "_kw")

    def __init__(self, df: DataFrame, keys: List[str],
                 kw: Optional[Dict[str, Any]] = None):
        self._df = df
        self._keys = keys
        self._kw = kw or {}

    def agg(self, aggs: Optional[Mapping[str, Union[str, Sequence[str]]]]
            = None, **named: Union[str, Sequence[str]]) -> DataFrame:
        """Aggregate: ``.agg({"v": ["sum", "mean"]})`` or ``.agg(v="sum")``.

        Supported: sum / count / size / min / max / mean (mean decomposes
        into sum+count so distributed partials stay mergeable).  Output
        columns are ``{col}_{agg}``.
        """
        merged: Dict[str, List[str]] = {}
        for src in (aggs or {}), named:
            for colname, names in src.items():
                names = [names] if isinstance(names, str) else list(names)
                merged.setdefault(colname, []).extend(
                    a for a in names if a not in merged.get(colname, []))
        if not merged:
            raise ValueError("agg needs at least one {column: aggs} entry")
        self._df._check_cols(merged, "agg")
        schema = groupby_schema(self._keys, merged)
        return self._df._derive(
            self._df.plan.groupby(self._keys, merged, **self._kw), schema)


# ---------------------------------------------------------------------- #
# Constructors
# ---------------------------------------------------------------------- #
def from_table(table: DistTable, name: Optional[str] = None,
               env: Optional[CylonEnv] = None) -> DataFrame:
    """Wrap an existing ``DistTable`` as a scan.  ``env`` pins the gang
    the frame executes on (see ``DataFrame.collect``).  Host-resident
    sources (a ``SpillTable`` or a host column dict) run out-of-core,
    which is not ported yet (ROADMAP item 7)."""
    if not isinstance(table, DistTable):
        raise not_ported(f"from_table({type(table).__name__}) (out-of-core "
                          f"sources)", 7)
    name = name or f"t{next(_src_ids)}"
    # validity masks (__m_*) are physical companions, not logical schema:
    # they ride along implicitly and never appear in df.columns
    return DataFrame(Plan.scan(name), {name: table},
                     data_columns(table.column_names), env)


def read_numpy(data: Mapping[str, np.ndarray], *,
               env: Optional[CylonEnv] = None,
               capacity: Optional[int] = None,
               spill: bool = False, chunk_rows: Optional[int] = None,
               name: Optional[str] = None) -> DataFrame:
    """Ingest host numpy columns as a distributed scan.

    Block-distributes onto the env's ranks and device (a ``DistTable``;
    ``capacity`` sets per-rank slots): an explicit ``env``, else the
    active session's.  String columns are dictionary-encoded at ingest
    (the device holds int32 codes over a sorted dictionary).  An explicit
    ``env`` both partitions the data for that gang and pins later
    ``collect()`` calls to it.  ``spill=True`` / ``chunk_rows`` (host-
    resident out-of-core sources) are not ported yet (ROADMAP item 7).
    """
    if spill or chunk_rows is not None:
        if spill and capacity is not None:
            raise TypeError("capacity only applies to device tables "
                            "(spill=False); use chunk_rows for spills")
        raise not_ported("read_numpy(spill=True, chunk_rows=...)", 7)
    target = env if env is not None else get_env()
    table = DistTable.from_numpy(dict(data), target.parallelism, capacity,
                                 device=target.device)
    return from_table(table, name, env)


def read_parquet(source, **kw) -> DataFrame:
    """Parquet ingest: not ported yet (ROADMAP item 8)."""
    raise not_ported("read_parquet", 8)


def read_csv(source, **kw) -> DataFrame:
    """CSV ingest: not ported yet (ROADMAP item 8)."""
    raise not_ported("read_csv", 8)


def from_pandas(pdf, **kw) -> DataFrame:
    """Ingest a ``pandas.DataFrame`` — see ``read_numpy`` for keyword
    arguments (pandas is needed only by the caller's frame).

    Numeric/bool columns pass through; object/string and ``Categorical``
    columns are dictionary-encoded (sorted dictionary + int32 codes on the
    device, decoded back by ``to_numpy`` / ``to_pandas``).  Anything else
    (datetimes, nested objects) raises."""
    import pandas as pd
    data = {}
    for colname in pdf.columns:
        series = pdf[colname]
        if isinstance(series.dtype, pd.CategoricalDtype):
            arr = np.asarray(series.astype(object))
        else:
            arr = np.asarray(series)
        # string-ish columns are validated element-wise by the encoder
        # itself (schema._as_str_array names the column in its error)
        if (arr.dtype.kind not in ("O", "U", "S")
                and not np.issubdtype(arr.dtype, np.number)
                and arr.dtype != np.bool_):
            raise TypeError(
                f"column {colname!r} has unsupported dtype {arr.dtype}; "
                f"supported: numeric, bool, str, Categorical[str]")
        data[str(colname)] = arr
    return read_numpy(data, **kw)
