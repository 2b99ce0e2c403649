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

Out-of-core runs take host-resident sources (``read_numpy(spill=True)``,
``read_parquet`` / ``read_csv``, ``from_table`` of a ``SpillTable`` or a
host column dict) through ``collect(morsel_rows=...)``; in-core modes
scatter them onto the env's ranks.  ``collect(analyze=True)`` and
``explain_analyze()`` report what a run did (EXPLAIN ANALYZE, with the
card's roofline), and ``collect(trace=...)`` records its spans.
``collect`` takes the fault-tolerance and adaptive options
(``timeout``, ``retries``, ``overflow``, ``faults``, ``adaptive``), or
the active session's defaults for them.  Inside ``session(scheduler=)``
a ``collect`` is submitted to the query scheduler, and ingests partition
for its gang size.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.env import CylonEnv, DistTable
from ..core.plan import Plan, execute
from ..core.store import SpillTable
from ..expr import Col, Expr, ensure_expr
from ..nulls import data_columns
from ..planner.logical import groupby_schema, join_schema
from .session import get_active_scheduler, get_env, get_session_defaults

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
        """Run the accumulated plan; returns a ``DistTable`` (or a
        host-resident ``SpillTable`` with ``morsel_rows=``, and a
        ``(result, ExecStats)`` pair with ``collect_stats=True``).

        ``analyze=True`` returns ``(result, obs.QueryReport)`` instead: the
        EXPLAIN tree annotated with measured per-node rows/bytes/times, a
        per-stage roofline table against the card's peaks, and (when
        tracing is on, the default under analyze) a Chrome-exportable
        ``QueryTrace``.  ``trace`` alone turns on query tracing for a
        plain collect (``repro_torch.obs.last_trace()`` retrieves the
        timeline).

        ``env`` resolution: explicit argument > the env the data was
        ingested for (``read_numpy(env=...)``) > the active session env
        (``repro_torch.df.session``).  Extra ``kw`` (``shuffle_impl``,
        ``a2a_chunks``, ``capacity_factor``, ``scan_capacity``, ...) pass
        through to ``core.plan.execute``.

        Fault tolerance: ``timeout`` (s) deadlines the query, ``retries``
        replays faulted dispatch units with backoff, ``overflow`` (``raise
        | warn | degrade``) governs capacity-pressure drops, ``faults``
        injects a deterministic fault plan.  ``None`` falls back to the
        active session's defaults (``session(timeout=..., ...)``), then
        the library defaults.  ``adaptive`` gates runtime skew mitigation
        the same way.

        Scheduler routing: inside a ``session(scheduler=...)`` scope, a
        collect with no explicit ``env=`` and no ingest-pinned env is
        submitted to the scheduler — it queues under admission control,
        runs on a gang carved from the scheduler's pool of rank slots,
        and this call blocks on the ``QueryHandle`` (use
        ``scheduler.submit(df, ...)`` directly for the non-blocking
        handle).
        """
        defaults = get_session_defaults()
        if timeout is None:
            timeout = defaults.get("timeout")
        if retries is None:
            retries = defaults.get("retries")
        if overflow is None:
            overflow = defaults.get("overflow")
        if faults is None:
            faults = defaults.get("faults")
        if adaptive is None:
            adaptive = defaults.get("adaptive")
        scheduler = defaults.get("scheduler")
        if scheduler is not None and env is None and self._env is None:
            handle = scheduler.submit(
                self, mode=mode, optimize=optimize,
                collect_stats=collect_stats, morsel_rows=morsel_rows,
                analyze=analyze, trace=trace, timeout=timeout,
                retries=retries, overflow=overflow, faults=faults,
                adaptive=adaptive, **kw)
            return handle.result()
        if env is None:
            env = self._env if self._env is not None else get_env()
        if morsel_rows is None:
            # catch gang mismatches here with a clear message instead of a
            # shape error deep inside a stage (the morsel path re-buckets
            # host spills, so it is exempt)
            for sname, t in self.sources.items():
                if (isinstance(t, DistTable)
                        and t.parallelism != env.ranks_held):
                    raise ValueError(
                        f"source {sname!r} is partitioned for "
                        f"{t.parallelism} ranks but the resolved env has "
                        f"{env.ranks_held}; pass collect(env=<ingest "
                        f"env>) or re-ingest under this session")
        if analyze:
            from ..obs.analyze import run_analyzed
            if collect_stats:
                raise TypeError("analyze=True already collects stats; drop "
                                "collect_stats")
            return run_analyzed(self.plan, env, self.sources, mode=mode,
                                optimize=optimize, morsel_rows=morsel_rows,
                                trace=True if trace is None else trace,
                                timeout=timeout, retries=retries,
                                overflow=overflow, faults=faults,
                                adaptive=adaptive, **kw)
        return execute(self.plan, env, self.sources, mode=mode,
                       optimize=optimize, collect_stats=collect_stats,
                       morsel_rows=morsel_rows, trace=trace,
                       timeout=timeout, retries=retries, overflow=overflow,
                       faults=faults, adaptive=adaptive, **kw)

    def on_gang(self, comm) -> "DataFrame":
        """This frame with each source narrowed to the ranks ``comm``
        holds (``DistTable.select`` / ``SpillTable.select``; a host dict
        stays whole): what a member of a gang of processes runs when
        every process was given the whole input."""
        return DataFrame(self.plan, {
            n: t.select(comm) if hasattr(t, "select") else t
            for n, t in self.sources.items()}, self._schema)

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
        """Execute the plan and render the EXPLAIN tree annotated with
        measured per-node rows/bytes and per-stage times, plus the
        per-stage roofline table against the card's peaks (a device
        without peaks raises ``ValueError``; ``peaks=`` supplies them).
        Defaults to ``bsp_staged`` (one dispatch per stage) so stage times
        are exactly attributable.  Same knobs as ``collect``; the full
        ``QueryReport`` (Chrome trace, JSON export) comes from
        ``collect(analyze=True)``."""
        _, report = self.collect(env=env, mode=mode, analyze=True, **kw)
        return str(report)

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
def from_table(table: Union[DistTable, SpillTable, Mapping[str, np.ndarray]],
               name: Optional[str] = None,
               env: Optional[CylonEnv] = None) -> DataFrame:
    """Wrap an existing ``DistTable`` / ``SpillTable`` / host column dict
    as a scan.  ``SpillTable`` sources run out-of-core under
    ``collect(morsel_rows=...)`` or are scattered onto the env's ranks for
    in-core modes; raw column dicts require the morsel path.  ``env`` pins
    the gang the frame executes on (see ``DataFrame.collect``)."""
    if hasattr(table, "column_names"):
        names = table.column_names
    elif isinstance(table, Mapping):
        names = tuple(table)
    else:
        raise TypeError(f"cannot infer a schema from {type(table).__name__}")
    name = name or f"t{next(_src_ids)}"
    # validity masks (__m_*) are physical companions, not logical schema:
    # they ride along implicitly and never appear in df.columns
    return DataFrame(Plan.scan(name), {name: table}, data_columns(names),
                     env)


def read_numpy(data: Mapping[str, np.ndarray], *,
               env: Optional[CylonEnv] = None,
               capacity: Optional[int] = None,
               spill: bool = False, chunk_rows: Optional[int] = None,
               name: Optional[str] = None) -> DataFrame:
    """Ingest host numpy columns as a distributed scan.

    Default: block-distribute onto the env's ranks and device (a
    ``DistTable``; ``capacity`` sets per-rank slots): an explicit ``env``,
    else the active session's.  String columns are dictionary-encoded at
    ingest (the device holds int32 codes over a sorted dictionary).  An
    explicit ``env`` both partitions the data for that gang and pins later
    ``collect()`` calls to it.  ``spill=True`` keeps the data host-resident
    as a ``SpillTable`` (in ``chunk_rows``-row chunks) for out-of-core
    ``collect(morsel_rows=...)`` runs.

    Inside a ``session(scheduler=...)`` scope (and with no explicit
    ``env``), data is partitioned for the scheduler's gang size on its
    pool's device, so the frame can run on *any* gang the scheduler
    carves.
    """
    p, device, comm = _resolve_target(env)
    if spill:
        if capacity is not None:
            raise TypeError("capacity only applies to device tables "
                            "(spill=False); use chunk_rows for spills")
        table: Any = SpillTable.from_numpy(data, p, chunk_rows=chunk_rows,
                                           comm=comm)
    else:
        if chunk_rows is not None:
            raise TypeError("chunk_rows only applies with spill=True")
        table = DistTable.from_numpy(dict(data), p, capacity, device=device,
                                     comm=comm)
    return from_table(table, name, env)


def _resolve_target(env: Optional[CylonEnv]):
    """(ranks, device, communicator) an ingest partitions for: the
    explicit env's, else the active scheduler's gang size on its pool's
    device, else the active env's.  Over a process group the process
    builds only the ranks it holds (the communicator says which)."""
    if env is None:
        sched = get_active_scheduler()
        if sched is not None:
            return sched.gang_size, sched.device, None
        env = get_env()
    return env.parallelism, env.device, env.comm


def read_parquet(source, *, env: Optional[CylonEnv] = None,
                 columns: Optional[Sequence[str]] = None,
                 batch_rows: Optional[int] = None,
                 name: Optional[str] = None, **kw) -> DataFrame:
    """Ingest Parquet file(s) as a host-resident out-of-core scan.

    ``source`` is a path, a glob, or a list of either; row groups stream
    in ``batch_rows``-row batches straight into the spill format, round-
    robin over the gang (``env``'s, else the active scheduler's gang size,
    else the active session's) — whole
    files are never materialized, so datasets larger than device memory
    run under ``collect(morsel_rows=...)``.  Missing values become
    validity masks (NaN / ``None`` on the way back out); string columns
    are dictionary-encoded incrementally, with a process-level dictionary
    cache keyed by the source files.  Requires pyarrow (``read_csv`` does
    not).  Over a process group every process reads the same files and
    keeps the batches of the rank it holds (a collective)."""
    from ..io import read_parquet as _read
    if batch_rows is not None:
        kw["batch_rows"] = batch_rows
    p, _, comm = _resolve_target(env)
    spill = _read(source, p, columns=columns, comm=comm, **kw)
    return from_table(spill, name, env)


def read_csv(source, *, env: Optional[CylonEnv] = None,
             batch_rows: Optional[int] = None,
             name: Optional[str] = None, **kw) -> DataFrame:
    """Ingest CSV file(s) (header row required) as a host-resident
    out-of-core scan — ``read_parquet`` semantics, CSV framing.  Empty
    fields are null in every column type.  Streams via pyarrow when
    available, else a pure-python fallback lane."""
    from ..io import read_csv as _read
    if batch_rows is not None:
        kw["batch_rows"] = batch_rows
    p, _, comm = _resolve_target(env)
    spill = _read(source, p, comm=comm, **kw)
    return from_table(spill, name, env)


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
