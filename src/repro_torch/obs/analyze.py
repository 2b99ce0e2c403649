"""EXPLAIN ANALYZE: the EXPLAIN tree re-rendered with *measured* actuals.

The torch counterpart of ``repro.obs.analyze``. ``run_analyzed`` executes a
plan with stats collection + tracing on and returns ``(result,
QueryReport)``. The report re-renders the physical plan
(``planner.explain`` labels) with per-node actual rows / bytes / drops from
``ExecStats.shuffle_records`` next to the planner's estimates, per-stage
wall times from ``ExecStats.stage_times``, and a per-stage roofline table
(``launch.roofline.stage_roofline``) showing how close each stage ran to
the bound of the card it ran on (its peaks from
``launch.roofline.DEVICE_PEAKS``; a device without peaks raises
``ValueError`` when the table is asked for, never a bound from another
device). The tree, the rows and the wire bytes are the JAX package's; the
bounds and fractions are the card's. The attached ``QueryTrace`` exports to
the Chrome ``trace_event`` format via ``QueryReport.to_chrome_trace``.

Frontend entry points: ``df.collect(analyze=True)`` and
``df.explain_analyze()`` (``repro_torch.df``); plan-level callers use
``run_analyzed`` directly.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Mapping, Optional, Tuple

from .trace import QueryTrace, Tracer

__all__ = ["QueryReport", "run_analyzed", "render_analyze", "stage_table"]


def _rows_of(table: Any) -> Optional[int]:
    """Total rows of any table-ish execute() input/output, else None."""
    if hasattr(table, "total_rows"):
        return int(table.total_rows())
    if isinstance(table, Mapping) and table:
        try:
            return len(next(iter(table.values())))
        except TypeError:
            return None
    return None


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(b) < 1024 or unit == "GiB":
            return f"{b:.1f}{unit}" if unit != "B" else f"{int(b)}B"
        b /= 1024
    return f"{b:.1f}GiB"


def _records_by_label(stats) -> Dict[str, Dict[str, int]]:
    """Aggregate shuffle records to per-label totals.  Out-of-core runs
    key records by ``(label, segment)``; the analyze rendering wants the
    whole-query per-label view, so same-label records sum."""
    agg: Dict[str, Dict[str, int]] = {}
    for r in stats.shuffle_records:
        a = agg.setdefault(r.label, {"rows": 0, "bytes": 0, "dropped": 0})
        a["rows"] += r.rows
        a["bytes"] += r.bytes
        a["dropped"] += r.dropped
    return agg


def _node_actuals(node, by_label: Dict[str, Dict[str, int]]
                  ) -> Optional[str]:
    """Measured annotation for one plan node, from its shuffle records.

    Labels match on the ``op(args)`` stem so salted extras the static
    plan does not predict (``groupby(k):remerge``, ``join(k):broadcast``)
    attribute to their node."""
    from ..planner.physical import node_stat_labels
    stems = {l.split(":")[0] for l in node_stat_labels(node)}
    labels = [l for l in by_label if l.split(":")[0] in stems]
    if not labels:
        return None
    rows = sum(by_label[l]["rows"] for l in labels)
    byts = sum(by_label[l]["bytes"] for l in labels)
    dropped = sum(by_label[l]["dropped"] for l in labels)
    s = f"moved {rows} rows / {_fmt_bytes(byts)}"
    if dropped:
        s += f", DROPPED {dropped}"
    return s


def _stage_seconds(stats) -> Dict[int, float]:
    """Map stage index -> measured seconds where attribution is exact
    (``bsp_staged`` one-dispatch-per-stage); other modes can only time the
    whole program / per-segment units."""
    out: Dict[int, float] = {}
    for name, secs in stats.stage_times:
        if name.startswith("stage:"):
            try:
                out[int(name.split(":", 1)[1])] = secs
            except ValueError:
                pass
    return out


def render_analyze(pplan, stats, scan_rows: Optional[Dict[str, int]] = None,
                   result_rows: Optional[int] = None) -> str:
    """The EXPLAIN tree with ``act:`` annotations from a finished run."""
    from ..planner.explain import adapt_note, node_label
    scan_rows = scan_rows or {}
    records = _records_by_label(stats)
    stage_secs = _stage_seconds(stats)
    cache = f"{stats.cache_hits} hits / {stats.cache_misses} misses"
    ft = ""
    if getattr(stats, "retries", 0) or getattr(stats, "degraded", 0):
        ft = (f" retries={getattr(stats, 'retries', 0)} "
              f"degraded={getattr(stats, 'degraded', 0)}")
    if (getattr(stats, "salted_shuffles", 0)
            or getattr(stats, "splitter_refreshes", 0)
            or getattr(stats, "autotune_steps", 0)):
        ft += (f" adapt[salted={getattr(stats, 'salted_shuffles', 0)} "
               f"refreshes={getattr(stats, 'splitter_refreshes', 0)} "
               f"autotune={getattr(stats, 'autotune_steps', 0)}]")
    salted_by_idx = {e["node_index"]: e
                     for e in getattr(stats, "adapt_events", [])
                     if e.get("kind") == "salted"}
    idx_of = {n.nid: i for i, n in enumerate(pplan.order)}
    lines = [
        f"== EXPLAIN ANALYZE: mode={stats.mode}, "
        f"wall={stats.wall_time_s:.4f}s, dispatches={stats.dispatches} "
        f"(compile cache: {cache}){ft} ==",
        f"   shuffled {stats.rows_shuffled} rows / "
        f"{_fmt_bytes(stats.bytes_shuffled)}"
        + (f", dropped {stats.rows_dropped}" if stats.rows_dropped else "")
        + (f", {stats.morsels} morsels" if getattr(stats, "morsels", 0)
           else ""),
    ]
    if getattr(stats, "rows_read", 0) or getattr(stats, "bytes_read", 0):
        # ingest attribution: a distinct "scan" stage ahead of stage 0,
        # fed by the scan tables' IngestInfo provenance (repro_torch.io)
        lines.append(
            f"stage scan: ingested {getattr(stats, 'rows_read', 0)} rows / "
            f"{_fmt_bytes(getattr(stats, 'bytes_read', 0))} from source "
            f"files")
    by_stage: Dict[int, list] = {}
    for n in pplan.order:
        by_stage.setdefault(pplan.stage_of[n.nid], []).append(n)
    for s in sorted(by_stage):
        t = f"  [{stage_secs[s]:.4f}s]" if s in stage_secs else ""
        lines.append(f"stage {s}:{t}")
        for n in by_stage[s]:
            acts = []
            if n.op == "scan" and n.params["name"] in scan_rows:
                acts.append(f"rows={scan_rows[n.params['name']]}")
            a = _node_actuals(n, records)
            if a:
                acts.append(a)
            ev = salted_by_idx.get(idx_of.get(n.nid))
            if ev is not None:
                acts.append(adapt_note(ev))
            if n.nid == pplan.root.nid and result_rows is not None:
                acts.append(f"out_rows={result_rows}")
            est = f"rows~{int(n.est_rows):>9d}"
            act = f"  act: {'; '.join(acts)}" if acts else ""
            lines.append(f"  {node_label(n):44s} {est}{act}")
    if stats.stage_times:
        unmapped = [(k, v) for k, v in stats.stage_times
                    if not k.startswith("stage:")]
        if unmapped:
            lines.append("timed units:")
            for name, secs in unmapped:
                lines.append(f"  {name:44s} {secs:.4f}s")
    return "\n".join(lines)


def stage_table(pplan, stats, peaks) -> List[Dict[str, Any]]:
    """Per-stage measured volumes + roofline terms (machine-readable rows;
    ``QueryReport.roofline_table`` renders the markdown).  ``peaks`` is a
    ``launch.roofline.DevicePeaks``; the gang occupies one card (the
    stacked communicator holds every rank on it)."""
    from ..launch.roofline import stage_roofline
    from ..planner.physical import node_stat_labels
    records = _records_by_label(stats)
    stage_secs = _stage_seconds(stats)
    by_stage: Dict[int, list] = {}
    for n in pplan.order:
        by_stage.setdefault(pplan.stage_of[n.nid], []).append(n)
    rows = []
    for s in sorted(by_stage):
        wire = 0
        srows = 0
        for n in by_stage[s]:
            stems = {l.split(":")[0] for l in node_stat_labels(n)}
            for l in records:
                if l.split(":")[0] in stems and not l.endswith(":overflow"):
                    wire += records[l]["bytes"]
                    srows += records[l]["rows"]
        secs = stage_secs.get(s)
        terms = stage_roofline(wire, secs, peaks)
        rows.append({
            "stage": s,
            "ops": [n.op for n in by_stage[s]],
            "rows_shuffled": srows,
            "wire_bytes": wire,
            "elapsed_s": secs,
            "memory_s": terms["memory_s"],
            "collective_s": terms["collective_s"],
            "bound_s": terms["step_s_lower_bound"],
            "dominant": terms["dominant"],
            "roofline_fraction": terms["roofline_fraction"],
        })
    return rows


class QueryReport:
    """Everything one analyzed execution measured, in one object.

    ``explain_analyze()`` — the annotated plan tree;
    ``roofline_table()`` — per-stage bytes-moved + roofline fraction;
    ``to_chrome_trace(path)`` — the Chrome/Perfetto timeline;
    ``to_json(path)`` — the machine-readable bundle.  ``str(report)``
    concatenates the two human renderings.

    The roofline rows use ``peaks`` when given, else the peaks of
    ``device`` (the env's), looked up when a table is first asked for:
    a device without peaks raises ``ValueError`` there.
    """

    def __init__(self, pplan, stats, trace: Optional[QueryTrace],
                 parallelism: int,
                 scan_rows: Optional[Dict[str, int]] = None,
                 result_rows: Optional[int] = None, device=None,
                 peaks=None):
        self.pplan = pplan
        self.stats = stats
        self.trace = trace
        self.parallelism = parallelism
        self.scan_rows = dict(scan_rows or {})
        self.result_rows = result_rows
        self.device = device
        self._peaks = peaks

    @property
    def peaks(self):
        """The ``launch.roofline.DevicePeaks`` the bounds use."""
        if self._peaks is None:
            from ..launch.roofline import device_peaks
            self._peaks = device_peaks(self.device)
        return self._peaks

    @property
    def wall_time_s(self) -> float:
        return self.stats.wall_time_s

    def explain_analyze(self) -> str:
        return render_analyze(self.pplan, self.stats, self.scan_rows,
                              self.result_rows)

    def stage_table(self) -> List[Dict[str, Any]]:
        return stage_table(self.pplan, self.stats, self.peaks)

    def roofline_table(self) -> str:
        hdr = ("| stage | ops | rows | wire | elapsed s | bound s "
               "| dominant | roofline frac |")
        lines = [hdr, "|" + "---|" * 8]
        for r in self.stage_table():
            el = f"{r['elapsed_s']:.4f}" if r["elapsed_s"] is not None else "-"
            frac = (f"{r['roofline_fraction']:.3f}"
                    if r["elapsed_s"] else "-")
            lines.append(
                f"| {r['stage']} | {','.join(r['ops'])} "
                f"| {r['rows_shuffled']} | {_fmt_bytes(r['wire_bytes'])} "
                f"| {el} | {r['bound_s']:.2e} | {r['dominant']} | {frac} |")
        return "\n".join(lines)

    def to_chrome_trace(self, path: Optional[str] = None) -> Dict[str, Any]:
        if self.trace is None:
            raise ValueError("no trace attached (run with trace enabled)")
        return self.trace.to_chrome_trace(path)

    def to_dict(self) -> Dict[str, Any]:
        st = self.stats
        return {
            "mode": st.mode,
            "fingerprint": self.pplan.fingerprint,
            "parallelism": self.parallelism,
            "wall_time_s": st.wall_time_s,
            "stage_times": list(st.stage_times),
            "dispatches": st.dispatches,
            "rows_shuffled": st.rows_shuffled,
            "bytes_shuffled": st.bytes_shuffled,
            "rows_dropped": st.rows_dropped,
            "cache_hits": st.cache_hits,
            "cache_misses": st.cache_misses,
            "retries": getattr(st, "retries", 0),
            "degraded": getattr(st, "degraded", 0),
            "faults_injected": getattr(st, "faults_injected", 0),
            "adaptive": getattr(st, "adaptive", False),
            "salted_shuffles": getattr(st, "salted_shuffles", 0),
            "splitter_refreshes": getattr(st, "splitter_refreshes", 0),
            "autotune_steps": getattr(st, "autotune_steps", 0),
            "adapt_events": list(getattr(st, "adapt_events", [])),
            "device": self.peaks.name,
            "scan_rows": self.scan_rows,
            "rows_read": getattr(st, "rows_read", 0),
            "bytes_read": getattr(st, "bytes_read", 0),
            "result_rows": self.result_rows,
            "shuffle_records": [
                {"label": r.label, "segment": r.segment,
                 "rows": r.rows, "bytes": r.bytes,
                 "dropped": r.dropped,
                 "per_rank_rows": list(r.per_rank_rows),
                 "per_rank_dropped": list(r.per_rank_dropped)}
                for r in st.shuffle_records],
            "stages": self.stage_table(),
        }

    def to_json(self, path: Optional[str] = None, indent: int = 1) -> str:
        text = json.dumps(self.to_dict(), indent=indent, sort_keys=True,
                          default=str)
        if path is not None:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text

    def __str__(self) -> str:
        return self.explain_analyze() + "\n\n" + self.roofline_table()


def run_analyzed(plan, env, tables: Dict[str, Any], mode: str = "bsp_staged",
                 optimize: bool = True, shuffle_impl: str = "radix",
                 a2a_chunks: int = 1, morsel_rows: Optional[int] = None,
                 trace: Any = True, peaks=None, **morsel_kw
                 ) -> Tuple[Any, QueryReport]:
    """Execute with stats + tracing on; returns ``(result, QueryReport)``.

    ``mode="bsp_staged"`` is the default because one dispatch per stage is
    what makes per-stage times attributable; ``bsp`` runs everything in one
    program (one "program" timing unit), ``morsel_rows`` streams out-of-core
    (per-segment units).  ``trace=False`` skips the timeline but keeps the
    annotated tree and roofline table.  ``peaks`` (a
    ``launch.roofline.DevicePeaks``) bounds the stages on a device the
    peak table does not hold; by default the env's card's own are used.
    """
    from ..planner import compile_plan, run_physical
    from .trace import resolve_tracer
    tracer = resolve_tracer(trace, name="analyze")
    pplan = compile_plan(plan, tables, optimize_plan=optimize)
    with tracer.span("query", "query", mode=mode,
                     fingerprint=pplan.fingerprint,
                     stages=pplan.num_stages, shuffles=pplan.num_shuffles):
        result, stats = run_physical(
            pplan, env, tables, mode, collect_stats=True,
            shuffle_impl=shuffle_impl, a2a_chunks=a2a_chunks,
            morsel_rows=morsel_rows, tracer=tracer, **morsel_kw)
    qtrace = tracer.finish() if isinstance(tracer, Tracer) else None
    scan_rows = {name: r for name in pplan.scan_names
                 if (r := _rows_of(tables.get(name))) is not None}
    report = QueryReport(pplan, stats, qtrace, env.parallelism,
                         scan_rows=scan_rows, result_rows=_rows_of(result),
                         device=env.device, peaks=peaks)
    return result, report
