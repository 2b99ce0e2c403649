"""Generate the §Dry-run / §Roofline tables from the dry run's cell JSONs
(ports ``repro/launch/report.py``).

  PYTHONPATH=src python -m repro_torch.launch.report \
      [--dir experiments/dryrun_torch/single_pod] [--write --md FILE]

``--write`` splices the tables into ``FILE`` at the
``<!-- DRYRUN_TABLE -->`` / ``<!-- ROOFLINE_TABLE -->`` /
``<!-- ROOFLINE_NOTES -->`` markers.  The port's rows carry ``trace_s``
(the wall time of the step's first run) where the reference's carry
``compile_s``; the tables render either, as the reference's report does.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import Dict, List

_SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(dirname: str) -> List[Dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    rows.sort(key=lambda r: (r["arch"], _SHAPE_ORDER.index(r["shape"])))
    return rows


def _gb(x) -> str:
    return f"{x / 2**30:.2f}"


def dryrun_table(rows: List[Dict]) -> str:
    out = ["| arch | shape | status | compile s | args GiB/dev | temp GiB/dev "
           "| collectives (AG/AR/RS/A2A/CP) |",
           "|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("skipped"):
            out.append(f"| {r['arch']} | {r['shape']} | SKIP (full attention"
                       f" @512k; DESIGN §7) | — | — | — | — |")
            continue
        ma = r.get("memory_analysis", {})
        c = r.get("raw_collectives", r.get("collectives", {}))
        ops = "/".join(str(int(c.get(k, {}).get("count", 0))) for k in
                       ("all-gather", "all-reduce", "reduce-scatter",
                        "all-to-all", "collective-permute"))
        secs = r.get("compile_s", r.get("trace_s", 0))
        out.append(
            f"| {r['arch']} | {r['shape']} | OK | {secs:.1f} "
            f"| {_gb(ma.get('argument_size_in_bytes', 0))} "
            f"| {_gb(ma.get('temp_size_in_bytes', 0))} | {ops} |")
    return "\n".join(out)


def roofline_table(rows: List[Dict]) -> str:
    out = ["| arch | shape | compute s | memory s | collective s | dominant "
           "| MODEL_FLOPS | useful/HLO | roofline frac |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("skipped") or "roofline" not in r:
            continue
        t = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.3f} "
            f"| {t['memory_s']:.3f} | {t['collective_s']:.3f} "
            f"| **{t['dominant']}** | {t['model_flops']:.2e} "
            f"| {t['useful_flops_ratio']:.3f} "
            f"| {t['roofline_fraction']:.3f} |")
    return "\n".join(out)


def notes(rows: List[Dict]) -> str:
    live = [r for r in rows if not r.get("skipped") and "roofline" in r]
    doms = {}
    for r in live:
        doms.setdefault(r["roofline"]["dominant"], []).append(
            f"{r['arch']}×{r['shape']}")
    lines = ["Dominant-term census:"]
    for k, v in sorted(doms.items(), key=lambda kv: -len(kv[1])):
        lines.append(f"* **{k}** ({len(v)} cells): {', '.join(v)}")
    worst = sorted(live, key=lambda r: r["roofline"]["roofline_fraction"])[:3]
    best = sorted(live, key=lambda r: -r["roofline"]["roofline_fraction"])[:3]
    lines.append("")
    lines.append("Best roofline fractions: " + ", ".join(
        f"{r['arch']}×{r['shape']} ({r['roofline']['roofline_fraction']:.3f})"
        for r in best))
    lines.append("Worst roofline fractions: " + ", ".join(
        f"{r['arch']}×{r['shape']} ({r['roofline']['roofline_fraction']:.3f})"
        for r in worst))
    return "\n".join(lines)


def splice(md_path: str, marker: str, content: str) -> None:
    with open(md_path) as f:
        text = f.read()
    tag = f"<!-- {marker} -->"
    if tag not in text:
        raise ValueError(f"{md_path} has no {tag} marker")
    block = f"{tag}\n\n{content}\n"
    # replace the marker line (keep it so re-runs regenerate)
    text = re.sub(rf"<!-- {marker} -->\n(?:(?!<!--|\n## ).*\n)*",
                  block, text, count=1)
    with open(md_path, "w") as f:
        f.write(text)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch/single_pod")
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--md", default="EXPERIMENTS.md")
    args = ap.parse_args()
    rows = load(args.dir)
    dt = dryrun_table(rows)
    rt = roofline_table(rows)
    nt = notes(rows)
    if args.write:
        splice(args.md, "DRYRUN_TABLE", dt)
        splice(args.md, "ROOFLINE_TABLE", rt)
        splice(args.md, "ROOFLINE_NOTES", nt)
        print(f"wrote tables into {args.md} ({len(rows)} cells)")
    else:
        print(dt)
        print()
        print(rt)
        print()
        print(nt)


if __name__ == "__main__":
    main()
