"""Roofline terms of a measured query stage and of a dry-run cell, on the
card's own peaks, and a model's FLOPs per step: the torch counterpart of
``repro.launch.roofline``.

**Query stages** (``roofline_terms``, ``stage_roofline``).  The JAX
package bounds a stage with one TPU chip per rank; the port stacks every
rank of a gang on one card, so two things change:

* **Peaks** are the card's own, from ``DEVICE_PEAKS`` keyed by the name
  ``torch.cuda.get_device_properties`` gives.  A device missing from the
  table (the CPU included) raises ``ValueError`` naming it: a bound from
  another device's peaks would be a wrong number, not a rough one.
* **Division** is by the devices the gang occupies (one for the stacked
  communicator), not by its ranks.  The stacked all-to-all is a transpose
  copy in the same HBM (``comm/stacked.py``): its wire bytes are read
  once and written once at the HBM rate, and no link is involved.

    memory term     = hbm_bytes / (devices x HBM rate)
    collective term = 2 x wire_bytes / (devices x HBM rate)
    bound           = max(compute term, memory term + collective term)

The memory and collective terms add because both use the one HBM.

**Dry-run cells** (``analyze``, ``format_table``, ``main``).  A cell of
``launch/dryrun.py`` is one step on a production mesh, one card a rank,
and its counts are per device (``launch/counting.py``).  ``analyze`` is
the reference's formula on an H100's peaks:

    compute term    = FLOPs / bf16 tensor-core rate
    memory term     = bytes accessed / HBM rate
    collective term = wire bytes / link rate
    bound           = max of the three

The link is NVLink 4 of the H100 SXM: 900 GB/s a card by NVIDIA's data
sheet, 450 GB/s each way, and the wire model (``_wire_bytes``, the
reference's: the bytes one device sends) counts one way.  A 16 x 16 mesh
is taken as one NVLink Switch System domain of 256 cards; like the
reference, the 2 x 16 x 16 mesh's pod axis is modelled at the same rate.
The reference's HLO parsing (``parse_collectives``, ``_shape_bytes``,
``_group_size``) has no counterpart: there is no HLO, and
``counting.StepCounter`` reads the collectives where DTensor issues them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

__all__ = ["DevicePeaks", "DEVICE_PEAKS", "H100", "peaks_for",
           "device_peaks", "roofline_terms", "stage_roofline",
           "model_flops", "analyze", "format_table"]

#: the reference's collective names (``repro/launch/roofline.py``)
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    """Published peak rates of one card (dense, without sparsity)."""

    name: str
    hbm_bytes_per_s: float
    f32_flops_per_s: float    # float32 outside the tensor cores
    bf16_flops_per_s: float   # dense bf16 tensor cores
    link_bytes_per_s: float   # card-to-card link, one direction


#: NVIDIA's data sheet, SXM part, at the full 700 W power limit
DEVICE_PEAKS: Dict[str, DevicePeaks] = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(
        "NVIDIA H100 80GB HBM3", hbm_bytes_per_s=3.35e12,
        f32_flops_per_s=67e12, bf16_flops_per_s=989e12,
        link_bytes_per_s=450e9),
}
#: the card the dry run's roofline assumes
H100 = DEVICE_PEAKS["NVIDIA H100 80GB HBM3"]


def peaks_for(name: str) -> DevicePeaks:
    """The peaks of the card called ``name``; ``ValueError`` if the table
    does not hold it."""
    try:
        return DEVICE_PEAKS[name]
    except KeyError:
        raise ValueError(
            f"no roofline peaks for device {name!r}; known devices: "
            f"{sorted(DEVICE_PEAKS)}") from None


def device_peaks(device=None) -> DevicePeaks:
    """The peaks of ``device`` (``None``: the current card).  Only CUDA
    devices named in ``DEVICE_PEAKS`` have them; any other device raises
    ``ValueError`` naming it."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(
            f"no roofline peaks for device {str(dev)!r}: bounds are the "
            f"card's own; known devices: {sorted(DEVICE_PEAKS)}")
    return peaks_for(torch.cuda.get_device_properties(dev).name)


def roofline_terms(flops: float, hbm_bytes: float, wire_bytes: float,
                   peaks: DevicePeaks, devices: int = 1
                   ) -> Dict[str, float]:
    """Compute, memory and collective terms of work spread over
    ``devices`` cards, and the least time it can take.  The compute term
    uses the bf16 tensor-core rate, as the JAX package's does; dataframe
    stages pass 0 FLOPs."""
    d = max(1, int(devices))
    compute_s = float(flops) / (d * peaks.bf16_flops_per_s)
    memory_s = float(hbm_bytes) / (d * peaks.hbm_bytes_per_s)
    collective_s = 2.0 * float(wire_bytes) / (d * peaks.hbm_bytes_per_s)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    terms["dominant"] = dominant.replace("_s", "")
    terms["step_s_lower_bound"] = max(compute_s, memory_s + collective_s)
    return terms


def stage_roofline(wire_bytes: float, elapsed_s: Optional[float],
                   peaks: DevicePeaks, devices: int = 1,
                   hbm_bytes: Optional[float] = None) -> Dict[str, float]:
    """Roofline terms for one *measured* query stage
    (``repro_torch.obs``).

    ``wire_bytes`` is the stage's global shuffle volume (from
    ``ExecStats.shuffle_records``); ``hbm_bytes`` defaults to 2x wire, as
    in the JAX package (every shuffled byte is packed on the send side
    and unpacked on the receive side — a lower bound, ignoring the local
    operator work).  ``roofline_fraction`` is that bound over the
    measured stage time: 1.0 means the stage ran at the card's bandwidth,
    small values mean other work (sorts, joins, dispatch, host
    round-trips) dominates.
    """
    hbm_total = (2.0 * float(wire_bytes) if hbm_bytes is None
                 else float(hbm_bytes))
    terms = roofline_terms(0.0, hbm_total, wire_bytes, peaks, devices)
    terms["wire_bytes"] = float(wire_bytes)
    terms["hbm_bytes"] = hbm_total
    terms["elapsed_s"] = float(elapsed_s) if elapsed_s is not None else None
    terms["roofline_fraction"] = (
        terms["step_s_lower_bound"] / float(elapsed_s)
        if elapsed_s else 0.0)
    return terms


def model_flops(cfg, kind: str, global_batch: int, seq_len: int) -> float:
    """6·N_active·tokens (train) or 2·N_active·tokens (inference)."""
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * global_batch * seq_len
    if kind == "prefill":
        return 2.0 * n * global_batch * seq_len
    return 2.0 * n * global_batch  # decode: one token per sequence


# ---------------------------------------------------------------------- #
# Dry-run cells
# ---------------------------------------------------------------------- #
def _wire_bytes(op: str, result_bytes: int, p: int) -> float:
    """Bytes one device sends for one collective of ``result_bytes`` over
    ``p`` devices (ring-equivalent; the reference's wire model)."""
    if p <= 1:
        return 0.0
    f = (p - 1) / p
    if op.startswith("all-reduce"):
        return 2.0 * result_bytes * f
    if op.startswith("all-gather"):
        return result_bytes * f
    if op == "reduce-scatter":
        return result_bytes * (p - 1)
    if op == "all-to-all":
        return result_bytes * f
    return float(result_bytes)  # collective-permute


def analyze(cell_result: Dict[str, Any], cfg, chips: int,
            peaks: DevicePeaks = H100) -> Dict[str, Any]:
    """Roofline terms of one dry-run cell result (per-device counts) on
    ``chips`` cards of ``peaks``: the reference's ``analyze``."""
    ca = cell_result["cost_analysis"]
    flops_dev = float(ca.get("flops", 0.0))
    bytes_dev = float(ca.get("bytes accessed", 0.0))
    wire_dev = float(cell_result["collectives"]["total_wire_bytes"])
    terms = {"compute_s": flops_dev / peaks.bf16_flops_per_s,
             "memory_s": bytes_dev / peaks.hbm_bytes_per_s,
             "collective_s": wire_dev / peaks.link_bytes_per_s}
    dominant = max(terms, key=terms.get)
    terms["dominant"] = dominant.replace("_s", "")
    terms["step_s_lower_bound"] = max(terms["compute_s"], terms["memory_s"],
                                      terms["collective_s"])
    mf = model_flops(cfg, cell_result["kind"], cell_result["global_batch"],
                     cell_result["seq_len"])
    flops_global = flops_dev * chips
    terms["model_flops"] = mf
    terms["hlo_flops_global"] = flops_global
    terms["useful_flops_ratio"] = (mf / flops_global
                                   if flops_global else 0.0)
    # roofline fraction: useful FLOP rate at the step lower bound vs peak
    step = terms["step_s_lower_bound"]
    terms["roofline_fraction"] = (
        mf / (step * chips * peaks.bf16_flops_per_s) if step > 0 else 0.0)
    return terms


def format_table(rows: List[Dict[str, Any]]) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant "
           "| MODEL_FLOPS | useful/HLO | roofline frac |")
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for r in rows:
        t = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.4f} "
            f"| {t['memory_s']:.4f} | {t['collective_s']:.4f} "
            f"| **{t['dominant']}** | {t['model_flops']:.3e} "
            f"| {t['useful_flops_ratio']:.3f} | {t['roofline_fraction']:.3f} |")
    return "\n".join(lines)


def main() -> None:
    """``python -m repro_torch.launch.roofline [--dir DIR]``: the roofline
    table of the dry-run cell JSONs in ``DIR``."""
    import argparse
    import glob
    import os
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch/single_pod")
    args = ap.parse_args()
    rows = []
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    rows = [r for r in rows if "roofline" in r]
    print(format_table(rows))


if __name__ == "__main__":
    main()
