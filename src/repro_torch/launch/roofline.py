"""Roofline terms of a measured query stage, on the card the env runs on,
and a model's FLOPs per step.

The torch counterpart of ``repro.launch.roofline``'s ``roofline_terms``,
``stage_roofline`` and ``model_flops`` (its HLO half, ``analyze``,
``parse_collectives`` and ``format_table``, reads the dry-run's lowered
programs and waits with it for ROADMAP queue 1, item 13.7).  The JAX
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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

__all__ = ["DevicePeaks", "DEVICE_PEAKS", "peaks_for", "device_peaks",
           "roofline_terms", "stage_roofline", "model_flops"]


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    """Published peak rates of one card (dense, without sparsity)."""

    name: str
    hbm_bytes_per_s: float
    f32_flops_per_s: float    # float32 outside the tensor cores
    bf16_flops_per_s: float   # dense bf16 tensor cores


#: NVIDIA's data sheet, SXM part, at the full 700 W power limit
DEVICE_PEAKS: Dict[str, DevicePeaks] = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(
        "NVIDIA H100 80GB HBM3", hbm_bytes_per_s=3.35e12,
        f32_flops_per_s=67e12, bf16_flops_per_s=989e12),
}


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
