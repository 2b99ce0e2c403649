"""The assigned input-shape cells, their eligibility per arch and their
input specs (ports ``repro/launch/shapes.py``).

The JAX package describes inputs with ``jax.ShapeDtypeStruct`` stand-ins;
here a stand-in is a tensor on ``torch.device("meta")``: it has a shape
and a dtype and allocates nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..configs import ARCHS, get_config
from ..configs.llava_next_34b import PATCHES_LARGE, PATCHES_SMALL
from ..models.config import SHAPES, ModelConfig

__all__ = ["Cell", "cell", "all_cells", "vlm_patches", "train_batch_specs",
           "prefill_batch_specs", "decode_token_specs"]


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    kind: str              # train | prefill | decode
    global_batch: int
    seq_len: int
    eligible: bool
    skip_reason: Optional[str] = None


def cell(arch: str, shape: str) -> Cell:
    cfg = get_config(arch)
    info = SHAPES[shape]
    eligible, reason = True, None
    if shape == "long_500k" and not cfg.sub_quadratic:
        eligible = False
        reason = ("pure full-attention decoder: 512k dense-KV decode is "
                  "defined by the brief to require sub-quadratic attention "
                  "(see DESIGN.md §7)")
    return Cell(arch, shape, info["kind"], info["global_batch"],
                info["seq_len"], eligible, reason)


def all_cells() -> List[Cell]:
    return [cell(a, s) for a in ARCHS for s in SHAPES]


def vlm_patches(cfg: ModelConfig, seq_len: int) -> int:
    """Patch embeddings of a vlm sequence: one image's 576 CLIP patches up
    to 4,096 positions, the anyres tiling's 2,880 above."""
    return PATCHES_SMALL if seq_len <= 4096 else PATCHES_LARGE


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, global_batch: int, seq_len: int
                      ) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for one training batch."""
    b, s = global_batch, seq_len
    i32 = torch.int32
    if cfg.family == "audio":
        shape = (b, s, cfg.num_codebooks)
        return {"tokens": _spec(shape, i32), "labels": _spec(shape, i32)}
    if cfg.family == "vlm":
        p = vlm_patches(cfg, s)
        return {"patch_embeds": _spec((b, p, cfg.d_model), torch.bfloat16),
                "tokens": _spec((b, s - p), i32),
                "labels": _spec((b, s - p), i32)}
    return {"tokens": _spec((b, s), i32), "labels": _spec((b, s), i32)}


def prefill_batch_specs(cfg: ModelConfig, global_batch: int, seq_len: int
                        ) -> Dict[str, torch.Tensor]:
    specs = train_batch_specs(cfg, global_batch, seq_len)
    specs.pop("labels")
    return specs


def decode_token_specs(cfg: ModelConfig, global_batch: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens, pos) stand-ins for one decode step."""
    i32 = torch.int32
    if cfg.family == "audio":
        tok = _spec((global_batch, 1, cfg.num_codebooks), i32)
    else:
        tok = _spec((global_batch, 1), i32)
    return tok, _spec((global_batch,), i32)
