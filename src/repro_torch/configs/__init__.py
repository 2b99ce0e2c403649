"""Architecture configs the port serves and trains (one module per arch +
smoke variants).

``get_config(arch)`` / ``get_smoke_config(arch)`` resolve the public arch
ids as the JAX package does; each module's ``CONFIG`` and ``SMOKE`` are
copied verbatim from it.  The port serves and trains qwen3-8b (dense),
mamba2-780m (ssm), olmoe-1b-7b (MoE) and jamba-v0.1-52b (hybrid MoE) so
far: any other arch of the JAX package raises ``NotImplementedError``
naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "qwen3-8b": "qwen3_8b",
    "mamba2-780m": "mamba2_780m",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}

#: archs of the JAX package that the port does not serve or train yet
_LATER = ("llama3.2-3b", "qwen3-32b", "gemma-7b", "deepseek-v2-lite-16b",
          "llava-next-34b", "musicgen-large")

ARCHS: List[str] = list(_MODULES)


def _module(arch: str):
    if arch in _LATER:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP queue 1, item 13: "
            f"the port serves and trains {ARCHS} so far)")
    try:
        name = _MODULES[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; known: {ARCHS}") from None
    return importlib.import_module(f".{name}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
