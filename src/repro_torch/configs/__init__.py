"""Architecture configs the port serves and trains (one module per arch +
smoke variants).

``get_config(arch)`` / ``get_smoke_config(arch)`` resolve the public arch
ids as the JAX package does; each module's ``CONFIG`` and ``SMOKE`` are
copied verbatim from it.  The port serves and trains every arch of the
JAX package: llama3.2-3b, qwen3-8b, qwen3-32b and gemma-7b (dense),
mamba2-780m (ssm), olmoe-1b-7b and deepseek-v2-lite-16b (MoE; deepseek
with MLA attention), jamba-v0.1-52b (hybrid MoE), llava-next-34b (vlm:
precomputed patch embeddings ahead of the text) and musicgen-large
(audio: K codebooks summed in, K logit heads out).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "llama3.2-3b": "llama3_2_3b",
    "qwen3-32b": "qwen3_32b",
    "gemma-7b": "gemma_7b",
    "qwen3-8b": "qwen3_8b",
    "mamba2-780m": "mamba2_780m",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llava-next-34b": "llava_next_34b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "musicgen-large": "musicgen_large",
}

ARCHS: List[str] = list(_MODULES)


def _module(arch: str):
    try:
        name = _MODULES[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; known: {ARCHS}") from None
    return importlib.import_module(f".{name}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
