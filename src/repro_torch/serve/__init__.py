"""Serving layer of the port: concurrent multi-query scheduling over
gangs carved from one pool of rank slots (``scheduler``), the process-
level stage cache (``cache``), and the batched LLM engine (``engine``).

Submodules import lazily (module ``__getattr__``), as in the JAX package,
so ``repro_torch.core`` can reference ``repro_torch.serve.cache`` without
a cycle and importing the scheduler never drags in the model stack.
"""

from typing import Any

__all__ = [
    "AdmissionRejected", "GLOBAL_PROGRAM_CACHE", "GenerationResult",
    "ProgramCache", "QueryHandle", "QueryScheduler", "ServeEngine",
]

_HOMES = {
    "AdmissionRejected": "scheduler",
    "QueryHandle": "scheduler",
    "QueryScheduler": "scheduler",
    "ProgramCache": "cache",
    "GLOBAL_PROGRAM_CACHE": "cache",
    "GenerationResult": "engine",
    "ServeEngine": "engine",
}


def __getattr__(name: str) -> Any:
    home = _HOMES.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{home}", __name__), name)


def __dir__():
    return sorted(__all__)
