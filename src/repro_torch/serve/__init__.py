"""Serving layer of the port: the batched LLM engine (prefill -> decode).

The JAX package's query scheduler and process-level program cache
(``serve/scheduler.py``, ``serve/cache.py``) serve dataframe queries and
are ROADMAP queue 1, item 11; they are not ported yet.
"""

from .engine import GenerationResult, ServeEngine

__all__ = ["GenerationResult", "ServeEngine"]
