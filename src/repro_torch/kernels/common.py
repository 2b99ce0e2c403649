"""Shared helpers of the port's kernels (a copy of ``repro.kernels.common``'s
``round_up``; the port imports nothing of the JAX package)."""

from __future__ import annotations


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m
