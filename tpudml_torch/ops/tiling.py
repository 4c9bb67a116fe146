"""Shared tiling helper (the port's copy of ``tpudml/ops/tiling.py``)."""

from __future__ import annotations


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m
