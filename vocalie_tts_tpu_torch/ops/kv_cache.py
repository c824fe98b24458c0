"""Bucket helpers for the decode loop (counterparts of
``vocalie_tts_tpu/ops/kv_cache.py::pick_bucket`` and ``round_cache_len``)."""

from __future__ import annotations

from typing import Tuple


def pick_bucket(length: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket >= length (last bucket if none fits) — keeps the
    number of distinct shapes bounded."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def round_cache_len(n: int, multiple: int = 128) -> int:
    """Round a KV-cache allocation up to a 128-multiple: decode attention
    reads the cache in 128-slot blocks and stops at the valid length."""
    return -(-n // multiple) * multiple


__all__ = ["pick_bucket", "round_cache_len"]
