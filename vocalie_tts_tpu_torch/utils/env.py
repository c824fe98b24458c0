"""Shared boolean env-var parsing.

One implementation of the documented convention (docs/ENV_POLICY.md
"Conventions": booleans accept 1/true/yes/on, case-insensitive) so a
default-on flag set to "true" cannot silently disable the feature —
previously several knobs compared == "1" (advisor finding, round 3).
Mirrors the reference's `_parse_bool_env` semantics
(ref: backend/config.py:25-29) with an added tri-state variant for
auto-defaulting kernel knobs.
"""

from __future__ import annotations

import os
from typing import Optional

_TRUTHY = {"1", "true", "yes", "on"}


def bool_env(name: str, default: bool = False) -> bool:
    """Boolean env knob: unset/empty → ``default``; else truthy-set test."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return bool(default)
    return raw.strip().lower() in _TRUTHY


def tri_env(name: str) -> Optional[bool]:
    """Tri-state env knob: unset/empty → None (auto); else boolean."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return None
    return raw.strip().lower() in _TRUTHY


__all__ = ["bool_env", "tri_env"]
