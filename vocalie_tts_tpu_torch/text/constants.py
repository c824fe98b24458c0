"""Tunable constants of the text-preparation pipeline.

These values are product behavior (they decide where a voice-over is
cut and how long a chunk may run) and mirror the reference exactly
(ref: backend/shared/text_constants.py:15-56).
"""

from __future__ import annotations

import re

# Empirical French promo voice-over speaking speed, words per second.
AVERAGE_WPS = 2.6

# Chunking defaults (ref: backend/shared/text_constants.py:20-26).
DEFAULT_MAX_CHARS_PER_CHUNK = 380
DEFAULT_MAX_PHRASES_PER_CHUNK = 3
DEFAULT_MIN_WORDS_PER_CHUNK = 16
DEFAULT_MAX_EST_SECONDS_PER_CHUNK = 10.0
DEFAULT_MAX_WORDS_WITHOUT_TERMINATOR = 35
FINAL_MERGE_EST_SECONDS = 3.5

# The only chunk-control surface exposed to users: explicit markers.
MANUAL_CHUNK_MARKER = "[[CHUNK]]"

# Punctuation taxonomy. FALLBACK_PUNCTUATION is a *priority order*:
# when no sentence terminator is available the chunker prefers the
# strongest separator seen so far, strongest first.
TERMINATOR_CHARS = (".", "!", "?")
FALLBACK_PUNCTUATION = (":", ";", "—", "-", ",")

# French discourse-pivot words that open a contrastive clause; a chunk
# starting with one of these may be split at its first strong comma.
PIVOT_WORDS = {
    "Cependant", "Pourtant", "Or", "Alors", "Néanmoins", "Toutefois",
}

# Legacy SSML-ish inline directives silently stripped from scripts.
LEGACY_TOKEN_PATTERN = re.compile(
    r"\{(?P<token>pause:\s*\d+|breath|beat)\}",
    re.IGNORECASE,
)

# French determiners: a hard word-split must not leave one of these
# dangling at the end of a chunk.
DETERMINERS = frozenset({
    "le", "la", "les",
    "un", "une", "des",
    "du", "de", "au", "aux",
    "ce", "cet", "cette", "ces",
    "mon", "ma", "mes",
    "ton", "ta", "tes",
    "son", "sa", "ses",
    "notre", "nos",
    "votre", "vos",
    "leur", "leurs",
})

__all__ = [
    "AVERAGE_WPS",
    "DEFAULT_MAX_CHARS_PER_CHUNK",
    "DEFAULT_MAX_PHRASES_PER_CHUNK",
    "DEFAULT_MIN_WORDS_PER_CHUNK",
    "DEFAULT_MAX_EST_SECONDS_PER_CHUNK",
    "DEFAULT_MAX_WORDS_WITHOUT_TERMINATOR",
    "FINAL_MERGE_EST_SECONDS",
    "MANUAL_CHUNK_MARKER",
    "TERMINATOR_CHARS",
    "FALLBACK_PUNCTUATION",
    "PIVOT_WORDS",
    "LEGACY_TOKEN_PATTERN",
    "DETERMINERS",
]
