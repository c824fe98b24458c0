"""Deterministic text preparation: the port's copy of the JAX package's
``text/`` chunker, renderer and duration model (pure Python, no JAX).

Only what the voice-over path reads is copied, and the French G2P and
the Piper id map of the VITS engine (``phonemes.py``, ``piper_ids.py``);
the prep lexicon and the published-tokenizer modules stay with the JAX
package until a slice needs them.
"""

from vocalie_tts_tpu_torch.text.constants import (
    AVERAGE_WPS,
    DEFAULT_MAX_EST_SECONDS_PER_CHUNK,
    DEFAULT_MAX_WORDS_WITHOUT_TERMINATOR,
    DEFAULT_MIN_WORDS_PER_CHUNK,
    MANUAL_CHUNK_MARKER,
)
from vocalie_tts_tpu_torch.text.types import ChunkInfo, SpeechSegment
from vocalie_tts_tpu_torch.text.normalize import normalize_text, strip_legacy_tokens
from vocalie_tts_tpu_torch.text.duration import estimate_duration
from vocalie_tts_tpu_torch.text.chunk import chunk_script, parse_manual_chunks
from vocalie_tts_tpu_torch.text.render import render_clean_text_from_segments

__all__ = [
    "AVERAGE_WPS",
    "DEFAULT_MAX_EST_SECONDS_PER_CHUNK",
    "DEFAULT_MAX_WORDS_WITHOUT_TERMINATOR",
    "DEFAULT_MIN_WORDS_PER_CHUNK",
    "MANUAL_CHUNK_MARKER",
    "ChunkInfo",
    "SpeechSegment",
    "normalize_text",
    "strip_legacy_tokens",
    "estimate_duration",
    "chunk_script",
    "parse_manual_chunks",
    "render_clean_text_from_segments",
]
