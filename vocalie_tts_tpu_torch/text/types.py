"""Value types exchanged between the text-preparation stages.

(ref: backend/shared/text_models.py)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class SpeechSegment:
    """A unit of audio to synthesize: spoken text or an explicit silence."""

    kind: str  # "text" | "silence"
    content: str
    duration_ms: int = 0


@dataclass
class TextUnit:
    """Tokenized unit used internally by chunking helpers."""

    text: str
    sentence_end: bool = False
    hard_break: bool = False
    char_fallback: bool = False


@dataclass
class DurationAdjustment:
    """Outcome of resizing a script toward a target speaking duration."""

    text: str
    estimated_duration: float
    target_duration: float
    warning: Optional[str] = None


@dataclass
class ChunkInfo:
    """One prepared chunk plus the metadata the synthesis pipeline needs
    to schedule it and stitch the audio back together."""

    segments: List[SpeechSegment]
    sentence_count: int
    char_count: int
    word_count: int
    comma_count: int
    estimated_duration: float
    reason: str
    boundary_kind: Optional[str] = None
    pivot: bool = False
    ends_with_suspended: bool = False
    oversize_sentence: bool = False
    warnings: List[str] = field(default_factory=list)


__all__ = ["SpeechSegment", "TextUnit", "DurationAdjustment", "ChunkInfo"]
