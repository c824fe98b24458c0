"""Render chunks/segments to engine-ready text and stitched audio.

(ref: backend/shared/text_render.py)
"""

from __future__ import annotations

from typing import Callable, Iterable, List

import numpy as np

from vocalie_tts_tpu_torch.text.normalize import normalize_text
from vocalie_tts_tpu_torch.text.types import SpeechSegment


def render_clean_text(text: str) -> str:
    """Final normalization pass: the result is safe to feed an engine."""
    return normalize_text(text or "")


def render_clean_text_from_segments(segments: Iterable[SpeechSegment]) -> str:
    joined = "".join(seg.content for seg in segments if seg.kind == "text")
    return normalize_text(joined)


def stitch_segments(
    segments: Iterable[SpeechSegment],
    sr: int,
    synth_fn: Callable[[str], np.ndarray],
) -> np.ndarray:
    """Concatenate synthesized segments, inserting explicit silence gaps.

    The synthesis callable is injected so this module stays free of any
    engine import.
    """
    pieces: List[np.ndarray] = []
    for seg in segments:
        if seg.kind == "silence":
            n = int(sr * (seg.duration_ms / 1000.0))
            if n > 0:
                pieces.append(np.zeros(n, dtype=np.float32))
            continue
        spoken = seg.content.strip()
        if spoken:
            pieces.append(synth_fn(spoken).astype(np.float32))
    if not pieces:
        return np.zeros(0, dtype=np.float32)
    return np.concatenate(pieces)


__all__ = ["render_clean_text", "render_clean_text_from_segments", "stitch_segments"]
