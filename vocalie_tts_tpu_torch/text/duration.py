"""Speaking-duration estimation and deterministic script resizing.

(ref: backend/shared/text_duration.py)
"""

from __future__ import annotations

from typing import Optional

from vocalie_tts_tpu_torch.text.constants import AVERAGE_WPS
from vocalie_tts_tpu_torch.text.normalize import count_words, normalize_whitespace
from vocalie_tts_tpu_torch.text.types import DurationAdjustment


def estimate_duration(text: str, words_per_sec: float = AVERAGE_WPS) -> float:
    """Estimated speaking time in seconds at the French VO rate."""
    if words_per_sec <= 0:
        words_per_sec = AVERAGE_WPS
    return max(count_words(text) / words_per_sec, 0.0)


def adjust_text_to_duration(
    text: str,
    target_seconds: float,
    tolerance: float = 0.2,
) -> DurationAdjustment:
    """Deterministically resize *text* toward *target_seconds*.

    Trims words from the end, or duplicates the script, until within
    tolerance — never calls a language model, and warns (in French, the
    product language) when the result needs a human pass.
    """
    normalized = normalize_whitespace(text)
    if not normalized:
        return DurationAdjustment("", 0.0, target_seconds, warning="Texte vide.")

    est = estimate_duration(normalized)
    if target_seconds <= 0 or est == 0:
        return DurationAdjustment(normalized, est, target_seconds)

    ratio = target_seconds / est
    if abs(1 - ratio) <= tolerance:
        return DurationAdjustment(normalized, est, target_seconds)

    words = normalized.split()
    desired = max(int(len(words) * ratio), 3)
    warning: Optional[str]
    if desired < len(words):
        resized = words[:desired]
        warning = "Texte raccourci automatiquement, vérifiez le sens."
    else:
        pool = list(words)
        while len(pool) < desired:
            pool += words
        resized = pool[:desired]
        warning = "Texte allongé en dupliquant certains segments, ajustez manuellement."

    adjusted = " ".join(resized)
    return DurationAdjustment(adjusted, estimate_duration(adjusted), target_seconds, warning)


__all__ = ["estimate_duration", "adjust_text_to_duration"]
