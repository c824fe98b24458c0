"""Script normalization — pure functions, stdlib-only.

Behavioral contract mirrors the reference normalizer
(ref: backend/shared/text_normalize.py): CRLF folding, blank-line
collapse, legacy-directive stripping, the "II"→"Il" OCR repair, and
French paste cleanup with a change report for the UI.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from vocalie_tts_tpu_torch.text.constants import LEGACY_TOKEN_PATTERN

_WORD_RE = re.compile(r"\w+")
_MULTI_BLANK_RE = re.compile(r"\n{3,}")
_OCR_II_RE = re.compile(r"(^|[.!?\n;:])\s*II\b")
_PUNCT_NEEDS_SPACE_RE = re.compile(r"([.!?;:,])(?!\s|$)")
_INLINE_WS_RE = re.compile(r"[ \t]+")


def count_words(text: str) -> int:
    """Word count as the pipeline defines it: runs of \\w characters."""
    return len(_WORD_RE.findall(text))


def first_word(text: str) -> str:
    """First whitespace-delimited word, stripped of edge punctuation."""
    if not text:
        return ""
    head = text.split(maxsplit=1)[0]
    return re.sub(r"^[^\w]+|[^\w]+$", "", head)


def strip_legacy_tokens(text: str) -> str:
    """Remove legacy {pause:N}/{breath}/{beat} directives."""
    if not text:
        return ""
    return LEGACY_TOKEN_PATTERN.sub("", text)


def normalize_whitespace(text: str) -> str:
    """Collapse intra-line whitespace, keep manual line breaks, drop
    blank lines."""
    lines = [re.sub(r"\s+", " ", ln).strip() for ln in text.splitlines()]
    return "\n".join(ln for ln in lines if ln).strip()


def normalize_text(text: str) -> str:
    """Canonical script normalization applied before chunking.

    Steps (order matters — ref: backend/shared/text_normalize.py:43-56):
    CRLF→LF, collapse 3+ blank lines, strip legacy directives, repair
    the "II" OCR artifact after sentence boundaries, guarantee a space
    after clause punctuation, collapse runs of spaces/tabs per line.
    """
    if not text:
        return ""
    s = text.replace("\r\n", "\n")
    s = _MULTI_BLANK_RE.sub("\n\n", s)
    s = strip_legacy_tokens(s)
    s = _OCR_II_RE.sub(r"\1 Il", s)
    s = _PUNCT_NEEDS_SPACE_RE.sub(r"\1 ", s)
    s = "\n".join(_INLINE_WS_RE.sub(" ", ln).strip() for ln in s.split("\n"))
    return s.strip()


def normalize_paste_fr(text: str) -> Tuple[str, List[str]]:
    """Clean text freshly pasted from a word processor or webpage.

    Returns (cleaned_text, change_tags); the tags let the UI explain
    what was touched (ref: backend/shared/text_normalize.py:59-89).
    """
    if text is None:
        return "", ["paste_norm_applied: false"]
    original = text
    s = text.replace("\r\n", "\n").replace("\r", "\n")
    s, n_nbsp = re.subn(r"[\u00A0\u202F\u2007]", " ", s)
    s, n_space = re.subn(r"[ \t]+", " ", s)
    s, n_ellipsis = re.subn(r"\.{3,}", "…", s)
    s, n_double_dot = re.subn(r"(?<!\.)\.\.(?!\.)", ".", s)
    s, n_space_before = re.subn(r"\s+([,.;:!?])", r"\1", s)
    s, n_space_after = re.subn(r'([,.;:!?])(?=[^\s»”"])', r"\1 ", s)
    s, n_newlines = re.subn(r"\n{3,}", "\n\n", s)
    s = s.strip()

    changed = s != original
    tags: List[str] = [f"paste_norm_applied: {str(changed).lower()}"]
    if changed:
        tags.append(
            "paste_norm_counts: "
            f"nbsp={n_nbsp}, spaces={n_space}, "
            f"ellipsis={n_ellipsis}, double_dot={n_double_dot}, "
            f"space_before_punct={n_space_before}, space_after_punct={n_space_after}, "
            f"newlines={n_newlines}"
        )
    return s, tags


__all__ = [
    "count_words",
    "first_word",
    "strip_legacy_tokens",
    "normalize_whitespace",
    "normalize_text",
    "normalize_paste_fr",
]
