"""Script chunking: split a long script into synthesizable chunks.

The chunker is deterministic, user-predictable product behavior
(ref: backend/shared/text_chunk.py). Strategy, in priority order:

1. newline boundaries (when the running chunk has enough words),
2. sentence terminators . ! ? once a chunk exceeds the word budget,
3. fallback punctuation in strength order  :  ;  —  -  ,
4. hard word split that refuses to strand a French determiner.

Manual ``[[CHUNK]]`` markers always win (``parse_manual_chunks``) —
the job API never auto-chunks.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from vocalie_tts_tpu_torch.text.constants import (
    AVERAGE_WPS,
    DEFAULT_MAX_CHARS_PER_CHUNK,
    DEFAULT_MAX_EST_SECONDS_PER_CHUNK,
    DEFAULT_MAX_WORDS_WITHOUT_TERMINATOR,
    DEFAULT_MIN_WORDS_PER_CHUNK,
    DETERMINERS,
    FALLBACK_PUNCTUATION,
    MANUAL_CHUNK_MARKER,
    PIVOT_WORDS,
    TERMINATOR_CHARS,
)
from vocalie_tts_tpu_torch.text.duration import estimate_duration
from vocalie_tts_tpu_torch.text.normalize import count_words, first_word, normalize_text
from vocalie_tts_tpu_torch.text.render import (
    render_clean_text,
    render_clean_text_from_segments,
)
from vocalie_tts_tpu_torch.text.types import ChunkInfo, SpeechSegment

_TOKEN_RE = re.compile(r"\w+|\n|[^\w\n]")
_WORD_TOKEN_RE = re.compile(r"\w+")
_SENTENCE_END_RE = re.compile(r"[.!?]")


def _tokenize(text: str) -> List[str]:
    """Token stream: words, newlines, and every other char singly."""
    return _TOKEN_RE.findall(text)


def _is_word(token: str) -> bool:
    return bool(_WORD_TOKEN_RE.fullmatch(token))


def _dash_is_separator(tokens: Sequence[str], idx: int) -> bool:
    """True for an em-dash, or a hyphen surrounded by whitespace (a
    clause separator rather than a compound-word hyphen)."""
    if idx < 0 or idx >= len(tokens):
        return False
    tok = tokens[idx]
    if tok == "—":
        return True
    if tok != "-":
        return False
    prev_tok = tokens[idx - 1] if idx > 0 else ""
    next_tok = tokens[idx + 1] if idx + 1 < len(tokens) else ""
    return bool(prev_tok.isspace() and next_tok.isspace())


def _make_chunk(
    text: str,
    *,
    reason: str,
    boundary_kind: Optional[str],
    warnings: Optional[List[str]] = None,
    pivot: bool = False,
    oversize_sentence: bool = False,
    sentence_count: Optional[int] = None,
    ends_with_suspended: Optional[bool] = None,
) -> ChunkInfo:
    """Build a ChunkInfo with metadata derived from the clean render."""
    clean = render_clean_text(text)
    if ends_with_suspended is None:
        ends_with_suspended = clean.rstrip().endswith((",", ";", ":"))
    return ChunkInfo(
        segments=[SpeechSegment("text", text)],
        sentence_count=(
            len(_SENTENCE_END_RE.findall(clean)) if sentence_count is None else sentence_count
        ),
        char_count=len(text),
        word_count=count_words(clean),
        comma_count=clean.count(","),
        estimated_duration=estimate_duration(clean),
        reason=reason,
        boundary_kind=boundary_kind,
        pivot=pivot,
        ends_with_suspended=ends_with_suspended,
        oversize_sentence=oversize_sentence,
        warnings=list(warnings or []),
    )


@dataclass
class _Cursor:
    """Mutable state of the chunk under construction."""

    buffer: List[str] = field(default_factory=list)
    word_count: int = 0
    words_since_terminator: int = 0
    last_terminator_idx: Optional[int] = None
    fallback_at: Dict[str, Optional[int]] = field(
        default_factory=lambda: {p: None for p in FALLBACK_PUNCTUATION}
    )
    warnings: List[str] = field(default_factory=list)

    def rescan(self) -> None:
        """Recompute all derived state from the current buffer."""
        self.word_count = 0
        self.words_since_terminator = 0
        self.last_terminator_idx = None
        self.fallback_at = {p: None for p in FALLBACK_PUNCTUATION}
        for idx, tok in enumerate(self.buffer):
            if _is_word(tok):
                self.word_count += 1
                self.words_since_terminator += 1
            elif tok in TERMINATOR_CHARS:
                self.last_terminator_idx = idx
                self.words_since_terminator = 0
            elif tok in (":", ";", "—", ","):
                self.fallback_at[tok] = idx
            elif tok == "-" and _dash_is_separator(self.buffer, idx):
                self.fallback_at["-"] = idx

    def best_fallback(self) -> Tuple[Optional[str], Optional[int]]:
        """Strongest fallback punctuation seen so far (priority order)."""
        for punct in FALLBACK_PUNCTUATION:
            idx = self.fallback_at.get(punct)
            if idx is not None:
                return punct, idx
        return None, None


def _word_split_point(
    tokens: Sequence[str],
    target_words: int,
    min_words: int,
) -> Optional[int]:
    """Buffer index of the word to end a hard split on.

    Aims for *target_words*, clamped to [min_words, total]; if the
    landing word is a French determiner, extends by one word so the
    article stays with its noun.
    """
    positions: List[Tuple[int, int, str]] = []  # (word ordinal, buffer idx, token)
    ordinal = 0
    for idx, tok in enumerate(tokens):
        if _is_word(tok):
            ordinal += 1
            positions.append((ordinal, idx, tok))
    if not positions:
        return None
    total = positions[-1][0]
    if target_words <= 0:
        target_words = total
    target_words = min(max(target_words, min_words), total)
    split_idx, split_word = positions[-1][1], positions[-1][2]
    for count, idx, tok in positions:
        if count >= target_words:
            split_idx, split_word = idx, tok
            break
    if split_word.lower() in DETERMINERS:
        extended = min(target_words + 1, total)
        for count, idx, _tok in positions:
            if count == extended:
                split_idx = idx
                break
    return split_idx


def chunk_script(
    script: str,
    *,
    min_words_per_chunk: int = DEFAULT_MIN_WORDS_PER_CHUNK,
    max_words_without_terminator: int = DEFAULT_MAX_WORDS_WITHOUT_TERMINATOR,
    max_est_seconds_per_chunk: float = DEFAULT_MAX_EST_SECONDS_PER_CHUNK,
    split_on_newline: bool = True,
) -> List[ChunkInfo]:
    """Split *script* into chunks ready for sequential synthesis."""
    cleaned = normalize_text(script)
    if not cleaned:
        return []
    min_words = max(0, min(int(min_words_per_chunk), 20))
    tokens = _tokenize(cleaned)
    if not tokens:
        return []
    word_budget = (
        int(max_est_seconds_per_chunk * AVERAGE_WPS) if max_est_seconds_per_chunk > 0 else 0
    )

    cur = _Cursor()
    chunks: List[ChunkInfo] = []
    tail_forced = False  # last emit was a forced (hard/fallback) split

    def emit(split_idx: int, reason: str, boundary_kind: Optional[str], warnings: List[str]) -> None:
        nonlocal tail_forced
        if split_idx < 0:
            return
        text = "".join(cur.buffer[: split_idx + 1])
        if boundary_kind == "newline":
            text = text.rstrip("\n")
        text = text.strip()
        if text:
            chunks.append(_make_chunk(text, reason=reason, boundary_kind=boundary_kind, warnings=warnings))
        tail_forced = reason == "hard" or reason.startswith("fallback(")
        del cur.buffer[: split_idx + 1]
        while cur.buffer and cur.buffer[0].isspace():
            cur.buffer.pop(0)
        cur.rescan()
        cur.warnings = []

    for idx, tok in enumerate(tokens):
        cur.buffer.append(tok)
        if _is_word(tok):
            cur.word_count += 1
            cur.words_since_terminator += 1
        elif tok in TERMINATOR_CHARS:
            cur.last_terminator_idx = len(cur.buffer) - 1
            cur.words_since_terminator = 0

        if tok == "\n" and split_on_newline:
            if cur.word_count >= min_words:
                emit(len(cur.buffer) - 1, "newline", "newline", cur.warnings)
                continue
            cur.warnings.append("newline_boundary_skipped_min_words")

        if tok in (":", ";", "—", ","):
            cur.fallback_at[tok] = len(cur.buffer) - 1
        elif tok == "-" and _dash_is_separator(tokens, idx):
            cur.fallback_at["-"] = len(cur.buffer) - 1

        # Run-on clause: too many words since the last terminator.
        if max_words_without_terminator > 0 and cur.words_since_terminator > max_words_without_terminator:
            punct, split_idx = cur.best_fallback()
            if punct is not None and split_idx is not None:
                emit(
                    split_idx,
                    f"fallback({punct})",
                    punct,
                    cur.warnings + [f"fallback_split_used:{punct}"],
                )
                continue
            split_idx = _word_split_point(cur.buffer, max_words_without_terminator, min_words)
            if split_idx is not None:
                emit(split_idx, "hard", "hard", cur.warnings + ["hard_split_no_punct"])
                continue

        # Chunk over the word budget: prefer a terminator boundary.
        if word_budget > 0 and cur.word_count > word_budget:
            if cur.last_terminator_idx is not None:
                emit(cur.last_terminator_idx, "terminator", "terminator", cur.warnings)
                continue
            punct, split_idx = cur.best_fallback()
            if punct is not None and split_idx is not None:
                emit(
                    split_idx,
                    f"fallback({punct})",
                    punct,
                    cur.warnings + [f"fallback_split_used:{punct}"],
                )
                continue
            split_idx = _word_split_point(cur.buffer, word_budget, min_words)
            if split_idx is not None:
                emit(split_idx, "hard", "hard", cur.warnings + ["hard_split_no_punct"])
                continue

    if cur.buffer:
        if tail_forced and cur.word_count < min_words and chunks:
            # A forced split left a stub tail: fold it into the previous
            # chunk instead of emitting an unnaturally short one.
            prev = chunks[-1]
            merged = render_clean_text_from_segments(prev.segments) + "".join(cur.buffer)
            chunks[-1] = _make_chunk(
                merged,
                reason=prev.reason,
                boundary_kind=prev.boundary_kind,
                warnings=prev.warnings,
                pivot=prev.pivot,
                oversize_sentence=prev.oversize_sentence,
            )
        else:
            emit(len(cur.buffer) - 1, "end", None, cur.warnings)
    return chunks


def parse_manual_chunks(
    snapshot: str,
    *,
    marker: str = MANUAL_CHUNK_MARKER,
) -> Tuple[List[ChunkInfo], int]:
    """Split on explicit user markers; returns ([], 0) when none present."""
    if not snapshot:
        return [], 0
    marker_count = snapshot.count(marker)
    if marker_count == 0:
        return [], 0
    chunks: List[ChunkInfo] = []
    for part in snapshot.split(marker):
        text = part.strip()
        if not text:
            continue
        chunks.append(_make_chunk(text, reason="manual_marker", boundary_kind="manual_marker"))
    return chunks, marker_count


# ── refinement passes (oversize split / short merge / pivot split) ──────


def _cut_by_length(text: str, max_chars: int) -> List[str]:
    """Last-resort split at the latest space/newline under *max_chars*."""
    parts: List[str] = []
    text = text.strip()
    while len(text) > max_chars:
        cut = max(text.rfind(" ", 0, max_chars), text.rfind("\n", 0, max_chars))
        if cut <= 0:
            cut = max_chars
        parts.append(text[:cut].rstrip())
        text = text[cut:].lstrip()
    if text:
        parts.append(text)
    return parts


def _cut_after_each(text: str, punct: str) -> List[str]:
    """Split keeping the punctuation with the left part."""
    if punct not in text:
        return [text]
    parts: List[str] = []
    start = 0
    for idx, ch in enumerate(text):
        if ch == punct:
            parts.append(text[start : idx + 1])
            start = idx + 1
    if text[start:]:
        parts.append(text[start:])
    return parts


def _cut_by_words(text: str, max_words: int, safe_tail_words: int = 2) -> List[str]:
    """Fixed-size word windows, avoiding a tail shorter than
    *safe_tail_words*."""
    if max_words <= 0:
        return [text]
    words = text.split()
    if len(words) <= max_words:
        return [text]
    parts: List[str] = []
    idx = 0
    while idx < len(words):
        end = min(idx + max_words, len(words))
        remaining = len(words) - end
        if 0 < remaining < safe_tail_words:
            end = max(len(words) - safe_tail_words, idx + 1)
        parts.append(" ".join(words[idx:end]))
        idx = end
    return parts


def split_oversize_chunks(
    chunks: List[ChunkInfo],
    max_est_seconds: float,
    max_chars: int,
) -> List[ChunkInfo]:
    """Re-split chunks whose estimated duration exceeds the budget.

    Candidate boundaries in order: sentence enders, then ; :, then
    newlines, then raw length; parts still over the word budget get a
    fixed-window word split.
    """
    if max_est_seconds <= 0:
        return chunks
    out: List[ChunkInfo] = []
    for chunk in chunks:
        if chunk.estimated_duration <= max_est_seconds:
            out.append(chunk)
            continue
        text = render_clean_text_from_segments(chunk.segments)
        candidates: List[str] = []
        for punct in [".", "!", "?", "…"]:
            if punct in text:
                candidates = _cut_after_each(text, punct)
                if len(candidates) > 1:
                    break
                candidates = []
        if not candidates:
            for punct in [";", ":"]:
                if punct in text:
                    candidates = _cut_after_each(text, punct)
                    if len(candidates) > 1:
                        break
                    candidates = []
        if not candidates and "\n" in text:
            candidates = text.split("\n")
        if not candidates:
            candidates = _cut_by_length(text, max_chars if max_chars > 0 else DEFAULT_MAX_CHARS_PER_CHUNK)
        word_budget = max(int(max_est_seconds * AVERAGE_WPS), 1)
        for part in candidates:
            clean = render_clean_text(part)
            subparts = (
                _cut_by_words(clean, word_budget)
                if word_budget > 0 and count_words(clean) > word_budget
                else [part]
            )
            for sub in subparts:
                clean_sub = render_clean_text(sub)
                stripped = clean_sub.rstrip()
                if stripped.endswith((".", "!", "?", "…")):
                    boundary = "period"
                elif "\n" in clean_sub:
                    boundary = "newline"
                else:
                    boundary = "hard"
                out.append(
                    _make_chunk(
                        sub,
                        reason="max-est-split",
                        boundary_kind=boundary,
                        sentence_count=1,
                        ends_with_suspended=False,
                        oversize_sentence=chunk.oversize_sentence,
                    )
                )
    return out


def merge_short_chunks(
    chunks: List[ChunkInfo],
    min_words: int,
    max_est_seconds: float,
) -> List[ChunkInfo]:
    """Merge chunks that are too short to synthesize naturally.

    A short chunk (under *min_words* or < 2 s estimated) merges forward
    into the next chunk, or backward into the previous one at the end,
    unless either side is a pivot chunk or the merge would blow the
    duration budget.
    """
    if min_words <= 0 or len(chunks) <= 1:
        return chunks
    out: List[ChunkInfo] = []
    idx = 0
    while idx < len(chunks):
        current = chunks[idx]
        clean_current = render_clean_text_from_segments(current.segments)
        is_short = count_words(clean_current) < min_words or estimate_duration(clean_current) < 2.0
        if not is_short or current.pivot:
            out.append(current)
            idx += 1
            continue
        if idx < len(chunks) - 1:
            nxt = chunks[idx + 1]
            if nxt.pivot:
                out.append(current)
                idx += 1
                continue
            merged_text = clean_current + " " + render_clean_text_from_segments(nxt.segments)
            clean = render_clean_text(merged_text)
            if max_est_seconds > 0 and estimate_duration(clean) > max_est_seconds:
                out.append(current)
                idx += 1
                continue
            out.append(
                _make_chunk(
                    merged_text,
                    reason="min-words-merge",
                    boundary_kind=nxt.boundary_kind,
                    sentence_count=current.sentence_count + nxt.sentence_count,
                    pivot=current.pivot or nxt.pivot,
                    ends_with_suspended=False,
                    oversize_sentence=current.oversize_sentence or nxt.oversize_sentence,
                )
            )
            idx += 2
            continue
        if out:
            prev = out.pop()
            merged_text = render_clean_text_from_segments(prev.segments) + " " + clean_current
            clean = render_clean_text(merged_text)
            if max_est_seconds > 0 and estimate_duration(clean) > max_est_seconds:
                out.append(prev)
                out.append(current)
                idx += 1
                continue
            out.append(
                _make_chunk(
                    merged_text,
                    reason="min-words-merge",
                    boundary_kind=prev.boundary_kind,
                    sentence_count=prev.sentence_count + current.sentence_count,
                    pivot=prev.pivot or current.pivot,
                    ends_with_suspended=False,
                    oversize_sentence=prev.oversize_sentence or current.oversize_sentence,
                )
            )
        idx += 1
    return out


def apply_pivot_splits(
    chunks: List[ChunkInfo],
    max_est_seconds: float,
    min_words: int,
) -> List[ChunkInfo]:
    """Split chunks that open with a discourse pivot (Cependant, …).

    Only fires when the chunk is comma-heavy or over the duration
    budget; the cut lands on the first comma (or first period) whose
    left side is a speakable clause (≥ max(min_words, 2) words, ≥ 2 s).
    """
    out: List[ChunkInfo] = []
    for chunk in chunks:
        text = render_clean_text_from_segments(chunk.segments).strip()
        head = first_word(text)
        comma_count = text.count(",")
        if head in PIVOT_WORDS and (comma_count > 2 or chunk.estimated_duration > max_est_seconds):
            cut = -1
            if comma_count > 0:
                for idx, ch in enumerate(text):
                    if ch != ",":
                        continue
                    left_clean = render_clean_text(text[: idx + 1])
                    if (
                        count_words(left_clean) >= max(min_words, 2)
                        and estimate_duration(left_clean) >= 2.0
                    ):
                        cut = idx
                        break
            if cut == -1 and "." in text:
                dot = text.find(".")
                left_clean = render_clean_text(text[: dot + 1])
                if (
                    count_words(left_clean) >= max(min_words, 2)
                    and estimate_duration(left_clean) >= 2.0
                ):
                    cut = dot
            if cut != -1:
                left = text[: cut + 1]
                right = text[cut + 1 :].lstrip()
                parts = [p for p in (left, right) if p.strip()]
                if len(parts) >= 2:
                    for part in parts:
                        out.append(
                            _make_chunk(
                                part,
                                reason="pivot-split",
                                boundary_kind=None,
                                sentence_count=1,
                                pivot=True,
                                ends_with_suspended=False,
                                oversize_sentence=chunk.oversize_sentence,
                            )
                        )
                    continue
        out.append(chunk)
    return out


__all__ = [
    "chunk_script",
    "parse_manual_chunks",
    "split_oversize_chunks",
    "merge_short_chunks",
    "apply_pivot_splits",
]
