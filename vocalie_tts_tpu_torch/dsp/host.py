"""Host-side (numpy/scipy) audio DSP with reference semantics.

Every routine mirrors the observable behavior of the reference
pipeline (ref: backend/shared/tts_pipeline.py:60-274,
backend/shared/audio_edit.py:16-79) so WAV outputs are bit-comparable
where the reference is deterministic.
"""

from __future__ import annotations

from math import gcd
from typing import List, Tuple

import numpy as np
from scipy.signal import resample_poly


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample to *target_sr*; passthrough when equal.

    Channels-last 2-D input is resampled per channel and re-stacked
    (ref semantics: tts_pipeline.py:100-111).
    """
    if orig_sr == target_sr:
        return audio
    g = gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    if audio.ndim == 1:
        return resample_poly(audio.astype(np.float64), up, down).astype(np.float32)
    cols = [
        resample_poly(audio[:, c].astype(np.float64), up, down).astype(np.float32)
        for c in range(audio.shape[1])
    ]
    n = min(len(c) for c in cols) if cols else 0
    if n == 0:
        return np.zeros(0, dtype=np.float32)
    return np.stack([c[:n] for c in cols], axis=1)


def snap_zero_crossing(audio: np.ndarray, idx: int, *, radius_samples: int) -> int:
    """Nearest zero crossing to *idx* within the radius (ties: earlier
    sample wins), matching the reference scan (tts_pipeline.py:114-137)."""
    if audio.size == 0:
        return idx
    idx = int(np.clip(int(idx), 0, audio.size - 1))
    lo = max(idx - radius_samples, 1)
    hi = min(idx + radius_samples, audio.size - 1)
    if hi < lo:
        return idx
    prev = audio[lo - 1 : hi]
    curr = audio[lo : hi + 1]
    crossing = (
        (prev == 0.0)
        | (curr == 0.0)
        | ((prev < 0.0) & (curr >= 0.0))
        | ((prev > 0.0) & (curr <= 0.0))
    )
    if not crossing.any():
        return idx
    positions = np.arange(lo, hi + 1)[crossing]
    dists = np.abs(positions - idx)
    return int(positions[np.argmin(dists)])


def fade_in(audio: np.ndarray, fade_frames: int) -> np.ndarray:
    """In-place linear fade-in over the first *fade_frames* samples."""
    if audio.size == 0:
        return audio
    fade_frames = max(0, min(int(fade_frames), len(audio)))
    if fade_frames:
        audio[:fade_frames] *= np.linspace(0.0, 1.0, fade_frames, dtype=np.float32)
    return audio


def fade_out(audio: np.ndarray, fade_frames: int) -> np.ndarray:
    """In-place linear fade-out over the last *fade_frames* samples."""
    if audio.size == 0:
        return audio
    fade_frames = max(0, min(int(fade_frames), len(audio)))
    if fade_frames:
        audio[-fade_frames:] *= np.linspace(1.0, 0.0, fade_frames, dtype=np.float32)
    return audio


def apply_inter_chunk_gap(
    audio_chunks: List[np.ndarray],
    *,
    sr: int,
    gap_ms: int,
    fade_ms: int = 10,
) -> np.ndarray:
    """Concatenate chunks with explicit silence gaps and 10 ms edge
    crossfades (ref: tts_pipeline.py:162-189)."""
    if not audio_chunks:
        return np.zeros(0, dtype=np.float32)
    if gap_ms <= 0 or len(audio_chunks) == 1:
        return np.concatenate(audio_chunks)
    gap_frames = max(0, int(sr * (int(gap_ms) / 1000.0)))
    fade_frames = max(0, int(sr * (int(fade_ms) / 1000.0)))
    pieces: List[np.ndarray] = []
    last = len(audio_chunks) - 1
    for i, chunk in enumerate(audio_chunks):
        a = np.asarray(chunk, dtype=np.float32)
        if fade_frames > 0 and (i < last or i > 0):
            a = a.copy()
            if i < last:
                fade_out(a, fade_frames)
            if i > 0:
                fade_in(a, fade_frames)
        pieces.append(a)
        if i < last and gap_frames > 0:
            pieces.append(np.zeros(gap_frames, dtype=np.float32))
    return np.concatenate(pieces) if pieces else np.zeros(0, dtype=np.float32)


def find_active_range(
    mono: np.ndarray,
    *,
    threshold: float,
    min_silence_frames: int,
) -> Tuple[int, int]:
    """[start, end) of the signal above *threshold*; edge silences
    shorter than *min_silence_frames* are kept (ref: tts_pipeline.py:192-209)."""
    if mono.size == 0:
        return 0, 0
    mask = np.abs(mono) > float(threshold)
    if not mask.any():
        return 0, len(mono)
    start = int(np.argmax(mask))
    end = len(mono) - int(np.argmax(mask[::-1]))
    if start < min_silence_frames:
        start = 0
    if len(mono) - end < min_silence_frames:
        end = len(mono)
    return start, end


def peak_normalize(audio: np.ndarray, target_dbfs: float) -> Tuple[np.ndarray, float, float]:
    """Scale so the peak hits *target_dbfs*. Returns (audio, gain, peak_before)."""
    peak_before = float(np.max(np.abs(audio))) if audio.size else 0.0
    target_peak = float(10 ** (float(target_dbfs) / 20.0))
    gain = 1.0
    if peak_before > 0.0 and target_peak > 0.0:
        gain = target_peak / peak_before
        audio = audio * gain
    return audio, gain, peak_before


def trim_audio_to_expected_duration(
    audio: np.ndarray,
    estimated_duration_s: float,
    sr: int,
    padding_ratio: float = 0.15,
) -> np.ndarray:
    """Cut repetition-padded synthesis back to the expected duration,
    landing the cut on a quiet zero crossing (ref: tts_pipeline.py:60-90)."""
    if audio.size == 0 or estimated_duration_s <= 0:
        return audio
    target = int(estimated_duration_s * sr * (1.0 + padding_ratio))
    if target >= len(audio):
        return audio
    search_lo = max(0, target - int(sr * 0.1))
    search_hi = min(len(audio), target + int(sr * 0.3))
    if search_hi > search_lo:
        window = np.abs(audio[search_lo:search_hi])
        quiet = search_lo + int(np.argmin(window))
        zero_cross = quiet
        limit = min(quiet + int(sr * 0.05), len(audio) - 1)
        seg_prev = audio[quiet:limit]
        seg_next = audio[quiet + 1 : limit + 1]
        hits = np.nonzero(
            ((seg_prev <= 0) & (seg_next > 0)) | ((seg_prev >= 0) & (seg_next < 0))
        )[0]
        if hits.size:
            zero_cross = quiet + int(hits[0]) + 1
        target = max(target, zero_cross)
    return audio[:target]


__all__ = [
    "resample",
    "snap_zero_crossing",
    "fade_in",
    "fade_out",
    "apply_inter_chunk_gap",
    "find_active_range",
    "peak_normalize",
    "trim_audio_to_expected_duration",
]
