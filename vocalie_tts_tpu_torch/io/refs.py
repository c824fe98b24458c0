"""Voice-reference preparation (copy of ``normalize_ref_audio`` from
``vocalie_tts_tpu/io/refs.py``, on the port's WAV codec and resampler)."""

from __future__ import annotations

import os

import numpy as np

from vocalie_tts_tpu_torch.dsp.host import resample
from vocalie_tts_tpu_torch.io.wavio import read_wav


def normalize_ref_audio(
    path: os.PathLike | str,
    *,
    target_sr: int = 24000,
    target_dbfs: float = -20.0,
    peak_ceiling: float = 0.97,
):
    """Load a reference voice as a conditioning-ready array: mono downmix,
    resample to ``target_sr``, loudness-normalize to ``target_dbfs`` RMS
    with a hard peak ceiling. Returns ``(audio_f32_mono, target_sr)``."""
    audio, sr = read_wav(path)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    audio = np.asarray(audio, np.float32)
    if sr != target_sr:
        audio = resample(audio, sr, target_sr)
    rms = float(np.sqrt(np.mean(np.square(audio, dtype=np.float64)))) or 0.0
    if rms > 1e-8:
        gain = (10.0 ** (target_dbfs / 20.0)) / rms
        peak = float(np.max(np.abs(audio))) * gain
        if peak > peak_ceiling:
            gain *= peak_ceiling / peak
        audio = audio * np.float32(gain)
    return audio, target_sr


__all__ = ["normalize_ref_audio"]
