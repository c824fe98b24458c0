"""Spectral audio utilities: STFT, mel filterbank, framing (counterpart of
the parts of ``vocalie_tts_tpu/models/common/audio.py`` that the AudioSR
front end uses).

float32 throughout. The filterbank is built in numpy (float64 break
points, float32 weights) exactly as the JAX package builds it, and is
cached per configuration.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, device="cpu") -> torch.Tensor:
    n = np.arange(win_length)
    return torch.as_tensor(0.5 - 0.5 * np.cos(2 * np.pi * n / win_length),
                           dtype=torch.float32, device=device)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int, *,
                 center: bool = True) -> torch.Tensor:
    """[..., T] → [..., frames, frame_length] with reflect pad when centered."""
    if center:
        pad = frame_length // 2
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
        x = x.reshape(*lead, x.shape[-1])
    return x.unfold(-1, frame_length, hop)


def stft(x: torch.Tensor, n_fft: int, hop: int, win_length: Optional[int] = None, *,
         center: bool = True) -> torch.Tensor:
    """[..., T] → [..., frames, n_fft//2+1] complex64."""
    win_length = win_length or n_fft
    frames = frame_signal(x, win_length, hop, center=center)
    frames = frames * hann_window(win_length, x.device)
    if win_length < n_fft:
        frames = F.pad(frames, (0, n_fft - win_length))
    return torch.fft.rfft(frames, n=n_fft, dim=-1)


def _hz_to_mel(f, scale: str = "htk"):
    if scale == "slaney":
        # librosa default (htk=False): linear below 1 kHz, log above
        f = np.asarray(f, np.float64)
        mel = f / (200.0 / 3.0)
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / (200.0 / 3.0)
        logstep = np.log(6.4) / 27.0
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                        mel)
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m, scale: str = "htk"):
    if scale == "slaney":
        m = np.asarray(m, np.float64)
        hz = m * (200.0 / 3.0)
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / (200.0 / 3.0)
        logstep = np.log(6.4) / 27.0
        return np.where(m >= min_log_mel,
                        min_log_hz * np.exp(logstep * (m - min_log_mel)), hz)
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@functools.lru_cache(maxsize=16)
def _mel_filterbank_np(
    sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: Optional[float] = None,
    normalize: bool = True, scale: str = "htk",
) -> np.ndarray:
    """Triangular mel filterbank [n_fft//2+1, n_mels], area-("slaney"-)
    normalized unless ``normalize`` is False."""
    fmax = fmax or sr / 2
    mel_pts = np.linspace(_hz_to_mel(fmin, scale), _hz_to_mel(fmax, scale), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, scale)
    bins = np.fft.rfftfreq(n_fft, d=1.0 / sr)
    fb = np.zeros((len(bins), n_mels), np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bins - lo) / max(ctr - lo, 1e-10)
        down = (hi - bins) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    if normalize:
        enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
        fb *= enorm[None, :]
    return fb


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None, *, scale: str = "htk",
                   device="cpu") -> torch.Tensor:
    return torch.from_numpy(_mel_filterbank_np(sr, n_fft, n_mels, fmin, fmax,
                                               scale=scale)).to(device)


def log_mel_spectrogram(
    x: torch.Tensor,
    *,
    sr: int,
    n_fft: int = 1024,
    hop: int = 256,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    eps: float = 1e-5,
    scale: str = "htk",
) -> torch.Tensor:
    """[..., T] → [..., frames, n_mels] natural-log mel spectrogram."""
    spec = torch.abs(stft(x, n_fft, hop))
    mel = torch.matmul(spec, mel_filterbank(sr, n_fft, n_mels, fmin, fmax, scale=scale,
                                            device=x.device))
    return torch.log(torch.clamp(mel, min=eps))


__all__ = ["hann_window", "frame_signal", "stft", "mel_filterbank", "log_mel_spectrogram"]
