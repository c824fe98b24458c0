"""Speaker (x-vector-class) encoder: reference audio → voice embedding
(counterpart of ``vocalie_tts_tpu/models/common/speaker.py``).

A stack of dilated convs over log-mels, mean/std statistics pooling in
f32, a 1x1 projection, L2 normalisation. The XTTS-class dev path embeds its
voice reference with it (``decoder["speaker"]``). Activations keep the JAX
layout ``[batch, frames, channels]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from vocalie_tts_tpu_torch.models.common.audio import log_mel_spectrogram
from vocalie_tts_tpu_torch.models.common.convnets import conv1d, conv1d_init, leaky_relu

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SpeakerEncoderConfig:
    n_mels: int = 80
    channels: int = 256
    n_layers: int = 4
    embed_dim: int = 256
    sr: int = 24000
    n_fft: int = 1024
    hop: int = 256
    dtype: torch.dtype = torch.float32


def init_speaker_encoder(cfg: SpeakerEncoderConfig, *, generator: Optional[torch.Generator] = None,
                         device="cpu") -> Params:
    kw = dict(generator=generator, device=device, dtype=cfg.dtype)
    layers, c_in = [], cfg.n_mels
    for _ in range(cfg.n_layers):
        layers.append({"conv": conv1d_init(3, c_in, cfg.channels, **kw)})
        c_in = cfg.channels
    # stats pooling doubles the channel dim (mean ‖ std)
    return {"layers": layers, "proj": conv1d_init(1, 2 * cfg.channels, cfg.embed_dim, **kw)}


def apply_speaker_encoder(params: Params, cfg: SpeakerEncoderConfig,
                          mel: torch.Tensor) -> torch.Tensor:
    """mel [batch, frames, n_mels] → embedding [batch, embed_dim], L2-normed."""
    x = mel.to(cfg.dtype)
    for i, layer in enumerate(params["layers"]):
        x = leaky_relu(conv1d(layer["conv"], x, dilation=2 ** i))
    xf = x.float()
    mean = xf.mean(1)
    std = torch.sqrt(torch.clamp(xf.var(1, correction=0), min=1e-6))
    stats = torch.cat([mean, std], -1)[:, None, :].to(x.dtype)
    emb = conv1d(params["proj"], stats)[:, 0, :]
    return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-6)


def embed_reference_audio(params: Params, cfg: SpeakerEncoderConfig,
                          audio: torch.Tensor) -> torch.Tensor:
    """audio [batch, T] (at cfg.sr) → embedding [batch, embed_dim]."""
    mel = log_mel_spectrogram(audio, sr=cfg.sr, n_fft=cfg.n_fft, hop=cfg.hop, n_mels=cfg.n_mels)
    return apply_speaker_encoder(params, cfg, mel)


__all__ = ["SpeakerEncoderConfig", "init_speaker_encoder", "apply_speaker_encoder",
           "embed_reference_audio"]
