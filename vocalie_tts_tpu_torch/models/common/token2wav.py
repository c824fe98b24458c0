"""Speech-token → waveform stage, flow + HiFT (counterpart of
``vocalie_tts_tpu/models/common/token2wav.py``).

All noise is explicit: a :class:`Stage2Noise` carries the CFM start noise
and HiFT's source noise, drawn by :func:`draw_stage2_noise` from a
``torch.Generator`` or handed in by a caller (the parity tests pass the
JAX package's draws).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from vocalie_tts_tpu_torch.models.common.cfm import (
    CFMDecoderConfig,
    cfm_generate,
    init_cfm_estimator,
)
from vocalie_tts_tpu_torch.models.common.conformer import (
    ConformerEncoderConfig,
    apply_conformer_encoder,
    init_conformer_encoder,
)
from vocalie_tts_tpu_torch.models.common.hift import HiFTConfig, apply_hift, init_hift
from vocalie_tts_tpu_torch.models.common.unet2d import dense, dense_init

Params = Dict[str, Any]

#: published CosyVoice2/S3Gen HiFT shape: 8·5·3 upsampling over an ISTFT
#: hop of 4 → mel hop 480 at 24 kHz
PUBLISHED_HIFT = HiFTConfig(
    upsample_rates=(8, 5, 3),
    upsample_kernels=(16, 11, 7),
    source_resblock_kernels=(7, 7, 11),
    source_resblock_dilations=((1, 3, 5),) * 3,
)


@dataclasses.dataclass(frozen=True)
class TokenToWavConfig:
    speech_vocab: int = 6561
    spk_dim: int = 192
    n_mels: int = 80
    encoder: ConformerEncoderConfig = ConformerEncoderConfig()
    decoder: CFMDecoderConfig = CFMDecoderConfig()
    hift: HiFTConfig = PUBLISHED_HIFT

    @property
    def token_mel_ratio(self) -> int:
        return self.encoder.upsample_stride

    @property
    def samples_per_token(self) -> int:
        return self.token_mel_ratio * self.hift.hop


def tiny_token2wav_config(speech_vocab: int) -> TokenToWavConfig:
    """Test-scale config (32 samples/token)."""
    return TokenToWavConfig(
        speech_vocab=speech_vocab,
        spk_dim=192,
        n_mels=8,
        encoder=ConformerEncoderConfig(
            input_size=16, output_size=16, attention_heads=2, linear_units=32,
            num_blocks=1, num_up_blocks=1,
        ),
        decoder=CFMDecoderConfig(
            in_channels=32, out_channels=8, channels=(16,), attention_head_dim=8,
            n_blocks=1, num_mid_blocks=1, num_heads=2, n_timesteps=2,
        ),
        hift=HiFTConfig(
            in_channels=8, base_channels=32, nb_harmonics=3,
            upsample_rates=(2, 2), upsample_kernels=(4, 4),
            f0_cond_channels=16, f0_layers=2,
        ),
    )


def t2w_scale_configs(speech_vocab: int) -> Dict[str, TokenToWavConfig]:
    return {
        "full": TokenToWavConfig(
            encoder=ConformerEncoderConfig(dtype=torch.bfloat16),
            decoder=CFMDecoderConfig(dtype=torch.bfloat16),
            hift=dataclasses.replace(PUBLISHED_HIFT, dtype=torch.bfloat16),
        ),
        "small": TokenToWavConfig(
            speech_vocab=speech_vocab,
            encoder=ConformerEncoderConfig(
                input_size=256, output_size=256, attention_heads=4,
                linear_units=1024, num_blocks=3, num_up_blocks=2,
            ),
            decoder=CFMDecoderConfig(
                in_channels=320, out_channels=80, channels=(128,), n_blocks=2,
                num_mid_blocks=6, num_heads=4,
            ),
            hift=dataclasses.replace(PUBLISHED_HIFT, base_channels=128),
        ),
        "tiny": tiny_token2wav_config(speech_vocab),
    }


def init_token2wav(cfg: TokenToWavConfig, *, generator=None, device="cpu") -> Params:
    kw = {"generator": generator, "device": device}
    return {
        "input_embedding": torch.randn((cfg.speech_vocab, cfg.encoder.input_size),
                                       generator=generator, device=device) * 0.02,
        "spk_embed_affine": dense_init(cfg.spk_dim, cfg.n_mels, **kw),
        "encoder": init_conformer_encoder(cfg.encoder, **kw),
        "encoder_proj": dense_init(cfg.encoder.output_size, cfg.n_mels, **kw),
        "estimator": init_cfm_estimator(cfg.decoder, **kw),
        "hift": init_hift(cfg.hift, **kw),
    }


@dataclasses.dataclass
class Stage2Noise:
    """Random inputs of stage 2. ``z`` is the CFM start noise (standard
    normal, [b, n_tok*ratio, n_mels]); ``rand_ini`` ([b, H+1], uniform)
    and ``source_normal`` ([b, n_tok*samples_per_token, H+1], standard
    normal) feed HiFT's NSF source — both None → deterministic source."""

    z: torch.Tensor
    rand_ini: Optional[torch.Tensor] = None
    source_normal: Optional[torch.Tensor] = None


def draw_stage2_noise(cfg: TokenToWavConfig, batch: int, n_tok: int,
                      generator: Optional[torch.Generator], device) -> Stage2Noise:
    frames = n_tok * cfg.token_mel_ratio
    h1 = cfg.hift.nb_harmonics + 1
    return Stage2Noise(
        z=torch.randn((batch, frames, cfg.n_mels), generator=generator, device=device),
        rand_ini=torch.rand((batch, h1), generator=generator, device=device),
        source_normal=torch.randn((batch, frames * cfg.hift.hop, h1),
                                  generator=generator, device=device),
    )


@torch.no_grad()
def token2mel(p: Params, cfg: TokenToWavConfig, tokens: torch.Tensor,
              token_mask: torch.Tensor, spk_emb: torch.Tensor, z: torch.Tensor):
    """Flow inference → (mel [b, n·ratio, n_mels], mel_mask [b, n·ratio, 1])."""
    norm = torch.linalg.vector_norm(spk_emb, dim=-1, keepdim=True)
    spk = dense(p["spk_embed_affine"], (spk_emb / torch.clamp(norm, min=1e-8)).float())
    tok = torch.clamp(tokens.long(), 0, cfg.speech_vocab - 1)
    h = p["input_embedding"][tok] * token_mask[..., None]
    h = apply_conformer_encoder(p["encoder"], cfg.encoder, h, token_mask[..., None])
    mu = dense(p["encoder_proj"], h)
    mel_mask = torch.repeat_interleave(token_mask[..., None], cfg.token_mel_ratio, dim=1)
    mel = cfm_generate(p["estimator"], cfg.decoder, mu, mel_mask, spks=spk,
                       cond=torch.zeros_like(mu), z=z)
    return mel, mel_mask


@torch.no_grad()
def mel2wav(p: Params, cfg: TokenToWavConfig, mel: torch.Tensor,
            rand_ini: Optional[torch.Tensor] = None,
            source_normal: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mel [b, frames, n_mels] → waveform; without the source noise HiFT's
    source is deterministic (the JAX ``mel2wav`` with ``rng=None``)."""
    return apply_hift(p["hift"], cfg.hift, mel, rand_ini, source_normal)


@torch.no_grad()
def token2wav(p: Params, cfg: TokenToWavConfig, tokens: torch.Tensor,
              token_mask: torch.Tensor, spk_emb: torch.Tensor, noise: Stage2Noise) -> torch.Tensor:
    """tokens → waveform [b, n · samples_per_token]."""
    mel, _ = token2mel(p, cfg, tokens, token_mask, spk_emb, noise.z)
    return mel2wav(p, cfg, mel, noise.rand_ini, noise.source_normal)


__all__ = [
    "TokenToWavConfig",
    "PUBLISHED_HIFT",
    "Stage2Noise",
    "draw_stage2_noise",
    "tiny_token2wav_config",
    "t2w_scale_configs",
    "init_token2wav",
    "token2mel",
    "mel2wav",
    "token2wav",
]
