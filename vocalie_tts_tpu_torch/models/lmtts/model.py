"""Qwen3-TTS-class model graph (counterpart of
``vocalie_tts_tpu/models/lmtts/model.py``).

One decoder-only LM over the codec-token vocabulary (Qwen3 backbone: GQA,
per-head q/k RMSNorm, eps 1e-6) with a separate text embedding table and
three conditioning slots: the speaker (a named speaker's table row or a
reference's x-vector) and the language, each projected to d_model, then the
text, then the audio BOS. It emits 12.5 Hz codec tokens; a codec decoder
upsamples them x8 to a 100 fps mel and a HiFi-GAN (hop 240) renders 24 kHz
audio.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from vocalie_tts_tpu_torch.models.common.convnets import (
    conv1d,
    conv1d_init,
    conv1d_transpose,
    leaky_relu,
)
from vocalie_tts_tpu_torch.models.common.speaker import SpeakerEncoderConfig, init_speaker_encoder
from vocalie_tts_tpu_torch.models.common.transformer import TransformerConfig
from vocalie_tts_tpu_torch.models.common.transformer import init_params as init_transformer
from vocalie_tts_tpu_torch.models.common.vocoder import VocoderConfig, apply_vocoder, init_vocoder
from vocalie_tts_tpu_torch.text.frontend import BYTE_VOCAB_SIZE

Params = Dict[str, Any]

#: the LM core's vocabulary: 2048 codec tokens, the audio BOS and EOS
CODEC_VOCAB = 2048
BOS_AUDIO = CODEC_VOCAB
EOS_AUDIO = BOS_AUDIO + 1
VOCAB = EOS_AUDIO + 1

TOKENS_PER_SECOND = 12.5
SPEAKERS = (
    "Vivian", "Serena", "Uncle_Fu", "Dylan", "Eric", "Ryan",
    "Aiden", "Ono_Anna", "Sohee",
)
LANGS = (
    "Auto", "Chinese", "English", "Japanese", "Korean", "German",
    "French", "Russian", "Portuguese", "Spanish", "Italian",
)


@dataclasses.dataclass(frozen=True)
class LMTTSConfig:
    d_model: int = 2048
    n_layers: int = 28
    n_heads: int = 16
    n_kv_heads: int = 8
    d_ff: int = 8192
    max_seq_len: int = 2048
    #: text embedding rows (the byte frontend's)
    text_vocab: int = BYTE_VOCAB_SIZE
    codec_vocab: int = CODEC_VOCAB
    speaker_dim: int = 256
    sample_rate: int = 24000
    n_mels: int = 80
    token_upsample: int = 8        # 12.5 Hz → 100 fps mel
    kv_quant: bool = False
    decode_kernel: bool = False
    dense_kernel: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def bos_audio(self) -> int:
        return self.codec_vocab

    @property
    def eos_audio(self) -> int:
        return self.codec_vocab + 1

    @property
    def lm(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=self.codec_vocab + 2, d_model=self.d_model, n_layers=self.n_layers,
            n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            d_head=self.d_model // self.n_heads, d_ff=self.d_ff, max_seq_len=self.max_seq_len,
            kv_quant=self.kv_quant, decode_kernel=self.decode_kernel,
            dense_kernel=self.dense_kernel, qk_norm=True, norm_eps=1e-6, dtype=self.dtype,
        )

    @property
    def vocoder(self) -> VocoderConfig:
        # hop 240 @ 24 kHz → 100 fps mel
        return VocoderConfig(n_mels=self.n_mels, base_channels=512, upsample_rates=(8, 6, 5),
                             upsample_kernels=(16, 12, 10), dtype=torch.float32)

    @property
    def speaker(self) -> SpeakerEncoderConfig:
        return SpeakerEncoderConfig(sr=self.sample_rate, embed_dim=self.speaker_dim)


def _normal(shape, scale, dtype, generator, device):
    return (torch.randn(shape, generator=generator, device=device) * scale).to(dtype)


def init_lmtts(cfg: LMTTSConfig, *, generator: Optional[torch.Generator] = None,
               device="cpu") -> Params:
    """The LM bundle (JAX ``init_lmtts``): the LM, the text embedding, the
    named speakers' table and the speaker / language projections."""
    g, dt = generator, cfg.dtype
    return {
        "lm": init_transformer(cfg.lm, generator=g, device=device),
        "text_emb": _normal((cfg.text_vocab, cfg.d_model), 0.02, dt, g, device),
        "speaker_table": _normal((len(SPEAKERS), cfg.speaker_dim), 0.02, dt, g, device),
        "spk_cond": _normal((cfg.speaker_dim, cfg.d_model), 1.0 / math.sqrt(cfg.speaker_dim),
                            dt, g, device),
        "lang_cond": _normal((16, cfg.d_model), 1.0 / math.sqrt(16), dt, g, device),
    }


def init_codec_decoder(cfg: LMTTSConfig, *, generator: Optional[torch.Generator] = None,
                       device="cpu") -> Params:
    """Stage 2 and the speaker encoder (JAX ``init_codec_decoder``), f32."""
    ch = 512
    kw = dict(generator=generator, device=device)
    return {
        "tok_emb": _normal((cfg.codec_vocab + 2, ch), 0.02, torch.float32, generator, device),
        "up1": conv1d_init(8, ch, ch, **kw),   # x4
        "up2": conv1d_init(4, ch, ch, **kw),   # x2
        "mel_out": conv1d_init(5, ch, cfg.n_mels, **kw),
        "vocoder": init_vocoder(cfg.vocoder, **kw),
        "speaker": init_speaker_encoder(cfg.speaker, **kw),
    }


def lang_one_hot(language: str, device="cpu") -> torch.Tensor:
    """[16] f32: the language's index in ``LANGS`` (unknown → Auto)."""
    out = torch.zeros((16,), device=device)
    out[LANGS.index(language) if language in LANGS else 0] = 1.0
    return out


def build_prompt_embeds(params: Params, cfg: LMTTSConfig, text_tokens: torch.Tensor,
                        spk_emb: torch.Tensor, lang_vec: torch.Tensor) -> torch.Tensor:
    """[speaker slot, language slot, text ..., audio BOS] embeddings for
    ``text_tokens`` [b, L] (byte ids), ``spk_emb`` [b, speaker_dim] and
    ``lang_vec`` [b, 16]."""
    text = params["text_emb"][text_tokens.long()]
    spk = torch.matmul(spk_emb.to(text.dtype), params["spk_cond"])[:, None, :]
    lang = torch.matmul(lang_vec.to(text.dtype), params["lang_cond"])[:, None, :]
    bos = params["lm"]["tok_emb"][torch.full((text_tokens.shape[0], 1), cfg.bos_audio,
                                             device=text_tokens.device)]
    return torch.cat([spk, lang, text, bos], 1)


def codec_logit_bias(cfg: Optional[LMTTSConfig] = None, device="cpu") -> torch.Tensor:
    """0 on the codec tokens and EOS, -1e30 on BOS."""
    cv = cfg.codec_vocab if cfg is not None else CODEC_VOCAB
    bias = torch.full((cv + 2,), -1e30, device=device)
    bias[:cv] = 0.0
    bias[cv + 1] = 0.0
    return bias


def tokens_to_mel(dec: Params, cfg: LMTTSConfig, codec_tokens: torch.Tensor,
                  token_mask: torch.Tensor) -> torch.Tensor:
    """Codec decoder: 12.5 Hz tokens [b, n] → 100 fps mel [b, 8n, n_mels]."""
    x = dec["tok_emb"][codec_tokens.long()] * token_mask[..., None]
    x = leaky_relu(conv1d_transpose(dec["up1"], x, stride=4))
    x = leaky_relu(conv1d_transpose(dec["up2"], x, stride=2))
    return conv1d(dec["mel_out"], x)


def tokens_to_audio(dec: Params, cfg: LMTTSConfig, codec_tokens: torch.Tensor,
                    token_mask: torch.Tensor) -> torch.Tensor:
    """Codec tokens [b, n] → audio [b, n · 8 · 240]."""
    return apply_vocoder(dec["vocoder"], cfg.vocoder,
                         tokens_to_mel(dec, cfg, codec_tokens, token_mask))


__all__ = ["LMTTSConfig", "CODEC_VOCAB", "BOS_AUDIO", "EOS_AUDIO", "VOCAB", "TOKENS_PER_SECOND",
           "SPEAKERS", "LANGS", "init_lmtts", "init_codec_decoder", "lang_one_hot",
           "build_prompt_embeds", "codec_logit_bias", "tokens_to_mel", "tokens_to_audio"]
