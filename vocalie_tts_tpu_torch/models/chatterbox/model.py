"""Chatterbox-class model graph (counterpart of
``vocalie_tts_tpu/models/chatterbox/model.py``).

1. T3: a decoder-only transformer over the speech-token vocabulary with
   a separate text embedding; the prompt is [speaker slot, exaggeration
   slot, text..., BOS_speech]; CFG runs the unconditioned prompt (zeroed
   slots) in the same cache batch.
2. S3Gen: speech tokens → waveform through ``models/common/token2wav``.

The speaker encoders (the 256-dim T3 voice encoder and the 192-dim
x-vector) are not ported yet: the runtime uses zero embeddings, as the
JAX runtime does without a voice reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from vocalie_tts_tpu_torch.models.common.token2wav import (
    Stage2Noise,
    TokenToWavConfig,
    t2w_scale_configs,
    token2wav,
)
from vocalie_tts_tpu_torch.models.common.transformer import TransformerConfig, _normal, init_params
from vocalie_tts_tpu_torch.text.frontend import BYTE_VOCAB_SIZE

Params = Dict[str, Any]

SPEECH_VOCAB = 1024
#: S3 speech tokens run at 25 Hz (mel hop 480 at 24 kHz, ratio 2)
TOKENS_PER_SECOND = 25.0
#: S3Gen x-vector dims (the published spk_embed_affine input)
XVECTOR_DIM = 192


@dataclasses.dataclass(frozen=True)
class T3Config:
    d_model: int = 1024
    n_layers: int = 30
    n_heads: int = 16
    n_kv_heads: int = 16
    d_ff: int = 4096
    max_seq_len: int = 2048
    text_vocab: int = BYTE_VOCAB_SIZE
    speech_vocab: int = SPEECH_VOCAB
    speaker_dim: int = 256
    sample_rate: int = 24000
    t2w_scale: str = "full"
    kv_quant: bool = False
    decode_kernel: bool = False
    dense_kernel: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def bos_speech(self) -> int:
        return self.speech_vocab

    @property
    def eos_speech(self) -> int:
        return self.speech_vocab + 1

    @property
    def lm(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=self.speech_vocab + 2,
            d_model=self.d_model,
            n_layers=self.n_layers,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            d_head=self.d_model // self.n_heads,
            d_ff=self.d_ff,
            max_seq_len=self.max_seq_len,
            kv_quant=self.kv_quant,
            decode_kernel=self.decode_kernel,
            dense_kernel=self.dense_kernel,
            dtype=self.dtype,
        )

    @property
    def t2w(self) -> TokenToWavConfig:
        return t2w_scale_configs(self.speech_vocab)[self.t2w_scale]

    @property
    def samples_per_token(self) -> int:
        return self.t2w.samples_per_token


def init_t3(cfg: T3Config, *, generator=None, device="cpu") -> Params:
    """Stage-1 params (the part the FR fine-tune overlays)."""
    dt = cfg.dtype
    return {
        "lm": init_params(cfg.lm, generator=generator, device=device),
        "text_emb": _normal((cfg.text_vocab, cfg.d_model), 0.02, dt, generator, device),
        "spk_cond": _normal((cfg.speaker_dim, cfg.d_model), cfg.speaker_dim ** -0.5, dt,
                            generator, device),
        "exag_cond": _normal((1, cfg.d_model), 1.0, dt, generator, device),
    }


def init_token_decoder(cfg: T3Config, *, generator=None, device="cpu") -> Params:
    """Stage-2 params: the flow + HiFT bundle (the speaker nets of the
    JAX bundle are not ported yet)."""
    from vocalie_tts_tpu_torch.models.common.token2wav import init_token2wav

    return {"t2w": init_token2wav(cfg.t2w, generator=generator, device=device)}


def build_prompt_embeds(t3: Params, cfg: T3Config, text_tokens: torch.Tensor,
                        spk_emb: torch.Tensor, exaggeration: torch.Tensor) -> torch.Tensor:
    """[b, 2 + text_len + 1, d_model]: [spk slot, exag slot, text..., BOS_speech]."""
    lm = t3["lm"]
    text_emb = t3["text_emb"][text_tokens.long()]
    spk_slot = torch.matmul(spk_emb.to(text_emb.dtype), t3["spk_cond"])[:, None, :]
    exag_slot = torch.matmul(exaggeration[:, None].to(text_emb.dtype), t3["exag_cond"])[:, None, :]
    bos = lm["tok_emb"][torch.full((text_tokens.shape[0], 1), cfg.bos_speech,
                                   dtype=torch.long, device=text_tokens.device)]
    return torch.cat([spk_slot, exag_slot, text_emb, bos], dim=1)


def speech_logit_bias(cfg: T3Config, device="cpu") -> torch.Tensor:
    """Additive bias restricting sampling to speech tokens + EOS."""
    sv = cfg.speech_vocab
    bias = torch.full((sv + 2,), -1e30, dtype=torch.float32, device=device)
    bias[:sv] = 0.0
    bias[sv + 1] = 0.0
    return bias


def tokens_to_audio(dec: Params, cfg: T3Config, speech_tokens: torch.Tensor,
                    token_mask: torch.Tensor, noise: Stage2Noise,
                    xvec_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stage 2: speech tokens → waveform [b, n_tok · samples_per_token]."""
    if xvec_emb is None:
        xvec_emb = torch.zeros((speech_tokens.shape[0], XVECTOR_DIM), device=speech_tokens.device)
    return token2wav(dec["t2w"], cfg.t2w, speech_tokens, token_mask, xvec_emb, noise)


__all__ = [
    "T3Config",
    "SPEECH_VOCAB",
    "TOKENS_PER_SECOND",
    "XVECTOR_DIM",
    "init_t3",
    "init_token_decoder",
    "build_prompt_embeds",
    "speech_logit_bias",
    "tokens_to_audio",
]
