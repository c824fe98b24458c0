"""CosyVoice-class model graph (counterpart of
``vocalie_tts_tpu/models/cosyvoice/model.py``).

1. The LM: a decoder-only transformer over the speech-token vocabulary
   (Qwen2 backbone: q/k/v biases) with a separate text embedding; the
   prompt is [speaker slot, prompt tokens..., BOS_speech], prompt ids mixing
   text ids and speech ids at ``+text_vocab``.
2. Token → wav through ``models/common/token2wav``: conformer encoder →
   CFM (start noise handed in) → HiFT with a deterministic source (the
   JAX runtime passes no rng to ``mel2wav``).

The speaker encoder of the JAX bundle (``decoder["speaker"]``) is not
ported yet: without a voice reference the JAX runtime uses zero speaker
embeddings, as this port does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from vocalie_tts_tpu_torch.models.common.ar_runtime import embed_mixed_prompt
from vocalie_tts_tpu_torch.models.common.token2wav import (
    TokenToWavConfig,
    init_token2wav,
    mel2wav,
    t2w_scale_configs,
    token2mel,
)
from vocalie_tts_tpu_torch.models.common.transformer import TransformerConfig, _normal, init_params
from vocalie_tts_tpu_torch.text.frontend import BYTE_VOCAB_SIZE

Params = Dict[str, Any]

SPEECH_VOCAB = 4096
BOS_SPEECH = SPEECH_VOCAB                      # 4096
EOS_SPEECH = BOS_SPEECH + 1                    # 4097
VOCAB = EOS_SPEECH + 1                         # 4098

#: published CosyVoice2 token rate: 24000 / (mel hop 480) / (ratio 2)
TOKENS_PER_SECOND = 25.0


@dataclasses.dataclass(frozen=True)
class CosyVoiceConfig:
    d_model: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    n_kv_heads: int = 16
    d_ff: int = 4096
    max_seq_len: int = 2048
    text_vocab: int = BYTE_VOCAB_SIZE
    speech_vocab: int = SPEECH_VOCAB
    speaker_dim: int = 192
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
            attn_bias=True,   # the Qwen2 backbone's q/k/v biases
            dtype=self.dtype,
        )

    @property
    def t2w(self) -> TokenToWavConfig:
        return t2w_scale_configs(self.speech_vocab)[self.t2w_scale]

    @property
    def samples_per_token(self) -> int:
        return self.t2w.samples_per_token


def init_cosyvoice_lm(cfg: CosyVoiceConfig, *, generator=None, device="cpu") -> Params:
    """The LM bundle: the transformer, the text embedding, the speaker slot
    projection (the JAX ``init_cosyvoice_lm`` tree and scales)."""
    return {
        "lm": init_params(cfg.lm, generator=generator, device=device),
        "text_emb": _normal((cfg.text_vocab, cfg.d_model), 0.02, cfg.dtype, generator, device),
        "spk_cond": _normal((cfg.speaker_dim, cfg.d_model), cfg.speaker_dim ** -0.5, cfg.dtype,
                            generator, device),
    }


def init_cfm_decoder(cfg: CosyVoiceConfig, *, generator=None, device="cpu") -> Params:
    """Stage-2 params: the flow + HiFT bundle (the speaker encoder of the
    JAX bundle is not ported yet)."""
    return {"t2w": init_token2wav(cfg.t2w, generator=generator, device=device)}


def speech_logit_bias(cfg: CosyVoiceConfig, device="cpu") -> torch.Tensor:
    """Restrict sampling to speech tokens + EOS (mask BOS)."""
    sv = cfg.speech_vocab
    bias = torch.full((sv + 2,), -1e30, dtype=torch.float32, device=device)
    bias[:sv] = 0.0
    bias[sv + 1] = 0.0
    return bias


def build_prompt_embeds(params: Params, cfg: CosyVoiceConfig, text_tokens: torch.Tensor,
                        spk_emb: torch.Tensor) -> torch.Tensor:
    """[b, 1 + prompt_len + 1, d_model]: [spk slot, prompt tokens..., BOS_speech]."""
    lm = params["lm"]
    text_emb = embed_mixed_prompt(params["text_emb"], lm["tok_emb"], text_tokens, cfg.text_vocab)
    spk_slot = torch.matmul(spk_emb.to(text_emb.dtype), params["spk_cond"])[:, None, :]
    bos = lm["tok_emb"][torch.full((text_tokens.shape[0], 1), cfg.bos_speech, dtype=torch.long,
                                   device=text_tokens.device)].to(text_emb.dtype)
    return torch.cat([spk_slot, text_emb, bos], dim=1)


def tokens_to_mel(dec: Params, cfg: CosyVoiceConfig, speech_tokens: torch.Tensor,
                  token_mask: torch.Tensor, spk_emb: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """Flow inference: tokens → mel [b, n·ratio, n_mels]; ``z`` is the CFM
    start noise [b, n·ratio, n_mels]."""
    mel, _ = token2mel(dec["t2w"], cfg.t2w, speech_tokens, token_mask, spk_emb, z)
    return mel


def mel_to_audio(dec: Params, cfg: CosyVoiceConfig, mel: torch.Tensor) -> torch.Tensor:
    return mel2wav(dec["t2w"], cfg.t2w, mel)


__all__ = [
    "CosyVoiceConfig",
    "SPEECH_VOCAB",
    "BOS_SPEECH",
    "EOS_SPEECH",
    "VOCAB",
    "TOKENS_PER_SECOND",
    "init_cosyvoice_lm",
    "init_cfm_decoder",
    "speech_logit_bias",
    "build_prompt_embeds",
    "tokens_to_mel",
    "mel_to_audio",
]
