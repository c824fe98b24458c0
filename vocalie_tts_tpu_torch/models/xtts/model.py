"""XTTS-v2-class model graph (counterpart of
``vocalie_tts_tpu/models/xtts/model.py``, the dev path).

A GPT-2-style decoder over [32 conditioning latents from the speaker
embedding | byte text with text positions | the mel BOS] emitting VQ codes,
then stage 2: VQ embedding → transposed-conv upsampling → speaker
modulation → mel conv → HiFi-GAN at 24 kHz. The published graph
(conditioning encoder + perceiver, latent HiFi-GAN, H/ASP speaker ResNet)
is not ported; the runtime refuses a weights directory that holds it.
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

Params = Dict[str, Any]

# the checkpoint's mel-code space: 1024 VQ codes + start (1024) + stop (1025)
VQ_VOCAB = 1024
VQ_BASE = 0
BOS_VQ = 1024
EOS_VQ = 1025
VOCAB = 1026
#: the published text-BPE vocabulary size; the byte frontend uses its
#: first rows
TEXT_VOCAB = 6681

TOKENS_PER_SECOND = 24000 / 256 / 4
N_COND_LATENTS = 32                       # conditioning prefix length


@dataclasses.dataclass(frozen=True)
class XTTSConfig:
    d_model: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    n_kv_heads: int = 16
    d_ff: int = 4096
    max_seq_len: int = 2048
    text_vocab: int = TEXT_VOCAB
    text_pos_len: int = 404              # published text position table
    mel_pos_len: int = 608               # published mel position table
    speaker_dim: int = 512
    sample_rate: int = 24000
    n_mels: int = 80
    token_upsample: int = 4
    kv_quant: bool = False
    decode_kernel: bool = False
    dense_kernel: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def lm(self) -> TransformerConfig:
        """GPT-2: biased LayerNorm, GELU MLP, biases everywhere, learned
        positions indexed decode-relative (mel position = n_decoded + 1;
        the prompt carries its own text and mel-BOS positions)."""
        return TransformerConfig(
            vocab_size=VOCAB, d_model=self.d_model, n_layers=self.n_layers,
            n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            d_head=self.d_model // self.n_heads, d_ff=self.d_ff, max_seq_len=self.max_seq_len,
            kv_quant=self.kv_quant, decode_kernel=self.decode_kernel,
            dense_kernel=self.dense_kernel, norm_type="layer", mlp_type="gelu", bias=True,
            attn_bias=True, pos_type="learned", pos_index="decode_relative",
            pos_len=self.mel_pos_len, head_bias=True, dtype=self.dtype,
        )

    @property
    def vocoder(self) -> VocoderConfig:
        return VocoderConfig(n_mels=self.n_mels, base_channels=512, dtype=torch.float32)

    @property
    def speaker(self) -> SpeakerEncoderConfig:
        return SpeakerEncoderConfig(sr=self.sample_rate, embed_dim=self.speaker_dim)


def _normal(shape, scale, dtype, generator, device):
    return (torch.randn(shape, generator=generator, device=device) * scale).to(dtype)


def init_xtts(cfg: XTTSConfig, *, generator: Optional[torch.Generator] = None,
              device="cpu") -> Params:
    """The GPT bundle: the LM, the text embedding and position tables, and
    the speaker → conditioning-latents projection (JAX ``init_xtts``)."""
    g, dt = generator, cfg.dtype
    return {
        "lm": init_transformer(cfg.lm, generator=g, device=device),
        "text_emb": _normal((cfg.text_vocab, cfg.d_model), 0.02, dt, g, device),
        "text_pos": _normal((cfg.text_pos_len, cfg.d_model), 0.01, dt, g, device),
        "cond_proj": _normal((cfg.speaker_dim, N_COND_LATENTS * cfg.d_model),
                             1.0 / math.sqrt(cfg.speaker_dim), dt, g, device),
        "cond_bias": _normal((N_COND_LATENTS, cfg.d_model), 0.02, dt, g, device),
    }


def init_vq_decoder(cfg: XTTSConfig, *, generator: Optional[torch.Generator] = None,
                    device="cpu") -> Params:
    """Stage 2 and the speaker encoder (JAX ``init_vq_decoder``), in f32."""
    ch = 512
    kw = dict(generator=generator, device=device)
    return {
        "tok_emb": _normal((VQ_VOCAB + 2, ch), 0.02, torch.float32, generator, device),
        "up": conv1d_init(8, ch, ch, **kw),
        "spk_mod": _normal((cfg.speaker_dim, ch), 1.0 / math.sqrt(cfg.speaker_dim),
                           torch.float32, generator, device),
        "mel_out": conv1d_init(5, ch, cfg.n_mels, **kw),
        "vocoder": init_vocoder(cfg.vocoder, **kw),
        "speaker": init_speaker_encoder(cfg.speaker, **kw),
    }


def build_prompt_embeds(params: Params, cfg: XTTSConfig, text_tokens: torch.Tensor,
                        spk_emb: torch.Tensor) -> torch.Tensor:
    """[cond latents × 32, text + text_pos ..., mel BOS + mel_pos 0]: the
    prompt carries its own positions (the core adds mel positions
    n_decoded + 1 per step)."""
    lm = params["lm"]
    b, L = text_tokens.shape
    dev = text_tokens.device
    text = params["text_emb"][text_tokens.long()]
    text = text + params["text_pos"][torch.arange(L, device=dev) % cfg.text_pos_len][None].to(
        text.dtype)
    cond = torch.matmul(spk_emb.to(text.dtype), params["cond_proj"])
    cond = cond.reshape(b, N_COND_LATENTS, cfg.d_model) + params["cond_bias"][None]
    bos = (lm["tok_emb"][torch.full((b, 1), BOS_VQ, device=dev)]
           + lm["pos_emb"][0][None, None].to(text.dtype))
    return torch.cat([cond, text, bos], 1)


def vq_logit_bias(device="cpu") -> torch.Tensor:
    """0 on the VQ codes and EOS, -1e30 elsewhere (BOS)."""
    bias = torch.full((VOCAB,), -1e30, device=device)
    bias[VQ_BASE: VQ_BASE + VQ_VOCAB] = 0.0
    bias[EOS_VQ] = 0.0
    return bias


def tokens_to_audio(dec: Params, cfg: XTTSConfig, vq_tokens: torch.Tensor,
                    token_mask: torch.Tensor, spk_emb: torch.Tensor) -> torch.Tensor:
    """VQ codes [b, n] → audio [b, n · token_upsample · hop]."""
    x = dec["tok_emb"][vq_tokens.long()] * token_mask[..., None]
    x = leaky_relu(conv1d_transpose(dec["up"], x, stride=cfg.token_upsample))
    x = x * (1.0 + torch.matmul(spk_emb, dec["spk_mod"]))[:, None, :]
    mel = conv1d(dec["mel_out"], x)
    return apply_vocoder(dec["vocoder"], cfg.vocoder, mel)


__all__ = ["XTTSConfig", "VQ_VOCAB", "VQ_BASE", "BOS_VQ", "EOS_VQ", "VOCAB", "TEXT_VOCAB",
           "N_COND_LATENTS", "TOKENS_PER_SECOND", "init_xtts", "init_vq_decoder",
           "build_prompt_embeds", "vq_logit_bias", "tokens_to_audio"]
