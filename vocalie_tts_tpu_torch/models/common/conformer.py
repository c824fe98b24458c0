"""Upsampling conformer token encoder, CosyVoice2/S3Gen flow front-end
(counterpart of ``vocalie_tts_tpu/models/common/conformer.py``).

Linear embed + LayerNorm, a pre-lookahead conv pair, N rel-pos conformer
blocks, a nearest x2 upsample + causal conv, M more blocks, final
LayerNorm. Activations are ``[b, t, c]``; the param tree is the JAX one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from vocalie_tts_tpu_torch.models.common.convnets import conv1d, conv1d_init, layer_norm
from vocalie_tts_tpu_torch.models.common.unet2d import dense, dense_init

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ConformerEncoderConfig:
    input_size: int = 512
    output_size: int = 512
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    num_up_blocks: int = 4
    upsample_stride: int = 2
    pre_lookahead_len: int = 3
    #: compute dtype (norms/softmax stay f32); full scale runs bf16
    dtype: torch.dtype = torch.float32

    @property
    def d_head(self) -> int:
        return self.output_size // self.attention_heads


def _embed_init(d_in, d_out, **kw):
    return {
        "linear": dense_init(d_in, d_out, **kw),
        "norm_g": torch.ones((d_out,), device=kw["device"]),
        "norm_b": torch.zeros((d_out,), device=kw["device"]),
    }


def _layer_init(cfg: ConformerEncoderConfig, **kw):
    d, h, dk = cfg.output_size, cfg.attention_heads, cfg.d_head
    dev = kw["device"]
    return {
        "linear_q": dense_init(d, d, **kw),
        "linear_k": dense_init(d, d, **kw),
        "linear_v": dense_init(d, d, **kw),
        "linear_out": dense_init(d, d, **kw),
        "linear_pos": dense_init(d, d, **kw)["w"],  # bias=False
        "pos_bias_u": torch.zeros((h, dk), device=dev),
        "pos_bias_v": torch.zeros((h, dk), device=dev),
        "norm_mha_g": torch.ones((d,), device=dev),
        "norm_mha_b": torch.zeros((d,), device=dev),
        "ff_w1": dense_init(d, cfg.linear_units, **kw),
        "ff_w2": dense_init(cfg.linear_units, d, **kw),
        "norm_ff_g": torch.ones((d,), device=dev),
        "norm_ff_b": torch.zeros((d,), device=dev),
    }


def init_conformer_encoder(cfg: ConformerEncoderConfig, *, generator=None, device="cpu") -> Params:
    kw = {"generator": generator, "device": device}
    d = cfg.output_size
    return {
        "embed": _embed_init(cfg.input_size, d, **kw),
        "pre_lookahead": {
            "conv1": conv1d_init(cfg.pre_lookahead_len + 1, d, d, **kw),
            "conv2": conv1d_init(3, d, d, **kw),
        },
        "encoders": [_layer_init(cfg, **kw) for _ in range(cfg.num_blocks)],
        "up_layer": conv1d_init(cfg.upsample_stride * 2 + 1, d, d, **kw),
        "up_embed": _embed_init(cfg.input_size, d, **kw),
        "up_encoders": [_layer_init(cfg, **kw) for _ in range(cfg.num_up_blocks)],
        "after_norm_g": torch.ones((d,), device=device),
        "after_norm_b": torch.zeros((d,), device=device),
    }


def _rel_pos_table(t: int, d: int, device) -> torch.Tensor:
    """Espnet relative positional encoding: [2t-1, d], index k ↦
    position t-1-k (positive = query after key)."""
    pos = torch.arange(t - 1, -t, -1, dtype=torch.float32, device=device)
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    ang = pos[:, None] * div[None, :]
    pe = torch.zeros((2 * t - 1, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def _rel_attention(p: Params, cfg: ConformerEncoderConfig, x: torch.Tensor,
                   pos_p: torch.Tensor, attn_bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Transformer-XL rel-pos attention (espnet RelPositionMultiHeadedAttention)."""
    b, t, d = x.shape
    h, dk = cfg.attention_heads, cfg.d_head
    q = dense(p["linear_q"], x).reshape(b, t, h, dk)
    k = dense(p["linear_k"], x).reshape(b, t, h, dk)
    v = dense(p["linear_v"], x).reshape(b, t, h, dk)
    ac = torch.einsum("bihd,bjhd->bhij", q + p["pos_bias_u"].to(q.dtype), k)
    bd_full = torch.einsum("bihd,khd->bhik", q + p["pos_bias_v"].to(q.dtype), pos_p.to(q.dtype))
    # bd[i, j] = bd_full[i, t-1 + j - i]  (relative distance i-j)
    ar = torch.arange(t, device=x.device)
    idx = (t - 1) + ar[None, :] - ar[:, None]
    bd = torch.gather(bd_full, -1, idx[None, None].expand(b, h, t, t))
    logits = (ac + bd).float() / math.sqrt(dk)
    if attn_bias is not None:
        logits = logits + attn_bias
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bhij,bjhd->bihd", probs, v).reshape(b, t, d)
    return dense(p["linear_out"], o)


def _conformer_layer(p, cfg, x, pos_p, attn_bias):
    """Pre-norm block: rel-pos MHA, then ReLU FFN."""
    h = layer_norm(x, p["norm_mha_g"], p["norm_mha_b"])
    x = x + _rel_attention(p, cfg, h, pos_p, attn_bias)
    h = layer_norm(x, p["norm_ff_g"], p["norm_ff_b"])
    return x + dense(p["ff_w2"], F.relu(dense(p["ff_w1"], h)))


def apply_conformer_encoder(
    p: Params,
    cfg: ConformerEncoderConfig,
    x: torch.Tensor,                      # [b, t, input_size]
    mask: Optional[torch.Tensor] = None,  # [b, t, 1] validity
) -> torch.Tensor:
    """Token features → [b, t*stride, output_size]."""
    xscale = math.sqrt(cfg.output_size)
    x = x.to(cfg.dtype)

    def embed(ep, h):
        h = dense(ep["linear"], h)
        return layer_norm(h, ep["norm_g"], ep["norm_b"]) * xscale

    def attn_bias_of(m):
        if m is None:
            return None
        keep = m[:, None, None, :, 0] > 0
        return torch.where(keep, 0.0, -1e9).to(torch.float32)

    x = embed(p["embed"], x)
    pl = p["pre_lookahead"]
    h = conv1d(pl["conv1"], x, padding=(0, cfg.pre_lookahead_len))
    h = torch.where(h >= 0, h, 0.01 * h)
    h = conv1d(pl["conv2"], h, padding=(2, 0))
    x = x + h

    bias = attn_bias_of(mask)
    pe = _rel_pos_table(x.shape[1], cfg.output_size, x.device)
    for layer in p["encoders"]:
        pos_p = torch.matmul(pe, layer["linear_pos"]).reshape(-1, cfg.attention_heads, cfg.d_head)
        x = _conformer_layer(layer, cfg, x, pos_p, bias)

    s = cfg.upsample_stride
    x = torch.repeat_interleave(x, s, dim=1)
    x = conv1d(p["up_layer"], x, padding=(2 * s, 0))
    up_mask = None if mask is None else torch.repeat_interleave(mask, s, dim=1)

    x = embed(p["up_embed"], x)
    bias = attn_bias_of(up_mask)
    pe = _rel_pos_table(x.shape[1], cfg.output_size, x.device)
    for layer in p["up_encoders"]:
        pos_p = torch.matmul(pe, layer["linear_pos"]).reshape(-1, cfg.attention_heads, cfg.d_head)
        x = _conformer_layer(layer, cfg, x, pos_p, bias)

    x = layer_norm(x, p["after_norm_g"], p["after_norm_b"])
    if up_mask is not None:
        x = x * up_mask
    return x


__all__ = ["ConformerEncoderConfig", "init_conformer_encoder", "apply_conformer_encoder"]
