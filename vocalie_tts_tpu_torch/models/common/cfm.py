"""Conditional flow-matching mel decoder, causal CosyVoice2/3 variant
(counterpart of ``vocalie_tts_tpu/models/common/cfm.py``).

A 1-D U-Net estimator (causal conv + LayerNorm + Mish resnet blocks and
diffusers-style transformer blocks) driven by an Euler ODE from noise,
with classifier-free guidance as one doubled batch per step.

The transformer blocks' self-attention runs the flash-attention kernel
(B6), non-causal with per-row ``kv_lens``, when the mel length is >= 256
(the JAX package's size split) and ``VOCALIE_CFM_FLASH`` is unset or
``1``; the plain softmax with a -1e9 key bias runs below that length or
with the knob set to anything else, as in JAX ``cfm.py:215-216``.

The ODE start noise ``z`` is an explicit input (or drawn from an explicit
``torch.Generator``), so tests can feed both frameworks the same noise.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from vocalie_tts_tpu_torch.models.common.convnets import (
    conv1d,
    conv1d_init,
    conv1d_transpose,
    layer_norm,
)
from vocalie_tts_tpu_torch.models.common.unet2d import dense, dense_init
from vocalie_tts_tpu_torch.ops.flash_attention import flash_attention

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CFMDecoderConfig:
    in_channels: int = 320          # [x ‖ mu ‖ spk ‖ cond] · out_channels
    out_channels: int = 80
    channels: Tuple[int, ...] = (256,)
    attention_head_dim: int = 64
    n_blocks: int = 4               # transformer blocks per level
    num_mid_blocks: int = 12
    num_heads: int = 8
    causal: bool = True             # CosyVoice2/3 causal variant
    n_timesteps: int = 10
    cfg_rate: float = 0.7
    t_scheduler: str = "cosine"
    sigma_min: float = 1e-6
    #: compute dtype for the U-Net body (norms/softmax stay f32)
    dtype: torch.dtype = torch.float32

    @property
    def time_embed_dim(self) -> int:
        return self.channels[0] * 4


def _conv(p: Params, x: torch.Tensor, *, stride: int = 1, causal: bool = False) -> torch.Tensor:
    k = p["w"].shape[0]
    if causal:
        pad = (k - 1, 0)
    elif stride == 1:
        pad = ((k - 1) // 2, k // 2)
    else:  # torch Conv1d(k=3, stride=2, padding=1)
        pad = (1, 1)
    return conv1d(p, x, stride=stride, padding=pad)


def _mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


def sinusoidal_pos_emb(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """Matcha SinusoidalPosEmb: [b] → [b, dim], t pre-scaled by 1000."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    ang = scale * t[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ── blocks ──────────────────────────────────────────────────────────────


def _block1d(p: Params, cfg: CFMDecoderConfig, x, mask):
    h = _conv(p["conv"], x * mask, causal=cfg.causal)
    return _mish(layer_norm(h, p["norm_g"], p["norm_b"])) * mask


def _resnet1d(p: Params, cfg: CFMDecoderConfig, x, mask, temb):
    h = _block1d(p["block1"], cfg, x, mask)
    h = h + dense(p["mlp"], _mish(temb))[:, None, :]
    h = _block1d(p["block2"], cfg, h, mask)
    return h + _conv(p["res_conv"], x * mask)


def _xf_block(p: Params, cfg: CFMDecoderConfig, x: torch.Tensor,
              attn_bias: torch.Tensor, kv_lens: torch.Tensor) -> torch.Tensor:
    """diffusers BasicTransformerBlock (self-attn only, exact-GELU FF)."""
    b, t, _ = x.shape
    nh, hd = cfg.num_heads, cfg.attention_head_dim
    h = layer_norm(x, p["norm1_g"], p["norm1_b"])
    sm = 1.0 / math.sqrt(hd)

    def heads(w):
        return torch.matmul(h, w.to(h.dtype)).reshape(b, t, nh, hd).transpose(1, 2).contiguous()

    q, k, v = heads(p["to_q"]), heads(p["to_k"]), heads(p["to_v"])
    if t >= 256 and os.environ.get("VOCALIE_CFM_FLASH", "1") == "1":
        o4 = flash_attention(q, k, v, causal=False, sm_scale=sm, kv_lens=kv_lens)
        o = o4.to(x.dtype).transpose(1, 2).reshape(b, t, nh * hd)
    else:
        logits = torch.matmul(q, k.transpose(-1, -2)).float() * sm + attn_bias
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        o = torch.matmul(probs, v).transpose(1, 2).reshape(b, t, nh * hd)
    x = x + dense(p["to_out"], o)
    h = layer_norm(x, p["norm3_g"], p["norm3_b"])
    h = dense(p["ff_out"], F.gelu(dense(p["ff_in"], h), approximate="none"))
    return x + h


# ── init ────────────────────────────────────────────────────────────────


def _block1d_init(c_in, c_out, **kw):
    dev = kw["device"]
    return {"conv": conv1d_init(3, c_in, c_out, **kw),
            "norm_g": torch.ones((c_out,), device=dev),
            "norm_b": torch.zeros((c_out,), device=dev)}


def _resnet1d_init(c_in, c_out, emb_dim, **kw):
    return {
        "mlp": dense_init(emb_dim, c_out, **kw),
        "block1": _block1d_init(c_in, c_out, **kw),
        "block2": _block1d_init(c_out, c_out, **kw),
        "res_conv": conv1d_init(1, c_in, c_out, **kw),
    }


def _xf_block_init(dim, n_heads, d_head, **kw):
    inner = n_heads * d_head
    dev = kw["device"]
    return {
        "norm1_g": torch.ones((dim,), device=dev),
        "norm1_b": torch.zeros((dim,), device=dev),
        "to_q": dense_init(dim, inner, **kw)["w"],
        "to_k": dense_init(dim, inner, **kw)["w"],
        "to_v": dense_init(dim, inner, **kw)["w"],
        "to_out": dense_init(inner, dim, **kw),
        "norm3_g": torch.ones((dim,), device=dev),
        "norm3_b": torch.zeros((dim,), device=dev),
        "ff_in": dense_init(dim, dim * 4, **kw),
        "ff_out": dense_init(dim * 4, dim, **kw),
    }


def init_cfm_estimator(cfg: CFMDecoderConfig, *, generator=None, device="cpu") -> Params:
    kw = {"generator": generator, "device": device}
    emb = cfg.time_embed_dim

    def level(c_in, c_out):
        return {
            "resnet": _resnet1d_init(c_in, c_out, emb, **kw),
            "transformer": [_xf_block_init(c_out, cfg.num_heads, cfg.attention_head_dim, **kw)
                            for _ in range(cfg.n_blocks)],
        }

    p: Params = {"time_mlp": {"linear_1": dense_init(cfg.in_channels, emb, **kw),
                              "linear_2": dense_init(emb, emb, **kw)}}
    downs, c_prev = [], cfg.in_channels
    for ch in cfg.channels:
        blk = level(c_prev, ch)
        blk["downsample"] = conv1d_init(3, ch, ch, **kw)
        downs.append(blk)
        c_prev = ch
    p["down_blocks"] = downs
    p["mid_blocks"] = [level(cfg.channels[-1], cfg.channels[-1]) for _ in range(cfg.num_mid_blocks)]
    ups = []
    rev = tuple(reversed(cfg.channels)) + (cfg.channels[0],)
    for i in range(len(rev) - 1):
        blk = level(rev[i] * 2, rev[i + 1])
        last = i == len(rev) - 2
        blk["upsample"] = conv1d_init(3 if last else 4, rev[i + 1], rev[i + 1], **kw)
        ups.append(blk)
    p["up_blocks"] = ups
    p["final_block"] = _block1d_init(rev[-1], rev[-1], **kw)
    p["final_proj"] = conv1d_init(1, rev[-1], cfg.out_channels, **kw)
    return p


# ── the estimator U-Net ─────────────────────────────────────────────────


def apply_cfm_estimator(
    p: Params,
    cfg: CFMDecoderConfig,
    x: torch.Tensor,        # [b, t, out_channels] current sample
    mask: torch.Tensor,     # [b, t, 1]
    mu: torch.Tensor,       # [b, t, out_channels] conditioning
    t: torch.Tensor,        # [b] ODE time in [0, 1]
    spks: Optional[torch.Tensor] = None,   # [b, out_channels]
    cond: Optional[torch.Tensor] = None,   # [b, t, out_channels]
) -> torch.Tensor:
    """Velocity v(x_t, t | mu, spk, cond) → [b, t, out_channels]."""
    if not cfg.causal:
        raise NotImplementedError("only the causal CFM variant (every shipped config) is ported")
    temb = sinusoidal_pos_emb(t, cfg.in_channels).to(cfg.dtype)
    temb = dense(p["time_mlp"]["linear_1"], temb)
    temb = dense(p["time_mlp"]["linear_2"], F.silu(temb))

    mask = mask.to(cfg.dtype)
    x = x.to(cfg.dtype)
    feats = [x, mu.to(cfg.dtype)]
    if spks is not None:
        feats.append(spks[:, None, :].expand(x.shape).to(x.dtype))
    if cond is not None:
        feats.append(cond.to(x.dtype))
    h = torch.cat(feats, dim=-1)

    def attn_bias_from(m):
        keep = m[:, None, None, :, 0] > 0
        return torch.where(keep, 0.0, -1e9).to(torch.float32)

    def lens_from(m):
        return (m[:, :, 0] > 0).sum(1).to(torch.int32)

    n_levels = len(p["down_blocks"])
    hiddens, masks = [], [mask]
    for i, blk in enumerate(p["down_blocks"]):
        m = masks[-1]
        h = _resnet1d(blk["resnet"], cfg, h, m, temb)
        bias, lens = attn_bias_from(m), lens_from(m)
        for xf in blk["transformer"]:
            h = _xf_block(xf, cfg, h, bias, lens)
        hiddens.append(h)
        if i < n_levels - 1:
            h = _conv(blk["downsample"], h * m, stride=2)
            masks.append(m[:, ::2, :])
        else:
            h = _conv(blk["downsample"], h * m, causal=cfg.causal)
            masks.append(m)
    masks = masks[:-1]

    m = masks[-1]
    bias, lens = attn_bias_from(m), lens_from(m)
    for blk in p["mid_blocks"]:
        h = _resnet1d(blk["resnet"], cfg, h, m, temb)
        for xf in blk["transformer"]:
            h = _xf_block(xf, cfg, h, bias, lens)

    for i, blk in enumerate(p["up_blocks"]):
        m = masks.pop()
        skip = hiddens.pop()
        h = torch.cat([h[:, : skip.shape[1], :], skip], dim=-1)
        h = _resnet1d(blk["resnet"], cfg, h, m, temb)
        bias, lens = attn_bias_from(m), lens_from(m)
        for xf in blk["transformer"]:
            h = _xf_block(xf, cfg, h, bias, lens)
        if i < len(p["up_blocks"]) - 1:
            h = conv1d_transpose(blk["upsample"], h * m, stride=2)
        else:
            h = _conv(blk["upsample"], h * m, causal=cfg.causal)

    h = _block1d(p["final_block"], cfg, h, m)
    return _conv(p["final_proj"], h * m) * mask


# ── the ODE solver ──────────────────────────────────────────────────────


def cfm_t_span(cfg: CFMDecoderConfig, device="cpu") -> torch.Tensor:
    t = torch.linspace(0.0, 1.0, cfg.n_timesteps + 1, dtype=torch.float32, device=device)
    if cfg.t_scheduler == "cosine":
        t = 1.0 - torch.cos(t * 0.5 * math.pi)
    return t


@torch.no_grad()
def cfm_generate(
    p: Params,
    cfg: CFMDecoderConfig,
    mu: torch.Tensor,                     # [b, t, out_channels]
    mask: torch.Tensor,                   # [b, t, 1]
    spks: Optional[torch.Tensor] = None,
    cond: Optional[torch.Tensor] = None,
    *,
    z: Optional[torch.Tensor] = None,     # [b, t, out_channels] standard normal
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
) -> torch.Tensor:
    """Euler ODE from noise ``z * temperature`` → mel, with CFG as one
    doubled batch per step."""
    b, t_len, c = mu.shape
    if z is None:
        z = torch.randn((b, t_len, c), generator=generator, device=mu.device)
    x = z.float() * temperature
    t_span = cfm_t_span(cfg, mu.device)
    use_cfg = cfg.cfg_rate > 0.0
    if use_cfg:
        mu2 = torch.cat([mu, torch.zeros_like(mu)], 0)
        mask2 = torch.cat([mask, mask], 0)
        spks2 = None if spks is None else torch.cat([spks, torch.zeros_like(spks)], 0)
        cond2 = None if cond is None else torch.cat([cond, torch.zeros_like(cond)], 0)
    for i in range(cfg.n_timesteps):
        t_cur = t_span[i]
        dt = t_span[i + 1] - t_span[i]
        if use_cfg:
            v2 = apply_cfm_estimator(p, cfg, torch.cat([x, x], 0), mask2, mu2,
                                     t_cur.expand(2 * b), spks2, cond2)
            v = (1.0 + cfg.cfg_rate) * v2[:b] - cfg.cfg_rate * v2[b:]
        else:
            v = apply_cfm_estimator(p, cfg, x, mask, mu, t_cur.expand(b), spks, cond)
        x = x + dt * v.to(x.dtype)
    return x * mask


__all__ = [
    "CFMDecoderConfig",
    "init_cfm_estimator",
    "apply_cfm_estimator",
    "cfm_t_span",
    "cfm_generate",
    "sinusoidal_pos_emb",
]
