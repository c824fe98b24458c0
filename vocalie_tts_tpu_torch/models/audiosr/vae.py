"""AutoencoderKL (CompVis layout) for the AudioSR latent space (counterpart
of ``vocalie_tts_tpu/models/audiosr/vae.py``).

2D ResnetBlocks with swish, one single-head attention at the bottleneck,
stride-2 downsampling padded (right, bottom) only, nearest-2× upsampling;
NHWC activations and a param tree mirroring the torch module tree. Mel
spectrograms enter as [b, T, F, 1] images; the latent is
[b, T/2^n, F/2^n, z_channels]. Every norm goes through ``_norm_act`` at
eps 1e-6 (kernel B13 for bf16 under ``VOCALIE_GN_PALLAS=1``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from vocalie_tts_tpu_torch.models.common.unet2d import (
    _norm_act,
    conv2d,
    conv2d_init,
    norm_init,
    upsample_nearest2x,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 1
    base_channels: int = 64
    channel_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    z_channels: int = 16
    embed_dim: int = 16
    dtype: Any = torch.float32

    @property
    def downsample(self) -> int:
        return 2 ** (len(self.channel_mult) - 1)


def _resnet_init(c_in: int, c_out: int, *, generator, device) -> Params:
    kw = dict(generator=generator, device=device)
    p: Params = {
        "norm1": norm_init(c_in, device),
        "conv1": conv2d_init(3, c_in, c_out, **kw),
        "norm2": norm_init(c_out, device),
        "conv2": conv2d_init(3, c_out, c_out, **kw),
    }
    if c_in != c_out:
        p["nin_shortcut"] = conv2d_init(1, c_in, c_out, **kw)
    return p


def _resnet(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = _norm_act(x, p["norm1"], silu=True, eps=1e-6)
    h = conv2d(p["conv1"], h)
    h = _norm_act(h, p["norm2"], silu=True, eps=1e-6)
    h = conv2d(p["conv2"], h)
    skip = conv2d(p["nin_shortcut"], x) if "nin_shortcut" in p else x
    return skip + h


def _attn_init(c: int, *, generator, device) -> Params:
    kw = dict(generator=generator, device=device)
    return {"norm": norm_init(c, device), "q": conv2d_init(1, c, c, **kw),
            "k": conv2d_init(1, c, c, **kw), "v": conv2d_init(1, c, c, **kw),
            "proj_out": conv2d_init(1, c, c, **kw)}


def _attn(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Single-head bottleneck attention (the CompVis AttnBlock); logits in f32."""
    b, hh, ww, c = x.shape
    h = _norm_act(x, p["norm"], eps=1e-6)
    q = conv2d(p["q"], h).reshape(b, hh * ww, c)
    k = conv2d(p["k"], h).reshape(b, hh * ww, c)
    v = conv2d(p["v"], h).reshape(b, hh * ww, c)
    logits = torch.einsum("btc,bsc->bts", q.float(), k.float()) * (1.0 / math.sqrt(c))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    a = torch.einsum("bts,bsc->btc", w, v).reshape(b, hh, ww, c)
    return x + conv2d(p["proj_out"], a)


def _downsample(p: Params, x: torch.Tensor) -> torch.Tensor:
    # CompVis pads (right, bottom) only, then convs VALID at stride 2
    return conv2d(p, F.pad(x, (0, 0, 0, 1, 0, 1)), stride=2, padding="VALID")


def _upsample(p: Params, x: torch.Tensor) -> torch.Tensor:
    return conv2d(p, upsample_nearest2x(x))


# ── init ────────────────────────────────────────────────────────────────


def init_vae(cfg: VAEConfig, *, generator: Optional[torch.Generator] = None,
             device="cpu") -> Params:
    kw = dict(generator=generator, device=device)
    n_levels = len(cfg.channel_mult)
    enc: Params = {"conv_in": conv2d_init(3, cfg.in_channels, cfg.base_channels, **kw),
                   "down": []}
    ch = cfg.base_channels
    for level, mult in enumerate(cfg.channel_mult):
        blocks = []
        c_out = cfg.base_channels * mult
        for _ in range(cfg.num_res_blocks):
            blocks.append(_resnet_init(ch, c_out, **kw))
            ch = c_out
        lvl: Params = {"block": blocks}
        if level != n_levels - 1:
            lvl["downsample"] = conv2d_init(3, ch, ch, **kw)
        enc["down"].append(lvl)
    enc["mid"] = {"block_1": _resnet_init(ch, ch, **kw), "attn_1": _attn_init(ch, **kw),
                  "block_2": _resnet_init(ch, ch, **kw)}
    enc["norm_out"] = norm_init(ch, device)
    enc["conv_out"] = conv2d_init(3, ch, 2 * cfg.z_channels, **kw)

    dec: Params = {
        "conv_in": conv2d_init(3, cfg.embed_dim, ch, **kw),
        "mid": {"block_1": _resnet_init(ch, ch, **kw), "attn_1": _attn_init(ch, **kw),
                "block_2": _resnet_init(ch, ch, **kw)},
        "up": [None] * n_levels,
    }
    for level in reversed(range(n_levels)):
        blocks = []
        c_out = cfg.base_channels * cfg.channel_mult[level]
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(_resnet_init(ch, c_out, **kw))
            ch = c_out
        lvl = {"block": blocks}
        if level != 0:
            lvl["upsample"] = conv2d_init(3, ch, ch, **kw)
        dec["up"][level] = lvl
    dec["norm_out"] = norm_init(ch, device)
    dec["conv_out"] = conv2d_init(3, ch, cfg.in_channels, **kw)
    return {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": conv2d_init(1, 2 * cfg.z_channels, 2 * cfg.embed_dim, **kw),
        "post_quant_conv": conv2d_init(1, cfg.embed_dim, cfg.embed_dim, **kw),
    }


# ── apply ───────────────────────────────────────────────────────────────


def vae_encode_moments(params: Params, cfg: VAEConfig, x: torch.Tensor) -> torch.Tensor:
    """x [b, H, W, in] → moments [b, H/ds, W/ds, 2*embed] (mean ‖ logvar)."""
    enc = params["encoder"]
    h = conv2d(enc["conv_in"], x)
    n_levels = len(cfg.channel_mult)
    for level, lvl in enumerate(enc["down"]):
        for block in lvl["block"]:
            h = _resnet(block, h)
        if level != n_levels - 1:
            h = _downsample(lvl["downsample"], h)
    h = _resnet(enc["mid"]["block_1"], h)
    h = _attn(enc["mid"]["attn_1"], h)
    h = _resnet(enc["mid"]["block_2"], h)
    h = _norm_act(h, enc["norm_out"], silu=True, eps=1e-6)
    h = conv2d(enc["conv_out"], h)
    return conv2d(params["quant_conv"], h)


def vae_encode(params: Params, cfg: VAEConfig, x: torch.Tensor) -> torch.Tensor:
    """The latent mean (what the studio pass conditions on; the JAX
    package's sampled latent, with an ``rng``, has no caller on the path)."""
    return torch.chunk(vae_encode_moments(params, cfg, x), 2, dim=-1)[0]


def vae_decode(params: Params, cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    dec = params["decoder"]
    h = conv2d(params["post_quant_conv"], z)
    h = conv2d(dec["conv_in"], h)
    h = _resnet(dec["mid"]["block_1"], h)
    h = _attn(dec["mid"]["attn_1"], h)
    h = _resnet(dec["mid"]["block_2"], h)
    for level in reversed(range(len(cfg.channel_mult))):
        lvl = dec["up"][level]
        for block in lvl["block"]:
            h = _resnet(block, h)
        if level != 0:
            h = _upsample(lvl["upsample"], h)
    h = _norm_act(h, dec["norm_out"], silu=True, eps=1e-6)
    return conv2d(dec["conv_out"], h)


__all__ = ["VAEConfig", "init_vae", "vae_encode", "vae_encode_moments", "vae_decode"]
