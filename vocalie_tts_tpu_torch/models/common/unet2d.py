"""LDM-style 2D UNet for latent diffusion (counterpart of
``vocalie_tts_tpu/models/common/unet2d.py``).

The public layout is the JAX package's: activations NHWC, conv kernels
HWIO ``[k, k, c_in, c_out]``, int8 convs ``{"w_q", "w_s", "b"}`` with
per-output-channel scales, and a param tree that mirrors the published
torch module tree. The re-layout to PyTorch's NCHW / OIHW happens inside
``conv2d`` only.

GroupNorm: f32 inputs take ``group_norm``'s f32 path; bf16 inputs take its
bf16 path (f32 moments, bf16 apply) or, under ``VOCALIE_GN_PALLAS=1``,
kernel B13 (``ops/groupnorm.py``), where the JAX package routes them.

int8 convs (``_conv2d_int8``): s8 × s8 products summed exactly in int32
(an im2col view and ``torch._int_mm``), with the activation quantized per
sample as the JAX package does. No Pallas kernel computes them there, so
none is owed here.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from vocalie_tts_tpu_torch.device import div_const
from vocalie_tts_tpu_torch.ops.groupnorm import group_norm_fused
from vocalie_tts_tpu_torch.utils.env import bool_env

Params = Dict[str, Any]
Padding = Union[str, Sequence[Tuple[int, int]]]


def conv2d_init(kernel: int, c_in: int, c_out: int, *, generator: Optional[torch.Generator] = None,
                device="cpu", zero: bool = False, dtype=torch.float32) -> Params:
    if zero:
        w = torch.zeros((kernel, kernel, c_in, c_out), dtype=dtype, device=device)
    else:
        scale = 1.0 / math.sqrt(kernel * kernel * c_in)
        w = (torch.rand((kernel, kernel, c_in, c_out), generator=generator, device=device)
             * 2 - 1) * scale
        w = w.to(dtype)
    return {"w": w, "b": torch.zeros((c_out,), dtype=dtype, device=device)}


def _pads(shape: Sequence[int], kernel: int, stride: int, padding: Padding):
    """((top, bottom), (left, right)) as XLA's ``padding`` argument means it."""
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding == "SAME":
        out = []
        for n in shape:
            total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    return tuple(tuple(p) for p in padding)


def conv2d(params: Params, x: torch.Tensor, *, stride: int = 1,
           padding: Padding = "SAME") -> torch.Tensor:
    if "w_q" in params:
        return _conv2d_int8(params, x, stride=stride, padding=padding)
    w = params["w"]
    k = w.shape[0]
    (pt, pb), (pl, pr) = _pads(x.shape[1:3], k, stride, padding)
    xn = x.permute(0, 3, 1, 2)
    if pt == pb and pl == pr:
        pad = (pt, pl)
    else:
        xn, pad = F.pad(xn, (pl, pr, pt, pb)), 0
    out = F.conv2d(xn, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride, padding=pad)
    return out.permute(0, 2, 3, 1) + params["b"].to(x.dtype)


def conv_quantize_int8(params: Params) -> Params:
    """Symmetric per-output-channel int8 (``w_q`` [k,k,ci,co] + ``w_s`` [co]
    f32 dequant scales); zero padding stays exact (0 ↦ 0)."""
    w = params["w"].float()
    amax = torch.clamp(torch.amax(torch.abs(w), dim=(0, 1, 2)), min=1e-12)
    s = div_const(amax, 127.0)
    wq = torch.round(w / s).to(torch.int8)
    return {"w_q": wq, "w_s": s, "b": params["b"]}


def _int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ w`` for int8 ``a`` [M, K] and ``w`` [K, N].
    ``torch._int_mm`` wants M > 16 and K, N multiples of 8: zero rows and
    columns make up the difference and add nothing to the sums."""
    m, k = a.shape
    n = w.shape[1]
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        w = F.pad(w, (0, pn, 0, pk))
    out = torch._int_mm(a.contiguous(), w.contiguous())
    return out[:m, :n] if (pm or pn) else out


def _quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample symmetric int8: (xq, sx [b,1,1,1] f32)."""
    xf = x.float()
    ax = torch.amax(torch.abs(xf), dim=tuple(range(1, x.ndim)), keepdim=True)
    sx = div_const(torch.clamp(ax, min=1e-12), 127.0)
    return torch.round(xf / sx).to(torch.int8), sx


def _conv_int8_acc(xq: torch.Tensor, wq: torch.Tensor, *, stride: int,
                   padding: Padding) -> torch.Tensor:
    """The exact int32 conv of int8 NHWC ``xq`` with int8 HWIO ``wq``: an
    im2col view (taps in HWI order, as ``wq`` flattens) times the weights."""
    k, _, ci, co = wq.shape
    b, h, w, _ = xq.shape
    (pt, pb), (pl, pr) = _pads((h, w), k, stride, padding)
    ho = (h + pt + pb - k) // stride + 1
    wo = (w + pl + pr - k) // stride + 1
    if k == 1 and stride == 1 and not (pt or pb or pl or pr):
        cols = xq.reshape(b * h * w, ci)
    else:
        xp = F.pad(xq, (0, 0, pl, pr, pt, pb))
        taps = [xp[:, i : i + stride * (ho - 1) + 1 : stride, j : j + stride * (wo - 1) + 1 : stride]
                for i in range(k) for j in range(k)]
        cols = torch.stack(taps, dim=3).reshape(b * ho * wo, k * k * ci)
    return _int8_matmul(cols, wq.reshape(k * k * ci, co)).reshape(b, ho, wo, co)


def _conv2d_int8(params: Params, x: torch.Tensor, *, stride: int = 1,
                 padding: Padding = "SAME") -> torch.Tensor:
    """s8×s8→s32 conv with dynamic per-sample activation quantization."""
    xq, sx = _quantize_act(x)
    acc = _conv_int8_acc(xq, params["w_q"], stride=stride, padding=padding)
    scale = sx * params["w_s"]                                     # [b,1,1,co]
    out = acc.float() * scale + params["b"].float()
    return out.to(x.dtype)


def dense_init(d_in: int, d_out: int, *, generator: Optional[torch.Generator] = None,
               device="cpu", zero: bool = False, dtype=torch.float32) -> Params:
    if zero:
        w = torch.zeros((d_in, d_out), dtype=dtype, device=device)
    else:
        scale = 1.0 / math.sqrt(d_in)
        w = (torch.rand((d_in, d_out), generator=generator, device=device) * 2 - 1) * scale
        w = w.to(dtype)
    return {"w": w, "b": torch.zeros((d_out,), dtype=dtype, device=device)}


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, params["w"].to(x.dtype)) + params["b"].to(x.dtype)


def n_groups(c: int, want: int = 32) -> int:
    """Largest divisor of ``c`` that is ≤ ``want``."""
    g = min(want, c)
    while c % g:
        g -= 1
    return g


def group_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, *, groups: int = 32,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over channels-last x (any spatial rank). Moments in f32;
    f32 inputs apply in f32, bf16 inputs apply in bf16."""
    orig_dtype = x.dtype
    c = x.shape[-1]
    groups = n_groups(c, groups)
    spatial = x.shape[1:-1]
    bdim = x.shape[0]
    if orig_dtype == torch.float32:
        xg = x.reshape(bdim, -1, groups, c // groups)
        mean = torch.mean(xg, dim=(1, 3), keepdim=True)
        var = torch.mean(torch.square(xg - mean), dim=(1, 3), keepdim=True)
        xg = (xg - mean) * torch.rsqrt(var + eps)
        return xg.reshape(x.shape) * g + b
    spatial_axes = tuple(range(1, x.ndim - 1))
    n_per_group = (c // groups) * int(np.prod(spatial)) if spatial else (c // groups)
    xf = x.float()
    sum_c = torch.sum(xf, dim=spatial_axes) if spatial else xf
    sq_c = torch.sum(torch.square(xf), dim=spatial_axes) if spatial else torch.square(xf)
    sum_g = sum_c.reshape(bdim, groups, c // groups).sum(-1)
    sq_g = sq_c.reshape(bdim, groups, c // groups).sum(-1)
    mean_g = div_const(sum_g, n_per_group)
    var_g = torch.clamp(div_const(sq_g, n_per_group) - torch.square(mean_g), min=0.0)
    inv_g = torch.rsqrt(var_g + eps)
    bc = (1,) * len(spatial)
    mean_c = torch.repeat_interleave(mean_g, c // groups, dim=1).to(orig_dtype)
    inv_c = torch.repeat_interleave(inv_g, c // groups, dim=1).to(orig_dtype)
    mean_c = mean_c.reshape(bdim, *bc, c)
    inv_c = inv_c.reshape(bdim, *bc, c)
    return ((x - mean_c) * inv_c * g.to(orig_dtype) + b.to(orig_dtype)).to(orig_dtype)


def norm_init(c: int, device="cpu") -> Params:
    return {"g": torch.ones((c,), dtype=torch.float32, device=device),
            "b": torch.zeros((c,), dtype=torch.float32, device=device)}


def _norm_act(x: torch.Tensor, p: Params, *, silu: bool = False,
              pre_add: Optional[torch.Tensor] = None, groups: int = 32,
              eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm with optional pre-norm FiLM add and post-norm SiLU. bf16
    input under ``VOCALIE_GN_PALLAS=1`` takes kernel B13, as the JAX
    package takes its Pallas kernel there."""
    c = x.shape[-1]
    g = n_groups(c, groups)
    if x.dtype != torch.float32 and bool_env("VOCALIE_GN_PALLAS"):
        row = pre_add.to(x.dtype).contiguous() if pre_add is not None else None
        return group_norm_fused(x.contiguous(), p["g"], p["b"], groups=g, eps=eps, silu=silu,
                                pre_add=row)
    if pre_add is not None:
        x = x + pre_add.reshape(pre_add.shape[0], *(1,) * (x.ndim - 2), c).to(x.dtype)
    y = group_norm(x, p["g"], p["b"], groups=g, eps=eps)
    return F.silu(y) if silu else y


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal step embedding, cos-first (the LDM util convention)."""
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(div_const(-math.log(max_period) * ar, half))
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


# ── UNet blocks (torch-tree-mirroring param layout) ─────────────────────


def _resblock_init(c_in: int, c_out: int, emb_dim: int, scale_shift: bool, *,
                   generator, device) -> Params:
    kw = dict(generator=generator, device=device)
    p: Params = {
        "in_norm": norm_init(c_in, device),
        "in_conv": conv2d_init(3, c_in, c_out, **kw),
        "emb": dense_init(emb_dim, 2 * c_out if scale_shift else c_out, **kw),
        "out_norm": norm_init(c_out, device),
        # zero-init final conv → identity residual at init (LDM convention)
        "out_conv": conv2d_init(3, c_out, c_out, zero=True, **kw),
    }
    if c_in != c_out:
        p["skip"] = conv2d_init(1, c_in, c_out, **kw)
    return p


def _resblock(p: Params, x: torch.Tensor, emb: torch.Tensor, scale_shift: bool) -> torch.Tensor:
    h = _norm_act(x, p["in_norm"], silu=True)
    h = conv2d(p["in_conv"], h)
    e_row = dense(p["emb"], F.silu(emb))                # [b, c_out(·2)]
    if scale_shift:
        scale, shift = torch.chunk(e_row[:, None, None, :], 2, dim=-1)
        h = group_norm(h, p["out_norm"]["g"], p["out_norm"]["b"]) * (1 + scale) + shift
        h = conv2d(p["out_conv"], F.silu(h))
    else:
        # h+e → norm → silu (one B13 launch on the serving path)
        h = _norm_act(h, p["out_norm"], silu=True, pre_add=e_row)
        h = conv2d(p["out_conv"], h)
    skip = conv2d(p["skip"], x) if "skip" in p else x
    return skip + h


def _attnblock_init(c: int, *, generator, device) -> Params:
    kw = dict(generator=generator, device=device)
    return {
        "norm": norm_init(c, device),
        "qkv": conv2d_init(1, c, 3 * c, **kw),
        # zero-init projection (LDM convention)
        "proj": conv2d_init(1, c, c, zero=True, **kw),
    }


@functools.lru_cache(maxsize=32)
def _qkv_perm(c: int, n_heads: int, device: torch.device) -> torch.Tensor:
    """Legacy QKVAttention columns are heads-major (h, {q,k,v}, d); the
    permutation to grouped [q_all | k_all | v_all], made once per device:
    a host→device copy in every block would wait for the card each call."""
    perm = np.arange(3 * c).reshape(n_heads, 3, c // n_heads)
    return torch.as_tensor(np.concatenate([perm[:, j, :].reshape(-1) for j in range(3)]),
                           device=device)


def _attnblock(p: Params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, hh, ww, c = x.shape
    h = _norm_act(x, p["norm"])
    d = c // n_heads
    perm = _qkv_perm(c, n_heads, x.device)
    if "w_q" in p["qkv"]:
        # per-output-channel scales permute with their columns
        qkv_p: Params = {"w_q": p["qkv"]["w_q"][..., perm], "w_s": p["qkv"]["w_s"][perm],
                         "b": p["qkv"]["b"][perm]}
    else:
        qkv_p = {"w": p["qkv"]["w"][..., perm], "b": p["qkv"]["b"][perm]}
    qkv = conv2d(qkv_p, h).reshape(b, hh * ww, 3 * c)
    q = qkv[:, :, :c].reshape(b, hh * ww, n_heads, d)
    k = qkv[:, :, c:2 * c].reshape(b, hh * ww, n_heads, d)
    v = qkv[:, :, 2 * c:].reshape(b, hh * ww, n_heads, d)
    # legacy QKVAttention scaling: 1/sqrt(sqrt(d)) applied to q AND k,
    # logits summed in f32
    scale = 1.0 / math.sqrt(math.sqrt(d))
    logits = torch.einsum("bthd,bshd->bhts", (q * scale).float(), (k * scale).float())
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    a = torch.einsum("bhts,bshd->bthd", w, v).reshape(b, hh, ww, c)
    return x + conv2d(p["proj"], a)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _upsample(p: Params, x: torch.Tensor) -> torch.Tensor:
    return conv2d(p, upsample_nearest2x(x))


# ── full UNet ───────────────────────────────────────────────────────────


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    in_channels: int = 32          # z + lowres-cond concat
    model_channels: int = 128
    out_channels: int = 16
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2)   # in downsample factors
    channel_mult: Tuple[int, ...] = (1, 2, 4)
    num_heads: int = 8
    use_scale_shift_norm: bool = False
    dtype: Any = torch.float32


def _plan(cfg: UNet2DConfig) -> Tuple[List[List[str]], List[List[str]], List[int]]:
    """Module kinds per input/output block (the torch ModuleList order) and
    the channel count of every skip."""
    input_plan: List[List[str]] = [["conv"]]
    chans = [cfg.model_channels]
    ch = cfg.model_channels
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            mods = ["res"]
            ch = mult * cfg.model_channels
            if ds in cfg.attention_resolutions:
                mods.append("attn")
            input_plan.append(mods)
            chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            input_plan.append(["down"])
            chans.append(ch)
            ds *= 2

    output_plan: List[List[str]] = []
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            mods = ["res"]
            if ds in cfg.attention_resolutions:
                mods.append("attn")
            if level and i == cfg.num_res_blocks:
                mods.append("up")
                ds //= 2
            output_plan.append(mods)
    return input_plan, output_plan, chans


def init_unet2d(cfg: UNet2DConfig, *, generator: Optional[torch.Generator] = None,
                device="cpu") -> Params:
    input_plan, _output_plan, chans = _plan(cfg)
    emb_dim = 4 * cfg.model_channels
    ss = cfg.use_scale_shift_norm
    kw = dict(generator=generator, device=device)
    params: Params = {
        "time_embed": {
            "l0": dense_init(cfg.model_channels, emb_dim, **kw),
            "l2": dense_init(emb_dim, emb_dim, **kw),
        },
        "input_blocks": [],
        "middle_block": {},
        "output_blocks": [],
    }
    ch = cfg.model_channels
    for bi, mods in enumerate(input_plan):
        block: Params = {}
        for kind in mods:
            if kind == "conv":
                block["conv"] = conv2d_init(3, cfg.in_channels, cfg.model_channels, **kw)
                ch = cfg.model_channels
            elif kind == "res":
                block["res"] = _resblock_init(ch, chans[bi], emb_dim, ss, **kw)
                ch = chans[bi]
            elif kind == "attn":
                block["attn"] = _attnblock_init(ch, **kw)
            elif kind == "down":
                block["down"] = conv2d_init(3, ch, ch, **kw)
        params["input_blocks"].append(block)

    params["middle_block"] = {
        "res1": _resblock_init(ch, ch, emb_dim, ss, **kw),
        "attn": _attnblock_init(ch, **kw),
        "res2": _resblock_init(ch, ch, emb_dim, ss, **kw),
    }

    skip_chans = list(chans)
    ds = 2 ** (len(cfg.channel_mult) - 1)
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            block = {}
            ich = skip_chans.pop()
            c_out = cfg.model_channels * mult
            block["res"] = _resblock_init(ch + ich, c_out, emb_dim, ss, **kw)
            ch = c_out
            if ds in cfg.attention_resolutions:
                block["attn"] = _attnblock_init(ch, **kw)
            if level and i == cfg.num_res_blocks:
                block["up"] = conv2d_init(3, ch, ch, **kw)
                ds //= 2
            params["output_blocks"].append(block)

    params["out_norm"] = norm_init(ch, device)
    params["out_conv"] = conv2d_init(3, ch, cfg.out_channels, zero=True, **kw)
    return params


def quantize_unet_convs(params: Params) -> Params:
    """A copy of a UNet param tree with every interior conv pre-quantized to
    int8 (``conv_quantize_int8``). The final ``out_conv`` (the eps estimate)
    stays full precision; dense layers stay as they are."""

    def walk(node, *, skip_final: bool = False):
        if isinstance(node, dict):
            if "w" in node and getattr(node["w"], "ndim", 0) == 4:
                return conv_quantize_int8(node)
            return {k: (v if (skip_final and k == "out_conv") else walk(v))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params, skip_final=True)


def apply_unet2d(params: Params, cfg: UNet2DConfig, x: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """x: [b, H, W, in_channels]; t: [b] diffusion steps → eps [b,H,W,out]."""
    ss = cfg.use_scale_shift_norm
    emb = dense(params["time_embed"]["l0"], timestep_embedding(t, cfg.model_channels))
    emb = dense(params["time_embed"]["l2"], F.silu(emb))
    # the activation dtype: an f32 embedding must not promote the bf16 UNet
    emb = emb.to(x.dtype)

    hs = []
    h = x
    for block in params["input_blocks"]:
        if "conv" in block:
            h = conv2d(block["conv"], h)
        if "res" in block:
            h = _resblock(block["res"], h, emb, ss)
        if "attn" in block:
            h = _attnblock(block["attn"], h, cfg.num_heads)
        if "down" in block:
            # explicit (1,1) padding, as the published conv pads (SAME at
            # stride 2 would pad (0,1))
            h = conv2d(block["down"], h, stride=2, padding=((1, 1), (1, 1)))
        hs.append(h)

    mid = params["middle_block"]
    h = _resblock(mid["res1"], h, emb, ss)
    h = _attnblock(mid["attn"], h, cfg.num_heads)
    h = _resblock(mid["res2"], h, emb, ss)

    for block in params["output_blocks"]:
        h = torch.cat([h, hs.pop()], dim=-1)
        h = _resblock(block["res"], h, emb, ss)
        if "attn" in block:
            h = _attnblock(block["attn"], h, cfg.num_heads)
        if "up" in block:
            h = _upsample(block["up"], h)

    h = _norm_act(h, params["out_norm"], silu=True)
    return conv2d(params["out_conv"], h)


__all__ = [
    "UNet2DConfig",
    "init_unet2d",
    "apply_unet2d",
    "conv2d",
    "conv2d_init",
    "conv_quantize_int8",
    "quantize_unet_convs",
    "dense",
    "dense_init",
    "group_norm",
    "n_groups",
    "norm_init",
    "timestep_embedding",
    "upsample_nearest2x",
]
