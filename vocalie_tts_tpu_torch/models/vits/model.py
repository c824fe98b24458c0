"""VITS model graph, the Piper-compatible architecture (counterpart of
``vocalie_tts_tpu/models/vits/model.py``).

Inference path: phone embeddings → relative-position transformer encoder
→ stochastic duration predictor (spline flows, reverse) → length
regulation → residual-coupling flow (WaveNet, inverse) → the
speaker-conditioned HiFi-GAN (``models/common/vocoder.py``).

Plain functions on tensors over the JAX package's param tree (its keys,
lists and ``[kernel, c_in, c_out]`` conv layout; the depthwise kernels
``[kernel, 1, c]``), activations ``[batch, time, channels]``. Every product
and convolution is a PyTorch call: the JAX model runs no Pallas kernel.

Randomness comes in as tensors: ``duration_log_w`` and
``encode_and_durations`` take the duration noise ``[b, t, 2]`` already
scaled by ``noise_w`` (JAX draws ``normal · noise_w`` from its key), and
``decode_frames`` takes the prior's standard-normal ``eps [b, frames,
latent]`` (JAX draws it from its key and scales it by ``noise_scale``
inside).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from vocalie_tts_tpu_torch.device import div_const
from vocalie_tts_tpu_torch.models.common.convnets import (
    _same_pad,
    conv1d,
    conv1d_init,
    layer_norm,
)
from vocalie_tts_tpu_torch.models.common.vocoder import (
    VocoderConfig,
    apply_vocoder,
    init_vocoder,
)
from vocalie_tts_tpu_torch.text.phonemes import N_PHONES

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VITSConfig:
    n_phones: int = N_PHONES
    d_model: int = 192             # hidden/inter-channel width
    n_layers: int = 6
    n_heads: int = 2
    d_ff: int = 768
    ff_kernel: int = 3
    rel_window: int = 4            # relative-attention window
    latent_dim: int = 192
    n_flows: int = 4
    flow_hidden: int = 192
    flow_kernel: int = 5
    flow_wn_layers: int = 4
    dp_filter: int = 192
    dp_kernel: int = 3
    dp_flows: int = 4
    dp_bins: int = 10
    dp_tail_bound: float = 5.0
    n_speakers: int = 4
    speaker_dim: int = 128         # gin_channels (0 = single speaker)
    sample_rate: int = 22050
    max_phones: int = 512
    max_frames: int = 1200         # ~14 s at 86 fps
    vocoder_channels: int = 512
    dtype: Any = torch.float32

    @property
    def vocoder(self) -> VocoderConfig:
        return VocoderConfig(
            n_mels=self.latent_dim,
            base_channels=self.vocoder_channels,
            upsample_rates=(8, 8, 2, 2),
            upsample_kernels=(16, 16, 4, 4),
            dtype=self.dtype,
        )


# ── low-level pieces ────────────────────────────────────────────────────


def _depthwise_conv(params: Params, x: torch.Tensor, *, dilation: int) -> torch.Tensor:
    """Depthwise 1-D conv, channels-last, ``[k, 1, c]`` kernel, XLA's SAME
    padding."""
    c = x.shape[-1]
    w = params["w"]
    pad = _same_pad(x.shape[1], w.shape[0], 1, dilation)
    out = F.conv1d(F.pad(x.transpose(1, 2), pad), w.to(x.dtype).permute(2, 1, 0),
                   dilation=dilation, groups=c)
    return out.transpose(1, 2) + params["b"].to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")    # published model: erf gelu


# ── relative-position multi-head attention (encoder) ────────────────────


def _get_relative_embeddings(emb: torch.Tensor, t: int, window: int) -> torch.Tensor:
    """emb [2w+1, d] → [2t-1, d] (pad or central slice)."""
    pad = max(t - (window + 1), 0)
    start = max((window + 1) - t, 0)
    padded = F.pad(emb, (0, 0, pad, pad))
    return padded[start:start + 2 * t - 1]


def _relative_to_absolute(x: torch.Tensor) -> torch.Tensor:
    """[b, h, t, 2t-1] relative logits → [b, h, t, t] absolute."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, 1))                                       # [b,h,t,2t]
    flat = F.pad(x.reshape(b, h, t * 2 * t), (0, t - 1))
    return flat.reshape(b, h, t + 1, 2 * t - 1)[:, :, :t, t - 1:]


def _absolute_to_relative(x: torch.Tensor) -> torch.Tensor:
    """[b, h, t, t] attention → [b, h, t, 2t-1] relative weights."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, t - 1))
    flat = F.pad(x.reshape(b, h, t * t + t * (t - 1)), (t, 0))
    return flat.reshape(b, h, t, 2 * t)[:, :, :, 1:]


def _rel_attention(layer: Params, cfg: VITSConfig, x: torch.Tensor,
                   attn_mask: torch.Tensor) -> torch.Tensor:
    """Windowed relative-position MHA (1×1 conv projections); masked
    scores filled with -1e4, as the published model."""
    b, t, c = x.shape
    h = cfg.n_heads
    d = c // h

    def heads(name):
        return conv1d(layer[name], x).reshape(b, t, h, d).transpose(1, 2)

    q, k, v = heads("conv_q"), heads("conv_k"), heads("conv_v")
    qs = q * (1.0 / math.sqrt(d))
    scores = torch.matmul(qs, k.transpose(-1, -2))
    rel_k = _get_relative_embeddings(layer["emb_rel_k"][0], t, cfg.rel_window)
    scores = scores + _relative_to_absolute(torch.matmul(qs.float(), rel_k.float().T))
    scores = torch.where(attn_mask, scores, torch.full_like(scores, -1e4))
    p = torch.softmax(scores, dim=-1)
    out = torch.matmul(p.to(v.dtype), v)
    rel_v = _get_relative_embeddings(layer["emb_rel_v"][0], t, cfg.rel_window)
    out = out + torch.matmul(_absolute_to_relative(p), rel_v.to(p.dtype)).to(out.dtype)
    out = out.transpose(1, 2).reshape(b, t, c)
    return conv1d(layer["conv_o"], out)


def _encoder(params: Params, cfg: VITSConfig, phones: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    m = mask[..., None]
    x = params["emb"][phones] * math.sqrt(cfg.d_model)
    x = x * m
    attn_mask = (mask[:, None, :, None] * mask[:, None, None, :]) > 0
    for layer in params["enc_layers"]:
        y = _rel_attention(layer, cfg, x * m, attn_mask)
        x = layer_norm(x + y, layer["norm1"]["g"], layer["norm1"]["b"])
        y = conv1d(layer["ffn1"], x * m)
        y = torch.relu(y) * m
        y = conv1d(layer["ffn2"], y)
        x = layer_norm(x + y, layer["norm2"]["g"], layer["norm2"]["b"])
    return x * m


# ── DDSConv (dilated depth-separable stack) ──────────────────────────────


def _dds_conv(params: Params, x: torch.Tensor, mask: torch.Tensor, kernel: int,
              g: Optional[torch.Tensor] = None) -> torch.Tensor:
    if g is not None:
        x = x + g
    for i, lyr in enumerate(params["layers"]):
        y = _depthwise_conv(lyr["sep"], x * mask[..., None], dilation=kernel ** i)
        y = _gelu(layer_norm(y, lyr["norm1"]["g"], lyr["norm1"]["b"]))
        y = conv1d(lyr["pw"], y)
        y = _gelu(layer_norm(y, lyr["norm2"]["g"], lyr["norm2"]["b"]))
        x = x + y
    return x * mask[..., None]


# ── rational-quadratic spline (inverse, linear tails) ────────────────────

_MIN_BIN = 1e-3
_MIN_DERIV = 1e-3


def _knots(u: torch.Tensor, bins: int, tail_bound: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unnormalized widths (heights) [.., bins] → the knots [.., bins+1]
    with their ends pinned to ±tail_bound, and the bins' sizes."""
    w = _MIN_BIN + (1 - _MIN_BIN * bins) * torch.softmax(u, dim=-1)
    cum = F.pad(torch.cumsum(w, dim=-1), (1, 0))
    cum = (2 * tail_bound) * cum - tail_bound
    cum = torch.cat([torch.full_like(cum[..., :1], -tail_bound), cum[..., 1:-1],
                     torch.full_like(cum[..., :1], tail_bound)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def _rqs_inverse(inputs: torch.Tensor, uw: torch.Tensor, uh: torch.Tensor, ud: torch.Tensor,
                 tail_bound: float) -> torch.Tensor:
    """Inverse rational-quadratic spline with linear tails, elementwise over
    the leading dims: inputs [..], uw/uh [.., bins], ud [.., bins-1]. Inputs
    outside ±tail_bound pass through unchanged."""
    bins = uw.shape[-1]
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    # pad boundary derivatives so the tails are exactly linear
    const = math.log(math.exp(1.0 - _MIN_DERIV) - 1.0)
    ud = F.pad(ud, (1, 1), value=const)
    cumwidths, widths = _knots(uw, bins, tail_bound)
    cumheights, heights = _knots(uh, bins, tail_bound)
    derivatives = _MIN_DERIV + F.softplus(ud)

    safe = torch.clamp(inputs, -tail_bound, tail_bound)
    # bin index: number of left edges <= input, minus one
    idx = (safe[..., None] >= cumheights[..., :-1]).sum(-1) - 1
    idx = torch.clamp(idx, 0, bins - 1)[..., None]

    def take(arr):
        return torch.gather(arr, -1, idx)[..., 0]

    in_cw, in_w = take(cumwidths[..., :-1]), take(widths)
    in_ch, in_h = take(cumheights[..., :-1]), take(heights)
    in_d, in_d1 = take(derivatives[..., :-1]), take(derivatives[..., 1:])
    delta = in_h / torch.clamp(in_w, min=1e-12)

    # solve the quadratic for theta (Durkan et al., inverse pass)
    y_rel = safe - in_ch
    a = in_h * (delta - in_d) + y_rel * (in_d + in_d1 - 2 * delta)
    b_ = in_h * in_d - y_rel * (in_d + in_d1 - 2 * delta)
    c_ = -delta * y_rel
    disc = torch.clamp(b_ * b_ - 4 * a * c_, min=0.0)
    # the denominator is negative by construction: clamp its magnitude
    # only, never the sign
    denom = torch.clamp(-b_ - torch.sqrt(disc), max=-1e-12)
    outputs_in = (2 * c_) / denom * in_w + in_cw
    return torch.where(inside, outputs_in, inputs)


# ── stochastic duration predictor (reverse/inference path) ──────────────


def _conv_flow_reverse(flow: Params, cfg: VITSConfig, z: torch.Tensor, mask: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """ConvFlow inverse: z [b, t, 2]; condition g [b, t, filter]."""
    z0, z1 = z[..., :1], z[..., 1:]
    h = conv1d(flow["pre"], z0)
    h = _dds_conv(flow["convs"], h, mask, cfg.dp_kernel, g=g)
    h = conv1d(flow["proj"], h) * mask[..., None]
    bins = cfg.dp_bins
    root = math.sqrt(cfg.dp_filter)
    uw = div_const(h[..., :bins], root)
    uh = div_const(h[..., bins:2 * bins], root)
    ud = h[..., 2 * bins:]
    z1_new = _rqs_inverse(z1[..., 0], uw, uh, ud, cfg.dp_tail_bound)[..., None]
    return torch.cat([z0, z1_new * mask[..., None]], dim=-1)


def duration_log_w(params: Params, cfg: VITSConfig, x_enc: torch.Tensor, mask: torch.Tensor,
                   g: Optional[torch.Tensor], noise: torch.Tensor) -> torch.Tensor:
    """SDP reverse pass → log-durations [b, t]. ``noise`` [b, t, 2] is the
    flows' input, already scaled by ``noise_w`` (JAX: ``normal ·
    noise_scale`` from its key, or its ``noise`` argument as given)."""
    dp = params["dp"]
    h = conv1d(dp["pre"], x_enc)
    if g is not None and "cond" in dp:
        h = h + conv1d(dp["cond"], g)
    h = _dds_conv(dp["convs"], h, mask, cfg.dp_kernel)
    h = conv1d(dp["proj"], h) * mask[..., None]

    z = noise.to(h.dtype) * mask[..., None]
    # the flows are stored forward [EA, CF_0, …, CF_{n-1}] with a Flip after
    # each CF; inference runs Flip, CF_{n-1}, …, Flip, CF_1, then CF_0's Flip
    # alone (CF_0 is dropped, "remove a useless vflow"), then EA
    for i in range(cfg.dp_flows - 1, 0, -1):
        z = z.flip(-1)                        # Flip (reverse of forward)
        z = _conv_flow_reverse(dp["flows"][i], cfg, z, mask, h)
    z = z.flip(-1)                            # CF_0's Flip (CF_0 dropped)
    ea = dp["affine"]                         # ElementwiseAffine reverse
    z = (z - ea["m"]) * torch.exp(-ea["logs"]) * mask[..., None]
    return z[..., 0]


# ── residual coupling flow (WaveNet) ─────────────────────────────────────


def _wn(params: Params, x: torch.Tensor, mask: torch.Tensor,
        g_cond: Optional[torch.Tensor], hidden: int) -> torch.Tensor:
    """WaveNet stack: gated units, shared cond projection, skip sum."""
    output = torch.zeros_like(x)
    n = len(params["in_layers"])
    for i in range(n):
        x_in = conv1d(params["in_layers"][i], x)
        if g_cond is not None:
            x_in = x_in + g_cond[..., 2 * hidden * i: 2 * hidden * (i + 1)]
        acts = torch.tanh(x_in[..., :hidden]) * torch.sigmoid(x_in[..., hidden:])
        res_skip = conv1d(params["res_skip_layers"][i], acts)
        if i < n - 1:
            x = (x + res_skip[..., :hidden]) * mask[..., None]
            output = output + res_skip[..., hidden:]
        else:
            output = output + res_skip
    return output * mask[..., None]


def _coupling_reverse(flow: Params, cfg: VITSConfig, x: torch.Tensor, mask: torch.Tensor,
                      g: Optional[torch.Tensor]) -> torch.Tensor:
    half = cfg.latent_dim // 2
    x0, x1 = x[..., :half], x[..., half:]
    h = conv1d(flow["pre"], x0) * mask[..., None]
    g_cond = None
    if g is not None and "cond_layer" in flow["enc"]:
        g_cond = conv1d(flow["enc"]["cond_layer"], g)
    h = _wn(flow["enc"], h, mask, g_cond, cfg.flow_hidden)
    m = conv1d(flow["post"], h) * mask[..., None]
    x1 = (x1 - m) * mask[..., None]           # mean-only coupling
    return torch.cat([x0, x1], dim=-1)


def _flow_inverse(params: Params, cfg: VITSConfig, z: torch.Tensor, mask: torch.Tensor,
                  g: Optional[torch.Tensor]) -> torch.Tensor:
    """Inverse of [Coupling, Flip] × n (Flip reverses channels)."""
    for flow in reversed(params["flows"]):
        z = z.flip(-1)                        # undo the forward Flip
        z = _coupling_reverse(flow, cfg, z, mask, g)
    return z


# ── init ────────────────────────────────────────────────────────────────


def _ln_init(c: int, device) -> Params:
    return {"g": torch.ones((c,), device=device), "b": torch.zeros((c,), device=device)}


def _normal(shape, scale: float, gen, device, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def _init_dds(channels: int, kernel: int, n_layers: int, gen, device, dtype) -> Params:
    kw = dict(generator=gen, device=device, dtype=dtype)
    return {"layers": [{
        "sep": {"w": _normal((kernel, 1, channels), 1 / math.sqrt(kernel), gen, device, dtype),
                "b": torch.zeros((channels,), dtype=dtype, device=device)},
        "norm1": _ln_init(channels, device),
        "pw": conv1d_init(1, channels, channels, **kw),
        "norm2": _ln_init(channels, device),
    } for _ in range(n_layers)]}


def _zeros_conv(c_in: int, c_out: int, device, dtype) -> Params:
    return {"w": torch.zeros((1, c_in, c_out), dtype=dtype, device=device),
            "b": torch.zeros((c_out,), dtype=dtype, device=device)}


def init_vits(cfg: VITSConfig, *, generator: Optional[torch.Generator] = None,
              device="cpu") -> Params:
    """Random weights of the JAX tree's structure, shapes and init laws
    (``init_vits``), drawn from ``generator``: the dp flows' ``proj``, the
    couplings' ``post`` and the affine ``m``/``logs`` start at zero (the
    published init: identity flows)."""
    dt = cfg.dtype
    kw = dict(generator=generator, device=device, dtype=dt)
    d, gin = cfg.d_model, cfg.speaker_dim
    params: Params = {
        "emb": _normal((cfg.n_phones, d), d ** -0.5, generator, device, dt),
        "enc_layers": [],
        "proj": conv1d_init(1, d, 2 * cfg.latent_dim, **kw),
        "vocoder": init_vocoder(cfg.vocoder, generator=generator, device=device),
    }
    speakers = cfg.n_speakers > 1 and gin
    if speakers:
        params["emb_g"] = _normal((cfg.n_speakers, gin), 0.02, generator, device, dt)
        params["voc_cond"] = conv1d_init(1, gin, cfg.vocoder_channels, **kw)
    d_head = d // cfg.n_heads
    rel = (1, 2 * cfg.rel_window + 1, d_head)
    for _ in range(cfg.n_layers):
        params["enc_layers"].append({
            "conv_q": conv1d_init(1, d, d, **kw),
            "conv_k": conv1d_init(1, d, d, **kw),
            "conv_v": conv1d_init(1, d, d, **kw),
            "conv_o": conv1d_init(1, d, d, **kw),
            "emb_rel_k": _normal(rel, d_head ** -0.5, generator, device, dt),
            "emb_rel_v": _normal(rel, d_head ** -0.5, generator, device, dt),
            "norm1": _ln_init(d, device),
            "ffn1": conv1d_init(cfg.ff_kernel, d, cfg.d_ff, **kw),
            "ffn2": conv1d_init(cfg.ff_kernel, cfg.d_ff, d, **kw),
            "norm2": _ln_init(d, device),
        })
    # stochastic duration predictor
    dp: Params = {
        "pre": conv1d_init(1, d, cfg.dp_filter, **kw),
        "convs": _init_dds(cfg.dp_filter, cfg.dp_kernel, 3, generator, device, dt),
        "proj": conv1d_init(1, cfg.dp_filter, cfg.dp_filter, **kw),
        "affine": {"m": torch.zeros((2,), device=device),
                   "logs": torch.zeros((2,), device=device)},
        "flows": [],
    }
    if speakers:
        dp["cond"] = conv1d_init(1, gin, cfg.dp_filter, **kw)
    for _ in range(cfg.dp_flows):
        dp["flows"].append({
            "pre": conv1d_init(1, 1, cfg.dp_filter, **kw),
            "convs": _init_dds(cfg.dp_filter, cfg.dp_kernel, 3, generator, device, dt),
            "proj": _zeros_conv(cfg.dp_filter, 3 * cfg.dp_bins - 1, device, dt),
        })
    params["dp"] = dp
    # residual coupling flows
    half, hid = cfg.latent_dim // 2, cfg.flow_hidden
    params["flows"] = []
    for _ in range(cfg.n_flows):
        enc: Params = {"in_layers": [], "res_skip_layers": []}
        for i in range(cfg.flow_wn_layers):
            enc["in_layers"].append(conv1d_init(cfg.flow_kernel, hid, 2 * hid, **kw))
            out_ch = 2 * hid if i < cfg.flow_wn_layers - 1 else hid
            enc["res_skip_layers"].append(conv1d_init(1, hid, out_ch, **kw))
        if speakers:
            enc["cond_layer"] = conv1d_init(1, gin, 2 * hid * cfg.flow_wn_layers, **kw)
        params["flows"].append({"pre": conv1d_init(1, half, hid, **kw), "enc": enc,
                                "post": _zeros_conv(hid, half, device, dt)})
    return params


# ── length regulation ───────────────────────────────────────────────────


def _length_regulate(h: torch.Tensor, durations: torch.Tensor,
                     max_frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand phone-level features to frames: frame f takes the phone whose
    cumulative end first passes f (the count of ends <= f, clipped), and
    frames past the total are masked."""
    cum = torch.cumsum(durations, dim=1)                     # [b, L]
    frame_idx = torch.arange(max_frames, device=h.device, dtype=cum.dtype)
    phone_idx = torch.searchsorted(cum.contiguous(),
                                   frame_idx.expand(cum.shape[0], -1).contiguous(), right=True)
    phone_idx = torch.clamp(phone_idx, 0, h.shape[1] - 1)
    frames = torch.gather(h, 1, phone_idx[..., None].expand(-1, -1, h.shape[2]))
    frame_mask = (frame_idx[None, :] < cum[:, -1:]).to(h.dtype)
    return frames * frame_mask[..., None], frame_mask


# ── public inference ────────────────────────────────────────────────────


def _speaker_vec(params: Params, speaker_id: torch.Tensor) -> Optional[torch.Tensor]:
    """``emb_g[speaker_id]`` as [b, 1, gin]: it broadcasts over time, and a
    1×1 conv of the broadcast vector is the broadcast of its conv."""
    if "emb_g" not in params:
        return None
    return params["emb_g"][speaker_id.long()][:, None, :]


def encode_and_durations(params: Params, cfg: VITSConfig, phones: torch.Tensor,
                         phone_lengths: torch.Tensor, speaker_id: torch.Tensor,
                         noise: torch.Tensor, *,
                         length_scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage A: text encoding + stochastic durations → (stats [b, max_phones,
    2·latent] = m_p ‖ logs_p, durations [b, max_phones] int32).

    ``phones`` [b, max_phones] (padded with 0), ``phone_lengths`` [b],
    ``speaker_id`` [b], ``noise`` [b, max_phones, 2] scaled by ``noise_w``.
    Durations: ``clip(ceil(exp(logw) · mask · length_scale), 1, 80) ·
    mask``."""
    max_p = phones.shape[1]
    mask = (torch.arange(max_p, device=phones.device)[None, :]
            < phone_lengths[:, None]).to(cfg.dtype)
    x = _encoder(params, cfg, phones.long(), mask)
    stats = conv1d(params["proj"], x) * mask[..., None]
    logw = duration_log_w(params, cfg, x, mask, _speaker_vec(params, speaker_id), noise)
    w = torch.exp(logw) * mask * float(length_scale)
    durations = torch.clamp(torch.ceil(w), 1.0, 80.0) * mask
    return stats, durations.to(torch.int32)


def decode_frames(params: Params, cfg: VITSConfig, stats: torch.Tensor,
                  durations: torch.Tensor, eps: torch.Tensor, *, max_frames: int,
                  speaker_id: Optional[torch.Tensor] = None,
                  noise_scale: float = 0.667) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage B: expand → prior sample → flow inverse → vocoder →
    (audio [b, max_frames · hop], sample_lengths [b] int32). ``eps`` [b,
    max_frames, latent] is standard normal; ``sample_lengths = min(Σ
    durations, max_frames) · hop``."""
    frames, frame_mask = _length_regulate(stats, durations, max_frames)
    m_p = frames[..., :cfg.latent_dim]
    logs_p = torch.clamp(frames[..., cfg.latent_dim:], -6.0, 2.0)
    z_p = m_p + eps.to(m_p.dtype) * torch.exp(logs_p) * noise_scale
    g = _speaker_vec(params, speaker_id) if speaker_id is not None else None
    z = _flow_inverse(params, cfg, z_p * frame_mask[..., None], frame_mask, g)
    cond = None
    if g is not None and "voc_cond" in params:
        cond = conv1d(params["voc_cond"], g)[:, 0, :]          # [b, base_ch]
    audio = apply_vocoder(params["vocoder"], cfg.vocoder, z * frame_mask[..., None], cond=cond)
    sample_lengths = (torch.clamp(durations.sum(1), max=max_frames)
                      * cfg.vocoder.hop).to(torch.int32)
    return audio, sample_lengths


def synthesize(params: Params, cfg: VITSConfig, phones: torch.Tensor,
               phone_lengths: torch.Tensor, speaker_id: torch.Tensor, noise: torch.Tensor,
               eps: torch.Tensor, *, length_scale: float = 1.0,
               noise_scale: float = 0.667) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage A + stage B at ``cfg.max_frames`` (``eps`` [b, max_frames,
    latent])."""
    stats, durations = encode_and_durations(params, cfg, phones, phone_lengths, speaker_id,
                                            noise, length_scale=length_scale)
    return decode_frames(params, cfg, stats, durations, eps, max_frames=cfg.max_frames,
                         speaker_id=speaker_id, noise_scale=noise_scale)


__all__ = ["VITSConfig", "init_vits", "encode_and_durations", "decode_frames", "synthesize",
           "duration_log_w"]
