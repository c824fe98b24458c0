"""HiFT generator: NSF-HiFiGAN with an ISTFT head (counterpart of
``vocalie_tts_tpu/models/common/hift.py``).

Conv F0 predictor → harmonic NSF source → tiny STFT (n_fft 16, hop 4)
fused into each HiFi-GAN upsample stage → log-magnitude + phase head →
ISTFT. The source's random terms are explicit inputs: ``rand_ini``
(uniform phase offsets) and ``source_normal`` (standard normal noise);
leaving both ``None`` gives the deterministic variant, as ``rng=None``
does in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from vocalie_tts_tpu_torch.models.common.convnets import (
    conv1d,
    conv1d_init,
    conv1d_transpose,
    leaky_relu,
)
from vocalie_tts_tpu_torch.models.common.unet2d import dense, dense_init

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class HiFTConfig:
    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 24000
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: Tuple[int, ...] = (8, 8)
    upsample_kernels: Tuple[int, ...] = (16, 16)
    istft_n_fft: int = 16
    istft_hop: int = 4
    resblock_kernels: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    source_resblock_kernels: Tuple[int, ...] = (7, 11)
    source_resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 2
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99
    f0_cond_channels: int = 512
    f0_layers: int = 5
    #: compute dtype of the generator conv stack; the f0 predictor, NSF
    #: source and STFT/ISTFT head always run f32
    dtype: torch.dtype = torch.float32

    @property
    def hop(self) -> int:
        out = self.istft_hop
        for r in self.upsample_rates:
            out *= r
        return out

    @property
    def n_bins(self) -> int:
        return self.istft_n_fft // 2 + 1


def _snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation: x + sin²(αx)/α, learnable per-channel α."""
    a = alpha.to(x.dtype)
    return x + torch.sin(a * x) ** 2 / (a + 1e-9)


def _snake_resblock(p: Params, x: torch.Tensor, dilations) -> torch.Tensor:
    for i, dil in enumerate(dilations):
        h = conv1d(p["convs1"][i], _snake(x, p["alphas1"][i]), dilation=int(dil))
        h = conv1d(p["convs2"][i], _snake(h, p["alphas2"][i]), dilation=1)
        x = x + h
    return x


def _snake_resblock_init(channels, kernel, dilations, **kw):
    dev = kw["device"]
    return {
        "convs1": [conv1d_init(kernel, channels, channels, **kw) for _ in dilations],
        "convs2": [conv1d_init(kernel, channels, channels, **kw) for _ in dilations],
        "alphas1": [torch.ones((channels,), device=dev) for _ in dilations],
        "alphas2": [torch.ones((channels,), device=dev) for _ in dilations],
    }


def init_hift(cfg: HiFTConfig, *, generator=None, device="cpu") -> Params:
    kw = {"generator": generator, "device": device}
    ch_in, condnet = cfg.in_channels, []
    for _ in range(cfg.f0_layers):
        condnet.append(conv1d_init(3, ch_in, cfg.f0_cond_channels, **kw))
        ch_in = cfg.f0_cond_channels
    p: Params = {
        "f0_predictor": {"condnet": condnet,
                         "classifier": dense_init(cfg.f0_cond_channels, 1, **kw)},
        "m_source": {"l_linear": dense_init(cfg.nb_harmonics + 1, 1, **kw)},
        "conv_pre": conv1d_init(7, cfg.in_channels, cfg.base_channels, **kw),
    }
    ups, source_downs, source_resblocks, resblocks = [], [], [], []
    ch = cfg.base_channels
    n_stft = cfg.istft_n_fft + 2
    for i, (rate, kern) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernels)):
        ch_out = ch // 2
        ups.append(conv1d_init(kern, ch, ch_out, **kw))
        down = math.prod(cfg.upsample_rates[i + 1:])
        source_downs.append(conv1d_init(1 if down == 1 else down * 2, n_stft, ch_out, **kw))
        source_resblocks.append(_snake_resblock_init(
            ch_out, cfg.source_resblock_kernels[i], cfg.source_resblock_dilations[i], **kw))
        resblocks.append([_snake_resblock_init(ch_out, rk, dil, **kw)
                          for rk, dil in zip(cfg.resblock_kernels, cfg.resblock_dilations)])
        ch = ch_out
    p.update(ups=ups, source_downs=source_downs, source_resblocks=source_resblocks,
             resblocks=resblocks, conv_post=conv1d_init(7, ch, n_stft, **kw))
    return p


# ── F0 → harmonic source ────────────────────────────────────────────────


def predict_f0(p: Params, cfg: HiFTConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel [b, t, n_mels] → f0 [b, t] (Hz, non-negative)."""
    x = mel
    for layer in p["f0_predictor"]["condnet"]:
        x = F.elu(conv1d(layer, x))
    return torch.abs(dense(p["f0_predictor"]["classifier"], x)[..., 0])


def harmonic_source(
    p: Params, cfg: HiFTConfig, f0: torch.Tensor,
    rand_ini: Optional[torch.Tensor] = None,       # [b, H+1] uniform in [0, 1)
    source_normal: Optional[torch.Tensor] = None,  # [b, t*hop, H+1] standard normal
) -> torch.Tensor:
    """f0 [b, t_mel] → NSF source [b, t_mel*hop] (sines + uv-gated noise),
    cumulative phase with the published integer-shift trick."""
    f0_up = torch.repeat_interleave(f0, cfg.hop, dim=1)
    harmonics = torch.arange(1, cfg.nb_harmonics + 2, dtype=torch.float32, device=f0.device)
    fn = f0_up[..., None] * harmonics
    rad = torch.remainder(fn / cfg.sampling_rate, 1.0)
    if rand_ini is not None:
        ini = rand_ini.float().clone()
        ini[:, 0] = 0.0
        rad = rad.clone()
        rad[:, 0, :] = rad[:, 0, :] + ini
    cum = torch.remainder(torch.cumsum(rad, dim=1), 1.0)
    wrap = torch.cat([torch.zeros_like(cum[:, :1]), (cum[:, 1:] - cum[:, :-1] < 0).to(rad.dtype)],
                     dim=1)
    phase = torch.cumsum(rad - wrap, dim=1)
    sines = torch.sin(2.0 * math.pi * phase) * cfg.nsf_alpha
    uv = (f0_up > cfg.nsf_voiced_threshold).float()[..., None]
    sine_waves = sines * uv
    if source_normal is not None:
        noise_amp = uv * cfg.nsf_sigma + (1.0 - uv) * cfg.nsf_alpha / 3.0
        sine_waves = sine_waves + noise_amp * source_normal.float()
    return torch.tanh(dense(p["m_source"]["l_linear"], sine_waves))[..., 0]


# ── tiny STFT / ISTFT (n_fft = 16) ──────────────────────────────────────


def _hann(n: int, device) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * i / n)


def _stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[b, T] → [b, frames, n_fft+2] (real ‖ imag), center/reflect."""
    half = n_fft // 2
    x = torch.cat([x[:, 1 : half + 1].flip(1), x, x[:, -half - 1 : -1].flip(1)], dim=1)
    win = _hann(n_fft, x.device)
    n = torch.arange(n_fft, dtype=torch.float32, device=x.device)
    k = torch.arange(n_fft // 2 + 1, dtype=torch.float32, device=x.device)
    ang = 2.0 * math.pi * k[:, None] * n[None, :] / n_fft
    basis = torch.cat([(torch.cos(ang) * win).T, (-torch.sin(ang) * win).T], dim=1)
    return torch.matmul(x.unfold(1, n_fft, hop), basis)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """out[t] = Σ_f frames[f, t - hop*f] → [b, (frames-1)*hop + n_fft]."""
    b, n_frames, n_fft = frames.shape
    out = frames.new_zeros((b, (n_frames - 1) * hop + n_fft))
    for n in range(n_fft):
        out[:, n : n + hop * (n_frames - 1) + 1 : hop] += frames[:, :, n]
    return out


def _istft(spec_re: torch.Tensor, spec_im: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Onesided centered ISTFT. [b, frames, bins] ×2 → [b, (frames-1)*hop]."""
    dev = spec_re.device
    n = torch.arange(n_fft, dtype=torch.float32, device=dev)
    k = torch.arange(n_fft // 2 + 1, dtype=torch.float32, device=dev)
    ang = 2.0 * math.pi * k[None, :] * n[:, None] / n_fft
    w = torch.where((k == 0) | (k == n_fft // 2), 1.0, 2.0) / n_fft
    frames = torch.matmul(spec_re, (torch.cos(ang) * w).T) - torch.matmul(
        spec_im, (torch.sin(ang) * w).T)
    win = _hann(n_fft, dev)
    ola = _overlap_add(frames * win, hop)
    norm = _overlap_add((win ** 2).expand(1, frames.shape[1], n_fft), hop)
    out = ola / torch.clamp(norm, min=1e-11)
    half = n_fft // 2
    return out[:, half : out.shape[1] - half]


# ── the generator ───────────────────────────────────────────────────────


def _conv_strided(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """torch Conv1d(k=2s, stride=s, padding=s//2) for the source downs."""
    k = p["w"].shape[0]
    pad = ((k - 1) // 2, k // 2) if stride == 1 else (stride // 2, stride // 2)
    return conv1d(p, x, stride=stride, padding=pad)


@torch.no_grad()
def apply_hift(
    p: Params,
    cfg: HiFTConfig,
    mel: torch.Tensor,                              # [b, t, n_mels]
    rand_ini: Optional[torch.Tensor] = None,
    source_normal: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """mel → waveform [b, t*hop], clamped to ±audio_limit."""
    f0 = predict_f0(p, cfg, mel.float())
    source = harmonic_source(p, cfg, f0, rand_ini, source_normal)
    s_spec = _stft(source, cfg.istft_n_fft, cfg.istft_hop).to(cfg.dtype)

    x = conv1d(p["conv_pre"], mel.to(cfg.dtype))
    n_up = len(cfg.upsample_rates)
    for i, rate in enumerate(cfg.upsample_rates):
        x = leaky_relu(x, cfg.lrelu_slope)
        x = conv1d_transpose(p["ups"][i], x, stride=rate)
        if i == n_up - 1:
            x = torch.cat([x[:, 1:2, :], x], dim=1)  # reflection pad (1, 0)
        si = _conv_strided(p["source_downs"][i], s_spec, math.prod(cfg.upsample_rates[i + 1:]))
        x = x + _snake_resblock(p["source_resblocks"][i], si, cfg.source_resblock_dilations[i])
        acc = None
        for rb, dil in zip(p["resblocks"][i], cfg.resblock_dilations):
            y = _snake_resblock(rb, x, dil)
            acc = y if acc is None else acc + y
        x = acc / len(p["resblocks"][i])

    x = leaky_relu(x, 0.01)
    x = conv1d(p["conv_post"], x).float()
    bins = cfg.n_bins
    magnitude = torch.exp(torch.clamp(x[..., :bins], max=math.log(1e2)))
    phase = torch.sin(x[..., bins:])
    audio = _istft(magnitude * torch.cos(phase), magnitude * torch.sin(phase),
                   cfg.istft_n_fft, cfg.istft_hop)
    return torch.clamp(audio, -cfg.audio_limit, cfg.audio_limit)


__all__ = ["HiFTConfig", "init_hift", "apply_hift", "predict_f0", "harmonic_source"]
