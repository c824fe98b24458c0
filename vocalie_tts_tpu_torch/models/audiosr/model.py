"""AudioSR-class latent diffusion model (counterpart of
``vocalie_tts_tpu/models/audiosr/model.py``).

  input audio → 48 kHz log-mel "image" [b, T, F, 1]
    → AutoencoderKL (vae.py) → latent [b, T/4, F/4, C]
    → DDIM loop over an LDM UNet eps-denoiser (unet2d.py), conditioned on
      the low-res latent by channel concat, classifier-free guidance
      against a zeroed condition in ONE doubled-batch UNet call per step
    → VAE decode → HiFi-GAN at 48 kHz (hop 512).

The VAE and UNet compute in ``cfg.dtype`` (bf16 at serving scale); the
DDIM state and its update stay f32. The JAX package carries the bf16 loop
state flat ``[b, H·W·C]`` to keep TPU lanes dense; that is the same
arithmetic as the latent layout kept here.

The DDIM start noise is an input (the runtime draws it from a generator
seeded per dispatch), so both packages can be fed the same tensor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vocalie_tts_tpu_torch.device import div_const
from vocalie_tts_tpu_torch.models.audiosr.vae import VAEConfig, init_vae, vae_decode, vae_encode
from vocalie_tts_tpu_torch.models.common.audio import log_mel_spectrogram
from vocalie_tts_tpu_torch.models.common.unet2d import UNet2DConfig, apply_unet2d, init_unet2d
from vocalie_tts_tpu_torch.models.common.vocoder import VocoderConfig, apply_vocoder, init_vocoder

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AudioSRConfig:
    sample_rate: int = 48000
    n_fft: int = 2048
    hop: int = 512                  # 93.75 fps mel at 48 kHz
    n_mels: int = 128
    # the published AudioSR front end (librosa.filters.mel: Slaney scale
    # and norm, fmin 20)
    mel_fmin: float = 20.0
    mel_scale: str = "slaney"
    # first stage (AutoencoderKL)
    vae_base: int = 64
    vae_mult: Tuple[int, ...] = (1, 2, 4)
    vae_res_blocks: int = 2
    z_channels: int = 16
    embed_dim: int = 16
    # denoiser (LDM UNet)
    unet_channels: int = 128
    unet_mult: Tuple[int, ...] = (1, 2, 4)
    unet_res_blocks: int = 2
    unet_attn_res: Tuple[int, ...] = (4,)
    unet_heads: int = 8
    n_train_steps: int = 1000      # diffusion time discretization
    dtype: Any = torch.float32

    @property
    def vae(self) -> VAEConfig:
        return VAEConfig(in_channels=1, base_channels=self.vae_base, channel_mult=self.vae_mult,
                         num_res_blocks=self.vae_res_blocks, z_channels=self.z_channels,
                         embed_dim=self.embed_dim, dtype=self.dtype)

    @property
    def unet(self) -> UNet2DConfig:
        return UNet2DConfig(in_channels=2 * self.embed_dim,   # [x_t ‖ lowres cond]
                            model_channels=self.unet_channels, out_channels=self.embed_dim,
                            num_res_blocks=self.unet_res_blocks,
                            attention_resolutions=self.unet_attn_res,
                            channel_mult=self.unet_mult, num_heads=self.unet_heads,
                            dtype=self.dtype)

    @property
    def latent_stride(self) -> int:
        """Total time downsampling: VAE stride × UNet depth alignment."""
        return 2 ** (len(self.vae_mult) - 1) * 2 ** (len(self.unet_mult) - 1)

    @property
    def vocoder(self) -> VocoderConfig:
        # hop 512 @ 48 kHz; compute dtype follows the serving dtype
        return VocoderConfig(n_mels=self.n_mels, base_channels=512, upsample_rates=(8, 8, 4, 2),
                             upsample_kernels=(16, 16, 8, 4), dtype=self.dtype)


def init_audiosr(cfg: AudioSRConfig, *, generator: Optional[torch.Generator] = None,
                 device="cpu") -> Params:
    kw = dict(generator=generator, device=device)
    return {"vae": init_vae(cfg.vae, **kw), "unet": init_unet2d(cfg.unet, **kw),
            "vocoder": init_vocoder(cfg.vocoder, **kw)}


def denoise_eps(params: Params, cfg: AudioSRConfig, x_t: torch.Tensor, cond: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
    """eps prediction conditioned on the low-res latent (channel concat)."""
    return apply_unet2d(params["unet"], cfg.unet, torch.cat([x_t, cond], dim=-1), t)


def _alpha_bar(t_frac: torch.Tensor) -> torch.Tensor:
    """Cosine schedule ᾱ(t) (t_frac ∈ [0,1])."""
    return torch.cos(div_const(t_frac + 0.008, 1.008) * math.pi / 2) ** 2


def ddim_times(ddim_steps: int, device="cpu") -> torch.Tensor:
    """``jnp.linspace(1, 0, steps + 1)`` as XLA computes it in f32:
    ``1 − i·(1/steps)``, the last point exactly 0."""
    i = np.arange(ddim_steps + 1, dtype=np.float32)
    ts = np.float32(1.0) - i * (np.float32(1.0) / np.float32(ddim_steps))
    ts[-1] = 0.0
    return torch.from_numpy(ts).to(device)


def ddim_super_resolution(
    params: Params,
    cfg: AudioSRConfig,
    mel_lowres: torch.Tensor,           # [b, frames, n_mels] log-mel of the input
    noise: torch.Tensor,                # [b, frames/4, n_mels/4, embed] f32
    *,
    ddim_steps: int,
    guidance_scale: float,
) -> torch.Tensor:
    """Run the DDIM loop, return the SR mel [b, frames, n_mels] (f32)."""
    cdt = cfg.dtype
    image = mel_lowres[..., None].to(cdt)                   # [b, T, F, 1]
    cond = vae_encode(params["vae"], cfg.vae, image)       # [b, T', F', C]
    b = cond.shape[0]
    x = noise.float()
    x2_cond = torch.cat([cond, torch.zeros_like(cond)], dim=0).to(cdt)
    ts = ddim_times(ddim_steps, x.device)
    alphas = _alpha_bar(ts)
    t_vecs = ts * cfg.n_train_steps
    one = torch.ones((), device=x.device)
    for i in range(ddim_steps):
        a_now, a_next = alphas[i], alphas[i + 1]
        t_vec = t_vecs[i].expand(2 * b)
        x2 = torch.cat([x, x], dim=0).to(cdt)
        eps2 = denoise_eps(params, cfg, x2, x2_cond, t_vec).float()
        eps_c, eps_u = eps2[:b], eps2[b:]
        eps = eps_u + guidance_scale * (eps_c - eps_u)
        # XLA computes the JAX package's ``/ sqrt(a)`` as ``* rsqrt(a)``
        x0 = (x - torch.sqrt(one - a_now) * eps) * torch.rsqrt(torch.clamp(a_now, min=1e-8))
        x0 = torch.clamp(x0, -10.0, 10.0)
        x = torch.sqrt(a_next) * x0 + torch.sqrt(one - a_next) * eps
    return vae_decode(params["vae"], cfg.vae, x.to(cdt))[..., 0].float()


def enhance_window(
    params: Params,
    cfg: AudioSRConfig,
    audio_48k: torch.Tensor,            # [b, T] at 48 kHz, f32 or int16 PCM
    noise: torch.Tensor,                # the DDIM start noise, ``latent_shape``
    *,
    ddim_steps: int,
    guidance_scale: float,
) -> torch.Tensor:
    """Audio window → SR audio window (same length); int16 PCM when
    ``cfg.dtype`` is not f32, f32 otherwise."""
    if not torch.is_floating_point(audio_48k):
        audio_48k = div_const(audio_48k.float(), 32767.0)
    else:
        audio_48k = audio_48k.float()
    mel = log_mel_spectrogram(audio_48k, sr=cfg.sample_rate, n_fft=cfg.n_fft, hop=cfg.hop,
                              n_mels=cfg.n_mels, fmin=cfg.mel_fmin, scale=cfg.mel_scale)
    # align frames to the latent stride: a hop-multiple window gives
    # stride·k + 1 centred frames, and the lone boundary frame is trimmed;
    # other remainders pad
    frames = mel.shape[1]
    rem = frames % cfg.latent_stride
    if rem == 1 and frames > 1:
        mel = mel[:, : frames - 1]
    elif rem:
        mel = F.pad(mel, (0, 0, 0, cfg.latent_stride - rem))
    sr_mel = ddim_super_resolution(params, cfg, mel, noise, ddim_steps=ddim_steps,
                                   guidance_scale=guidance_scale)
    audio = apply_vocoder(params["vocoder"], cfg.vocoder, sr_mel)
    audio = audio[:, : audio_48k.shape[1]]
    if cfg.dtype != torch.float32:
        audio = torch.clamp(audio, -1.0, 1.0)
        audio = torch.round(audio * 32767.0).to(torch.int16)
    return audio


def latent_shape(cfg: AudioSRConfig, batch: int, n_samples: int) -> Tuple[int, int, int, int]:
    """The DDIM noise shape of ``batch`` windows of ``n_samples``."""
    frames = n_samples // cfg.hop + 1
    rem = frames % cfg.latent_stride
    if rem == 1 and frames > 1:
        frames -= 1
    elif rem:
        frames += cfg.latent_stride - rem
    ds = 2 ** (len(cfg.vae_mult) - 1)
    return (batch, frames // ds, cfg.n_mels // ds, cfg.embed_dim)


__all__ = ["AudioSRConfig", "init_audiosr", "denoise_eps", "ddim_super_resolution",
           "enhance_window", "latent_shape"]
