"""HiFi-GAN-class neural vocoder (generator), counterpart of
``vocalie_tts_tpu/models/common/vocoder.py``.

mel [batch, frames, n_mels] → waveform [batch, frames * prod(rates)]:
multi-receptive-field resblocks after each transposed-conv upsample stage
(the HiFi-GAN V1 topology).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from vocalie_tts_tpu_torch.device import div_const
from vocalie_tts_tpu_torch.models.common.convnets import (
    conv1d,
    conv1d_init,
    conv1d_transpose,
    leaky_relu,
    resblock_apply,
    resblock_init,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    n_mels: int = 80
    base_channels: int = 512
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernels: Tuple[int, ...] = (16, 16, 4, 4)
    resblock_kernels: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    dtype: Any = torch.float32

    @property
    def hop(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out


def init_vocoder(cfg: VocoderConfig, *, generator: Optional[torch.Generator] = None,
                 device="cpu") -> Params:
    kw = dict(generator=generator, device=device, dtype=cfg.dtype)
    params: Params = {"pre": conv1d_init(7, cfg.n_mels, cfg.base_channels, **kw),
                      "ups": [], "resblocks": []}   # resblocks: [stage][kernel]
    ch = cfg.base_channels
    for rate, kern in zip(cfg.upsample_rates, cfg.upsample_kernels):
        ch_out = ch // 2
        params["ups"].append(conv1d_init(kern, ch, ch_out, **kw))
        params["resblocks"].append([resblock_init(ch_out, rk, dil, **kw) for rk, dil in
                                    zip(cfg.resblock_kernels, cfg.resblock_dilations)])
        ch = ch_out
    params["post"] = conv1d_init(7, ch, 1, **kw)
    return params


def apply_vocoder(params: Params, cfg: VocoderConfig, mel: torch.Tensor,
                  cond: Optional[torch.Tensor] = None,
                  stage_conds: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """mel [batch, frames, n_mels] → audio [batch, frames * hop].

    ``cond`` [batch, base_channels] is the speaker-conditioning vector the
    published generator adds after the stem conv (its ``cond`` 1×1
    projection lives with the caller's params: VITS's ``voc_cond``).
    ``stage_conds`` (one [batch, ch_i] vector per upsample stage) is added
    right after each upsample conv, before the MRF resblocks."""
    x = conv1d(params["pre"], mel.to(cfg.dtype))
    if cond is not None:
        x = x + cond[:, None, :].to(x.dtype)
    for i, rate in enumerate(cfg.upsample_rates):
        x = leaky_relu(x)
        x = conv1d_transpose(params["ups"][i], x, stride=rate)
        if stage_conds is not None:
            x = x + stage_conds[i][:, None, :].to(x.dtype)
        acc = None
        for rb, dil in zip(params["resblocks"][i], cfg.resblock_dilations):
            y = resblock_apply(rb, x, dil)
            acc = y if acc is None else acc + y
        x = div_const(acc, len(params["resblocks"][i]))
    # the canonical generator's final activation uses the framework
    # default slope (0.01), not the 0.1 used elsewhere
    x = leaky_relu(x, 0.01)
    x = conv1d(params["post"], x)
    return torch.tanh(x)[..., 0]


__all__ = ["VocoderConfig", "init_vocoder", "apply_vocoder"]
