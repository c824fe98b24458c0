"""1-D convolution building blocks (counterpart of the parts of
``vocalie_tts_tpu/models/common/convnets.py`` that HiFT, the conformer,
the CFM decoder and the HiFi-GAN vocoder use).

The public layout is the JAX package's: activations ``[batch, time,
channels]``, conv kernels ``[kernel, c_in, c_out]``. The re-layout to
PyTorch's ``[batch, channels, time]`` / ``[c_out, c_in, kernel]`` happens
inside these functions only.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def conv1d_init(kernel: int, c_in: int, c_out: int, *, generator: Optional[torch.Generator] = None,
                device="cpu", dtype=torch.float32) -> Params:
    scale = 1.0 / math.sqrt(kernel * c_in)
    w = (torch.rand((kernel, c_in, c_out), generator=generator, device=device) * 2 - 1) * scale
    return {"w": w.to(dtype), "b": torch.zeros((c_out,), dtype=dtype, device=device)}


def _same_pad(t: int, kernel: int, stride: int, dilation: int) -> Tuple[int, int]:
    """XLA's "SAME" padding (output length ceil(t / stride))."""
    eff = (kernel - 1) * dilation + 1
    out = -(-t // stride)
    total = max((out - 1) * stride + eff - t, 0)
    return total // 2, total - total // 2


def conv1d(
    params: Params,
    x: torch.Tensor,               # [b, t, c_in]
    *,
    stride: int = 1,
    dilation: int = 1,
    padding: Union[str, Tuple[int, int]] = "SAME",
) -> torch.Tensor:
    w = params["w"]
    kernel = w.shape[0]
    pad = _same_pad(x.shape[1], kernel, stride, dilation) if padding == "SAME" else padding
    xt = F.pad(x.transpose(1, 2), pad)
    out = F.conv1d(xt, w.to(x.dtype).permute(2, 1, 0), stride=stride, dilation=dilation)
    return out.transpose(1, 2) + params["b"].to(x.dtype)


def conv1d_transpose(params: Params, x: torch.Tensor, *, stride: int) -> torch.Tensor:
    """The JAX lhs-dilated conv (padding k-1 each side) cropped to
    exactly t*stride, centered: a transposed conv with the kernel
    flipped along time."""
    w = params["w"]
    out = F.conv_transpose1d(
        x.transpose(1, 2), w.to(x.dtype).flip(0).permute(1, 2, 0), stride=stride
    ).transpose(1, 2)
    t_out = x.shape[1] * stride
    start = (out.shape[1] - t_out) // 2
    return out[:, start : start + t_out] + params["b"].to(x.dtype)


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32, returned in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


# ── HiFi-GAN-style residual block (multi-receptive-field) ───────────────


def resblock_init(channels: int, kernel: int, dilations: Sequence[int], *,
                  generator: Optional[torch.Generator] = None, device="cpu",
                  dtype=torch.float32) -> Params:
    # dilations are static config, passed to resblock_apply
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "convs1": [conv1d_init(kernel, channels, channels, **kw) for _ in dilations],
        "convs2": [conv1d_init(kernel, channels, channels, **kw) for _ in dilations],
    }


def resblock_apply(params: Params, x: torch.Tensor, dilations: Sequence[int]) -> torch.Tensor:
    for c1, c2, dil in zip(params["convs1"], params["convs2"], dilations):
        h = conv1d(c1, leaky_relu(x), dilation=int(dil))
        h = conv1d(c2, leaky_relu(h), dilation=1)
        x = x + h
    return x


__all__ = ["conv1d_init", "conv1d", "conv1d_transpose", "leaky_relu", "layer_norm",
           "resblock_init", "resblock_apply"]
