"""Shared pieces of the AR runtimes (counterpart of the parts of
``vocalie_tts_tpu/models/common/ar_runtime.py`` the Chatterbox-class
path uses): the decode-path env knobs, the runtime weight transforms
and the int16 PCM wire format."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from vocalie_tts_tpu_torch.utils.env import bool_env, tri_env


def apply_runtime_env(cfg):
    """Apply the decode-path env knobs to a family config dataclass, as
    ``vocalie_tts_tpu/models/common/ar_runtime.py:29-54`` does:

    - ``VOCALIE_KV_INT8=1``: int8 KV cache;
    - ``VOCALIE_DECODE_KERNEL``: decode-attention kernel, on by default
      with the int8 cache (``=0`` opts out);
    - ``VOCALIE_DENSE_KERNEL``: the int8-native dense decode kernels, on
      by default with ``VOCALIE_WEIGHT_INT8=1`` (``=0`` opts out, ``=1``
      forces the flag, inert without int8 weights).
    """
    kv_int8 = bool_env("VOCALIE_KV_INT8")
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    kernel_env = tri_env("VOCALIE_DECODE_KERNEL")
    if kernel_env is True or (kv_int8 and kernel_env is not False):
        cfg = dataclasses.replace(cfg, decode_kernel=True)
    dense_env = tri_env("VOCALIE_DENSE_KERNEL")
    if dense_env is True or (bool_env("VOCALIE_WEIGHT_INT8") and dense_env is not False):
        cfg = dataclasses.replace(cfg, dense_kernel=True)
    return cfg


def maybe_quantize_lm(bundle: Dict, key: str = "lm") -> Dict:
    """Runtime weight transforms of the transformer inside a bundle:
    ``VOCALIE_WEIGHT_INT8=1`` (int8 weights, per-channel scales), then
    fused q/k/v and gate/up, the only layout the port's forward takes."""
    from vocalie_tts_tpu_torch.models.common.transformer import (
        fuse_decode_weights,
        quantize_weights_int8,
    )

    if key not in bundle:
        return bundle
    lm = bundle[key]
    if bool_env("VOCALIE_WEIGHT_INT8"):
        lm = quantize_weights_int8(lm)
    return {**bundle, key: fuse_decode_weights(lm)}


def to_pcm16_wire(audio: torch.Tensor) -> torch.Tensor:
    """Device-side int16 PCM: the output file's precision, half the bytes
    of f32 on the way to the host."""
    return torch.round(torch.clamp(audio, -1.0, 1.0) * 32767.0).to(torch.int16)


def from_pcm16_wire(arr) -> np.ndarray:
    """Host-side inverse of to_pcm16_wire → float32 in [-1, 1]."""
    a = np.asarray(arr)
    if a.dtype == np.int16:
        return a.astype(np.float32) / 32767.0
    return a.astype(np.float32)


__all__ = ["apply_runtime_env", "maybe_quantize_lm", "to_pcm16_wire", "from_pcm16_wire"]
