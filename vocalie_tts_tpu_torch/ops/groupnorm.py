"""Fused GroupNorm (kernel B13) and its plain version.

Counterpart of ``vocalie_tts_tpu/ops/groupnorm.py::group_norm_fused``:

    [optional] x += e          (FiLM row [B, C], added pre-norm in f32)
    per-group f32 moments over spatial × C/G
    y = x·(inv·γ) + (β − mean·inv·γ)
    [optional] y = silu(y)
    cast to x's dtype

On a CUDA tensor the wrapper launches ``csrc/groupnorm.cu`` (two launches:
moments by chunk, then the apply) for every shape; on a CPU tensor it runs
:func:`group_norm_fused_plain`, which follows the JAX package's XLA branch
``_gn_xla`` step by step. The JAX wrapper's VMEM batch-block picker and its
C % 128 gate are TPU tiling rules and have no counterpart here.
"""

from __future__ import annotations

import functools

import torch

from vocalie_tts_tpu_torch.ops import _build

_ARGTYPES = [_build.P] * 6 + [_build.I] * 6 + [_build.F, _build.I, _build.I, _build.P]

#: the kernel's block size (csrc/groupnorm.cu kThreads)
_THREADS = 256


def group_norm_fused_plain(x3: torch.Tensor, e: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor, *, groups: int, eps: float,
                           silu: bool) -> torch.Tensor:
    """``_gn_xla`` on ``x3`` [B, S, C] and the row ``e`` [B, C]."""
    b, s, c = x3.shape
    xf = x3.float() + e.float()[:, None, :]
    m = xf.reshape(b, s, groups, c // groups)
    mean = torch.mean(m, dim=(1, 3))
    var = torch.clamp(torch.mean(m * m, dim=(1, 3)) - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    mean_c = torch.repeat_interleave(mean, c // groups, dim=1)
    inv_c = torch.repeat_interleave(inv, c // groups, dim=1)
    scale = inv_c * gamma.float()
    bias = beta.float() - mean_c * scale
    y = xf * scale[:, None, :] + bias[:, None, :]
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x3.dtype)


@functools.lru_cache(maxsize=256)
def _plan(b: int, s: int, c: int, sms: int):
    """(n_chunks, rows_per_chunk): enough blocks for ~4 waves of the card's
    SMs, each chunk at least as deep as the block's rows of threads."""
    n_vec = c // 8 if c % 8 == 0 else c
    by = max(1, _THREADS // min(n_vec, _THREADS))
    most = max(1, -(-s // by))
    n_chunks = max(1, min(-(-4 * sms // b), most))
    rows = -(-s // n_chunks)
    return -(-s // rows), rows


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _vec_width(c: int, *tensors: torch.Tensor) -> int:
    for v in (8, 4, 2):
        if c % v == 0 and all(t.data_ptr() % (2 * v) == 0 for t in tensors):
            return v
    return 1


def group_norm_fused(
    x: torch.Tensor,                    # [B, *spatial, C]
    gamma: torch.Tensor,                # [C]
    beta: torch.Tensor,                 # [C]
    *,
    groups: int,
    eps: float = 1e-5,
    silu: bool = False,
    pre_add: torch.Tensor | None = None,   # [B, C] FiLM row, added pre-norm
) -> torch.Tensor:
    """One-pass GroupNorm(+pre-add)(+SiLU) over channels-last ``x``."""
    orig_shape = x.shape
    bdim, c = x.shape[0], x.shape[-1]
    if c % groups:
        raise ValueError(f"C={c} not divisible by groups={groups}")
    s = 1
    for dim in orig_shape[1:-1]:
        s *= dim
    x3 = x.reshape(bdim, s, c)
    if x.device.type == "cpu":
        e = pre_add if pre_add is not None else torch.zeros((bdim, c), dtype=x.dtype)
        y = group_norm_fused_plain(x3, e, gamma, beta, groups=groups, eps=eps, silu=silu)
        return y.reshape(orig_shape)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bf16 activations, got {x.dtype}")
    if not x3.is_contiguous():
        raise ValueError("x must be contiguous (channels last)")
    if pre_add is not None and (pre_add.dtype != x.dtype or tuple(pre_add.shape) != (bdim, c)
                                or pre_add.device != x.device or not pre_add.is_contiguous()):
        raise ValueError(f"pre_add: expected contiguous {x.dtype} {(bdim, c)} on {x.device}, got "
                         f"{pre_add.dtype} {tuple(pre_add.shape)} on {pre_add.device}")
    if 4 * (2 * c + 2 * 8 * _THREADS) > 227 * 1024:
        raise ValueError(f"C={c} needs more shared memory than a block has")
    g32 = gamma.to(device=x.device, dtype=torch.float32).contiguous()
    b32 = beta.to(device=x.device, dtype=torch.float32).contiguous()
    if g32.shape != (c,) or b32.shape != (c,):
        raise ValueError(f"gamma/beta must be [{c}]")
    out = torch.empty_like(x3)
    n_chunks, rows = _plan(bdim, s, c, _sm_count(x.device.index or 0))
    ws = torch.empty((bdim, n_chunks, groups, 2), dtype=torch.float32, device=x.device)
    vec = _vec_width(c, x3, out, *([pre_add] if pre_add is not None else []))
    fn = _build.kernel("vt_group_norm", _ARGTYPES)
    group_norm_fused.launches += 1
    rc = fn(x3.data_ptr(), pre_add.data_ptr() if pre_add is not None else None,
            g32.data_ptr(), b32.data_ptr(), ws.data_ptr(), out.data_ptr(),
            bdim, s, c, groups, n_chunks, rows, float(eps), int(silu), vec,
            _build.stream_ptr(x))
    _build.check(rc, "vt_group_norm")
    return out.reshape(orig_shape)


#: launches of the CUDA kernel pair (the plain version is not counted)
group_norm_fused.launches = 0

__all__ = ["group_norm_fused", "group_norm_fused_plain"]
