"""Fused GroupNorm (kernel B13) and its plain version.

Counterpart of ``vocalie_tts_tpu/ops/groupnorm.py::group_norm_fused``:

    [optional] x += e          (FiLM row [B, C], added pre-norm in f32)
    per-group f32 moments over spatial × C/G
    y = x·(inv·γ) + (β − mean·inv·γ)
    [optional] y = silu(y)
    cast to x's dtype

On a CUDA tensor the wrapper launches ``csrc/groupnorm.cu`` for every
shape: where :func:`gn_plan` finds a cluster of at most 16 blocks whose
shared memory holds a batch row, ONE launch that reads each activation
once (the one-pass route); otherwise two launches, moments by chunk and
then the apply (the two-pass route, counted apart in
``group_norm_fused.two_pass_launches``). On a CPU tensor it runs
:func:`group_norm_fused_plain`, which follows the JAX package's XLA branch
``_gn_xla`` step by step. The JAX wrapper's VMEM batch-block picker and its
C % 128 gate are TPU tiling rules and have no counterpart here.
"""

from __future__ import annotations

import functools

import torch

from vocalie_tts_tpu_torch.ops import _build

_ARGTYPES = [_build.P] * 7 + [_build.I] * 8 + [_build.F, _build.I, _build.I, _build.P]

#: the kernel's block size (csrc/groupnorm.cu kThreads)
_THREADS = 256
#: the one-pass route's limits: shared memory an SM has and a block may take
#: (H100), what the card reserves for each block, the largest cluster (16 is
#: non-portable), the bulk copies a block makes (csrc kMaxPieces) and the
#: bytes a copy aims for
SM_SMEM = 228 * 1024
BLOCK_SMEM_MAX = 227 * 1024
BLOCK_RESERVED = 1024
MAX_CLUSTER = 16
MAX_PIECES = 8
PIECE_BYTES = 16 * 1024
#: the phase points at which the one-pass kernel writes the card's clock
#: when given ``stamps`` (csrc kStamps): per block, in order
STAMP_POINTS = ("start", "first piece in", "moments summed", "barrier passed",
                "statistics formed", "y written")


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


def gn_one_pass_smem(rows: int, c: int, groups: int, vec: int) -> int:
    """The one-pass kernel's dynamic shared bytes for blocks of ``rows``
    spatial rows (``csrc/groupnorm.cu`` ``one_pass_smem``): the bf16 slice
    (16-byte rounded), the row-thread tree, the channel sums, the group
    partials and statistics, the mbarriers."""
    n_vec = c // vec
    bx = min(n_vec, _THREADS)
    by = _THREADS // bx
    data = -(-rows * c * 2 // 16) * 16
    return data + 4 * (2 * by * bx * vec + 2 * c + 4 * groups) + 8 * MAX_PIECES


@functools.lru_cache(maxsize=256)
def gn_plan(b: int, s: int, c: int, groups: int, vec: int, sms: int = 132):
    """The one-pass route's launch for ``b`` rows of ``s`` spatial rows x
    ``c`` channels: ``(n_cl, rows, pieces)`` -- a cluster of ``n_cl`` blocks
    per batch row, ``rows`` spatial rows a block, its slice copied in
    ``pieces`` bulk copies -- or None where a row does not fit (the two-pass
    route). The cluster is the smallest whose blocks an SM holds two of (two
    blocks' copies in flight an SM), grown while the ``b · n_cl`` blocks
    still fit two an SM in one wave; a row too large for that takes the
    smallest cluster of blocks one an SM holds."""
    half = SM_SMEM // 2 - BLOCK_RESERVED
    top = min(MAX_CLUSTER, s)

    def fits(n: int, budget: int) -> bool:
        return gn_one_pass_smem(-(-s // n), c, groups, vec) <= budget

    n = next((n for n in range(1, top + 1) if fits(n, half)), None)
    if n is None:
        n = next((n for n in range(1, top + 1) if fits(n, BLOCK_SMEM_MAX)), None)
        if n is None:
            return None
    else:
        while n < top and b * (n + 1) <= 2 * sms:
            n += 1
    rows = -(-s // n)
    n = -(-s // rows)            # no block left without rows
    pieces = 1 if vec != 8 else min(MAX_PIECES, max(1, -(-rows * c * 2 // PIECE_BYTES)))
    return n, rows, pieces


@functools.lru_cache(maxsize=256)
def _plan(b: int, s: int, c: int, sms: int):
    """The two-pass route's (n_chunks, rows_per_chunk): enough blocks for ~4
    waves of the card's SMs, each chunk at least as deep as the block's rows
    of threads."""
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
    stamps: torch.Tensor | None = None,    # on a card: [B, n_cl, len(STAMP_POINTS)] int64
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
    g32 = gamma.to(device=x.device, dtype=torch.float32).contiguous()
    b32 = beta.to(device=x.device, dtype=torch.float32).contiguous()
    if g32.shape != (c,) or b32.shape != (c,):
        raise ValueError(f"gamma/beta must be [{c}]")
    out = torch.empty_like(x3)
    vec = _vec_width(c, x3, out, *([pre_add] if pre_add is not None else []))
    sms = _sm_count(x.device.index or 0)
    plan = gn_plan(bdim, s, c, groups, vec, sms)
    if plan is not None:
        n_cl, rows, pieces = plan
        n_chunks, ws = 0, None
    else:
        if 4 * (2 * c + 2 * 8 * _THREADS) > 227 * 1024:
            raise ValueError(f"C={c} needs more shared memory than a block has")
        n_cl, pieces = 0, 1
        n_chunks, rows = _plan(bdim, s, c, sms)
        ws = torch.empty((bdim, n_chunks, groups, 2), dtype=torch.float32, device=x.device)
    if stamps is not None and (plan is None or stamps.dtype != torch.int64
                               or stamps.numel() < bdim * n_cl * len(STAMP_POINTS)):
        raise ValueError("stamps: int64, [B, n_cl, len(STAMP_POINTS)], one-pass route only")
    fn = _build.kernel("vt_group_norm", _ARGTYPES)
    group_norm_fused.launches += 1
    if plan is None:
        group_norm_fused.two_pass_launches += 1
    rc = fn(x3.data_ptr(), pre_add.data_ptr() if pre_add is not None else None,
            g32.data_ptr(), b32.data_ptr(), ws.data_ptr() if ws is not None else None,
            out.data_ptr(), stamps.data_ptr() if stamps is not None else None,
            bdim, s, c, groups, n_chunks, rows, n_cl, pieces, float(eps), int(silu), vec,
            _build.stream_ptr(x))
    _build.check(rc, "vt_group_norm")
    return out.reshape(orig_shape)


#: calls that launched the CUDA kernel, by either route, and those of them
#: that took the two-pass route (the plain version is not counted)
group_norm_fused.launches = 0
group_norm_fused.two_pass_launches = 0

__all__ = ["group_norm_fused", "group_norm_fused_plain", "gn_plan", "gn_one_pass_smem"]
