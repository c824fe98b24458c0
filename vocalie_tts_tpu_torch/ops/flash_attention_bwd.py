"""Flash-attention backward (kernel B11: B11b dQ, B11a dK/dV) and its plain
versions.

Counterpart of ``vocalie_tts_tpu/ops/flash_attention_bwd.py``: the
gradients of ``[b, h, s, d]`` attention (causal start-aligned, or not; GQA
when k/v carry fewer heads) from the forward's output ``o`` and logsumexp
``lse`` (B6t, ``flash_attention_lse``), without the score matrix:

    p  = exp(q·kᵀ·scale − lse)          (0 where masked)
    dp = dO·vᵀ,  di = rowsum(o ⊙ dO)
    ds = p ⊙ (dp − di) · scale
    dV = pᵀ·dO,  dK = dsᵀ·q             (p, ds in f32)
    dQ = ds·k                           (ds rounded to the input dtype)

all in f32, the outputs cast to the input dtype. With GQA, dK and dV are
summed over each kv head's group of q heads in f32 and rounded once (JAX
rounds each q head's and sums the group in the input dtype).

On CUDA tensors :func:`flash_attention_bwd` launches B11b, which also
writes ``di`` (JAX computes it outside its kernels), then B11a, from
``csrc/flash_attention_bwd.cu`` (replacing the JAX module's ``_dq_kernel``
and ``_dkv_kernel``); on CPU tensors it runs the plain versions. The two
kernels keep JAX's iteration orders: no atomics, every sum in one fixed
order.

Each kernel has two bodies, chosen by :func:`flash_bwd_body` from the
dtype and the head dim. bf16 at d 64 (the trainer's) and 128 runs on the
tensor cores (``"tc"``: wgmma with f32 accumulators, bf16 tiles loaded by
cp.async); there dQ takes ds rounded to bf16 as JAX does, and dV and dK
take p and ds each as two bf16 parts, ``hi = bf16(x)`` and ``lo = bf16(x −
hi)``, which keep 16 significand bits where one bf16 rounding would move
them several times further from JAX's f32 rule
(``tests/test_torch_flash_attention_bwd.py`` emulates both). Every other
call runs on the CUDA cores in f32 (``"simt"``). The work is bound by
bytes (~51 MB a kernel at ``[8, 16, 512, 64]``); off the tensor cores the
products set the time. Each wrapper counts its launches (``launches``)
and, of those, the tensor-core body's (``tc_launches``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from vocalie_tts_tpu_torch.ops import _build
from vocalie_tts_tpu_torch.ops.flash_attention import _DTYPES, _valid_keys

#: the additive mask of the TPU kernel (-0.7 * f32 max), before exp(s - lse)
_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_ARGTYPES = [_build.P] * 8 + [_build.I] * 7 + [_build.F, _build.I, _build.P]
#: the head dims the tensor-core bodies take (bf16 only)
TC_HEAD_DIMS = (64, 128)

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def flash_bwd_body(dtype: torch.dtype, d: int) -> str:
    """The body B11a and B11b take: ``"tc"`` (tensor cores) for bf16 at the
    head dims of :data:`TC_HEAD_DIMS`, else ``"simt"`` (f32 on the CUDA
    cores); the choice ``csrc/flash_attention_bwd.cu``'s dispatch makes."""
    return "tc" if dtype == torch.bfloat16 and d in TC_HEAD_DIMS else "simt"


def _p_ds(q, k, v, lse, do, di, causal, sm_scale):
    """(p, ds) in f32, ``[b, hk, g, s_q, s_k]`` (JAX ``_tile_ds``)."""
    b, h, s_q, d = q.shape
    hk, s_k = k.shape[1], k.shape[2]
    f32 = torch.float32
    qf = q.to(f32).reshape(b, hk, h // hk, s_q, d)
    s = torch.matmul(qf, k.to(f32)[:, :, None].transpose(-1, -2)) * sm_scale
    ok = _valid_keys(b, s_q, s_k, causal, None, q.device)[:, :, None]
    s = s + torch.where(ok, 0.0, _MASK_VALUE)
    lse_g = lse.reshape(b, hk, h // hk, s_q, 1)
    p = torch.where(ok, torch.exp(s - lse_g), 0.0)
    dof = do.to(f32).reshape(b, hk, h // hk, s_q, d)
    dp = torch.matmul(dof, v.to(f32)[:, :, None].transpose(-1, -2))
    ds = p * (dp - di.reshape(b, hk, h // hk, s_q, 1)) * sm_scale
    return p, ds


def flash_attention_bwd_dq_plain(q, k, v, o, lse, do, *, causal: bool, sm_scale: float):
    """B11b's plain version: ``(dq, di)``, ``di`` f32 ``[b, h, s_q]``."""
    b, h, s_q, d = q.shape
    di = (o.float() * do.float()).sum(-1)
    _p, ds = _p_ds(q, k, v, lse, do, di, causal, sm_scale)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()[:, :, None])
    return dq.reshape(b, h, s_q, d).to(q.dtype), di


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, *, causal: bool, sm_scale: float):
    """B11a's plain version: ``(dk, dv)``, summed over each group in f32."""
    b, h, s_q, d = q.shape
    hk = k.shape[1]
    p, ds = _p_ds(q, k, v, lse, do, di, causal, sm_scale)
    dof = do.float().reshape(b, hk, h // hk, s_q, d)
    qf = q.float().reshape(b, hk, h // hk, s_q, d)
    dv = torch.matmul(p.transpose(-1, -2), dof).sum(2)
    dk = torch.matmul(ds.transpose(-1, -2), qf).sum(2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool, sm_scale: float) -> Grads:
    """``(dq, dk, dv)`` in plain PyTorch (B11b's then B11a's plain version)."""
    dq, di = flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, causal=causal,
                                           sm_scale=sm_scale)
    return dq, dk, dv


def _check(q, k, v, rows, lse):
    """Check the kernels' inputs: q-shaped ``rows`` (o or dO and dO), f32
    ``[b, h, s_q]`` ``lse``."""
    b, h, s_q, d = q.shape
    bk, hk, s_k, dk = k.shape
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if bk != b or dk != d or tuple(v.shape) != tuple(k.shape) or h % hk:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, *rows)):
        raise ValueError(f"kernel takes float32 or bfloat16 q/k/v/o/dO of one dtype, got {q.dtype}")
    if d not in (8, 16, 32, 64, 128):
        raise ValueError(f"kernel takes head dims 8, 16, 32, 64 or 128, got {d}")
    for t in (q, k, v, *rows, lse):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"q, k, v, o, dO and lse must be contiguous tensors on {q.device}")
    if any(tuple(t.shape) != tuple(q.shape) for t in rows):
        raise ValueError(f"o and dO must have q's shape {tuple(q.shape)}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, s_q):
        raise ValueError(f"lse must be float32 [{b}, {h}, {s_q}]")
    if flash_bwd_body(q.dtype, d) == "tc" and any(t.data_ptr() % 16 for t in (q, k, v, *rows)):
        raise ValueError("the tensor-core body loads q, k, v, o and dO in 16-byte chunks: "
                         "their data must start on a 16-byte boundary")


def _dims(q, k):
    b, h, s_q, d = q.shape
    return b, h, k.shape[1], s_q, k.shape[2], d


def flash_attention_bwd_dq(q, k, v, o, lse, do, *, causal: bool, sm_scale: float):
    """B11b: ``(dq, di)`` (``di`` f32 ``[b, h, s_q]``, B11a's input)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal=causal,
                                            sm_scale=sm_scale)
    _check(q, k, v, (o, do), lse)
    dq = torch.empty_like(q)
    di = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    fn = _build.kernel("vt_flash_attention_bwd_dq", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), di.data_ptr(), *_dims(q, k), int(bool(causal)),
            float(sm_scale), _DTYPES[q.dtype], _build.stream_ptr(q))
    _build.check(rc, "vt_flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    if flash_bwd_body(q.dtype, q.shape[-1]) == "tc":
        flash_attention_bwd_dq.tc_launches += 1
    return dq, di


def flash_attention_bwd_dkv(q, k, v, do, lse, di, *, causal: bool, sm_scale: float):
    """B11a: ``(dk, dv)`` from B11b's ``di``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, causal=causal,
                                             sm_scale=sm_scale)
    _check(q, k, v, (do,), lse)
    if di.dtype != torch.float32 or di.shape != lse.shape or not di.is_contiguous() \
            or di.device != q.device:
        raise ValueError(f"di must be a contiguous float32 {tuple(lse.shape)} tensor")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = _build.kernel("vt_flash_attention_bwd_dkv", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_dims(q, k), int(bool(causal)),
            float(sm_scale), _DTYPES[q.dtype], _build.stream_ptr(q))
    _build.check(rc, "vt_flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    if flash_bwd_body(q.dtype, q.shape[-1]) == "tc":
        flash_attention_bwd_dkv.tc_launches += 1
    return dk, dv


#: launches of each CUDA kernel (the plain versions are not counted), and of
#: those the tensor-core body's
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.tc_launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.tc_launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool, sm_scale: float) -> Grads:
    """``(dq, dk, dv)``: B11b then B11a on CUDA tensors, the plain versions
    on CPU tensors."""
    dq, di = flash_attention_bwd_dq(q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, causal=causal, sm_scale=sm_scale)
    return dq, dk, dv


__all__ = ["flash_attention_bwd", "flash_attention_bwd_plain", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq_plain",
           "flash_attention_bwd_dkv_plain", "flash_bwd_body"]
