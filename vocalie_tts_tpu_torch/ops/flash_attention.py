"""Flash attention forward (kernel B6), the training path's forward with
the logsumexp kept (B6t) and its differentiable wrapper, with their plain
versions.

Counterpart of ``vocalie_tts_tpu/ops/flash_attention.py``: ``[b, h, s, d]``
attention, causal (start-aligned, query i sees keys <= i) or masked per
batch row by ``kv_lens``, with GQA when k/v carry fewer heads, at head
dims 8, 16, 32, 64 and 128. :func:`reference_attention` is the counterpart
of that module's ``reference_attention`` (the XLA softmax that prefill
runs below 512 positions and the trainer runs by default).
:func:`flash_attention_trainable` is the counterpart of its
``flash_attention_trainable`` (the custom VJP): the forward is B6 writing
each row's logsumexp (``_fa_fwd``), the backward is B11
(``ops/flash_attention_bwd.py``).

On a CUDA tensor the wrappers launch ``csrc/flash_attention.cu``; on a
CPU tensor they run :func:`attention_plain` / :func:`attention_plain_lse`.
A row with no valid key returns zeros (and a logsumexp of -inf).

The kernel has two bodies, chosen by :func:`flash_body` from the dtype and
the head dim: bf16 at d 64 and 128 (every full-width path) runs on the
tensor cores (``"tc"``: wgmma, bf16 K/V tiles loaded by cp.async), every
other call on the CUDA cores in f32 (``"simt"``). Each wrapper counts its
launches (``launches``) and, of those, the tensor-core body's
(``tc_launches``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from vocalie_tts_tpu_torch.ops import _build

_ARGTYPES = [_build.P] * 6 + [_build.I] * 7 + [_build.F, _build.I, _build.P]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the head dims the tensor-core body takes (bf16 only)
TC_HEAD_DIMS = (64, 128)


def flash_body(dtype: torch.dtype, d: int) -> str:
    """The kernel body a launch takes: ``"tc"`` (tensor cores) for bf16 at
    d 64 and 128, else ``"simt"`` (f32 on the CUDA cores); the choice
    ``vt_flash_attention_fwd`` makes."""
    return "tc" if dtype == torch.bfloat16 and d in TC_HEAD_DIMS else "simt"


def _valid_keys(b, s_q, s_k, causal, kv_lens, device):
    """[b, 1, s_q, s_k] bool — True where a query may see a key."""
    cols = torch.arange(s_k, device=device)
    ok = torch.ones((b, 1, s_q, s_k), dtype=torch.bool, device=device)
    if kv_lens is not None:
        ok = ok & (cols[None, None, None, :] < kv_lens.to(device)[:, None, None, None])
    if causal:
        rows = torch.arange(s_q, device=device)
        ok = ok & (cols[None, :] <= rows[:, None])[None, None]
    return ok


def attention_plain(q, k, v, *, causal: bool = True, sm_scale: Optional[float] = None,
                    kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention in f32; the probabilities are cast to the input
    type before the p.v product, as the kernels do."""
    return attention_plain_lse(q, k, v, causal=causal, sm_scale=sm_scale, kv_lens=kv_lens)[0]


def attention_plain_lse(q, k, v, *, causal: bool = True, sm_scale: Optional[float] = None,
                        kv_lens: Optional[torch.Tensor] = None):
    """:func:`attention_plain` and each row's logsumexp, f32 ``[b, h, s_q]``:
    ``m + log(max(l, 1e-30))`` with the row max ``m`` and ``l`` the sum of
    ``exp(s - m)`` (JAX ``_attention_kernel``'s ``_store``); -inf for a row
    with no valid key."""
    b, h, s_q, d = q.shape
    hk, s_k = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    grp = h // hk
    f32 = torch.float32
    qf = q.to(f32).reshape(b, hk, grp, s_q, d)
    s = torch.matmul(qf, k.to(f32)[:, :, None].transpose(-1, -2)) * sm_scale
    ok = _valid_keys(b, s_q, s_k, causal, kv_lens, q.device)[:, :, None]
    s = s.masked_fill(~ok, -math.inf)
    m_row = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m_row), m_row, torch.zeros_like(m_row))
    p = torch.exp(s - m)
    lsum = p.sum(-1, keepdim=True)
    pc = p.to(q.dtype).to(f32)
    o = torch.matmul(pc, v.to(f32)[:, :, None])
    o = o * torch.where(lsum == 0, torch.ones_like(lsum), 1.0 / lsum)
    lse = (m_row + torch.log(torch.clamp(lsum, min=1e-30)))[..., 0]
    return o.reshape(b, h, s_q, d).to(q.dtype), lse.reshape(b, h, s_q)


def reference_attention(q, k, v, *, causal: bool = True,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Naive softmax attention, all in f32, cast to q's dtype at the end."""
    b, h, s_q, d = q.shape
    hk, s_k = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    f32 = torch.float32
    qf = q.to(f32).reshape(b, hk, h // hk, s_q, d)
    s = torch.matmul(qf, k.to(f32)[:, :, None].transpose(-1, -2)) * sm_scale
    if causal:
        s = s.masked_fill(~_valid_keys(1, s_q, s_k, True, None, q.device)[:, :, None], -math.inf)
    o = torch.matmul(torch.softmax(s, dim=-1), v.to(f32)[:, :, None])
    return o.reshape(b, h, s_q, d).to(q.dtype)


def _check(q, k, v):
    b, h, s_q, d = q.shape
    bk, hk, s_k, dk = k.shape
    if bk != b or dk != d or tuple(v.shape) != tuple(k.shape) or h % hk:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _launch(q, k, v, causal, sm_scale, kv_lens, lse):
    """Check the kernel's inputs and launch B6 (``lse``: an f32 ``[b, h,
    s_q]`` tensor to write, or None)."""
    b, h, s_q, d = q.shape
    hk, s_k = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"kernel takes float32 or bfloat16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in (8, 16, 32, 64, 128):
        raise ValueError(f"kernel takes head dims 8, 16, 32, 64 or 128, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {q.device}")
    if flash_body(q.dtype, d) == "tc" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the tensor-core body loads q, k and v in 16-byte chunks: their data "
                         "must start on a 16-byte boundary")
    lens_ptr = 0
    if kv_lens is not None:
        if kv_lens.dtype != torch.int32 or tuple(kv_lens.shape) != (b,) \
                or kv_lens.device != q.device or not kv_lens.is_contiguous():
            raise ValueError(f"kv_lens must be a contiguous int32 [{b}] tensor on {q.device}")
        lens_ptr = kv_lens.data_ptr()
    out = torch.empty_like(q)
    fn = _build.kernel("vt_flash_attention_fwd", _ARGTYPES)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        0 if lse is None else lse.data_ptr(), lens_ptr,
        b, h, hk, s_q, s_k, d, int(bool(causal)), float(sm_scale), _DTYPES[q.dtype],
        _build.stream_ptr(q),
    )
    _build.check(rc, "vt_flash_attention_fwd")
    return out


def flash_attention(
    q: torch.Tensor,          # [b, h, s_q, d]
    k: torch.Tensor,          # [b, hk, s_k, d]
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    kv_lens: Optional[torch.Tensor] = None,   # [b] int32
) -> torch.Tensor:
    """B6: the serving forward (no logsumexp)."""
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, sm_scale=sm_scale, kv_lens=kv_lens)
    out = _launch(q, k, v, causal, sm_scale, kv_lens, None)
    flash_attention.launches += 1
    if flash_body(q.dtype, q.shape[-1]) == "tc":
        flash_attention.tc_launches += 1
    return out


#: launches of the CUDA kernel (the plain version is not counted), and of
#: those the tensor-core body's
flash_attention.launches = 0
flash_attention.tc_launches = 0


def flash_attention_lse(q, k, v, *, causal: bool = True, sm_scale: Optional[float] = None):
    """B6t: the training forward, ``(out, lse)`` with ``lse`` f32 ``[b, h,
    s_q]`` (JAX ``_fa_fwd`` → ``_flash_attention_padded``)."""
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return attention_plain_lse(q, k, v, causal=causal, sm_scale=sm_scale)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    out = _launch(q, k, v, causal, sm_scale, None, lse)
    flash_attention_lse.launches += 1
    if flash_body(q.dtype, q.shape[-1]) == "tc":
        flash_attention_lse.tc_launches += 1
    return out, lse


#: launches of the CUDA kernel with the logsumexp (B6t), and of those the
#: tensor-core body's
flash_attention_lse.launches = 0
flash_attention_lse.tc_launches = 0


class _FlashAttention(torch.autograd.Function):
    """B6t forward, B11 backward; q, k, v, out and lse are saved."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_attention_lse(q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, grad_out):
        from vocalie_tts_tpu_torch.ops.flash_attention_bwd import flash_attention_bwd

        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, grad_out.contiguous(),
                                         causal=ctx.causal, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention_trainable(q, k, v, causal: bool = True,
                              sm_scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable flash attention (JAX ``flash_attention_trainable``):
    B6t forward, B11 backward, on contiguous ``[b, h, s, d]`` q and ``[b, hk,
    s, d]`` k/v. With GQA the kv head is indexed (no repeat), and B11 sums
    dK/dV over each group in f32 inside its kernel (JAX repeats the heads and
    sums the group's dK/dV after its kernel in the input dtype)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bool(causal), float(sm_scale))


__all__ = ["flash_attention", "flash_attention_lse", "flash_attention_trainable", "flash_body",
           "attention_plain", "attention_plain_lse", "reference_attention"]
