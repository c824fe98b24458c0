"""q_len == 1 decode attention over the stacked int8 KV cache (kernel B1)
and its plain version.

Counterpart of ``vocalie_tts_tpu/ops/decode_attention.py::
decode_attention_stacked(..., int8_dots=True, valid_len=...)`` — the
int8 T-blocked branches (``_kernel_stacked_int8dots_packed_tblk`` /
``_kernel_stacked_int8dots_tblk``), whose numbers are identical. The
port keeps k and v split (``[L, b, kv, T, d]`` int8 each, bf16 scales
``[L, b, kv, T]``); the TPU's lane-packed k|v is not copied.

The cache is read in place and never written here: the current token's
k/v (``k_new``/``v_new``) join the softmax in f32 at the end.

On a CUDA tensor the wrapper launches ``csrc/decode_attention.cu``; on a
CPU tensor it runs :func:`decode_attention_plain`.
"""

from __future__ import annotations

import torch

from vocalie_tts_tpu_torch.ops import _build
from vocalie_tts_tpu_torch.ops.decode_dense import _quantize_rows

#: slots per T block — the probabilities are re-quantized per block, so
#: this must equal the JAX kernel's 128 for the numbers to match
TBLK = 128

_ARGTYPES = [_build.P] * 9 + [_build.I] * 7 + [_build.F, _build.P]


def n_valid_blocks(valid_len: int, T: int) -> int:
    """Blocks the kernel reads: ceil(valid_len / 128), at least one."""
    return min(max(-(-int(valid_len) // TBLK), 1), T // TBLK)


def decode_attention_plain(q, k_all, v_all, bias, layer: int, k_scale, v_scale,
                           k_new, v_new, valid_len: int, sm_scale: float,
                           sum_dtype: torch.dtype = torch.float32):
    """The JAX kernel's math in PyTorch ops (see module doc). ``sum_dtype``
    float64 sums each block's probabilities and the current token's score
    in double, rounded to f32 once, as the whole-layer kernel (B12) does:
    then any summation order gives the same f32."""
    b, kv, g, d = q.shape
    T = k_all.shape[3]
    BC = b * kv
    f32 = torch.float32
    qf = q.reshape(BC, g, d).to(f32)
    qq, qs = _quantize_rows(qf)          # int values, exact in f32
    k = k_all[layer].reshape(BC, T, d)
    v = v_all[layer].reshape(BC, T, d)
    ks = k_scale[layer].reshape(BC, T).to(f32)
    vs = v_scale[layer].reshape(BC, T).to(f32)
    bias_m = bias.to(f32)[:, None, :].expand(b, kv, T).reshape(BC, T)
    m = torch.full((BC, g, 1), -1e30, dtype=f32, device=q.device)
    lsum = torch.zeros((BC, g, 1), dtype=f32, device=q.device)
    acc = torch.zeros((BC, g, d), dtype=f32, device=q.device)
    for blk in range(n_valid_blocks(valid_len, T)):
        sl = slice(blk * TBLK, (blk + 1) * TBLK)
        # int8 x int8 dots: every partial sum is an integer below 2**24,
        # so the f32 products are exact in any summation order
        s = torch.matmul(qq, k[:, sl].to(f32).transpose(1, 2))
        s = s * (qs * sm_scale)
        s = s * ks[:, None, sl] + bias_m[:, None, sl]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        lsum = lsum * corr + p.to(sum_dtype).sum(-1, keepdim=True).float()
        p = p * vs[:, None, sl]
        p8, ps = _quantize_rows(p, floor=1e-20)   # p >= 0
        o = torch.matmul(p8, v[:, sl].to(f32))
        acc = acc * corr + o * ps
        m = m_new
    kn = k_new.reshape(BC, 1, d).to(f32)
    vn = v_new.reshape(BC, 1, d).to(f32)
    s_new = (qf.to(sum_dtype) * kn.to(sum_dtype)).sum(-1, keepdim=True).float() * sm_scale
    m_fin = torch.maximum(m, s_new)
    corr = torch.exp(m - m_fin)
    p_new = torch.exp(s_new - m_fin)
    l_fin = lsum * corr + p_new
    o = acc * corr + p_new * vn
    return (o / torch.clamp(l_fin, min=1e-30)).reshape(b, kv, g, d)


def decode_attention_stacked(
    q: torch.Tensor,          # [b, kv, g, d] f32
    k_all: torch.Tensor,      # [L, b, kv, T, d] int8
    v_all: torch.Tensor,      # [L, b, kv, T, d] int8
    bias: torch.Tensor,       # [b, T] f32 additive mask
    layer: int,
    k_scale: torch.Tensor,    # [L, b, kv, T] bf16
    v_scale: torch.Tensor,
    k_new: torch.Tensor,      # [b, kv, d] f32 — current token's k
    v_new: torch.Tensor,
    *,
    valid_len: int,           # cached slots in use (blocks past it are skipped)
    sm_scale: float,
) -> torch.Tensor:
    """Attention output ``[b, kv, g, d]`` f32 for layer ``layer``."""
    L, b, kv, T, d = k_all.shape
    g = q.shape[2]
    if T % TBLK:
        raise ValueError(f"cache length {T} must be a multiple of {TBLK}")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_all, v_all, bias, layer, k_scale, v_scale,
                                      k_new, v_new, valid_len, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (1 <= g <= 8 and d % 16 == 0 and 16 <= d <= 128):
        raise ValueError(f"kernel takes 1 <= g <= 8 and d in 16..128 step 16, got g={g} d={d}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} outside 0..{L - 1}")
    for name, t, dtype, shape in (
        ("q", q, torch.float32, (b, kv, g, d)),
        ("k_all", k_all, torch.int8, (L, b, kv, T, d)),
        ("v_all", v_all, torch.int8, (L, b, kv, T, d)),
        ("bias", bias, torch.float32, (b, T)),
        ("k_scale", k_scale, torch.bfloat16, (L, b, kv, T)),
        ("v_scale", v_scale, torch.bfloat16, (L, b, kv, T)),
        ("k_new", k_new, torch.float32, (b, kv, d)),
        ("v_new", v_new, torch.float32, (b, kv, d)),
    ):
        if t.device != q.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {q.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((b, kv, g, d), dtype=torch.float32, device=q.device)
    fn = _build.kernel("vt_decode_attention_int8", _ARGTYPES)
    decode_attention_stacked.launches += 1
    rc = fn(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), bias.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(),
        b, kv, g, d, T, int(layer), int(valid_len), float(sm_scale),
        _build.stream_ptr(q),
    )
    _build.check(rc, "vt_decode_attention_int8")
    return out


#: launches of the CUDA kernel (the plain version is not counted)
decode_attention_stacked.launches = 0

__all__ = ["decode_attention_stacked", "decode_attention_plain", "n_valid_blocks", "TBLK"]
