"""The whole decode step at batch 1, every layer in one launch (kernel B7),
and its plain version.

Counterpart of ``vocalie_tts_tpu/ops/decode_step.py::
decode_step_fused_packed``. For each layer ``l``, on the residual carried
in f32 across all layers (no cast between layers):

- attention over the whole int8 cache in one block per head: q quantized
  per head, ``s = (i32 · (qs · sm_scale)) · ks + bias`` over every slot
  (the additive bias masks; there is no valid-length clamp), the current
  token's column merged in f32, the probabilities times the v scales
  quantized ONCE per head over all T (not per 128-slot block as in B1),
  ``o = (o_v + p_new · v_new) / max(l_sum, 1e-30)``;
- the o-projection with one scale per head: each head's o quantized on
  its own, the per-head products summed over heads (ascending), then
  times the column scale, plus the residual;
- RMSNorm, per-row int8, gate and up, ``silu(g) · u`` quantized with ONE
  scale over all of d_ff, down, plus the residual;
- the next layer's RMSNorm, per-row int8 and qkv from layer
  ``min(l + 1, L - 1)``, times the scales, plus ``bqkv``, RoPE in f32 on
  the q and k heads: q goes on to the next layer, k and v are written to
  output row ``l`` (so row ``l`` holds layer ``l + 1``'s k/v; the caller
  drops row ``L - 1``).

The port keeps its split cache (``[L, 1, H, T, d]`` int8 k and v, bf16
scales) and the fused ``wqkv`` ``[L, d_model, 3·H·d]`` with ``bqkv``; the
TPU's head-stacked weight copy, its selector matmuls and its permutation
dot for RoPE are not carried over.

The plain version repeats the kernel's arithmetic in the kernel's order:
int8 products summed exactly (float64), the variance, the softmax sum and
the current token's score summed in float64 and rounded to f32 once (so
any summation order gives the same f32), IEEE divides by a tensor 127,
and the head sum in a fixed ascending loop.

On a CUDA tensor the wrapper launches ``csrc/decode_step.cu`` (one
cooperative launch); on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from vocalie_tts_tpu_torch.ops import _build
from vocalie_tts_tpu_torch.ops.decode_dense import _int_dot, _kind, _quantize_rows, _rms_rows

_ARGTYPES = ([_build.P] * 25 + [_build.I] * 9 + [_build.F] * 2
             + [_build.P, _build.LL, _build.P])


def _rope(y: torch.Tensor, cos_f: torch.Tensor, sin_f: torch.Tensor) -> torch.Tensor:
    """``y · cos‖cos + swap(y) · (−sin‖sin)`` over the last dim (two
    products and an add, no fused multiply-add)."""
    h = y.shape[-1] // 2
    swap = torch.cat([y[..., h:], y[..., :h]], dim=-1)
    return y * cos_f + swap * sin_f


def decode_step_fused_plain(q0, kn0, vn0, x, k_all, v_all, k_scale, v_scale, bias2d,
                            wo_all, wos_all, mw_all, wgu_all, sgu_all, wd_all, sd_all,
                            nw_all, wq_all, sq_all, bqkv_all, cos_f, sin_f, *,
                            sm_scale: float, eps: float):
    """The kernel's arithmetic in PyTorch ops (see module doc)."""
    L, _, H, T, d = k_all.shape
    F = wd_all.shape[1]
    q = q0.reshape(H, d).float()
    kn, vn = kn0.float(), vn0.float()
    xres = x.float().reshape(1, -1)
    bias = bias2d.float().reshape(1, T)
    cos_f, sin_f = cos_f.float().reshape(1, d), sin_f.float().reshape(1, d)
    kn_rows, vn_rows = [], []
    for l in range(L):
        # attention, one whole-cache block per head
        qq, qs = _quantize_rows(q)
        s = torch.matmul(k_all[l, 0].double(), qq.double()[:, :, None])[..., 0].float()
        s = s * (qs * sm_scale)
        s = s * k_scale[l, 0].float() + bias
        s_new = (q.double() * kn.double()).sum(-1, keepdim=True).float() * sm_scale
        m = torch.maximum(s.amax(-1, keepdim=True), s_new)
        p = torch.exp(s - m)
        p_new = torch.exp(s_new - m)
        l_sum = p.double().sum(-1, keepdim=True).float() + p_new
        p8, ps = _quantize_rows(p * v_scale[l, 0].float(), floor=1e-20)   # p >= 0
        o_i = torch.matmul(p8.double()[:, None, :], v_all[l, 0].double())[:, 0].float()
        o = (o_i * ps + p_new * vn) / torch.clamp(l_sum, min=1e-30)
        # o-projection, one scale per head, heads summed in ascending order
        oq, os_ = _quantize_rows(o)
        wo = wo_all[l].reshape(H, d, -1)
        y = None
        for h in range(H):
            yh = _int_dot(oq[h:h + 1], wo[h]) * os_[h]
            y = yh if y is None else y + yh
        x2 = xres + y * wos_all[l]
        # whole-d_ff SwiGLU, one hidden scale per row
        hq, hs = _quantize_rows(_rms_rows(x2, mw_all[l], eps))
        gu = _int_dot(hq, wgu_all[l])
        g = gu[:, :F] * hs * sgu_all[l][:, :F]
        u = gu[:, F:] * hs * sgu_all[l][:, F:]
        mq, ms = _quantize_rows(g * torch.sigmoid(g) * u)
        x_out = x2 + _int_dot(mq, wd_all[l]) * ms * sd_all[l]
        xres = x_out
        # the next layer's norm, qkv (+ bias) and RoPE
        nxt = min(l + 1, L - 1)
        nq, ns = _quantize_rows(_rms_rows(x_out, nw_all[nxt], eps))
        yq = _int_dot(nq, wq_all[nxt]) * ns * sq_all[nxt]
        if bqkv_all is not None:
            yq = yq + bqkv_all[nxt].float()
        y3 = yq.reshape(3 * H, d)
        qk = _rope(y3[: 2 * H], cos_f, sin_f)
        q, kn, vn = qk[:H], qk[H:], y3[2 * H:]
        kn_rows.append(kn)
        vn_rows.append(vn)
    return xres, torch.stack(kn_rows), torch.stack(vn_rows)


@functools.lru_cache(maxsize=None)
def _ws_bytes(H: int, d: int, D: int, F: int) -> int:
    return _build.kernel("vt_decode_step_workspace", [_build.I] * 4, restype=_build.LL)(H, d, D, F)


def decode_step_fused_packed(
    q0: torch.Tensor,         # [H, 1, d] f32 — layer-0 post-RoPE q
    kn0: torch.Tensor,        # [H, d] f32 — layer-0 current-token k
    vn0: torch.Tensor,        # [H, d] f32
    x: torch.Tensor,          # [1, d_model] f32 residual INTO layer 0
    k_all: torch.Tensor,      # [L, 1, H, T, d] int8
    v_all: torch.Tensor,      # [L, 1, H, T, d] int8
    k_scale: torch.Tensor,    # [L, 1, H, T] bf16
    v_scale: torch.Tensor,
    bias2d: torch.Tensor,     # [1, T] f32 additive mask
    wo_all: torch.Tensor,     # [L, H·d, d_model] int8
    wos_all: torch.Tensor,    # [L, 1, d_model] f32
    mw_all: torch.Tensor,     # [L, d_model] mlp-norm weights
    wgu_all: torch.Tensor,    # [L, d_model, 2·d_ff] int8 ([gate | up])
    sgu_all: torch.Tensor,    # [L, 1, 2·d_ff] f32
    wd_all: torch.Tensor,     # [L, d_ff, d_model] int8
    sd_all: torch.Tensor,     # [L, 1, d_model] f32
    nw_all: torch.Tensor,     # [L, d_model] attn-norm weights (the next layer's)
    wq_all: torch.Tensor,     # [L, d_model, 3·H·d] int8 fused qkv
    sq_all: torch.Tensor,     # [L, 1, 3·H·d] f32
    bqkv_all: Optional[torch.Tensor],  # [L, 3·H·d] q/k/v bias, or None
    cos_f: torch.Tensor,      # [1, d] f32 — cos tiled to both halves
    sin_f: torch.Tensor,      # [1, d] f32 — [−sin | +sin]
    *,
    sm_scale: float,
    eps: float,
    grid: int = 0,
):
    """The whole decode step (all layers) →
    ``(x_out [1, d_model] f32, kn_nxt [L, H, d] f32, vn_nxt [L, H, d] f32)``;
    ``kn_nxt[l]`` is layer ``l + 1``'s current-token k (see module doc).

    ``grid`` (CUDA only) forces the number of cooperative blocks instead of
    one per SM; a grid larger than the card keeps resident is refused."""
    H, g, d = q0.shape
    if g != 1:
        raise ValueError("the whole-step kernel takes one query per head (MHA, batch 1)")
    L, b, kv, T, _ = k_all.shape
    if b != 1 or kv != H:
        raise ValueError(f"the whole-step kernel takes batch 1 and kv heads == heads, got "
                         f"b={b} kv={kv} H={H}")
    D = x.shape[1]
    F = wd_all.shape[1]
    Q = wq_all.shape[2]
    if Q != 3 * H * d or wgu_all.shape[2] != 2 * F:
        raise ValueError("wq_all must be the fused q|k|v and wgu_all the fused gate|up")
    if q0.device.type == "cpu":
        return decode_step_fused_plain(q0, kn0, vn0, x, k_all, v_all, k_scale, v_scale, bias2d,
                                       wo_all, wos_all, mw_all, wgu_all, sgu_all, wd_all, sd_all,
                                       nw_all, wq_all, sq_all, bqkv_all, cos_f, sin_f,
                                       sm_scale=sm_scale, eps=eps)
    dev = q0.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if d % 32 or d > 128 or D % 32 or F % 32 or T % 128:
        raise ValueError(f"the kernel takes d_head a multiple of 32 up to 128, d_model and d_ff "
                         f"multiples of 32 and T a multiple of 128; got d={d} D={D} F={F} T={T}")
    f32, i8, bf16 = (torch.float32,), (torch.int8,), (torch.bfloat16,)
    norm = (nw_all.dtype,) if nw_all.dtype in (torch.float32, torch.bfloat16) else f32
    specs = [
        ("q0", q0, f32, (H, 1, d)), ("kn0", kn0, f32, (H, d)), ("vn0", vn0, f32, (H, d)),
        ("x", x, f32, (1, D)),
        ("k_all", k_all, i8, (L, 1, H, T, d)), ("v_all", v_all, i8, (L, 1, H, T, d)),
        ("k_scale", k_scale, bf16, (L, 1, H, T)), ("v_scale", v_scale, bf16, (L, 1, H, T)),
        ("bias2d", bias2d, f32, (1, T)),
        ("wo_all", wo_all, i8, (L, H * d, D)), ("wos_all", wos_all, f32, (L, 1, D)),
        ("mw_all", mw_all, norm, (L, D)),
        ("wgu_all", wgu_all, i8, (L, D, 2 * F)), ("sgu_all", sgu_all, f32, (L, 1, 2 * F)),
        ("wd_all", wd_all, i8, (L, F, D)), ("sd_all", sd_all, f32, (L, 1, D)),
        ("nw_all", nw_all, norm, (L, D)),
        ("wq_all", wq_all, i8, (L, D, Q)), ("sq_all", sq_all, f32, (L, 1, Q)),
        ("cos_f", cos_f, f32, (1, d)), ("sin_f", sin_f, f32, (1, d)),
    ]
    if bqkv_all is not None:
        specs.append(("bqkv_all", bqkv_all, (torch.float32, torch.bfloat16), (L, Q)))
    for name, t, dtypes, shape in specs:
        if t.device != dev or t.dtype not in dtypes or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected {dtypes} {tuple(shape)} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ws = torch.empty((int(_ws_bytes(H, d, D, F)),), dtype=torch.uint8, device=dev)
    x_out = torch.empty((1, D), dtype=torch.float32, device=dev)
    kn_out = torch.empty((L, H, d), dtype=torch.float32, device=dev)
    vn_out = torch.empty((L, H, d), dtype=torch.float32, device=dev)
    fn = _build.kernel("vt_decode_step_fused", _ARGTYPES)
    decode_step_fused_packed.launches += 1
    rc = fn(q0.data_ptr(), kn0.data_ptr(), vn0.data_ptr(), x.data_ptr(),
            k_all.data_ptr(), v_all.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            bias2d.data_ptr(), wo_all.data_ptr(), wos_all.data_ptr(), mw_all.data_ptr(),
            wgu_all.data_ptr(), sgu_all.data_ptr(), wd_all.data_ptr(), sd_all.data_ptr(),
            nw_all.data_ptr(), wq_all.data_ptr(), sq_all.data_ptr(),
            None if bqkv_all is None else bqkv_all.data_ptr(),
            cos_f.data_ptr(), sin_f.data_ptr(),
            x_out.data_ptr(), kn_out.data_ptr(), vn_out.data_ptr(),
            _kind(nw_all, "nw_all"), 0 if bqkv_all is None else _kind(bqkv_all, "bqkv_all"),
            int(grid),
            L, H, T, d, D, F, float(sm_scale), float(eps),
            ws.data_ptr(), ws.numel(), _build.stream_ptr(q0))
    _build.check(rc, "vt_decode_step_fused")
    return x_out, kn_out, vn_out


def max_resident_blocks(H: int, d: int, D: int, F: int, T: int) -> int:
    """SMs × the blocks of the kernel one SM keeps resident at these shapes:
    the largest grid a cooperative launch accepts."""
    return int(_build.kernel("vt_decode_step_max_blocks", [_build.I] * 5)(H, d, D, F, T))


#: launches of the CUDA kernel (the plain version is not counted)
decode_step_fused_packed.launches = 0

__all__ = ["decode_step_fused_packed", "decode_step_fused_plain", "max_resident_blocks"]
