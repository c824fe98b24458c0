"""The whole SwiGLU decode layer in one launch (kernel B12) and its plain
version.

Counterpart of ``vocalie_tts_tpu/ops/decode_layer.py::
layer_swiglu_qkv_int8_stacked`` (``VOCALIE_MEGALAYER=1``). Its packed and
split bodies compute the same numbers; the port keeps k and v split
(``[L, b, kv, T, d]`` int8, bf16 scales ``[L, b, kv, T]``), as B1 does, and
has one kernel. For one layer ``l``:

- attention per (row, kv head) over the 128-slot T blocks below
  ``ceil(valid_len / 128)`` (at least one): B1's int8 math (q quantized per
  q row, ``s = i32 · (qs · sm_scale) · ks + bias`` with an online max and
  sum, ``p · vs`` quantized per block and q row, the current token's k/v
  merged in f32, divided by ``max(l, 1e-30)``);
- the o-projection per q-head chunk: each ``[b, d]`` slice of head
  ``h · g + j`` quantized per row on its own (floor 1e-8), its int32 product
  with Wo rows ``[(h · g + j) · d, +d)`` times that scale, the chunks summed
  in f32 in ascending head order, times ``wos``, plus the residual: ``x2``.
  B2 quantizes the whole ``[h · d]`` row with one scale, so B12 is not
  B1 + B2;
- B2's tail: RMSNorm(x2, ``mw[l]``), per-row int8, gate | up, ``silu(g) · u``
  quantized per (row, d_ff tile), the down-projection's parts summed in tile
  order, ``x_out = x2 + acc · sd``; then RMSNorm with ``nw[nxt]``, int8 and
  ``qkv_next`` from layer ``nxt = min(l + 1, L - 1)``.

The d_ff tile is the JAX kernel's, ``pick_tile(d_ff, 6 MiB, 2 · d_model)``
(``VOCALIE_TILE_MB`` read at each call, as for B2).

The plain version takes the kernel's steps: int8 products exact, IEEE
divides by a tensor 127, each attention block's probability sum and the
current token's score in float64 rounded to f32 once, the variance as B2's.

On a CUDA tensor the wrapper launches ``csrc/decode_layer.cu`` (one
cooperative launch); on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import functools

import torch

from vocalie_tts_tpu_torch.ops import _build
from vocalie_tts_tpu_torch.ops.decode_attention import TBLK, decode_attention_plain, n_valid_blocks
from vocalie_tts_tpu_torch.ops.decode_dense import (
    _check,
    _ff_tile,
    _int_dot,
    _kind,
    _quantize_rows,
    _rms_rows,
    _swiglu_down,
    qkv_norm_int8_plain,
)

_ARGTYPES = ([_build.P] * 21 + [_build.I] * 14 + [_build.F] * 2
             + [_build.P, _build.LL, _build.P])


def layer_swiglu_qkv_int8_plain(q, x, k_all, v_all, k_scale, v_scale, bias2d, k_new, v_new,
                                layer: int, valid_len: int, wo_all, wos_all, mw_all, wgu_all,
                                sgu_all, wd_all, sd_all, nw_all, wq_all, sq_all, *,
                                sm_scale: float, eps: float, tile: int | None = None):
    """The kernel's arithmetic in PyTorch ops (see module doc). ``tile``:
    the d_ff block the hidden is quantized over (default: the JAX
    kernel's)."""
    b, kv, g, d = q.shape
    H = kv * g
    tile = tile or _ff_tile(x.shape[1], wd_all.shape[1], wq_all.shape[2])
    o = decode_attention_plain(q, k_all, v_all, bias2d, layer, k_scale, v_scale, k_new, v_new,
                               valid_len, sm_scale, sum_dtype=torch.float64).reshape(b, H, d)
    wo = wo_all[layer]
    y = None
    for c in range(H):      # ascending q heads: the f32 sum's order
        oq, os_ = _quantize_rows(o[:, c])
        part = _int_dot(oq, wo[c * d:(c + 1) * d]) * os_
        y = part if y is None else y + part
    x2 = x.float() + y * wos_all[layer]
    h, hs = _quantize_rows(_rms_rows(x2, mw_all[layer], eps))
    x_out = x2 + _swiglu_down(h, hs, wgu_all[layer], sgu_all[layer], wd_all[layer], tile) \
        * sd_all[layer]
    nxt = min(int(layer) + 1, wq_all.shape[0] - 1)
    return x_out, qkv_norm_int8_plain(x_out, nw_all, wq_all, sq_all, nxt, eps=eps)


@functools.lru_cache(maxsize=None)
def _ws_bytes(b: int, kv: int, g: int, d: int, D: int, F: int, tile: int, Q: int) -> int:
    return _build.kernel("vt_decode_layer_workspace", [_build.I] * 8, restype=_build.LL)(
        b, kv, g, d, D, F, tile, Q)


def layer_swiglu_qkv_int8_stacked(
    q: torch.Tensor,          # [b, kv, g, d] f32 (post-RoPE)
    x: torch.Tensor,          # [b, d_model] f32 residual INTO the layer
    k_all: torch.Tensor,      # [L, b, kv, T, d] int8
    v_all: torch.Tensor,      # [L, b, kv, T, d] int8
    k_scale: torch.Tensor,    # [L, b, kv, T] bf16
    v_scale: torch.Tensor,
    bias2d: torch.Tensor,     # [b, T] f32 additive mask
    k_new: torch.Tensor,      # [b, kv, d] f32 — the current token's k
    v_new: torch.Tensor,
    layer: int,
    valid_len: int,           # cached slots in use (blocks past it are skipped)
    wo_all: torch.Tensor,     # [L, h·d, d_model] int8
    wos_all: torch.Tensor,    # [L, 1, d_model] f32
    mw_all: torch.Tensor,     # [L, d_model] mlp-norm weights
    wgu_all: torch.Tensor,    # [L, d_model, 2·d_ff] int8 ([gate | up])
    sgu_all: torch.Tensor,    # [L, 1, 2·d_ff] f32
    wd_all: torch.Tensor,     # [L, d_ff, d_model] int8
    sd_all: torch.Tensor,     # [L, 1, d_model] f32
    nw_all: torch.Tensor,     # [L, d_model] attn-norm weights (the next layer's)
    wq_all: torch.Tensor,     # [L, d_model, d_qkv] int8 fused qkv
    sq_all: torch.Tensor,     # [L, 1, d_qkv] f32
    *,
    sm_scale: float,
    eps: float,
    grid: int = 0,
):
    """The whole decode layer →
    ``(x_out [b, d_model] f32, qkv_next [b, d_qkv] f32)``.

    ``grid`` (CUDA only) forces the number of cooperative blocks instead of
    one per SM; a grid larger than the card keeps resident is refused."""
    b, kv, g, d = q.shape
    L, _, _, T, _ = k_all.shape
    D = x.shape[1]
    F = wd_all.shape[1]
    Q = wq_all.shape[2]
    if T % TBLK:
        raise ValueError(f"cache length {T} must be a multiple of {TBLK}")
    if wgu_all.shape[2] != 2 * F:
        raise ValueError("wgu_all must be the fused [gate | up] concat")
    tile = _ff_tile(D, F, Q)
    if q.device.type == "cpu":
        return layer_swiglu_qkv_int8_plain(
            q, x, k_all, v_all, k_scale, v_scale, bias2d, k_new, v_new, layer, valid_len,
            wo_all, wos_all, mw_all, wgu_all, sgu_all, wd_all, sd_all, nw_all, wq_all, sq_all,
            sm_scale=sm_scale, eps=eps, tile=tile)
    if not (1 <= b <= 16 and 1 <= g <= 8 and d % 32 == 0 and 32 <= d <= 128
            and D % 128 == 0 and Q % 128 == 0):
        raise ValueError(f"the kernel takes 1 <= b <= 16, 1 <= g <= 8, d_head 32..128 step 32 "
                         f"and d_model, d_qkv multiples of 128; got b={b} g={g} d={d} D={D} "
                         f"Q={Q}")
    H = kv * g
    f32, i8, bf16 = (torch.float32,), (torch.int8,), (torch.bfloat16,)
    norm = (mw_all.dtype,)
    _check(q.device, layer, L,
           ("q", q, f32, (b, kv, g, d)), ("x", x, f32, (b, D)),
           ("k_all", k_all, i8, (L, b, kv, T, d)), ("v_all", v_all, i8, (L, b, kv, T, d)),
           ("k_scale", k_scale, bf16, (L, b, kv, T)), ("v_scale", v_scale, bf16, (L, b, kv, T)),
           ("bias2d", bias2d, f32, (b, T)),
           ("k_new", k_new, f32, (b, kv, d)), ("v_new", v_new, f32, (b, kv, d)),
           ("wo_all", wo_all, i8, (L, H * d, D)), ("wos_all", wos_all, f32, (L, 1, D)),
           ("mw_all", mw_all, (torch.float32, torch.bfloat16), (L, D)),
           ("wgu_all", wgu_all, i8, (L, D, 2 * F)), ("sgu_all", sgu_all, f32, (L, 1, 2 * F)),
           ("wd_all", wd_all, i8, (L, F, D)), ("sd_all", sd_all, f32, (L, 1, D)),
           ("nw_all", nw_all, norm, (L, D)),
           ("wq_all", wq_all, i8, (L, D, Q)), ("sq_all", sq_all, f32, (L, 1, Q)))
    ws = torch.empty((int(_ws_bytes(b, kv, g, d, D, F, tile, Q)),), dtype=torch.uint8,
                     device=q.device)
    x_out = torch.empty((b, D), dtype=torch.float32, device=q.device)
    qkv = torch.empty((b, Q), dtype=torch.float32, device=q.device)
    fn = _build.kernel("vt_decode_layer", _ARGTYPES)
    layer_swiglu_qkv_int8_stacked.launches += 1
    rc = fn(q.data_ptr(), x.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), bias2d.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(),
            wo_all.data_ptr(), wos_all.data_ptr(), mw_all.data_ptr(),
            wgu_all.data_ptr(), sgu_all.data_ptr(), wd_all.data_ptr(), sd_all.data_ptr(),
            nw_all.data_ptr(), wq_all.data_ptr(), sq_all.data_ptr(),
            x_out.data_ptr(), qkv.data_ptr(),
            _kind(mw_all, "mw_all"), int(grid), L, int(layer), b, kv, g, d, T,
            n_valid_blocks(valid_len, T), D, F, tile, Q, float(sm_scale), float(eps),
            ws.data_ptr(), ws.numel(), _build.stream_ptr(q))
    _build.check(rc, "vt_decode_layer")
    return x_out, qkv


def max_resident_blocks(b: int, D: int, F: int, tile: int) -> int:
    """SMs × the blocks of the kernel one SM keeps resident at these shapes:
    the largest grid a cooperative launch accepts."""
    return int(_build.kernel("vt_decode_layer_max_blocks", [_build.I] * 4)(b, D, F, tile))


#: launches of the CUDA kernel (the plain version is not counted)
layer_swiglu_qkv_int8_stacked.launches = 0

__all__ = ["layer_swiglu_qkv_int8_stacked", "layer_swiglu_qkv_int8_plain", "max_resident_blocks"]
