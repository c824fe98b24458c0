"""int8-native dense decode-step kernels (B2, B3, B4, B8a-b, B9a-c) and their
plain versions.

Counterpart of ``vocalie_tts_tpu/ops/decode_dense.py`` on the functions the
serving paths run with ``dense_kernel`` on. The SwiGLU family (Chatterbox,
CosyVoice, Qwen3):

- ``dense_int8_stacked`` (B4): per-row int8 x, ``(x_i8 · W[l])_i32 · xs · s``
  (the 128-padded int8 lm_head; the qkv and o-projections where no fused
  tail applies);
- ``qkv_norm_int8_stacked`` (B3): f32 RMSNorm, then the same product with
  the fused qkv weights (the layer-0 prologue of each decode step; every
  layer with ``VOCALIE_MEGATAIL=0``);
- ``tail_swiglu_qkv_int8_stacked`` (B2): the whole layer tail (o-proj →
  residual → RMSNorm → SwiGLU → down-proj → residual) and the NEXT layer's
  RMSNorm + qkv, ``qkv_next`` read from layer ``min(l + 1, L - 1)``;
- ``tail_swiglu_int8_stacked`` (B8a): B2 without the next-qkv phase
  (``VOCALIE_MEGATAIL=0``);
- ``mlp_swiglu_int8_stacked`` (B8b): the int8 SwiGLU MLP alone on the
  post-norm activations, no residual (SwiGLU with biases or a LayerNorm).

The GPT-2 family (XTTS):

- ``qkv_lnorm_int8_stacked`` (B9a): f32 LayerNorm (gain, bias), then the
  fused qkv product (the layer-0 prologue; every layer with
  ``VOCALIE_MEGATAIL=0``), B3's launch with the LayerNorm;
- ``tail_gelu_qkv_int8_stacked`` (B9b): o-proj + bias → residual →
  LayerNorm → fc + bias → tanh-GELU → proj + bias → residual, then the
  next layer's LayerNorm + qkv (layer ``min(l + 1, L - 1)``);
- ``tail_gelu_int8_stacked`` (B9c): B9b without the next-qkv phase;
- ``mlp_gelu_int8_stacked`` (B9d): fc + bias → tanh-GELU → proj on the
  post-norm activations, no residual, no proj bias (a GELU MLP with biases
  under RMSNorm, which JAX's decode step runs with B4 for the projections).

The q/k/v biases stay the caller's add, after these kernels.

Weights keep the JAX layout: stacked ``[L, d_in, d_out]`` int8 with f32
scales ``[L, 1, d_out]``, norm weights ``[L, d_model]``, and a layer index.

Activations are quantized per row, ``s = max(amax / 127, 1e-8)`` and
``round(x / s)`` half to even (a divide, no clip). The SwiGLU and GELU
hiddens are quantized per (row, d_ff tile), with the tile ``pick_tile(d_ff,
6 MiB, 2 · d_model)``: the JAX kernel's block. ``VOCALIE_TILE_MB`` overrides
the 6 MiB budget as in JAX ``_pick_tile`` (read at each call), and a budget
below one 128-column tile raises as it does there.

On a CUDA tensor each wrapper launches ``csrc/decode_dense.cu`` (a short
sequence of kernels from one C entry point; ``launches`` counts calls of
the entry point), except B2 and B8a, which are one cooperative launch of
``csrc/tail_swiglu.cu`` on the int8 tensor cores (a batch past what one
launch takes, :func:`tail_rows`, one launch a row chunk), B8b, the same
body's MLP branch (no o-projection, norm or residual), and B9b, B9c and
B9d, one launch of ``csrc/tail_gelu.cu`` (B2's body with the GELU MLP and
the LayerNorms; B9c its branch without the next qkv, as B8a is B2's; B9d
its MLP branch, with no o-projection), each planned per shape by
:func:`tail_plan`; a shape that body does not take (:func:`gelu_takes`,
:func:`mlp_gelu_takes`, :func:`mlp_swiglu_takes`) runs the old chain of
``csrc/decode_dense.cu``, and B8b's and B9d's ``chain=True`` force it. B3, B4 and B9a are one
launch of ``csrc/dense_int8.cu`` (TMA weight slices, int8 tensor cores,
split-K met in a thread-block cluster; B9a with the LayerNorm in place of
B3's RMSNorm), planned per shape by :func:`dense_plan`; a shape it does not
take (:func:`dense_takes`) runs their old three-kernel chain, and
``chain=True`` forces it (the one launch's yardstick); ``tc_launches``
counts the one launch's calls. On a CPU tensor each runs the plain version, which takes
the integer products exactly in float64 (|sum| <= 8192 · 127² < 2**53).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import heapq
import os
from typing import Optional

import numpy as np
import torch

from vocalie_tts_tpu_torch.ops import _build

#: the JAX kernels' per-block weight budget with VOCALIE_TILE_MB unset
TILE_BUDGET = 6 * 1024 * 1024

_F32, _BF16 = 1, 2
_DENSE_ARGTYPES = ([_build.P, _build.I, _build.P, _build.I, _build.F, _build.P, _build.P]
                   + [_build.I] * 4 + [_build.P, _build.P, _build.LL, _build.P])
_TAIL_ARGTYPES = ([_build.P, _build.P, _build.I] + [_build.P] * 10 + [_build.I] * 9
                  + [_build.F] + [_build.P] * 3 + [_build.LL, _build.P] + [_build.I] * 7
                  + [_build.P, _build.P])
_LNORM_ARGTYPES = ([_build.P, _build.I, _build.P, _build.P, _build.I, _build.F, _build.P, _build.P]
                   + [_build.I] * 4 + [_build.P, _build.P, _build.LL, _build.P])
_MLP_ARGTYPES = ([_build.P, _build.I] + [_build.P] * 4 + [_build.I] * 6
                 + [_build.P, _build.P, _build.LL, _build.P])
_GELU_ARGTYPES = ([_build.P, _build.P, _build.I] + [_build.P] * 11 + [_build.I] + [_build.P] * 4
                  + [_build.I] * 9 + [_build.F] + [_build.P] * 3 + [_build.LL, _build.P])
_GELU_ONE_ARGTYPES = (_GELU_ARGTYPES[:-1] + [_build.P] + [_build.I] * 7
                      + [_build.P, _build.P])


def pick_tile(n: int, budget: int, bytes_per_col: int) -> int:
    """Largest 128-multiple dividing ``n`` within ``budget`` bytes of
    ``bytes_per_col``-byte columns (0 if none): the JAX ``_pick_tile``.
    ``VOCALIE_TILE_MB`` (MiB) replaces ``budget``; below one 128-column
    tile it raises, as in JAX."""
    mb = os.environ.get("VOCALIE_TILE_MB")
    if mb:
        override = int(float(mb) * 1024 * 1024)
        floor = bytes_per_col * 128
        if override < floor:
            raise ValueError(
                f"VOCALIE_TILE_MB={mb} is below the minimum one-tile budget "
                f"({floor / 1024 / 1024:.2f} MB = 128 cols x {bytes_per_col} bytes/col for this "
                "layer); raise it or unset the knob"
            )
        budget = override
    cap = min(n, budget // max(bytes_per_col, 1)) // 128 * 128
    for t in range(cap, 0, -128):
        if n % t == 0:
            return t
    return 0


def _quantize_rows(x: torch.Tensor, floor: float = 1e-8):
    """[b, d] f32 → (integer-valued f32 [b, d], f32 scales [b, 1], at least
    ``floor``). The divisor 127 is a tensor: PyTorch's CUDA divide by a
    Python number multiplies by its rounded reciprocal, an ulp away from the
    divide that JAX and the kernel take."""
    a = x.abs().amax(-1, keepdim=True)
    s = torch.clamp(a / torch.full_like(a, 127.0), min=floor)
    return torch.round(x / s), s


def _rms_rows(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 RMSNorm over the last dim, with no cast before quantizing. The
    mean of the squares is taken in float64 and rounded to f32 once, and
    1 / sqrt is two IEEE steps, as in the CUDA kernel: the two then round
    alike in any summation order (JAX sums in f32, an ulp away)."""
    xd = x.double()
    var = torch.mean(xd * xd, dim=-1, keepdim=True).float()
    return x * (1.0 / torch.sqrt(var + eps)) * w.float()


def _ln_rows(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 LayerNorm over the last dim, ``(x - mean) * (1 / sqrt(var + eps))
    * g + b`` op by op (the JAX kernels' ``_ln_rows``, with rsqrt as two
    IEEE steps). The mean and the variance (the mean of the squared
    centred values) are summed in float64 and rounded to f32 once, as in
    the CUDA kernel: the two then round alike in any summation order."""
    mean = x.double().mean(-1, keepdim=True).float()
    xc = x - mean
    xcd = xc.double()
    var = torch.mean(xcd * xcd, dim=-1, keepdim=True).float()
    return xc * (1.0 / torch.sqrt(var + eps)) * g.float() + b.float()


#: the tanh-GELU constants as JAX rounds them to f32
_GELU_C = float(np.float32(np.sqrt(2.0 / np.pi)))
_GELU_A = float(np.float32(0.044715))


def gelu_tanh(u: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(u, approximate=True)`` as JAX spells it, op by op in
    f32: ``u * (0.5 * (1 + tanh(sqrt(2 / pi) * (u + 0.044715 * u**3))))``
    with ``u**3 = (u * u) * u``. The CUDA kernel takes the same steps with
    ``tanhf``, which is PyTorch's CUDA tanh too."""
    inner = u + _GELU_A * (u * u * u)
    return u * (0.5 * (1.0 + torch.tanh(_GELU_C * inner)))


def _int_dot(q: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """Integer-valued q · int8 W, exact (float64), cast to f32 as JAX's
    ``astype`` does."""
    return torch.matmul(q.double(), w_i8.double()).float()


# ── plain versions ──────────────────────────────────────────────────────


def dense_int8_plain(x, w_all, s_all, layer: int):
    q, xs = _quantize_rows(x.float())
    return _int_dot(q, w_all[layer]) * xs * s_all[layer]


def qkv_norm_int8_plain(x, nw_all, w_all, s_all, layer: int, *, eps: float):
    q, hs = _quantize_rows(_rms_rows(x.float(), nw_all[layer], eps))
    return _int_dot(q, w_all[layer]) * hs * s_all[layer]


def tail_swiglu_int8_plain(attn, x, wo_all, wos_all, mw_all, wgu_all, sgu_all, wd_all, sd_all,
                           layer: int, *, eps: float, tile: int | None = None):
    """B8a. ``tile``: the d_ff block the hidden is quantized over (default:
    the JAX kernel's, ``pick_tile(d_ff, 6 MiB, 2 · d_model)``)."""
    d_ff = wd_all.shape[1]
    tile = tile or pick_tile(d_ff, TILE_BUDGET, 2 * x.shape[1])
    a, as_ = _quantize_rows(attn.float())
    x2 = x.float() + _int_dot(a, wo_all[layer]) * as_ * wos_all[layer]
    h, hs = _quantize_rows(_rms_rows(x2, mw_all[layer], eps))
    return x2 + _swiglu_down(h, hs, wgu_all[layer], sgu_all[layer], wd_all[layer], tile) \
        * sd_all[layer]


def _swiglu_down(h, hs, wgu, sgu, wd, tile):
    """The int8 SwiGLU of one layer on quantized rows ``h`` (scales ``hs``):
    gate | up, ``silu(g) · u``, the down-projection summed over d_ff tiles
    (before the down scales)."""
    d_ff = wd.shape[0]
    gu = _int_dot(h, wgu) * hs * sgu
    gate = gu[:, :d_ff]
    return _tiled_down(gate * torch.sigmoid(gate) * gu[:, d_ff:], wd, tile)


def tail_swiglu_qkv_int8_plain(attn, x, wo_all, wos_all, mw_all, wgu_all, sgu_all,
                               wd_all, sd_all, nw_all, wq_all, sq_all, layer: int, *,
                               eps: float, tile: int | None = None):
    """B2: B8a, then the next layer's norm + qkv."""
    x_out = tail_swiglu_int8_plain(attn, x, wo_all, wos_all, mw_all, wgu_all, sgu_all, wd_all,
                                   sd_all, layer, eps=eps, tile=tile)
    nxt = min(layer + 1, wq_all.shape[0] - 1)
    qkv = qkv_norm_int8_plain(x_out, nw_all, wq_all, sq_all, nxt, eps=eps)
    return x_out, qkv


def mlp_swiglu_int8_plain(x, wgu_all, sgu_all, wd_all, sd_all, layer: int, *,
                          tile: int | None = None):
    """B8b: the int8 SwiGLU MLP on post-norm rows, no residual."""
    tile = tile or pick_tile(wd_all.shape[1], TILE_BUDGET, 2 * x.shape[1])
    h, hs = _quantize_rows(x.float())
    return _swiglu_down(h, hs, wgu_all[layer], sgu_all[layer], wd_all[layer], tile) \
        * sd_all[layer]


def qkv_lnorm_int8_plain(x, ng_all, nb_all, w_all, s_all, layer: int, *, eps: float):
    q, hs = _quantize_rows(_ln_rows(x.float(), ng_all[layer], nb_all[layer], eps))
    return _int_dot(q, w_all[layer]) * hs * s_all[layer]


def _tiled_down(hidden, wd, tile):
    """sum over d_ff tiles t of (int8 hidden_t · Wd_t) · s_t, in tile order:
    the hidden is quantized per (row, tile)."""
    acc = None
    for t in range(hidden.shape[1] // tile):
        cols = slice(t * tile, (t + 1) * tile)
        hq, ts = _quantize_rows(hidden[:, cols])
        part = _int_dot(hq, wd[cols]) * ts
        acc = part if acc is None else acc + part
    return acc


def tail_gelu_int8_plain(attn, x, wo_all, wos_all, bo_all, lg_all, lb_all, wu_all, su_all,
                         bu_all, wd_all, sd_all, bd_all, layer: int, *, eps: float,
                         tile: int | None = None):
    """B9c. ``tile``: the d_ff block the hidden is quantized over (default:
    the JAX kernel's, ``pick_tile(d_ff, 6 MiB, 2 · d_model)``)."""
    l, d_ff = layer, wd_all.shape[1]
    tile = tile or pick_tile(d_ff, TILE_BUDGET, 2 * x.shape[1])
    a, as_ = _quantize_rows(attn.float())
    o = _int_dot(a, wo_all[l]) * as_ * wos_all[l] + bo_all[l].float()
    x2 = x.float() + o
    h, hs = _quantize_rows(_ln_rows(x2, lg_all[l], lb_all[l], eps))
    u = _int_dot(h, wu_all[l]) * hs * su_all[l] + bu_all[l].float()
    return x2 + _tiled_down(gelu_tanh(u), wd_all[l], tile) * sd_all[l] + bd_all[l].float()


def mlp_gelu_int8_plain(x, wu_all, su_all, bu_all, wd_all, sd_all, layer: int, *,
                        tile: int | None = None):
    """B9d: ``(x_i8 · Wu) · xs · su + bu`` → tanh-GELU → the hidden
    quantized per d_ff tile → the down-projection summed over tiles, times
    ``sd`` (JAX ``_mlp_gelu_kernel``); the proj bias is the caller's."""
    l = layer
    tile = tile or pick_tile(wd_all.shape[1], TILE_BUDGET, 2 * x.shape[1])
    h, hs = _quantize_rows(x.float())
    u = _int_dot(h, wu_all[l]) * hs * su_all[l] + bu_all[l].float()
    return _tiled_down(gelu_tanh(u), wd_all[l], tile) * sd_all[l]


def tail_gelu_qkv_int8_plain(attn, x, wo_all, wos_all, bo_all, lg_all, lb_all, wu_all, su_all,
                             bu_all, wd_all, sd_all, bd_all, ng_all, nb_all, wq_all, sq_all,
                             layer: int, *, eps: float, tile: int | None = None):
    """B9b: B9c, then the next layer's LayerNorm + qkv."""
    x_out = tail_gelu_int8_plain(attn, x, wo_all, wos_all, bo_all, lg_all, lb_all, wu_all,
                                 su_all, bu_all, wd_all, sd_all, bd_all, layer, eps=eps,
                                 tile=tile)
    nxt = min(layer + 1, wq_all.shape[0] - 1)
    return x_out, qkv_lnorm_int8_plain(x_out, ng_all, nb_all, wq_all, sq_all, nxt, eps=eps)


# ── wrappers ────────────────────────────────────────────────────────────


def _kind(t: torch.Tensor, name: str) -> int:
    if t.dtype == torch.float32:
        return _F32
    if t.dtype == torch.bfloat16:
        return _BF16
    raise ValueError(f"{name}: expected float32 or bfloat16, got {t.dtype}")


def _check(dev, layer: int, L: int, *specs):
    """Device, dtype, shape and contiguity of each (name, tensor, dtypes,
    shape) on a CUDA call; the layer index inside the stack."""
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} outside 0..{L - 1}")
    for name, t, dtypes, shape in specs:
        if t.device != dev or t.dtype not in dtypes or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected {dtypes} {tuple(shape)} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


_ACT = (torch.float32, torch.bfloat16)
_I8 = (torch.int8,)
_FL = (torch.float32,)


# the workspace sizes, asked of the library once per shape: a decode step
# calls the tail 30 times and is bound by host time


@functools.lru_cache(maxsize=None)
def _dense_ws_bytes(b: int, K: int, N: int) -> int:
    return _build.kernel("vt_dense_workspace", [_build.I] * 3, restype=_build.LL)(b, K, N)


def _workspace(nbytes: int, dev) -> torch.Tensor:
    if nbytes < 0:
        raise ValueError("shapes the dense kernels do not take (K % 32, N % 4)")
    return torch.empty((max(int(nbytes), 1),), dtype=torch.uint8, device=dev)


_DENSE_ONE_ARGTYPES = ([_build.P, _build.I, _build.P, _build.P, _build.I, _build.F, _build.P,
                        _build.P] + [_build.I] * 5 + [_build.P] + [_build.I] * 5
                       + [_build.P, _build.P])
_CLUSTERS_ARGTYPES = [_build.I] * 4 + [_build.P]


def _launch_dense(x, nw_all, eps, w_all, s_all, layer, chain=False, stamps=None, nb_all=None):
    """B3 (``nw_all`` the stacked norm weights), B9a (``nw_all`` the
    LayerNorm gains, ``nb_all`` its biases) or B4 (``nw_all`` None): one
    launch of ``csrc/dense_int8.cu`` where ``dense_takes``, else (or with
    ``chain``) the old chain of ``csrc/decode_dense.cu``. ``stamps``: None,
    or an int64 CUDA tensor of ``grid * 6`` the one launch fills with its
    blocks' phase times (entry, thread 0's tiles asked for, norm, products,
    the cluster's meet, end)."""
    b, K = x.shape
    L, _, N = w_all.shape
    ln = nb_all is not None
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    plan = None if chain else _dense_launch(b, K, N, dev, ln)
    out = torch.empty((b, N), dtype=torch.float32, device=x.device)
    nw = (None, 0) if nw_all is None else (nw_all.data_ptr(), _kind(nw_all, "nw_all"))
    if plan is None:
        ws = _workspace(_dense_ws_bytes(b, K, N), x.device)
        tail = (w_all.data_ptr(), s_all.data_ptr(), int(layer), b, K, N, out.data_ptr(),
                ws.data_ptr(), ws.numel(), _build.stream_ptr(x))
        if ln:
            rc = _build.kernel("vt_qkv_lnorm_int8", _LNORM_ARGTYPES)(
                x.data_ptr(), _kind(x, "x"), nw[0], nb_all.data_ptr(), nw[1], float(eps), *tail)
            _build.check(rc, "vt_qkv_lnorm_int8")
        else:
            rc = _build.kernel("vt_dense_int8", _DENSE_ARGTYPES)(
                x.data_ptr(), _kind(x, "x"), *nw, float(eps), *tail)
            _build.check(rc, "vt_dense_int8")
        return out
    fn = _build.kernel("vt_dense_int8_one", _DENSE_ONE_ARGTYPES)
    rc = fn(x.data_ptr(), _kind(x, "x"), nw[0], nb_all.data_ptr() if ln else None, nw[1],
            float(eps), w_all.data_ptr(), s_all.data_ptr(), int(layer), L, b, K, N,
            out.data_ptr(), plan.grid, plan.ks, plan.spb, plan.kc, plan.smem,
            None if stamps is None else stamps.data_ptr(), _build.stream_ptr(x))
    _build.check(rc, "vt_dense_int8_one")
    (qkv_lnorm_int8_stacked if ln else dense_int8_stacked if nw_all is None
     else qkv_norm_int8_stacked).tc_launches += 1
    return out


def dense_int8_stacked(
    x: torch.Tensor,       # [b, d_in] bf16/f32 activations
    w_all: torch.Tensor,   # [L, d_in, d_out] int8
    s_all: torch.Tensor,   # [L, 1, d_out] f32 per-channel scales
    layer: int,
    *,
    chain: bool = False,
) -> torch.Tensor:
    """x · W[layer] with int8 × int8 products → [b, d_out] f32. ``chain``
    runs the old three-kernel chain on a card whatever the shape."""
    b, d_in = x.shape
    L, _, d_out = w_all.shape
    if pick_tile(d_out, TILE_BUDGET, d_in) == 0:
        raise ValueError(f"d_out={d_out} has no 128-multiple tile")
    if x.device.type == "cpu":
        return dense_int8_plain(x, w_all, s_all, layer)
    _check(x.device, layer, L, ("x", x, _ACT, (b, d_in)),
           ("w_all", w_all, _I8, (L, d_in, d_out)), ("s_all", s_all, _FL, (L, 1, d_out)))
    dense_int8_stacked.launches += 1
    return _launch_dense(x, None, 0.0, w_all, s_all, layer, chain)


def qkv_norm_int8_stacked(
    x: torch.Tensor,       # [b, d_model] raw residual stream
    nw_all: torch.Tensor,  # [L, d_model] attn-norm weights
    w_all: torch.Tensor,   # [L, d_model, d_out] int8 (fused qkv)
    s_all: torch.Tensor,   # [L, 1, d_out] f32
    layer: int,
    *,
    eps: float,
    chain: bool = False,
) -> torch.Tensor:
    """rms_norm(x) · Wqkv[layer] → [b, d_out] f32. ``chain`` runs the old
    three-kernel chain on a card whatever the shape."""
    b, d_in = x.shape
    L, _, d_out = w_all.shape
    if pick_tile(d_out, TILE_BUDGET, d_in) == 0:
        raise ValueError(f"d_out={d_out} has no 128-multiple tile")
    if x.device.type == "cpu":
        return qkv_norm_int8_plain(x, nw_all, w_all, s_all, layer, eps=eps)
    _check(x.device, layer, L, ("x", x, _ACT, (b, d_in)), ("nw_all", nw_all, _ACT, (L, d_in)),
           ("w_all", w_all, _I8, (L, d_in, d_out)), ("s_all", s_all, _FL, (L, 1, d_out)))
    qkv_norm_int8_stacked.launches += 1
    return _launch_dense(x, nw_all, eps, w_all, s_all, layer, chain)


def _ff_tile(d: int, d_ff: int, Q: int) -> int:
    """The d_ff tile of B2, B8a-b and B9b-c; raises where the JAX kernels have
    none."""
    tile = pick_tile(d_ff, TILE_BUDGET, 2 * d)
    if tile == 0 or (Q and pick_tile(Q, TILE_BUDGET, d) == 0):
        raise ValueError(f"d_ff={d_ff}/d_qkv={Q} has no 128-multiple tile")
    return tile


#: B2/B8a's launch (``csrc/tail_swiglu.cu``): the columns of a weight slab
#: (one item's width; 32 bytes a row), the tile rows at most, the ring depth
#: at most, the shared bytes a block may use on Hopper, and the batch and
#: the normed row width the body takes at most
SLAB = 32
TAIL_KC_MAX = 1024
TAIL_MAX_STAGES = 16
SMEM_MAX = 232448
TAIL_MAX_B = 32
TAIL_MAX_D = 2048


@dataclasses.dataclass(frozen=True)
class TailPlan:
    """One B2/B8a launch at one shape: ``grid`` blocks (one an SM at most),
    ``items[blk]`` the (product, slab) pairs block ``blk`` owns in its
    stream's order (slab s of a product is its output columns [32 s, 32 s +
    32); of gate | up, gate columns c and up columns d_ff + c), ``tiles[blk]``
    the weight tiles of ``kc`` rows it streams, ``stages`` the ring depth,
    ``max_gu`` and ``max_items`` the gate | up items and the items a block
    holds at most, ``gu_blocks`` the blocks that hold a gate | up item,
    ``smem`` the shared bytes of the launch (``vt_tail_swiglu_smem``'s),
    and ``ring_holds_all`` whether the ring holds every tile of every block
    at once (none is refilled). ``mlp`` "gelu" is B9b's plan
    (``csrc/tail_gelu.cu``): product 1 is the fc (one slab an item, not a
    gate | up pair; ``max_gu`` and ``gu_blocks`` count fc items), and a
    down-projection item is one d_ff ``tile`` of a slab, ``s = (n_tiles - 1
    - t) · d / 32 + slab``, so that a block streams the later tiles' items
    before the tile-0 item that waits for them. ``mlp`` "gelu_mlp" is B9d's
    (the same body's MLP branch): B9b's items without the o-projection's
    and the qkv's; "swiglu_mlp" is B8b's (B2's body's MLP branch,
    ``csrc/tail_swiglu.cu`` ``mlp_swiglu_kernel``): B8a's items without the
    o-projection's."""
    grid: int
    kc: int
    stages: int
    max_gu: int
    max_items: int
    gu_blocks: int
    smem: int
    items: tuple
    tiles: tuple
    ring_holds_all: bool
    mlp: str = "swiglu"
    tile: int = 0

    def table(self) -> list:
        """The item table the kernel reads: ``grid + 1`` offsets, then each
        block's items as ``product << 24 | slab``."""
        offsets, codes = [0], []
        for its in self.items:
            codes += [p << 24 | s for p, s in its]
            offsets.append(len(codes))
        return offsets + codes


#: the GELU plans (``csrc/tail_gelu.cu``); "swiglu" and "swiglu_mlp" are
#: ``csrc/tail_swiglu.cu``'s
_GELU = ("gelu", "gelu_mlp")
#: the MLP branches: no o-projection, no qkv
_MLP_ONLY = ("gelu_mlp", "swiglu_mlp")


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def tail_item_rows(p: int, d_attn: int, d: int, d_ff: int, mlp: str = "swiglu",
                   tile: int = 0) -> int:
    """The weight rows (K) of one item of product ``p`` (0 the o-projection,
    1 gate | up or, with ``mlp`` "gelu" or "gelu_mlp", the fc, 2 the
    down-projection, 3 the qkv, in stream order); a gate | up item streams
    its gate and its up slab, each ``d`` rows; a GELU down item one d_ff
    ``tile``."""
    if mlp in _GELU:
        return (d_attn, d, tile, d)[p]
    return (d_attn, 2 * d, d_ff, d)[p]


def _fixed_smem(mlp, b, lda, d, d_ff, tile, max_gu, max_items, act_min=0, n_abar=0):
    """The shared bytes of a launch beside the ring: ``layout`` in
    ``csrc/tail_swiglu.cuh`` or ``csrc/tail_gelu.cu``; ``act_min``: the
    activations' bytes at least, ``n_abar``: mbarriers past the ring's
    (B12's attention slots)."""
    mt = 2 if b > 16 else 1
    n_tiles = max(1, d_ff // tile)
    red = _align16((1 if mlp in _GELU else 2) * 16 * mt * (SLAB + 1) * 4)
    nvec = _align16(4 * d) * (2 if mlp in _GELU else 1)
    return (_align16(max(b * lda, act_min)) + red + _align16(max_gu * b * SLAB * 4)
            + _align16(b * SLAB * 4) + _align16(4 * b * n_tiles) + nvec
            + max_items * (2 * SLAB * 4 + b * SLAB * 4) + 32 * 12 + 8 * TAIL_MAX_STAGES
            + 8 * n_abar)


def tail_plan(b: int, d_attn: int, d: int, d_ff: int, tile: int, Q: int, sms: int,
              smem_max: int = SMEM_MAX, mlp: str = "swiglu", act_min: int = 0,
              n_abar: int = 0) -> TailPlan:
    """B2's (``Q`` > 0) or B8a's (``Q`` = 0) launch plan, or with ``mlp``
    "gelu" B9b's (``Q`` > 0) or B9c's (``Q`` = 0), or with ``mlp``
    "gelu_mlp" B9d's or "swiglu_mlp" B8b's (``d_attn`` and ``Q`` 0: no
    o-projection, no qkv), a pure function of the shape and the card's SM
    count (B12 adds ``act_min`` and ``n_abar``, see :func:`_fixed_smem`). The
    items (32-column slabs of the four products, each over its full K; a
    GELU down-projection item over one d_ff tile) are dealt largest first
    to the least loaded block (by weight bytes; ties to the lower block; an
    o-projection item to the least loaded block without one, while there is
    one), and each block streams its items in product order. A tile is ``kc`` rows of a
    slab: the largest power of two up to 1024 dividing ``d_attn``, ``d`` and
    ``tile`` that leaves room for two stages. The ring takes what shared memory leaves beside the int8
    activations (``b`` rows of the widest K, + 16 bytes a row against bank
    conflicts), the int32 sums, the items' hidden, the row scales, the MLP
    norm's weights and each item's column scales and residual columns, up to
    16 stages and no more than the largest block's tiles.
    Raises ``ValueError`` for a shape the body does not take."""
    name = {"gelu": "B9b/B9c", "gelu_mlp": "B9d", "swiglu_mlp": "B8b"}.get(mlp, "B2/B8a")
    if not 1 <= b <= TAIL_MAX_B:
        raise ValueError(f"{name} take 1 to {TAIL_MAX_B} rows, got b={b}")
    if mlp in _MLP_ONLY and (d_attn or Q):
        raise ValueError(f"{name} has no o-projection and no qkv, got d_attn={d_attn}, d_qkv={Q}")
    widths = (("d_model", d), ("d_ff", d_ff), ("tile", tile))
    for what, n in widths if mlp in _MLP_ONLY else (("d_attn", d_attn),) + widths:
        if n < SLAB or n % SLAB:
            raise ValueError(f"{name} need {what} a multiple of {SLAB}, got {n}")
    if Q < 0 or Q % SLAB or d_ff % tile:
        raise ValueError(f"{name} need d_qkv a multiple of {SLAB} and whole d_ff tiles, got "
                         f"d_qkv={Q}, d_ff={d_ff}, tile={tile}")
    if max(d_attn, d) > TAIL_MAX_D:
        raise ValueError(f"{name} norm rows of at most {TAIL_MAX_D}, got d_attn={d_attn}, "
                         f"d_model={d}")
    n_tiles = d_ff // tile
    if mlp in _GELU:
        slabs = (d_attn // SLAB, d_ff // SLAB, d // SLAB * n_tiles, Q // SLAB)
    else:
        slabs = (d // SLAB if d_attn else 0, d_ff // SLAB, d // SLAB, Q // SLAB)
    work = sorted(((tail_item_rows(p, d_attn, d, d_ff, mlp, tile) * SLAB, p, s)
                   for p in range(4) for s in range(slabs[p])),
                  key=lambda w: (-w[0], w[1], w[2]))
    grid = min(sms, len(work))
    heap = [(0, blk) for blk in range(grid)]
    owned = [[] for _ in range(grid)]
    for nbytes, p, s in work:
        # an o-projection item goes to a block without one while any is left:
        # its tiles are the only ones in flight before barrier 1
        passed = []
        load, blk = heapq.heappop(heap)
        while p == 0 and heap and any(q == 0 for q, _ in owned[blk]):
            passed.append((load, blk))
            load, blk = heapq.heappop(heap)
        if p == 0 and any(q == 0 for q, _ in owned[blk]) and passed:
            passed.append((load, blk))
            load, blk = passed.pop(0)
        for entry in passed:
            heapq.heappush(heap, entry)
        owned[blk].append((p, s))
        heapq.heappush(heap, (load + nbytes, blk))
    items = tuple(tuple(sorted(its)) for its in owned)
    max_gu = max(sum(p == 1 for p, _ in its) for its in items)
    max_items = max(len(its) for its in items)
    lda = max(d_attn, d, d_ff) + 16
    fixed = _fixed_smem(mlp, b, lda, d, d_ff, tile, max_gu, max_items, act_min, n_abar)
    # the largest tile that divides the depths and leaves room for two stages
    kc = TAIL_KC_MAX
    while kc > SLAB and (d_attn % kc or d % kc or tile % kc
                         or (smem_max - fixed) // (kc * SLAB) < 2):
        kc //= 2
    fit = (smem_max - fixed) // (kc * SLAB)
    if fit < 2:
        raise ValueError(f"{name} at b={b}, d_ff={d_ff}: the activations leave no room for a "
                         f"two-stage weight ring in {smem_max} bytes of shared memory")
    tiles = tuple(sum(tail_item_rows(p, d_attn, d, d_ff, mlp, tile) // kc for p, _ in its)
                  for its in items)
    stages = min(TAIL_MAX_STAGES, fit, max(tiles))
    return TailPlan(grid=grid, kc=kc, stages=stages, max_gu=max_gu, max_items=max_items,
                    gu_blocks=sum(any(p == 1 for p, _ in its) for its in items),
                    smem=fixed + stages * kc * SLAB, items=items, tiles=tiles,
                    ring_holds_all=stages >= max(tiles), mlp=mlp, tile=tile)


def tail_stream(plan: TailPlan, blk: int, d_attn: int, d: int, d_ff: int) -> list:
    """Block ``blk``'s weight tiles in the order its kernel requests them
    (``tile_request`` in ``csrc/tail_swiglu.cu`` and ``csrc/tail_gelu.cu``):
    (product, first column, first row) of each ``plan.kc``-row, 32-column
    tile; a gate | up item alternates its gate and its up tiles, a GELU down
    item streams the rows of its d_ff tile."""
    out = []
    n_slabs = d // SLAB
    for p, s in plan.items[blk]:
        c0, r0 = SLAB * s, 0
        if p == 1 and plan.mlp not in _GELU:
            for j in range(d // plan.kc):
                out += [(1, c0, j * plan.kc), (1, d_ff + c0, j * plan.kc)]
            continue
        if p == 2 and plan.mlp in _GELU:
            t = d_ff // plan.tile - 1 - s // n_slabs
            c0, r0 = SLAB * (s % n_slabs), t * plan.tile
        K = tail_item_rows(p, d_attn, d, d_ff, plan.mlp, plan.tile)
        out += [(p, c0, r0 + j * plan.kc) for j in range(K // plan.kc)]
    return out


def tail_workspace_bytes(b: int, d: int, d_ff: int, tile: int) -> int:
    """B2/B8a's workspace: x2 [b, d] f32, the quantized hidden [b, d_ff]
    int8, its amax [b, d_ff / tile] and a counter
    (``vt_tail_swiglu_workspace``)."""
    a256 = lambda n: (n + 255) // 256 * 256   # noqa: E731
    return a256(b * d * 4) + a256(b * d_ff) + a256(b * (d_ff // tile) * 4) + 256


def gelu_workspace_bytes(b: int, d: int, d_ff: int, tile: int) -> int:
    """B9b's workspace (``vt_tail_gelu_one_workspace``): x2, the quantized
    hidden, its amax, a counter, the down-projection's f32 parts [n_tiles,
    b, d] and their flags [n_tiles, d / 32]."""
    a256 = lambda n: (n + 255) // 256 * 256   # noqa: E731
    n_tiles = d_ff // tile
    return (a256(b * d * 4) + a256(b * d_ff) + a256(b * n_tiles * 4) + 256
            + a256(n_tiles * b * d * 4) + a256(n_tiles * (d // SLAB) * 4))


def mlp_swiglu_workspace_bytes(b: int, d: int, d_ff: int, tile: int) -> int:
    """B8b's workspace (``vt_mlp_swiglu_one_workspace``): the quantized
    hidden and its amax per (row, gate | up slab)."""
    a256 = lambda n: (n + 255) // 256 * 256   # noqa: E731
    return a256(b * d_ff) + a256(b * (d_ff // SLAB) * 4)


def mlp_gelu_workspace_bytes(b: int, d: int, d_ff: int, tile: int) -> int:
    """B9d's workspace (``tail_gelu.cu`` ``mlp_workspace``): the quantized hidden,
    its amax per (row, fc slab), the down-projection's f32 parts [n_tiles, b,
    d] and their flags [n_tiles, d / 32]."""
    a256 = lambda n: (n + 255) // 256 * 256   # noqa: E731
    n_tiles = d_ff // tile
    return (a256(b * d_ff) + a256(b * (d_ff // SLAB) * 4) + a256(n_tiles * b * d * 4)
            + a256(n_tiles * (d // SLAB) * 4))


@functools.lru_cache(maxsize=None)
def _sm_count(dev: int) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def card_sms(device: torch.device):
    """The SM count of the card ``device`` lies on; None off a card."""
    if device.type != "cuda":
        return None
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _tail_fits(b: int, d_attn: int, d: int, d_ff: int, tile: int, Q: int, sms: int,
               mlp: str = "swiglu") -> bool:
    try:
        tail_plan(b, d_attn, d, d_ff, tile, Q, sms, mlp=mlp)
    except ValueError:
        return False
    return True


def tail_takes(b: int, d_attn: int, d: int, d_ff: int, Q: int, sms) -> bool:
    """Whether B2 (``Q`` > 0) or B8a (``Q`` = 0) takes this shape in one
    launch: on a card of ``sms`` SMs, where ``tail_plan`` has a plan for it
    (1 to 32 rows, normed rows of at most 2048, the activations and a
    two-stage ring in shared memory); off a card (``sms`` None) always, as
    the plain version takes any shape. A batch past it runs in row chunks
    of at most :func:`tail_rows` rows."""
    if sms is None:
        return True
    return _tail_fits(b, d_attn, d, d_ff, _ff_tile(d, d_ff, Q), Q, sms)


@functools.lru_cache(maxsize=None)
def tail_rows(d_attn: int, d: int, d_ff: int, Q: int, sms: int):
    """The most rows (at most ``TAIL_MAX_B``) that one B2 (``Q`` > 0) or B8a
    (``Q`` = 0) launch takes at these widths on a card of ``sms`` SMs, or
    None where none does (a normed row past 2048, no two-stage ring beside
    one row's activations). Every quantity of the tail is per row, so a
    batch of more rows runs as launches over row chunks of at most this
    many, bit for bit the one call's result (``_tail_swiglu``)."""
    tile = _ff_tile(d, d_ff, Q)
    for b in range(TAIL_MAX_B, 0, -1):
        if _tail_fits(b, d_attn, d, d_ff, tile, Q, sms):
            return b
    return None


def _row_chunks(b: int, rows: int) -> list:
    """``ceil(b / rows)`` row ranges [r0, r1) of near-equal size covering
    ``range(b)`` in order."""
    n = -(-b // rows)
    bounds = [b * i // n for i in range(n + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def gelu_takes(b: int, d_attn: int, d: int, d_ff: int, Q: int, sms) -> bool:
    """Whether the one-launch GELU body (``csrc/tail_gelu.cu``) takes this
    shape on a card of ``sms`` SMs, as B9b (``Q`` > 0) or B9c (``Q`` = 0):
    ``tail_plan`` with ``mlp="gelu"`` has a plan (1 to 32 rows, normed rows
    of at most 2048, a two-stage ring beside the activations);
    ``_tail_gelu`` runs the other shapes on the old chain of
    ``csrc/decode_dense.cu``."""
    return sms is not None and _tail_fits(b, d_attn, d, d_ff, _ff_tile(d, d_ff, Q), Q, sms,
                                          "gelu")


@functools.lru_cache(maxsize=None)
def _tail_launch(b: int, d_attn: int, d: int, d_ff: int, tile: int, Q: int, dev: int,
                 mlp: str = "swiglu"):
    """The plan of a shape on card ``dev``, its item table on the card
    (uploaded once) and the workspace bytes: a decode step calls B2 (or
    B9b) once a layer and is bound by host time, so a call reads them from
    here and runs no Python over the blocks."""
    plan = tail_plan(b, d_attn, d, d_ff, tile, Q, _sm_count(dev), mlp=mlp)
    table = torch.tensor(plan.table(), dtype=torch.int32, device=torch.device("cuda", dev))
    ws = {"gelu": gelu_workspace_bytes, "gelu_mlp": mlp_gelu_workspace_bytes,
          "swiglu_mlp": mlp_swiglu_workspace_bytes}.get(mlp, tail_workspace_bytes)(b, d, d_ff, tile)
    return plan, table, ws


@functools.lru_cache(maxsize=None)
def _gelu_launch(b: int, d_attn: int, d: int, d_ff: int, tile: int, Q: int, dev: int):
    """B9b's or B9c's ``_tail_launch`` at a shape on card ``dev``, or None
    where the one-launch body does not take the shape (``gelu_takes``): a
    call's one cache lookup."""
    if not gelu_takes(b, d_attn, d, d_ff, Q, _sm_count(dev)):
        return None
    return _tail_launch(b, d_attn, d, d_ff, tile, Q, dev, "gelu")


def mlp_gelu_takes(b: int, d: int, d_ff: int, sms) -> bool:
    """Whether the one-launch GELU body takes this shape as B9d (its MLP
    branch) on a card of ``sms`` SMs: ``tail_plan`` with ``mlp="gelu_mlp"``
    has a plan (1 to 32 rows, rows of at most 2048, a two-stage ring beside
    the activations); ``mlp_gelu_int8_stacked`` runs the other shapes on the
    old six-kernel chain of ``csrc/decode_dense.cu``."""
    return sms is not None and _tail_fits(b, 0, d, d_ff, _ff_tile(d, d_ff, 0), 0, sms,
                                          "gelu_mlp")


@functools.lru_cache(maxsize=None)
def _mlp_gelu_launch(b: int, d: int, d_ff: int, tile: int, dev: int):
    """B9d's ``_tail_launch`` at a shape on card ``dev``, or None where the
    one-launch body does not take the shape (``mlp_gelu_takes``)."""
    if not mlp_gelu_takes(b, d, d_ff, _sm_count(dev)):
        return None
    return _tail_launch(b, 0, d, d_ff, tile, 0, dev, "gelu_mlp")


def mlp_swiglu_takes(b: int, d: int, d_ff: int, sms) -> bool:
    """Whether B2's body takes this shape as B8b (its MLP branch) on a card
    of ``sms`` SMs: ``tail_plan`` with ``mlp="swiglu_mlp"`` has a plan (1 to
    32 rows, rows of at most 2048, a two-stage ring beside the activations,
    whose rows are d_ff wide); ``mlp_swiglu_int8_stacked`` runs the other
    shapes on the old six-kernel chain of ``csrc/decode_dense.cu``."""
    return sms is not None and _tail_fits(b, 0, d, d_ff, _ff_tile(d, d_ff, 0), 0, sms,
                                          "swiglu_mlp")


@functools.lru_cache(maxsize=None)
def _mlp_swiglu_launch(b: int, d: int, d_ff: int, tile: int, dev: int):
    """B8b's ``_tail_launch`` at a shape on card ``dev``, or None where the
    one-launch body does not take the shape (``mlp_swiglu_takes``)."""
    if not mlp_swiglu_takes(b, d, d_ff, _sm_count(dev)):
        return None
    return _tail_launch(b, 0, d, d_ff, tile, 0, dev, "swiglu_mlp")


#: B3/B4's one launch (``csrc/dense_int8.cu``): the rows, the row width
#: (``quant_rows``' reach in whole parts) and the cluster size (a portable
#: cluster) it takes at most, and the most rows of a weight tile (one TMA box)
DENSE_MAX_B = 32
DENSE_MAX_K = 8192
DENSE_MAX_KS = 8
DENSE_KC_MAX = 256
#: ``quant_rows``' shared scratch (``int8_stream.cuh`` QUANT_SCRATCH)
QUANT_SCRATCH = 32 * 8 + 32 * 4


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """One B3/B4 launch at one shape: ``grid`` blocks in clusters of ``ks``;
    cluster g owns the output slabs [g · spb, min((g + 1) · spb, N / 32)) (32
    columns each), and its rank r the K tiles [r · tiles / ks, (r + 1) ·
    tiles / ks) (floors) of ``kc`` rows; ``smem`` the shared bytes of a block
    (``vt_dense_one_smem``'s)."""
    grid: int
    ks: int
    spb: int
    kc: int
    tiles: int
    smem: int

    def blocks(self, N: int) -> list:
        """Each block's (first column, end column, first K row, end K row),
        in block order (block g · ks + r is rank r of cluster g)."""
        n_slabs = N // SLAB
        out = []
        for blk in range(self.grid):
            g, r = divmod(blk, self.ks)
            s0, s1 = g * self.spb, min((g + 1) * self.spb, n_slabs)
            t0, t1 = r * self.tiles // self.ks, (r + 1) * self.tiles // self.ks
            out.append((SLAB * s0, SLAB * s1, t0 * self.kc, t1 * self.kc))
        return out


def dense_smem(b: int, K: int, spb: int, kc: int, tile_rows: int) -> int:
    """A B3/B4 block's shared bytes (``dense_layout`` in
    ``csrc/dense_int8.cu``): ``spb`` slabs of ``tile_rows`` tiles of ``kc``
    rows, the int8 rows (+ 16 bytes a row against bank conflicts), the int32
    sums, the row and column scales, the quantizer's scratch and an mbarrier a
    tile."""
    mt = 2 if b > 16 else 1
    return (spb * tile_rows * kc * SLAB + _align16(b * (K + 16)) + spb * 16 * mt * (SLAB + 1) * 4
            + _align16(4 * b) + spb * SLAB * 4 + QUANT_SCRATCH + 8 * spb * tile_rows)


def dense_plan(b: int, K: int, N: int, sms: int, smem_max: int = SMEM_MAX,
               resident=None) -> DensePlan:
    """B3's, B4's or B9a's launch plan, a pure function of the shape, the card's SM
    count and (``resident(ks, smem)``, where given) the clusters of ``ks``
    blocks of ``smem`` bytes the card keeps resident at once: the N / 32
    slabs dealt ``spb`` = ceil(slabs / sms) to a cluster, and K split over
    ``ks`` ranks, the most (up to 8, no more than sms // clusters) whose
    clusters all run in one wave; tiles of ``kc`` rows, the largest power of
    two up to 256 that divides K into at least four tiles a rank (at least
    32 rows; ``ks`` no more than the tiles). A block's whole slice and the
    int8 rows lie in shared memory. Raises ``ValueError`` for a shape the
    body does not take: past 32 rows, K not a multiple of 32 or past 8192, N
    not a multiple of 32, or a slice past shared memory."""
    if not 1 <= b <= DENSE_MAX_B:
        raise ValueError(f"B3/B4 take 1 to {DENSE_MAX_B} rows, got b={b}")
    if K < SLAB or K % SLAB or K > DENSE_MAX_K:
        raise ValueError(f"B3/B4 need K a multiple of {SLAB} up to {DENSE_MAX_K}, got {K}")
    if N < SLAB or N % SLAB:
        raise ValueError(f"B3/B4 need N a multiple of {SLAB}, got {N}")
    n_slabs = N // SLAB
    spb = -(-n_slabs // sms)
    clusters = -(-n_slabs // spb)
    for ks in range(max(1, min(DENSE_MAX_KS, sms // clusters, K // SLAB)), 0, -1):
        kc = DENSE_KC_MAX
        while kc > SLAB and (K % kc or K // kc < 4 * ks):
            kc //= 2
        tiles = K // kc
        smem = dense_smem(b, K, spb, kc, -(-tiles // ks))
        if smem > smem_max:
            raise ValueError(f"B3/B4 at b={b}, K={K}, N={N}: a block's slice and rows take "
                             f"{smem} bytes, past {smem_max} of shared memory")
        if ks == 1 or resident is None or clusters <= resident(ks, smem):
            return DensePlan(grid=clusters * ks, ks=ks, spb=spb, kc=kc, tiles=tiles, smem=smem)
    raise AssertionError("ks = 1 always returns")


@functools.lru_cache(maxsize=None)
def _dense_fits(b: int, K: int, N: int, sms: int) -> bool:
    try:
        dense_plan(b, K, N, sms)
    except ValueError:
        return False
    return True


def dense_takes(b: int, K: int, N: int, sms) -> bool:
    """Whether B3/B4's (and B9a's) one launch (``csrc/dense_int8.cu``) takes this shape
    on a card of ``sms`` SMs: ``dense_plan`` has a plan for it; never off a
    card (``sms`` None). The wrappers run the other shapes on the old
    three-kernel chain."""
    return sms is not None and _dense_fits(b, K, N, sms)


@functools.lru_cache(maxsize=None)
def _dense_resident(dev: int, b: int, ks: int, smem: int, ln: bool = False) -> int:
    """Clusters of ``ks`` blocks of ``smem`` bytes (b rows) card ``dev``
    keeps resident at once for B3/B4 (``ln``: B9a's body)
    (``cudaOccupancyMaxActiveClusters``)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = _build.kernel("vt_dense_clusters", _CLUSTERS_ARGTYPES)(
            b, int(ln), ks, smem, ctypes.byref(n))
    _build.check(rc, "vt_dense_clusters")
    return n.value


@functools.lru_cache(maxsize=None)
def _dense_launch(b: int, K: int, N: int, dev: int, ln: bool = False):
    """B3/B4's (``ln``: B9a's) plan at a shape on card ``dev`` (with the
    card's resident clusters), or None where the one launch does not take
    it: a call's one cache lookup (a decode step is bound by host time)."""
    sms = _sm_count(dev)
    if not dense_takes(b, K, N, sms):
        return None
    return dense_plan(b, K, N, sms,
                      resident=lambda ks, smem: _dense_resident(dev, b, ks, smem, ln))


def _tail_swiglu(attn, x, wo_all, wos_all, mw_all, wgu_all, sgu_all, wd_all, sd_all, nxt,
                 layer, eps, tile, stamps=None):
    """Checks and launches B2 (``nxt`` = (nw_all, wq_all, sq_all)) or B8a
    (``nxt`` None) → ``(x_out, qkv_next or None)``: one launch, or, for more
    rows than one launch takes (:func:`tail_rows`), one launch over each of
    ``_row_chunks`` (each counted in ``.launches``); a width no launch
    takes raises ``ValueError`` naming the shape. ``stamps``: None, or an
    int64 CUDA tensor of ``grid * (12 + 64)`` the kernel fills with its
    blocks' phase times and their first 64 tiles' arrival times
    (``python3 -m vocalie_tts_tpu_torch.tools.tail_swiglu_trace``; one
    launch only)."""
    b, d = x.shape
    d_attn = attn.shape[1]
    L, d_ff = wd_all.shape[0], wd_all.shape[1]
    Q = 0 if nxt is None else nxt[1].shape[2]
    specs = [("attn", attn, _FL, (b, d_attn)), ("x", x, _ACT, (b, d)),
             ("wo_all", wo_all, _I8, (L, d_attn, d)), ("wos_all", wos_all, _FL, (L, 1, d)),
             ("mw_all", mw_all, _ACT, (L, d)),
             ("wgu_all", wgu_all, _I8, (L, d, 2 * d_ff)),
             ("sgu_all", sgu_all, _FL, (L, 1, 2 * d_ff)),
             ("wd_all", wd_all, _I8, (L, d_ff, d)), ("sd_all", sd_all, _FL, (L, 1, d))]
    if nxt is not None:
        nw_all, wq_all, sq_all = nxt
        specs += [("nw_all", nw_all, (mw_all.dtype,), (L, d)),
                  ("wq_all", wq_all, _I8, (L, d, Q)), ("sq_all", sq_all, _FL, (L, 1, Q))]
    _check(x.device, layer, L, *specs)
    if any(t.data_ptr() % 16 for t in (attn, x, wo_all, wos_all, mw_all, wgu_all, sgu_all, wd_all,
                                       sd_all, *(nxt or ()))):
        raise ValueError("B2/B8a read attn, x and the weights in 16-byte chunks: each must "
                         "start on a 16-byte boundary")
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    rows = tail_rows(d_attn, d, d_ff, Q, _sm_count(dev))
    if rows is None:
        raise ValueError(f"B2/B8a: no launch takes d_model={d}, d_attn={d_attn}, d_ff={d_ff} "
                         f"(rows {b}): normed rows past {TAIL_MAX_D} or no room for a two-stage "
                         "weight ring beside one row")
    chunks = [(0, b)] if b <= rows else _row_chunks(b, rows)
    if stamps is not None and len(chunks) > 1:
        raise ValueError(f"stamps trace one launch: {b} rows take {len(chunks)}")
    x_out = torch.empty((b, d), dtype=torch.float32, device=x.device)
    qkv = torch.empty((b, Q), dtype=torch.float32, device=x.device) if Q else None
    ptrs = [None] * 3 if nxt is None else [t.data_ptr() for t in nxt]
    fn = _build.kernel("vt_tail_swiglu_qkv_int8", _TAIL_ARGTYPES)
    wrapper = tail_swiglu_int8_stacked if nxt is None else tail_swiglu_qkv_int8_stacked
    xsz = x.element_size()
    for r0, r1 in chunks:
        # contiguous row views by pointer: every row starts on a 16-byte
        # boundary (the widths are multiples of 32)
        plan, table, ws_bytes = _tail_launch(r1 - r0, d_attn, d, d_ff, tile, Q, dev)
        ws = _workspace(ws_bytes, x.device)
        wrapper.launches += 1
        rc = fn(attn.data_ptr() + 4 * r0 * d_attn, x.data_ptr() + xsz * r0 * d, _kind(x, "x"),
                wo_all.data_ptr(), wos_all.data_ptr(), mw_all.data_ptr(),
                wgu_all.data_ptr(), sgu_all.data_ptr(), wd_all.data_ptr(), sd_all.data_ptr(),
                *ptrs, _kind(mw_all, "mw_all"),
                int(layer), L, r1 - r0, d_attn, d, d_ff, tile, Q, float(eps),
                x_out.data_ptr() + 4 * r0 * d, None if qkv is None else qkv.data_ptr() + 4 * r0 * Q,
                ws.data_ptr(), ws.numel(), table.data_ptr(), plan.grid, plan.kc, plan.stages,
                plan.max_gu, plan.max_items, plan.gu_blocks, plan.smem,
                None if stamps is None else stamps.data_ptr(),
                _build.stream_ptr(x))
        _build.check(rc, "vt_tail_swiglu_qkv_int8")
    return x_out, qkv


def tail_swiglu_qkv_int8_stacked(
    attn: torch.Tensor,     # [b, n_heads*d_head] f32 merged attention output
    x: torch.Tensor,        # [b, d_model] residual stream INTO the block
    wo_all: torch.Tensor,   # [L, n_heads*d_head, d_model] int8
    wos_all: torch.Tensor,  # [L, 1, d_model] f32
    mw_all: torch.Tensor,   # [L, d_model] mlp-norm weights
    wgu_all: torch.Tensor,  # [L, d_model, 2*d_ff] int8 ([gate | up])
    sgu_all: torch.Tensor,  # [L, 1, 2*d_ff] f32
    wd_all: torch.Tensor,   # [L, d_ff, d_model] int8
    sd_all: torch.Tensor,   # [L, 1, d_model] f32
    nw_all: torch.Tensor,   # [L, d_model] attn-norm weights (the next layer's)
    wq_all: torch.Tensor,   # [L, d_model, d_qkv] int8 fused qkv
    sq_all: torch.Tensor,   # [L, 1, d_qkv] f32
    layer: int,
    *,
    eps: float,
):
    """Layer tail + the next layer's norm + qkv (B2) →
    ``(x_out [b, d_model] f32, qkv_next [b, d_qkv] f32)``."""
    args = (attn, x, wo_all, wos_all, mw_all, wgu_all, sgu_all, wd_all, sd_all)
    if wgu_all.shape[2] != 2 * wd_all.shape[1]:
        raise ValueError("wgu_all must be the fused [gate | up] concat")
    tile = _ff_tile(x.shape[1], wd_all.shape[1], wq_all.shape[2])
    if x.device.type == "cpu":
        return tail_swiglu_qkv_int8_plain(*args, nw_all, wq_all, sq_all, layer, eps=eps,
                                          tile=tile)
    return _tail_swiglu(*args, (nw_all, wq_all, sq_all), layer, eps, tile)


def tail_swiglu_int8_stacked(attn, x, wo_all, wos_all, mw_all, wgu_all, sgu_all, wd_all, sd_all,
                             layer: int, *, eps: float) -> torch.Tensor:
    """The SwiGLU layer tail alone (B8a) → x_out [b, d_model] f32; the
    arguments as ``tail_swiglu_qkv_int8_stacked``'s first nine."""
    args = (attn, x, wo_all, wos_all, mw_all, wgu_all, sgu_all, wd_all, sd_all)
    if wgu_all.shape[2] != 2 * wd_all.shape[1]:
        raise ValueError("wgu_all must be the fused [gate | up] concat")
    tile = _ff_tile(x.shape[1], wd_all.shape[1], 0)
    if x.device.type == "cpu":
        return tail_swiglu_int8_plain(*args, layer, eps=eps, tile=tile)
    return _tail_swiglu(*args, None, layer, eps, tile)[0]


@functools.lru_cache(maxsize=None)
def _mlp_ws_bytes(b: int, d: int, d_ff: int, tile: int) -> int:
    return _build.kernel("vt_mlp_swiglu_workspace", [_build.I] * 4, restype=_build.LL)(
        b, d, d_ff, tile)


_MLP_ONE_ARGTYPES = (_MLP_ARGTYPES[:-1] + [_build.P] + [_build.I] * 6
                     + [_build.P, _build.P])


def mlp_swiglu_int8_stacked(
    x: torch.Tensor,        # [b, d_model] post-norm activations
    wgu_all: torch.Tensor,  # [L, d_model, 2*d_ff] int8 ([gate | up])
    sgu_all: torch.Tensor,  # [L, 1, 2*d_ff] f32
    wd_all: torch.Tensor,   # [L, d_ff, d_model] int8
    sd_all: torch.Tensor,   # [L, 1, d_model] f32
    layer: int,
    *,
    chain: bool = False,
    stamps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """silu(x·Wg)·(x·Wu)·Wd of layer ``layer`` (B8b) → [b, d_model] f32. On
    a card: one launch of ``csrc/tail_swiglu.cu`` (B2's body's MLP branch)
    where ``mlp_swiglu_takes``, else the old six-kernel chain; ``chain``
    runs the chain whatever the shape (the yardstick). ``stamps``: None, or
    an int64 CUDA tensor of ``grid * (12 + 64)`` the one launch fills with
    its phase and tile times."""
    b, d = x.shape
    L, d_ff = wd_all.shape[0], wd_all.shape[1]
    if wgu_all.shape[2] != 2 * d_ff:
        raise ValueError("wgu_all must be the fused [gate | up] concat")
    tile = _ff_tile(d, d_ff, 0)
    if x.device.type == "cpu":
        return mlp_swiglu_int8_plain(x, wgu_all, sgu_all, wd_all, sd_all, layer, tile=tile)
    _check(x.device, layer, L, ("x", x, _ACT, (b, d)),
           ("wgu_all", wgu_all, _I8, (L, d, 2 * d_ff)),
           ("sgu_all", sgu_all, _FL, (L, 1, 2 * d_ff)),
           ("wd_all", wd_all, _I8, (L, d_ff, d)), ("sd_all", sd_all, _FL, (L, 1, d)))
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    launch = None if chain else _mlp_swiglu_launch(b, d, d_ff, tile, dev)
    out = torch.empty((b, d), dtype=torch.float32, device=x.device)
    head = (x.data_ptr(), _kind(x, "x"), wgu_all.data_ptr(), sgu_all.data_ptr(),
            wd_all.data_ptr(), sd_all.data_ptr(), int(layer), L, b, d, d_ff, tile,
            out.data_ptr())
    mlp_swiglu_int8_stacked.launches += 1
    if launch is None:
        ws = _workspace(_mlp_ws_bytes(b, d, d_ff, tile), x.device)
        rc = _build.kernel("vt_mlp_swiglu_int8", _MLP_ARGTYPES)(
            *head, ws.data_ptr(), ws.numel(), _build.stream_ptr(x))
        _build.check(rc, "vt_mlp_swiglu_int8")
        return out
    plan, table, ws_bytes = launch
    ws = _workspace(ws_bytes, x.device)
    mlp_swiglu_int8_stacked.tc_launches += 1
    rc = _build.kernel("vt_mlp_swiglu_one", _MLP_ONE_ARGTYPES)(
        *head, ws.data_ptr(), ws.numel(), table.data_ptr(), plan.grid, plan.kc, plan.stages,
        plan.max_gu, plan.max_items, plan.smem, None if stamps is None else stamps.data_ptr(),
        _build.stream_ptr(x))
    _build.check(rc, "vt_mlp_swiglu_one")
    return out


def qkv_lnorm_int8_stacked(
    x: torch.Tensor,       # [b, d_model] raw residual stream
    ng_all: torch.Tensor,  # [L, d_model] LayerNorm gains
    nb_all: torch.Tensor,  # [L, d_model] LayerNorm biases
    w_all: torch.Tensor,   # [L, d_model, d_out] int8 (fused qkv)
    s_all: torch.Tensor,   # [L, 1, d_out] f32
    layer: int,
    *,
    eps: float,
    chain: bool = False,
) -> torch.Tensor:
    """layer_norm(x) · Wqkv[layer] → [b, d_out] f32 (B9a). ``chain`` runs
    the old three-kernel chain on a card whatever the shape."""
    b, d_in = x.shape
    L, _, d_out = w_all.shape
    if pick_tile(d_out, TILE_BUDGET, d_in) == 0:
        raise ValueError(f"d_out={d_out} has no 128-multiple tile")
    if x.device.type == "cpu":
        return qkv_lnorm_int8_plain(x, ng_all, nb_all, w_all, s_all, layer, eps=eps)
    _check(x.device, layer, L, ("x", x, _ACT, (b, d_in)), ("ng_all", ng_all, _ACT, (L, d_in)),
           ("nb_all", nb_all, (ng_all.dtype,), (L, d_in)),
           ("w_all", w_all, _I8, (L, d_in, d_out)), ("s_all", s_all, _FL, (L, 1, d_out)))
    qkv_lnorm_int8_stacked.launches += 1
    return _launch_dense(x, ng_all, eps, w_all, s_all, layer, chain, nb_all=nb_all)


@functools.lru_cache(maxsize=None)
def _gelu_ws_bytes(b: int, d_attn: int, d: int, d_ff: int, tile: int, Q: int) -> int:
    return _build.kernel("vt_tail_gelu_workspace", [_build.I] * 6, restype=_build.LL)(
        b, d_attn, d, d_ff, tile, Q)


def _tail_gelu(attn, x, wo_all, wos_all, bo_all, lg_all, lb_all, wu_all, su_all, bu_all,
               wd_all, sd_all, bd_all, nxt, layer, eps, tile, stamps=None, chain=False):
    """Checks and launches B9b (``nxt`` = (ng_all, nb_all, wq_all, sq_all))
    or B9c (``nxt`` None) → ``(x_out, qkv_next or None)``: one launch of
    ``csrc/tail_gelu.cu`` where ``gelu_takes``, else the old chain. The
    one-launch C entry checks the pointers' 16-byte alignment itself
    (cudaError 716, raised by ``_build.check``). ``stamps``: None, or an
    int64 CUDA tensor of ``grid * (12 + 64)`` the one-launch body fills
    with its phase and tile times (as ``_tail_swiglu``'s). ``chain`` runs
    the old chain whatever the shape (the one-launch body's yardstick)."""
    b, d = x.shape
    d_attn = attn.shape[1]
    L, _, d_ff = wu_all.shape
    Q = 0 if nxt is None else nxt[2].shape[2]
    specs = [("attn", attn, _FL, (b, d_attn)), ("x", x, _ACT, (b, d)),
             ("wo_all", wo_all, _I8, (L, d_attn, d)), ("wos_all", wos_all, _FL, (L, 1, d)),
             ("bo_all", bo_all, _ACT, (L, d)), ("lg_all", lg_all, _ACT, (L, d)),
             ("lb_all", lb_all, (lg_all.dtype,), (L, d)),
             ("wu_all", wu_all, _I8, (L, d, d_ff)), ("su_all", su_all, _FL, (L, 1, d_ff)),
             ("bu_all", bu_all, (bo_all.dtype,), (L, d_ff)),
             ("wd_all", wd_all, _I8, (L, d_ff, d)), ("sd_all", sd_all, _FL, (L, 1, d)),
             ("bd_all", bd_all, (bo_all.dtype,), (L, d))]
    if nxt is not None:
        ng_all, nb_all, wq_all, sq_all = nxt
        specs += [("ng_all", ng_all, (lg_all.dtype,), (L, d)),
                  ("nb_all", nb_all, (lg_all.dtype,), (L, d)),
                  ("wq_all", wq_all, _I8, (L, d, Q)), ("sq_all", sq_all, _FL, (L, 1, Q))]
    _check(x.device, layer, L, *specs)
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    launch = None if chain else _gelu_launch(b, d_attn, d, d_ff, tile, Q, dev)
    x_out = torch.empty((b, d), dtype=torch.float32, device=x.device)
    qkv = torch.empty((b, Q), dtype=torch.float32, device=x.device) if Q else None
    ptrs = [None] * 4 if nxt is None else [t.data_ptr() for t in nxt]
    head = [attn.data_ptr(), x.data_ptr(), _kind(x, "x"),
            wo_all.data_ptr(), wos_all.data_ptr(), bo_all.data_ptr(), lg_all.data_ptr(),
            lb_all.data_ptr(), wu_all.data_ptr(), su_all.data_ptr(), bu_all.data_ptr(),
            wd_all.data_ptr(), sd_all.data_ptr(), bd_all.data_ptr(), _kind(bo_all, "bo_all"),
            *ptrs, _kind(lg_all, "lg_all"), int(layer), L, b, d_attn, d, d_ff, tile, Q,
            float(eps), x_out.data_ptr(), None if qkv is None else qkv.data_ptr()]
    (tail_gelu_int8_stacked if nxt is None else tail_gelu_qkv_int8_stacked).launches += 1
    if launch is None:
        ws = _workspace(_gelu_ws_bytes(b, d_attn, d, d_ff, tile, Q), x.device)
        fn = _build.kernel("vt_tail_gelu_int8", _GELU_ARGTYPES)
        rc = fn(*head, ws.data_ptr(), ws.numel(), _build.stream_ptr(x))
        _build.check(rc, "vt_tail_gelu_int8")
        return x_out, qkv
    plan, table, ws_bytes = launch
    ws = _workspace(ws_bytes, x.device)
    fn = _build.kernel("vt_tail_gelu_qkv_int8", _GELU_ONE_ARGTYPES)
    rc = fn(*head, ws.data_ptr(), ws.numel(), table.data_ptr(), plan.grid, plan.kc,
            plan.stages, plan.max_gu, plan.max_items, plan.gu_blocks, plan.smem,
            None if stamps is None else stamps.data_ptr(), _build.stream_ptr(x))
    _build.check(rc, "vt_tail_gelu_qkv_int8")
    return x_out, qkv


def tail_gelu_int8_stacked(
    attn: torch.Tensor,     # [b, n_heads*d_head] f32 merged attention output
    x: torch.Tensor,        # [b, d_model] residual stream INTO the block
    wo_all: torch.Tensor,   # [L, n_heads*d_head, d_model] int8
    wos_all: torch.Tensor,  # [L, 1, d_model] f32
    bo_all: torch.Tensor,   # [L, d_model] o-proj bias
    lg_all: torch.Tensor,   # [L, d_model] mlp LayerNorm gains
    lb_all: torch.Tensor,   # [L, d_model] mlp LayerNorm biases
    wu_all: torch.Tensor,   # [L, d_model, d_ff] int8
    su_all: torch.Tensor,   # [L, 1, d_ff] f32
    bu_all: torch.Tensor,   # [L, d_ff] fc bias
    wd_all: torch.Tensor,   # [L, d_ff, d_model] int8
    sd_all: torch.Tensor,   # [L, 1, d_model] f32
    bd_all: torch.Tensor,   # [L, d_model] proj bias
    layer: int,
    *,
    eps: float,
) -> torch.Tensor:
    """The GPT-2 layer tail (B9c) → x_out [b, d_model] f32."""
    args = (attn, x, wo_all, wos_all, bo_all, lg_all, lb_all, wu_all, su_all, bu_all, wd_all,
            sd_all, bd_all)
    tile = _ff_tile(x.shape[1], wd_all.shape[1], 0)
    if x.device.type == "cpu":
        return tail_gelu_int8_plain(*args, layer, eps=eps, tile=tile)
    return _tail_gelu(*args, None, layer, eps, tile)[0]


def tail_gelu_qkv_int8_stacked(
    attn, x, wo_all, wos_all, bo_all, lg_all, lb_all, wu_all, su_all, bu_all, wd_all, sd_all,
    bd_all,
    ng_all: torch.Tensor,   # [L, d_model] attn LayerNorm gains (the next layer's)
    nb_all: torch.Tensor,   # [L, d_model] attn LayerNorm biases
    wq_all: torch.Tensor,   # [L, d_model, d_qkv] int8 fused qkv
    sq_all: torch.Tensor,   # [L, 1, d_qkv] f32
    layer: int,
    *,
    eps: float,
):
    """The GPT-2 layer tail + the next layer's LayerNorm + qkv (B9b) →
    ``(x_out [b, d_model] f32, qkv_next [b, d_qkv] f32)``; the tail's
    arguments as ``tail_gelu_int8_stacked``'s."""
    args = (attn, x, wo_all, wos_all, bo_all, lg_all, lb_all, wu_all, su_all, bu_all, wd_all,
            sd_all, bd_all)
    tile = _ff_tile(x.shape[1], wd_all.shape[1], wq_all.shape[2])
    if x.device.type == "cpu":
        return tail_gelu_qkv_int8_plain(*args, ng_all, nb_all, wq_all, sq_all, layer, eps=eps,
                                        tile=tile)
    return _tail_gelu(*args, (ng_all, nb_all, wq_all, sq_all), layer, eps, tile)


@functools.lru_cache(maxsize=None)
def _mlp_gelu_ws_bytes(b: int, d: int, d_ff: int, tile: int) -> int:
    return _build.kernel("vt_mlp_gelu_workspace", [_build.I] * 4, restype=_build.LL)(
        b, d, d_ff, tile)


_MLP_GELU_ARGTYPES = ([_build.P, _build.I] + [_build.P] * 3 + [_build.I] + [_build.P] * 2
                      + [_build.I] * 6 + [_build.P, _build.P, _build.LL, _build.P])
_MLP_GELU_ONE_ARGTYPES = (_MLP_GELU_ARGTYPES[:-1] + [_build.P] + [_build.I] * 6
                          + [_build.P, _build.P])


def mlp_gelu_int8_stacked(
    x: torch.Tensor,        # [b, d_model] post-norm activations
    wu_all: torch.Tensor,   # [L, d_model, d_ff] int8
    su_all: torch.Tensor,   # [L, 1, d_ff] f32
    bu_all: torch.Tensor,   # [L, d_ff] fc bias
    wd_all: torch.Tensor,   # [L, d_ff, d_model] int8
    sd_all: torch.Tensor,   # [L, 1, d_model] f32
    layer: int,
    *,
    chain: bool = False,
    stamps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """gelu(x·Wu + bu)·Wd of layer ``layer`` (B9d) → [b, d_model] f32; the
    proj bias is the caller's add. On a card: one launch of
    ``csrc/tail_gelu.cu`` where ``mlp_gelu_takes``, else the old six-kernel
    chain; ``chain`` runs the chain whatever the shape (the yardstick).
    ``stamps``: None, or an int64 CUDA tensor of ``grid * (12 + 64)`` the
    one launch fills with its phase and tile times."""
    b, d = x.shape
    L, _, d_ff = wu_all.shape
    tile = _ff_tile(d, d_ff, 0)
    if x.device.type == "cpu":
        return mlp_gelu_int8_plain(x, wu_all, su_all, bu_all, wd_all, sd_all, layer, tile=tile)
    _check(x.device, layer, L, ("x", x, _ACT, (b, d)),
           ("wu_all", wu_all, _I8, (L, d, d_ff)), ("su_all", su_all, _FL, (L, 1, d_ff)),
           ("bu_all", bu_all, _ACT, (L, d_ff)),
           ("wd_all", wd_all, _I8, (L, d_ff, d)), ("sd_all", sd_all, _FL, (L, 1, d)))
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    launch = None if chain else _mlp_gelu_launch(b, d, d_ff, tile, dev)
    out = torch.empty((b, d), dtype=torch.float32, device=x.device)
    head = (x.data_ptr(), _kind(x, "x"), wu_all.data_ptr(), su_all.data_ptr(),
            bu_all.data_ptr(), _kind(bu_all, "bu_all"), wd_all.data_ptr(), sd_all.data_ptr(),
            int(layer), L, b, d, d_ff, tile, out.data_ptr())
    mlp_gelu_int8_stacked.launches += 1
    if launch is None:
        ws = _workspace(_mlp_gelu_ws_bytes(b, d, d_ff, tile), x.device)
        rc = _build.kernel("vt_mlp_gelu_int8", _MLP_GELU_ARGTYPES)(
            *head, ws.data_ptr(), ws.numel(), _build.stream_ptr(x))
        _build.check(rc, "vt_mlp_gelu_int8")
        return out
    plan, table, ws_bytes = launch
    ws = _workspace(ws_bytes, x.device)
    mlp_gelu_int8_stacked.tc_launches += 1
    rc = _build.kernel("vt_mlp_gelu_one", _MLP_GELU_ONE_ARGTYPES)(
        *head, ws.data_ptr(), ws.numel(), table.data_ptr(), plan.grid, plan.kc, plan.stages,
        plan.max_gu, plan.max_items, plan.smem, None if stamps is None else stamps.data_ptr(),
        _build.stream_ptr(x))
    _build.check(rc, "vt_mlp_gelu_one")
    return out


#: launches of the CUDA entry points (the plain versions are not counted);
#: ``tc_launches``: B3's, B4's, B8b's, B9a's and B9d's that took the one launch
dense_int8_stacked.launches = 0
qkv_norm_int8_stacked.launches = 0
dense_int8_stacked.tc_launches = 0
qkv_norm_int8_stacked.tc_launches = 0
tail_swiglu_qkv_int8_stacked.launches = 0
tail_swiglu_int8_stacked.launches = 0
mlp_swiglu_int8_stacked.launches = 0
mlp_swiglu_int8_stacked.tc_launches = 0
qkv_lnorm_int8_stacked.launches = 0
qkv_lnorm_int8_stacked.tc_launches = 0
tail_gelu_int8_stacked.launches = 0
tail_gelu_qkv_int8_stacked.launches = 0
mlp_gelu_int8_stacked.launches = 0
mlp_gelu_int8_stacked.tc_launches = 0

__all__ = [
    "dense_int8_stacked", "dense_int8_plain",
    "qkv_norm_int8_stacked", "qkv_norm_int8_plain",
    "tail_swiglu_qkv_int8_stacked", "tail_swiglu_qkv_int8_plain",
    "tail_swiglu_int8_stacked", "tail_swiglu_int8_plain",
    "mlp_swiglu_int8_stacked", "mlp_swiglu_int8_plain",
    "qkv_lnorm_int8_stacked", "qkv_lnorm_int8_plain",
    "tail_gelu_int8_stacked", "tail_gelu_int8_plain",
    "tail_gelu_qkv_int8_stacked", "tail_gelu_qkv_int8_plain",
    "mlp_gelu_int8_stacked", "mlp_gelu_int8_plain",
    "gelu_tanh", "pick_tile", "TILE_BUDGET", "TailPlan", "tail_plan", "tail_stream",
    "tail_workspace_bytes", "gelu_workspace_bytes", "gelu_takes", "mlp_gelu_takes",
    "mlp_gelu_workspace_bytes", "mlp_swiglu_takes", "mlp_swiglu_workspace_bytes", "tail_rows",
    "DensePlan", "dense_plan", "dense_smem", "dense_takes",
]
