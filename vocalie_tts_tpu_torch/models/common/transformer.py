"""Decoder-only transformer core (counterpart of
``vocalie_tts_tpu/models/common/transformer.py``).

Params are the JAX package's tree, bridged to torch (``bridge.py``):
layers stacked on a leading ``[n_layers]`` axis, ``x @ W`` layout,
int8 weights as ``{"q": int8, "s": f32 [..., 1, d_out]}``. The layer
loop is a Python loop over that axis. ``prefill`` and ``decode_step``
take the runtime's weights, with q/k/v and gate/up concatenated by
``fuse_decode_weights`` (``ar_runtime.maybe_quantize_lm``), under
``torch.no_grad``; ``forward_all_logits`` (the trainer's forward, under
autograd) takes the unfused tree of ``init_params``.

Two families: the Chatterbox/CosyVoice/Qwen3 one (RMSNorm, RoPE, GQA,
SwiGLU, optional q/k/v biases, ``attn_bias``, optional per-head q/k
RMSNorm, ``qk_norm``) and the GPT-2 one of XTTS
(``norm_type="layer"``: LayerNorm with bias; ``mlp_type="gelu"``: fc →
tanh-GELU → proj; ``bias``: o-proj and MLP biases; ``pos_type="learned"``:
an absolute position table, no RoPE; ``head_bias``: a bias on the head).
Both run every KV cache and decode attention that the JAX package's
``apply_runtime_env`` can give: the ``cfg.dtype`` cache without scales
(the default), attended in plain PyTorch (JAX's XLA branch) or, with
``decode_kernel``, by the f32 decode-attention kernel (K1), and appended
by slice assignment or, with the decode or dense kernels on, by the
no-scale cache-update kernel (K4); or the int8 cache (``kv_quant``) with
its scales, attended in plain PyTorch or by the int8 decode-attention
kernels (B1 over a 128-multiple cache, B1w, the whole-row branch, over any
other length) and appended by slice assignment or the cache-update kernel
(B5). Prefill runs flash attention (B6) at prompt buckets >= 512, and,
with ``dense_kernel`` (the JAX package's default with int8 weights), the
decode step runs the int8-native dense decode kernels of
``_dense_dispatch``: for SwiGLU the layer-0 norm+qkv (B3),
the fused layer tail + next qkv (B2), with ``VOCALIE_MEGATAIL=0`` B3 and
the tail alone (B8a) per layer, with ``VOCALIE_MEGALAYER=1`` the whole
layer (attention, o-projection, tail, next qkv) as one launch (B12), or,
at batch 1 without qk-norm, the whole step (B7); for GPT-2 the layer-0
LayerNorm+qkv (B9a) and the GELU tail + next qkv (B9b), or with
``VOCALIE_MEGATAIL=0`` B9a and the tail alone (B9c) per layer; where no
fused tail applies (SwiGLU with biases or a LayerNorm; a GELU MLP with
biases under RMSNorm), B4 for the qkv and o-projections and the int8
SwiGLU MLP (B8b) or the int8 GELU MLP (B9d); the int8 lm_head (B4, also
for prefill's last-position logits) for all. Where the shapes are not
eligible (d_model or the qkv width not a 128-multiple), the JAX package
takes the ``_qdot`` path, and so does the port.

The KV cache is a mutable object: ``decode_step`` writes the step's k/v
into it IN PLACE and returns it (the JAX version returns a new cache).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from vocalie_tts_tpu_torch.ops.cache_update import cache_append_kv_stacked, cache_append_stacked
from vocalie_tts_tpu_torch.device import div_const
from vocalie_tts_tpu_torch.ops.decode_dense import (
    _ff_tile,
    card_sms,
    dense_int8_stacked,
    gelu_tanh,
    mlp_gelu_int8_stacked,
    mlp_swiglu_int8_stacked,
    qkv_lnorm_int8_stacked,
    qkv_norm_int8_stacked,
    tail_gelu_int8_stacked,
    tail_gelu_qkv_int8_stacked,
    tail_rows,
    tail_swiglu_int8_stacked,
    tail_swiglu_qkv_int8_stacked,
)
from vocalie_tts_tpu_torch.ops.decode_attention import decode_attention_stacked
from vocalie_tts_tpu_torch.ops.decode_layer import layer_rows, layer_swiglu_qkv_int8_stacked
from vocalie_tts_tpu_torch.ops.decode_step import decode_step_fused_packed
from vocalie_tts_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_trainable,
    reference_attention,
)
from vocalie_tts_tpu_torch.utils.env import bool_env

Params = Dict[str, Any]

#: the additive mask for cache slots that hold no token (-0.7 * f32 max)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    #: int8 KV cache with per-(layer, row, head, position) bf16 scales
    #: (else the cache holds ``dtype`` and no scales)
    kv_quant: bool = False
    #: decode attention through a kernel (B1 on the int8 cache, K1 on
    #: the float cache) and the in-place cache append (B5, K4)
    decode_kernel: bool = False
    #: int8-native dense decode kernels: B3 norm+qkv, B2 layer tail + next
    #: qkv, B4 lm_head; inert without int8 weights or on ineligible shapes
    #: (see ``_dense_dispatch``)
    dense_kernel: bool = False
    #: additive q/k/v projection biases (the Qwen2 backbone of CosyVoice)
    attn_bias: bool = False
    # ── the GPT-2 variant (the XTTS GPT), JAX ``transformer.py:71-91`` ──
    #: "rms" or "layer" (LayerNorm with bias)
    norm_type: str = "rms"
    #: "swiglu" (gate · up) or "gelu" (fc → tanh-GELU → proj)
    mlp_type: str = "swiglu"
    #: biases on the o-projection and the MLP
    bias: bool = False
    #: "rope" or "learned" (absolute table; caller-built prompt embeds
    #: carry their own positions, decode steps look the table up)
    pos_type: str = "rope"
    #: decode position: "absolute" (prompt + decoded) or
    #: "decode_relative" (n_decoded + 1: XTTS mel positions)
    pos_index: str = "absolute"
    #: learned position table length (0 → max_seq_len)
    pos_len: int = 0
    #: a bias on the LM head, added after the vocabulary slice
    head_bias: bool = False
    #: per-head RMSNorm on q and k over d_head, before RoPE (the Qwen3
    #: backbone; ``q_norm`` / ``k_norm`` leaves ``[L, d_head]`` f32)
    qk_norm: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head


@dataclasses.dataclass
class StackedKVCache:
    """All layers' caches stacked on a leading [n_layers] axis, k and v
    split: int8 with bf16 scales (``kv_quant``), or the config's dtype
    without scales (JAX ``StackedKVCache.create``, :142-175). Positions
    [0, prompt_pad) hold the padded prompt; decode tokens land at the
    uniform slot ``prompt_pad + n_decoded``. Per-row validity comes from
    ``prompt_lengths``; RoPE uses logical positions. ``n_decoded`` and
    ``prompt_pad`` are host integers."""

    k: torch.Tensor        # [L, b, kv, T, d] int8, or the config's dtype
    v: torch.Tensor        # [L, b, kv, T, d]
    k_scale: Optional[torch.Tensor]  # [L, b, kv, T] bf16 (int8 cache), else None
    v_scale: Optional[torch.Tensor]
    prompt_lengths: torch.Tensor  # [b] int32
    n_decoded: int = 0
    prompt_pad: int = 0

    @classmethod
    def create(cls, n_layers, batch, kv_heads, max_len, head_dim, device,
               dtype: torch.dtype = torch.bfloat16, quantized: bool = True) -> "StackedKVCache":
        shape = (n_layers, batch, kv_heads, max_len, head_dim)
        vals = torch.int8 if quantized else dtype
        scales = ((torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
                   torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device))
                  if quantized else (None, None))
        return cls(
            k=torch.zeros(shape, dtype=vals, device=device),
            v=torch.zeros(shape, dtype=vals, device=device),
            k_scale=scales[0],
            v_scale=scales[1],
            prompt_lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
        )

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def length(self) -> torch.Tensor:
        """Per-row logical sequence length (prompt + decoded)."""
        return self.prompt_lengths + self.n_decoded

    def valid_mask(self) -> torch.Tensor:
        """[batch, max_len] — True where a cache slot holds a real token."""
        pos = torch.arange(self.max_len, device=self.k.device)[None, :]
        in_prompt = pos < self.prompt_lengths[:, None]
        in_decode = (pos >= self.prompt_pad) & (pos < self.prompt_pad + self.n_decoded)
        return in_prompt | in_decode


# ── init ────────────────────────────────────────────────────────────────


def _normal(shape, scale, dtype, generator, device):
    return (torch.randn(shape, generator=generator, device=device) * scale).to(dtype)


def init_params(cfg: TransformerConfig, *, generator=None, device="cpu") -> Params:
    """Random stacked transformer params with the JAX ``init_params``
    tree, shapes and scales (``transformer.py:208-257``): biases at zero,
    LayerNorm biases at zero, the learned position table at 0.01."""
    L, dt = cfg.n_layers, cfg.dtype

    def stacked(d_in, d_out):
        return _normal((L, d_in, d_out), d_in ** -0.5, dt, generator, device)

    params = {
        "tok_emb": _normal((cfg.vocab_size, cfg.d_model), 0.02, dt, generator, device),
        "final_norm": torch.ones((cfg.d_model,), device=device),
        "lm_head": _normal((cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5, dt, generator,
                           device),
        "layers": {
            "attn_norm": torch.ones((L, cfg.d_model), device=device),
            "wq": stacked(cfg.d_model, cfg.q_dim),
            "wk": stacked(cfg.d_model, cfg.kv_dim),
            "wv": stacked(cfg.d_model, cfg.kv_dim),
            "wo": stacked(cfg.q_dim, cfg.d_model),
            "mlp_norm": torch.ones((L, cfg.d_model), device=device),
            "w_up": stacked(cfg.d_model, cfg.d_ff),
            "w_down": stacked(cfg.d_ff, cfg.d_model),
        },
    }
    layers = params["layers"]
    if cfg.mlp_type == "swiglu":
        layers["w_gate"] = stacked(cfg.d_model, cfg.d_ff)
    if cfg.head_bias:
        params["lm_head_b"] = torch.zeros((cfg.vocab_size,), device=device)
    if cfg.norm_type == "layer":
        params["final_norm_b"] = torch.zeros((cfg.d_model,), device=device)
        layers["attn_norm_b"] = torch.zeros((L, cfg.d_model), device=device)
        layers["mlp_norm_b"] = torch.zeros((L, cfg.d_model), device=device)
    if cfg.bias:
        for name, width in (("bo", cfg.d_model), ("b_up", cfg.d_ff), ("b_down", cfg.d_model)):
            layers[name] = torch.zeros((L, width), dtype=dt, device=device)
    if cfg.pos_type == "learned":
        params["pos_emb"] = _normal((cfg.pos_len or cfg.max_seq_len, cfg.d_model), 0.01, dt,
                                    generator, device)
    if cfg.attn_bias:
        for name, width in (("bq", cfg.q_dim), ("bk", cfg.kv_dim), ("bv", cfg.kv_dim)):
            params["layers"][name] = torch.zeros((L, width), dtype=dt, device=device)
    if cfg.qk_norm:
        layers["q_norm"] = torch.ones((L, cfg.d_head), device=device)
        layers["k_norm"] = torch.ones((L, cfg.d_head), device=device)
    return params


# ── building blocks ─────────────────────────────────────────────────────


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).to(x.dtype)


def _norm(x: torch.Tensor, cfg: TransformerConfig, weight: torch.Tensor,
          bias: Optional[torch.Tensor]) -> torch.Tensor:
    """rms or layer norm per ``cfg.norm_type`` (LayerNorm in f32 with the
    population variance and its bias, cast back)."""
    if cfg.norm_type == "rms":
        return rms_norm(x, weight, cfg.norm_eps)
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    return ((xf - mean) * torch.rsqrt(var + cfg.norm_eps) * weight + bias).to(x.dtype)


def rope_angles(positions: torch.Tensor, d_head: int, theta: float):
    """(cos, sin) tables for *positions* — [..., d_head // 2]."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, d_head, 2, dtype=torch.float32, device=positions.device) / d_head)
    )
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [batch, heads, seq, d_head]; cos/sin: [batch, seq, d_head/2]."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    cos = cos[:, None]
    sin = sin[:, None]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _split_heads(x: torch.Tensor, n_heads: int, d_head: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, d_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _127(like: torch.Tensor) -> torch.Tensor:
    """127 as a tensor divisor: PyTorch's CUDA divide by a Python number
    multiplies by its rounded reciprocal, an ulp away from JAX's divide."""
    return torch.full_like(like, 127.0)


def _quantize_kv(t: torch.Tensor):
    """[..., d] → (int8 values, bf16 scales [...]) with per-vector amax;
    the bf16-rounded scale is what divides the values (round half even)."""
    tf = t.float()
    amax = tf.abs().amax(-1)
    scale = torch.clamp(amax / _127(amax), min=1e-8).to(torch.bfloat16)
    q = torch.clamp(torch.round(tf / scale[..., None].float()), -127, 127).to(torch.int8)
    return q, scale


# ── int8 weight-only quantization ───────────────────────────────────────

_QUANT_KEYS = {"lm_head", "cond_proj", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}


def _quantize_dense(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., d_in, d_out] → {"q": int8, "s": f32 [..., 1, d_out]}, as the JAX
    runtimes serve it: they quantize inside one ``jax.jit``
    (``materialize_bundle``, ``materialize_params``), where XLA turns
    ``amax / 127`` into a multiply by the f32 reciprocal (``div_const``);
    ``wf / s`` stays a divide there and here."""
    wf = w.float()
    amax = wf.abs().amax(-2, keepdim=True)
    s = torch.clamp(div_const(amax, 127.0), min=1e-8)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_weights_int8(params: Params) -> Params:
    """Matmul weights int8 with per-output-channel scales; embeddings,
    norms and q/k/v biases keep their dtype. ``_qdot`` dispatches on the
    leaf type."""
    out = dict(params)
    for key in ("lm_head", "cond_proj"):
        if key in out:
            out[key] = _quantize_dense(out[key])
    layers = dict(params["layers"])
    for key in list(layers):
        if key in _QUANT_KEYS:
            layers[key] = _quantize_dense(layers[key])
    out["layers"] = layers
    return out


def fuse_decode_weights(params: Params) -> Params:
    """Concatenate q/k/v (their biases into ``bqkv``, and gate/up) along
    the output channel, and pad an int8 lm_head to a 128-multiple width
    (zero weights, unit scales; logits are sliced back to the
    vocabulary)."""
    layers = dict(params["layers"])

    def cat(names):
        vals = [layers.pop(n) for n in names]
        if isinstance(vals[0], dict):
            return {"q": torch.cat([v["q"] for v in vals], dim=-1),
                    "s": torch.cat([v["s"] for v in vals], dim=-1)}
        return torch.cat(vals, dim=-1)

    layers["wqkv"] = cat(["wq", "wk", "wv"])
    if "bq" in layers:
        layers["bqkv"] = cat(["bq", "bk", "bv"])
    if "w_gate" in layers:
        layers["w_gateup"] = cat(["w_gate", "w_up"])
    out = {**params, "layers": layers}
    lm = out.get("lm_head")
    if isinstance(lm, dict):
        pad = (-lm["q"].shape[-1]) % 128
        if pad:
            out["lm_head"] = {
                "q": F.pad(lm["q"], (0, pad)),
                "s": F.pad(lm["s"], (0, pad), value=1.0),
            }
    return out


def unfuse_decode_weights(params: Params, cfg: TransformerConfig) -> Params:
    """The inverse of ``fuse_decode_weights`` (a pure concatenation), for
    saving the canonical unfused tree."""
    layers = dict(params["layers"])

    def split(v, names, sizes):
        lo = 0
        for name, n in zip(names, sizes):
            layers[name] = ({"q": v["q"][..., lo:lo + n], "s": v["s"][..., lo:lo + n]}
                            if isinstance(v, dict) else v[..., lo:lo + n])
            lo += n

    qkv = (cfg.q_dim, cfg.kv_dim, cfg.kv_dim)
    if "wqkv" in layers:
        split(layers.pop("wqkv"), ("wq", "wk", "wv"), qkv)
    if "bqkv" in layers:
        split(layers.pop("bqkv"), ("bq", "bk", "bv"), qkv)
    if "w_gateup" in layers:
        split(layers.pop("w_gateup"), ("w_gate", "w_up"), (cfg.d_ff, cfg.d_ff))
    out = {**params, "layers": layers}
    lm = out.get("lm_head")
    if isinstance(lm, dict) and lm["q"].shape[-1] != cfg.vocab_size:
        out["lm_head"] = {k: v[..., : cfg.vocab_size] for k, v in lm.items()}
    return out


def _qdot(x: torch.Tensor, w, f32_out: bool = False) -> torch.Tensor:
    """x @ w for plain or int8 ({"q","s"}) weights. ``f32_out`` is the
    JAX ``preferred_element_type=f32``: the product is taken in f32."""
    if isinstance(w, dict):
        if f32_out:
            y = torch.matmul(x.float(), w["q"].float())
        else:
            y = torch.matmul(x, w["q"].to(x.dtype))
        return y * w["s"].reshape(w["s"].shape[-1]).to(y.dtype)
    if f32_out:
        return torch.matmul(x.float(), w.float())
    return torch.matmul(x, w)


def _lm_head_logits(x2d: torch.Tensor, params: Params, cfg: TransformerConfig) -> torch.Tensor:
    """[b, d_model] → [b, vocab] f32 logits: the int8 head padded to a
    128-multiple through B4 under ``dense_kernel``, else ``_qdot``."""
    w = params["lm_head"]
    if (_is_i8(w) and cfg.dense_kernel and w["q"].shape[-1] % 128 == 0
            and x2d.shape[-1] % 128 == 0):
        logits = dense_int8_stacked(x2d, w["q"][None], w["s"][None], 0)
    else:
        logits = _qdot(x2d, w, f32_out=True)
    logits = logits[..., : cfg.vocab_size]
    if "lm_head_b" in params:
        logits = logits + params["lm_head_b"].to(logits.dtype)
    return logits


def _is_i8(w) -> bool:
    return isinstance(w, dict) and "q" in w


#: the decode step's paths (``_dense_dispatch``)
QDOT, MEGATAIL, TAIL, FUSED_STEP = "qdot", "megatail", "tail", "fused_step"
MEGALAYER = "megalayer"
MEGATAIL_GELU, TAIL_GELU, DENSE_FNS = "megatail_gelu", "tail_gelu", "dense_fns"


def _dense_dispatch(layers: Params, cfg: TransformerConfig, batch: int, max_len: int) -> str:
    """Which path ``decode_step`` takes: ``_qdot`` per layer; for SwiGLU the
    megatail (B3 prologue, then B2 per layer), with ``VOCALIE_MEGATAIL=0``
    B3 and the tail alone (B8a) per layer, or, at batch 1, the whole step
    after the B3 prologue as one kernel (B7), or, with
    ``VOCALIE_MEGALAYER=1`` and the megatail on, the B3 prologue and then
    one launch per layer (B12) on a lane-packable (d_head 64) or d_head-128
    cache of a 128-multiple length; for GPT-2 the GELU megatail
    (B9a prologue, then B9b per layer) or, with ``VOCALIE_MEGATAIL=0``, B9a
    and B9c per layer; where no fused tail applies (SwiGLU with biases or a
    LayerNorm, a GELU MLP with biases under RMSNorm, a d_ff that is not a
    128-multiple, a GELU MLP without biases), B4 for the qkv and
    o-projections and the int8 SwiGLU MLP (B8b), the int8 GELU MLP (B9d) or
    ``_qdot`` for the MLP. On a card, a batch past what one B2/B8a (B12)
    launch takes runs the same path in row chunks (``tail_rows``,
    ``layer_rows``); widths that no launch takes (normed rows wider than
    2048, no room for the weight ring beside one row) raise ``ValueError``
    where the megatail, the tail or B12 would run: JAX takes B2/B8a and B12
    at any shape, and ``DENSE_FNS`` computes another thing. The JAX ``decode_step``'s choice from
    the config and the shapes (``transformer.py:778-857``; the B7
    conditions of ``maybe_head_stack_qkv``, ``:422-464``, which the JAX
    generate programs apply at batch 1, for the SwiGLU family without
    qk-norm only; B7 goes before B12, as the JAX fused step returns before
    the layer scan). B7 and B12 also need the int8 cache and the decode
    kernel, as in JAX (``kv_packed`` :116, ``maybe_head_stack_qkv``
    :441-442, ``use_megalayer`` :833-841, ``use_fused_step`` :847-857): with
    a bf16 cache or ``VOCALIE_DECODE_KERNEL=0`` the megatail runs instead."""
    dense = (cfg.dense_kernel and _is_i8(layers.get("wqkv")) and _is_i8(layers.get("wo"))
             and layers["wqkv"]["q"].shape[2] % 128 == 0 and cfg.d_model % 128 == 0)
    if not dense:
        return QDOT
    mega = bool_env("VOCALIE_MEGATAIL", True)
    mlp_i8 = _is_i8(layers.get("w_down")) and cfg.d_ff % 128 == 0
    if (cfg.mlp_type == "gelu" and cfg.bias and mlp_i8 and _is_i8(layers.get("w_up"))
            and cfg.norm_type == "layer"):
        return MEGATAIL_GELU if mega else TAIL_GELU
    if not (cfg.mlp_type == "swiglu" and mlp_i8 and _is_i8(layers.get("w_gateup"))
            and cfg.norm_type == "rms" and not cfg.bias):
        return DENSE_FNS
    d_attn, d_ff = layers["wo"]["q"].shape[1], layers["w_down"]["q"].shape[1]
    sms = card_sms(layers["wo"]["q"].device)
    if not mega:
        _tail_on_card(batch, d_attn, cfg.d_model, d_ff, 0, sms)
        return TAIL
    int8_attn = cfg.decode_kernel and cfg.kv_quant
    packed = int8_attn and 2 * cfg.d_head == 128   # the JAX cache's lane-packed k|v
    # at batch 1 the JAX generate programs install the head-stacked qkv
    # (maybe_head_stack_qkv) that sends decode_step to the whole-step kernel
    if (batch == 1 and cfg.n_heads == cfg.n_kv_heads and packed and max_len % 128 == 0
            and cfg.pos_type == "rope" and not cfg.qk_norm
            and bool_env("VOCALIE_FUSED_STEP", True)):
        return FUSED_STEP
    if (int8_attn and (packed or cfg.d_head % 128 == 0) and max_len % 128 == 0
            and bool_env("VOCALIE_MEGALAYER")):
        _layer_on_card(batch, cfg, d_ff, max_len, layers["wqkv"]["q"].shape[2], sms)
        return MEGALAYER
    _tail_on_card(batch, d_attn, cfg.d_model, d_ff, layers["wqkv"]["q"].shape[2], sms)
    return MEGATAIL


def _tail_on_card(batch: int, d_attn: int, d: int, d_ff: int, Q: int, sms) -> None:
    """Raises ``ValueError`` naming the shape where no B2 (``Q`` > 0) or B8a
    launch takes these widths on a card of ``sms`` SMs (``tail_rows``); off
    a card (``sms`` None) the plain versions take any shape."""
    if sms is not None and tail_rows(d_attn, d, d_ff, Q, sms) is None:
        raise ValueError(
            f"the SwiGLU decode step at d_model={d}, d_attn={d_attn}, d_ff={d_ff} ({batch} "
            f"rows) has no B2/B8a launch on this card (normed rows of at most 2048 and a "
            "two-stage weight ring beside one row); the reference takes B2/B8a there")


def _layer_on_card(batch: int, cfg: TransformerConfig, d_ff: int, max_len: int, Q: int,
                   sms) -> None:
    """Raises ``ValueError`` naming the shape where no B12 launch takes the
    layer at one row on a card of ``sms`` SMs (``layer_rows``); a batch past
    what one launch takes runs in row chunks. Off a card the plain version
    takes any shape."""
    kv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    if sms is not None and layer_rows(kv, g, cfg.d_head, max_len, cfg.d_model, d_ff,
                                      _ff_tile(cfg.d_model, d_ff, Q), Q, sms) is None:
        raise ValueError(
            f"the VOCALIE_MEGALAYER=1 decode step at d_model={cfg.d_model}, {cfg.n_heads} q / "
            f"{kv} kv heads of {cfg.d_head}, d_ff={d_ff}, cache {max_len} ({batch} rows) has "
            "no B12 launch on this card, not even at one row; the reference takes B12 there")


def _layer(layers: Params, l: int) -> Params:
    """Layer ``l`` of the stacked tree (views, no copies)."""
    return {k: ({"q": v["q"][l], "s": v["s"][l]} if isinstance(v, dict) else v[l])
            for k, v in layers.items()}


def _block_qkv(layer: Params, x: torch.Tensor, cfg: TransformerConfig, cos, sin, qkv_dot=None):
    """Norm, the qkv projection (``qkv_dot``: B4 in the decode step's
    ``DENSE_FNS`` path, cast to the activation dtype; else ``_qdot`` of the
    fused ``wqkv`` the runtimes serve, or of the unfused ``wq``/``wk``/``wv``
    of the training tree, JAX :563-575), the bias, then the heads."""
    h = _norm(x, cfg, layer["attn_norm"], layer.get("attn_norm_b"))
    if qkv_dot is not None or "wqkv" in layer:
        qkv = qkv_dot(h) if qkv_dot is not None else _qdot(h, layer["wqkv"])
        return _finish_qkv(cfg, _add_qkv_bias(cfg, qkv, layer.get("bqkv")), cos, sin, layer)
    q, k, v = _qdot(h, layer["wq"]), _qdot(h, layer["wk"]), _qdot(h, layer["wv"])
    if cfg.attn_bias:
        q = q + layer["bq"].to(q.dtype)
        k = k + layer["bk"].to(k.dtype)
        v = v + layer["bv"].to(v.dtype)
    return _heads_qkv(cfg, q, k, v, cos, sin, layer)


def _add_qkv_bias(cfg: TransformerConfig, qkv: torch.Tensor, bqkv) -> torch.Tensor:
    """``qkv + bqkv`` (one layer's bias) in qkv's dtype, as the JAX package
    adds it after the projection (and after the cast to the activation
    dtype)."""
    return qkv + bqkv.to(qkv.dtype) if cfg.attn_bias else qkv


def _finish_qkv(cfg: TransformerConfig, qkv, cos, sin, layer: Optional[Params] = None):
    """Split of the fused projection, then ``_heads_qkv``."""
    q = qkv[..., : cfg.q_dim]
    k = qkv[..., cfg.q_dim : cfg.q_dim + cfg.kv_dim]
    v = qkv[..., cfg.q_dim + cfg.kv_dim :]
    return _heads_qkv(cfg, q, k, v, cos, sin, layer)


def _heads_qkv(cfg: TransformerConfig, q, k, v, cos, sin, layer: Optional[Params] = None):
    """Head split, the per-head q/k RMSNorm (``qk_norm``: f32 over d_head,
    cast back to q's dtype, before RoPE, as JAX ``transformer.py:577-580``;
    ``layer`` holds ``q_norm`` / ``k_norm``), then RoPE (none for learned
    positions)."""
    q = _split_heads(q, cfg.n_heads, cfg.d_head)
    k = _split_heads(k, cfg.n_kv_heads, cfg.d_head)
    v = _split_heads(v, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rms_norm(q, layer["q_norm"], cfg.norm_eps)
        k = rms_norm(k, layer["k_norm"], cfg.norm_eps)
    if cfg.pos_type != "rope":
        return q, k, v
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _block_tail(layer: Params, x: torch.Tensor, attn: torch.Tensor, cfg: TransformerConfig,
                o_dot=None, mlp_fn=None):
    """o-projection (``_qdot``, or ``o_dot``: B4), bias, residual, norm,
    MLP (a fused ``w_gateup`` or, in the training tree, ``w_gate`` and
    ``w_up``), residual. ``mlp_fn`` (B8b) replaces the whole MLP and, as in
    JAX, adds no ``b_down``."""
    merged = _merge_heads(attn)
    o = o_dot(merged) if o_dot is not None else _qdot(merged, layer["wo"])
    if cfg.bias:
        o = o + layer["bo"].to(o.dtype)
    x = x + o.to(x.dtype)
    h2 = _norm(x, cfg, layer["mlp_norm"], layer.get("mlp_norm_b"))
    if mlp_fn is not None:
        return x + mlp_fn(h2).to(x.dtype)
    if cfg.mlp_type == "swiglu" and "w_gateup" in layer:   # the runtimes' fused tree
        gu = _qdot(h2, layer["w_gateup"], f32_out=True)
        gate, up = gu[..., : cfg.d_ff], gu[..., cfg.d_ff :]
        hidden = (F.silu(gate) * up).to(x.dtype)
    elif cfg.mlp_type == "swiglu":   # the training tree (JAX :601-606)
        gate = F.silu(_qdot(h2, layer["w_gate"], f32_out=True))
        up = _qdot(h2, layer["w_up"], f32_out=True)
        hidden = (gate * up).to(x.dtype)
    else:   # GPT-2: fc → tanh-GELU → proj
        up = _qdot(h2, layer["w_up"], f32_out=True)
        if cfg.bias:
            up = up + layer["b_up"].to(up.dtype)
        hidden = gelu_tanh(up).to(x.dtype)
    mlp = _qdot(hidden, layer["w_down"], f32_out=True)
    if cfg.bias:
        mlp = mlp + layer["b_down"].to(mlp.dtype)
    return x + mlp.to(x.dtype)


def _dense_fns(lw: Params, cfg: TransformerConfig, l: int):
    """The ``DENSE_FNS`` path's callbacks for layer ``l`` (JAX
    ``_make_dense_fns``, ``transformer.py:906-935``): B4 for the fused qkv
    and the o-projection (f32 out, cast to the input's dtype); for the MLP,
    with int8 weights and a 128-multiple d_ff, B8b for SwiGLU and, for a
    GELU MLP with biases, B9d plus the proj bias (JAX :922-931); else None:
    ``_qdot``."""

    def b4(w):
        return lambda h: dense_int8_stacked(h[:, 0], w["q"], w["s"], l)[:, None, :].to(h.dtype)

    mlp_fn = None
    mlp_i8 = _is_i8(lw.get("w_down")) and cfg.d_ff % 128 == 0
    if cfg.mlp_type == "swiglu" and mlp_i8 and _is_i8(lw.get("w_gateup")):
        def mlp_fn(h2):
            return mlp_swiglu_int8_stacked(h2[:, 0], lw["w_gateup"]["q"], lw["w_gateup"]["s"],
                                           lw["w_down"]["q"], lw["w_down"]["s"], l)[:, None, :]
    elif cfg.mlp_type == "gelu" and cfg.bias and mlp_i8 and _is_i8(lw.get("w_up")):
        def mlp_fn(h2):
            y = mlp_gelu_int8_stacked(h2[:, 0], lw["w_up"]["q"], lw["w_up"]["s"], lw["b_up"],
                                      lw["w_down"]["q"], lw["w_down"]["s"], l)
            return (y + lw["b_down"][l].to(y.dtype))[:, None, :]
    return b4(lw["wqkv"]), b4(lw["wo"]), mlp_fn


# ── forward passes ──────────────────────────────────────────────────────


@torch.no_grad()
def prefill(
    params: Params,
    cfg: TransformerConfig,
    tokens: Optional[torch.Tensor],      # [batch, seq] — unused with inputs_embeds
    lengths: torch.Tensor,               # [batch] valid prompt lengths
    inputs_embeds: Optional[torch.Tensor] = None,
    cache_len: Optional[int] = None,
) -> Tuple[torch.Tensor, StackedKVCache]:
    """Encode the prompt, fill a fresh cache (int8 with scales under
    ``kv_quant``, else k/v in the cache's dtype: JAX :672-695), return
    last-position logits. Attention runs the flash kernel at seq >= 512 and
    the naive f32 softmax below (the JAX package's split: no kernel
    there). With learned positions, caller-built ``inputs_embeds`` carry
    their own positions (XTTS adds its text and mel tables); token prompts
    get the table's first ``s`` rows."""
    x = params["tok_emb"][tokens] if inputs_embeds is None else inputs_embeds
    b, s = x.shape[:2]
    dev = x.device
    cos = sin = None
    if cfg.pos_type == "rope":
        positions = torch.arange(s, device=dev)[None, :].expand(b, s)
        cos, sin = rope_angles(positions, cfg.d_head, cfg.rope_theta)
    elif inputs_embeds is None:
        x = x + params["pos_emb"][:s][None].to(x.dtype)
    attn_fn = flash_attention if s >= 512 else reference_attention

    cache = StackedKVCache.create(cfg.n_layers, b, cfg.n_kv_heads, cache_len or cfg.max_seq_len,
                                  cfg.d_head, dev, dtype=cfg.dtype, quantized=cfg.kv_quant)
    for l in range(cfg.n_layers):
        layer = _layer(params["layers"], l)
        q, k, v = _block_qkv(layer, x, cfg, cos, sin)
        attn = attn_fn(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
        x = _block_tail(layer, x, attn, cfg)
        if cfg.kv_quant:
            k_q, k_s = _quantize_kv(k)
            v_q, v_s = _quantize_kv(v)
            cache.k[l, :, :, :s] = k_q
            cache.v[l, :, :, :s] = v_q
            cache.k_scale[l, :, :, :s] = k_s
            cache.v_scale[l, :, :, :s] = v_s
        else:
            cache.k[l, :, :, :s] = k.to(cache.k.dtype)
            cache.v[l, :, :, :s] = v.to(cache.v.dtype)
    cache.prompt_lengths = lengths.to(device=dev, dtype=torch.int32)
    cache.prompt_pad = s

    x = _norm(x, cfg, params["final_norm"], params.get("final_norm_b"))
    last_idx = torch.clamp(cache.prompt_lengths.long() - 1, 0, s - 1)
    x_last = x[torch.arange(b, device=dev), last_idx]
    return _lm_head_logits(x_last, params, cfg), cache


@torch.no_grad()
def decode_step(
    params: Params,
    cfg: TransformerConfig,
    token: torch.Tensor,      # [batch] — previous token
    cache: StackedKVCache,
) -> Tuple[torch.Tensor, StackedKVCache]:
    """One AR step: (logits [b, vocab] f32, cache). The cache stays
    read-only through the layer loop (the current token's k/v merge
    inside the attention kernel); the step's k/v of all layers are then
    quantized and appended in place by ONE kernel launch.

    With the dense path's megatail (``_dense_dispatch``), layer 0's raw
    qkv comes from B3 (B9a for GPT-2) and each layer's B2 (B9b) returns
    the layer output and the next layer's raw qkv, carried through the
    loop; the last layer's (computed from its own weights, the clamped
    index) is dropped. Without the megatail, every layer takes B3 and B8a
    (GPT-2: B9a and B9c). With the fused step, layer 0's q/k/v come from
    B3 and every layer runs in B7 (``_fused_step``). With the megalayer,
    layer 0's raw qkv comes from B3 and each layer's B12 takes the q/k/v
    of its raw qkv (bias, q/k norm, RoPE applied here) and returns the layer
    output, cast to the activation dtype every layer as JAX does, and the
    next layer's raw qkv. The ``DENSE_FNS``
    path runs B4 for the qkv and o-projections and B8b, B9d (or ``_qdot``)
    for the MLP. Learned positions add the table's row ``n_decoded + 1``
    (``decode_relative``) or the row's length (``absolute``) to the token
    embedding.

    Attention per layer: with ``decode_kernel`` a kernel reads the cache in
    place (``decode_attention_stacked``: B1 on an int8 cache of a
    128-multiple length, B1w on any other, K1 on the float cache); without,
    JAX's XLA branch in plain PyTorch (``_xla_attention``). The append:
    ``_decode_step_finish``."""
    b = token.shape[0]
    x = params["tok_emb"][token][:, None, :]  # [b, 1, d_model]
    cos = sin = None
    if cfg.pos_type == "rope":
        cos, sin = rope_angles(cache.length[:, None], cfg.d_head, cfg.rope_theta)
    else:
        pos = (torch.full((b,), cache.n_decoded + 1, device=x.device)
               if cfg.pos_index == "decode_relative" else cache.length.long())
        x = x + params["pos_emb"][pos][:, None, :].to(x.dtype)
    write_pos = cache.prompt_pad + cache.n_decoded
    if write_pos >= cache.max_len:
        raise ValueError(f"KV cache full ({cache.max_len} slots)")
    attend = cache.valid_mask()
    bias2d = torch.where(attend, 0.0, MASK_VALUE).to(torch.float32)
    sm_scale = 1.0 / math.sqrt(cfg.d_head)
    group = cfg.n_heads // cfg.n_kv_heads
    lw = params["layers"]
    path = _dense_dispatch(lw, cfg, b, cache.max_len)
    if path in (MEGATAIL, FUSED_STEP, MEGALAYER):
        qkv_raw = qkv_norm_int8_stacked(x[:, 0], lw["attn_norm"], lw["wqkv"]["q"],
                                        lw["wqkv"]["s"], 0, eps=cfg.norm_eps)
    if path == FUSED_STEP:
        return _fused_step(params, cfg, cache, x, qkv_raw, cos, sin, bias2d, write_pos, sm_scale)
    gelu = path in (MEGATAIL_GELU, TAIL_GELU)
    if path == MEGATAIL_GELU:
        qkv_raw = _qkv_lnorm(x, lw, cfg, 0)
    megatail = path in (MEGATAIL, MEGATAIL_GELU)

    k_news, v_news = [], []
    for l in range(cfg.n_layers):
        layer = _layer(lw, l)
        o_dot = mlp_fn = None
        if path == TAIL_GELU:
            qkv_raw = _qkv_lnorm(x, lw, cfg, l)
        elif path == TAIL:
            qkv_raw = qkv_norm_int8_stacked(x[:, 0], lw["attn_norm"], lw["wqkv"]["q"],
                                            lw["wqkv"]["s"], l, eps=cfg.norm_eps)
        if path in (QDOT, DENSE_FNS):
            qkv_dot = None
            if path == DENSE_FNS:
                qkv_dot, o_dot, mlp_fn = _dense_fns(lw, cfg, l)
            q, k_new, v_new = _block_qkv(layer, x, cfg, cos, sin, qkv_dot)
        else:
            qkv = _add_qkv_bias(cfg, qkv_raw[:, None, :].to(x.dtype), layer.get("bqkv"))
            q, k_new, v_new = _finish_qkv(cfg, qkv, cos, sin, layer)
        kn = k_new[:, :, 0, :].float().contiguous()  # [b, kv, d]
        vn = v_new[:, :, 0, :].float().contiguous()
        qg = q.reshape(b, cfg.n_kv_heads, group, cfg.d_head).float().contiguous()
        if path == MEGALAYER:
            x_out, qkv_raw = layer_swiglu_qkv_int8_stacked(
                qg, x[:, 0].float().contiguous(), cache.k, cache.v, cache.k_scale, cache.v_scale,
                bias2d, kn, vn, l, write_pos, lw["wo"]["q"], lw["wo"]["s"], lw["mlp_norm"],
                lw["w_gateup"]["q"], lw["w_gateup"]["s"], lw["w_down"]["q"], lw["w_down"]["s"],
                lw["attn_norm"], lw["wqkv"]["q"], lw["wqkv"]["s"], sm_scale=sm_scale,
                eps=cfg.norm_eps)
            x = x_out[:, None, :].to(x.dtype)
            k_news.append(kn)
            v_news.append(vn)
            continue
        if cfg.decode_kernel:
            attn = decode_attention_stacked(
                qg, cache.k, cache.v, bias2d, l, cache.k_scale, cache.v_scale, kn, vn,
                valid_len=write_pos, sm_scale=sm_scale, int8_dots=cfg.kv_quant,
            )
        else:
            attn = _xla_attention(cache, l, q, k_new, v_new, bias2d, sm_scale)
        if gelu:
            # the f32 attention output goes in as it is (no cast to x.dtype)
            tail = (attn.reshape(b, cfg.q_dim), x[:, 0], lw["wo"]["q"], lw["wo"]["s"], lw["bo"],
                    lw["mlp_norm"], lw["mlp_norm_b"], lw["w_up"]["q"], lw["w_up"]["s"],
                    lw["b_up"], lw["w_down"]["q"], lw["w_down"]["s"], lw["b_down"])
            if megatail:
                x_out, qkv_raw = tail_gelu_qkv_int8_stacked(
                    *tail, lw["attn_norm"], lw["attn_norm_b"], lw["wqkv"]["q"],
                    lw["wqkv"]["s"], l, eps=cfg.norm_eps)
            else:
                x_out = tail_gelu_int8_stacked(*tail, l, eps=cfg.norm_eps)
            x = x_out[:, None, :].to(x.dtype)
        elif path in (MEGATAIL, TAIL):
            # the f32 attention output goes in as it is (no cast to x.dtype)
            tail = (attn.reshape(b, cfg.q_dim), x[:, 0], lw["wo"]["q"], lw["wo"]["s"],
                    lw["mlp_norm"], lw["w_gateup"]["q"], lw["w_gateup"]["s"],
                    lw["w_down"]["q"], lw["w_down"]["s"])
            if megatail:
                x_out, qkv_raw = tail_swiglu_qkv_int8_stacked(
                    *tail, lw["attn_norm"], lw["wqkv"]["q"], lw["wqkv"]["s"], l,
                    eps=cfg.norm_eps)
            else:
                x_out = tail_swiglu_int8_stacked(*tail, l, eps=cfg.norm_eps)
            x = x_out[:, None, :].to(x.dtype)
        else:
            attn = attn.reshape(b, cfg.n_heads, 1, cfg.d_head).to(x.dtype)
            x = _block_tail(layer, x, attn, cfg, o_dot, mlp_fn)
        k_news.append(kn)
        v_news.append(vn)
    return _decode_step_finish(params, cfg, cache, x, torch.stack(k_news), torch.stack(v_news),
                               write_pos)


def _xla_attention(cache, l, q, k_new, v_new, bias2d, sm_scale):
    """JAX's XLA decode-attention branch (``transformer.py:1028-1059``) in
    plain PyTorch, on layer ``l``: both products take f32 sums of operands
    in the activation dtype (q ``[b, H, 1, d]`` and the current token's k/v
    ``[b, kv, 1, d]`` come in it; the cache is cast to it), as JAX's
    ``preferred_element_type``; the int8 cache's scales fold into the
    scores and the probabilities; p is cast to the activation dtype before
    the PV product; the current token's column merges flash-style in f32.
    The f32 products run without TF32 (PyTorch's CUDA matmul default).
    Returns ``[b, kv, g, d]`` f32."""
    f32 = torch.float32
    b, H, _, d = q.shape
    kv = k_new.shape[1]
    dt = q.dtype
    qg = q.reshape(b, kv, H // kv, d).to(f32)
    s = torch.matmul(qg, cache.k[l].to(dt).to(f32).transpose(-1, -2)) * sm_scale
    if cache.k_scale is not None:
        s = s * cache.k_scale[l][:, :, None, :].to(f32)
    s = s + bias2d[:, None, None, :]
    s_new = (qg * k_new[:, :, 0].to(f32)[:, :, None, :]).sum(-1, keepdim=True) * sm_scale
    m = torch.maximum(s.amax(-1, keepdim=True), s_new)
    p = torch.exp(s - m)
    p_new = torch.exp(s_new - m)
    denom = p.sum(-1, keepdim=True) + p_new
    if cache.v_scale is not None:
        p = p * cache.v_scale[l][:, :, None, :].to(f32)
    attn = torch.matmul(p.to(dt).to(f32), cache.v[l].to(dt).to(f32))
    return (attn + p_new * v_new[:, :, 0].to(f32)[:, :, None, :]) / denom


def _qkv_lnorm(x, lw, cfg, l):
    """B9a: LayerNorm + the fused int8 qkv of layer ``l`` → [b, d_qkv] f32."""
    return qkv_lnorm_int8_stacked(x[:, 0], lw["attn_norm"], lw["attn_norm_b"], lw["wqkv"]["q"],
                                  lw["wqkv"]["s"], l, eps=cfg.norm_eps)


def _fused_step(params, cfg, cache, x, qkv_raw, cos, sin, bias2d, write_pos, sm_scale):
    """The batch-1 step through B7 (JAX ``transformer.py:858-904``): layer
    0's q/k/v from the B3 prologue (cast to the activation dtype, plus the
    bias, RoPE), then every layer in one kernel on the f32 residual. The
    kernel's row l is layer l + 1's k/v: the layer-0 k/v is prepended and
    the last row (a successor that does not exist) dropped."""
    lw = params["layers"]
    qkv0 = _add_qkv_bias(cfg, qkv_raw[:, None, :].to(x.dtype),
                         lw["bqkv"][0] if cfg.attn_bias else None)
    q0, k0, v0 = _finish_qkv(cfg, qkv0, cos, sin)           # [1, H, 1, d]
    c, s = cos[:, 0].float(), sin[:, 0].float()             # [1, d / 2]
    cos_f, sin_f = torch.cat([c, c], -1), torch.cat([-s, s], -1)
    kn0 = k0[0, :, 0].float().contiguous()                  # [H, d]
    vn0 = v0[0, :, 0].float().contiguous()
    x_fin, kn_nxt, vn_nxt = decode_step_fused_packed(
        q0[0].float().contiguous(), kn0, vn0, x[:, 0].float().contiguous(),
        cache.k, cache.v, cache.k_scale, cache.v_scale, bias2d,
        lw["wo"]["q"], lw["wo"]["s"], lw["mlp_norm"],
        lw["w_gateup"]["q"], lw["w_gateup"]["s"], lw["w_down"]["q"], lw["w_down"]["s"],
        lw["attn_norm"], lw["wqkv"]["q"], lw["wqkv"]["s"],
        lw["bqkv"] if cfg.attn_bias else None, cos_f, sin_f,
        sm_scale=sm_scale, eps=cfg.norm_eps,
    )
    x = x_fin[:, None, :].to(x.dtype)
    k_news = torch.cat([kn0[None], kn_nxt[:-1]])[:, None]   # [L, 1, H, d]
    v_news = torch.cat([vn0[None], vn_nxt[:-1]])[:, None]
    return _decode_step_finish(params, cfg, cache, x, k_news, v_news, write_pos)


def _decode_step_finish(params, cfg, cache, x, k_news, v_news, write_pos):
    """Append the step's [L, b, kv, d] k/v in place at ``write_pos`` (JAX
    :1148-1220): quantized with their scales on the int8 cache, cast to the
    cache's dtype otherwise; with the decode or dense kernels on, one kernel
    launch for all layers (B5 with scales, K4 without), else JAX's
    ``dynamic_update_slice`` as slice assignment. Then final norm + head."""
    pallas_write = cfg.decode_kernel or cfg.dense_kernel
    if cfg.kv_quant:
        k_q, k_s = _quantize_kv(k_news)
        v_q, v_s = _quantize_kv(v_news)
        if pallas_write:
            cache_append_stacked(cache.k, cache.v, cache.k_scale, cache.v_scale,
                                 k_q, v_q, k_s, v_s, write_pos)
        else:
            for arr, new in ((cache.k, k_q), (cache.v, v_q), (cache.k_scale, k_s),
                             (cache.v_scale, v_s)):
                arr[:, :, :, write_pos] = new
    else:
        k_c, v_c = k_news.to(cache.k.dtype), v_news.to(cache.v.dtype)
        if pallas_write:
            cache_append_kv_stacked(cache.k, cache.v, k_c, v_c, write_pos)
        else:
            cache.k[:, :, :, write_pos] = k_c
            cache.v[:, :, :, write_pos] = v_c
    cache.n_decoded += 1
    decode_step.steps += 1
    x = _norm(x, cfg, params["final_norm"], params.get("final_norm_b"))
    return _lm_head_logits(x[:, 0], params, cfg), cache


#: decode steps run, every path's counted where it ends (read beside the
#: kernels' launch counters: a path without an append kernel has no launch
#: to count its steps by)
decode_step.steps = 0


def forward_all_logits(params: Params, cfg: TransformerConfig, tokens: torch.Tensor, *,
                       use_flash: bool = False, mesh=None) -> torch.Tensor:
    """Causal forward returning f32 logits at EVERY position (the training
    path, JAX :1229-1276), under autograd. Attention is
    :func:`reference_attention` (the f32 softmax, differentiated by
    autograd), or with ``use_flash`` the flash kernel with its kernel
    backward (``flash_attention_trainable``: B6t forward, B11 backward).
    ``params`` is the unfused tree (``init_params``); the stacked layer
    leaves are unbound once, so each gets its gradient in one stack."""
    if mesh is not None:
        raise NotImplementedError(
            "a mesh runs the flash kernel under shard_map over dp x tp in the JAX package; the "
            "port trains on one GPU until torch.distributed is ported (ROADMAP A8)"
        )
    b, s = tokens.shape
    x = params["tok_emb"][tokens]
    cos = sin = None
    if cfg.pos_type == "rope":
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        cos, sin = rope_angles(positions, cfg.d_head, cfg.rope_theta)
    else:
        x = x + params["pos_emb"][:s][None].to(x.dtype)

    def attn_fn(q, k, v):
        if use_flash:
            return flash_attention_trainable(q.contiguous(), k.contiguous(), v.contiguous(), True)
        return reference_attention(q, k, v, causal=True)

    per_layer = {k: v.unbind(0) for k, v in params["layers"].items()}
    for l in range(cfg.n_layers):
        layer = {k: v[l] for k, v in per_layer.items()}
        q, k, v = _block_qkv(layer, x, cfg, cos, sin)
        x = _block_tail(layer, x, attn_fn(q, k, v), cfg)
    x = _norm(x, cfg, params["final_norm"], params.get("final_norm_b"))
    logits = _qdot(x, params["lm_head"], f32_out=True)
    if "lm_head_b" in params:
        logits = logits + params["lm_head_b"].to(logits.dtype)
    return logits


__all__ = [
    "TransformerConfig",
    "StackedKVCache",
    "MASK_VALUE",
    "init_params",
    "rms_norm",
    "rope_angles",
    "apply_rope",
    "quantize_weights_int8",
    "fuse_decode_weights",
    "unfuse_decode_weights",
    "prefill",
    "decode_step",
    "forward_all_logits",
]
