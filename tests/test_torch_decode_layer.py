"""The port's whole-layer decode kernel B12 (``layer_swiglu_qkv_int8_stacked``,
``VOCALIE_MEGALAYER=1``) in its plain version against the JAX kernel, run in
Pallas interpret mode on the CPU as the JAX package's own tests run it.
Inputs are made with numpy from a seed:

- both JAX bodies: packed (d_head 64, g = 1; the lane-packed cache is built
  from the port's split bytes, k in lanes [0, d) and v in [d, 2d) of
  [L, b, kv, T, 2d]) and split (d_head 128, GQA g = 2);
- valid_len inside the first 128-slot block, across blocks and exactly on a
  block boundary, at layer 0 and at the last layer (whose next qkv is read
  from itself, the clamped index);
- bf16-valued q and residual rows, as the bf16 decode step gives them.

Tolerance: x_out and qkv_next within 1e-5 · max|ref| (B2's,
``tests/test_torch_decode_dense.py``), with .5 ties recognized: the jitted
kernel body computes ``amax / 127`` as ``amax · (1/127)`` (XLA's divide by a
constant, ROADMAP C), an ulp from the divide the port and the CUDA kernel
take. With 8-bit mantissas ``127 · q / amax`` often lands exactly on a .5
tie, which then rounds the other way and moves the output by ~1e-2. Where
the port misses the tolerance, the same plain version with JAX's scale form
must meet it (``_assert_up_to_ties``).

B1 followed by B2 is not B12: B2 quantizes the whole [h · d] attention row
with one scale, B12 each head's chunk with its own; the pair misses B12's
output by far more than the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.ops import decode_layer as jl
from vocalie_tts_tpu_torch.device import div_const
from vocalie_tts_tpu_torch.ops import decode_attention as pa
from vocalie_tts_tpu_torch.ops import decode_dense as pd
from vocalie_tts_tpu_torch.ops import decode_layer as pl

TOL = 1e-5
EPS = 1e-5
NEG = -0.7 * float(np.finfo(np.float32).max)
L, B, T, D, F = 3, 4, 384, 256, 512
#: the two JAX bodies: (packed, kv heads, group, d_head)
BODIES = {"packed-d64-g1": (True, 2, 1, 64), "split-d128-g2": (False, 1, 2, 128)}
#: (valid_len, layer): inside the first block, across blocks, on a block
#: boundary (two and one blocks)
CASES = [(50, 0), (200, L - 1), (256, 0), (128, L - 1)]


def _quant_cols(rng, d_in, d_out, n):
    w = rng.randn(n, d_in, d_out).astype(np.float32)
    s = (np.abs(w).max(axis=1, keepdims=True) / 127.0 + 1e-8).astype(np.float32)
    return np.clip(np.round(w / s), -127, 127).astype(np.int8), s


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _inputs(seed, kv, g, d, valid, bf16_rows=False):
    """The B12 arguments before ``layer`` (q .. v_new) and after
    ``valid_len`` (wo .. sq), numpy; k/v scales bf16-valued f32. Rows' prompt
    lengths are drawn below ``valid``."""
    rng = np.random.RandomState(seed)
    H = kv * g
    q = rng.randn(B, kv, g, d).astype(np.float32)
    x = rng.randn(B, D).astype(np.float32)
    if bf16_rows:
        q, x = _bf16(q), _bf16(x)
    k = rng.randint(-127, 128, (L, B, kv, T, d)).astype(np.int8)
    v = rng.randint(-127, 128, (L, B, kv, T, d)).astype(np.int8)
    ks, vs = (_bf16((rng.rand(L, B, kv, T) + 0.5) / 127) for _ in range(2))
    lens = rng.randint(1, valid + 1, (B,))
    bias = np.where(np.arange(T)[None] < lens[:, None], 0.0, NEG).astype(np.float32)
    kn, vn = (rng.randn(B, kv, d).astype(np.float32) for _ in range(2))
    wo, wos = _quant_cols(rng, H * d, D, L)
    mw = (1 + 0.1 * rng.randn(L, D)).astype(np.float32)
    wgu, sgu = _quant_cols(rng, D, 2 * F, L)
    wd, sd = _quant_cols(rng, F, D, L)
    nw = (1 + 0.1 * rng.randn(L, D)).astype(np.float32)
    wq, sq = _quant_cols(rng, D, (H + 2 * kv) * d, L)
    return (q, x, k, v, ks, vs, bias, kn, vn), (wo, wos, mw, wgu, sgu, wd, sd, nw, wq, sq)


def _jax(head, tail, layer, valid, packed, d):
    q, x, k, v, ks, vs, bias, kn, vn = head
    k_all = np.concatenate([k, v], -1) if packed else k
    out = jl.layer_swiglu_qkv_int8_stacked(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(k_all), None if packed else jnp.asarray(v),
        jnp.asarray(ks).astype(jnp.bfloat16), jnp.asarray(vs).astype(jnp.bfloat16),
        jnp.asarray(bias), jnp.asarray(kn), jnp.asarray(vn), layer, valid,
        *map(jnp.asarray, tail), sm_scale=d ** -0.5, eps=EPS, packed=packed)
    return [np.asarray(o) for o in out]


def _port(head, tail, layer, valid, d):
    q, x, k, v, ks, vs, bias, kn, vn = (torch.from_numpy(a) for a in head)
    ks, vs = ks.to(torch.bfloat16), vs.to(torch.bfloat16)
    out = pl.layer_swiglu_qkv_int8_stacked(q, x, k, v, ks, vs, bias, kn, vn, layer, valid,
                                           *map(torch.from_numpy, tail), sm_scale=d ** -0.5,
                                           eps=EPS)
    return [o.numpy() for o in out]


def _close(got, ref):
    return all(np.abs(g - r).max() <= TOL * np.abs(r).max() for g, r in zip(got, ref))


def _jit_form_quantize_rows(x, floor=1e-8):
    """``_quantize_rows`` with the jitted JAX scale, ``amax · f32(1/127)``."""
    a = x.abs().amax(-1, keepdim=True)
    s = torch.clamp(div_const(a, 127.0), min=floor)
    return torch.round(x / s), s


def _assert_up_to_ties(run, ref, monkeypatch) -> bool:
    """``run()`` within TOL of ``ref``, or else within it with JAX's scale
    form in every activation quantizer of the plain version (a .5 tie that
    the two forms round apart). Returns whether the tie was needed."""
    got = run()
    if _close(got, ref):
        return False
    with monkeypatch.context() as m:
        for mod in (pa, pd, pl):
            m.setattr(mod, "_quantize_rows", _jit_form_quantize_rows)
        tied = run()
    errs = [np.abs(g - r).max() / np.abs(r).max() for g, r in zip(got, ref)]
    assert _close(tied, ref), f"off by {errs} x max|ref|, not explained by a .5 tie"
    return True


@pytest.mark.parametrize("valid,layer", CASES, ids=[f"valid{v}-layer{l}" for v, l in CASES])
@pytest.mark.parametrize("body", sorted(BODIES))
def test_plain_matches_jax(body, valid, layer):
    packed, kv, g, d = BODIES[body]
    head, tail = _inputs(valid + layer, kv, g, d, valid)
    ref = _jax(head, tail, layer, valid, packed, d)
    got = _port(head, tail, layer, valid, d)
    assert got[0].shape == (B, D) and got[1].shape == (B, (kv * g + 2 * kv) * d)
    assert _close(got, ref), [np.abs(a - r).max() / np.abs(r).max() for a, r in zip(got, ref)]


def test_bf16_rows_match_jax_up_to_ties(monkeypatch):
    """Four seeds of bf16-valued q and x rows for each body; at least one
    of them puts an int8 activation on a .5 tie that the two scale forms
    round apart (so the tie check above is live)."""
    ties = 0
    for body in sorted(BODIES):
        packed, kv, g, d = BODIES[body]
        for seed in range(4):
            head, tail = _inputs(seed, kv, g, d, 300, bf16_rows=True)
            ref = _jax(head, tail, 1, 200, packed, d)
            ties += _assert_up_to_ties(lambda: _port(head, tail, 1, 200, d), ref, monkeypatch)
    assert ties >= 1


def test_b1_then_b2_is_not_b12():
    """The two-kernel pair (B1's attention, then B2 on the merged row) on
    the same inputs lands far outside B12's tolerance: B12's o-projection
    scales each head's chunk on its own."""
    packed, kv, g, d = BODIES["split-d128-g2"]
    head, tail = _inputs(7, kv, g, d, 300)
    ref = _jax(head, tail, 1, 200, packed, d)
    q, x, k, v, ks, vs, bias, kn, vn = (torch.from_numpy(a) for a in head)
    ks, vs = ks.to(torch.bfloat16), vs.to(torch.bfloat16)
    attn = pa.decode_attention_plain(q, k, v, bias, 1, ks, vs, kn, vn, 200, d ** -0.5)
    pair = pd.tail_swiglu_qkv_int8_plain(attn.reshape(B, -1), x, *map(torch.from_numpy, tail), 1,
                                         eps=EPS)
    errs = [np.abs(p.numpy() - r).max() / np.abs(r).max() for p, r in zip(pair, ref)]
    assert min(errs) > 100 * TOL, errs


def test_refused_shapes():
    packed, kv, g, d = BODIES["packed-d64-g1"]
    head, tail = _inputs(3, kv, g, d, 100)
    args = [torch.from_numpy(a) for a in head]
    args[4], args[5] = args[4].to(torch.bfloat16), args[5].to(torch.bfloat16)
    w = list(map(torch.from_numpy, tail))
    short = list(args)
    short[2], short[3] = args[2][:, :, :, :T - 64], args[3][:, :, :, :T - 64]
    short[4], short[5], short[6] = args[4][..., :T - 64], args[5][..., :T - 64], args[6][:, :T - 64]
    with pytest.raises(ValueError, match="multiple of 128"):
        pl.layer_swiglu_qkv_int8_stacked(*short, 0, 50, *w, sm_scale=0.125, eps=EPS)
    w[3], w[4], w[5] = w[3][..., :384], w[4][..., :384], w[5][:, :192]   # d_ff 192
    with pytest.raises(ValueError, match="128-multiple"):
        pl.layer_swiglu_qkv_int8_stacked(*args, 0, 50, *w, sm_scale=0.125, eps=EPS)
