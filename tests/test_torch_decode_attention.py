"""Kernel B1 (int8 decode attention): the port's plain version against
``decode_attention_stacked(..., int8_dots=True, valid_len=...)`` run in
Pallas interpret mode, on both T-blocked branches: the packed one (d=64,
the JAX cache packed k|v from the same int8 values) and the unpacked one
(d=16).

Tolerance: atol 5e-4 on unit-scale inputs (outputs ~0.05), and a mean
relative error below 1e-3. Both sides re-quantize q and p to int8 in
f32; an element sitting on a rounding boundary may round the other way
under the two libraries' different exp/summation order, moving a p by
one step. A p block of other than 128 slots moves the output by more
than four times the tolerance (the test below).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.ops.decode_attention import decode_attention_stacked as jax_attn
from vocalie_tts_tpu_torch.bridge import to_torch
from vocalie_tts_tpu_torch.ops import decode_attention as da
from vocalie_tts_tpu_torch.ops.decode_attention import (
    decode_attention_plain,
    decode_attention_stacked,
)

NEG = -0.7 * float(np.finfo(np.float32).max)


def _case(seed, L, b, kv, g, T, d, prompt_pad, n_dec):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, d)).astype(np.float32)
    k = rng.integers(-127, 128, (L, b, kv, T, d), dtype=np.int8)
    v = rng.integers(-127, 128, (L, b, kv, T, d), dtype=np.int8)
    ks = jnp.asarray(rng.uniform(0.5, 1.5, (L, b, kv, T)).astype(np.float32) / 127, jnp.bfloat16)
    vs = jnp.asarray(rng.uniform(0.5, 1.5, (L, b, kv, T)).astype(np.float32) / 127, jnp.bfloat16)
    kn = rng.standard_normal((b, kv, d)).astype(np.float32)
    vn = rng.standard_normal((b, kv, d)).astype(np.float32)
    # per-row prompt lengths leave masked slots inside the valid blocks
    lens = rng.integers(1, prompt_pad + 1, (b,))
    pos = np.arange(T)[None, :]
    valid = (pos < lens[:, None]) | ((pos >= prompt_pad) & (pos < prompt_pad + n_dec))
    bias = np.where(valid, 0.0, NEG).astype(np.float32)
    return q, k, v, ks, vs, bias, kn, vn


CASES = [
    # (branch, L, b, kv, g, T, d, prompt_pad, n_decoded, layer)
    ("packed", 2, 3, 2, 1, 512, 64, 256, 44, 1),     # valid_len 300: not a 128-multiple
    ("packed", 1, 2, 2, 2, 256, 64, 100, 28, 0),     # GQA, valid_len exactly 128
    ("unpacked", 2, 2, 2, 2, 384, 16, 200, 57, 1),   # GQA, valid_len 257
    ("unpacked", 1, 4, 1, 1, 128, 16, 3, 2, 0),      # valid_len 5: one mostly-masked block
]


@pytest.mark.parametrize("branch,L,b,kv,g,T,d,prompt_pad,n_dec,layer", CASES)
def test_decode_attention_matches_jax(branch, L, b, kv, g, T, d, prompt_pad, n_dec, layer):
    q, k, v, ks, vs, bias, kn, vn = _case(T + d + g, L, b, kv, g, T, d, prompt_pad, n_dec)
    valid_len = prompt_pad + n_dec
    sm = 1.0 / np.sqrt(d)
    if branch == "packed":
        kv_all = jnp.concatenate([jnp.asarray(k), jnp.asarray(v)], axis=-1)
        ref = jax_attn(jnp.asarray(q), kv_all, None, jnp.asarray(bias), jnp.asarray(layer),
                       ks, vs, jnp.asarray(kn), jnp.asarray(vn),
                       valid_len=jnp.asarray(valid_len, jnp.int32), sm_scale=sm,
                       int8_dots=True, packed=True)
    else:
        ref = jax_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
                       jnp.asarray(layer), ks, vs, jnp.asarray(kn), jnp.asarray(vn),
                       valid_len=jnp.asarray(valid_len, jnp.int32), sm_scale=sm,
                       int8_dots=True)
    ref = np.asarray(ref)
    out = decode_attention_stacked(
        *(to_torch(np.asarray(a)) for a in (q, k, v, bias)), layer,
        *(to_torch(np.asarray(a)) for a in (ks, vs, kn, vn)),
        valid_len=valid_len, sm_scale=sm, int8_dots=True,
    ).numpy()
    assert out.shape == ref.shape == (b, kv, g, d)
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=0)
    rel = np.abs(out - ref).mean() / np.abs(ref).mean()
    assert rel < 1e-3, rel


@pytest.mark.parametrize("tblk", [64, 256, 640])
def test_kernel_tolerance_catches_a_wrong_p_block(monkeypatch, tblk):
    """``chip_smoke.py`` holds the CUDA kernel to atol 5e-4 against the
    plain version at the main path's shape (b 16, kv 16, d 64, cache 640,
    valid_len 416). A kernel that re-quantized p per block of other than
    128 slots must fall outside it: the plain version run with such a
    block moves by more than four times that tolerance."""
    q, k, v, ks, vs, bias, kn, vn = _case(1, 1, 16, 16, 1, 640, 64, 256, 160)
    args = [to_torch(np.asarray(a)) for a in (q, k, v, bias, ks, vs, kn, vn)]
    ref = decode_attention_plain(*args[:4], 0, *args[4:], 416, 0.125)
    monkeypatch.setattr(da, "TBLK", tblk)
    wrong = decode_attention_plain(*args[:4], 0, *args[4:], 416, 0.125)
    assert (wrong - ref).abs().max().item() > 4 * 5e-4


def test_decode_attention_skips_blocks_past_valid_len():
    """Garbage past the valid blocks must not leak into the result."""
    q, k, v, ks, vs, bias, kn, vn = _case(1, 1, 2, 2, 1, 256, 16, 60, 4)
    args = [to_torch(np.asarray(a)) for a in (q, k, v, bias, ks, vs, kn, vn)]
    base = decode_attention_stacked(*args[:4], 0, *args[4:], valid_len=64, sm_scale=0.25,
                                    int8_dots=True)
    args[1][..., 128:, :] = 127
    args[3][:, 128:] = 0.0  # even unmasked, a skipped block is never read
    again = decode_attention_stacked(*args[:4], 0, *args[4:], valid_len=64, sm_scale=0.25,
                                    int8_dots=True)
    assert torch.equal(base, again)
