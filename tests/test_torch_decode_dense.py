"""The port's dense decode kernels' plain versions (B4 ``dense_int8_stacked``,
B3 ``qkv_norm_int8_stacked``, B2 ``tail_swiglu_qkv_int8_stacked``) against
the JAX kernels, run in Pallas interpret mode on the CPU as the JAX
package's own tests run them (``VOCALIE_TILE_MB`` unset). Inputs are made
with numpy from a seed, at the shapes of ``tests/test_decode_dense.py``,
and B2 once at the full T3 layer width (d_model 1024, d_ff 4096, qkv 3072),
where the hidden is quantized in two d_ff tiles of 2048.

Tolerances:
- B4 and B3: 1e-4 · max|ref|, the JAX test's bound for the exact integer
  path (``tests/test_decode_dense.py:39``). The products are exact on both
  sides; what is left is the f32 epilogue and, for B3, the RMSNorm, whose
  mean and rsqrt the two libraries round differently in the last ulp.
- B2: x within 1e-5 · max|x| and qkv within 1e-4 · max|qkv|: the JAX
  test's atol 1e-5 / 1e-4 (``tests/test_decode_dense.py:150-151``), taken
  relative to the output's scale, since x reaches 5e3 to 2e5 with these
  unscaled weights and an f32 ulp there is 5e-4 to 2e-2. An int8 activation
  that flips by one at a .5 tie would exceed both; none does at these seeds.
- A hidden quantized in one block instead of per d_ff tile misses the x
  tolerance at full width by over 100x (``test_one_block_hidden_is_caught``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.ops import decode_dense as jd
from vocalie_tts_tpu_torch.ops import decode_dense as pd

EPS = 1e-5


def _quant_cols(rng, d_in, d_out, L):
    """Per-output-channel int8 weights and scales, as the JAX test makes them."""
    w = rng.randn(L, d_in, d_out).astype(np.float32)
    s = (np.abs(w).max(axis=1, keepdims=True) / 127.0 + 1e-8).astype(np.float32)
    return np.clip(np.round(w / s), -127, 127).astype(np.int8), s


def _rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max()


@pytest.mark.parametrize("layer", [0, 2])
def test_dense_int8_matches_jax(layer):
    rng = np.random.RandomState(0)
    L, b, d_in, d_out = 3, 8, 256, 384
    x = rng.randn(b, d_in).astype(np.float32)
    q, s = _quant_cols(rng, d_in, d_out, L)
    ref = jd.dense_int8_stacked(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), layer)
    got = pd.dense_int8_stacked(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s),
                                layer)
    assert got.dtype == torch.float32 and got.shape == (b, d_out)
    assert _rel(got.numpy(), ref) < 1e-4


def test_dense_int8_bf16_rows_match_jax():
    """The lm_head's input is the bf16 residual stream at full width."""
    rng = np.random.RandomState(3)
    x = rng.randn(16, 256).astype(np.float32)
    q, s = _quant_cols(rng, 256, 1152, 1)
    ref = jd.dense_int8_stacked(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q), jnp.asarray(s), 0)
    got = pd.dense_int8_stacked(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(q),
                                torch.from_numpy(s), 0)
    assert _rel(got.numpy(), ref) < 1e-4


def test_dense_int8_rejects_untileable():
    q, s = _quant_cols(np.random.RandomState(1), 256, 384, 1)
    with pytest.raises(ValueError, match="128-multiple"):
        pd.dense_int8_stacked(torch.zeros(4, 256), torch.from_numpy(q[:, :, :300].copy()),
                              torch.from_numpy(s[:, :, :300].copy()), 0)


@pytest.mark.parametrize("layer", [0, 1])
def test_qkv_norm_int8_matches_jax(layer):
    rng = np.random.RandomState(4)
    L, b, d, dq = 2, 8, 256, 384
    x = rng.randn(b, d).astype(np.float32)
    nw = (1.0 + 0.1 * rng.randn(L, d)).astype(np.float32)
    q, s = _quant_cols(rng, d, dq, L)
    ref = jd.qkv_norm_int8_stacked(jnp.asarray(x), jnp.asarray(nw), jnp.asarray(q),
                                   jnp.asarray(s), layer, eps=EPS)
    got = pd.qkv_norm_int8_stacked(torch.from_numpy(x), torch.from_numpy(nw),
                                   torch.from_numpy(q), torch.from_numpy(s), layer, eps=EPS)
    assert _rel(got.numpy(), ref) < 1e-4


def _tail_inputs(seed, L, b, d, F, Q):
    rng = np.random.RandomState(seed)
    attn = (rng.randn(b, d) * 0.3).astype(np.float32)
    x = rng.randn(b, d).astype(np.float32)
    wo, wos = _quant_cols(rng, d, d, L)
    mw = (1.0 + 0.1 * rng.randn(L, d)).astype(np.float32)
    gu, sgu = _quant_cols(rng, d, 2 * F, L)
    wd, sd = _quant_cols(rng, F, d, L)
    nw = (1.0 + 0.1 * rng.randn(L, d)).astype(np.float32)
    wq, sq = _quant_cols(rng, d, Q, L)
    return [attn, x, wo, wos, mw, gu, sgu, wd, sd, nw, wq, sq]


def _tail_jax(args, layer):
    x_out, qkv = jd.tail_swiglu_qkv_int8_stacked(*map(jnp.asarray, args), layer, eps=EPS)
    return np.asarray(x_out), np.asarray(qkv)


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_tail_swiglu_qkv_matches_jax(layer):
    """Every layer, the last one with its clamped next-qkv (layer 2 of 3)."""
    args = _tail_inputs(11, 3, 4, 128, 256, 384)
    rx, rq = _tail_jax(args, layer)
    gx, gq = pd.tail_swiglu_qkv_int8_stacked(*map(torch.from_numpy, args), layer, eps=EPS)
    assert _rel(gx.numpy(), rx) < 1e-5
    assert _rel(gq.numpy(), rq) < 1e-4


@pytest.fixture(scope="module")
def full_width_tail():
    """One B2 call at the T3 layer width: d_ff 4096 → two 2048 tiles."""
    args = _tail_inputs(12, 2, 4, 1024, 4096, 3072)
    assert pd.pick_tile(4096, pd.TILE_BUDGET, 2 * 1024) == 2048
    return args, _tail_jax(args, 0)


def test_tail_swiglu_qkv_full_width_matches_jax(full_width_tail):
    args, (rx, rq) = full_width_tail
    gx, gq = pd.tail_swiglu_qkv_int8_stacked(*map(torch.from_numpy, args), 0, eps=EPS)
    assert _rel(gx.numpy(), rx) < 1e-5
    assert _rel(gq.numpy(), rq) < 1e-4


def test_one_block_hidden_is_caught(full_width_tail):
    """Quantizing the whole 4096-wide hidden per row (one scale, not two)
    is the trap: it must land far outside the tolerance above."""
    args, (rx, rq) = full_width_tail
    gx, gq = pd.tail_swiglu_qkv_int8_plain(*map(torch.from_numpy, args), 0, eps=EPS, tile=4096)
    assert _rel(gx.numpy(), rx) > 100 * 1e-5
    assert _rel(gq.numpy(), rq) > 1e-4


def test_zero_rows_give_the_floor_scale():
    """A zero row quantizes with the scale 1e-8 (not NaN) and gives 0."""
    rng = np.random.RandomState(7)
    x = rng.randn(3, 128).astype(np.float32)
    x[1] = 0.0
    q, s = _quant_cols(rng, 128, 256, 1)
    nw = np.ones((1, 128), np.float32)
    for got in (pd.dense_int8_stacked(torch.from_numpy(x), torch.from_numpy(q),
                                      torch.from_numpy(s), 0),
                pd.qkv_norm_int8_stacked(torch.from_numpy(x), torch.from_numpy(nw),
                                         torch.from_numpy(q), torch.from_numpy(s), 0, eps=EPS)):
        assert torch.isfinite(got).all() and (got[1] == 0).all()
