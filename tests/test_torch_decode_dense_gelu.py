"""The port's GPT-2 dense decode kernels' plain versions (B9a
``qkv_lnorm_int8_stacked``, B9b ``tail_gelu_qkv_int8_stacked``, B9c
``tail_gelu_int8_stacked``) against the JAX kernels, run in Pallas interpret
mode on the CPU as the JAX package's own tests run them
(``VOCALIE_TILE_MB`` unset). Inputs are made with numpy from a seed, at the
shapes of ``tests/test_decode_dense.py:163-178`` (L 3, b 4, d 128, d_ff 256,
qkv 384, non-zero biases and LayerNorm parameters), B9a also at 1 and 32
bf16 rows (the ends of its one launch's reach), and B9b once at the full
XTTS layer width (d_model 1024, d_ff 4096, qkv 3072), where the hidden is
quantized in two d_ff tiles of 2048.

Tolerances (as the B2-B4 tests, ``tests/test_torch_decode_dense.py``):
- B9a: 1e-4 · max|ref|: exact integer products; the LayerNorm's mean,
  variance and rsqrt round differently in the last ulp in the two libraries;
- B9b / B9c: x within 1e-5 · max|x| and qkv within 1e-4 · max|qkv|
  (``tests/test_decode_dense.py:195-196``, relative to the output's scale).
- The GELU: JAX's tanh on the CPU is XLA's own approximation and PyTorch's
  is another, so the two GELUs differ by a few ulp and an int8 hidden can
  round the other way where it sits on a .5 tie. ``test_gelu_matches_jax``
  checks that every int8 hidden that differs is such a tie, off by one.
- A hidden quantized in one block instead of per d_ff tile misses the x
  tolerance at full width by far (``test_one_block_hidden_is_caught``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.ops import decode_dense as jd
from vocalie_tts_tpu_torch.ops import decode_dense as pd

EPS = 1e-5


def _quant_cols(rng, d_in, d_out, L):
    w = rng.randn(L, d_in, d_out).astype(np.float32)
    s = (np.abs(w).max(axis=1, keepdims=True) / 127.0 + 1e-8).astype(np.float32)
    return np.clip(np.round(w / s), -127, 127).astype(np.int8), s


def _vec(rng, L, n, base=0.0):
    return (base + 0.1 * rng.randn(L, n)).astype(np.float32)


def _rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max()


def _tail_inputs(seed, L, b, d, F, Q):
    """(attn, x, wo, wos, bo, lg, lb, wu, su, bu, wd, sd, bd, ng, nb, wq, sq)."""
    rng = np.random.RandomState(seed)
    attn = (rng.randn(b, d) * 0.3).astype(np.float32)
    x = rng.randn(b, d).astype(np.float32)
    wo, wos = _quant_cols(rng, d, d, L)
    bo, lg, lb = _vec(rng, L, d), _vec(rng, L, d, 1.0), _vec(rng, L, d)
    wu, su = _quant_cols(rng, d, F, L)
    bu = _vec(rng, L, F)
    wd, sd = _quant_cols(rng, F, d, L)
    bd, ng, nb = _vec(rng, L, d), _vec(rng, L, d, 1.0), _vec(rng, L, d)
    wq, sq = _quant_cols(rng, d, Q, L)
    return [attn, x, wo, wos, bo, lg, lb, wu, su, bu, wd, sd, bd, ng, nb, wq, sq]


@pytest.mark.parametrize("layer", [0, 2])
def test_qkv_lnorm_int8_matches_jax(layer):
    rng = np.random.RandomState(4)
    L, b, d, dq = 3, 8, 256, 384
    x = (rng.randn(b, d) * 2 + 0.5).astype(np.float32)
    ng, nb = _vec(rng, L, d, 1.0), _vec(rng, L, d)
    q, s = _quant_cols(rng, d, dq, L)
    ref = jd.qkv_lnorm_int8_stacked(*map(jnp.asarray, (x, ng, nb, q, s)), layer, eps=EPS)
    got = pd.qkv_lnorm_int8_stacked(*map(torch.from_numpy, (x, ng, nb, q, s)), layer, eps=EPS)
    assert got.dtype == torch.float32 and got.shape == (b, dq)
    assert _rel(got.numpy(), ref) < 1e-4


def test_qkv_lnorm_int8_bf16_rows_match_jax():
    """The decode step hands B9a the bf16 residual stream."""
    rng = np.random.RandomState(5)
    x = rng.randn(8, 128).astype(np.float32)
    ng, nb = _vec(rng, 1, 128, 1.0), _vec(rng, 1, 128)
    q, s = _quant_cols(rng, 128, 384, 1)
    ref = jd.qkv_lnorm_int8_stacked(jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, (ng, nb, q, s)),
                                    0, eps=EPS)
    got = pd.qkv_lnorm_int8_stacked(torch.from_numpy(x).to(torch.bfloat16),
                                    *map(torch.from_numpy, (ng, nb, q, s)), 0, eps=EPS)
    assert _rel(got.numpy(), ref) < 1e-4


@pytest.mark.parametrize("b", [1, 32])
def test_qkv_lnorm_int8_bf16_rows_match_jax_at_the_batch_edges(b):
    """The rows B9a's one launch takes at most and at least (1 and 32: one
    and two m16 row tiles on the card), bf16 rows as the decode step hands
    them, the last of two layers, against JAX."""
    rng = np.random.RandomState(6 + b)
    x = (rng.randn(b, 256) * 2 + 0.5).astype(np.float32)
    ng, nb = _vec(rng, 2, 256, 1.0), _vec(rng, 2, 256)
    q, s = _quant_cols(rng, 256, 384, 2)
    ref = jd.qkv_lnorm_int8_stacked(jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, (ng, nb, q, s)),
                                    1, eps=EPS)
    got = pd.qkv_lnorm_int8_stacked(torch.from_numpy(x).to(torch.bfloat16),
                                    *map(torch.from_numpy, (ng, nb, q, s)), 1, eps=EPS)
    assert got.shape == (b, 384) and _rel(got.numpy(), ref) < 1e-4


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_tail_gelu_qkv_matches_jax(layer):
    """Every layer, the last one with its clamped next-qkv (layer 2 of 3)."""
    args = _tail_inputs(13, 3, 4, 128, 256, 384)
    rx, rq = jd.tail_gelu_qkv_int8_stacked(*map(jnp.asarray, args), layer, eps=EPS)
    gx, gq = pd.tail_gelu_qkv_int8_stacked(*map(torch.from_numpy, args), layer, eps=EPS)
    assert _rel(gx.numpy(), rx) < 1e-5
    assert _rel(gq.numpy(), rq) < 1e-4


@pytest.mark.parametrize("layer", [0, 2])
def test_tail_gelu_matches_jax(layer):
    args = _tail_inputs(14, 3, 4, 128, 256, 384)[:13]
    ref = jd.tail_gelu_int8_stacked(*map(jnp.asarray, args), layer, eps=EPS)
    got = pd.tail_gelu_int8_stacked(*map(torch.from_numpy, args), layer, eps=EPS)
    assert got.shape == (4, 128) and _rel(got.numpy(), ref) < 1e-5


def test_tail_gelu_bf16_biases_match_jax():
    """The XTTS tree keeps bo / b_up / b_down and the residual in bf16."""
    args = _tail_inputs(15, 2, 4, 128, 256, 384)
    for i in (1, 4, 9, 12):
        args[i] = args[i].astype(jnp.bfloat16)
    rx, rq = jd.tail_gelu_qkv_int8_stacked(*map(jnp.asarray, args), 1, eps=EPS)
    targs = [torch.from_numpy(np.asarray(a, np.float32)) for a in args]
    for i in (1, 4, 9, 12):
        targs[i] = targs[i].to(torch.bfloat16)
    gx, gq = pd.tail_gelu_qkv_int8_stacked(*targs, 1, eps=EPS)
    assert _rel(gx.numpy(), rx) < 1e-5
    assert _rel(gq.numpy(), rq) < 1e-4


@pytest.fixture(scope="module")
def full_width_tail():
    """One B9b call at the XTTS layer width: d_ff 4096 → two 2048 tiles."""
    args = _tail_inputs(16, 2, 8, 1024, 4096, 3072)
    assert pd.pick_tile(4096, pd.TILE_BUDGET, 2 * 1024) == 2048
    rx, rq = jd.tail_gelu_qkv_int8_stacked(*map(jnp.asarray, args), 1, eps=EPS)
    return args, (np.asarray(rx), np.asarray(rq))


def test_tail_gelu_qkv_full_width_matches_jax(full_width_tail):
    """Layer 1 of 2: the last layer, its next qkv clamped to itself."""
    args, (rx, rq) = full_width_tail
    gx, gq = pd.tail_gelu_qkv_int8_stacked(*map(torch.from_numpy, args), 1, eps=EPS)
    assert _rel(gx.numpy(), rx) < 1e-5
    assert _rel(gq.numpy(), rq) < 1e-4


def test_one_block_hidden_is_caught(full_width_tail):
    """Quantizing the whole 4096-wide hidden per row (one scale, not two)
    is the trap: it must land far outside the tolerance above."""
    args, (rx, rq) = full_width_tail
    gx, gq = pd.tail_gelu_qkv_int8_plain(*map(torch.from_numpy, args), 1, eps=EPS, tile=4096)
    assert _rel(gx.numpy(), rx) > 100 * 1e-5
    assert _rel(gq.numpy(), rq) > 1e-4


def test_gelu_matches_jax():
    """The plain GELU against ``jax.nn.gelu(approximate=True)`` (jitted, as
    the kernel body runs) on 64k values: within 4 f32 ulp of |u| of JAX's
    value (XLA's tanh is its own approximation; an error of a few ulp in
    tanh moves u · 0.5 · (1 + tanh) by that much), and its per-tile int8
    quantization equal to JAX's except where the value sits on a .5 tie
    (within 1e-3 of n + 0.5 steps), where it may land one step away."""
    rng = np.random.RandomState(17)
    u = (rng.randn(16, 4096) * 3).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v: jax.nn.gelu(v, approximate=True))(u))
    got = pd.gelu_tanh(torch.from_numpy(u)).numpy()
    assert (np.abs(got - ref) <= 4 * np.spacing(np.abs(u))).all()
    jq, js = (np.asarray(a) for a in jax.jit(jd._quantize_rows)(jnp.asarray(ref)))
    pq, ps = pd._quantize_rows(torch.from_numpy(got))
    pq, ps = pq.numpy(), ps.numpy()
    assert np.array_equal(ps, js) or np.abs(ps - js).max() <= np.spacing(js).max()
    bad = pq != jq
    assert bad.mean() < 1e-3
    steps = ref / js
    assert np.all(np.abs(pq[bad] - jq[bad]) == 1)
    assert np.all(np.abs(np.abs(steps[bad] - np.trunc(steps[bad])) - 0.5) < 1e-3)


def test_zero_rows_and_untileable():
    """A constant row normalizes to its bias, quantizes without NaN; a d_ff
    with no 128-multiple tile is refused."""
    rng = np.random.RandomState(18)
    x = rng.randn(3, 128).astype(np.float32)
    x[1] = 2.5
    ng, nb = np.ones((1, 128), np.float32), np.zeros((1, 128), np.float32)
    q, s = _quant_cols(rng, 128, 256, 1)
    got = pd.qkv_lnorm_int8_stacked(*map(torch.from_numpy, (x, ng, nb, q, s)), 0, eps=EPS)
    assert torch.isfinite(got).all() and (got[1] == 0).all()
    args = [torch.from_numpy(a) for a in _tail_inputs(19, 1, 2, 128, 192, 384)]
    with pytest.raises(ValueError, match="128-multiple"):
        pd.tail_gelu_int8_stacked(*args[:13], 0, eps=EPS)
    with pytest.raises(ValueError, match="128-multiple"):
        pd.tail_gelu_qkv_int8_stacked(*args, 0, eps=EPS)
