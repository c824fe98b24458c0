"""The port's unfused SwiGLU dense decode kernels' plain versions (B8a
``tail_swiglu_int8_stacked``, B8b ``mlp_swiglu_int8_stacked``) against the
JAX kernels, run in Pallas interpret mode on the CPU as the JAX package's
own tests run them (``VOCALIE_TILE_MB`` unset). Inputs are made with numpy
from a seed, at the shapes of ``tests/test_decode_dense.py`` (L 3, b 4,
d 128, d_ff 256), with f32 and bf16 rows, and once at the Qwen3 layer width
d_model 2048 (d_ff 2048, so the hidden is quantized in two d_ff tiles of
1024; the full d_ff 8192 takes eight).

Tolerances (as the B2 tests, ``tests/test_torch_decode_dense.py``): the
output within 1e-5 · max|ref| (``tests/test_decode_dense.py:150-151``'s
atol 1e-5, relative to the output's scale). A hidden quantized in one block
instead of per d_ff tile misses it by over 100x
(``test_one_block_hidden_is_caught``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.ops import decode_dense as jd
from vocalie_tts_tpu_torch.ops import decode_dense as pd

EPS = 1e-6


def _quant_cols(rng, d_in, d_out, L):
    w = rng.randn(L, d_in, d_out).astype(np.float32)
    s = (np.abs(w).max(axis=1, keepdims=True) / 127.0 + 1e-8).astype(np.float32)
    return np.clip(np.round(w / s), -127, 127).astype(np.int8), s


def _rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max()


def _tail_inputs(seed, L, b, d, F):
    """(attn, x, wo, wos, mw, wgu, sgu, wd, sd)."""
    rng = np.random.RandomState(seed)
    attn = (rng.randn(b, d) * 0.3).astype(np.float32)
    x = rng.randn(b, d).astype(np.float32)
    wo, wos = _quant_cols(rng, d, d, L)
    mw = (1.0 + 0.1 * rng.randn(L, d)).astype(np.float32)
    gu, sgu = _quant_cols(rng, d, 2 * F, L)
    wd, sd = _quant_cols(rng, F, d, L)
    return [attn, x, wo, wos, mw, gu, sgu, wd, sd]


def _mlp_inputs(seed, L, b, d, F):
    """(x, wgu, sgu, wd, sd): post-norm rows of unit scale."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, d).astype(np.float32)
    gu, sgu = _quant_cols(rng, d, 2 * F, L)
    wd, sd = _quant_cols(rng, F, d, L)
    return [x, gu, sgu, wd, sd]


def _torch(args, bf16_rows=()):
    out = [torch.from_numpy(np.asarray(a)) for a in args]
    for i in bf16_rows:
        out[i] = out[i].to(torch.bfloat16)
    return out


@pytest.mark.parametrize("layer", [0, 2])
def test_tail_swiglu_matches_jax(layer):
    args = _tail_inputs(21, 3, 4, 128, 256)
    ref = jd.tail_swiglu_int8_stacked(*map(jnp.asarray, args), layer, eps=EPS)
    got = pd.tail_swiglu_int8_stacked(*_torch(args), layer, eps=EPS)
    assert got.dtype == torch.float32 and got.shape == (4, 128)
    assert _rel(got.numpy(), ref) < 1e-5


def test_tail_swiglu_bf16_rows_match_jax():
    """The decode step hands B8a the bf16 residual stream."""
    args = _tail_inputs(22, 2, 4, 128, 256)
    args[1] = args[1].astype(jnp.bfloat16)
    ref = jd.tail_swiglu_int8_stacked(*map(jnp.asarray, args), 1, eps=EPS)
    targs = _torch([np.asarray(a, np.float32) for a in args], bf16_rows=(1,))
    got = pd.tail_swiglu_int8_stacked(*targs, 1, eps=EPS)
    assert _rel(got.numpy(), ref) < 1e-5


def test_tail_swiglu_is_b2_without_the_next_qkv():
    """B8a's output is B2's first output, bit for bit."""
    args = _tail_inputs(23, 2, 4, 128, 256)
    rng = np.random.RandomState(24)
    nw = (1.0 + 0.1 * rng.randn(2, 128)).astype(np.float32)
    wq, sq = _quant_cols(rng, 128, 384, 2)
    x_out, _ = pd.tail_swiglu_qkv_int8_stacked(*_torch(args + [nw, wq, sq]), 0, eps=EPS)
    assert torch.equal(pd.tail_swiglu_int8_stacked(*_torch(args), 0, eps=EPS), x_out)


@pytest.mark.parametrize("layer", [0, 2])
def test_mlp_swiglu_matches_jax(layer):
    args = _mlp_inputs(25, 3, 4, 128, 256)
    ref = jd.mlp_swiglu_int8_stacked(*map(jnp.asarray, args), layer)
    got = pd.mlp_swiglu_int8_stacked(*_torch(args), layer)
    assert got.dtype == torch.float32 and got.shape == (4, 128)
    assert _rel(got.numpy(), ref) < 1e-5


def test_mlp_swiglu_bf16_rows_match_jax():
    """The ``DENSE_FNS`` path hands B8b the bf16 post-norm rows. With 8-bit
    mantissas, ``127 · x / amax`` often lands exactly on a .5 tie; the
    jitted kernel body scales by ``amax · (1 / 127)`` (XLA's constant
    divide), the port and the kernel source by ``amax / 127``, an ulp
    apart, so a tie can round the other way (ROADMAP C). Rows whose
    int8 activations agree must match within 1e-5 · max|ref|; in the others
    every differing activation must be such a tie, one step away."""
    args = _mlp_inputs(26, 2, 8, 256, 512)
    args[0] = args[0].astype(jnp.bfloat16)
    ref = np.asarray(jd.mlp_swiglu_int8_stacked(*map(jnp.asarray, args), 1))
    x = np.asarray(args[0], np.float32)
    got = pd.mlp_swiglu_int8_stacked(*_torch([x] + args[1:], bf16_rows=(0,)), 1).numpy()
    jq, js = (np.asarray(a) for a in jax.jit(jd._quantize_rows)(jnp.asarray(x)))
    pq = pd._quantize_rows(torch.from_numpy(x))[0].numpy()
    same = (pq == jq).all(-1)
    assert same.sum() >= len(same) // 2
    assert np.abs(got[same] - ref[same]).max() <= 1e-5 * np.abs(ref).max()
    bad = pq != jq
    steps = (x / js)[bad]
    assert np.all(np.abs(pq[bad] - jq[bad]) == 1)
    assert np.all(np.abs(np.abs(steps - np.trunc(steps)) - 0.5) < 1e-3)


@pytest.fixture(scope="module")
def full_width():
    """B8a and B8b once at d_model 2048: d_ff 2048 → two tiles of 1024."""
    assert pd.pick_tile(2048, pd.TILE_BUDGET, 2 * 2048) == 1024
    assert pd.pick_tile(8192, pd.TILE_BUDGET, 2 * 2048) == 1024
    tail = _tail_inputs(27, 2, 4, 2048, 2048)
    mlp = _mlp_inputs(28, 2, 4, 2048, 2048)
    return (tail, np.asarray(jd.tail_swiglu_int8_stacked(*map(jnp.asarray, tail), 1, eps=EPS)),
            mlp, np.asarray(jd.mlp_swiglu_int8_stacked(*map(jnp.asarray, mlp), 1)))


def test_full_width_matches_jax(full_width):
    tail, rt, mlp, rm = full_width
    assert _rel(pd.tail_swiglu_int8_stacked(*_torch(tail), 1, eps=EPS).numpy(), rt) < 1e-5
    assert _rel(pd.mlp_swiglu_int8_stacked(*_torch(mlp), 1).numpy(), rm) < 1e-5


def test_one_block_hidden_is_caught(full_width):
    """Quantizing the whole 2048-wide hidden per row (one scale, not two)
    is the trap: it must land far outside the tolerance above."""
    tail, rt, mlp, rm = full_width
    got = pd.tail_swiglu_int8_plain(*_torch(tail), 1, eps=EPS, tile=2048)
    assert _rel(got.numpy(), rt) > 100 * 1e-5
    got = pd.mlp_swiglu_int8_plain(*_torch(mlp), 1, tile=2048)
    assert _rel(got.numpy(), rm) > 100 * 1e-5


def test_untileable_d_ff_is_refused():
    tail = _torch(_tail_inputs(29, 1, 2, 128, 192))
    with pytest.raises(ValueError, match="128-multiple"):
        pd.tail_swiglu_int8_stacked(*tail, 0, eps=EPS)
    with pytest.raises(ValueError, match="128-multiple"):
        pd.mlp_swiglu_int8_stacked(*_torch(_mlp_inputs(30, 1, 2, 128, 192)), 0)
