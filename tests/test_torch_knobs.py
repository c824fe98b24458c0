"""Four knobs the JAX package reads and the port used to ignore, each set
in both packages: the port must compute what JAX computes under it, or
raise.

- ``VOCALIE_TILE_MB`` (the dense kernels' per-block budget, hence the d_ff
  tile the SwiGLU hidden is quantized over, ``ops/decode_dense.py:65-95``):
  carried. B2 at d_model 256, d_ff 1024 takes one tile of 1024 by default
  and two of 512 at 0.25 MiB; the port matches JAX within B2's tolerance
  (x 1e-5 · max|x|, qkv 1e-4 · max|qkv|) both ways, the two tiles move x
  past that, and a budget below one 128-column tile raises in both. B12
  (the whole layer, ``VOCALIE_MEGALAYER=1``) quantizes its hidden over the
  same tile and moves with it alike (its tolerance: 1e-5 · max|ref| on both
  outputs).
- ``VOCALIE_CFM_FLASH=0`` (the CFM self-attention as the XLA softmax,
  ``cfm.py:215-216``): carried. A CFM transformer block at 288 mel frames
  within the stage-2 tolerance (atol 1e-3), with no flash launch on the
  port.
- ``VOCALIE_FUSE_QKV=0`` (unfused q/k/v and gate/up, and with int8 weights
  no dense kernels, ``ar_runtime.py:79-82``): the port raises.
- ``VOCALIE_STREAM_FUSED=0`` (CosyVoice streaming's unfused window
  programs, ``cosyvoice/runtime.py:481, :499-514``): the port raises.

JAX reads the first two while it traces, so its caches are cleared around
each case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.ops import decode_dense as jd
from vocalie_tts_tpu_torch.ops import decode_dense as pd

EPS = 1e-5


@pytest.fixture
def fresh_jax():
    jax.clear_caches()
    yield
    jax.clear_caches()


def _quant_cols(rng, d_in, d_out, L):
    w = rng.randn(L, d_in, d_out).astype(np.float32)
    s = (np.abs(w).max(axis=1, keepdims=True) / 127.0 + 1e-8).astype(np.float32)
    return np.clip(np.round(w / s), -127, 127).astype(np.int8), s


def _b2_inputs(seed, L=2, b=4, d=256, F=1024, Q=512):
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


def _rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max()


def _b2_both(args):
    rx, rq = jd.tail_swiglu_qkv_int8_stacked(*map(jnp.asarray, args), 0, eps=EPS)
    gx, gq = pd.tail_swiglu_qkv_int8_stacked(*map(torch.from_numpy, args), 0, eps=EPS)
    return np.asarray(rx), np.asarray(rq), gx.numpy(), gq.numpy()


def test_tile_mb_is_carried(fresh_jax, monkeypatch):
    args = _b2_inputs(51)
    monkeypatch.delenv("VOCALIE_TILE_MB", raising=False)
    assert pd.pick_tile(1024, pd.TILE_BUDGET, 2 * 256) == 1024
    rx1, rq1, gx1, gq1 = _b2_both(args)
    jax.clear_caches()
    monkeypatch.setenv("VOCALIE_TILE_MB", "0.25")
    assert pd.pick_tile(1024, pd.TILE_BUDGET, 2 * 256) == 512
    rx2, rq2, gx2, gq2 = _b2_both(args)
    for rx, rq, gx, gq in ((rx1, rq1, gx1, gq1), (rx2, rq2, gx2, gq2)):
        assert _rel(gx, rx) < 1e-5 and _rel(gq, rq) < 1e-4
    assert _rel(rx2, rx1) > 1e-5 and _rel(gx2, gx1) > 1e-5


def _b12_inputs(seed, L=2, b=4, kv=2, d=64, T=256, D=256, F=1024):
    """B12's arguments at the d_model-256, d_ff-1024 layer (packed d_head
    64 on the JAX side) → (jax args, port args, kwargs)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, kv, 1, d).astype(np.float32)
    x = rng.randn(b, D).astype(np.float32)
    k, v = (rng.randint(-127, 128, (L, b, kv, T, d)).astype(np.int8) for _ in range(2))
    ks, vs = (torch.from_numpy((rng.rand(L, b, kv, T) + 0.5).astype(np.float32) / 127)
              .to(torch.bfloat16) for _ in range(2))
    bias = np.where(np.arange(T)[None] < rng.randint(1, 150, (b, 1)), 0.0, -1e30).astype(
        np.float32)
    kn, vn = (rng.randn(b, kv, d).astype(np.float32) for _ in range(2))
    wo, wos = _quant_cols(rng, kv * d, D, L)
    mw = (1.0 + 0.1 * rng.randn(L, D)).astype(np.float32)
    gu, sgu = _quant_cols(rng, D, 2 * F, L)
    wd, sd = _quant_cols(rng, F, D, L)
    nw = (1.0 + 0.1 * rng.randn(L, D)).astype(np.float32)
    wq, sq = _quant_cols(rng, D, 3 * kv * d, L)
    tail = [wo, wos, mw, gu, sgu, wd, sd, nw, wq, sq]
    jax_args = [jnp.asarray(q), jnp.asarray(x), jnp.asarray(np.concatenate([k, v], -1)), None,
                jnp.asarray(ks.float().numpy()).astype(jnp.bfloat16),
                jnp.asarray(vs.float().numpy()).astype(jnp.bfloat16), jnp.asarray(bias),
                jnp.asarray(kn), jnp.asarray(vn), 1, 150, *map(jnp.asarray, tail)]
    port_args = [*map(torch.from_numpy, (q, x, k, v)), ks, vs,
                 *map(torch.from_numpy, (bias, kn, vn)), 1, 150, *map(torch.from_numpy, tail)]
    return jax_args, port_args, dict(sm_scale=d ** -0.5, eps=EPS)


def test_tile_mb_moves_b12(fresh_jax, monkeypatch):
    """B12 at d_model 256, d_ff 1024: one hidden tile of 1024 by default,
    two of 512 at 0.25 MiB, as B2; the port's plain B12 matches the JAX
    kernel (interpret mode) both ways, and the two tiles move x_out past
    the tolerance in both packages."""
    from vocalie_tts_tpu.ops import decode_layer as jl
    from vocalie_tts_tpu_torch.ops import decode_layer as pl

    jargs, pargs, kw = _b12_inputs(54)
    outs = []
    for mb in (None, "0.25"):
        jax.clear_caches()
        if mb:
            monkeypatch.setenv("VOCALIE_TILE_MB", mb)
        else:
            monkeypatch.delenv("VOCALIE_TILE_MB", raising=False)
        assert pd.pick_tile(1024, pd.TILE_BUDGET, 2 * 256) == (512 if mb else 1024)
        rx, rq = jl.layer_swiglu_qkv_int8_stacked(*jargs, **kw, packed=True)
        gx, gq = pl.layer_swiglu_qkv_int8_stacked(*pargs, **kw)
        assert _rel(gx.numpy(), rx) < 1e-5 and _rel(gq.numpy(), rq) < 1e-5
        outs.append((np.asarray(rx), gx.numpy()))
    assert _rel(outs[1][0], outs[0][0]) > 1e-5 and _rel(outs[1][1], outs[0][1]) > 1e-5


def test_tile_mb_below_one_tile_raises(fresh_jax, monkeypatch):
    """0.1 MiB holds fewer than 128 columns of the o-projection's 512 bytes
    (and of gate | up's 1024): both packages refuse."""
    monkeypatch.setenv("VOCALIE_TILE_MB", "0.1")
    args = _b2_inputs(52, d=512, F=1024)
    with pytest.raises(ValueError, match="VOCALIE_TILE_MB"):
        jd.tail_swiglu_qkv_int8_stacked(*map(jnp.asarray, args), 0, eps=EPS)
    with pytest.raises(ValueError, match="VOCALIE_TILE_MB"):
        pd.tail_swiglu_qkv_int8_stacked(*map(torch.from_numpy, args), 0, eps=EPS)


def test_cfm_flash_off_is_carried(fresh_jax, monkeypatch):
    """One CFM transformer block (the code the knob switches) of the tiny
    Chatterbox decoder at 288 frames with ragged rows."""
    from vocalie_tts_tpu.models.chatterbox.runtime import SCALES as JAX_SCALES
    from vocalie_tts_tpu.models.common import cfm as jcfm
    from vocalie_tts_tpu_torch.bridge import tree_to_torch
    from vocalie_tts_tpu_torch.models.chatterbox.runtime import SCALES
    from vocalie_tts_tpu_torch.models.common import cfm as pcfm

    monkeypatch.setenv("VOCALIE_CFM_FLASH", "0")
    calls = []
    real = pcfm.flash_attention
    monkeypatch.setattr(pcfm, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    jc, pc = JAX_SCALES["tiny"].t2w.decoder, SCALES["tiny"].t2w.decoder
    jp = jax.device_get(jax.jit(lambda k: jcfm._xf_block_init(
        k, jc.channels[0], jc.num_heads, jc.attention_head_dim))(jax.random.PRNGKey(3)))
    pp = tree_to_torch(jp)
    t, lens = 288, np.asarray([288, 218], np.int32)
    rng = np.random.default_rng(53)
    x = rng.standard_normal((2, t, jc.channels[0])).astype(np.float32)
    keep = np.arange(t)[None, :] < lens[:, None]
    bias = np.where(keep, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    ref = jax.jit(lambda p, x, b, n: jcfm._xf_block(p, jc, x, b, n))(
        jp, jnp.asarray(x), jnp.asarray(bias), jnp.asarray(lens))
    out = pcfm._xf_block(pp, pc, torch.from_numpy(x), torch.from_numpy(bias),
                         torch.from_numpy(lens))
    assert not calls
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3, rtol=0)


def test_fuse_qkv_off_raises(monkeypatch):
    from vocalie_tts_tpu.models.common.ar_runtime import maybe_quantize_lm as jax_transform
    from vocalie_tts_tpu_torch.models.common.ar_runtime import maybe_quantize_lm

    monkeypatch.setenv("VOCALIE_FUSE_QKV", "0")
    monkeypatch.setenv("VOCALIE_WEIGHT_INT8", "1")
    layers = {"wq": np.ones((1, 128, 128), np.float32), "wk": np.ones((1, 128, 128), np.float32),
              "wv": np.ones((1, 128, 128), np.float32)}
    jax_lm = jax_transform({"lm": {"layers": layers, "lm_head": np.ones((128, 96), np.float32)}})
    assert "wq" in jax_lm["lm"]["layers"] and "wqkv" not in jax_lm["lm"]["layers"]
    with pytest.raises(NotImplementedError, match="VOCALIE_FUSE_QKV"):
        maybe_quantize_lm({"lm": {"layers": {k: torch.from_numpy(v) for k, v in layers.items()},
                                  "lm_head": torch.ones(128, 96)}})


@pytest.mark.parametrize("value,refused", [("0", True), ("false", True), ("1", False),
                                           (None, False)])
def test_stream_fused_off_raises(monkeypatch, value, refused):
    """JAX's ``synthesize_streaming`` reads ``VOCALIE_STREAM_FUSED``; the
    port's refuses ``=0`` before it touches the runtime, and passes the knob
    unset or on (the stand-in runtime then fails on its first attribute)."""
    import inspect

    from vocalie_tts_tpu.models.cosyvoice.runtime import CosyVoiceRuntime as JaxRuntime
    from vocalie_tts_tpu_torch.models.cosyvoice.runtime import CosyVoiceRuntime

    assert 'bool_env("VOCALIE_STREAM_FUSED", True)' in inspect.getsource(
        JaxRuntime.synthesize_streaming)
    if value is None:
        monkeypatch.delenv("VOCALIE_STREAM_FUSED", raising=False)
    else:
        monkeypatch.setenv("VOCALIE_STREAM_FUSED", value)
    packets = CosyVoiceRuntime.synthesize_streaming(object(), "Bonjour.")
    with pytest.raises(NotImplementedError if refused else AttributeError,
                       match="VOCALIE_STREAM_FUSED" if refused else "cfg"):
        next(packets)
