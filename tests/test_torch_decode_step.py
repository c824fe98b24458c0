"""The whole-step kernel B7 and the decode step's batch-1 branch against the
JAX reference, on the JAX test's own config (``tests/test_decode_step_fused.py
:36-63``: d_model 256, 3 layers, 4 heads = kv heads, d_head 64, d_ff 512,
f32, int8 weights and cache, cache 128, prompt 37 of 40), with and without
q/k/v biases. JAX's init leaves the biases at zero, so the test sets them
(and the norm weights) from a numpy seed in the JAX tree before either side
runs. JAX runs its Pallas kernels in interpret mode, the port its plain
versions.

Tolerances:
- B7 plain against JAX's B7: x_out and the k/v rows within 1e-4 + 1e-4·|ref|.
  The activations are quantized to int8 five times a layer; the two sides
  take the same IEEE steps but sum the softmax, the variance and the current
  token's score in another order (JAX in f32, the port in float64), an ulp
  apart, which moves no int8 unless one sits on a .5 tie. Also at cache 384
  and d_ff 4096 (2 layers), where B1's per-128-slot p quantization and B2's
  per-2048 SwiGLU tiles differ from B7's, and are shown to miss.
- Three teacher-forced steps through the fused branch: logits within 2e-3
  atol/rtol (``tests/test_decode_step_fused.py:95-97``); the int8 k/v the
  steps append equal, except elements whose unquantized value sits on a
  rounding tie, which may be one step off (the ``test_torch_transformer.py``
  check); their bf16 scales equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.models.common import transformer as jt
from vocalie_tts_tpu.ops.decode_step import decode_step_fused_packed as jax_b7
from vocalie_tts_tpu.ops.decode_step import head_stack_qkv
from vocalie_tts_tpu_torch.bridge import tree_to_torch
from vocalie_tts_tpu_torch.models.common import transformer as pt
from vocalie_tts_tpu_torch.ops import decode_step as ds

DIMS = dict(vocab_size=160, d_model=256, n_layers=3, n_heads=4, n_kv_heads=4, d_head=64,
            d_ff=512, max_seq_len=256)
FLAGS = dict(kv_quant=True, decode_kernel=True, dense_kernel=True)
CACHE_LEN, PROMPT_LEN, PROMPT_PAD = 128, 37, 40
NEG = -0.7 * float(np.finfo(np.float32).max)


def _configs(attn_bias):
    return (jt.TransformerConfig(**DIMS, **FLAGS, attn_bias=attn_bias, dtype=jnp.float32),
            pt.TransformerConfig(**DIMS, **FLAGS, attn_bias=attn_bias, dtype=torch.float32))


def _int8_params(jcfg, pcfg, attn_bias):
    """The JAX init of ``jcfg`` with norm weights (and biases) set from a
    numpy seed → (jax int8 fused params, port int8 fused params)."""
    raw = jax.device_get(jt.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(3)
    layers = dict(raw["layers"])
    for name in ("attn_norm", "mlp_norm"):
        layers[name] = (1 + 0.1 * rng.standard_normal(layers[name].shape)).astype(np.float32)
    if attn_bias:
        for name in ("bq", "bk", "bv"):
            layers[name] = (0.5 * rng.standard_normal(layers[name].shape)).astype(np.float32)
    raw = {**raw, "layers": layers}
    jparams = jt.fuse_decode_weights(jax.device_get(jax.jit(jt.quantize_weights_int8)(raw)))
    pparams = pt.fuse_decode_weights(pt.quantize_weights_int8(tree_to_torch(raw)))
    assert ("bqkv" in pparams["layers"]) is attn_bias
    return jparams, pparams


@pytest.fixture(scope="module", params=[False, True], ids=["no_bias", "bias"])
def models(request):
    """(jax cfg, jax int8 fused params, port cfg, port int8 fused params)."""
    jcfg, pcfg = _configs(request.param)
    jparams, pparams = _int8_params(jcfg, pcfg, request.param)
    return jcfg, jparams, pcfg, pparams


def _rope_f(pos, d):
    cos, sin = pt.rope_angles(torch.tensor([[pos]]), d, 10000.0)
    c, s = cos[:, 0], sin[:, 0]
    return torch.cat([c, c], -1), torch.cat([-s, s], -1)


def _b7_both(jcfg, jparams, pparams, T, n_prompt, prompt_pad, n_dec):
    """One call of B7 in both packages on the same inputs: random q0/k0/v0,
    residual and int8 cache from a numpy seed, the model's int8 weights
    (with the biases), a mask that lets through ``n_prompt`` prompt slots of
    ``prompt_pad`` and ``n_dec`` decoded ones → (JAX's outputs as numpy, a
    function that runs the port's)."""
    L, H, d, D = jcfg.n_layers, jcfg.n_heads, jcfg.d_head, jcfg.d_model
    rng = np.random.default_rng(11)
    q0 = rng.standard_normal((H, 1, d)).astype(np.float32)
    kn0, vn0 = (rng.standard_normal((H, d)).astype(np.float32) for _ in range(2))
    x = (0.5 * rng.standard_normal((1, D))).astype(np.float32)
    k, v = (rng.integers(-127, 128, (L, 1, H, T, d), dtype=np.int8) for _ in range(2))
    ks, vs = (((rng.random((L, 1, H, T)) + 0.5) / 127).astype(np.float32) for _ in range(2))
    ks, vs = (torch.from_numpy(a).to(torch.bfloat16) for a in (ks, vs))
    pos = np.arange(T)
    valid = (pos < n_prompt) | ((pos >= prompt_pad) & (pos < prompt_pad + n_dec))
    bias = np.where(valid, 0.0, NEG).astype(np.float32)[None]
    cos_f, sin_f = _rope_f(n_prompt + n_dec, d)
    sm = 1.0 / np.sqrt(d)

    jl = jparams["layers"]
    wh, bh = head_stack_qkv(jl, H, H, d)
    ref = jax_b7(
        jnp.asarray(q0), jnp.asarray(kn0), jnp.asarray(vn0), jnp.asarray(x),
        jnp.concatenate([jnp.asarray(k), jnp.asarray(v)], -1),
        jnp.asarray(ks.float().numpy(), jnp.bfloat16), jnp.asarray(vs.float().numpy(), jnp.bfloat16),
        jnp.asarray(bias), prompt_pad + n_dec,
        jl["wo"]["q"], jl["wo"]["s"], jl["mlp_norm"], jl["w_gateup"]["q"], jl["w_gateup"]["s"],
        jl["w_down"]["q"], jl["w_down"]["s"], jl["attn_norm"], wh["q"], wh["s"], bh,
        jnp.asarray(cos_f.numpy()), jnp.asarray(sin_f.numpy()),
        sm_scale=float(sm), eps=jcfg.norm_eps, interpret=True,
    )
    pl = pparams["layers"]

    def port():
        return ds.decode_step_fused_packed(
            torch.from_numpy(q0), torch.from_numpy(kn0), torch.from_numpy(vn0),
            torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(v), ks, vs,
            torch.from_numpy(bias), pl["wo"]["q"], pl["wo"]["s"], pl["mlp_norm"],
            pl["w_gateup"]["q"], pl["w_gateup"]["s"], pl["w_down"]["q"], pl["w_down"]["s"],
            pl["attn_norm"], pl["wqkv"]["q"], pl["wqkv"]["s"], pl.get("bqkv"), cos_f, sin_f,
            sm_scale=float(sm), eps=jcfg.norm_eps,
        )

    return [np.asarray(r) for r in ref], port


def _worst(ref, got):
    """max |got - ref| / (1e-4 + 1e-4·|ref|) over the three outputs."""
    return max(float(np.max(np.abs(g.numpy() - r) / (1e-4 + 1e-4 * np.abs(r))))
               for r, g in zip(ref, got))


def test_b7_plain_matches_jax_kernel(models):
    """One call of B7 at the JAX test's shapes (cache 128, d_ff 512)."""
    jcfg, jparams, _, pparams = models
    ref, port = _b7_both(jcfg, jparams, pparams, CACHE_LEN, PROMPT_LEN, PROMPT_PAD, 5)
    got = port()
    assert ds.decode_step_fused_packed.launches == 0   # the CPU runs the plain version
    for name, r, g in zip(("x_out", "kn", "vn"), ref, got):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4, rtol=1e-4, err_msg=name)


#: wide enough that B7's whole-T p quantization and whole-d_ff SwiGLU scale
#: differ from B1's per-128-slot p blocks and B2's per-2048 d_ff tiles:
#: cache 384 (3 blocks, each holding valid slots), d_ff 4096 (2 tiles)
WIDE_DIMS = dict(DIMS, n_layers=2, d_ff=4096)
WIDE_T, WIDE_PROMPT, WIDE_PAD, WIDE_DEC = 384, 150, 160, 140


@pytest.fixture(scope="module")
def wide_b7():
    jcfg = jt.TransformerConfig(**WIDE_DIMS, **FLAGS, attn_bias=True, dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**WIDE_DIMS, **FLAGS, attn_bias=True, dtype=torch.float32)
    jparams, pparams = _int8_params(jcfg, pcfg, True)
    return _b7_both(jcfg, jparams, pparams, WIDE_T, WIDE_PROMPT, WIDE_PAD, WIDE_DEC)


def test_b7_plain_matches_jax_kernel_wide(wide_b7):
    """B7 at cache 384 and d_ff 4096, with the biases, within the same
    1e-4 + 1e-4·|ref| as the JAX test's shapes."""
    ref, port = wide_b7
    assert _worst(ref, port()) <= 1.0


def _blocked_quantizer(widths):
    """``_quantize_rows`` with one scale per block of ``widths[n]`` columns
    for rows ``n`` wide, as B1 quantizes p and B2 the SwiGLU hidden. The
    block-scaled values come back over one row scale (the largest block's),
    so the callers' ``q · W · s`` sums each block at its own scale (float64,
    to a few ulps)."""
    real = ds._quantize_rows

    def quantize(x, floor=1e-8):
        blk = widths.get(x.shape[-1])
        if blk is None:
            return real(x, floor)
        parts = [real(c, floor) for c in x.split(blk, dim=-1)]
        s_row = torch.stack([s for _, s in parts]).amax(0)
        return torch.cat([q * (s / s_row) for q, s in parts], dim=-1), s_row

    return quantize


@pytest.mark.parametrize("trap,widths", [
    ("p per 128 slots (B1)", {WIDE_T: 128}),
    ("SwiGLU per 2048 d_ff (B2)", {WIDE_DIMS["d_ff"]: 2048}),
])
def test_b7_block_quantization_traps_are_caught(wide_b7, monkeypatch, trap, widths):
    """The wide case tells B7's quantization from B1's and B2's: the plain
    version with either block size of theirs lands over 100 times outside
    the tolerance the real one meets (at the JAX test's shapes, cache 128
    and d_ff 512, both block sizes span the whole row and change nothing)."""
    ref, port = wide_b7
    monkeypatch.setattr(ds, "_quantize_rows", _blocked_quantizer(widths))
    assert _worst(ref, port()) > 100.0, trap


def _check_appended(jcache, pcache, k_raw, n_steps):
    """The decode slots of the int8 cache: JAX's lane-packed k|v against
    the port's split k and v. ``k_raw``: the port's unquantized k/v of each
    step, for the tie check."""
    sl = slice(PROMPT_PAD, PROMPT_PAD + n_steps)
    jk = np.asarray(jcache.k)[:, :, :, sl]
    d = pcache.k.shape[-1]
    for name, ref, raw in (("k", jk[..., :d], k_raw[0]), ("v", jk[..., d:], k_raw[1])):
        got = getattr(pcache, name)[:, :, :, sl].numpy()
        bad = got != ref
        if bad.any():
            assert np.all(np.abs(got[bad].astype(int) - ref[bad].astype(int)) == 1), name
            scale = getattr(pcache, name + "_scale")[:, :, :, sl].float().numpy()[..., None]
            x = raw[bad] / np.broadcast_to(scale, bad.shape)[bad]
            assert np.all(np.abs(np.abs(x - np.trunc(x)) - 0.5) < 1e-3), f"{name}: {x}"
    for name in ("k_scale", "v_scale"):
        ref = np.asarray(getattr(jcache, name))[:, :, :, sl].view(np.int16)
        assert np.array_equal(getattr(pcache, name)[:, :, :, sl].view(torch.int16).numpy(), ref)


def test_fused_branch_teacher_forced(models, monkeypatch):
    """Prefill of the JAX test's prompt, then three decode steps on tokens
    7, 12, 3 through the batch-1 branch: B3 prologue (+ bias), B7, B5, B4 on
    the port's side; JAX with the head-stacked layout its generate programs
    install (``maybe_head_stack_qkv``)."""
    jcfg, jparams, pcfg, pparams = models
    monkeypatch.delenv("VOCALIE_FUSED_STEP", raising=False)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (1, PROMPT_PAD), 0,
                                           jcfg.vocab_size))
    lens = np.asarray([PROMPT_LEN], np.int32)
    fparams = jt.maybe_head_stack_qkv(jparams, jcfg, 1)
    assert "wqkv_h" in fparams["layers"]
    _, jcache = jt.prefill(fparams, jcfg, jnp.asarray(tokens), jnp.asarray(lens),
                           cache_len=CACHE_LEN)
    _, pcache = pt.prefill(pparams, pcfg, torch.from_numpy(tokens).long(), torch.from_numpy(lens),
                           cache_len=CACHE_LEN)
    jstep = jax.jit(lambda p, t, c: jt.decode_step(p, jcfg, t, c))
    calls, seen = [], []
    real_b7, real_quant = pt.decode_step_fused_packed, pt._quantize_kv
    monkeypatch.setattr(pt, "decode_step_fused_packed",
                        lambda *a, **k: calls.append(1) or real_b7(*a, **k))
    monkeypatch.setattr(pt, "_quantize_kv", lambda a: seen.append(a.numpy()) or real_quant(a))
    for t in (7, 12, 3):
        jl, jcache = jstep(fparams, jnp.asarray([t], jnp.int32), jcache)
        pl, pcache = pt.decode_step(pparams, pcfg, torch.tensor([t]), pcache)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=2e-3, rtol=2e-3,
                                   err_msg=f"token {t}")
    assert len(calls) == 3
    # each step quantizes its [L, 1, H, d] k, then its v
    _check_appended(jcache, pcache, [np.stack(seen[0::2], axis=3), np.stack(seen[1::2], axis=3)],
                    3)


@pytest.mark.parametrize("batch,env,path", [
    (1, {}, "fused_step"),
    (2, {}, "megatail"),
    (1, {"VOCALIE_FUSED_STEP": "0"}, "megatail"),
])
def test_dispatch_matches_jax(models, monkeypatch, batch, env, path):
    """Batch 2 or ``VOCALIE_FUSED_STEP=0`` takes the megatail path (B3 + B2
    per layer), batch 1 takes B7, in both packages: the JAX side installs
    its head-stacked layout (what sends its ``decode_step`` to B7) exactly
    where the port's dispatch picks B7, and one port step calls that path's
    kernel and not the other's."""
    jcfg, jparams, pcfg, pparams = models
    monkeypatch.delenv("VOCALIE_FUSED_STEP", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    installed = "wqkv_h" in jt.maybe_head_stack_qkv(jparams, jcfg, batch)["layers"]
    assert installed is (path == "fused_step")
    assert pt._dense_dispatch(pparams["layers"], pcfg, batch, CACHE_LEN) == path
    calls = {"fused_step": [], "megatail": []}
    for name, key in (("decode_step_fused_packed", "fused_step"),
                      ("tail_swiglu_qkv_int8_stacked", "megatail")):
        fn = getattr(pt, name)
        monkeypatch.setattr(pt, name,
                            lambda *a, _fn=fn, _k=key, **kw: calls[_k].append(1) or _fn(*a, **kw))
    cache = pt.StackedKVCache.create(pcfg.n_layers, batch, pcfg.n_kv_heads, CACHE_LEN,
                                     pcfg.d_head, "cpu")
    cache.prompt_lengths = torch.full((batch,), 3, dtype=torch.int32)
    cache.prompt_pad = 3
    logits, _ = pt.decode_step(pparams, pcfg, torch.zeros(batch, dtype=torch.long), cache)
    assert logits.shape == (batch, pcfg.vocab_size) and torch.isfinite(logits).all()
    assert len(calls[path]) == (1 if path == "fused_step" else pcfg.n_layers)
    assert not calls["megatail" if path == "fused_step" else "fused_step"]
