"""The port's decode step with the dense kernels on (``dense_kernel``: B3
norm+qkv, B2 layer tail + next qkv, B4 lm_head) against the JAX reference,
on the config of ``tests/test_decode_dense.py:213-216`` (d_model 128, two
layers, two heads, d_head 64, d_ff 256, f32) with the int8 KV cache, the
decode-attention kernel and int8 fused weights bridged from ``init_params``.
JAX runs its Pallas kernels in interpret mode, the port its plain versions.

Also the fault this slice repairs: under ``bench.py``'s env
(``VOCALIE_KV_INT8=1 VOCALIE_WEIGHT_INT8=1``, ``VOCALIE_DENSE_KERNEL``
unset) the JAX package turns the dense kernels on; the port turned them
off and ran ``_qdot``, so the two gave different logits.

Tolerances: logits atol = rtol = 2e-3, as for slice 1 (the JAX package's
own bound for its decode-step kernels, ``tests/test_decode_step_fused.py``);
the int8 cache bytes the steps append are equal.

``VOCALIE_MEGALAYER=1`` (the whole layer as one launch, B12) on three tiny
family-like configs: Chatterbox-like (the d_model-128 model above, d_head
64, lane-packed on the JAX side), CosyVoice-like (the same with non-zero
q/k/v biases) and Qwen3-like (2 q heads and 1 kv head of 128, q/k norm).
Logits within 2e-3 + 2e-3 · |ref|; the appended cache's layer 0 equal
byte for byte (its k/v come from the B3 prologue on both sides), the other
layers' scales equal and their int8 values equal except where the port's
unquantized k/v sits on a .5 tie (off by one step, as in
``tests/test_torch_transformer.py``): they come from B12's next qkv, whose
f32 sums the port takes in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _int8_ties import assert_appended_cache_up_to_ties
from vocalie_tts_tpu.models.common import transformer as jt
from vocalie_tts_tpu_torch.bridge import tree_to_torch
from vocalie_tts_tpu_torch.models.common import transformer as pt

DIMS = dict(vocab_size=96, d_model=128, n_layers=2, n_heads=2, n_kv_heads=2, d_head=64,
            d_ff=256, max_seq_len=256)
DENSE = dict(kv_quant=True, decode_kernel=True, dense_kernel=True)
CACHE_LEN = 256


def _params(**dims):
    jcfg = jt.TransformerConfig(**{**DIMS, **dims}, dtype=jnp.float32)
    raw = jax.device_get(jt.init_params(jax.random.PRNGKey(0), jcfg))
    jparams = jt.fuse_decode_weights(jax.device_get(jax.jit(jt.quantize_weights_int8)(raw)))
    pparams = pt.fuse_decode_weights(pt.quantize_weights_int8(tree_to_torch(raw)))
    return jparams, pparams


@pytest.fixture(scope="module")
def params():
    return _params()


def _configs(flags, **dims):
    return (jt.TransformerConfig(**{**DIMS, **dims}, **flags, dtype=jnp.float32),
            pt.TransformerConfig(**{**DIMS, **dims}, **flags, dtype=torch.float32))


#: JAX decode-step programs shared by the tests of this file, by config and
#: the knobs JAX reads while it traces
_JITTED = {}


def _jax_step(jcfg, env):
    key = (jcfg, tuple(sorted(env.items())))
    if key not in _JITTED:
        _JITTED[key] = jax.jit(lambda p, t, c: jt.decode_step(p, jcfg, t, c))
    return _JITTED[key]


def _jax_prefill(jcfg):
    key = ("prefill", jcfg)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(lambda p, e, l: jt.prefill(
            p, jcfg, jnp.zeros(e.shape[:2], jnp.int32), l, inputs_embeds=e, cache_len=CACHE_LEN))
    return _JITTED[key]


def _run(jcfg, jparams, pcfg, pparams, *, b=4, n_steps=8, seed=1, jax_step=None, raw=None,
         jax_prompt=False):
    """Prefill logits, then teacher-forced decode logits, on both sides →
    (list of (jax, port) logits, jax cache, port cache). ``jax_step``: a
    shared jitted JAX step (the env must be as when it was traced);
    ``raw``: a list that receives the port's unquantized [L, b, kv, d] k and
    v of each step; ``jax_prompt``: the port decodes from JAX's int8 prompt
    cache (a prompt value on a .5 tie may round apart in the two prefills,
    ``tests/test_torch_transformer.py``), as ``tests/test_torch_qwen3.py``
    does."""
    s = 32
    rng = np.random.default_rng(seed)
    emb = (rng.standard_normal((b, s, jcfg.d_model)) * 0.5).astype(np.float32)
    lens = np.asarray([32, 20, 3, 11][:b], np.int32)
    toks = rng.integers(0, jcfg.vocab_size, (n_steps, b)).astype(np.int32)
    jl, jcache = _jax_prefill(jcfg)(jparams, jnp.asarray(emb), jnp.asarray(lens))
    pl, pcache = pt.prefill(pparams, pcfg, None, torch.from_numpy(lens),
                            inputs_embeds=torch.from_numpy(emb), cache_len=CACHE_LEN)
    out = [(np.asarray(jl), pl.numpy())]
    if jax_prompt:
        d = pcache.k.shape[-1]
        jk = np.asarray(jcache.k)
        jv = jk[..., d:] if jcache.v is None else np.asarray(jcache.v)
        for name, val in (("k", jk[..., :d]), ("v", jv)):
            getattr(pcache, name).copy_(torch.from_numpy(np.array(val)))
            getattr(pcache, name + "_scale").copy_(torch.from_numpy(np.array(
                getattr(jcache, name + "_scale").astype(jnp.float32))).to(torch.bfloat16))
    jstep = jax_step or jax.jit(lambda p, t, c: jt.decode_step(p, jcfg, t, c))
    quantize_kv = pt._quantize_kv
    if raw is not None:
        pt._quantize_kv = lambda t: raw.append(t.clone()) or quantize_kv(t)
    try:
        for i in range(n_steps):
            jl, jcache = jstep(jparams, jnp.asarray(toks[i]), jcache)
            pl, pcache = pt.decode_step(pparams, pcfg, torch.from_numpy(toks[i]).long(), pcache)
            out.append((np.asarray(jl), pl.numpy()))
    finally:
        pt._quantize_kv = quantize_kv
    return out, jcache, pcache


def _assert_logits(pairs):
    for i, (ref, got) in enumerate(pairs):
        np.testing.assert_allclose(got, ref, atol=2e-3, rtol=2e-3,
                                   err_msg="prefill" if i == 0 else f"step {i - 1}")


def _assert_logits_up_to_ties(pairs):
    """Prefill within 2e-3 + 2e-3 · |ref|; of the decode steps' (step, row)
    logit rows at most a quarter outside it. Where the port computes a
    norm before B4 in PyTorch (the ``DENSE_FNS`` path), its f32 mean and
    rsqrt differ from JAX's in the last ulp, and an int8 activation within
    an ulp of a .5 tie rounds the other way, moving one row at one step by
    ~1e-2 (ROADMAP C); a wrong path moves every row at every step."""
    (ref, got), *steps = pairs
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=2e-3, err_msg="prefill")
    out = [(np.abs(g - r) > 2e-3 + 2e-3 * np.abs(r)).any(-1) for r, g in steps]
    assert np.sum(out) * 4 <= np.size(out), out


def _assert_appended_cache(jcache, pcache, n_steps, prompt_pad=32):
    """The decode slots of the int8 cache: JAX's lane-packed k|v against
    the port's split k and v, values and bf16 scales equal."""
    sl = slice(prompt_pad, prompt_pad + n_steps)
    jk = np.asarray(jcache.k)[:, :, :, sl]
    d = pcache.k.shape[-1]
    assert np.array_equal(pcache.k[:, :, :, sl].numpy(), jk[..., :d])
    assert np.array_equal(pcache.v[:, :, :, sl].numpy(), jk[..., d:])
    for name in ("k_scale", "v_scale"):
        ref = np.asarray(getattr(jcache, name))[:, :, :, sl].view(np.int16)
        assert np.array_equal(getattr(pcache, name)[:, :, :, sl].view(torch.int16).numpy(), ref)


def test_dense_prefill_and_teacher_forced_decode(params):
    """Prefill's last-position logits through B4; each step through B3, B2
    per layer and B4; then the k/v the steps appended (B5)."""
    jcfg, pcfg = _configs(DENSE)
    assert jcfg.kv_packed
    pairs, jcache, pcache = _run(jcfg, params[0], pcfg, params[1], n_steps=12)
    _assert_logits(pairs)
    assert pcache.n_decoded == 12 == int(jcache.n_decoded)
    _assert_appended_cache(jcache, pcache, 12)


def test_dense_path_differs_from_qdot(params):
    """The dense path is not the ``_qdot`` one: the activations' int8
    quantization moves the logits by more than the tolerance above."""
    jcfg, pcfg = _configs(DENSE)
    pairs, _, _ = _run(jcfg, params[0], pcfg, params[1], n_steps=2)
    qpairs, _, _ = _run(jcfg, params[0], dataclasses.replace(pcfg, dense_kernel=False),
                        params[1], n_steps=2)
    assert all(np.abs(got - ref).max() > 2e-3 + 2e-3 * np.abs(ref).max()
               for (ref, _), (_, got) in zip(pairs[1:], qpairs[1:]))


def test_dense_batch_one_without_fused_step(params, monkeypatch):
    """Batch 1 with ``VOCALIE_FUSED_STEP=0``: the JAX package keeps the
    megatail path (the whole-step kernel B7 needs the knob on)."""
    monkeypatch.setenv("VOCALIE_FUSED_STEP", "0")
    jcfg, pcfg = _configs(DENSE)
    pairs, _, _ = _run(jcfg, params[0], pcfg, params[1], b=1, n_steps=3)
    _assert_logits(pairs)


def test_dense_without_fused_tail_raises(monkeypatch):
    """d_ff 192 (not a 128-multiple): the JAX package runs B4 for the
    fused qkv and the o-projection and ``_qdot`` for the MLP
    (``_make_dense_fns``). The port carries that dispatch now (it used to
    raise): prefill and the teacher-forced steps match up to ties, through
    B4 and never B8b."""
    jparams, pparams = _params(d_ff=192)
    jcfg, pcfg = _configs(DENSE, d_ff=192)
    calls = {"dense": 0, "mlp": 0}
    dense, mlp = pt.dense_int8_stacked, pt.mlp_swiglu_int8_stacked
    monkeypatch.setattr(pt, "dense_int8_stacked",
                        lambda *a, **k: calls.__setitem__("dense", calls["dense"] + 1)
                        or dense(*a, **k))
    monkeypatch.setattr(pt, "mlp_swiglu_int8_stacked",
                        lambda *a, **k: calls.__setitem__("mlp", calls["mlp"] + 1) or mlp(*a, **k))
    assert pt._dense_dispatch(pparams["layers"], pcfg, 4, CACHE_LEN) == pt.DENSE_FNS
    pairs, _, _ = _run(jcfg, jparams, pcfg, pparams, n_steps=3)
    _assert_logits_up_to_ties(pairs)
    # per step: the head, and qkv + o per layer; prefill: the head
    assert calls == {"dense": 1 + 3 * (1 + 2 * pcfg.n_layers), "mlp": 0}


def test_biased_swiglu_takes_b4_and_b8b(monkeypatch):
    """SwiGLU with biases (non-zero here) has no fused tail: the JAX package
    runs B4 for the qkv and o-projections and B8b for the MLP, which adds no
    ``b_down`` (``transformer.py:593-595``). Teacher-forced logits within
    2e-3 up to ties (``_assert_logits_up_to_ties``)."""
    dims = dict(bias=True, attn_bias=True)
    jcfg, pcfg = _configs(DENSE, **dims)
    raw = jax.device_get(jt.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(61)
    for name in ("bq", "bk", "bv", "bo", "b_up", "b_down"):
        raw["layers"][name] = (0.2 * rng.standard_normal(raw["layers"][name].shape)).astype(
            np.float32)
    jparams = jt.fuse_decode_weights(jax.device_get(jax.jit(jt.quantize_weights_int8)(raw)))
    pparams = pt.fuse_decode_weights(pt.quantize_weights_int8(tree_to_torch(raw)))
    calls = []
    mlp = pt.mlp_swiglu_int8_stacked
    monkeypatch.setattr(pt, "mlp_swiglu_int8_stacked",
                        lambda *a, **k: calls.append(1) or mlp(*a, **k))
    assert pt._dense_dispatch(pparams["layers"], pcfg, 4, CACHE_LEN) == pt.DENSE_FNS
    pairs, _, _ = _run(jcfg, jparams, pcfg, pparams, n_steps=4)
    _assert_logits_up_to_ties(pairs)
    assert len(calls) == 4 * pcfg.n_layers


def test_qk_norm_at_batch_one_skips_the_fused_step(monkeypatch):
    """The whole-step kernel B7 has no q/k norm: the JAX dispatch requires
    ``not cfg.qk_norm`` (``transformer.py:854``). A packed (d_head 64)
    qk-norm model at batch 1 takes the megatail, and matches JAX."""
    jparams, pparams = _params(qk_norm=True)
    jcfg, pcfg = _configs(DENSE, qk_norm=True)
    monkeypatch.delenv("VOCALIE_FUSED_STEP", raising=False)
    monkeypatch.delenv("VOCALIE_MEGATAIL", raising=False)
    calls = []
    monkeypatch.setattr(pt, "decode_step_fused_packed", lambda *a, **k: calls.append(1))
    assert 2 * pcfg.d_head == 128
    assert pt._dense_dispatch(pparams["layers"], pcfg, 1, CACHE_LEN) == pt.MEGATAIL
    pairs, _, _ = _run(jcfg, jparams, pcfg, pparams, b=1, n_steps=3)
    _assert_logits(pairs)
    assert not calls


def test_dense_at_tiny_width_takes_qdot(monkeypatch):
    """d_model 64 is not eligible: both packages take ``_qdot`` with the
    flag on, and no dense kernel runs on the port's side."""
    dims = dict(d_model=64, d_ff=128, n_heads=2, n_kv_heads=1, d_head=32)
    jparams, pparams = _params(**dims)
    jcfg, pcfg = _configs(DENSE, **dims)
    calls = []
    for name in ("dense_int8_stacked", "qkv_norm_int8_stacked", "tail_swiglu_qkv_int8_stacked"):
        fn = getattr(pt, name)
        monkeypatch.setattr(pt, name, lambda *a, _fn=fn, **k: calls.append(1) or _fn(*a, **k))
    pairs, _, _ = _run(jcfg, jparams, pcfg, pparams, n_steps=3)
    _assert_logits(pairs)
    assert not calls


@pytest.mark.parametrize("env,kernel", [
    ({"VOCALIE_MEGATAIL": "0"}, "B8"),
    ({"VOCALIE_MEGALAYER": "1"}, "B12"),
    ({}, "B7"),
])
def test_dense_knobs_without_a_port_raise(params, monkeypatch, env, kernel):
    """Each knob that once named a kernel the port lacked now runs it:
    ``{}`` at batch 1 the whole-step kernel B7, ``VOCALIE_MEGATAIL=0`` the
    tail B8a (with B3 per layer), ``VOCALIE_MEGALAYER=1`` the whole layer
    B12 (with the B3 prologue), each counted on one step
    (``tests/test_torch_decode_step.py`` and ``tests/test_torch_qwen3.py``
    hold B7 and B8a against JAX); B12's teacher-forced logits match JAX's
    here too (``test_megalayer_teacher_forced_decode`` holds three
    families)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jcfg, pcfg = _configs(DENSE)
    b = 1 if kernel == "B7" else 2
    cache = pt.StackedKVCache.create(2, b, 2, CACHE_LEN, 64, "cpu")
    name = {"B7": "decode_step_fused_packed", "B8": "tail_swiglu_int8_stacked",
            "B12": "layer_swiglu_qkv_int8_stacked"}[kernel]
    calls = []
    real = getattr(pt, name)
    monkeypatch.setattr(pt, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    logits, _ = pt.decode_step(params[1], pcfg, torch.zeros(b, dtype=torch.long), cache)
    assert calls == [1] * (1 if kernel == "B7" else pcfg.n_layers)
    assert torch.isfinite(logits).all()
    if kernel == "B12":
        pairs, _, _ = _run(jcfg, params[0], pcfg, params[1], b=2, n_steps=3,
                           jax_step=_jax_step(jcfg, env))
        _assert_logits(pairs)
        assert len(calls) == 4 * pcfg.n_layers


#: the megalayer's family-like configs: ``DIMS`` plus these
FAMILIES = {
    "chatterbox": {},
    "cosyvoice": dict(attn_bias=True),
    "qwen3": dict(n_heads=2, n_kv_heads=1, d_head=128, qk_norm=True, norm_eps=1e-6),
}
MEGALAYER_ENV = {"VOCALIE_MEGALAYER": "1"}
_FAMILY = {}


def _family(name):
    """(jax cfg, port cfg, jax params, port params) of a family-like config,
    with q/k/v biases and norm weights (q/k norm too) drawn from a numpy
    seed, so that none is inert."""
    if name not in _FAMILY:
        jcfg, pcfg = _configs(DENSE, **FAMILIES[name])
        raw = jax.device_get(jt.init_params(jax.random.PRNGKey(3), jcfg))
        rng = np.random.default_rng(71)
        layers = raw["layers"]
        for n in ("bq", "bk", "bv"):
            if n in layers:
                layers[n] = (0.2 * rng.standard_normal(layers[n].shape)).astype(np.float32)
        for n in ("attn_norm", "mlp_norm", "q_norm", "k_norm"):
            if n in layers:
                layers[n] = (1 + 0.2 * rng.standard_normal(layers[n].shape)).astype(np.float32)
        jparams = jt.fuse_decode_weights(jax.device_get(jax.jit(jt.quantize_weights_int8)(raw)))
        pparams = pt.fuse_decode_weights(pt.quantize_weights_int8(tree_to_torch(raw)))
        _FAMILY[name] = (jcfg, pcfg, jparams, pparams)
    return _FAMILY[name]


def _megalayer_env(monkeypatch, **extra):
    for k in ("VOCALIE_MEGATAIL", "VOCALIE_FUSED_STEP", "VOCALIE_TILE_MB"):
        monkeypatch.delenv(k, raising=False)
    for k, v in {**MEGALAYER_ENV, **extra}.items():
        monkeypatch.setenv(k, v)


def _count_b12(monkeypatch):
    calls = []
    real = pt.layer_swiglu_qkv_int8_stacked
    monkeypatch.setattr(pt, "layer_swiglu_qkv_int8_stacked",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_megalayer_teacher_forced_decode(monkeypatch, family):
    """``VOCALIE_MEGALAYER=1``: prefill, then 6 teacher-forced steps through
    the B3 prologue, B12 per layer and B4, against JAX's step with its
    Pallas kernels in interpret mode; B12's launches counted."""
    _megalayer_env(monkeypatch)
    jcfg, pcfg, jparams, pparams = _family(family)
    assert pt._dense_dispatch(pparams["layers"], pcfg, 4, CACHE_LEN) == pt.MEGALAYER
    calls, raw, n = _count_b12(monkeypatch), [], 6
    pairs, jcache, pcache = _run(jcfg, jparams, pcfg, pparams, n_steps=n,
                                 jax_step=_jax_step(jcfg, MEGALAYER_ENV), raw=raw,
                                 jax_prompt=True)
    _assert_logits(pairs)
    assert len(calls) == n * pcfg.n_layers
    assert_appended_cache_up_to_ties(jcache, pcache, raw)


def test_megalayer_dispatch_at_batch_one(monkeypatch):
    """With the knob at batch 1: the CosyVoice-like model takes the whole
    step (B7 comes first, as JAX's fused step returns before the layer
    scan), the Qwen3-like one B12 (q/k norm rules B7 out), and its steps
    match JAX's; ``VOCALIE_MEGATAIL=0`` with the knob set takes the tail
    (B12 needs the megatail)."""
    _megalayer_env(monkeypatch)
    cosy, qwen3 = _family("cosyvoice"), _family("qwen3")
    assert pt._dense_dispatch(cosy[3]["layers"], cosy[1], 1, CACHE_LEN) == pt.FUSED_STEP
    assert pt._dense_dispatch(qwen3[3]["layers"], qwen3[1], 1, CACHE_LEN) == pt.MEGALAYER
    jcfg, pcfg, jparams, pparams = qwen3
    calls = _count_b12(monkeypatch)
    pairs, _, _ = _run(jcfg, jparams, pcfg, pparams, b=1, n_steps=3,
                       jax_step=_jax_step(jcfg, MEGALAYER_ENV), jax_prompt=True)
    _assert_logits(pairs)
    assert len(calls) == 3 * pcfg.n_layers
    monkeypatch.setenv("VOCALIE_MEGATAIL", "0")
    for fam in (cosy, qwen3):
        assert pt._dense_dispatch(fam[3]["layers"], fam[1], 4, CACHE_LEN) == pt.TAIL


@pytest.mark.parametrize("env,expect", [
    ({"VOCALIE_KV_INT8": "1", "VOCALIE_WEIGHT_INT8": "1"}, True),   # bench.py
    ({"VOCALIE_KV_INT8": "1", "VOCALIE_WEIGHT_INT8": "1", "VOCALIE_DENSE_KERNEL": "0"}, False),
    ({"VOCALIE_KV_INT8": "1", "VOCALIE_DENSE_KERNEL": "1"}, True),
    ({"VOCALIE_KV_INT8": "1"}, False),
])
def test_runtime_env_sets_dense_kernel_as_jax(params, monkeypatch, env, expect):
    """``apply_runtime_env`` in both packages under the same env, then the
    teacher-forced logits of the d_model-128 model under the configs it
    gives. Under bench.py's env the port used to leave the dense kernels
    off while the JAX package turned them on."""
    from vocalie_tts_tpu.models.common.ar_runtime import apply_runtime_env as jax_env
    from vocalie_tts_tpu_torch.models.common.ar_runtime import apply_runtime_env as port_env

    for k in ("VOCALIE_KV_INT8", "VOCALIE_WEIGHT_INT8", "VOCALIE_DENSE_KERNEL",
              "VOCALIE_DECODE_KERNEL"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jcfg, pcfg = _configs({})
    jcfg, pcfg = jax_env(jcfg), port_env(pcfg)
    assert jcfg.dense_kernel is pcfg.dense_kernel is expect
    assert jcfg.decode_kernel is pcfg.decode_kernel is True
    pairs, _, _ = _run(jcfg, params[0], pcfg, params[1], n_steps=3)
    _assert_logits(pairs)
