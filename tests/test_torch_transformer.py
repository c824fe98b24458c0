"""The port's transformer core against the JAX reference at the tiny T3
scale (f32), in the slice's configuration: int8 KV cache, the decode
attention kernel (B1, Pallas interpret mode on the JAX side, the plain
version on the port's), int8 weights (q/k/v and gate/up fused on the
port's side; fused and not on the JAX side), dense kernels off. Params come from the JAX ``init_t3`` and cross through ``bridge``.

Tolerances:
- int8 weight quantization: exact, against ``jax.jit(quantize_weights_int8)``,
  the form the JAX runtimes serve (XLA scales by the f32 reciprocal of 127;
  ``test_runtime_quantizer_matches_jitted_jax`` holds the runtimes'
  transform at the T3 width);
- prefill / teacher-forced decode logits: atol = rtol = 2e-3, the JAX
  package's own bound for its decode-step kernels
  (tests/test_decode_step_fused.py);
- bf16 cache scales: exact; int8 cache values: exact, except where the
  unquantized value sits on a rounding tie (|x/scale| within 1e-3 of
  n + 0.5): the two libraries' matmuls differ in the last ulp of k/v, so
  such an element may round to either neighbour. The test takes the JAX
  side's unquantized k/v (the same prefill with the bf16/f32 cache) and
  checks that every differing element is such a tie, off by one step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.models.chatterbox.model import init_t3
from vocalie_tts_tpu.models.chatterbox.runtime import SCALES as JAX_SCALES
from vocalie_tts_tpu.models.common import transformer as jt
from vocalie_tts_tpu_torch.bridge import tree_to_torch
from vocalie_tts_tpu_torch.models.chatterbox.runtime import SCALES
from vocalie_tts_tpu_torch.models.common import transformer as pt

SLICE = dict(kv_quant=True, decode_kernel=True, dense_kernel=False)


@pytest.fixture(scope="module", params=["fused", "unfused"])
def models(request):
    """The JAX reference runs q/k/v and gate/up concatenated (``fused``,
    its default) or as the separate int8 matrices (``unfused``); the
    port's forward always runs them fused. ``exact`` is the port's tree
    in the JAX tree's layout, for the bit-exact check."""
    jcfg = dataclasses.replace(JAX_SCALES["tiny"], **SLICE)
    pcfg = dataclasses.replace(SCALES["tiny"], **SLICE)
    raw = jax.device_get(init_t3(jax.random.PRNGKey(0), jcfg)["lm"])
    jparams = jax.device_get(jax.jit(jt.quantize_weights_int8)(raw))
    exact = pt.quantize_weights_int8(tree_to_torch(raw))
    pparams = pt.fuse_decode_weights(exact)
    if request.param == "fused":
        jparams, exact = jt.fuse_decode_weights(jparams), pparams
    return jcfg.lm, jparams, pcfg.lm, pparams, exact


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_int8_quantize_and_fuse_match_exactly(models):
    _, jparams, _, _, exact = models
    jl = dict(_leaves(jax.device_get(jparams)))
    pl = dict(_leaves(exact))
    assert jl.keys() == pl.keys()
    for key, ref in jl.items():
        got = pl[key].float().numpy() if pl[key].dtype == torch.bfloat16 else pl[key].numpy()
        assert got.dtype == np.asarray(ref).dtype or pl[key].dtype == torch.bfloat16, key
        assert np.array_equal(got, np.asarray(ref, got.dtype)), key


def test_runtime_quantizer_matches_jitted_jax(monkeypatch):
    """The runtimes' int8 transform (``maybe_quantize_lm`` under
    ``VOCALIE_WEIGHT_INT8=1``: quantize, then fuse) against the JAX
    runtimes' own, which runs inside one ``jax.jit``
    (``weights.materialize_bundle``), byte for byte, on a sub-stack of the
    T3 q/k/v weights ([4, 1024, 1024] each → a fused [4, 1024, 3072]). A
    true division of ``amax`` by 127 gives other scales here (the eager
    JAX form)."""
    from vocalie_tts_tpu.models.common.ar_runtime import maybe_quantize_lm as jax_mq
    from vocalie_tts_tpu_torch.models.common.ar_runtime import maybe_quantize_lm

    monkeypatch.setenv("VOCALIE_WEIGHT_INT8", "1")
    monkeypatch.delenv("VOCALIE_FUSE_QKV", raising=False)
    rng = np.random.default_rng(23)
    layers = {k: (rng.standard_normal((4, 1024, 1024)) / 32).astype(jnp.bfloat16)
              for k in ("wq", "wk", "wv")}
    ref = jax.device_get(jax.jit(jax_mq)({"lm": {"layers": layers}}))["lm"]["layers"]["wqkv"]
    got = maybe_quantize_lm({"lm": {"layers": tree_to_torch(layers)}})["lm"]["layers"]["wqkv"]
    assert got["q"].shape == (4, 1024, 3072)
    assert np.array_equal(got["s"].numpy().view(np.int32), np.asarray(ref["s"]).view(np.int32))
    assert np.array_equal(got["q"].numpy(), np.asarray(ref["q"]))


def _embeds(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32) * 0.5


def _check_cache(jcache, pcache, jraw=None):
    """``jraw``: the JAX cache of the same prefill without int8 (f32 k/v)."""
    for name in ("k_scale", "v_scale"):
        ref = np.asarray(getattr(jcache, name)).view(np.int16)
        got = getattr(pcache, name).view(torch.int16).numpy()
        assert np.array_equal(got, ref), f"{name} differs"
    for name in ("k", "v"):
        ref = np.asarray(getattr(jcache, name))
        got = getattr(pcache, name).numpy()
        bad = got != ref
        if not bad.any():
            continue
        assert jraw is not None, f"int8 {name} differs at {np.argwhere(bad)[:4]}"
        assert bad.mean() < 1e-4, f"int8 {name}: {bad.sum()} values differ"
        assert np.all(np.abs(got[bad].astype(int) - ref[bad].astype(int)) == 1)
        scale = np.asarray(getattr(jcache, name + "_scale")).astype(np.float32)[..., None]
        x = np.asarray(getattr(jraw, name), np.float32)[bad] / np.broadcast_to(scale, bad.shape)[bad]
        assert np.all(np.abs(np.abs(x - np.trunc(x)) - 0.5) < 1e-3), f"{name}: {x}"


@pytest.mark.parametrize("s", [64, 512])
def test_prefill_logits_and_int8_cache(models, s):
    """s=64 takes the plain softmax on both sides; s=512 the flash
    kernel (B6) — interpret mode in JAX, the plain version here."""
    jcfg, jparams, pcfg, pparams, _ = models
    b = 2 if s == 512 else 4
    emb = _embeds(s, b, s, jcfg.d_model)
    lens = np.asarray([s, s - 13, 3, 17][:b], np.int32)
    def jax_prefill(cfg):
        return jax.jit(
            lambda p, e, l: jt.prefill(p, cfg, jnp.zeros(e.shape[:2], jnp.int32), l,
                                       inputs_embeds=e, cache_len=s + 128)
        )(jparams, jnp.asarray(emb), jnp.asarray(lens))

    jlogits, jcache = jax_prefill(jcfg)
    _, jraw = jax_prefill(dataclasses.replace(jcfg, kv_quant=False, decode_kernel=False))
    plogits, pcache = pt.prefill(pparams, pcfg, None, torch.from_numpy(lens),
                                 inputs_embeds=torch.from_numpy(emb), cache_len=s + 128)
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), atol=2e-3, rtol=2e-3)
    _check_cache(jcache, pcache, jraw)
    assert pcache.prompt_pad == s and pcache.n_decoded == 0


def test_decode_steps_teacher_forced(models):
    """Per-step logits under teacher forcing, then the cache the steps
    appended (B5 on the port side, the Pallas appender in JAX)."""
    jcfg, jparams, pcfg, pparams, _ = models
    b, s, n_steps = 4, 64, 12
    emb = _embeds(1, b, s, jcfg.d_model)
    lens = np.asarray([64, 40, 3, 21], np.int32)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (n_steps, b)).astype(np.int32)

    _, jcache = jax.jit(
        lambda p, e, l: jt.prefill(p, jcfg, jnp.zeros(e.shape[:2], jnp.int32), l,
                                   inputs_embeds=e, cache_len=256)
    )(jparams, jnp.asarray(emb), jnp.asarray(lens))
    jstep = jax.jit(lambda p, t, c: jt.decode_step(p, jcfg, t, c))
    _, pcache = pt.prefill(pparams, pcfg, None, torch.from_numpy(lens),
                           inputs_embeds=torch.from_numpy(emb), cache_len=256)
    for i in range(n_steps):
        jlogits, jcache = jstep(jparams, jnp.asarray(toks[i]), jcache)
        plogits, pcache = pt.decode_step(pparams, pcfg, torch.from_numpy(toks[i]).long(), pcache)
        np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), atol=2e-3, rtol=2e-3,
                                   err_msg=f"step {i}")
    assert pcache.n_decoded == n_steps == int(jcache.n_decoded)
    _check_cache(jcache, pcache)


def test_unported_configs_raise(models):
    """The decode-attention branch the port once refused now runs: JAX's
    non-T-blocked int8 kernel, which an int8 cache of other than a
    128-multiple length takes with the decode kernel on (B1w). Prefill
    with ``cache_len`` 192, then 3 teacher-forced steps, against JAX's:
    logits within 2e-3 + 2e-3 · |ref| and the cache as ``_check_cache``
    holds it. The XLA branch (the decode kernel off) on the same cache runs
    too, and so does the dense flag at this width (d_model 64 is not
    eligible: ``_qdot``, as in JAX; tests/test_torch_dense_step.py holds the
    dense path, tests/test_torch_noenv.py the cache and attention branches
    against JAX)."""
    jcfg, jparams, pcfg, pparams, _ = models
    emb, lens, tok = torch.zeros(1, 4, pcfg.d_model), torch.tensor([3]), torch.tensor([1])
    logits, _ = pt.prefill(pparams, dataclasses.replace(pcfg, dense_kernel=True), None, lens,
                           inputs_embeds=emb)
    assert logits.shape == (1, pcfg.vocab_size)
    xla = dataclasses.replace(pcfg, decode_kernel=False)
    _, cache = pt.prefill(pparams, xla, None, lens, inputs_embeds=emb, cache_len=192)
    logits, _ = pt.decode_step(pparams, xla, tok, cache)
    assert torch.isfinite(logits).all() and cache.n_decoded == 1

    b, s, n_steps = 2, 40, 3
    emb = _embeds(3, b, s, jcfg.d_model)
    lens = np.asarray([40, 17], np.int32)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (n_steps, b)).astype(np.int32)

    @jax.jit
    def jax_run(p, e, l):
        logits, cache = jt.prefill(p, jcfg, jnp.zeros(e.shape[:2], jnp.int32), l,
                                   inputs_embeds=e, cache_len=192)
        out = [logits]
        for i in range(n_steps):
            logits, cache = jt.decode_step(p, jcfg, jnp.asarray(toks[i]), cache)
            out.append(logits)
        return out, cache

    jlogits, jcache = jax_run(jparams, jnp.asarray(emb), jnp.asarray(lens))
    plogits, pcache = pt.prefill(pparams, pcfg, None, torch.from_numpy(lens),
                                 inputs_embeds=torch.from_numpy(emb), cache_len=192)
    got = [plogits]
    for i in range(n_steps):
        plogits, pcache = pt.decode_step(pparams, pcfg, torch.from_numpy(toks[i]).long(), pcache)
        got.append(plogits)
    for i, (ref, g) in enumerate(zip(jlogits, got)):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), atol=2e-3, rtol=2e-3,
                                   err_msg=f"logits {i}")
    assert pcache.max_len == 192 and pcache.n_decoded == n_steps
    _check_cache(jcache, pcache)