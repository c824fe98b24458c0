"""The XTTS-class slice against the JAX package, on the CPU.

- The reference voice: ``normalize_ref_audio`` (a stereo 44.1 kHz WAV →
  mono 24 kHz at -20 dBFS) within 1e-6, and the runtimes' speaker x-vector
  of a reference (``normalize_ref_audio`` → ``embed_reference_audio``,
  L2-normed) within 1e-4, on JAX's weights.
- The GPT-2 transformer (LayerNorm with bias, GELU MLP, biases everywhere,
  learned positions indexed decode-relative, a head bias) at d_model 128,
  2 layers, 2 heads of 64, d_ff 256, vocab 1026, f32, int8 weights
  (JAX's quantized under ``jax.jit``, as its runtimes serve them) and the
  int8 KV cache, with non-zero biases and LayerNorm parameters from a numpy
  seed: prefill logits within 2e-3 + 2e-3 · |ref| (the JAX package's
  decode-step bound) and the prompt's int8 cache, equal except on .5 ties
  (``tests/test_torch_transformer.py``'s rule); then, from JAX's prompt
  cache on both sides (a tie in the prompt's k/v moves every later step of
  its row), teacher-forced decode logits within 2e-3 + 2e-3 · |ref| and the
  appended int8 k/v and bf16 scales equal, in the default
  int8 serving dispatch (``VOCALIE_MEGATAIL`` unset: B9a + B9b per layer)
  and with ``VOCALIE_MEGATAIL=0`` (B9a + B9c per layer), at batch 2 and at
  batch 1 (which must not reach the SwiGLU whole-step kernel B7).
- ``build_prompt_embeds`` on JAX's tiny weights; ``tokens_to_audio`` (stage
  2) on JAX's greedy tokens.
- The tiny runtime (``SCALES["tiny"]``: d_model 64, so ``_qdot`` in both
  packages) under the int8 serving env, greedy, with a reference WAV:
  tokens equal to JAX's (where the port's argmax leaves JAX's, JAX replayed
  teacher-forced must show the port's pick within the logit tolerance of
  its top, the near-tie rule of ``tests/test_torch_slice.py``), stage 2 on
  JAX's tokens within 33 LSB of int16, and ``run_tts_pipeline`` with
  ``tts_backend: "xtts"``. The vocoder is narrowed to 64 base channels on
  both sides (test side only) to keep the CPU time down.
- The GPT-2 transformer with RMSNorm in place of LayerNorm (the dense
  kernels' B4 + B9d dispatch): prefill and teacher-forced logits against
  JAX's up to the dense path's ties.
- The refusals: a published bundle at the LM's width, a ``tokenizer.json``,
  a request without a reference or with one under 3 s.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.models.common import transformer as jt
from vocalie_tts_tpu_torch.bridge import tree_to_torch
from vocalie_tts_tpu_torch.models.common import transformer as pt

TOL = lambda top: 2e-3 + 2e-3 * abs(top)  # noqa: E731
GPT2 = dict(vocab_size=1026, d_model=128, n_layers=2, n_heads=2, n_kv_heads=2, d_head=64,
            d_ff=256, max_seq_len=512, norm_type="layer", mlp_type="gelu", bias=True,
            attn_bias=True, pos_type="learned", pos_index="decode_relative", pos_len=608,
            head_bias=True, kv_quant=True, decode_kernel=True, dense_kernel=True)
ENV = {"VOCALIE_MODEL_SCALE": "tiny", "VOCALIE_KV_INT8": "1", "VOCALIE_WEIGHT_INT8": "1",
       "VOCALIE_ALLOW_RANDOM_WEIGHTS": "1"}
TEXTS = ["Bonjour à tous.", "Un essai rapide."]
#: the gain on stage 2's VQ embedding (test side, both packages)
VQ_GAIN = 1e4


def _ref_wav(path, seconds=3.0, sr=24000, stereo=False):
    from vocalie_tts_tpu.io.wavio import write_wav

    t = np.arange(int(seconds * sr)) / sr
    ref = (0.2 * np.sin(2 * np.pi * 180 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)))
    ref = ref.astype(np.float32)
    if stereo:
        ref = np.stack([ref, 0.5 * ref], 1)
    write_wav(str(path), ref, sr)
    return str(path)


def _randomize(tree, rng, names):
    """Non-zero biases / LayerNorm parameters from a numpy seed (the JAX
    init leaves them at 0 and 1)."""
    out = dict(tree)
    for name in names:
        base = 1.0 if name.endswith("norm") else 0.0
        out[name] = (base + 0.2 * rng.standard_normal(out[name].shape)).astype(
            np.asarray(out[name]).dtype)
    return out


# ── the reference voice ──────────────────────────────────────────────────


def test_normalize_ref_audio_matches_jax(tmp_path):
    from vocalie_tts_tpu.io.refs import normalize_ref_audio as jax_norm
    from vocalie_tts_tpu_torch.io.refs import normalize_ref_audio

    path = _ref_wav(tmp_path / "ref.wav", 3.5, 44100, stereo=True)
    ja, jsr = jax_norm(path)
    pa, psr = normalize_ref_audio(path)
    assert psr == jsr == 24000 and pa.shape == ja.shape and pa.dtype == np.float32
    np.testing.assert_allclose(pa, ja, atol=1e-6, rtol=0)


# ── the GPT-2 transformer ────────────────────────────────────────────────


@pytest.fixture(scope="module")
def gpt2():
    """(jax cfg, jax int8 fused params, port cfg, port int8 fused params)."""
    jcfg = jt.TransformerConfig(**GPT2, dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**GPT2, dtype=torch.float32)
    raw = jax.device_get(jax.jit(lambda k: jt.init_params(k, jcfg))(jax.random.PRNGKey(5)))
    rng = np.random.default_rng(6)
    raw = _randomize(raw, rng, ("final_norm", "final_norm_b", "lm_head_b"))
    raw["layers"] = _randomize(raw["layers"], rng, (
        "attn_norm", "attn_norm_b", "mlp_norm", "mlp_norm_b", "bq", "bk", "bv", "bo", "b_up",
        "b_down"))
    jparams = jt.fuse_decode_weights(jax.device_get(jax.jit(jt.quantize_weights_int8)(raw)))
    pparams = pt.fuse_decode_weights(pt.quantize_weights_int8(tree_to_torch(raw)))
    return jcfg, jparams, pcfg, pparams


def _count(monkeypatch, names):
    calls = {n: 0 for n in names}

    for n in names:
        real = getattr(pt, n)

        def wrapped(*a, _n=n, _real=real, **k):
            calls[_n] += 1
            return _real(*a, **k)

        monkeypatch.setattr(pt, n, wrapped)
    return calls


@pytest.mark.parametrize("mega", ["1", "0"])
@pytest.mark.parametrize("b", [2, 1])
def test_gpt2_prefill_and_teacher_forced_decode(gpt2, monkeypatch, mega, b):
    """Prefill over caller-built embeds (no positions added), then 6
    teacher-forced steps from JAX's prompt cache; the kernels each
    dispatch takes, counted."""
    monkeypatch.setenv("VOCALIE_MEGATAIL", mega)
    monkeypatch.delenv("VOCALIE_FUSED_STEP", raising=False)
    jcfg, jparams, pcfg, pparams = gpt2
    calls = _count(monkeypatch, ("qkv_lnorm_int8_stacked", "tail_gelu_qkv_int8_stacked",
                                 "tail_gelu_int8_stacked", "decode_step_fused_packed",
                                 "qkv_norm_int8_stacked", "dense_int8_stacked"))
    s, n_steps = 40, 6
    rng = np.random.default_rng(7)
    emb = (rng.standard_normal((b, s, 128)) * 0.5).astype(np.float32)
    lens = np.asarray([40, 23][:b], np.int32)
    toks = rng.integers(0, 1024, (n_steps, b)).astype(np.int32)

    def jprefill(cfg):
        return jax.jit(lambda p, e, l: jt.prefill(p, cfg, jnp.zeros(e.shape[:2], jnp.int32), l,
                                                  inputs_embeds=e, cache_len=128)
                       )(jparams, jnp.asarray(emb), jnp.asarray(lens))

    jl, jcache = jprefill(jcfg)
    pl, pcache = pt.prefill(pparams, pcfg, None, torch.from_numpy(lens),
                            inputs_embeds=torch.from_numpy(emb), cache_len=128)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=2e-3, rtol=2e-3)
    _, jraw = jprefill(dataclasses.replace(jcfg, kv_quant=False, decode_kernel=False))
    _check_prompt_cache(jcache, pcache, jraw, s)
    jk = torch.from_numpy(np.array(jcache.k))
    pcache.k, pcache.v = jk[..., :64].contiguous(), jk[..., 64:].contiguous()
    for name in ("k_scale", "v_scale"):
        getattr(pcache, name).copy_(torch.from_numpy(np.array(getattr(jcache, name).astype(
            jnp.float32))).to(torch.bfloat16))
    jstep = jax.jit(lambda p, t, c: jt.decode_step(p, jcfg, t, c))
    for i in range(n_steps):
        jl, jcache = jstep(jparams, jnp.asarray(toks[i]), jcache)
        pl, pcache = pt.decode_step(pparams, pcfg, torch.from_numpy(toks[i]).long(), pcache)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=2e-3, rtol=2e-3,
                                   err_msg=f"step {i}")
    want = {"qkv_lnorm_int8_stacked": n_steps if mega == "1" else 2 * n_steps,
            "tail_gelu_qkv_int8_stacked": 2 * n_steps if mega == "1" else 0,
            "tail_gelu_int8_stacked": 0 if mega == "1" else 2 * n_steps,
            "decode_step_fused_packed": 0, "qkv_norm_int8_stacked": 0,
            "dense_int8_stacked": n_steps + 1}
    assert calls == want
    sl = slice(s, s + n_steps)
    jk = np.asarray(jcache.k)[:, :, :, sl]
    assert np.array_equal(pcache.k[:, :, :, sl].numpy(), jk[..., :64])
    assert np.array_equal(pcache.v[:, :, :, sl].numpy(), jk[..., 64:])
    for name in ("k_scale", "v_scale"):
        ref = np.asarray(getattr(jcache, name))[:, :, :, sl].view(np.int16)
        assert np.array_equal(getattr(pcache, name)[:, :, :, sl].view(torch.int16).numpy(), ref)


def _check_prompt_cache(jcache, pcache, jraw, s):
    """The prompt slots of the int8 cache (JAX's lane-packed k|v against the
    port's split k and v): scales equal; values equal except on a .5 tie
    of the unquantized value (JAX's f32 cache ``jraw``), off by one."""
    for name in ("k_scale", "v_scale"):
        ref = np.asarray(getattr(jcache, name))[..., :s].view(np.int16)
        assert np.array_equal(getattr(pcache, name)[..., :s].view(torch.int16).numpy(), ref)
    jk = np.asarray(jcache.k)[..., :s, :]
    for i, name in enumerate(("k", "v")):
        ref = jk[..., 64 * i: 64 * (i + 1)]
        got = getattr(pcache, name)[..., :s, :].numpy()
        bad = got != ref
        if not bad.any():
            continue
        assert bad.mean() < 1e-3 and np.all(np.abs(got[bad].astype(int) - ref[bad]) == 1)
        scale = np.asarray(getattr(jcache, name + "_scale"))[..., :s].astype(np.float32)[..., None]
        x = (np.asarray(getattr(jraw, name), np.float32)[..., :s, :]
             / np.broadcast_to(scale, ref.shape))[bad]
        assert np.all(np.abs(np.abs(x - np.trunc(x)) - 0.5) < 1e-3), f"{name}: {x}"


def test_gpt2_token_prefill_adds_positions(gpt2):
    """The token path of prefill adds the learned table's first rows; the
    ``_qdot`` path (dense kernels off) gives JAX's logits too."""
    jcfg, jparams, pcfg, pparams = gpt2
    jcfg, pcfg = (dataclasses.replace(c, dense_kernel=False) for c in (jcfg, pcfg))
    toks = np.random.default_rng(8).integers(0, 1024, (2, 24)).astype(np.int32)
    lens = np.asarray([24, 9], np.int32)
    jl, _ = jax.jit(lambda p, t, l: jt.prefill(p, jcfg, t, l, cache_len=128))(
        jparams, jnp.asarray(toks), jnp.asarray(lens))
    pl, _ = pt.prefill(pparams, pcfg, torch.from_numpy(toks).long(), torch.from_numpy(lens),
                       cache_len=128)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=2e-3, rtol=2e-3)


def test_gpt2_unported_dispatch_raises(gpt2, monkeypatch):
    """A GELU MLP with RMSNorm takes B4 for qkv/o and B9d for the MLP in the
    JAX package (``transformer.py:792-799, :922-941``). The port used to
    refuse it; now the RMS GPT-2 config decodes and matches JAX: prefill
    logits within 2e-3 + 2e-3 · |ref|, then 3 teacher-forced steps from
    JAX's prompt cache within it up to the dense path's ties
    (``tests/test_torch_dense_step.py::_assert_logits_up_to_ties``), through
    B4 and B9d alone."""
    from test_torch_dense_step import _assert_logits_up_to_ties

    monkeypatch.delenv("VOCALIE_TILE_MB", raising=False)
    jcfg, jparams, pcfg, pparams = gpt2
    jcfg, pcfg = (dataclasses.replace(c, norm_type="rms") for c in (jcfg, pcfg))
    calls = _count(monkeypatch, ("dense_int8_stacked", "mlp_gelu_int8_stacked",
                                 "qkv_lnorm_int8_stacked", "tail_gelu_qkv_int8_stacked"))
    b, s, n_steps = 2, 40, 3
    rng = np.random.default_rng(9)
    emb = (rng.standard_normal((b, s, 128)) * 0.5).astype(np.float32)
    lens = np.asarray([40, 23], np.int32)
    toks = rng.integers(0, 1024, (n_steps, b)).astype(np.int32)
    jl, jcache = jax.jit(lambda p, e, l: jt.prefill(p, jcfg, jnp.zeros(e.shape[:2], jnp.int32),
                                                    l, inputs_embeds=e, cache_len=128)
                         )(jparams, jnp.asarray(emb), jnp.asarray(lens))
    pl, pcache = pt.prefill(pparams, pcfg, None, torch.from_numpy(lens),
                            inputs_embeds=torch.from_numpy(emb), cache_len=128)
    pairs = [(np.asarray(jl), pl.numpy())]
    jk = torch.from_numpy(np.array(jcache.k))
    pcache.k, pcache.v = jk[..., :64].contiguous(), jk[..., 64:].contiguous()
    for name in ("k_scale", "v_scale"):
        getattr(pcache, name).copy_(torch.from_numpy(np.array(getattr(jcache, name).astype(
            jnp.float32))).to(torch.bfloat16))
    jstep = jax.jit(lambda p, t, c: jt.decode_step(p, jcfg, t, c))
    for i in range(n_steps):
        jl, jcache = jstep(jparams, jnp.asarray(toks[i]), jcache)
        pl, pcache = pt.decode_step(pparams, pcfg, torch.from_numpy(toks[i]).long(), pcache)
        pairs.append((np.asarray(jl), pl.numpy()))
    _assert_logits_up_to_ties(pairs)
    L = pcfg.n_layers
    assert calls == {"dense_int8_stacked": 1 + n_steps * (1 + 2 * L),
                     "mlp_gelu_int8_stacked": n_steps * L,
                     "qkv_lnorm_int8_stacked": 0, "tail_gelu_qkv_int8_stacked": 0}


# ── the model pieces and the tiny runtime ────────────────────────────────


@pytest.fixture(scope="module")
def runtimes(tmp_path_factory):
    """The JAX and port ``XTTSRuntime`` at the tiny scale under the int8
    serving env, on one checkpoint saved by the JAX package (non-zero
    biases and LayerNorm parameters), the vocoder narrowed to 64 base
    channels in both packages."""
    from vocalie_tts_tpu.models.common.vocoder import VocoderConfig as JVoc
    from vocalie_tts_tpu.models.common.weights import save_params
    from vocalie_tts_tpu.models.xtts import model as jmodel
    from vocalie_tts_tpu.models.xtts.runtime import XTTSRuntime as JaxRuntime
    from vocalie_tts_tpu_torch.models.common.vocoder import VocoderConfig
    from vocalie_tts_tpu_torch.models.xtts import model as pmodel
    from vocalie_tts_tpu_torch.models.xtts.runtime import XTTSRuntime

    assets = tmp_path_factory.mktemp("assets")
    with pytest.MonkeyPatch.context() as mp:
        for k in ("VOCALIE_DENSE_KERNEL", "VOCALIE_FUSED_STEP", "VOCALIE_MEGATAIL",
                  "VOCALIE_DECODE_KERNEL"):
            mp.delenv(k, raising=False)
        for k, v in ENV.items():
            mp.setenv(k, v)
        mp.setattr(jmodel.XTTSConfig, "vocoder", property(
            lambda c: JVoc(n_mels=c.n_mels, base_channels=64, dtype=jnp.float32)))
        mp.setattr(pmodel.XTTSConfig, "vocoder", property(
            lambda c: VocoderConfig(n_mels=c.n_mels, base_channels=64)))
        from vocalie_tts_tpu.models.xtts.runtime import SCALES as JAX_SCALES

        cfg = JAX_SCALES["tiny"]
        gpt = jax.device_get(jax.jit(lambda k: jmodel.init_xtts(k, cfg))(jax.random.PRNGKey(23)))
        dec = jax.device_get(jax.jit(lambda k: jmodel.init_vq_decoder(k, cfg))(
            jax.random.PRNGKey(24)))
        # the init's VQ table renders a waveform under one int16 step: raised
        # so that the PCM comparisons below compare sound, not zeros
        dec = {**dec, "tok_emb": dec["tok_emb"] * np.float32(VQ_GAIN)}
        rng = np.random.default_rng(9)
        lm = _randomize(gpt["lm"], rng, ("final_norm", "final_norm_b", "lm_head_b"))
        lm["layers"] = _randomize(lm["layers"], rng, (
            "attn_norm", "attn_norm_b", "mlp_norm", "mlp_norm_b", "bq", "bk", "bv", "bo", "b_up",
            "b_down"))
        gpt = {**gpt, "lm": lm}
        wdir = assets / "xtts" / "weights"
        save_params(wdir, "gpt", gpt, meta={"family": "xtts"})
        save_params(wdir, "vq_decoder", dec, meta={"family": "xtts", "stage": "vq_decoder"})
        jrt = JaxRuntime.create(assets / "xtts")
        prt = XTTSRuntime.create(assets / "xtts", device="cpu")
        assert jrt.published is None and jrt.cfg.lm.kv_quant and prt.cfg.lm.decode_kernel
        yield jrt, prt, (gpt, dec), assets / "xtts"


def test_prompt_embeds_match_jax(runtimes):
    from vocalie_tts_tpu.models.xtts import model as jmodel
    from vocalie_tts_tpu_torch.bridge import xtts_bundle
    from vocalie_tts_tpu_torch.models.xtts import model as pmodel

    jrt, prt, (gpt, dec), _ = runtimes
    b = xtts_bundle(gpt, dec)
    rng = np.random.default_rng(10)
    toks = rng.integers(0, 260, (2, 30)).astype(np.int32)
    spk = rng.standard_normal((2, 64)).astype(np.float32)
    spk /= np.linalg.norm(spk, axis=-1, keepdims=True)
    ref = jmodel.build_prompt_embeds(gpt, jrt.cfg, jnp.asarray(toks), jnp.asarray(spk))
    got = pmodel.build_prompt_embeds(b["gpt"], prt.cfg, torch.from_numpy(toks),
                                     torch.from_numpy(spk))
    assert got.shape == (2, 30 + 33, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def _jax_tokens(jrt, texts, spk):
    """JAX's greedy tokens as its ``_decode`` makes them → (tokens,
    lengths, prompt embeds, prompt lengths, cache length)."""
    from vocalie_tts_tpu.models.xtts.model import BOS_VQ, EOS_VQ, build_prompt_embeds
    from vocalie_tts_tpu.ops.kv_cache import round_cache_len

    tokens, lengths, pb, bb, db = jrt._prepare_prompt(texts, "fr")
    spk_b = jnp.asarray(np.tile(spk[None], (bb, 1)))
    embeds = build_prompt_embeds(jrt.params["gpt"], jrt.cfg, jnp.asarray(tokens), spk_b)
    cache_len = round_cache_len(pb + db)
    out, n = jrt._generate(jrt.params["gpt"]["lm"], embeds, jnp.asarray(lengths),
                           jax.random.PRNGKey(0), cache_len=cache_len, max_new=db,
                           eos_token_id=EOS_VQ, temperature=0.0, top_k=50, top_p=0.85,
                           repetition_penalty=2.0, first_token=BOS_VQ)
    return np.asarray(out), np.asarray(n), embeds, jnp.asarray(lengths), cache_len


def _jax_replay(jrt, embeds, lengths, cache_len, tokens, n_steps):
    """JAX's biased, repetition-penalized logits at steps 0..n_steps-1, fed
    ``tokens`` (teacher forcing) → [n_steps, b, vocab]."""
    from vocalie_tts_tpu.models.xtts.model import BOS_VQ, vq_logit_bias
    from vocalie_tts_tpu.ops.sampling import apply_repetition_penalty

    cfg, lm = jrt.cfg.lm, jrt.params["gpt"]["lm"]
    _, cache = jt.prefill(lm, cfg, jnp.zeros(embeds.shape[:2], jnp.int32), lengths,
                          inputs_embeds=embeds, cache_len=cache_len)
    step = jax.jit(lambda p, t, c: jt.decode_step(p, cfg, t, c))
    counts = np.zeros((tokens.shape[0], cfg.vocab_size), np.int32)
    tok, out = np.full((tokens.shape[0],), BOS_VQ, np.int32), []
    for i in range(n_steps):
        logits, cache = step(lm, jnp.asarray(tok), cache)
        out.append(np.asarray(apply_repetition_penalty(logits + vq_logit_bias()[None],
                                                       jnp.asarray(counts), 2.0)))
        tok = tokens[:, i]
        counts[np.arange(len(tok)), tok] += 1
    return np.stack(out)


@pytest.fixture(scope="module")
def greedy(runtimes, tmp_path_factory):
    """Both sides' greedy tokens for ``TEXTS`` cloned from one reference,
    and ``flips``: row → the first step where the port leaves JAX (each a
    shown near-tie)."""
    jrt, prt, _, _ = runtimes
    ref = _ref_wav(tmp_path_factory.mktemp("ref") / "ref.wav")
    spk = np.asarray(jrt._spk_cache.get(ref), np.float32)
    jtok, jlen, embeds, lengths, cache_len = _jax_tokens(jrt, TEXTS, spk)
    ptok = []
    real = prt.stage2_pcm16
    prt.stage2_pcm16 = lambda t, n, s: ptok.append((t.numpy(), n.numpy())) or real(t, n, s)
    try:
        results = prt.synthesize_batch(TEXTS, voice_ref_path=ref, temperature=0.0)
    finally:
        del prt.stage2_pcm16
    (ptok, plen), = ptok
    flips = {r: int(np.argmax(jtok[r] != ptok[r])) for r in range(len(TEXTS))
             if (jtok[r] != ptok[r]).any()}
    if flips:
        logits = _jax_replay(jrt, embeds, lengths, cache_len, jtok, max(flips.values()) + 1)
        for r, s in flips.items():
            a = logits[s, r]
            assert a[ptok[r, s]] >= a.max() - TOL(a.max()), f"row {r} step {s}"
    return ref, spk, (jtok, jlen, ptok, plen), flips, results


def test_speaker_embedding_matches_jax(runtimes, greedy):
    """The runtimes' x-vector of the reference (normalized, then
    ``embed_reference_audio`` on JAX's speaker encoder weights)."""
    _, prt, _, _ = runtimes
    ref, spk = greedy[:2]
    got = prt._spk_cache.get(ref)
    assert got.shape == (64,) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got), 1.0, atol=1e-6)
    np.testing.assert_allclose(got, spk, atol=1e-4, rtol=0)


def test_tiny_runtime_greedy_tokens_and_pcm(runtimes, greedy):
    from vocalie_tts_tpu.models.common.ar_runtime import from_pcm16_wire

    jrt, prt, _, _ = runtimes
    ref, spk, (jtok, jlen, ptok, plen), flips, results = greedy
    for r in range(len(TEXTS)):
        s = flips.get(r, jtok.shape[1])
        np.testing.assert_array_equal(ptok[r, :s], jtok[r, :s], err_msg=f"row {r}")
        if r not in flips:
            assert plen[r] == jlen[r]
    spk_b = np.tile(spk[None], (jtok.shape[0], 1))
    jpcm = np.asarray(jrt._stage2(jrt.params["decoder"], tokens=jnp.asarray(jtok),
                                  tok_lengths=jnp.asarray(jlen), spk_emb=jnp.asarray(spk_b)))
    ppcm = prt.stage2_pcm16(torch.from_numpy(jtok), torch.from_numpy(jlen),
                            torch.from_numpy(spk_b)).numpy()
    assert np.abs(jpcm.astype(int)).max() > 1000   # not silent
    assert np.abs(ppcm.astype(int) - jpcm.astype(int)).max() <= 33
    for r, (audio, sr, meta) in enumerate(results):
        assert sr == 24000 and meta["vq_tokens"] == plen[r] and meta["decode_bucket"] == 64
        if r not in flips:
            want = from_pcm16_wire(jpcm)[r, : int(jlen[r]) * 1024]
            assert audio.shape == want.shape
            assert np.abs(audio - want).max() <= 33 / 32767 + 1e-6


def test_run_tts_pipeline_matches(runtimes, greedy, monkeypatch, tmp_path):
    """``run_tts_pipeline`` with ``tts_backend: "xtts"`` and a reference WAV
    in both packages, decoding greedily (``engine_params`` temperature 0)."""
    from vocalie_tts_tpu.engines import get_backend
    from vocalie_tts_tpu.io.wavio import read_wav
    from vocalie_tts_tpu.pipeline import run_tts_pipeline as jax_pipeline
    from vocalie_tts_tpu.text import parse_manual_chunks as jax_chunks
    from vocalie_tts_tpu_torch.engines import ENGINES
    from vocalie_tts_tpu_torch.engines.xtts import XTTSEngine
    from vocalie_tts_tpu_torch.pipeline import run_tts_pipeline
    from vocalie_tts_tpu_torch.text import parse_manual_chunks

    jrt, prt, _, _ = runtimes
    ref, *_, flips, _ = greedy
    assert ENGINES["xtts"] is XTTSEngine
    script = "\n[[CHUNK]]\n".join(TEXTS)
    base = {"tts_backend": "xtts", "script": script, "inter_chunk_gap_ms": 250,
            "target_sr": 24000, "voice_ref_path": ref, "engine_params": {"temperature": 0.0}}
    monkeypatch.setenv("VOCALIE_ALLOW_RANDOM_WEIGHTS", "1")
    jax_engine = get_backend("xtts")
    jax_engine.release_runtime()
    try:
        jax_engine._runtime = jrt
        jres = jax_pipeline({**base, "chunks": jax_chunks(script)[0],
                             "out_path": str(tmp_path / "jax.wav")})
    finally:
        jax_engine.release_runtime()
    engine = XTTSEngine(device="cpu")
    engine._runtime = prt
    pres = run_tts_pipeline({**base, "chunks": parse_manual_chunks(script)[0],
                             "out_path": str(tmp_path / "port.wav")}, engine=engine)
    jm, pm = jres.meta, pres.meta
    assert pm["chunks"] == jm["chunks"] == 2 and pm["backend_id"] == "xtts"
    for key in ("sr", "inter_chunk_gap_ms", "inter_chunk_gap_applied", "num_subunits"):
        assert pm[key] == jm[key], key
    pwav, psr = read_wav(pres.out_path)
    jwav, _ = read_wav(jres.out_path)
    assert psr == 24000 and np.isfinite(pwav).all() and np.abs(pwav).max() > 1000 / 32767
    if not flips:
        assert pm["durations"] == jm["durations"] and pwav.shape == jwav.shape
        assert np.abs(pwav - jwav).max() <= 34 / 32767


def test_bridge_and_save(runtimes):
    """``bridge.xtts_bundle`` of the JAX trees, through the runtime's int8
    transform, equals what the runtime loaded; ``save_weights`` refuses the
    int8 tree as the JAX runtime does."""
    from vocalie_tts_tpu_torch.bridge import xtts_bundle
    from vocalie_tts_tpu_torch.models.common.ar_runtime import maybe_quantize_lm
    from vocalie_tts_tpu_torch.models.common.weights import tree_items

    _, prt, (gpt, dec), _ = runtimes
    b = xtts_bundle(gpt, dec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOCALIE_WEIGHT_INT8", "1")
        want = dict(tree_items({"gpt": maybe_quantize_lm(b["gpt"]), "decoder": b["decoder"]}))
    got = dict(tree_items(prt.params))
    assert got.keys() == want.keys() and "gpt/lm/layers/wqkv/q" in got
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    with pytest.raises(RuntimeError, match="int8"):
        prt.save_weights()


def test_save_weights_round_trip(runtimes, tmp_path, monkeypatch):
    """With float weights (``VOCALIE_WEIGHT_INT8`` unset) ``save_weights``
    writes the unfused LM; a runtime created from what it wrote holds the
    same tree as the one that wrote it."""
    from vocalie_tts_tpu_torch.models.common.weights import tree_items
    from vocalie_tts_tpu_torch.models.xtts.runtime import XTTSRuntime

    _, _, _, assets = runtimes
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("VOCALIE_WEIGHT_INT8")
    rt = XTTSRuntime.create(assets, device="cpu")
    assert "wqkv" in rt.params["gpt"]["lm"]["layers"]
    rt.weights_dir = tmp_path / "weights"
    rt.save_weights()
    want = dict(tree_items(rt.params))
    got = dict(tree_items(XTTSRuntime.create(tmp_path, device="cpu").params))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_refusals(runtimes, tmp_path, monkeypatch):
    """No reference or one under 3 s: the JAX engine's errors. A published
    bundle at the LM's width, or a ``tokenizer.json``: NotImplementedError."""
    from vocalie_tts_tpu_torch.engines.base import EngineUnavailableError
    from vocalie_tts_tpu_torch.engines.xtts import XTTSEngine
    from vocalie_tts_tpu_torch.models.xtts.runtime import PUBLISHED_NAMES, XTTSRuntime

    _, prt, _, assets = runtimes
    engine = XTTSEngine(device="cpu")
    engine._runtime = prt
    with pytest.raises(EngineUnavailableError, match="référence"):
        engine.synthesize_batch(TEXTS)
    with pytest.raises(EngineUnavailableError, match="trop court"):
        engine.synthesize_batch(TEXTS, voice_ref_path=_ref_wav(tmp_path / "short.wav", 2.0))
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    pub = tmp_path / "pub"
    (pub / "weights").mkdir(parents=True)
    for name in PUBLISHED_NAMES:
        np.savez(pub / "weights" / f"{name}.npz", x=np.zeros(1))
    meta = {"xtts_cond": {"config": {"perceiver": {"dim": prt.cfg.d_model}}}}
    (pub / "weights" / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(NotImplementedError, match="published XTTS-v2 bundle"):
        XTTSRuntime.create(pub, device="cpu")
    (assets / "tokenizer.json").write_text("{}")
    try:
        with pytest.raises(NotImplementedError, match="tokenizer.json"):
            XTTSRuntime.create(assets, device="cpu")
    finally:
        (assets / "tokenizer.json").unlink()
