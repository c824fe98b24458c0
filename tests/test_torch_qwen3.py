"""The Qwen3-class slice against the JAX package, on the CPU.

Both packages' ``SCALES["tiny"]`` are widened here (test side only) to
d_model 256, 2 q heads and 1 kv head of d_head 128 (GQA group 2, the
full model's head width and its unpacked int8 cache), d_ff 512, 2 layers,
so that the dense decode path is eligible; the vocoder is narrowed to 64
base channels on both sides to keep the CPU time down. JAX runs its Pallas
kernels in interpret mode, the port its plain versions.

- The transformer (qk-norm with non-unit q/k norm weights from a numpy
  seed, int8 weights quantized as JAX's runtimes serve them, the int8 KV
  cache): prefill logits at the 512 prompt bucket (B6 against JAX's
  ``flash_attention``) within 2e-3 + 2e-3 · |ref| and the prompt's int8
  cache equal except on .5 ties; teacher-forced decode from JAX's prompt
  cache, logits within 2e-3 + 2e-3 · |ref| and the appended int8 k/v and
  bf16 scales equal, in the default dispatch (B3 prologue + B2 per layer)
  and with ``VOCALIE_MEGATAIL=0`` (B3 + B8a per layer), at batch 2 and 1
  (never B7: qk-norm).
- The runtime under the int8 serving env, greedy: tokens equal to JAX's
  for the three modes (custom_voice on three chunks; voice_design and
  voice_clone, with a 3 s reference WAV made with numpy, on one short
  chunk), custom_voice also with ``VOCALIE_MEGATAIL=0``; where the port's argmax leaves JAX's, JAX
  replayed teacher-forced must show the port's pick within the logit
  tolerance of its top (the near-tie rule of ``tests/test_torch_slice.py``).
  Stage 2 on JAX's tokens within 33 LSB of int16; ``run_tts_pipeline`` on
  a 3-chunk script with ``tts_backend: "qwen3"``.
- ``VOCALIE_MEGALAYER=1`` (B12, reached at d_head 128): teacher-forced
  decode against JAX's megalayer step, and one greedy custom_voice chunk
  through ``run_tts_pipeline`` with tokens equal to JAX's (near-tie rule).
- The refusal of ``VOCALIE_SERVE_MESH``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.models.common import transformer as jt
from vocalie_tts_tpu_torch.bridge import tree_to_torch
from vocalie_tts_tpu_torch.models.common import transformer as pt

TOL = lambda top: 2e-3 + 2e-3 * abs(top)  # noqa: E731
WIDE = dict(d_model=256, n_heads=2, n_kv_heads=1, d_ff=512)
LM = dict(vocab_size=2050, n_layers=2, d_head=128, max_seq_len=1024, qk_norm=True,
          norm_eps=1e-6, kv_quant=True, decode_kernel=True, dense_kernel=True,
          **{k: v for k, v in WIDE.items()})
ENV = {"VOCALIE_MODEL_SCALE": "tiny", "VOCALIE_KV_INT8": "1", "VOCALIE_WEIGHT_INT8": "1",
       "VOCALIE_ALLOW_RANDOM_WEIGHTS": "1"}
CLEARED = ("VOCALIE_DENSE_KERNEL", "VOCALIE_FUSED_STEP", "VOCALIE_MEGATAIL",
           "VOCALIE_DECODE_KERNEL", "VOCALIE_MEGALAYER", "VOCALIE_SERVE_MESH", "VOCALIE_TILE_MB",
           "VOCALIE_FUSE_QKV")
SCRIPT = ("Bonjour à tous.\n[[CHUNK]]\nUn essai rapide du moteur.\n[[CHUNK]]\n"
          "Et une troisième phrase.")
TEXTS = ["Bonjour à tous.", "Un essai rapide du moteur.", "Et une troisième phrase."]
#: one short chunk (batch 1, the 32-token decode bucket): the other modes
#: and the ``VOCALIE_MEGATAIL=0`` run, to keep the CPU time down
SHORT = ["Un essai."]
#: the gain on stage 2's codec embedding (test side, both packages): the
#: init's table renders a waveform under one int16 step
CODEC_GAIN = 1e4


def _ref_wav(path, seconds=3.0, sr=24000):
    from vocalie_tts_tpu.io.wavio import write_wav

    t = np.arange(int(seconds * sr)) / sr
    ref = 0.2 * np.sin(2 * np.pi * 180 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
    write_wav(str(path), ref.astype(np.float32), sr)
    return str(path)


def _randomize(tree, rng, names):
    """Norm weights away from 1 (the init's), from a numpy seed."""
    out = dict(tree)
    for name in names:
        out[name] = (1.0 + 0.2 * rng.standard_normal(out[name].shape)).astype(
            np.asarray(out[name]).dtype)
    return out


# ── the transformer ──────────────────────────────────────────────────────


@pytest.fixture(scope="module")
def qwen3_lm():
    """(jax cfg, jax int8 fused params, port cfg, port int8 fused params)."""
    jcfg = jt.TransformerConfig(**LM, dtype=jnp.float32)
    pcfg = pt.TransformerConfig(**LM, dtype=torch.float32)
    assert not jcfg.kv_packed
    raw = jax.device_get(jax.jit(lambda k: jt.init_params(k, jcfg))(jax.random.PRNGKey(31)))
    rng = np.random.default_rng(32)
    raw = _randomize(raw, rng, ("final_norm",))
    raw["layers"] = _randomize(raw["layers"], rng, ("attn_norm", "mlp_norm", "q_norm", "k_norm"))
    jparams = jt.fuse_decode_weights(jax.device_get(jax.jit(jt.quantize_weights_int8)(raw)))
    pparams = pt.fuse_decode_weights(pt.quantize_weights_int8(tree_to_torch(raw)))
    assert pparams["layers"]["q_norm"].shape == (2, 128)
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


#: JAX programs shared by the tests of this file, by (config, cache length
#: or ``VOCALIE_MEGATAIL``, which JAX reads while it traces)
_JITTED = {}


def _jax_prefill(jcfg, cache_len):
    key = ("prefill", jcfg, cache_len)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(lambda p, e, l: jt.prefill(
            p, jcfg, jnp.zeros(e.shape[:2], jnp.int32), l, inputs_embeds=e, cache_len=cache_len))
    return _JITTED[key]


def _jax_step(jcfg, mega):
    key = ("step", jcfg, mega)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(lambda p, t, c: jt.decode_step(p, jcfg, t, c))
    return _JITTED[key]


def _prefill_both(jcfg, jparams, pcfg, pparams, emb, lens, cache_len):
    jl, jcache = _jax_prefill(jcfg, cache_len)(jparams, jnp.asarray(emb), jnp.asarray(lens))
    pl, pcache = pt.prefill(pparams, pcfg, None, torch.from_numpy(lens),
                            inputs_embeds=torch.from_numpy(emb), cache_len=cache_len)
    return jl, jcache, pl, pcache


def _check_prompt_cache(jcache, pcache, jraw, s):
    """The prompt slots of the split int8 cache: scales equal; values equal
    except on a .5 tie of the unquantized value (JAX's f32 cache ``jraw``),
    off by one (``tests/test_torch_transformer.py``'s rule)."""
    for name in ("k", "v"):
        ref_s = np.asarray(getattr(jcache, name + "_scale"))[..., :s]
        assert np.array_equal(getattr(pcache, name + "_scale")[..., :s].view(torch.int16).numpy(),
                              ref_s.view(np.int16))
        ref = np.asarray(getattr(jcache, name))[..., :s, :]
        got = getattr(pcache, name)[..., :s, :].numpy()
        bad = got != ref
        if not bad.any():
            continue
        assert bad.mean() < 1e-3 and np.all(np.abs(got[bad].astype(int) - ref[bad]) == 1)
        scale = np.broadcast_to(ref_s.astype(np.float32)[..., None], ref.shape)
        x = (np.asarray(getattr(jraw, name), np.float32)[..., :s, :] / scale)[bad]
        assert np.all(np.abs(np.abs(x - np.trunc(x)) - 0.5) < 1e-3), f"{name}: {x}"


def test_prefill_at_the_512_bucket(qwen3_lm, monkeypatch):
    """Prefill over a 512-position prompt: causal flash attention (B6 at
    d_head 128, GQA group 2) on both sides; last-position logits through
    B4 and the prompt's int8 cache."""
    jcfg, jparams, pcfg, pparams = qwen3_lm
    calls = _count(monkeypatch, ("flash_attention",))
    rng = np.random.default_rng(33)
    s = 512
    emb = (rng.standard_normal((2, s, 256)) * 0.5).astype(np.float32)
    lens = np.asarray([512, 300], np.int32)
    jl, jcache, pl, pcache = _prefill_both(jcfg, jparams, pcfg, pparams, emb, lens, 640)
    assert calls == {"flash_attention": 2}
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=2e-3, rtol=2e-3)
    _, jraw = _jax_prefill(dataclasses.replace(jcfg, kv_quant=False, decode_kernel=False), 640)(
        jparams, jnp.asarray(emb), jnp.asarray(lens))
    _check_prompt_cache(jcache, pcache, jraw, s)


def _teacher_forced(qwen3_lm, monkeypatch, b, mega, n_steps=6):
    """``n_steps`` teacher-forced steps from JAX's prompt cache on both
    sides (``mega``: the JAX program's key), logits within 2e-3 + 2e-3 ·
    |ref| → (kernel calls, jax cache, port cache, appended slots)."""
    jcfg, jparams, pcfg, pparams = qwen3_lm
    calls = _count(monkeypatch, ("qkv_norm_int8_stacked", "tail_swiglu_qkv_int8_stacked",
                                 "tail_swiglu_int8_stacked", "decode_step_fused_packed",
                                 "mlp_swiglu_int8_stacked", "dense_int8_stacked",
                                 "layer_swiglu_qkv_int8_stacked"))
    s = 40
    rng = np.random.default_rng(34)
    emb = (rng.standard_normal((b, s, 256)) * 0.5).astype(np.float32)
    lens = np.asarray([40, 23][:b], np.int32)
    toks = rng.integers(0, 2048, (n_steps, b)).astype(np.int32)
    jl, jcache, pl, pcache = _prefill_both(jcfg, jparams, pcfg, pparams, emb, lens, 128)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=2e-3, rtol=2e-3)
    for name in ("k", "v"):
        getattr(pcache, name).copy_(torch.from_numpy(np.array(getattr(jcache, name))))
        getattr(pcache, name + "_scale").copy_(torch.from_numpy(np.array(
            getattr(jcache, name + "_scale").astype(jnp.float32))).to(torch.bfloat16))
    jstep = _jax_step(jcfg, mega)
    for i in range(n_steps):
        jl, jcache = jstep(jparams, jnp.asarray(toks[i]), jcache)
        pl, pcache = pt.decode_step(pparams, pcfg, torch.from_numpy(toks[i]).long(), pcache)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=2e-3, rtol=2e-3,
                                   err_msg=f"step {i}")
    return calls, jcache, pcache, slice(s, s + n_steps)


@pytest.mark.parametrize("mega", ["1", "0"])
@pytest.mark.parametrize("b", [2, 1])
def test_teacher_forced_decode(qwen3_lm, monkeypatch, mega, b):
    """6 teacher-forced steps from JAX's prompt cache on both sides; the
    kernels each dispatch takes, counted."""
    monkeypatch.setenv("VOCALIE_MEGATAIL", mega)
    for k in ("VOCALIE_FUSED_STEP", "VOCALIE_MEGALAYER", "VOCALIE_TILE_MB"):
        monkeypatch.delenv(k, raising=False)
    n_steps, L = 6, qwen3_lm[2].n_layers
    calls, jcache, pcache, sl = _teacher_forced(qwen3_lm, monkeypatch, b, mega, n_steps)
    want = {"qkv_norm_int8_stacked": n_steps if mega == "1" else L * n_steps,
            "tail_swiglu_qkv_int8_stacked": L * n_steps if mega == "1" else 0,
            "tail_swiglu_int8_stacked": 0 if mega == "1" else L * n_steps,
            "decode_step_fused_packed": 0, "mlp_swiglu_int8_stacked": 0,
            "dense_int8_stacked": n_steps + 1, "layer_swiglu_qkv_int8_stacked": 0}
    assert calls == want
    for name in ("k", "v", "k_scale", "v_scale"):
        ref = np.asarray(getattr(jcache, name))[:, :, :, sl]
        got = getattr(pcache, name)[:, :, :, sl]
        if got.dtype == torch.bfloat16:
            got, ref = got.view(torch.int16), ref.view(np.int16)
        assert np.array_equal(got.numpy(), ref), name


def test_megalayer_is_refused(qwen3_lm, monkeypatch):
    """d_head 128 passes the JAX megalayer's ``d_head % 128 == 0``
    (``transformer.py:837``): ``VOCALIE_MEGALAYER=1`` runs B12 there, which
    the port once refused. 6 teacher-forced steps at batch 2 from JAX's
    prompt cache: B3 + L x B12 + B4 a step, logits within 2e-3 + 2e-3 ·
    |ref| of JAX's, the appended bf16 scales equal, layer 0's int8 k/v
    equal (the B3 prologue's) and the later layers' at most one step off
    (batch 1: ``tests/test_torch_dense_step.py``)."""
    monkeypatch.setenv("VOCALIE_MEGALAYER", "1")
    for k in ("VOCALIE_MEGATAIL", "VOCALIE_FUSED_STEP", "VOCALIE_TILE_MB"):
        monkeypatch.delenv(k, raising=False)
    n_steps, L = 6, qwen3_lm[2].n_layers
    calls, jcache, pcache, sl = _teacher_forced(qwen3_lm, monkeypatch, 2, "megalayer", n_steps)
    assert calls == {"qkv_norm_int8_stacked": n_steps, "layer_swiglu_qkv_int8_stacked": L * n_steps,
                     "tail_swiglu_qkv_int8_stacked": 0, "tail_swiglu_int8_stacked": 0,
                     "decode_step_fused_packed": 0, "mlp_swiglu_int8_stacked": 0,
                     "dense_int8_stacked": n_steps + 1}
    for name in ("k", "v", "k_scale", "v_scale"):
        ref = np.asarray(getattr(jcache, name))[:, :, :, sl]
        got = getattr(pcache, name)[:, :, :, sl]
        if got.dtype == torch.bfloat16:
            got, ref = got.view(torch.int16), ref.view(np.int16)
        assert np.array_equal(got.numpy()[0], ref[0]), name
        bad = got.numpy() != ref
        assert name in ("k", "v") or not bad.any(), name
        assert np.all(np.abs(got.numpy()[bad].astype(int) - ref[bad].astype(int)) == 1), name


# ── the runtime ──────────────────────────────────────────────────────────


def _memo_generate(jrt):
    """JAX's generate program, remembered per input: greedy (temperature
    <= 0) does not read the key, so the tests and JAX's own pipeline share
    one JAX run per prompt."""
    real, memo = jrt._generate, {}

    def generate(lm, embeds, lengths, key, **kw):
        tag = (np.asarray(embeds).tobytes(), np.asarray(lengths).tobytes(),
               tuple(sorted(kw.items())))
        if kw["temperature"] > 0:
            return real(lm, embeds, lengths, key, **kw)
        if tag not in memo:
            memo[tag] = jax.device_get(real(lm, embeds, lengths, key, **kw))
        return memo[tag]

    jrt._generate = generate


@pytest.fixture(scope="module")
def runtimes(tmp_path_factory):
    """The JAX and port ``LMTTSRuntime`` at the widened tiny scale under the
    int8 serving env, on one checkpoint saved by the JAX package (q/k and
    layer norm weights away from 1, the codec embedding raised by
    ``CODEC_GAIN``), the vocoder narrowed to 64 base channels."""
    from vocalie_tts_tpu.models.common.vocoder import VocoderConfig as JVoc
    from vocalie_tts_tpu.models.common.weights import save_params
    from vocalie_tts_tpu.models.lmtts import model as jmodel
    from vocalie_tts_tpu.models.lmtts.runtime import SCALES as JAX_SCALES
    from vocalie_tts_tpu.models.lmtts.runtime import LMTTSRuntime as JaxRuntime
    from vocalie_tts_tpu_torch.models.common.vocoder import VocoderConfig
    from vocalie_tts_tpu_torch.models.lmtts import model as pmodel
    from vocalie_tts_tpu_torch.models.lmtts.runtime import SCALES, LMTTSRuntime

    assets = tmp_path_factory.mktemp("assets")
    with pytest.MonkeyPatch.context() as mp:
        for k in CLEARED:
            mp.delenv(k, raising=False)
        for k, v in ENV.items():
            mp.setenv(k, v)
        mp.setitem(JAX_SCALES, "tiny", dataclasses.replace(JAX_SCALES["tiny"], **WIDE))
        mp.setitem(SCALES, "tiny", dataclasses.replace(SCALES["tiny"], **WIDE))
        mp.setattr(jmodel.LMTTSConfig, "vocoder", property(lambda c: JVoc(
            n_mels=c.n_mels, base_channels=16, upsample_rates=(8, 6, 5),
            upsample_kernels=(16, 12, 10), dtype=jnp.float32)))
        mp.setattr(pmodel.LMTTSConfig, "vocoder", property(lambda c: VocoderConfig(
            n_mels=c.n_mels, base_channels=16, upsample_rates=(8, 6, 5),
            upsample_kernels=(16, 12, 10))))
        cfg = JAX_SCALES["tiny"]
        bundle = jax.device_get(jax.jit(lambda k: jmodel.init_lmtts(k, cfg))(
            jax.random.PRNGKey(41)))
        dec = jax.device_get(jax.jit(lambda k: jmodel.init_codec_decoder(k, cfg))(
            jax.random.PRNGKey(42)))
        dec = {**dec, "tok_emb": dec["tok_emb"] * np.float32(CODEC_GAIN)}
        rng = np.random.default_rng(43)
        lm = _randomize(bundle["lm"], rng, ("final_norm",))
        lm["layers"] = _randomize(lm["layers"], rng, ("attn_norm", "mlp_norm", "q_norm",
                                                      "k_norm"))
        bundle = {**bundle, "lm": lm}
        wdir = assets / "qwen3" / "weights"
        save_params(wdir, "lm", bundle, meta={"family": "lmtts", "text_vocab": cfg.text_vocab,
                                              "codec_vocab": cfg.codec_vocab})
        save_params(wdir, "codec_decoder", dec, meta={"family": "lmtts",
                                                      "stage": "codec_decoder"})
        jrt = JaxRuntime.create(assets / "qwen3")
        prt = LMTTSRuntime.create(assets / "qwen3", device="cpu")
        assert jrt.cfg.lm.dense_kernel and prt.cfg.lm.dense_kernel and prt.cfg.lm.qk_norm
        assert prt.cfg.lm.d_head == 128 and prt.cfg.lm.n_heads == 2 * prt.cfg.lm.n_kv_heads
        _memo_generate(jrt)
        yield jrt, prt, (bundle, dec), assets / "qwen3", mp


MODES = {
    "custom_voice": dict(mode="custom_voice", speaker="Serena"),
    "voice_design": dict(mode="voice_design", instruct="Voix grave et posée."),
    "voice_clone": dict(mode="voice_clone", x_vector_only=True),
}


def _jax_tokens(jrt, texts, kw):
    """JAX's greedy tokens as its ``synthesize_batch`` makes them →
    (tokens, lengths, prompt embeds, prompt lengths, cache length)."""
    from vocalie_tts_tpu.models.lmtts.model import (
        SPEAKERS,
        build_prompt_embeds,
        lang_one_hot,
    )
    from vocalie_tts_tpu.models.lmtts.runtime import (
        BATCH_BUCKETS,
        DECODE_BUCKETS,
        PROMPT_BUCKETS,
        TOKENS_PER_SECOND,
    )
    from vocalie_tts_tpu.models.common.ar_runtime import pad_token_batch
    from vocalie_tts_tpu.ops.kv_cache import pick_bucket, round_cache_len
    from vocalie_tts_tpu.text.duration import estimate_duration
    from vocalie_tts_tpu.text.frontend import build_prompt_ids

    cfg, bundle = jrt.cfg, jrt.params["lm_bundle"]
    mode = kw["mode"]
    preamble = kw.get("instruct", "") if mode != "voice_clone" else ""
    seqs = [build_prompt_ids(jrt._frontend, t, preamble=preamble) for t in texts]
    tokens, lengths, pb, bb = pad_token_batch(seqs, prompt_buckets=PROMPT_BUCKETS,
                                              batch_buckets=BATCH_BUCKETS, extra_positions=3)
    if mode == "voice_clone":
        spk = jrt._spk_cache.get(kw["voice_ref_path"])
    elif mode == "custom_voice":
        spk = np.asarray(bundle["speaker_table"][SPEAKERS.index(kw["speaker"])], np.float32)
    else:
        spk = np.zeros((cfg.speaker_dim,), np.float32)
    spk_b = jnp.asarray(np.tile(spk[None, :], (bb, 1)))
    lang_b = jnp.tile(lang_one_hot("French")[None, :], (bb, 1))
    est = max(int(estimate_duration(t) * TOKENS_PER_SECOND * 1.8) + 8 for t in texts)
    db = pick_bucket(est, DECODE_BUCKETS)
    cache_len = round_cache_len(pb + db)
    embeds = build_prompt_embeds(bundle, cfg, jnp.asarray(tokens), spk_b, lang_b)
    out, n = jrt._generate(bundle["lm"], embeds, jnp.asarray(lengths), jax.random.PRNGKey(0),
                           cache_len=cache_len, max_new=db, eos_token_id=cfg.eos_audio,
                           temperature=0.0, top_k=50, first_token=cfg.bos_audio)
    return np.asarray(out), np.asarray(n), embeds, jnp.asarray(lengths), cache_len


def _jax_replay(jrt, embeds, lengths, cache_len, tokens, n_steps):
    """JAX's biased logits at steps 0..n_steps-1, fed ``tokens`` (teacher
    forcing) → [n_steps, b, vocab]."""
    from vocalie_tts_tpu.models.lmtts.model import codec_logit_bias

    cfg, lm = jrt.cfg, jrt.params["lm_bundle"]["lm"]
    _, cache = jt.prefill(lm, cfg.lm, jnp.zeros(embeds.shape[:2], jnp.int32), lengths,
                          inputs_embeds=embeds, cache_len=cache_len)
    step = jax.jit(lambda p, t, c: jt.decode_step(p, cfg.lm, t, c))
    tok, out = np.full((tokens.shape[0],), cfg.bos_audio, np.int32), []
    for i in range(n_steps):
        logits, cache = step(lm, jnp.asarray(tok), cache)
        out.append(np.asarray(logits + codec_logit_bias(cfg)[None]))
        tok = tokens[:, i]
    return np.stack(out)


def _greedy(jrt, prt, kw, texts, run=None):
    """Both sides' greedy tokens for ``texts`` in one mode, the port's
    through ``synthesize_batch`` (or ``run(texts, **kw)``, which must reach
    it once); ``flips``: row → the first step where the port leaves JAX,
    each a shown near-tie."""
    jtok, jlen, embeds, lengths, cache_len = _jax_tokens(jrt, texts, kw)
    seen = []
    real = prt.stage2_pcm16
    prt.stage2_pcm16 = lambda t, n: seen.append((t.numpy(), n.numpy())) or real(t, n)
    try:
        results = (run or (lambda t, **k: prt.synthesize_batch(t, language="French",
                                                                temperature=0.0, **k)))(texts, **kw)
    finally:
        del prt.stage2_pcm16
    (ptok, plen), = seen
    flips = {r: int(np.argmax(jtok[r] != ptok[r])) for r in range(len(texts))
             if (jtok[r] != ptok[r]).any()}
    if flips:
        logits = _jax_replay(jrt, embeds, lengths, cache_len, jtok, max(flips.values()) + 1)
        for r, s in flips.items():
            a = logits[s, r]
            assert a[ptok[r, s]] >= a.max() - TOL(a.max()), f"row {r} step {s}"
    for r in range(len(texts)):
        s = flips.get(r, jtok.shape[1])
        np.testing.assert_array_equal(ptok[r, :s], jtok[r, :s], err_msg=f"row {r}")
        if r not in flips:
            assert plen[r] == jlen[r], f"row {r}"
    assert (jlen > 0).all()
    return jtok, jlen, flips, results


@pytest.fixture(scope="module")
def ref_wav(tmp_path_factory):
    return _ref_wav(tmp_path_factory.mktemp("ref") / "ref.wav")


@pytest.fixture(scope="module")
def greedy(runtimes, ref_wav):
    """``greedy(mode)`` → ``_greedy``'s result in that mode (default env),
    computed once: custom_voice on ``TEXTS``, the others on ``SHORT``."""
    jrt, prt, *_ = runtimes
    done = {}

    def get(mode):
        if mode not in done:
            kw = {**MODES[mode], "voice_ref_path": ref_wav if mode == "voice_clone" else None}
            done[mode] = _greedy(jrt, prt, kw, TEXTS if mode == "custom_voice" else SHORT)
        return done[mode]

    return get


@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_tokens_match(greedy, mode):
    _, _, _, results = greedy(mode)
    for audio, sr, meta in results:
        assert sr == 24000 and meta["mode"] == mode and meta["engine"] == "qwen3"
        assert audio.shape == (meta["codec_tokens"] * 1920,) and np.isfinite(audio).all()


def test_greedy_tokens_match_without_megatail(runtimes, monkeypatch):
    """``VOCALIE_MEGATAIL=0`` on both sides: JAX retraces a new generate
    program (the knob is read while it traces), the port takes B3 + B8a."""
    from vocalie_tts_tpu.models.common.ar_runtime import make_generate_fn
    from vocalie_tts_tpu.models.lmtts.model import codec_logit_bias

    jrt, prt, *_ = runtimes
    monkeypatch.setenv("VOCALIE_MEGATAIL", "0")
    monkeypatch.setattr(jrt, "_generate", make_generate_fn(jrt.cfg.lm, codec_logit_bias(jrt.cfg)))
    calls = _count(monkeypatch, ("tail_swiglu_int8_stacked", "tail_swiglu_qkv_int8_stacked"))
    _greedy(jrt, prt, MODES["custom_voice"], SHORT)
    assert calls["tail_swiglu_int8_stacked"] > 0 and calls["tail_swiglu_qkv_int8_stacked"] == 0


def test_megalayer_pipeline_tokens_match(runtimes, monkeypatch, tmp_path):
    """``run_tts_pipeline`` with ``VOCALIE_MEGALAYER=1``, one short
    custom_voice chunk, greedy: the port's tokens (B3 + L x B12 + B5 + B4 a
    step) equal JAX's under the same knob (a new JAX generate program: the
    knob is read while it traces), up to shown near-ties."""
    from vocalie_tts_tpu.models.common.ar_runtime import make_generate_fn
    from vocalie_tts_tpu.models.lmtts.model import codec_logit_bias
    from vocalie_tts_tpu_torch.engines.qwen3 import Qwen3Engine
    from vocalie_tts_tpu_torch.pipeline import pad_short_text, run_tts_pipeline
    from vocalie_tts_tpu_torch.text import parse_manual_chunks

    jrt, prt, *_ = runtimes
    monkeypatch.setenv("VOCALIE_MEGALAYER", "1")
    monkeypatch.setattr(jrt, "_generate", make_generate_fn(jrt.cfg.lm, codec_logit_bias(jrt.cfg)))
    calls = _count(monkeypatch, ("layer_swiglu_qkv_int8_stacked", "tail_swiglu_qkv_int8_stacked"))
    seen, real = [], prt.synthesize_batch

    def pipeline(texts, **kw):
        engine = Qwen3Engine(device="cpu")
        engine._runtime = prt
        prt.synthesize_batch = lambda t, **k: seen.append((t, k)) or real(
            t, **{**k, "temperature": 0.0})
        try:
            script = SHORT[0] + "\n[[CHUNK]]"
            res = run_tts_pipeline({"tts_backend": "qwen3", "script": script,
                                    "chunks": parse_manual_chunks(script)[0], "lang": "fr-FR",
                                    "target_sr": 24000, "out_path": str(tmp_path / "mega.wav"),
                                    "engine_params": {"qwen3_mode": "custom_voice",
                                                      "speaker": "Serena"}}, engine=engine)
        finally:
            del prt.synthesize_batch
        assert res.meta["chunks"] == 1 and seen[0][0] == texts
        return [(np.zeros(1), 24000, {})]

    # the pipeline pads a short chunk by repeating it (``pad_short_text``)
    _greedy(jrt, prt, MODES["custom_voice"], [pad_short_text(SHORT[0])[0]], run=pipeline)
    assert calls["layer_swiglu_qkv_int8_stacked"] > 0 and calls["tail_swiglu_qkv_int8_stacked"] == 0
    assert calls["layer_swiglu_qkv_int8_stacked"] % prt.cfg.lm.n_layers == 0


def test_speaker_embedding_matches_jax(runtimes, ref_wav):
    jrt, prt, *_ = runtimes
    got, ref = prt._spk_cache.get(ref_wav), np.asarray(jrt._spk_cache.get(ref_wav))
    assert got.shape == (256,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_prompt_embeds_match_jax(runtimes):
    from vocalie_tts_tpu.models.lmtts import model as jmodel
    from vocalie_tts_tpu_torch.bridge import lmtts_bundle
    from vocalie_tts_tpu_torch.models.lmtts import model as pmodel

    jrt, prt, (bundle, dec), _, _ = runtimes
    b = lmtts_bundle(bundle, dec)
    rng = np.random.default_rng(44)
    toks = rng.integers(0, 260, (2, 30)).astype(np.int32)
    spk = rng.standard_normal((2, 256)).astype(np.float32)
    lang = np.stack([np.asarray(jmodel.lang_one_hot(x)) for x in ("French", "Klingon")])
    ref = jmodel.build_prompt_embeds(bundle, jrt.cfg, jnp.asarray(toks), jnp.asarray(spk),
                                     jnp.asarray(lang))
    plang = torch.stack([pmodel.lang_one_hot(x) for x in ("French", "Klingon")])
    assert np.array_equal(plang.numpy(), lang)
    got = pmodel.build_prompt_embeds(b["lm_bundle"], prt.cfg, torch.from_numpy(toks),
                                     torch.from_numpy(spk), plang)
    assert got.shape == (2, 33, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(pmodel.codec_logit_bias(prt.cfg).numpy(),
                                  np.asarray(jmodel.codec_logit_bias(jrt.cfg)))


def test_stage2_pcm_on_jax_tokens(runtimes):
    jrt, prt, *_ = runtimes
    jtok, jlen, *_ = _jax_tokens(jrt, TEXTS, MODES["custom_voice"])
    jpcm = np.asarray(jrt._stage2(jrt.params["decoder"], tokens=jnp.asarray(jtok),
                                  tok_lengths=jnp.asarray(jlen)))
    ppcm = prt.stage2_pcm16(torch.from_numpy(jtok), torch.from_numpy(jlen)).numpy()
    assert ppcm.dtype == jpcm.dtype == np.int16 and ppcm.shape == jpcm.shape
    assert np.abs(jpcm.astype(int)).max() > 1000   # not silent
    assert np.abs(ppcm.astype(int) - jpcm.astype(int)).max() <= 33


def test_run_tts_pipeline_matches(runtimes, greedy, tmp_path):
    """``run_tts_pipeline`` with ``tts_backend: "qwen3"`` on a 3-chunk script
    in both packages, custom_voice, greedy (the engines pass no
    temperature, so each runtime's ``synthesize_batch`` is given 0 here;
    the JAX run shares its decode with ``test_greedy_tokens_match``)."""
    from vocalie_tts_tpu.engines import get_backend
    from vocalie_tts_tpu.io.wavio import read_wav
    from vocalie_tts_tpu.pipeline import run_tts_pipeline as jax_pipeline
    from vocalie_tts_tpu.text import parse_manual_chunks as jax_chunks
    from vocalie_tts_tpu_torch.engines import ENGINES
    from vocalie_tts_tpu_torch.engines.qwen3 import Qwen3Engine
    from vocalie_tts_tpu_torch.pipeline import run_tts_pipeline
    from vocalie_tts_tpu_torch.text import parse_manual_chunks

    jrt, prt, *_ = runtimes
    assert ENGINES["qwen3"] is Qwen3Engine
    base = {"tts_backend": "qwen3", "script": SCRIPT, "inter_chunk_gap_ms": 250,
            "target_sr": 24000, "lang": "fr-FR",
            "engine_params": {"qwen3_mode": "custom_voice", "speaker": "Serena"}}
    flips = greedy("custom_voice")[2]
    jax_engine = get_backend("qwen3")
    jax_engine.release_runtime()
    jreal = jrt.synthesize_batch
    jrt.synthesize_batch = lambda texts, **kw: jreal(texts, **{**kw, "temperature": 0.0})
    try:
        jax_engine._runtime = jrt
        jres = jax_pipeline({**base, "chunks": jax_chunks(SCRIPT)[0],
                             "out_path": str(tmp_path / "jax.wav")})
    finally:
        del jrt.synthesize_batch
        jax_engine.release_runtime()
    engine = Qwen3Engine(device="cpu")
    engine._runtime = prt
    real = prt.synthesize_batch
    prt.synthesize_batch = lambda texts, **kw: real(texts, **{**kw, "temperature": 0.0})
    try:
        pres = run_tts_pipeline({**base, "chunks": parse_manual_chunks(SCRIPT)[0],
                                 "out_path": str(tmp_path / "port.wav")}, engine=engine)
    finally:
        del prt.synthesize_batch
    jm, pm = jres.meta, pres.meta
    assert pm["chunks"] == jm["chunks"] == 3 and pm["backend_id"] == "qwen3"
    for key in ("sr", "inter_chunk_gap_ms", "inter_chunk_gap_applied", "num_subunits"):
        assert pm[key] == jm[key], key
    for key in ("qwen3_mode", "qwen3_model", "qwen3_speaker", "prompt_bucket", "decode_bucket"):
        assert pm["backend_meta"][key] == jm["backend_meta"][key], key
    pwav, psr = read_wav(pres.out_path)
    jwav, _ = read_wav(jres.out_path)
    assert psr == 24000 and np.isfinite(pwav).all() and np.abs(pwav).max() > 1000 / 32767
    assert [d for i, d in enumerate(pm["durations"]) if i not in flips] == \
        [d for i, d in enumerate(jm["durations"]) if i not in flips]
    if not flips:
        assert pwav.shape == jwav.shape
        assert np.abs(pwav - jwav).max() <= 34 / 32767


def test_bridge_and_save(runtimes, tmp_path, monkeypatch):
    """``bridge.lmtts_bundle`` of the JAX trees through the runtime's int8
    transform equals what the runtime loaded; ``save_weights`` refuses the
    int8 tree, and with float weights writes a checkpoint that loads back
    into the same tree."""
    from vocalie_tts_tpu_torch.bridge import lmtts_bundle
    from vocalie_tts_tpu_torch.models.common.ar_runtime import maybe_quantize_lm
    from vocalie_tts_tpu_torch.models.common.weights import tree_items
    from vocalie_tts_tpu_torch.models.lmtts.runtime import LMTTSRuntime

    _, prt, (bundle, dec), assets, _ = runtimes
    b = lmtts_bundle(bundle, dec)
    monkeypatch.setenv("VOCALIE_WEIGHT_INT8", "1")
    want = dict(tree_items({"lm_bundle": maybe_quantize_lm(b["lm_bundle"]),
                          "decoder": b["decoder"]}))
    got = dict(tree_items(prt.params))
    assert got.keys() == want.keys() and "lm_bundle/lm/layers/k_norm" in got
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    with pytest.raises(RuntimeError, match="int8"):
        prt.save_weights()
    monkeypatch.delenv("VOCALIE_WEIGHT_INT8")
    rt = LMTTSRuntime.create(assets, device="cpu")
    rt.weights_dir = tmp_path / "weights"
    rt.save_weights()
    want = dict(tree_items(rt.params))
    got = dict(tree_items(LMTTSRuntime.create(tmp_path, device="cpu").params))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_refusals(runtimes, ref_wav, tmp_path, monkeypatch):
    """The engine's request resolution against the JAX engine's (a
    reference turns custom_voice into voice_clone unless the mode is
    asked for; an emotion becomes the instruction); voice_clone without a
    reference or with one under 1 s: the JAX engine's errors;
    ``VOCALIE_SERVE_MESH``: NotImplementedError."""
    from vocalie_tts_tpu.engines.qwen3 import Qwen3Engine as JaxEngine
    from vocalie_tts_tpu_torch.engines.base import EngineUnavailableError
    from vocalie_tts_tpu_torch.engines.qwen3 import Qwen3Engine
    from vocalie_tts_tpu_torch.models.lmtts.runtime import LMTTSRuntime

    _, prt, _, assets, _ = runtimes
    engine = Qwen3Engine(device="cpu")
    engine._runtime = prt
    for ref, params in ((ref_wav, {}), (ref_wav, {"qwen3_mode": "custom_voice"}),
                        (None, {"qwen3_mode": "voice_design", "emotion": "Sad"}),
                        (None, {"speaker": "Ryan", "model_id": "m"}),
                        (None, {"qwen3_mode": "bogus", "voice": "Eric", "emotion": "neutral"})):
        assert engine._resolve_request(ref, dict(params)) == \
            JaxEngine()._resolve_request(ref, dict(params)), params
    with pytest.raises(EngineUnavailableError, match="ref audio"):
        engine.synthesize_batch(TEXTS, qwen3_mode="voice_clone")
    with pytest.raises(EngineUnavailableError, match="trop court"):
        engine.synthesize_batch(TEXTS, voice_ref_path=_ref_wav(tmp_path / "short.wav", 0.5))
    assert engine.map_language("fr-FR") == "French" and engine.map_language(None) == "French"
    assert engine.map_language("xx-XX") == "Auto"
    monkeypatch.setenv("VOCALIE_SERVE_MESH", "2x1")
    with pytest.raises(NotImplementedError, match="VOCALIE_SERVE_MESH"):
        LMTTSRuntime.create(assets, device="cpu")
