"""The whole port at the tiny scale: the JAX ``ChatterboxRuntime`` and the
port's, on the same weights (saved once in the ``.npz`` format and loaded
by both), in two configurations, one file each so that ``--dist loadfile``
runs them on two workers (this file: ``slice1``;
``tests/test_torch_slice2.py`` imports these tests with its own
``runtimes`` fixture: ``slice2``):

- ``slice1``: int8 KV cache, int8 weights, the decode-attention and
  cache-append kernels, dense kernels off (``VOCALIE_DENSE_KERNEL=0`` on
  both sides), at the ``tiny`` T3 width;
- ``slice2``: the JAX package's default int8 serving configuration
  (``VOCALIE_DENSE_KERNEL`` unset, so the dense kernels B2-B4 are on), on a
  ``tiny`` T3 widened (test side only, in both packages' ``SCALES``) to
  d_model 128, 2 heads, d_ff 256 so that the dense path is eligible.

- Greedy decoding (temperature 0) with CFG and the repetition penalty:
  token ids and lengths must be equal. With the dense kernels on, the
  activations are quantized to int8 per row, and the two libraries round
  a norm or an exp differently in the last ulp; an element on a .5 tie
  can then round the other way, and with random weights the logits hold
  near-ties. Such a tie moves a row's logits past the gate at its step and,
  through the cache bytes it changes, at later steps, so a free-running
  greedy row can leave JAX's tokens after a few hundred steps. Where the
  port's argmax leaves JAX's, the test replays both teacher-forced on
  JAX's tokens up to that step, the port's step run from JAX's cache at
  every step: each logit row of each step within the logit tolerance
  (2e-3 + 2e-3 * |ref|) of JAX's, or brought within it by one int8
  rounding within 64 ulps of its .5 tie taken the other way
  (``tests/_int8_ties.py``); tokens are then compared up to that step.
  ``slice1`` must have no such step.
- Stage 2 on the JAX tokens, with JAX's noise handed to the port: int16
  PCM within 33 LSB (1e-3 of full scale, the stage-2 tolerance).
- ``run_tts_pipeline`` on a 3-chunk ``[[CHUNK]]`` script: chunk count,
  per-chunk token lengths and durations, WAV length and meta keys agree
  (the sample values are covered by the stage-2 comparison); a chunk whose
  greedy row left JAX's tokens is left out of what depends on its length.

JAX's generate program is remembered per input where it decodes greedily
(which reads no key), so the greedy, stage-2 and pipeline tests share one
JAX decode of the script. The port's side runs on one torch thread (a
fixture).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

SCRIPT = (
    "Bonjour à tous, voici un premier essai.\n[[CHUNK]]\n"
    "La deuxième phrase est un peu plus longue que la première, mais pas trop.\n[[CHUNK]]\n"
    "Et enfin, une troisième."
)
ENV = {
    "VOCALIE_MODEL_SCALE": "tiny",
    "VOCALIE_KV_INT8": "1",
    "VOCALIE_WEIGHT_INT8": "1",
    "VOCALIE_ALLOW_RANDOM_WEIGHTS": "1",
}
CONFIGS = {"slice1": {"VOCALIE_DENSE_KERNEL": "0"}, "slice2": {}}
WIDE = dict(d_model=128, n_heads=2, n_kv_heads=2, d_ff=256)


def _memo_generate(jrt):
    """Remember JAX's generate program per input where it decodes greedily
    (temperature <= 0 reads no key)."""
    real, memo = jrt._generate, {}

    def generate(t3, embeds, lens, key, **kw):
        if kw["temperature"] > 0:
            return real(t3, embeds, lens, key, **kw)
        tag = (np.asarray(embeds).tobytes(), np.asarray(lens).tobytes(),
               tuple(sorted(kw.items())))
        if tag not in memo:
            memo[tag] = jax.device_get(real(t3, embeds, lens, key, **kw))
        return memo[tag]

    jrt._generate = generate


def make_runtimes(config, tmp_path_factory):
    """(JAX runtime, port runtime, the env's MonkeyPatch) for one of
    ``CONFIGS``, yielded while the env holds."""
    from vocalie_tts_tpu.models.chatterbox.model import init_t3, init_token_decoder
    from vocalie_tts_tpu.models.chatterbox.runtime import SCALES as JAX_SCALES
    from vocalie_tts_tpu.models.chatterbox.runtime import ChatterboxRuntime as JaxRuntime
    from vocalie_tts_tpu.models.common.weights import save_params
    from vocalie_tts_tpu_torch.models.chatterbox.runtime import SCALES
    from vocalie_tts_tpu_torch.models.chatterbox.runtime import ChatterboxRuntime

    dense = config == "slice2"
    assets = tmp_path_factory.mktemp("assets")
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("VOCALIE_DENSE_KERNEL", raising=False)
        for k, v in {**ENV, **CONFIGS[config]}.items():
            mp.setenv(k, v)
        mp.setenv("VOCALIE_ASSETS_DIR", str(assets))
        if dense:
            mp.setitem(JAX_SCALES, "tiny", dataclasses.replace(JAX_SCALES["tiny"], **WIDE))
            mp.setitem(SCALES, "tiny", dataclasses.replace(SCALES["tiny"], **WIDE))
        cfg = JAX_SCALES["tiny"]
        wdir = assets / "chatterbox" / "weights"
        save_params(wdir, "t3", init_t3(jax.random.PRNGKey(1), cfg),
                    meta={"family": "chatterbox", "stage": "t3"})
        # the stage-2 tree in one jitted call (the eager init compiled op by
        # op: ~10 s of this fixture); the T3 tree stays eager, as its greedy
        # tokens' ties were recorded on it
        s3gen = jax.device_get(jax.jit(lambda k: init_token_decoder(k, cfg))(
            jax.random.PRNGKey(2)))
        save_params(wdir, "s3gen", s3gen, meta={"family": "chatterbox", "stage": "s3gen"})
        jrt = JaxRuntime.create(assets / "chatterbox")
        prt = ChatterboxRuntime.create(assets / "chatterbox", device="cpu")
        assert jrt.cfg.lm.dense_kernel is dense and jrt.cfg.lm.decode_kernel is True
        assert prt.cfg.lm.dense_kernel is dense and prt.cfg.lm.d_model == cfg.d_model
        _memo_generate(jrt)
        yield jrt, prt, mp


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs tiny tensors: one intra-op thread is as fast
    here, and it keeps the suite's parallel workers from oversubscribing the
    CPU with spinning thread pools (the port's greedy tokens are the same on
    one thread as on eight, in both configurations)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["slice1"])
def runtimes(request, tmp_path_factory):
    yield from make_runtimes(request.param, tmp_path_factory)


def _texts():
    from vocalie_tts_tpu_torch.text import parse_manual_chunks, render_clean_text_from_segments

    chunks, _ = parse_manual_chunks(SCRIPT)
    return [render_clean_text_from_segments(c.segments) for c in chunks]


def _jax_generate(jrt, texts, **kw):
    t3, embeds, lens, (_, _, decode_bucket, cache_len) = jrt._prepare_batch(
        texts, mode="fr_finetune", lang="fr", voice_ref_path=None,
        exaggeration=0.5, cfg_weight=kw["cfg_weight"])
    toks, lengths = jrt._generate(t3, embeds, lens, jax.random.PRNGKey(0), cache_len=cache_len,
                                  max_new=decode_bucket, **kw)
    return np.asarray(toks), np.asarray(lengths)


def _port_generate(prt, texts, **kw):
    t3, embeds, lens, (_, _, decode_bucket, cache_len) = prt._prepare_batch(
        texts, mode="fr_finetune", lang="fr", exaggeration=0.5, cfg_weight=kw["cfg_weight"])
    toks, lengths = prt.generate(t3, embeds, lens, cache_len=cache_len, max_new=decode_bucket, **kw)
    return toks.numpy(), lengths.numpy()


GREEDY = dict(temperature=0.0, cfg_weight=0.6, repetition_penalty=1.35)


def _replay_up_to_ties(jrt, prt, texts, tokens, n_steps):
    """JAX and the port teacher-forced on ``tokens`` for ``n_steps`` steps,
    the port's step run from JAX's cache each time (the int8 bytes and
    scales, as JAX's step leaves them): every logit row of every step
    within 2e-3 + 2e-3·|ref| of JAX's, or a shown int8 activation tie
    (``_int8_ties.assert_step_rows_up_to_ties``). Returns (step, row,
    ratio, rounding call, element, ulps from the tie, ratio once flipped)
    for each row that needed a tie."""
    from _int8_ties import assert_step_rows_up_to_ties
    from vocalie_tts_tpu.models.common import transformer as jtr
    from vocalie_tts_tpu_torch.models.common import transformer as ptr

    kw = dict(mode="fr_finetune", lang="fr", exaggeration=0.5, cfg_weight=GREEDY["cfg_weight"])
    t3, embeds, lens, (_, _, _, cache_len) = jrt._prepare_batch(texts, voice_ref_path=None, **kw)
    _, jc = jtr.prefill(t3["lm"], jrt.cfg.lm, jnp.zeros(embeds.shape[:2], jnp.int32), lens,
                        inputs_embeds=embeds, cache_len=cache_len)
    pt3, pembeds, plens, _ = prt._prepare_batch(texts, **kw)
    _, pc = ptr.prefill(pt3["lm"], prt.cfg.lm, None, plens, inputs_embeds=pembeds,
                        cache_len=cache_len)
    step = jax.jit(lambda p, t, c: jtr.decode_step(p, jrt.cfg.lm, t, c))
    d = pc.k.shape[-1]

    def port_step(jcache, tok):
        jk = np.asarray(jcache.k)
        for name, val in (("k", jk[..., :d]), ("v", jk[..., d:] if jcache.v is None
                                                   else np.asarray(jcache.v))):
            getattr(pc, name).copy_(torch.from_numpy(np.array(val)))
            getattr(pc, name + "_scale").copy_(torch.from_numpy(np.array(
                getattr(jcache, name + "_scale").astype(jnp.float32))).to(torch.bfloat16))
        pc.n_decoded = int(jcache.n_decoded)
        return ptr.decode_step(pt3["lm"], prt.cfg.lm, torch.from_numpy(tok).long(), pc)[0].numpy()

    tok = np.full((2 * tokens.shape[0],), jrt.cfg.bos_speech, np.int32)
    ties = []
    for i in range(n_steps):
        before = jc
        ref, jc = step(t3["lm"], jnp.asarray(tok), jc)
        ties += [(i, *t) for t in assert_step_rows_up_to_ties(
            lambda: port_step(before, tok), np.asarray(ref), f"step {i}")]
        tok = np.concatenate([tokens[:, i], tokens[:, i]])
    return ties


@pytest.fixture(scope="module")
def greedy(runtimes):
    """Both sides' greedy tokens and lengths, and ``flips``: row → the
    first step where the port's token differs from JAX's."""
    jrt, prt, _ = runtimes
    jt, jl = _jax_generate(jrt, _texts(), **GREEDY)
    pt, pl = _port_generate(prt, _texts(), **GREEDY)
    flips = {r: int(np.argmax(jt[r] != pt[r])) for r in range(jt.shape[0])
             if (jt[r] != pt[r]).any()}
    return jt, jl, pt, pl, flips


def test_greedy_tokens_match(runtimes, greedy):
    jrt, prt, _ = runtimes
    jt, jl, pt, pl, flips = greedy
    assert (jl > 0).all()
    if not prt.cfg.lm.dense_kernel:
        assert not flips, f"tokens differ from JAX's at (row, step) {flips}"
    if flips:
        # the port computes JAX's step from JAX's state at every step up to
        # the last flip (up to shown int8 ties): its greedy tokens leave
        # JAX's only where such ties, in the step or in the bytes they leave
        # in the cache, add up over the free-running steps
        _replay_up_to_ties(jrt, prt, _texts(), jt, max(flips.values()) + 1)
    for r in range(jt.shape[0]):
        s = flips.get(r, jt.shape[1])
        np.testing.assert_array_equal(pt[r, :s], jt[r, :s], err_msg=f"row {r}")
        if r not in flips:
            assert pl[r] == jl[r], f"row {r}"


def jax_stage2_noise(cfg, key, b, n_tok):
    """Stage2Noise with the draws the JAX stage 2 makes from ``key``."""
    from vocalie_tts_tpu_torch.models.common.token2wav import Stage2Noise

    t2w = cfg.t2w
    r1, r2 = jax.random.split(key)
    frames = n_tok * t2w.token_mel_ratio
    r2, k1 = jax.random.split(r2)
    h1 = t2w.hift.nb_harmonics + 1
    return Stage2Noise(
        z=torch.from_numpy(np.array(jax.random.normal(r1, (b, frames, t2w.n_mels), jnp.float32))),
        rand_ini=torch.from_numpy(np.array(jax.random.uniform(k1, (b, h1)))),
        source_normal=torch.from_numpy(np.array(
            jax.random.normal(r2, (b, frames * t2w.hift.hop, h1)))),
    )


def test_stage2_pcm_on_jax_tokens(runtimes, greedy):
    jrt, prt, _ = runtimes
    toks, lens = greedy[:2]
    key = jax.random.PRNGKey(5)
    b = toks.shape[0]
    ref = np.asarray(jrt._stage2(jrt.params["decoder"], tokens=jnp.asarray(toks),
                                 tok_lengths=jnp.asarray(lens),
                                 xvec_emb=jnp.zeros((b, 192), jnp.float32), rng=key))
    out = prt.stage2_pcm16(torch.from_numpy(toks.copy()), torch.from_numpy(lens.copy()),
                           jax_stage2_noise(jrt.cfg, key, b, toks.shape[1])).numpy()
    assert out.dtype == ref.dtype == np.int16 and out.shape == ref.shape
    assert np.abs(out.astype(np.int32) - ref.astype(np.int32)).max() <= 33


def test_run_tts_pipeline_matches(runtimes, greedy, tmp_path):
    from vocalie_tts_tpu.engines import get_backend
    from vocalie_tts_tpu.io.wavio import read_wav
    from vocalie_tts_tpu.pipeline import run_tts_pipeline as jax_pipeline
    from vocalie_tts_tpu.text import parse_manual_chunks as jax_chunks
    from vocalie_tts_tpu_torch.engines.chatterbox import ChatterboxEngine
    from vocalie_tts_tpu_torch.pipeline import run_tts_pipeline
    from vocalie_tts_tpu_torch.text import parse_manual_chunks

    jrt, prt, _ = runtimes
    base = {
        "tts_backend": "chatterbox",
        "script": SCRIPT,
        "engine_params": {"chatterbox_mode": "fr_finetune", "temperature": 0.0,
                          "cfg_weight": 0.6, "repetition_penalty": 1.35},
        "inter_chunk_gap_ms": 250,
        "target_sr": 24000,
    }
    jax_engine = get_backend("chatterbox")
    jax_engine.release_runtime()
    try:
        jax_engine._runtime = jrt
        jres = jax_pipeline({**base, "chunks": jax_chunks(SCRIPT)[0],
                             "out_path": str(tmp_path / "jax.wav")})
    finally:
        jax_engine.release_runtime()
    engine = ChatterboxEngine(device="cpu")
    engine._runtime = prt
    pres = run_tts_pipeline({**base, "chunks": parse_manual_chunks(SCRIPT)[0],
                             "out_path": str(tmp_path / "port.wav")}, engine=engine)

    jm, pm = jres.meta, pres.meta
    assert pm["chunks"] == jm["chunks"] == 3
    assert pm.keys() == jm.keys()
    # a chunk whose greedy tokens left JAX's at a shown near-tie
    # (test_greedy_tokens_match) may end at another length
    flipped = set(greedy[4])
    assert [d for i, d in enumerate(pm["durations"]) if i not in flipped] == \
        [d for i, d in enumerate(jm["durations"]) if i not in flipped]
    same_length = not flipped & set(range(pm["chunks"]))
    if same_length:
        assert pm["total_duration"] == jm["total_duration"]
    for key in ("retries", "sr", "inter_chunk_gap_ms", "inter_chunk_gap_applied",
                "backend_id", "num_subunits"):
        assert pm[key] == jm[key], key
    # backend_meta is the last chunk's: its token count follows its tokens
    drop = {"elapsed_ms_batch"} | ({"speech_tokens"} if pm["chunks"] - 1 in flipped else set())
    assert ({k: v for k, v in pm["backend_meta"].items() if k not in drop}
            == {k: v for k, v in jm["backend_meta"].items() if k not in drop})
    assert pm["perf"].keys() == jm["perf"].keys()
    jwav, jsr = read_wav(jres.out_path)
    pwav, psr = read_wav(pres.out_path)
    assert psr == jsr == 24000 and len(pwav) == round(pm["total_duration"] * 24000)
    if same_length:
        assert len(pwav) == len(jwav)
    assert np.isfinite(pwav).all()
