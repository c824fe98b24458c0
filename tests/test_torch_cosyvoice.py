"""The CosyVoice-class slice against the JAX ``CosyVoiceRuntime``, on the
same weights (saved once by the JAX package in its ``.npz`` format, with
non-zero q/k/v biases set from a numpy seed, and loaded by both), under the
int8 serving env (``VOCALIE_KV_INT8=1 VOCALIE_WEIGHT_INT8=1``), at two
widths:

- ``tiny``: the ``tiny`` scale (d_model 64, GQA 4:2): the dense kernels are
  not eligible, both packages take ``_qdot``;
- ``mha256``: ``tiny`` widened (test side only, in both packages'
  ``SCALES``) to d_model 256, 4 heads = kv heads, d_ff 512: offline batches
  take B3 + B2 per layer, batch-1 streaming takes B3 + the whole-step
  kernel B7 (interpret mode in JAX, the plain versions here).

Checks, on the short text "Bonjour à tous." (decode bucket 64, windows
[8, 48, 8]), decoded greedily (temperature 0):
- offline tokens and lengths equal to JAX's; where the port's argmax leaves
  JAX's, JAX replayed teacher-forced must show the port's pick within the
  logit tolerance (2e-3 + 2e-3·|max|) of its top logit at that step (the
  ``tests/test_torch_slice.py`` near-tie rule), and tokens are compared up
  to that step;
- streaming: per-window tokens and valid counts equal to JAX's (same rule),
  with JAX's per-window CFM noise handed to the port; PCM packets within
  33 LSB of int16 (1e-3 of full scale, the stage-2 tolerance);
- ``stream_window_schedule`` equal to JAX's; ``run_tts_pipeline`` with
  ``tts_backend: "cosyvoice"``: chunk count, durations, WAV length and meta
  keys agree.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

TEXT = "Bonjour à tous."
TEXTS = [TEXT, "Un essai rapide."]
INSTRUCT = "Parle clairement."
ENV = {
    "VOCALIE_MODEL_SCALE": "tiny",
    "VOCALIE_KV_INT8": "1",
    "VOCALIE_WEIGHT_INT8": "1",
    "VOCALIE_ALLOW_RANDOM_WEIGHTS": "1",
}
WIDE = dict(d_model=256, n_heads=4, n_kv_heads=4, d_ff=512)
TOL = lambda top: 2e-3 + 2e-3 * abs(top)  # noqa: E731


_DECODER = {}


def _jax_decoder(cfg):
    """JAX's stage-2 params (flow, HiFT, speaker encoder), made once for
    both widths (they do not depend on the LM's), in one jitted call: the
    eager init compiles op by op and took most of this file's time."""
    from vocalie_tts_tpu.models.cosyvoice.model import init_cfm_decoder

    if not _DECODER:
        _DECODER["dec"] = jax.device_get(
            jax.jit(lambda k: init_cfm_decoder(k, cfg))(jax.random.PRNGKey(2)))
    return _DECODER["dec"]


@pytest.fixture(scope="module", params=["tiny", "mha256"])
def runtimes(request, tmp_path_factory):
    from vocalie_tts_tpu.models.common.weights import save_params
    from vocalie_tts_tpu.models.cosyvoice.model import init_cosyvoice_lm
    from vocalie_tts_tpu.models.cosyvoice.runtime import SCALES as JAX_SCALES
    from vocalie_tts_tpu.models.cosyvoice.runtime import CosyVoiceRuntime as JaxRuntime
    from vocalie_tts_tpu_torch.models.cosyvoice.runtime import SCALES, CosyVoiceRuntime

    assets = tmp_path_factory.mktemp("assets")
    with pytest.MonkeyPatch.context() as mp:
        for k in ("VOCALIE_DENSE_KERNEL", "VOCALIE_FUSED_STEP", "VOCALIE_MEGATAIL"):
            mp.delenv(k, raising=False)
        for k, v in ENV.items():
            mp.setenv(k, v)
        mp.setenv("VOCALIE_ASSETS_DIR", str(assets))
        if request.param == "mha256":
            mp.setitem(JAX_SCALES, "tiny", dataclasses.replace(JAX_SCALES["tiny"], **WIDE))
            mp.setitem(SCALES, "tiny", dataclasses.replace(SCALES["tiny"], **WIDE))
        cfg = JAX_SCALES["tiny"]
        lm = jax.device_get(jax.jit(lambda k: init_cosyvoice_lm(k, cfg))(jax.random.PRNGKey(1)))
        rng = np.random.default_rng(4)
        layers = dict(lm["lm"]["layers"])
        for name in ("bq", "bk", "bv"):
            layers[name] = (0.3 * rng.standard_normal(layers[name].shape)).astype(np.float32)
        lm = {**lm, "lm": {**lm["lm"], "layers": layers}}
        wdir = assets / "cosyvoice" / "weights"
        save_params(wdir, "lm", lm, meta={"family": "cosyvoice", "text_vocab": cfg.text_vocab,
                                          "speech_vocab": cfg.speech_vocab})
        dec = _jax_decoder(cfg)
        save_params(wdir, "flow", dec, meta={"family": "cosyvoice", "stage": "flow+hift"})
        jrt = JaxRuntime.create(assets / "cosyvoice")
        prt = CosyVoiceRuntime.create(assets / "cosyvoice", device="cpu")
        assert float(np.abs(np.asarray(prt.params["lm_bundle"]["lm"]["layers"]["bqkv"])).max()) > 0
        wide = request.param == "mha256"
        assert jrt.cfg.lm.dense_kernel and prt.cfg.lm.dense_kernel
        assert ("wqkv_h" in jrt.params["lm_bundle"]["lm"]["layers"]) is wide
        yield jrt, prt, wide, (lm, dec)


def _jax_replay(jrt, embeds, lengths, cache_len, tokens, n_steps):
    """JAX's biased logits at steps 0..n_steps-1 of the prompt ``embeds``,
    fed ``tokens`` [b, n] (teacher forcing) → [n_steps, b, vocab]."""
    from vocalie_tts_tpu.models.common import transformer as jt
    from vocalie_tts_tpu.models.cosyvoice.model import speech_logit_bias

    cfg = jrt.cfg
    lm = jrt.params["lm_bundle"]["lm"]
    _, cache = jt.prefill(lm, cfg.lm, jnp.zeros(embeds.shape[:2], jnp.int32), lengths,
                          inputs_embeds=embeds, cache_len=cache_len)
    step = jax.jit(lambda p, t, c: jt.decode_step(p, cfg.lm, t, c))
    bias = speech_logit_bias(cfg)[None]
    tok = np.full((tokens.shape[0],), cfg.bos_speech, np.int32)
    out = []
    for i in range(n_steps):
        logits, cache = step(lm, jnp.asarray(tok), cache)
        out.append(np.asarray(logits + bias))
        tok = tokens[:, i]
    return np.stack(out)


def _agreed_prefix(jrt, jt, pt, replay):
    """Steps (per row) up to which the port's greedy tokens must equal
    JAX's: the first step where they differ must be a shown near-tie."""
    flips = {r: int(np.argmax(jt[r] != pt[r])) for r in range(jt.shape[0])
             if (jt[r] != pt[r]).any()}
    if flips:
        ref = replay(max(flips.values()) + 1)
        for r, s in flips.items():
            a = ref[s, r]
            assert a[pt[r, s]] >= a.max() - TOL(a.max()), (
                f"row {r} step {s}: the port picked {pt[r, s]} ({a[pt[r, s]]}), JAX "
                f"{jt[r, s]} ({a.max()})")
    return flips


def _jax_prompt(jrt, texts, batch_buckets):
    from vocalie_tts_tpu.models.common.ar_runtime import pad_token_batch
    from vocalie_tts_tpu.models.cosyvoice.model import build_prompt_embeds
    from vocalie_tts_tpu.models.cosyvoice.runtime import PROMPT_BUCKETS
    from vocalie_tts_tpu.text.frontend import build_prompt_ids

    seqs = [build_prompt_ids(jrt._frontend, t, preamble=INSTRUCT) for t in texts]
    tokens, lengths, pb, bb = pad_token_batch(seqs, prompt_buckets=PROMPT_BUCKETS,
                                              batch_buckets=batch_buckets, extra_positions=2)
    embeds = build_prompt_embeds(jrt.params["lm_bundle"], jrt.cfg, jnp.asarray(tokens),
                                 jnp.zeros((bb, jrt.cfg.speaker_dim), jnp.float32))
    return embeds, jnp.asarray(lengths), pb


@pytest.fixture(scope="module")
def greedy(runtimes):
    """Both sides' offline greedy tokens and lengths for ``TEXTS``, the
    meta, and ``flips``: row → the first step where the port's token
    leaves JAX's (each shown to be a near-tie)."""
    from vocalie_tts_tpu.models.cosyvoice.runtime import BATCH_BUCKETS

    jrt, prt, *_ = runtimes
    kw = dict(mode="instruct", instruct_text=INSTRUCT, temperature=0.0, top_k=50)
    jtok, jlen, _, jmeta = jrt._lm_tokens(TEXTS, **kw)
    ptok, plen, _, pmeta = prt._lm_tokens(TEXTS, **kw)
    jtok, jlen, ptok, plen = (np.asarray(a) for a in (jtok, jlen, ptok, plen))

    def replay(n):
        embeds, lengths, pb = _jax_prompt(jrt, TEXTS, BATCH_BUCKETS)
        return _jax_replay(jrt, embeds, lengths, pb + 64 + (-(pb + 64)) % 128, jtok, n)

    return jtok, jlen, ptok, plen, (jmeta, pmeta), _agreed_prefix(jrt, jtok, ptok, replay)


def test_offline_greedy_tokens_match(greedy):
    jtok, jlen, ptok, plen, (jmeta, pmeta), flips = greedy
    assert pmeta == jmeta and pmeta["decode_bucket"] == 64
    assert ptok.shape == jtok.shape and (jlen > 0).all()
    for r in range(jtok.shape[0]):
        s = flips.get(r, jtok.shape[1])
        np.testing.assert_array_equal(ptok[r, :s], jtok[r, :s], err_msg=f"row {r}")
        if r not in flips:
            assert plen[r] == jlen[r], f"row {r}"


def _jax_window_noise(cfg, key, schedule):
    """The CFM start noise JAX's fused window chain draws from ``key``,
    window by window (``split(rng, 3)``: next, sampling, CFM)."""
    from vocalie_tts_tpu_torch.models.common.token2wav import Stage2Noise

    t2w = cfg.t2w
    out = []
    for w in schedule:
        key, _sub, sub2 = jax.random.split(key, 3)
        z = jax.random.normal(sub2, (1, w * t2w.token_mel_ratio, t2w.n_mels), jnp.float32)
        out.append(Stage2Noise(z=torch.from_numpy(np.array(z))))
    return out


def test_streaming_windows_match(runtimes, monkeypatch):
    """Per-window greedy tokens, valid counts and int16 PCM of
    ``synthesize_streaming`` (instruct mode): JAX's fused window chain and
    the port's window decode + stage 2, on JAX's noise."""
    from vocalie_tts_tpu.models.cosyvoice import runtime as jrt_mod

    jrt, prt, wide, _ = runtimes
    schedule = jrt_mod.stream_window_schedule(64)
    assert schedule == [8, 48, 8]
    key = jax.random.PRNGKey(7)
    jrt._rng = key
    kw = dict(mode="instruct", instruct_text=INSTRUCT, temperature=0.0)
    # JAX's window tokens, read out of its fused chain as it runs: the
    # chain looks up ``_stream_window`` when it is traced (first use here)
    jwin = []
    real_window = jrt._stream_window

    def recording_window(*a, **k):
        out = real_window(*a, **k)
        jax.debug.callback(lambda t, n: jwin.append((np.asarray(t)[0], int(n[0]))),
                           out[0], out[1], ordered=True)
        return out

    monkeypatch.setattr(jrt, "_stream_window", recording_window)
    jpackets = [p for p, _sr in jrt.synthesize_streaming(TEXT, **kw)]
    jax.effects_barrier()
    assert len(jwin) >= len(jpackets) >= 1   # windows queued ahead run too
    embeds, lengths, pb = _jax_prompt(jrt, [TEXT], (1,))
    cache_len = pb + 64 + (-(pb + 64)) % 128

    noise = iter(_jax_window_noise(jrt.cfg, key, schedule))
    monkeypatch.setattr(prt, "_stage2_noise", lambda b, n: next(noise))
    pwin = []
    real_stage2 = prt.stage2_pcm16
    monkeypatch.setattr(prt, "stage2_pcm16", lambda toks, n_valid, *a: pwin.append(
        (toks.numpy()[0], int(n_valid[0]))) or real_stage2(toks, n_valid, *a))
    calls = []
    if wide:
        from vocalie_tts_tpu_torch.models.common import transformer as pt

        real_b7 = pt.decode_step_fused_packed
        monkeypatch.setattr(pt, "decode_step_fused_packed",
                            lambda *a, **k: calls.append(1) or real_b7(*a, **k))
    ppackets = [p for p, _sr in prt.synthesize_streaming(TEXT, **kw)]
    if wide:
        assert len(calls) == sum(schedule[: len(pwin)])   # B7 on every streamed step

    jt = np.concatenate([t for t, _ in jwin])[None]
    pt_ = np.concatenate([t for t, _ in pwin])[None]
    n = min(jt.shape[1], pt_.shape[1])

    def replay(k):
        return _jax_replay(jrt, embeds, lengths, cache_len, jt, k)

    flips = _agreed_prefix(jrt, jt[:, :n], pt_[:, :n], replay)
    stop = flips.get(0, n)
    ends = np.cumsum(schedule)
    whole = int(np.searchsorted(ends, stop, side="right"))   # windows before any flip
    for i in range(min(whole, len(pwin))):
        np.testing.assert_array_equal(pwin[i][0], jwin[i][0], err_msg=f"window {i}")
        assert pwin[i][1] == jwin[i][1], f"window {i}"
    if not flips:
        assert len(ppackets) == len(jpackets) >= 1
    for i, (p, j) in enumerate(zip(ppackets[:whole], jpackets[:whole])):
        assert p.shape == j.shape, f"packet {i}"
        lsb = np.abs(np.round(p * 32767).astype(np.int32) - np.round(j * 32767).astype(np.int32))
        assert lsb.max() <= 33, f"packet {i}: {lsb.max()} LSB"


@pytest.mark.parametrize("bucket", [64, 128, 256, 320])
def test_stream_window_schedule_matches(bucket):
    from vocalie_tts_tpu.models.cosyvoice.runtime import stream_window_schedule as jax_sched
    from vocalie_tts_tpu_torch.models.cosyvoice.runtime import stream_window_schedule

    assert stream_window_schedule(bucket) == jax_sched(bucket)
    assert sum(stream_window_schedule(bucket)) == bucket


def test_run_tts_pipeline_matches(runtimes, greedy, monkeypatch, tmp_path):
    """``run_tts_pipeline`` with ``tts_backend: "cosyvoice"`` in both
    packages, the runtimes decoding greedily (the engines pass no
    temperature: the runtimes' default is wrapped)."""
    from vocalie_tts_tpu.engines import get_backend
    from vocalie_tts_tpu.io.wavio import read_wav
    from vocalie_tts_tpu.pipeline import run_tts_pipeline as jax_pipeline
    from vocalie_tts_tpu.text import parse_manual_chunks as jax_chunks
    from vocalie_tts_tpu_torch.engines import ENGINES
    from vocalie_tts_tpu_torch.engines.cosyvoice import CosyVoiceEngine
    from vocalie_tts_tpu_torch.pipeline import run_tts_pipeline
    from vocalie_tts_tpu_torch.text import parse_manual_chunks

    jrt, prt, *_ = runtimes
    assert ENGINES["cosyvoice"] is CosyVoiceEngine
    script = "\n[[CHUNK]]\n".join(TEXTS)
    base = {"tts_backend": "cosyvoice", "script": script, "inter_chunk_gap_ms": 250,
            "target_sr": 24000,
            "engine_params": {"engine_id": "cosyvoice_instruct", "instruct_text": INSTRUCT}}
    for rt in (jrt, prt):
        monkeypatch.setattr(rt, "synthesize_batch",
                            functools.partial(rt.synthesize_batch, temperature=0.0))
    jax_engine = get_backend("cosyvoice")
    jax_engine.release_runtime()
    try:
        jax_engine._runtime = jrt
        jres = jax_pipeline({**base, "chunks": jax_chunks(script)[0],
                             "out_path": str(tmp_path / "jax.wav")})
    finally:
        jax_engine.release_runtime()
    engine = CosyVoiceEngine(device="cpu")
    engine._runtime = prt
    pres = run_tts_pipeline({**base, "chunks": parse_manual_chunks(script)[0],
                             "out_path": str(tmp_path / "port.wav")}, engine=engine)
    jm, pm = jres.meta, pres.meta
    assert pm["chunks"] == jm["chunks"] == 2
    assert pm.keys() == jm.keys()
    for key in ("sr", "inter_chunk_gap_ms", "inter_chunk_gap_applied", "backend_id",
                "num_subunits", "retries"):
        assert pm[key] == jm[key], key
    flipped = set(greedy[5])   # a chunk that left JAX's tokens at a near-tie
    assert [d for i, d in enumerate(pm["durations"]) if i not in flipped] == \
        [d for i, d in enumerate(jm["durations"]) if i not in flipped]
    drop = {"elapsed_ms", "speech_tokens"} if flipped else {"elapsed_ms"}
    assert ({k: v for k, v in pm["backend_meta"].items() if k not in drop}
            == {k: v for k, v in jm["backend_meta"].items() if k not in drop})
    pwav, psr = read_wav(pres.out_path)
    jwav, jsr = read_wav(jres.out_path)
    assert psr == jsr == 24000 and len(pwav) == round(pm["total_duration"] * 24000)
    assert np.isfinite(pwav).all()
    if not flipped:
        assert len(pwav) == len(jwav)


def test_engine_surface_matches(runtimes):
    """The engine's maps, presets, variants and capabilities equal the JAX
    engine's; clone and cross-lingual without a reference raise its errors;
    a reference raises ``NotImplementedError`` (no speaker encoder yet)."""
    from vocalie_tts_tpu.engines import cosyvoice as jeng
    from vocalie_tts_tpu_torch.engines import cosyvoice as peng

    assert peng.COSYVOICE_LANGUAGE_MAP == jeng.COSYVOICE_LANGUAGE_MAP
    assert peng.INSTRUCT_CHOICES == jeng.INSTRUCT_CHOICES
    assert peng.COSYVOICE_DEFAULT_MODELS == jeng.COSYVOICE_DEFAULT_MODELS
    assert peng.CosyVoiceEngine.engine_variants() == jeng.CosyVoiceEngine.engine_variants()
    jax_engine, engine = jeng.CosyVoiceEngine(), peng.CosyVoiceEngine(device="cpu")
    for eid in (None, "cosyvoice_instruct", "cosyvoice_clone", "cosyvoice_cross"):
        assert engine.capabilities(eid) == jax_engine.capabilities(eid), eid
    for bcp47 in (None, "fr-FR", "en-US", "xx-YY"):
        assert engine.map_language(bcp47) == jax_engine.map_language(bcp47)
    engine._runtime = runtimes[1]
    for eid, match in (("cosyvoice_clone", "clone requiert"), ("cosyvoice_cross", "cross-lingual")):
        with pytest.raises(peng.EngineUnavailableError, match=match):
            engine.synthesize_batch([TEXT], engine_id=eid)
        with pytest.raises(peng.EngineUnavailableError):
            next(engine.synthesize_stream(TEXT, engine_id=eid))
    with pytest.raises(NotImplementedError, match="speaker encoders"):
        engine.synthesize_batch([TEXT], engine_id="cosyvoice_clone", voice_ref_path="ref.wav")


def test_bridge_bundle_matches_loaded_weights(runtimes):
    """``bridge.cosyvoice_bundle`` of the JAX trees equals what the port's
    runtime loaded from the JAX checkpoint: the text and speaker tables and
    stage 2 as they are, the LM (with its q/k/v biases) after the runtime's
    int8 quantization and fusion."""
    from vocalie_tts_tpu_torch.bridge import cosyvoice_bundle
    from vocalie_tts_tpu_torch.models.common.ar_runtime import maybe_quantize_lm

    _, prt, _, (lm, dec) = runtimes
    bridged = cosyvoice_bundle(lm, dec)
    assert "speaker" not in bridged["decoder"]
    want = {"lm_bundle": maybe_quantize_lm(bridged["lm_bundle"]), "decoder": bridged["decoder"]}

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}/{i}")
        else:
            yield prefix, tree

    got = dict(leaves(prt.params))
    ref = dict(leaves(want))
    assert got.keys() == ref.keys() and "/lm_bundle/lm/layers/bqkv" in got
    for key, r in ref.items():
        assert got[key].dtype == r.dtype and torch.equal(got[key], r), key
