"""The port's VITS (Piper) slice against the JAX package, on the CPU, at the
tiny scale (``SCALES["tiny"]`` of both runtimes: d_model 32, 2 layers, 2
coupling and 2 dp flows, a 64-channel vocoder).

The JAX init leaves the dp flows' ``proj``, the couplings' ``post`` and the
affine ``m``/``logs`` at zero, so the spline and every coupling would be
identities. The tree here is drawn with numpy from a seed for every leaf,
those included (the dp flows' ``proj`` scaled so that the spline's bins
are uneven), in the shapes of ``jax.eval_shape(init_vits)``, and bridged
by ``bridge.vits_params``. JAX's side runs jitted (its serving form), each
stage through the JAX runtime's own two programs where it can.

- ``_rqs_inverse`` alone, inputs past ±``dp_tail_bound`` passed through;
  the pad-reshape relative-position tricks; encoder stats at phone lengths
  below, at and above ``rel_window + 1``; ``duration_log_w`` on noise with
  inputs past the tail bound; ``_flow_inverse``; stage A
  (``encode_and_durations``) on JAX's noise; stage B (``decode_frames``) on
  JAX's ``eps``, with and without a speaker. Stats and log-durations within
  1e-4 + 1e-4·|ref|, durations equal except ceil ties (``exp(logw) ·
  length_scale`` within 1e-5 relative of an integer), audio within 1e-3 of
  the peak, sample lengths exact.
- The vocoder's ``cond`` and ``stage_conds`` against JAX's
  ``apply_vocoder``.
- ``VITSRuntime.synthesize_batch`` against JAX's at ``noise_w = noise_scale
  = 0`` for 1 and 3 texts: buckets and lengths exact, audio within 1e-3 of
  the peak, the same meta keys; the engine and ``run_tts_pipeline`` with
  ``tts_backend: "piper"``.
- Weights: a JAX ``save_params`` bundle (and a staged id map) loaded by the
  port's ``VITSRuntime.create``, and the port's ``save_weights`` read back
  by both packages.

The port's side runs on one torch thread (a fixture).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.models.vits import model as jm
from vocalie_tts_tpu.models.vits import runtime as jr
from vocalie_tts_tpu_torch.bridge import tree_to_torch, vits_params
from vocalie_tts_tpu_torch.models.common.weights import tree_items
from vocalie_tts_tpu_torch.models.vits import model as pm
from vocalie_tts_tpu_torch.models.vits import runtime as pr

pytestmark = pytest.mark.device

JCFG = jr.SCALES["tiny"]
PCFG = pr.SCALES["tiny"]
TEXTS = ["Bonjour à tous, voici un essai.", "Un deuxième texte, un peu plus long que le premier.",
         "Trois."]


def _close(got, ref, what, rel=1e-4, abs_=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bad = np.abs(got - ref) > abs_ + rel * np.abs(ref)
    assert not bad.any(), (what, int(bad.sum()), float(np.abs(got - ref).max()))


def _audio_close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    peak = np.abs(ref).max()
    assert peak > 1e-3, (what, "silent reference")
    assert np.abs(got - ref).max() <= 1e-3 * peak, (what, np.abs(got - ref).max() / peak)


def _draw(path, shape, rng):
    """A leaf of ``init_vits``'s tree, drawn with numpy by its role."""
    name = path[-1]
    if name == "g":
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if name in ("b", "m", "logs"):
        return 0.1 * rng.standard_normal(shape)
    if name == "w":
        k_cin = int(np.prod(shape[:-1]))
        scale = 1.0 / np.sqrt(k_cin)
        if path[-2] == "proj" and "flows" in path:
            scale *= 10.0     # uneven spline bins: |uw|, |uh| ~ 1
        return rng.uniform(-scale, scale, shape)
    if name == "emb_g":
        return 0.5 * rng.standard_normal(shape)
    return rng.standard_normal(shape) / np.sqrt(shape[-1])   # emb, emb_rel_k/v


def _numpy_tree(cfg, seed):
    shapes = jax.eval_shape(lambda k: jm.init_vits(k, cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        return _draw(path, node.shape, rng).astype(np.float32)

    return walk(shapes, ())


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs tiny tensors: one intra-op thread is as fast
    here, and it keeps the suite's parallel workers from oversubscribing the
    CPU with spinning thread pools (8 threads took 11 s for a call that one
    thread makes in 0.35 s beside another test run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    assert dataclasses.asdict(JCFG).keys() == dataclasses.asdict(PCFG).keys()
    for f in dataclasses.fields(PCFG):
        if f.name != "dtype":
            assert getattr(JCFG, f.name) == getattr(PCFG, f.name), f.name
    return _numpy_tree(JCFG, 7)


@pytest.fixture(scope="module")
def params(tree):
    return vits_params(tree)


@pytest.fixture(scope="module")
def jrt(tree, tmp_path_factory):
    """The JAX runtime on the numpy tree: its two jitted stages serve every
    stage-level comparison of this file."""
    return jr.VITSRuntime(jax.tree_util.tree_map(jnp.asarray, tree), JCFG,
                          tmp_path_factory.mktemp("jax_vits"))


@pytest.fixture(scope="module")
def prt(params, tmp_path_factory):
    return pr.VITSRuntime(params, PCFG, tmp_path_factory.mktemp("port_vits") / "weights",
                          torch.device("cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))


# ── the model's pieces ──────────────────────────────────────────────────


def test_rqs_inverse_alone():
    rng = np.random.default_rng(1)
    bins, tb = JCFG.dp_bins, JCFG.dp_tail_bound
    x = rng.uniform(-8.0, 8.0, (3, 41)).astype(np.float32)
    x[0, :4] = [-tb, tb, -tb - 1e-3, tb + 1e-3]
    uw = (1.5 * rng.standard_normal((3, 41, bins))).astype(np.float32)
    uh = (1.5 * rng.standard_normal((3, 41, bins))).astype(np.float32)
    ud = rng.standard_normal((3, 41, bins - 1)).astype(np.float32)
    ref = np.asarray(jax.jit(jm._rqs_inverse, static_argnums=4)(x, uw, uh, ud, tb))
    got = pm._rqs_inverse(_t(x), _t(uw), _t(uh), _t(ud), tb).numpy()
    _close(got, ref, "rqs")
    outside = np.abs(x) > tb
    assert outside.sum() >= 20
    assert np.array_equal(got[outside], x[outside])
    assert np.abs(got - x)[~outside].max() > 0.5      # the spline moves its inputs


def test_relative_position_tricks():
    rng = np.random.default_rng(2)
    for t in (3, 5, 12):
        rel = rng.standard_normal((2, 2, t, 2 * t - 1)).astype(np.float32)
        ab = rng.standard_normal((2, 2, t, t)).astype(np.float32)
        assert np.array_equal(pm._relative_to_absolute(_t(rel)).numpy(),
                              np.asarray(jm._relative_to_absolute(rel)))
        assert np.array_equal(pm._absolute_to_relative(_t(ab)).numpy(),
                              np.asarray(jm._absolute_to_relative(ab)))
        emb = rng.standard_normal((2 * JCFG.rel_window + 1, 16)).astype(np.float32)
        assert np.array_equal(pm._get_relative_embeddings(_t(emb), t, JCFG.rel_window).numpy(),
                              np.asarray(jm._get_relative_embeddings(emb, t, JCFG.rel_window)))


@pytest.mark.parametrize("t", [3, 5, 12], ids=["below", "at", "above"])
def test_encoder_stats_by_length(tree, params, t):
    """``t`` below, at and above ``rel_window + 1`` = 5: the relative
    embeddings sliced, taken whole and padded."""
    assert JCFG.rel_window + 1 == 5
    rng = np.random.default_rng(t)
    phones = rng.integers(1, JCFG.n_phones, (2, t)).astype(np.int32)
    mask = (np.arange(t)[None] < np.array([t, max(t - 2, 1)])[:, None]).astype(np.float32)

    def stats(p, ph, m):
        x = jm._encoder(p, JCFG, ph, m)
        return jm.conv1d(p["proj"], x) * m[..., None]

    ref = np.asarray(jax.jit(stats)(tree, phones, mask))
    x = pm._encoder(params, PCFG, _t(phones).long(), _t(mask))
    got = (pm.conv1d(params["proj"], x) * _t(mask)[..., None]).numpy()
    _close(got, ref, f"stats t={t}")


def test_duration_log_w_past_the_tail_bound(tree, params):
    rng = np.random.default_rng(3)
    b, t = 2, 12
    x = rng.standard_normal((b, t, JCFG.d_model)).astype(np.float32)
    mask = (np.arange(t)[None] < np.array([t, 7])[:, None]).astype(np.float32)
    g = np.broadcast_to(tree["emb_g"][np.array([1, 2])][:, None, :],
                        (b, t, JCFG.speaker_dim)).astype(np.float32)
    noise = (2.5 * rng.standard_normal((b, t, 2))).astype(np.float32)
    # the first flow's spline input is the noise's channel 0 (after a Flip)
    assert (np.abs(noise[..., 0]) * mask > JCFG.dp_tail_bound).any()
    fn = jax.jit(lambda p, x, m, g, n: jm.duration_log_w(p, JCFG, x, m, g, None, 0.0, noise=n))
    ref = np.asarray(fn(tree, x, mask, g, noise))
    got = pm.duration_log_w(params, PCFG, _t(x), _t(mask), _t(g), _t(noise)).numpy()
    _close(got, ref, "logw")
    assert np.abs(ref).max() > 0.1


def test_flow_inverse(tree, params):
    rng = np.random.default_rng(4)
    b, f = 2, 20
    z = rng.standard_normal((b, f, JCFG.latent_dim)).astype(np.float32)
    mask = (np.arange(f)[None] < np.array([f, 13])[:, None]).astype(np.float32)
    g = np.broadcast_to(tree["emb_g"][np.array([0, 3])][:, None, :],
                        (b, f, JCFG.speaker_dim)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, z, m, g: jm._flow_inverse(p, JCFG, z, m, g))(
        tree, z, mask, g))
    got = pm._flow_inverse(params, PCFG, _t(z), _t(mask), _t(g)).numpy()
    _close(got, ref, "flow")
    assert np.abs(ref - z).max() > 0.1                  # the couplings move the latents


def _phones(texts, rt=None):
    """The runtime's phone batch (bucketed) for ``texts``."""
    rt = rt or pr.VITSRuntime({}, PCFG, ".", torch.device("cpu"))
    return rt.phone_batch(texts)


def test_stage_a_on_jax_noise(jrt, tree, params):
    """``encode_and_durations`` through the JAX runtime's stage-A program
    at noise_w 2 and length_scale 1.3, on the noise it draws from its key:
    stats within the tolerance, durations equal except ceil ties."""
    phones, lengths, _, batch = _phones(TEXTS)
    speaker = np.full((batch,), 2, np.int32)
    key = jax.random.PRNGKey(11)
    noise_w, length_scale = 2.0, 1.3
    stats, dur = jrt._stage_a(jrt.params, phones=jnp.asarray(phones),
                              phone_lengths=jnp.asarray(lengths),
                              speaker_id=jnp.asarray(speaker), rng=key,
                              length_scale=length_scale, noise_w=noise_w)
    noise = np.asarray(jax.random.normal(key, (*phones.shape, 2), jnp.float32)) * noise_w
    got_stats, got_dur = pm.encode_and_durations(params, PCFG, _t(phones), _t(lengths),
                                                 _t(speaker), _t(noise),
                                                 length_scale=length_scale)
    _close(got_stats.numpy(), np.asarray(stats), "stage A stats")
    # the log-durations on both sides, for the ceil ties
    mask = (np.arange(phones.shape[1])[None] < lengths[:, None]).astype(np.float32)
    g = np.broadcast_to(tree["emb_g"][speaker][:, None, :],
                        (batch, phones.shape[1], JCFG.speaker_dim)).astype(np.float32)

    def logw(p, ph, m, g, n):
        return jm.duration_log_w(p, JCFG, jm._encoder(p, JCFG, ph, m), m, g, None, 0.0, noise=n)

    ref_logw = np.asarray(jax.jit(logw)(tree, phones, mask, g, noise))
    x = pm._encoder(params, PCFG, _t(phones).long(), _t(mask))
    got_logw = pm.duration_log_w(params, PCFG, x, _t(mask), _t(g), _t(noise)).numpy()
    _close(got_logw, ref_logw, "stage A log-durations")
    w = np.stack([np.exp(ref_logw), np.exp(got_logw)]) * length_scale
    tie = (np.abs(w - np.round(w)) <= 1e-5 * np.abs(w)).any(0)
    differ = got_dur.numpy() != np.asarray(dur)
    assert not (differ & ~tie).any(), np.argwhere(differ & ~tie)
    assert np.asarray(dur)[mask > 0].min() >= 1 and np.unique(np.asarray(dur)).size > 3


@pytest.mark.parametrize("speaker", [True, False], ids=["speaker", "no-speaker"])
def test_stage_b_on_jax_eps(jrt, tree, params, speaker):
    """``decode_frames`` at 128 frames on JAX's ``eps`` (noise_scale
    0.667): one row's durations past the frame bucket (its length
    clipped), one short; audio within 1e-3 of the peak, lengths exact.
    With a speaker through the JAX runtime's stage-B program."""
    rng = np.random.default_rng(5)
    b, p, frames = 2, 64, 128
    stats = (0.5 * rng.standard_normal((b, p, 2 * JCFG.latent_dim))).astype(np.float32)
    dur = rng.integers(1, 5, (b, p)).astype(np.int32)
    dur[1, 20:] = 0
    assert dur[0].sum() > frames > dur[1].sum()
    key = jax.random.PRNGKey(12)
    spk = np.array([1, 3], np.int32)
    kw = dict(max_frames=frames, noise_scale=0.667)
    if speaker:
        audio, lens = jrt._stage_b(jrt.params, stats=jnp.asarray(stats),
                                   durations=jnp.asarray(dur), rng=key,
                                   speaker_id=jnp.asarray(spk), **kw)
    else:
        audio, lens = jax.jit(lambda p, s, d, k: jm.decode_frames(p, JCFG, s, d, k, **kw))(
            tree, stats, dur, key)
    eps = np.asarray(jax.random.normal(key, (b, frames, JCFG.latent_dim), jnp.float32))
    got, got_lens = pm.decode_frames(params, PCFG, _t(stats), _t(dur), _t(eps),
                                     speaker_id=_t(spk) if speaker else None, **kw)
    assert np.array_equal(got_lens.numpy(), np.asarray(lens))
    assert got_lens.tolist() == [frames * 256, int(dur[1].sum()) * 256]
    _audio_close(got.numpy(), np.asarray(audio), f"stage B speaker={speaker}")


def test_vocoder_cond_and_stage_conds():
    from vocalie_tts_tpu.models.common import vocoder as jv
    from vocalie_tts_tpu_torch.models.common import vocoder as pv

    jcfg = jv.VocoderConfig(n_mels=8, base_channels=16)
    pcfg = pv.VocoderConfig(n_mels=8, base_channels=16)
    rng = np.random.default_rng(6)
    shapes = jax.eval_shape(lambda k: jv.init_vocoder(k, jcfg), jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(
        lambda s: rng.uniform(-1, 1, s.shape).astype(np.float32) / np.sqrt(np.prod(s.shape[:-1])),
        shapes)
    mel = rng.standard_normal((2, 6, 8)).astype(np.float32)
    cond = rng.standard_normal((2, 16)).astype(np.float32)
    stage = [rng.standard_normal((2, 16 >> (i + 1))).astype(np.float32) for i in range(4)]
    ref = np.asarray(jax.jit(lambda p, m, c, s: jv.apply_vocoder(p, jcfg, m, cond=c,
                                                                  stage_conds=s))(
        tree, mel, cond, stage))
    got = pv.apply_vocoder(tree_to_torch(tree), pcfg, _t(mel),
                           cond=_t(cond), stage_conds=[_t(s) for s in stage]).numpy()
    _audio_close(got, ref, "vocoder cond + stage_conds")
    plain = pv.apply_vocoder(tree_to_torch(tree), pcfg, _t(mel)).numpy()
    assert np.abs(plain - got).max() > 1e-3 * np.abs(ref).max()   # the conds take effect


# ── the runtime, the engine, the pipeline ───────────────────────────────


@pytest.mark.parametrize("n", [1, 3])
def test_runtime_at_zero_noise_matches_jax(jrt, prt, n):
    kw = dict(voice="fr_FR-upmc-medium", noise_w=0.0, noise_scale=0.0, length_scale=1.0)
    ref = jrt.synthesize_batch(TEXTS[:n], **kw)
    got = prt.synthesize_batch(TEXTS[:n], **kw)
    assert len(got) == len(ref) == n
    for (ga, gsr, gm), (ra, rsr, rm) in zip(got, ref):
        assert gsr == rsr == 22050
        assert gm.keys() == rm.keys()
        for key in ("engine", "phones", "batch_bucket", "phone_bucket", "frame_bucket"):
            assert gm[key] == rm[key], key
        assert len(ga) == len(ra) and len(ga) % 256 == 0
        _audio_close(ga, ra, f"runtime audio n={n}")


def test_engine_and_pipeline(prt, tmp_path, monkeypatch):
    from vocalie_tts_tpu_torch.engines import ENGINES
    from vocalie_tts_tpu_torch.io.wavio import read_wav
    from vocalie_tts_tpu_torch.pipeline import run_tts_pipeline

    monkeypatch.setenv("VOCALIE_ALLOW_RANDOM_WEIGHTS", "1")
    engine = ENGINES["piper"](device="cpu", assets=tmp_path / "assets")
    assert engine.native_sr == 22050 and engine.supports_inter_chunk_gap
    assert engine.is_available()
    engine._runtime = prt
    audio, sr, meta = engine.synthesize_chunk("Bonjour le monde.", voice_id="fr_FR-tom-medium",
                                              noise_w=0.0, noise_scale=0.0)
    ref, _, _ = prt.synthesize("Bonjour le monde.", voice="fr_FR-tom-medium", noise_w=0.0,
                               noise_scale=0.0)
    assert sr == 22050 and np.array_equal(audio, ref)
    assert meta["voice"] == "fr_FR-tom-medium" and meta["backend_id"] == "piper"
    script = "Premier morceau du texte.\n\nSecond morceau, un peu plus long."
    res = run_tts_pipeline({"tts_backend": "piper", "script": script,
                            "out_path": str(tmp_path / "out.wav"), "inter_chunk_gap_ms": 120,
                            "engine_params": {"noise_w": 0.0, "noise_scale": 0.0}},
                           engine=engine, device="cpu")
    wav, wav_sr = read_wav(res.out_path)
    assert wav_sr == 24000 == res.meta["sr"]
    assert res.meta["backend_id"] == "piper" and res.meta["backend_meta"]["engine"] == "piper"
    assert len(res.meta["durations"]) == res.meta["chunks"] >= 1
    assert abs(len(wav) / 24000 - res.meta["total_duration"]) < 1e-6
    assert np.isfinite(wav).all() and np.abs(wav).max() > 0


# ── weights ─────────────────────────────────────────────────────────────


def _leaves(tree):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in tree_items(tree)}


def test_jax_bundle_loads_and_port_save_round_trips(tree, tmp_path, monkeypatch):
    from tests.test_piper_ids import realistic_fr_id_map
    from vocalie_tts_tpu.models.common.weights import load_params_host, save_params

    monkeypatch.setenv("VOCALIE_MODEL_SCALE", "tiny")
    assets = tmp_path / "assets"
    save_params(assets / "weights", "vits", tree,
                meta={"family": "vits", "sample_rate": 22050, "n_phones": JCFG.n_phones})
    raw = realistic_fr_id_map()
    (assets / "weights" / "config.json").write_text(json.dumps({"phoneme_id_map": raw}),
                                                    encoding="utf-8")
    rt = pr.VITSRuntime.create(assets, device="cpu")
    want = _leaves(tree)
    got = _leaves(rt.params)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert rt._id_map is not None and rt._id_map.id_map == raw
    # the phone ids of JAX's id map on the same config
    from vocalie_tts_tpu.text.piper_ids import PiperIdMap

    ids = PiperIdMap(raw).encode_text(TEXTS[0])
    phones, lengths, _, _ = rt.phone_batch(TEXTS[:1])
    assert phones[0, :lengths[0]].tolist() == ids
    # the port's save: read back by both packages
    out = tmp_path / "saved"
    rt.weights_dir = out / "weights"
    rt.save_weights()
    meta = json.loads((out / "weights" / "meta.json").read_text(encoding="utf-8"))["vits"]
    assert meta == {"family": "vits", "sample_rate": 22050, "n_phones": JCFG.n_phones}
    back = _leaves(load_params_host(out / "weights", "vits", tree))
    for k in want:
        assert np.array_equal(back[k], want[k]), k
    again = pr.VITSRuntime.create(out, device="cpu")
    for k, v in _leaves(again.params).items():
        assert np.array_equal(v, want[k]), k
    # an id map past the embedding's rows is ignored, as in JAX
    big = {**raw, "x": [JCFG.n_phones + 3]}
    (assets / "weights" / "config.json").write_text(json.dumps({"phoneme_id_map": big}),
                                                    encoding="utf-8")
    assert pr.VITSRuntime.create(assets, device="cpu")._id_map is None
