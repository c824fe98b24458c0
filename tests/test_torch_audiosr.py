"""The AudioSR slice of the port against the JAX package, module by module
and for ``AudioSRRuntime.enhance_audio`` as a whole, at the ``tiny`` scale
on the CPU. Both sides run the JAX ``init_audiosr`` tree (carried across by
``bridge.tree_to_torch``) with every leaf redrawn from a numpy seed, so the
zero-initialized LDM output convs do not hide the network; the DDIM noise
is JAX's own ``jax.random.normal`` draw, fed to the port.

Tolerances (each test states its own):
- the mel filterbank and the int8 values, scales and int32 conv sums are
  equal (the port divides by a constant as XLA's jitted code does: by an
  f32 reciprocal); ``_conv2d_int8``'s outputs within an f32 ulp;
- f32 modules agree to summation order: convs, VAE and vocoder within
  1e-4 of max|ref|, the UNet and the whole DDIM-to-audio chain within 1e-4
  (log-mel 1e-4 absolute);
- the bf16 UNet with int8 convs and B13 is held to JAX's own bf16 noise
  (relative L2; see that test).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.models.audiosr import model as jmodel
from vocalie_tts_tpu.models.audiosr import runtime as jrt
from vocalie_tts_tpu.models.audiosr import vae as jvae
from vocalie_tts_tpu.models.common import audio as jaudio
from vocalie_tts_tpu.models.common import unet2d as junet
from vocalie_tts_tpu.models.common import vocoder as jvoc
from vocalie_tts_tpu_torch.bridge import tree_to_torch
from vocalie_tts_tpu_torch.models.audiosr import model as tmodel
from vocalie_tts_tpu_torch.models.audiosr import runtime as trt
from vocalie_tts_tpu_torch.models.audiosr import vae as tvae
from vocalie_tts_tpu_torch.models.common import audio as taudio
from vocalie_tts_tpu_torch.models.common import unet2d as tunet
from vocalie_tts_tpu_torch.models.common import vocoder as tvoc

JCFG = jrt.SCALES["tiny"]
TCFG = trt.SCALES["tiny"]


def _redraw(tree, seed: int):
    """Every leaf of a param tree (arrays or shapes) drawn from a numpy
    seed at a fan-in scale, norm gains around 1, in the leaf's dtype."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        arr = node
        if name == "g":
            new = 1.0 + 0.1 * rng.standard_normal(arr.shape)
        elif arr.ndim == 1:
            new = 0.1 * rng.standard_normal(arr.shape)
        else:
            fan_in = int(np.prod(arr.shape[:-1]))
            new = rng.uniform(-1.0, 1.0, arr.shape) / np.sqrt(fan_in)
        return jnp.asarray(new.astype(np.float32), arr.dtype)

    return walk(tree)


@pytest.fixture(scope="module")
def jparams():
    shapes = jax.eval_shape(functools.partial(jmodel.init_audiosr, cfg=JCFG),
                            jax.random.PRNGKey(5))
    return _redraw(shapes, 21)


@pytest.fixture(scope="module")
def jq(jparams):
    """JAX's int8 serving view of the UNet."""
    return jax.jit(junet.quantize_unet_convs)(jparams["unet"])


_jit_unet = jax.jit(junet.apply_unet2d, static_argnums=1)


def _t(tree):
    return tree_to_torch(jax.device_get(tree))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ── front end ───────────────────────────────────────────────────────────


def test_log_mel_slaney_matches_jax():
    fb_t = taudio._mel_filterbank_np(48000, 2048, 128, 20.0, None, scale="slaney")
    fb_j = jaudio._mel_filterbank_np(48000, 2048, 128, 20.0, None, scale="slaney")
    np.testing.assert_array_equal(fb_t, fb_j)
    x = (0.3 * np.random.default_rng(0).standard_normal((2, 8192))).astype(np.float32)
    kw = dict(sr=48000, n_fft=2048, hop=512, n_mels=128, fmin=20.0, scale="slaney")
    want = np.asarray(jaudio.log_mel_spectrogram(jnp.asarray(x), **kw))
    got = taudio.log_mel_spectrogram(torch.from_numpy(x), **kw).numpy()
    assert got.shape == want.shape == (2, 17, 128)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# ── convs and int8 ──────────────────────────────────────────────────────


CONV_CASES = [  # (kernel, stride, padding, pre-pad (0,1))
    (3, 1, "SAME", False),
    (1, 1, "SAME", False),
    (3, 2, ((1, 1), (1, 1)), False),
    (3, 2, "VALID", True),
]


def _conv_inputs(k, ci, co, seed):
    rng = np.random.default_rng(seed)
    w = (rng.uniform(-1, 1, (k, k, ci, co)) / np.sqrt(k * k * ci)).astype(np.float32)
    b = (0.1 * rng.standard_normal(co)).astype(np.float32)
    x = rng.standard_normal((3, 8, 12, ci)).astype(np.float32)
    x[1] *= 5.0   # per-sample activation scales differ
    return w, b, x


@pytest.mark.parametrize("k,stride,padding,prepad", CONV_CASES)
def test_conv2d_matches_jax(k, stride, padding, prepad):
    w, b, x = _conv_inputs(k, 16, 24, k + stride)
    if prepad:
        x = np.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0)))
    p_j = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    p_t = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    want = np.asarray(junet.conv2d(p_j, jnp.asarray(x), stride=stride, padding=padding))
    got = tunet.conv2d(p_t, torch.from_numpy(x), stride=stride, padding=padding).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5


@functools.partial(jax.jit, static_argnames=("stride", "padding"))
def _jax_int8_steps(w, b, x, *, stride, padding):
    """JAX's int8 conv as its jitted serving code computes it: the weight
    quantization, the activation scale and int8 values, the int32 sums and
    the dequantized output."""
    q = junet.conv_quantize_int8({"w": w, "b": b})
    sx = jnp.maximum(jnp.max(jnp.abs(x), axis=(1, 2, 3), keepdims=True), 1e-12) / 127.0
    xq = jnp.round(x / sx).astype(jnp.int8)
    acc = jax.lax.conv_general_dilated(xq, q["w_q"], (stride, stride), padding,
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                       preferred_element_type=jnp.int32)
    return q, sx, xq, acc, junet.conv2d(q, x, stride=stride, padding=padding)


@pytest.mark.parametrize("k,stride,padding,prepad", CONV_CASES)
def test_conv2d_int8_integer_sums_equal_jax(k, stride, padding, prepad):
    """Quantized weights and activations equal, the int32 conv sums equal,
    and the dequantized f32 output within an ulp."""
    w, b, x = _conv_inputs(k, 16, 24, 10 + k + stride)
    if prepad:
        x = np.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0)))
    pad = padding if isinstance(padding, str) else tuple(map(tuple, padding))
    qj, sx, xq_j, acc_j, want = _jax_int8_steps(jnp.asarray(w), jnp.asarray(b), jnp.asarray(x),
                                                stride=stride, padding=pad)
    qt = tunet.conv_quantize_int8({"w": torch.from_numpy(w), "b": torch.from_numpy(b)})
    np.testing.assert_array_equal(qt["w_q"].numpy(), np.asarray(qj["w_q"]))
    np.testing.assert_array_equal(qt["w_s"].numpy(), np.asarray(qj["w_s"]))
    xq_t, sx_t = tunet._quantize_act(torch.from_numpy(x))
    np.testing.assert_array_equal(sx_t.numpy(), np.asarray(sx))
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
    acc_t = tunet._conv_int8_acc(xq_t, qt["w_q"], stride=stride, padding=padding)
    assert acc_t.dtype == torch.int32
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    got = tunet.conv2d(qt, torch.from_numpy(x), stride=stride, padding=padding).numpy()
    # XLA contracts the dequantizing multiply-add into an FMA: an f32 ulp
    assert _rel(got, want) <= 1e-6


def test_quantize_unet_convs_equal_jax(jparams, jq):
    qj = jax.device_get(jq)
    qt = tunet.quantize_unet_convs(_t(jparams["unet"]))
    flat_j = jax.tree_util.tree_flatten_with_path(qj)[0]
    n_int8 = 0
    for path, leaf in flat_j:
        node = qt
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf), err_msg=str(path))
        n_int8 += node.dtype == torch.int8
    assert n_int8 > 10 and "w" in qt["out_conv"] and "w_q" not in qt["out_conv"]


# ── UNet, VAE, vocoder ──────────────────────────────────────────────────


def _unet_inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 4, 8, JCFG.unet.in_channels)).astype(np.float32)
    t = np.asarray([3.0, 700.0][:b], np.float32)
    return x, t


def test_apply_unet2d_f32_matches_jax(jparams):
    x, t = _unet_inputs(1)
    want = np.asarray(_jit_unet(jparams["unet"], JCFG.unet, jnp.asarray(x), jnp.asarray(t)))
    got = tunet.apply_unet2d(_t(jparams["unet"]), TCFG.unet, torch.from_numpy(x),
                             torch.from_numpy(t)).numpy()
    assert got.shape == want.shape and np.abs(want).max() > 0.1
    assert _rel(got, want) <= 1e-4


def test_apply_unet2d_bf16_int8_with_b13_matches_jax(jparams, jq, monkeypatch):
    """The serving configuration: bf16 activations, int8 convs, and
    ``VOCALIE_GN_PALLAS=1`` on both sides (B13's plain version here, JAX's
    Pallas kernel in interpret mode or ``_gn_xla``). In f32 the same int8
    tree agrees to 1e-6; in bf16 the two round at other places (PyTorch
    after every op, XLA once per fused chain) and an activation near an
    int8 step can take the other step. So the bound is JAX's own bf16
    noise: the port's bf16 output is no farther (relative L2) from JAX's
    bf16 output than that is from JAX's f32 output on the same tree (~4e-2
    here), and no more than 1.25× that from the f32 output."""
    monkeypatch.setenv("VOCALIE_GN_PALLAS", "1")
    x, t = _unet_inputs(2)
    ucj = dataclasses.replace(JCFG.unet, dtype=jnp.bfloat16)
    uct = dataclasses.replace(TCFG.unet, dtype=torch.bfloat16)
    want = np.asarray(_jit_unet(jq, ucj, jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(t)).astype(jnp.float32))
    want_f32 = np.asarray(_jit_unet(jq, JCFG.unet, jnp.asarray(x), jnp.asarray(t)))
    calls = []
    real = tunet.group_norm_fused
    monkeypatch.setattr(tunet, "group_norm_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = tunet.apply_unet2d(tunet.quantize_unet_convs(_t(jparams["unet"])), uct,
                             torch.from_numpy(x).to(torch.bfloat16),
                             torch.from_numpy(t)).float().numpy()
    # tiny: 8 resblocks (1 + 1 down, 2 in the middle, 2 + 2 up) with two
    # norms each, 4 attention blocks (at ds 2: 1 down, 1 middle, 2 up), out_norm
    assert len(calls) == 2 * 8 + 4 + 1
    got_f32 = tunet.apply_unet2d(tunet.quantize_unet_convs(_t(jparams["unet"])), TCFG.unet,
                                 torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert _rel(got_f32, want_f32) <= 1e-6

    def l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    noise = l2(want, want_f32)
    assert 1e-3 < noise < 0.1
    assert l2(got, want) <= noise, (l2(got, want), noise)
    assert l2(got, want_f32) <= 1.25 * noise, (l2(got, want_f32), noise)


def test_vae_encode_decode_matches_jax(jparams):
    rng = np.random.default_rng(3)
    image = rng.standard_normal((2, 16, JCFG.n_mels, 1)).astype(np.float32)
    enc = jax.jit(jvae.vae_encode, static_argnums=1)
    want = np.asarray(enc(jparams["vae"], JCFG.vae, jnp.asarray(image)))
    got = tvae.vae_encode(_t(jparams["vae"]), TCFG.vae, torch.from_numpy(image)).numpy()
    assert got.shape == want.shape == (2, 8, JCFG.n_mels // 2, JCFG.embed_dim)
    assert _rel(got, want) <= 1e-4
    z = rng.standard_normal(want.shape).astype(np.float32)
    want = np.asarray(jax.jit(jvae.vae_decode, static_argnums=1)(jparams["vae"], JCFG.vae,
                                                               jnp.asarray(z)))
    got = tvae.vae_decode(_t(jparams["vae"]), TCFG.vae, torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == image.shape
    assert _rel(got, want) <= 1e-4


def test_apply_vocoder_matches_jax(jparams):
    mel = np.random.default_rng(4).standard_normal((2, 6, JCFG.n_mels)).astype(np.float32)
    voc = jax.jit(jvoc.apply_vocoder, static_argnums=1)
    want = np.asarray(voc(jparams["vocoder"], JCFG.vocoder, jnp.asarray(mel)))
    got = tvoc.apply_vocoder(_t(jparams["vocoder"]), TCFG.vocoder, torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 6 * 512)
    assert _rel(got, want) <= 1e-4


# ── DDIM and the window ─────────────────────────────────────────────────


def test_ddim_times_match_jax_linspace():
    for steps in (2, 3, 7, 20, 100):
        np.testing.assert_array_equal(tmodel.ddim_times(steps).numpy(),
                                      np.asarray(jnp.linspace(1.0, 0.0, steps + 1)))


def test_enhance_window_with_jax_noise_matches_jax(jparams, steps=3):
    """log-mel → VAE → DDIM with CFG → VAE → vocoder on JAX's noise; the
    ``ddim_super_resolution`` mel and the window's audio within 1e-4."""
    audio = (0.3 * np.random.default_rng(6).standard_normal((2, 8192))).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    kw = dict(ddim_steps=steps, guidance_scale=2.5)
    window = jax.jit(functools.partial(jmodel.enhance_window, cfg=JCFG, **kw))
    want = np.asarray(window(jparams, audio_48k=jnp.asarray(audio), rng=rng))
    mel = jaudio.log_mel_spectrogram(jnp.asarray(audio), sr=48000, n_fft=2048, hop=512,
                                     n_mels=JCFG.n_mels, fmin=20.0, scale="slaney")[:, :16]
    ddim = jax.jit(functools.partial(jmodel.ddim_super_resolution, cfg=JCFG, **kw))
    want_mel = np.asarray(ddim(jparams, mel_lowres=mel, rng=rng))
    shape = tmodel.latent_shape(TCFG, 2, 8192)
    noise = torch.from_numpy(np.array(jax.random.normal(rng, shape, jnp.float32)))
    tp = _t(jparams)
    got_mel = tmodel.ddim_super_resolution(tp, TCFG, torch.from_numpy(np.array(mel)), noise,
                                           **kw).numpy()
    assert got_mel.shape == want_mel.shape
    np.testing.assert_allclose(got_mel, want_mel, atol=1e-4 * np.abs(want_mel).max(), rtol=0)
    got = tmodel.enhance_window(tp, TCFG, torch.from_numpy(audio), noise, **kw).numpy()
    assert got.shape == want.shape == audio.shape and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# ── the runtime ─────────────────────────────────────────────────────────


@pytest.fixture(scope="module")
def runtimes(jparams, tmp_path_factory):
    """The JAX tiny runtime on the redrawn weights, and the port's runtime
    on the same weights with JAX's per-dispatch noise."""
    import os

    old = os.environ.get("VOCALIE_MODEL_SCALE")
    os.environ["VOCALIE_MODEL_SCALE"] = "tiny"
    try:
        jr = jrt.AudioSRRuntime(jparams, JCFG, tmp_path_factory.mktemp("asr") / "weights")
    finally:
        if old is None:
            os.environ.pop("VOCALIE_MODEL_SCALE")
        else:
            os.environ["VOCALIE_MODEL_SCALE"] = old
    tr = trt.AudioSRRuntime(_t(jparams), TCFG, jr.weights_dir, torch.device("cpu"))
    tr._draw_noise = lambda shape, seed: torch.from_numpy(
        np.array(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)))
    return jr, tr


def test_enhance_audio_matches_jax(runtimes, monkeypatch):
    """A three-window input (one padded window-count bucket of 4, a short
    last window) with the device stitch, then the multiband ensemble: the
    port's output within 1e-4 of JAX's; the port's device stitch against
    its host stitch within 1e-5 (the JAX package's own bound)."""
    jr, tr = runtimes
    audio = (0.2 * np.random.default_rng(11).standard_normal(80_000)).astype(np.float32)
    kw = dict(ddim_steps=2, guidance_scale=2.0, seed=5)
    want = jr.enhance_audio(audio, 48000, **kw)
    got = tr.enhance_audio(audio, 48000, **kw)
    assert got.shape == want.shape == audio.shape and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    monkeypatch.setattr(trt, "_DEVICE_STITCH", False)
    host = tr.enhance_audio(audio, 48000, **kw)
    np.testing.assert_allclose(got, host, atol=1e-5, rtol=0)
    monkeypatch.setattr(trt, "_DEVICE_STITCH", True)
    kw.update(multiband_ensemble=True, input_cutoff=6000)
    want = jr.enhance_audio(audio, 44100, **kw)
    got = tr.enhance_audio(audio, 44100, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_short_input_and_wav_file(runtimes, tmp_path):
    """A one-window input (the single-dispatch branch) through
    ``enhance_file``: a 48 kHz PCM_16 WAV of the resampled length."""
    from vocalie_tts_tpu_torch.io.wavio import read_wav, write_wav

    jr, tr = runtimes
    t = np.arange(12_000) / 24000
    src = tmp_path / "in.wav"
    write_wav(src, (0.4 * np.sin(2 * np.pi * 330 * t)).astype(np.float32), 24000)
    kw = dict(ddim_steps=3, guidance_scale=2.5, seed=1)
    res = tr.enhance_file(input_path=str(src), output_path=str(tmp_path / "out.wav"), **kw)
    out, sr = read_wav(tmp_path / "out.wav")
    assert sr == 48000 and len(out) == 24_000 and res["duration_s"] == 0.5
    jax_out = jr.enhance_audio(*read_wav(src), **kw)
    np.testing.assert_allclose(out, jax_out, atol=1.5 / 32767, rtol=0)   # PCM_16 rounding


def test_create_loads_the_jax_checkpoint(jparams, jq, tmp_path, monkeypatch):
    """``create`` reads the JAX package's saved npz (the bf16 runtime's
    tree: f32 VAE and UNet, bf16 vocoder); the int8 serving view rebuilt
    from it equals JAX's, and ``save_weights`` writes the float tree back."""
    from vocalie_tts_tpu.models.common.weights import save_params as jax_save_params

    monkeypatch.setenv("VOCALIE_MODEL_SCALE", "tiny")
    monkeypatch.setenv("VOCALIE_AUDIOSR_BF16", "1")
    tree = {**jparams, "vocoder": jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                                         jparams["vocoder"])}
    jax_save_params(tmp_path / "weights", "audiosr", tree, meta={"family": "audiosr"})
    tr = trt.AudioSRRuntime.create(tmp_path, device="cpu")
    assert tr.cfg.dtype == torch.bfloat16
    conv = tr._save_params["unet"]["input_blocks"][0]["conv"]["w"]
    np.testing.assert_array_equal(conv.numpy(),
                                  np.asarray(jparams["unet"]["input_blocks"][0]["conv"]["w"]))
    voc = tr._save_params["vocoder"]["pre"]["w"]
    assert voc.dtype == torch.bfloat16
    np.testing.assert_array_equal(voc.float().numpy(),
                                  np.asarray(tree["vocoder"]["pre"]["w"], np.float32))
    q = tr.params["unet"]["output_blocks"][1]["res"]["in_conv"]
    want = jq["output_blocks"][1]["res"]["in_conv"]
    np.testing.assert_array_equal(q["w_q"].numpy(), np.asarray(want["w_q"]))
    np.testing.assert_array_equal(q["w_s"].numpy(), np.asarray(want["w_s"]))
    tr.save_weights()
    tr2 = trt.AudioSRRuntime.create(tmp_path, device="cpu")
    assert torch.equal(tr2._save_params["vae"]["encoder"]["conv_in"]["w"],
                       tr._save_params["vae"]["encoder"]["conv_in"]["w"])
    assert torch.equal(tr2._save_params["vocoder"]["pre"]["w"], voc)
    # and the port's npz loads in the JAX package
    from vocalie_tts_tpu.models.common.weights import load_params_host

    back = load_params_host(tmp_path / "weights", "audiosr", tree)
    np.testing.assert_array_equal(np.asarray(back["vocoder"]["pre"]["w"], np.float32),
                                  voc.float().numpy())
    np.testing.assert_array_equal(back["unet"]["out_conv"]["w"],
                                  tr._save_params["unet"]["out_conv"]["w"].numpy())
