"""Stage 2 (token → waveform) of the port against the JAX reference at
the tiny scale (f32): the conformer encoder, the CFM ODE (with the flash
kernel B6 in its transformer blocks at mel length >= 256 — interpret
mode in JAX, the plain version here — and the plain softmax below), HiFT,
and ``tokens_to_audio``.

The two frameworks' generators never agree, so the test draws JAX's
noise (the ODE start ``z`` and HiFT's source noise, with the same key
splits the JAX functions use) and hands it to the port.

Tolerance: atol 1e-3 on mel and waveform (f32 on both sides; the ODE and
the vocoder's convolutions sum in different orders, and the ODE's CFG
step amplifies differences by 1 + cfg_rate per step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocalie_tts_tpu.models.chatterbox import model as jmodel
from vocalie_tts_tpu.models.chatterbox.runtime import SCALES as JAX_SCALES
from vocalie_tts_tpu.models.common import cfm as jcfm
from vocalie_tts_tpu.models.common import conformer as jconf
from vocalie_tts_tpu.models.common import hift as jhift
from vocalie_tts_tpu_torch.bridge import tree_to_torch
from vocalie_tts_tpu_torch.models.chatterbox import model as pmodel
from vocalie_tts_tpu_torch.models.chatterbox.runtime import SCALES
from vocalie_tts_tpu_torch.models.common import cfm as pcfm
from vocalie_tts_tpu_torch.models.common import conformer as pconf
from vocalie_tts_tpu_torch.models.common import hift as phift
from vocalie_tts_tpu_torch.models.common.token2wav import Stage2Noise

ATOL = 1e-3


@pytest.fixture(scope="module")
def dec():
    cfg = JAX_SCALES["tiny"]
    raw = jax.device_get(jmodel.init_token_decoder(jax.random.PRNGKey(3), cfg))
    return raw, tree_to_torch(raw)


def _t(a):
    return torch.from_numpy(np.array(a))


def _mask(n_tok, lens):
    return (np.arange(n_tok)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)


def test_conformer_encoder(dec):
    jp, pp = dec[0]["t2w"]["encoder"], dec[1]["t2w"]["encoder"]
    jc, pc = JAX_SCALES["tiny"].t2w.encoder, SCALES["tiny"].t2w.encoder
    x = np.random.default_rng(0).standard_normal((3, 40, jc.input_size)).astype(np.float32)
    m = _mask(40, [40, 25, 7])[..., None]
    ref = jconf.apply_conformer_encoder(jp, jc, jnp.asarray(x), jnp.asarray(m))
    out = pconf.apply_conformer_encoder(pp, pc, _t(x), _t(m))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_mel", [96, 288])
def test_cfm_generate(dec, n_mel):
    """n_mel=96 runs the plain softmax; 288 (>= 256) the flash kernel."""
    jp, pp = dec[0]["t2w"]["estimator"], dec[1]["t2w"]["estimator"]
    jc, pc = JAX_SCALES["tiny"].t2w.decoder, SCALES["tiny"].t2w.decoder
    rng = np.random.default_rng(n_mel)
    b, c = 2, jc.out_channels
    mu = rng.standard_normal((b, n_mel, c)).astype(np.float32)
    spk = rng.standard_normal((b, c)).astype(np.float32)
    m = _mask(n_mel, [n_mel, n_mel - 70])[..., None]
    key = jax.random.PRNGKey(n_mel)
    ref = jcfm.cfm_generate(jp, jc, key, jnp.asarray(mu), jnp.asarray(m), spks=jnp.asarray(spk),
                            cond=jnp.zeros_like(jnp.asarray(mu)))
    z = jax.random.normal(key, (b, n_mel, c), jnp.float32)
    out = pcfm.cfm_generate(pp, pc, _t(mu), _t(m), spks=_t(spk), cond=torch.zeros(b, n_mel, c),
                            z=_t(z))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _hift_noise(key, b, samples, h1):
    """The draws jhift.harmonic_source makes from ``key``."""
    key, k1 = jax.random.split(key)
    return (np.array(jax.random.uniform(k1, (b, h1))),
            np.array(jax.random.normal(key, (b, samples, h1))))


@pytest.mark.parametrize("noisy", [False, True])
def test_hift(dec, noisy):
    jp, pp = dec[0]["t2w"]["hift"], dec[1]["t2w"]["hift"]
    jc, pc = JAX_SCALES["tiny"].t2w.hift, SCALES["tiny"].t2w.hift
    mel = np.random.default_rng(5).standard_normal((2, 30, jc.in_channels)).astype(np.float32)
    key = jax.random.PRNGKey(9) if noisy else None
    ref = jhift.apply_hift(jp, jc, jnp.asarray(mel), key)
    if noisy:
        rand_ini, normal = _hift_noise(key, 2, 30 * jc.hop, jc.nb_harmonics + 1)
        out = phift.apply_hift(pp, pc, _t(mel), _t(rand_ini), _t(normal))
    else:
        out = phift.apply_hift(pp, pc, _t(mel))
    assert out.shape == ref.shape == (2, 30 * jc.hop)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def jax_stage2_noise(cfg, key, b, n_tok):
    """Stage2Noise with the draws jmodel.tokens_to_audio makes from ``key``
    (token2wav splits it into the CFM key and the HiFT key)."""
    t2w = cfg.t2w
    r1, r2 = jax.random.split(key)
    frames = n_tok * t2w.token_mel_ratio
    z = np.array(jax.random.normal(r1, (b, frames, t2w.n_mels), jnp.float32))
    rand_ini, normal = _hift_noise(r2, b, frames * t2w.hift.hop, t2w.hift.nb_harmonics + 1)
    return Stage2Noise(z=_t(z), rand_ini=_t(rand_ini), source_normal=_t(normal))


def test_tokens_to_audio(dec):
    cfg = JAX_SCALES["tiny"]
    b, n_tok = 3, 140   # 280 mel frames: the CFM blocks take the flash path
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.speech_vocab, (b, n_tok)).astype(np.int32)
    m = _mask(n_tok, [140, 90, 5])
    key = jax.random.PRNGKey(21)
    ref = jmodel.tokens_to_audio(dec[0], cfg, jnp.asarray(toks), jnp.asarray(m), rng=key)
    out = pmodel.tokens_to_audio(dec[1], SCALES["tiny"], _t(toks), _t(m),
                                 jax_stage2_noise(cfg, key, b, n_tok))
    assert out.shape == ref.shape == (b, n_tok * cfg.samples_per_token)
    assert torch.all(torch.isfinite(out))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
