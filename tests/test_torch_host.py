"""The port's copies of the JAX package's host-side modules (``text/``,
``dsp/host.py``, ``io/wavio.py``, ``utils/env.py`` and the byte
frontend) against the originals, on the same inputs. These are pure
Python/numpy, so every comparison is exact: same chunks, same floats,
same WAV bytes."""

import dataclasses

import numpy as np
import pytest

from vocalie_tts_tpu.dsp import host as jax_host
from vocalie_tts_tpu.io import wavio as jax_wavio
from vocalie_tts_tpu.text import chunk_script as jax_chunk_script
from vocalie_tts_tpu.text import estimate_duration as jax_estimate_duration
from vocalie_tts_tpu.text import parse_manual_chunks as jax_parse_manual_chunks
from vocalie_tts_tpu.text.frontend import ByteFrontend as JaxByteFrontend
from vocalie_tts_tpu.utils import env as jax_env
from vocalie_tts_tpu_torch.dsp import host
from vocalie_tts_tpu_torch.io import wavio
from vocalie_tts_tpu_torch.text import chunk_script, estimate_duration, parse_manual_chunks
from vocalie_tts_tpu_torch.text.frontend import ByteFrontend
from vocalie_tts_tpu_torch.utils import env

_SENT = ("Découvrez une nouvelle façon de créer vos voix off en français, "
         "avec un rendu naturel et une diction parfaitement maîtrisée.")
SCRIPTS = {
    "sentences": " ".join([_SENT, "C'est simple ! Vraiment ?", _SENT] * 3),
    "manual": "\n[[CHUNK]]\n".join([_SENT, "Deux mots.", _SENT + " " + _SENT]),
    "no_terminator": " ".join(["et puis la voix continue encore"] * 20),
    "newlines_and_pause": "Premier paragraphe, court.\n\nSecond [pause 500ms] paragraphe ; fin",
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_chunker_matches(name):
    script = SCRIPTS[name]
    got = [dataclasses.asdict(c) for c in chunk_script(script)]
    ref = [dataclasses.asdict(c) for c in jax_chunk_script(script)]
    assert got == ref and got
    got_m, ref_m = parse_manual_chunks(script), jax_parse_manual_chunks(script)
    assert [dataclasses.asdict(c) for c in got_m[0]] == [dataclasses.asdict(c) for c in ref_m[0]]
    assert got_m[1:] == ref_m[1:]
    assert estimate_duration(script) == jax_estimate_duration(script)


def test_byte_frontend_matches():
    text = SCRIPTS["newlines_and_pause"] + " œuvre 123 €"
    port, ref = ByteFrontend(), JaxByteFrontend()
    assert port.encode(text, "fr") == ref.encode(text, "fr")
    assert (port.bos_ids, port.sep_ids, port.vocab_size) == (ref.bos_ids, ref.sep_ids,
                                                             ref.vocab_size)


def test_resample_and_gap_stitch_match():
    rng = np.random.default_rng(0)
    chunks = [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in (4000, 9001, 2500)]
    got = host.apply_inter_chunk_gap(chunks, sr=24000, gap_ms=250)
    ref = jax_host.apply_inter_chunk_gap(chunks, sr=24000, gap_ms=250)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert np.array_equal(host.resample(chunks[1], 22050, 24000),
                          jax_host.resample(chunks[1], 22050, 24000))


def test_wav_bytes_match(tmp_path):
    """PCM_16 encode: the port's numpy codec writes the same bytes as the
    JAX package's native one (clip, x32767, round half to even)."""
    rng = np.random.default_rng(1)
    audio = np.concatenate([
        rng.uniform(-1.2, 1.2, 5000),
        np.asarray([0.5 / 32767, 1.5 / 32767, -2.5 / 32767, 1.0, -1.0, 0.0]),
    ]).astype(np.float32)
    wavio.write_wav(tmp_path / "port.wav", audio, 24000)
    jax_wavio.write_wav(tmp_path / "jax.wav", audio, 24000)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    got, sr = wavio.read_wav(tmp_path / "jax.wav")
    ref, jsr = jax_wavio.read_wav(tmp_path / "jax.wav")
    assert sr == jsr == 24000 and np.array_equal(got, ref)


@pytest.mark.parametrize("value", [None, "", "0", "1", "true", "False", "no", "on", "junk"])
def test_env_flags_match(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("VOCALIE_TEST_FLAG", raising=False)
    else:
        monkeypatch.setenv("VOCALIE_TEST_FLAG", value)
    for default in (False, True):
        assert env.bool_env("VOCALIE_TEST_FLAG", default) == jax_env.bool_env(
            "VOCALIE_TEST_FLAG", default)
    assert env.tri_env("VOCALIE_TEST_FLAG") == jax_env.tri_env("VOCALIE_TEST_FLAG")
