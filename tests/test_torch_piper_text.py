"""The port's French G2P and Piper id map against the JAX package's, on the
CPU (pure Python on both sides).

- ``phonemize_fr``, ``text_to_phone_ids`` and ``number_to_words_fr`` exactly
  equal to JAX's on every item of ``tests/test_g2p_golden.py``'s corpus, on
  liaison and number sentences and on the numbers of its number test.
- ``PiperIdMap.encode_text`` / ``encode_phones`` exactly equal on the
  realistic espeak map of ``tests/test_piper_ids.py``, and
  ``load_piper_id_map``'s discovery beside the weights.
- The phone inventory, the IPA table and the lexicon are the JAX
  package's; the byte ids keep one definition (``text/frontend.py``).
"""

import json

import pytest

from tests.test_g2p_golden import GOLDEN
from tests.test_piper_ids import realistic_fr_id_map
from vocalie_tts_tpu.text import phonemes as jp
from vocalie_tts_tpu.text import piper_ids as jids
from vocalie_tts_tpu_torch.text import phonemes as pp
from vocalie_tts_tpu_torch.text import piper_ids as pids

pytestmark = pytest.mark.unit

SENTENCES = [
    "Les enfants ont vingt ans, et six amis arrivent à midi.",
    "Bien entendu, c'est une bonne idée : tout à fait !",
    "Il y a 25 élèves, 71 chaises et 1999 livres ; 80 euros ou 200 ?",
    "Monsieur Dupont habite au 3 rue des Lilas depuis 1984.",
    "Un homme, deux hommes, trois heures et quatre-vingt-onze ans.",
    "Numéro 1234567890123 : lu chiffre par chiffre.",
    "L'œuvre du cœur, les yeux, l'oiseau et le château.",
    "Bonjour le monde. Oui, non ? Peut-être !",
    "",
]
NUMBERS = [0, 1, 7, 16, 17, 21, 22, 31, 60, 61, 69, 70, 71, 77, 80, 81, 91, 99, 100, 101,
           180, 200, 201, 999, 1000, 1001, 1984, 1999, 2000, 21000, 100000, 999999,
           1000000, 2000000, 2000017, -5, -1999]

TEXTS = [t for t, _ in GOLDEN] + SENTENCES


@pytest.mark.parametrize("text", TEXTS)
def test_phonemize_and_ids_equal_jax(text):
    assert pp.phonemize_fr(text) == jp.phonemize_fr(text)
    assert pp.text_to_phone_ids(text) == jp.text_to_phone_ids(text)


def test_number_to_words_equal_jax():
    for n in NUMBERS:
        assert pp.number_to_words_fr(n) == jp.number_to_words_fr(n), n


def test_inventory_lexicon_and_byte_ids_are_jax_s():
    from vocalie_tts_tpu_torch.text import frontend

    assert pp.PHONES == jp.PHONES and pp.PHONE_TO_ID == jp.PHONE_TO_ID
    assert pp.N_PHONES == jp.N_PHONES
    assert pp._lexicon() == jp._lexicon()
    assert pids.PHONE_TO_IPA == jids.PHONE_TO_IPA
    # one definition of the byte ids, re-exported under JAX's names
    assert pp.text_to_byte_ids is frontend.text_to_byte_ids
    for name in ("BYTE_VOCAB_SIZE", "BYTE_PAD", "BYTE_BOS", "BYTE_EOS", "BYTE_SEP"):
        assert getattr(pp, name) == getattr(jp, name), name
    assert pp.text_to_byte_ids("été") == jp.text_to_byte_ids("été")


def test_piper_id_map_encode_equal_jax():
    raw = realistic_fr_id_map()
    port, ref = pids.PiperIdMap(raw), jids.PiperIdMap(raw)
    assert port.max_id == ref.max_id
    for text in TEXTS:
        assert port.encode_text(text) == ref.encode_text(text), text
    # an unmapped phone is skipped alike
    partial = {k: v for k, v in raw.items() if k != "ʁ"}
    phones = jp.phonemize_fr("Bonjour à tous, merci.")
    assert (pids.PiperIdMap(partial).encode_phones(phones)
            == jids.PiperIdMap(partial).encode_phones(phones))


def test_load_piper_id_map_discovery(tmp_path):
    raw = realistic_fr_id_map()
    assert pids.load_piper_id_map(tmp_path) is None
    (tmp_path / "weights").mkdir()
    (tmp_path / "weights" / "config.json").write_text(json.dumps({"phoneme_id_map": raw}),
                                                      encoding="utf-8")
    port, ref = pids.load_piper_id_map(tmp_path), jids.load_piper_id_map(tmp_path)
    assert port.id_map == ref.id_map and port.bos == ref.bos and port.eos == ref.eos
    (tmp_path / "piper_config.json").write_text(json.dumps({"no_map": 1}), encoding="utf-8")
    assert pids.load_piper_id_map(tmp_path).id_map == raw
    with pytest.raises(ValueError, match="no phoneme_id_map"):
        pids.PiperIdMap.from_config(tmp_path / "piper_config.json")
