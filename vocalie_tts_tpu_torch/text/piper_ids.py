"""Published Piper voice id space: the espeak ``phoneme_id_map`` frontend
(the port's copy of ``vocalie_tts_tpu/text/piper_ids.py``, pure Python).

Published Piper voices ship a ``config.json`` whose ``phoneme_id_map``
maps espeak-ng IPA output characters to id lists, with the sentinel
entries ``^`` (BOS), ``$`` (EOS), ``_`` (pad, interleaved between
phonemes) and `` `` (word separator): the id space the voice's
``enc_p.emb`` rows were trained with.

The in-repo French G2P (``text/phonemes.py``) produces the phones; this
module translates that inventory into espeak IPA strings and then into
the voice's published ids, with piper's interleaved-pad convention:

    ids = map[^] + map[_] + Σ(map[phone] + map[_]) + map[$]

Unknown phones are skipped with a one-time warning (piper's own
behavior for unmapped characters). A composed IPA string (e.g. the
nasal "ɑ̃" = U+0251 + combining U+0303) is looked up whole first, then
character-by-character: published maps key per character.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List, Optional

from vocalie_tts_tpu_torch.text.phonemes import phonemize_fr

log = logging.getLogger("vocalie_api")

#: in-repo phone inventory (text/phonemes.PHONES) → espeak-ng IPA
PHONE_TO_IPA: Dict[str, str] = {
    "_": "_", "^": "^", "$": "$", " ": " ",
    ".": ".", ",": ",", "?": "?", "!": "!",
    # oral vowels
    "a": "a", "e": "e", "E": "ɛ", "i": "i", "o": "o", "O": "ɔ",
    "u": "u", "y": "y", "2": "ø", "9": "œ", "@": "ə",
    # nasal vowels (combining tilde — espeak's French output)
    "a~": "ɑ̃", "E~": "ɛ̃", "o~": "ɔ̃", "9~": "œ̃",
    # glides
    "j": "j", "w": "w", "H": "ɥ",
    # consonants
    "p": "p", "b": "b", "t": "t", "d": "d", "k": "k", "g": "ɡ",
    "f": "f", "v": "v", "s": "s", "z": "z",
    "S": "ʃ", "Z": "ʒ", "m": "m", "n": "n", "N": "ɲ", "l": "l",
    "R": "ʁ",
}


class PiperIdMap:
    """A published voice's phoneme→id translation."""

    def __init__(self, phoneme_id_map: Dict[str, List[int]]):
        self.id_map = {k: list(v) for k, v in phoneme_id_map.items()}
        self._warned: set = set()
        self.bos = self.id_map.get("^", [])
        self.eos = self.id_map.get("$", [])
        self.pad = self.id_map.get("_", [])

    @property
    def max_id(self) -> int:
        return max((max(v) for v in self.id_map.values() if v), default=0)

    @classmethod
    def from_config(cls, config_path: str | Path) -> "PiperIdMap":
        cfg = json.loads(Path(config_path).read_text(encoding="utf-8"))
        id_map = cfg.get("phoneme_id_map")
        if not isinstance(id_map, dict) or not id_map:
            raise ValueError(f"{config_path}: no phoneme_id_map")
        return cls(id_map)

    def _ids_for_ipa(self, ipa: str) -> Optional[List[int]]:
        if ipa in self.id_map:
            return list(self.id_map[ipa])
        ids: List[int] = []
        for ch in ipa:
            if ch in self.id_map:
                ids.extend(self.id_map[ch])
            else:
                return None
        return ids or None

    def encode_phones(self, phones: List[str]) -> List[int]:
        """Our G2P phone sequence → published ids (piper convention:
        BOS, then every phoneme followed by the interleaved pad, EOS).
        The G2P's own ^/$ sentinels are replaced by the map's."""
        ids: List[int] = list(self.bos) + list(self.pad)
        for p in phones:
            if p in ("^", "$"):
                continue
            ipa = PHONE_TO_IPA.get(p)
            got = self._ids_for_ipa(ipa) if ipa is not None else None
            if got is None:
                if p not in self._warned:
                    self._warned.add(p)
                    log.warning(
                        "piper id map: phone %r (ipa %r) not in the voice's "
                        "phoneme_id_map — skipped", p, ipa,
                    )
                continue
            ids.extend(got)
            ids.extend(self.pad)
        ids.extend(self.eos)
        return ids

    def encode_text(self, text: str) -> List[int]:
        return self.encode_phones(phonemize_fr(text))


def load_piper_id_map(assets_dir: str | Path) -> Optional[PiperIdMap]:
    """Voice config discovery beside the weights: ``piper_config.json``
    (staged by convert-hf) or a raw ``config.json``."""
    for name in ("piper_config.json", "config.json"):
        for base in (Path(assets_dir), Path(assets_dir) / "weights"):
            cand = base / name
            if cand.exists():
                try:
                    return PiperIdMap.from_config(cand)
                except ValueError:
                    continue
    return None


__all__ = ["PHONE_TO_IPA", "PiperIdMap", "load_piper_id_map"]
