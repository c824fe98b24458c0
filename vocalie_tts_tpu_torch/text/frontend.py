"""Byte frontend for the Chatterbox- and CosyVoice-class LMs (copy of the
JAX package's ``ByteFrontend``, ``build_prompt_ids`` and its byte ids from
``text/phonemes.py``).

A published ``tokenizer.json`` staged beside converted weights is not
handled by the port yet: :func:`load_frontend` refuses it instead of
silently encoding with the wrong ids.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

BYTE_VOCAB_SIZE = 256 + 4
BYTE_PAD, BYTE_BOS, BYTE_EOS, BYTE_SEP = 256, 257, 258, 259
#: the JAX package's encode styles of published tokenizers (Chatterbox's
#: voice BPE, CosyVoice's raw byte-level BPE); the byte frontend takes both
STYLES = ("voicebpe", "raw")


def text_to_byte_ids(text: str, *, add_bos: bool = True, add_eos: bool = True) -> List[int]:
    ids = list(text.encode("utf-8"))
    if add_bos:
        ids = [BYTE_BOS] + ids
    if add_eos:
        ids = ids + [BYTE_EOS]
    return ids


class ByteFrontend:
    """UTF-8 byte ids with explicit BOS/SEP control tokens (< 260)."""

    published = False
    vocab_size = BYTE_VOCAB_SIZE

    def encode(self, text: str, lang: Optional[str] = None) -> List[int]:
        return text_to_byte_ids(text, add_bos=False, add_eos=False)

    @property
    def bos_ids(self) -> List[int]:
        return [BYTE_BOS]

    @property
    def sep_ids(self) -> List[int]:
        return [BYTE_SEP]


def build_prompt_ids(frontend, text: str, *, preamble: str = "",
                     lang: Optional[str] = None) -> List[int]:
    """Standard two-segment prompt: [BOS?] preamble [SEP] text (empty
    preamble → [BOS?] text)."""
    ids: List[int] = list(frontend.bos_ids)
    if preamble:
        ids += frontend.encode(preamble, lang)
        ids += frontend.sep_ids
    ids += frontend.encode(text, lang)
    return ids


def load_frontend(assets_dir: str | Path, *, text_vocab: int,
                  style: str = "voicebpe") -> ByteFrontend:
    """The byte frontend; ``style`` names the encode style a published
    tokenizer would take (``STYLES``), which the byte ids do not depend
    on."""
    if style not in STYLES:
        raise ValueError(f"unknown frontend style {style!r} (choose from {STYLES})")
    for cand in (Path(assets_dir) / "tokenizer.json",
                 Path(assets_dir) / "weights" / "tokenizer.json"):
        if cand.exists():
            raise NotImplementedError(
                f"{cand}: published tokenizers are not ported yet; the "
                "port encodes with the byte frontend only"
            )
    if text_vocab != BYTE_VOCAB_SIZE:
        raise ValueError(
            f"text embedding has {text_vocab} rows but the byte frontend "
            f"needs {BYTE_VOCAB_SIZE}"
        )
    return ByteFrontend()


__all__ = ["BYTE_VOCAB_SIZE", "BYTE_BOS", "STYLES", "ByteFrontend", "build_prompt_ids",
           "load_frontend", "text_to_byte_ids"]
