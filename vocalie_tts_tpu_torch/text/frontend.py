"""Byte frontend for the Chatterbox-class LM (copy of the JAX package's
``ByteFrontend`` and its byte ids from ``text/phonemes.py``).

A published ``tokenizer.json`` staged beside converted weights is not
handled by the port yet: :func:`load_frontend` refuses it instead of
silently encoding with the wrong ids.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

BYTE_VOCAB_SIZE = 256 + 4
BYTE_PAD, BYTE_BOS, BYTE_EOS, BYTE_SEP = 256, 257, 258, 259


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


def load_frontend(assets_dir: str | Path, *, text_vocab: int) -> ByteFrontend:
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


__all__ = ["BYTE_VOCAB_SIZE", "BYTE_BOS", "ByteFrontend", "load_frontend", "text_to_byte_ids"]
