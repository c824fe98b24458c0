"""French grapheme-to-phoneme conversion for the VITS-class engine (the
port's copy of ``vocalie_tts_tpu/text/phonemes.py``, pure Python).

A deterministic rule-based French G2P over an IPA-ish phone set, built
from three layers:

1. an exception lexicon (``data/g2p_lexicon_fr.json``, a copy of the JAX
   package's) for the high-frequency irregulars rules cannot reach
   (monsieur, femme, est/et, six/dix, -er nouns, …);
2. orthographic rules for the regular core (nasals, digraphs,
   closed-syllable ``e``, double consonants, silent finals);
3. cross-word liaison (z/t/n) and integer→words expansion
   ("25" → "vingt-cinq") at the sentence layer.

The byte ids of the LM-style engines keep their one definition in
``text/frontend.py``; this module re-exports them under the JAX module's
names.

Known limitation: third-person plural verb endings in ``-ent`` are
read as nasal /ɑ̃/ (indistinguishable from nouns like "vent" without
POS tagging); the lexicon carries the most frequent verb forms.
"""

from __future__ import annotations

import functools
import json
import re
import unicodedata
from pathlib import Path
from typing import Dict, List, Tuple

from vocalie_tts_tpu_torch.text.frontend import (
    BYTE_BOS,
    BYTE_EOS,
    BYTE_PAD,
    BYTE_SEP,
    BYTE_VOCAB_SIZE,
    text_to_byte_ids,
)

# ── phone inventory (French) ────────────────────────────────────────────

PHONES = [
    # special
    "_", "^", "$", " ",           # pad, bos, eos, word-break
    ".", ",", "?", "!",           # prosodic punctuation
    # oral vowels
    "a", "e", "E", "i", "o", "O", "u", "y", "2", "9", "@",
    # nasal vowels
    "a~", "E~", "o~", "9~",
    # glides
    "j", "w", "H",
    # consonants
    "p", "b", "t", "d", "k", "g", "f", "v", "s", "z",
    "S", "Z", "m", "n", "N", "l", "R",
]

PHONE_TO_ID: Dict[str, int] = {p: i for i, p in enumerate(PHONES)}
N_PHONES = len(PHONES)

# Multi-character graphemes, longest-first. Regular French rules.
_RULES: List[Tuple[str, str]] = [
    ("eaux", "o"), ("eau", "o"),
    ("aient", "E"), ("oient", "wa"),
    ("ouill", "uj"), ("euill", "9j"), ("aill", "aj"), ("eill", "Ej"), ("ill", "ij"),
    ("ouil$", "uj"), ("euil$", "9j"), ("ail$", "aj"), ("eil$", "Ej"),
    ("tion", "sjo~"), ("ssion", "sjo~"),
    ("ain", "E~"), ("aim", "E~"), ("ein", "E~"), ("eim", "E~"),
    ("oin", "wE~"),
    ("ien", "jE~"), ("yen", "jE~"),
    ("an", "a~"), ("am", "a~"), ("en", "a~"), ("em", "a~"),
    ("on", "o~"), ("om", "o~"),
    ("in", "E~"), ("im", "E~"), ("un", "9~"), ("um", "9~"), ("ym", "E~"), ("yn", "E~"),
    ("eau", "o"), ("au", "o"),
    ("oi", "wa"), ("oy", "waj"),
    ("ou", "u"),
    ("ui", "Hi"),
    ("ai", "E"), ("ei", "E"), ("ay", "Ej"),
    ("er$", "e"), ("ez$", "e"), ("et$", "E"),
    ("ch", "S"), ("ph", "f"), ("th", "t"), ("gn", "N"), ("qu", "k"), ("gu", "g"),
    ("ç", "s"),
    ("é", "e"), ("è", "E"), ("ê", "E"), ("ë", "E"),
    ("à", "a"), ("â", "a"), ("î", "i"), ("ï", "i"),
    ("ô", "o"), ("û", "y"), ("ù", "y"), ("ü", "y"),
    # double consonants collapse (the "ill" family already matched above)
    ("ss", "s"), ("ll", "l"), ("nn", "n"), ("mm", "m"), ("tt", "t"),
    ("rr", "R"), ("pp", "p"), ("ff", "f"), ("dd", "d"), ("bb", "b"),
    ("gg", "g"),
    # word-final x is silent (deux, prix, choix); elsewhere /ks/
    ("x$", ""), ("x", "ks"),
]

_FINAL_SILENT = set("bdgpstxz")  # typical silent finals
_CONSONANT_LETTERS = set("bcdfgjklmnpqrstvwxzçh")
_VOWEL_LETTERS = set("aeiouyàâäéèêëîïôöùûüœ")
_VOWEL_PHONES = {"a", "e", "E", "i", "o", "O", "u", "y", "2", "9", "@",
                 "a~", "E~", "o~", "9~"}

_DATA_DIR = Path(__file__).parent / "data"


@functools.lru_cache(maxsize=1)
def _lexicon() -> Dict[str, List[str]]:
    """Exception lexicon: word → phones (data/g2p_lexicon_fr.json)."""
    path = _DATA_DIR / "g2p_lexicon_fr.json"
    raw = json.loads(path.read_text(encoding="utf-8"))
    return {
        w: phones.split()
        for w, phones in raw.items()
        if not w.startswith("_")
    }


def _is_pronounced_final(w: str, i: int, n: int) -> bool:
    """Would the consonant at w[i] be pronounced if it ends the word?"""
    return not (i == n - 1 and w[i] in _FINAL_SILENT)


def _eu_phone(w: str, j: int, n: int) -> str:
    """Open/closed quality of eu/œu at position j (j = first char AFTER
    the grapheme): closed syllable (pronounced consonant then consonant
    or end or final mute e) → 9 /œ/ (neuf, heure, seul); open → 2 /ø/
    (deux, jeudi, peu)."""
    c = w[j] if j < n else ""
    if not c or c in _VOWEL_LETTERS:
        return "2"
    if c in "sxzt" and j == n - 1:
        return "2"  # silent final consonant → open (deux, veut, creux)
    c2 = w[j + 1] if j + 1 < n else ""
    if not c2:
        return "9"  # pronounced final consonant (neuf, seul)
    if c2 == "e" and j + 2 == n:
        return "9"  # consonant + final mute e (heure, jeune)
    if c2 in _VOWEL_LETTERS:
        return "2"  # open syllable (jeudi)
    return "9"


def _phonemize_word(word: str) -> List[str]:
    w = word.lower()
    lex = _lexicon()
    if w in lex:
        return list(lex[w])
    out: List[str] = []
    i = 0
    n = len(w)
    while i < n:
        # integer runs → French number words ("25" → "vingt-cinq")
        if w[i].isdigit():
            j = i
            while j < n and w[j].isdigit():
                j += 1
            out.extend(_phonemize_number(w[i:j]))
            i = j
            continue
        # eu / œu / oeu: open vs closed quality needs lookahead
        for grapheme in ("oeu", "œu", "eu", "œ"):
            if w.startswith(grapheme, i):
                out.append(_eu_phone(w, i + len(grapheme), n))
                i += len(grapheme)
                break
        else:
            grapheme = None
        if grapheme is not None:
            continue
        matched = False
        for pattern, phones in _RULES:
            if pattern.endswith("$"):
                pat = pattern[:-1]
                if w.endswith(pat) and i == n - len(pat):
                    out.extend(_split_phones(phones))
                    i = n
                    matched = True
                    break
                continue
            if w.startswith(pattern, i):
                # nasal rules don't apply before a vowel (e.g. "ami") or
                # a doubled nasal consonant (année, ennemi, comme)
                if pattern in {"an", "am", "en", "em", "on", "om", "in", "im",
                               "un", "um", "ym", "yn", "ain", "aim", "ein"}:
                    nxt = w[i + len(pattern) : i + len(pattern) + 1]
                    if nxt and (nxt in "aeiouyéèêâîôûh" or nxt == pattern[-1]):
                        continue
                out.extend(_split_phones(phones))
                i += len(pattern)
                matched = True
                break
        if matched:
            continue
        ch = w[i]
        nxt = w[i + 1] if i + 1 < n else ""
        nxt2 = w[i + 2] if i + 2 < n else ""
        if ch == "c":
            if nxt == "c":  # accident → ks, accord → k
                out.extend(["k", "s"] if (nxt2 and nxt2 in "eiyéè") else ["k"])
                i += 2
                continue
            out.append("s" if (nxt and nxt in "eiyéè") else "k")
        elif ch == "g":
            out.append("Z" if (nxt and nxt in "eiyéè") else "g")
        elif ch == "s":
            # intervocalic s → z (orthographic: "réponse" keeps /s/ —
            # the n is consumed by the nasal but still closes the s)
            prev_vowel = i > 0 and w[i - 1] in _VOWEL_LETTERS
            if prev_vowel and nxt and nxt in "aeiouyéèêâîôû":
                out.append("z")
            elif not (i == n - 1):  # final s silent
                out.append("s")
        elif ch == "e":
            if i == n - 1:
                pass  # final mute e
            elif i + 2 == n and nxt in _FINAL_SILENT:
                pass  # e + final silent consonant (pied, heures→"es")
            elif nxt in _CONSONANT_LETTERS and nxt == nxt2:
                out.append("E")  # before a double consonant (belle, cette)
            elif (
                nxt in _CONSONANT_LETTERS
                and nxt != "h"
                and (i + 2 == n or (nxt2 and nxt2 in _CONSONANT_LETTERS))
                and not (i + 2 == n and nxt in _FINAL_SILENT)
            ):
                out.append("E")  # closed syllable (avec, mercredi, espace)
            else:
                out.append("@")
        elif ch == "o":
            # open /ɔ/ in a closed syllable (porte, bonne→handled by nn),
            # closed /o/ word-finally, before silent finals, and before
            # /z/ (rose, chose)
            if (
                nxt in _CONSONANT_LETTERS
                and nxt != "h"
                and _is_pronounced_final(w, i + 1, n)
                and not (nxt == "s" and (not nxt2 or nxt2 in _VOWEL_LETTERS))
                and (i + 2 == n or (nxt2 and (nxt2 in _CONSONANT_LETTERS
                                              or (nxt2 == "e" and i + 3 == n))))
            ):
                out.append("O")
            else:
                out.append("o")
        elif ch == "h":
            pass  # h muet
        elif ch == "j":
            out.append("Z")
        elif ch == "y":
            out.append("i")
        elif ch == "r":
            out.append("R")
        elif ch == "w":
            out.append("w")
        elif ch == "i":
            # glide before a pronounced vowel (piano, amitié, janvier) —
            # but not before a final mute e / e+silent-s (vie, vies)
            if nxt and nxt in _VOWEL_LETTERS and not (
                nxt == "e"
                and (i + 2 == n or (i + 3 == n and nxt2 in "sxz"))
            ):
                out.append("j")
            else:
                out.append("i")
        elif ch == "u":
            # glide before a/o (nuage); ui is a digraph rule above
            out.append("H" if (nxt and nxt in "aâoô") else "y")
        elif ch == "a":
            out.append("a")
        elif ch in "bdfgklmnpqtvz":
            if i == n - 1 and ch in _FINAL_SILENT:
                pass  # silent final consonant
            elif i == n - 2 and nxt == "s" and ch in _FINAL_SILENT:
                pass  # silent final cluster before plural s (-ts, -ds)
            else:
                out.append({"q": "k"}.get(ch, ch))
        # anything else (apostrophes, dashes) is dropped
        i += 1
    return out


def _split_phones(s: str) -> List[str]:
    """Split a rule output like "sjo~" into phones ["s","j","o~"]."""
    phones = []
    i = 0
    while i < len(s):
        if i + 1 < len(s) and s[i + 1] == "~":
            phones.append(s[i : i + 2])
            i += 2
        else:
            phones.append(s[i])
            i += 1
    return phones


_UNITS = [
    "zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept",
    "huit", "neuf", "dix", "onze", "douze", "treize", "quatorze",
    "quinze", "seize", "dix-sept", "dix-huit", "dix-neuf",
]
_TENS = {20: "vingt", 30: "trente", 40: "quarante", 50: "cinquante",
         60: "soixante"}


def number_to_words_fr(num: int) -> str:
    """Integer → French words ("71" → "soixante et onze")."""
    if num < 0:
        return "moins " + number_to_words_fr(-num)
    if num < 20:
        return _UNITS[num]
    if num < 70:
        tens, rest = divmod(num, 10)
        base = _TENS[tens * 10]
        if rest == 0:
            return base
        if rest == 1:
            return f"{base} et un"
        return f"{base}-{_UNITS[rest]}"
    if num < 80:
        rest = num - 60
        return "soixante et onze" if rest == 11 else f"soixante-{_UNITS[rest]}"
    if num < 100:
        rest = num - 80
        return "quatre-vingts" if rest == 0 else f"quatre-vingt-{_UNITS[rest]}"
    if num < 1000:
        hundreds, rest = divmod(num, 100)
        base = "cent" if hundreds == 1 else f"{number_to_words_fr(hundreds)} cent"
        if rest == 0:
            return base + ("s" if hundreds > 1 else "")
        return f"{base} {number_to_words_fr(rest)}"
    if num < 1_000_000:
        thousands, rest = divmod(num, 1000)
        base = "mille" if thousands == 1 else f"{number_to_words_fr(thousands)} mille"
        return base if rest == 0 else f"{base} {number_to_words_fr(rest)}"
    millions, rest = divmod(num, 1_000_000)
    base = f"{number_to_words_fr(millions)} million" + ("s" if millions > 1 else "")
    return base if rest == 0 else f"{base} {number_to_words_fr(rest)}"


def _phonemize_number(digits: str) -> List[str]:
    """Digit run → phones of the French number words, with word breaks
    between words ("125" → "cent vingt-cinq")."""
    try:
        num = int(digits)
    except ValueError:
        return []
    if len(digits) > 9:
        # degenerate runs (ids, phone numbers): read digit by digit
        out: List[str] = []
        for d in digits:
            out.extend(_phonemize_word(_UNITS[int(d)]))
            out.append(" ")
        return out[:-1] if out else out
    words = re.split(r"[\s-]+", number_to_words_fr(num))
    out = []
    for k, word in enumerate(words):
        if k:
            out.append(" ")
        out.extend(_phonemize_word(word))
        # 22–29: the t of "vingt" is pronounced before the unit
        # (vingt-deux = vɛ̃tdø) — but not in 80–99 (quatre-vingt-dix)
        if (
            word == "vingt"
            and k + 1 < len(words)
            and (k == 0 or words[k - 1] != "quatre")
        ):
            out.append("t")
    return out


# Liaison: words whose (otherwise silent) final consonant surfaces
# before a vowel-initial word. Three frequent classes (espeak-ng makes
# the same mandatory liaisons): plural/frozen s·x → /z/, -t/-d → /t/,
# nasal -n → /n/. h-aspiré words (les héros) are not distinguished —
# a known simplification.
_LIAISON_Z = {
    "les", "des", "mes", "tes", "ses", "ces", "nos", "vos", "leurs",
    "aux", "deux", "trois", "six", "dix", "quelques", "plusieurs",
    "nous", "vous", "ils", "elles", "très", "plus", "sous", "chez",
    "dans", "sans", "temps",
}
_LIAISON_T = {"est", "sont", "ont", "fait", "tout", "cet", "quand",
              "petit", "grand", "vingt", "cent"}
_LIAISON_N = {"un", "on", "en", "mon", "ton", "son", "bien", "rien",
              "aucun"}


def _liaison_phone(word: str) -> str | None:
    if word in _LIAISON_Z:
        return "z"
    if word in _LIAISON_T:
        return "t"
    if word in _LIAISON_N:
        return "n"
    return None


def phonemize_fr(text: str) -> List[str]:
    """Text → phone sequence with word breaks, prosodic punctuation and
    cross-word liaison."""
    text = unicodedata.normalize("NFC", text or "")
    tokens = re.findall(r"[\w'’àâäéèêëîïôöùûüçœ-]+|[.,!?]", text, re.IGNORECASE)
    phones: List[str] = ["^"]
    for t_idx, token in enumerate(tokens):
        if token in {".", ",", "!", "?"}:
            if phones and phones[-1] == " ":
                phones.pop()
            phones.append(token)
            phones.append(" ")
            continue
        pieces = [p for p in re.split(r"[-'’]", token) if p]
        for piece in pieces:
            phones.extend(_phonemize_word(piece))
            phones.append(" ")
        # liaison off the token's last piece onto a vowel-initial word
        nxt = tokens[t_idx + 1] if t_idx + 1 < len(tokens) else ""
        if (
            pieces
            and nxt
            and nxt[0].lower() in _VOWEL_LETTERS | {"h"}
        ):
            liaison = _liaison_phone(pieces[-1].lower())
            if liaison == "z" and len(phones) >= 2 and phones[-2] == "s":
                phones[-2] = "z"  # six amis → si·z·ami (voiced in liaison)
            elif liaison and (len(phones) < 2 or phones[-2] != liaison):
                phones.insert(-1, liaison)
    while phones and phones[-1] == " ":
        phones.pop()
    phones.append("$")
    return phones


def phones_to_ids(phones: List[str]) -> List[int]:
    return [PHONE_TO_ID[p] for p in phones if p in PHONE_TO_ID]


def text_to_phone_ids(text: str) -> List[int]:
    return phones_to_ids(phonemize_fr(text))


__all__ = [
    "PHONES",
    "PHONE_TO_ID",
    "N_PHONES",
    "number_to_words_fr",
    "phonemize_fr",
    "phones_to_ids",
    "text_to_phone_ids",
    "BYTE_VOCAB_SIZE",
    "BYTE_PAD",
    "BYTE_BOS",
    "BYTE_EOS",
    "BYTE_SEP",
    "text_to_byte_ids",
]
