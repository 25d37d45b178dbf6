"""Grapheme-to-phoneme conversion with punctuation preservation.

Capability parity with the reference's phonemizer/espeak path
(Mozilla TTS's TTS/tts/utils/text/__init__.py:26-58 ``text2phone``): an
espeak(-ng) subprocess backend when the binary exists, and a pure-Python
rule-based English G2P fallback so the framework works in hermetic
environments (espeak is a host subprocess in the reference too). Results are memoized; datasets additionally cache phoneme
ids to .npy files.
"""

from __future__ import annotations

import functools
import re
import shutil
import subprocess
from typing import List, Optional

PUNCT_RE = re.compile(r"([!'(),\-.:;? ]+)")


@functools.lru_cache(maxsize=1)
def espeak_binary() -> Optional[str]:
    for name in ("espeak-ng", "espeak"):
        path = shutil.which(name)
        if path:
            return path
    return None


def _espeak_phonemize(text: str, language: str) -> str:
    """One espeak subprocess call -> IPA string (no word separators kept)."""
    cmd = [espeak_binary(), "-q", "--ipa=3", "-v", language, text]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    ipa = out.stdout.strip().replace("_", "")
    return ipa.replace("\n", " ")


# ---------------------------------------------------------------------------
# Rule-based English letter-to-sound fallback.
# Longest-match context rules (grapheme cluster -> IPA), applied greedily.
# Coarse, but deterministic and dependency-free; quality users should install
# espeak or supply a CMUdict file.
# ---------------------------------------------------------------------------

_DIGRAPHS = [
    ("tion", "ʃʌn"), ("sion", "ʒʌn"), ("ture", "tʃɚ"), ("ought", "ɔt"),
    ("augh", "æf"), ("eigh", "eɪ"), ("igh", "aɪ"), ("tch", "tʃ"),
    ("dge", "dʒ"), ("sch", "sk"), ("ch", "tʃ"), ("sh", "ʃ"), ("th", "θ"),
    ("ph", "f"), ("wh", "w"), ("gh", "ɡ"), ("ck", "k"), ("ng", "ŋ"),
    ("qu", "kw"), ("kn", "n"), ("wr", "ɹ"), ("ee", "i"), ("ea", "i"),
    ("oo", "u"), ("ou", "aʊ"), ("ow", "oʊ"), ("ai", "eɪ"), ("ay", "eɪ"),
    ("oa", "oʊ"), ("oi", "ɔɪ"), ("oy", "ɔɪ"), ("au", "ɔ"), ("aw", "ɔ"),
    ("ew", "ju"), ("ue", "u"), ("ie", "i"), ("ei", "eɪ"), ("ar", "ɑɹ"),
    ("er", "ɚ"), ("ir", "ɚ"), ("ur", "ɚ"), ("or", "ɔɹ"), ("ll", "l"),
    ("ss", "s"), ("tt", "t"), ("pp", "p"), ("bb", "b"), ("dd", "d"),
    ("mm", "m"), ("nn", "n"), ("rr", "ɹ"), ("ff", "f"), ("gg", "ɡ"),
    ("zz", "z"), ("cc", "k"),
]

_SINGLE = {
    "a": "æ", "b": "b", "c": "k", "d": "d", "e": "ɛ", "f": "f", "g": "ɡ",
    "h": "h", "i": "ɪ", "j": "dʒ", "k": "k", "l": "l", "m": "m", "n": "n",
    "o": "ɑ", "p": "p", "q": "k", "r": "ɹ", "s": "s", "t": "t", "u": "ʌ",
    "v": "v", "w": "w", "x": "ks", "y": "j", "z": "z", "'": "",
}

_SOFT_C_V = set("eiy")


def _rule_g2p_word(word: str) -> str:
    w = word.lower()
    out: List[str] = []
    i = 0
    n = len(w)
    # final silent 'e' (magic e): lengthen previous vowel, drop the e
    magic_e = n >= 3 and w.endswith("e") and w[-2] not in "aeiou" and w[-3] in "aeiou"
    limit = n - 1 if magic_e else n
    long_vowel = {"a": "eɪ", "e": "i", "i": "aɪ", "o": "oʊ", "u": "ju"}
    while i < limit:
        matched = False
        for graph, ipa in _DIGRAPHS:
            if w.startswith(graph, i) and i + len(graph) <= limit:
                out.append(ipa)
                i += len(graph)
                matched = True
                break
        if matched:
            continue
        ch = w[i]
        if magic_e and i == n - 3 and ch in long_vowel:
            out.append(long_vowel[ch])
        elif ch == "c" and i + 1 < n and w[i + 1] in _SOFT_C_V:
            out.append("s")
        elif ch == "g" and i + 1 < n and w[i + 1] in _SOFT_C_V:
            out.append("dʒ")
        elif ch == "y" and (i == n - 1 or (i + 1 < n and w[i + 1] not in "aeiou")):
            out.append("i" if i == n - 1 else "ɪ")
        else:
            out.append(_SINGLE.get(ch, ch))
        i += 1
    return "".join(out)


_VOICELESS_FINAL = set("ptkfθsʃ")
_SIBILANT_FINAL = set("szʃʒ")


def _lexicon_morph(word: str) -> Optional[str]:
    """Lexicon lookup with regular-inflection morphology: plural/3sg -s,
    past -ed, progressive -ing, adverbial -ly derive from a known stem with
    the standard allophonic endings."""
    from tts_tpu_torch.text.lexicon import default_lexicon
    lex = default_lexicon()
    ipa = lex.lookup(word)
    if ipa is not None:
        return ipa
    w = word.lower()
    if len(w) > 2 and (w.endswith("'s") or
                       (w.endswith("s") and not w.endswith("ss"))):
        stem = w[:-2] if w.endswith("'s") else w[:-1]
        base = lex.lookup(stem)
        if base:
            if base[-1] in _SIBILANT_FINAL:
                return base + "ɪz"
            return base + ("s" if base[-1] in _VOICELESS_FINAL else "z")
    if len(w) > 3 and w.endswith("ed"):
        for stem in (w[:-2], w[:-1]):      # walked -> walk; loved -> love
            base = lex.lookup(stem)
            if base:
                if base[-1] in "td":
                    return base + "ɪd"
                return base + ("t" if base[-1] in _VOICELESS_FINAL else "d")
    if len(w) > 4 and w.endswith("ing"):
        for stem in (w[:-3], w[:-3] + "e"):  # asking -> ask; making -> make
            base = lex.lookup(stem)
            if base:
                return base + "ɪŋ"
    if len(w) > 3 and w.endswith("ly"):
        base = lex.lookup(w[:-2])
        if base:
            return base + "li"
    return None


def _no_espeak_word(word: str) -> str:
    """Lexicon-first G2P: the built-in ARPAbet core lexicon (text/lexicon.py,
    extendable with a user cmudict via load_user_lexicon) covers the
    high-frequency irregulars where letter-to-sound rules fail; unknown words
    fall through to the rules."""
    if not word:
        return word
    ipa = _lexicon_morph(word)
    if ipa is not None:
        return ipa
    return _rule_g2p_word(word)


def _rule_phonemize(text: str) -> str:
    parts = PUNCT_RE.split(text)
    return "".join(p if PUNCT_RE.fullmatch(p) else _no_espeak_word(p)
                   for p in parts)


@functools.lru_cache(maxsize=65536)
def text2phone(text: str, language: str = "en-us", backend: str = "auto") -> str:
    """Convert cleaned text to an IPA phoneme string, preserving punctuation.

    backend: 'auto' (espeak if present, else rules), 'espeak', or 'rules'.
    """
    if backend == "espeak" or (backend == "auto" and espeak_binary()):
        # phonemize chunks between punctuation separately so punctuation
        # positions survive (≙ reference punctuation re-insertion,
        # text/__init__.py:36-58)
        parts = PUNCT_RE.split(text)
        out = []
        for p in parts:
            if not p:
                continue
            if PUNCT_RE.fullmatch(p):
                out.append(p)
            else:
                out.append(_espeak_phonemize(p, language))
        return "".join(out)
    return _rule_phonemize(text)
