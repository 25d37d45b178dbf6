"""Text frontend: text/phoneme <-> id-sequence conversion.

Capability parity with Mozilla TTS's TTS/tts/utils/text/__init__.py:
``text_to_sequence`` (l.73), ``phoneme_to_sequence`` (l.26),
``sequence_to_text`` (l.110), curly-brace ARPAbet passthrough (l.110-140),
custom character sets via ``make_symbols``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

from tts_tpu_torch.text import cleaners as _cleaners
from tts_tpu_torch.text import symbols as _sym
from tts_tpu_torch.text.cmudict import arpabet_to_ipa
from tts_tpu_torch.text.phonemize import text2phone

_CURLY_RE = re.compile(r"(.*?)\{(.+?)\}(.*)")

_symbol_to_id: Dict[str, int] = {s: i for i, s in enumerate(_sym.symbols)}
_id_to_symbol: Dict[int, str] = {i: s for i, s in enumerate(_sym.symbols)}
_phoneme_to_id: Dict[str, int] = {s: i for i, s in enumerate(_sym.phonemes)}
_id_to_phoneme: Dict[int, str] = {i: s for i, s in enumerate(_sym.phonemes)}


def make_charmaps(symbols: Sequence[str], phonemes: Sequence[str]):
    """Build id maps for a custom character set (tp dicts usable via tp= arg)."""
    return (
        {s: i for i, s in enumerate(symbols)},
        {i: s for i, s in enumerate(symbols)},
        {s: i for i, s in enumerate(phonemes)},
        {i: s for i, s in enumerate(phonemes)},
    )


def _should_keep(s: str, table: Dict[str, int]) -> bool:
    return s in table and s not in ("_", "~")


def _symbols_to_ids(syms: str, table: Dict[str, int]) -> List[int]:
    return [table[s] for s in syms if _should_keep(s, table)]


def _arpabet_to_ids(arpa: str, table: Dict[str, int]) -> List[int]:
    # grapheme tables store phonemes with an '@' prefix (symbols.make_symbols)
    ipa = arpabet_to_ipa(arpa.split())
    out = []
    for ch in ipa:
        if "@" + ch in table:
            out.append(table["@" + ch])
        elif _should_keep(ch, table):
            out.append(table[ch])
    return out


def clean_text(text: str, cleaner_names) -> str:
    if isinstance(cleaner_names, str):
        cleaner_names = [cleaner_names]
    for name in cleaner_names:
        text = _cleaners.get_cleaner(name)(text)
    return text


def text_to_sequence(
    text: str,
    cleaner_names,
    tp: Optional[Dict[str, int]] = None,
) -> List[int]:
    """Clean text and convert to grapheme ids; '{...}' spans are ARPAbet."""
    table = tp or _symbol_to_id
    sequence: List[int] = []
    while text:
        m = _CURLY_RE.match(text)
        if not m:
            sequence += _symbols_to_ids(clean_text(text, cleaner_names), table)
            break
        sequence += _symbols_to_ids(clean_text(m.group(1), cleaner_names), table)
        sequence += _arpabet_to_ids(m.group(2), table)
        text = m.group(3)
    return sequence


def phoneme_to_sequence(
    text: str,
    cleaner_names,
    language: str = "en-us",
    enable_eos_bos: bool = False,
    tp: Optional[Dict[str, int]] = None,
    backend: str = "auto",
) -> List[int]:
    """Clean text, phonemize, convert to phoneme ids (+ optional bos/eos)."""
    table = tp or _phoneme_to_id
    sequence: List[int] = []
    cleaned = clean_text(text, cleaner_names)
    while cleaned:
        m = _CURLY_RE.match(cleaned)
        if not m:
            phonemes = text2phone(cleaned, language, backend=backend)
            sequence += _symbols_to_ids(phonemes, table)
            break
        if m.group(1):
            sequence += _symbols_to_ids(
                text2phone(m.group(1), language, backend=backend), table)
        sequence += _symbols_to_ids(arpabet_to_ipa(m.group(2).split()), table)
        cleaned = m.group(3)
    if enable_eos_bos:
        sequence = pad_with_eos_bos(sequence, tp=table)
    return sequence


def pad_with_eos_bos(sequence: List[int], tp: Optional[Dict[str, int]] = None) -> List[int]:
    table = tp or _phoneme_to_id
    return [table[_sym.bos]] + list(sequence) + [table[_sym.eos]]


def sequence_to_text(sequence: Sequence[int], tp: Optional[Dict[int, str]] = None,
                     use_phonemes: bool = False) -> str:
    table = tp or (_id_to_phoneme if use_phonemes else _id_to_symbol)
    return "".join(table.get(int(i), "") for i in sequence)


def num_symbols(use_phonemes: bool = False) -> int:
    return len(_sym.phonemes) if use_phonemes else len(_sym.symbols)
