"""Text cleaner pipelines (≙ Mozilla TTS's TTS/tts/utils/text/cleaners.py).

Cleaners are composable string->string functions selected by name in the
config (``text_cleaner``). ``convert_to_ascii`` is a unidecode-free
transliteration (NFKD decomposition + a latin supplement table).
"""

from __future__ import annotations

import re
import unicodedata

from tts_tpu_torch.text.numbers import normalize_numbers

_whitespace_re = re.compile(r"\s+")

_abbreviations_en = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
        ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
        ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
        ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
        ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]

_abbreviations_fr = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("M", "monsieur"), ("Mlle", "mademoiselle"), ("Mlles", "mesdemoiselles"),
        ("Mme", "Madame"), ("Mmes", "Mesdames"), ("N\\.B", "nota bene"),
        ("p\\.c\\.q", "parce que"), ("Pr", "professeur"), ("qqch", "quelque chose"),
        ("rdv", "rendez-vous"), ("max", "maximum"), ("min", "minimum"),
        ("no", "numero"), ("adr", "adresse"), ("dr", "docteur"), ("st", "saint"),
        ("ex", "exemple"), ("av", "avenue"), ("bd", "boulevard"),
    ]
]

# latin-supplement transliteration beyond NFKD stripping
_TRANSLIT = {
    "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O",
    "ß": "ss", "þ": "th", "Þ": "Th", "ð": "d", "Ð": "D", "ł": "l", "Ł": "L",
    "đ": "d", "Đ": "D", "ı": "i", "İ": "I",
}


def expand_abbreviations(text: str, lang: str = "en") -> str:
    table = _abbreviations_en if lang == "en" else _abbreviations_fr
    for regex, replacement in table:
        text = regex.sub(replacement + " ", text)
    return text


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(" ", text).strip()


def convert_to_ascii(text: str) -> str:
    text = "".join(_TRANSLIT.get(ch, ch) for ch in text)
    nfkd = unicodedata.normalize("NFKD", text)
    return "".join(ch for ch in nfkd if ord(ch) < 128)


def replace_symbols(text: str) -> str:
    text = text.replace(";", ",").replace("-", " ").replace(":", ",")
    text = text.replace("&", " and ")
    return text


def remove_aux_symbols(text: str) -> str:
    return re.sub(r"[\<\>\(\)\[\]\"]+", "", text)


def basic_cleaners(text: str) -> str:
    """Lowercase + whitespace collapse; no transliteration."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def basic_german_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(text))


def basic_turkish_cleaners(text: str) -> str:
    text = text.replace("I", "ı")
    return collapse_whitespace(lowercase(text))


def english_cleaners(text: str) -> str:
    """Full English pipeline: ascii, numbers, abbreviations."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text, "en")
    return collapse_whitespace(text)


def french_cleaners(text: str) -> str:
    text = expand_abbreviations(text, "fr")
    text = lowercase(text)
    text = replace_symbols(text)
    text = remove_aux_symbols(text)
    return collapse_whitespace(text)


def portuguese_cleaners(text: str) -> str:
    text = lowercase(text)
    text = replace_symbols(text)
    text = remove_aux_symbols(text)
    return collapse_whitespace(text)


def phoneme_cleaners(text: str) -> str:
    """Pipeline applied before phonemization."""
    text = expand_numbers(text)
    text = convert_to_ascii(text)
    text = expand_abbreviations(text, "en")
    text = replace_symbols(text)
    text = remove_aux_symbols(text)
    return collapse_whitespace(text)


CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "basic_german_cleaners": basic_german_cleaners,
    "basic_turkish_cleaners": basic_turkish_cleaners,
    "english_cleaners": english_cleaners,
    "french_cleaners": french_cleaners,
    "portuguese_cleaners": portuguese_cleaners,
    "phoneme_cleaners": phoneme_cleaners,
}


def get_cleaner(name: str):
    if name not in CLEANERS:
        raise KeyError(f"unknown cleaner: {name}")
    return CLEANERS[name]
