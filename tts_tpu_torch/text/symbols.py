"""Symbol tables for text/phoneme sequences.

Capability parity with Mozilla TTS's TTS/tts/utils/text/symbols.py:8-38:
grapheme + IPA-phoneme inventories, pad/eos/bos markers, and
``make_symbols`` for custom character sets supplied via config.
"""

from typing import List, Optional, Tuple

_pad = "_"
_eos = "~"
_bos = "^"
_characters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz!'(),-.:;? "
_punctuations = "!'(),-.:;? "

# IPA phoneme inventory (vowels / non-pulmonic + pulmonic consonants /
# suprasegmentals / diacritics), deduplicated into a stable ordering.
_vowels = "iyɨʉɯuɪʏʊeøɘəɵɤoɛœɜɞʌɔæɐaɶɑɒᵻ"
_non_pulmonic_consonants = "ʘɓǀɗǃʄǂɠǁʛ"
_pulmonic_consonants = "pbtdʈɖcɟkɡqɢʔɴŋɲɳnɱmʙrʀⱱɾɽɸβfvθðszʃʒʂʐçʝxɣχʁħʕhɦɬɮʋɹɻjɰlɭʎʟ"
_suprasegmentals = "ˈˌːˑ"
_other_symbols = "ʍwɥʜʢʡɕʑɺɧ"
_diacritics = "ɚ˞ɫ"
_phonemes = (
    _vowels
    + _non_pulmonic_consonants
    + _pulmonic_consonants
    + _suprasegmentals
    + _other_symbols
    + _diacritics
)


def make_symbols(
    characters: str,
    phonemes_chars: Optional[str] = None,
    punctuations: str = _punctuations,
    pad: str = _pad,
    eos: str = _eos,
    bos: str = _bos,
) -> Tuple[List[str], List[str]]:
    """Build (symbols, phoneme_symbols) from a custom character set
    (≙ make_symbols, symbols.py:8-19)."""
    syms = [pad, eos, bos] + list(characters)
    phoneme_syms: List[str] = []
    if phonemes_chars is not None:
        sorted_phonemes = sorted(set(phonemes_chars))
        syms = syms + [f"@{p}" for p in sorted_phonemes]
        phoneme_syms = [pad, eos, bos] + sorted_phonemes + sorted(set(punctuations))
    return syms, phoneme_syms


symbols, phonemes = make_symbols(_characters, _phonemes, _punctuations)

pad = _pad
eos = _eos
bos = _bos
