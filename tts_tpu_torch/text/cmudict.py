"""CMU pronouncing dictionary support + ARPAbet→IPA mapping.

Capability parity with Mozilla TTS's TTS/tts/utils/text/cmudict.py:1-78 and
the curly-brace ARPAbet passthrough (text/__init__.py:110-140 in the reference).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

VALID_SYMBOLS = [
    "AA", "AA0", "AA1", "AA2", "AE", "AE0", "AE1", "AE2", "AH", "AH0", "AH1",
    "AH2", "AO", "AO0", "AO1", "AO2", "AW", "AW0", "AW1", "AW2", "AY", "AY0",
    "AY1", "AY2", "B", "CH", "D", "DH", "EH", "EH0", "EH1", "EH2", "ER", "ER0",
    "ER1", "ER2", "EY", "EY0", "EY1", "EY2", "F", "G", "HH", "IH", "IH0",
    "IH1", "IH2", "IY", "IY0", "IY1", "IY2", "JH", "K", "L", "M", "N", "NG",
    "OW", "OW0", "OW1", "OW2", "OY", "OY0", "OY1", "OY2", "P", "R", "S", "SH",
    "T", "TH", "UH", "UH0", "UH1", "UH2", "UW", "UW0", "UW1", "UW2", "V", "W",
    "Y", "Z", "ZH",
]
_valid_symbol_set = set(VALID_SYMBOLS)

# base ARPAbet phone -> IPA
ARPA_TO_IPA: Dict[str, str] = {
    "AA": "ɑ", "AE": "æ", "AH": "ʌ", "AO": "ɔ", "AW": "aʊ", "AY": "aɪ",
    "B": "b", "CH": "tʃ", "D": "d", "DH": "ð", "EH": "ɛ", "ER": "ɚ",
    "EY": "eɪ", "F": "f", "G": "ɡ", "HH": "h", "IH": "ɪ", "IY": "i",
    "JH": "dʒ", "K": "k", "L": "l", "M": "m", "N": "n", "NG": "ŋ",
    "OW": "oʊ", "OY": "ɔɪ", "P": "p", "R": "ɹ", "S": "s", "SH": "ʃ",
    "T": "t", "TH": "θ", "UH": "ʊ", "UW": "u", "V": "v", "W": "w",
    "Y": "j", "Z": "z", "ZH": "ʒ",
}


def arpabet_to_ipa(phones: List[str]) -> str:
    """['HH','AH0','L','OW1'] -> 'hʌˈloʊ' (stress marks prepended per phone)."""
    out = []
    for p in phones:
        stress = ""
        base = p.upper()
        if base and base[-1].isdigit():
            if base[-1] == "1":
                stress = "ˈ"
            elif base[-1] == "2":
                stress = "ˌ"
            base = base[:-1]
        ipa = ARPA_TO_IPA.get(base)
        if ipa is None:
            continue
        out.append(stress + ipa)
    return "".join(out)


_alt_re = re.compile(r"\([0-9]+\)")


class CMUDict:
    """Parser for cmudict-format files; keeps only pure-ARPAbet entries."""

    def __init__(self, path_or_lines, keep_ambiguous: bool = True):
        if isinstance(path_or_lines, str):
            with open(path_or_lines, encoding="latin-1") as f:
                entries = _parse_cmudict(f)
        else:
            entries = _parse_cmudict(path_or_lines)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, word: str) -> Optional[List[str]]:
        """Pronunciations of ``word`` as space-separated ARPAbet strings."""
        return self._entries.get(word.upper())

    @staticmethod
    def get_arpabet(word: str, cmudict: "CMUDict", punctuation_symbols: str = "!?,.;:") -> str:
        """word -> '{ARPA ...}' if known, else the word itself."""
        first = word
        trailing = ""
        while first and first[-1] in punctuation_symbols:
            trailing = first[-1] + trailing
            first = first[:-1]
        pron = cmudict.lookup(first)
        if pron:
            return "{%s}%s" % (pron[0], trailing)
        return word


def _parse_cmudict(lines) -> Dict[str, List[str]]:
    entries: Dict[str, List[str]] = {}
    for line in lines:
        if len(line) and (line[0].isalpha() or line[0] == "'"):
            parts = line.split("  ")
            if len(parts) < 2:
                continue
            word = _alt_re.sub("", parts[0])
            pron = _get_pronunciation(parts[1])
            if pron:
                entries.setdefault(word, []).append(pron)
    return entries


def _get_pronunciation(s: str) -> Optional[str]:
    parts = s.strip().split(" ")
    for part in parts:
        if part not in _valid_symbol_set:
            return None
    return " ".join(parts)
