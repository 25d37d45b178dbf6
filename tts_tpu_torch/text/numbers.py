"""English number normalization (inflect-free pure Python).

Capability parity with Mozilla TTS's TTS/tts/utils/text/number_norm.py:
expands ordinals, cardinals, decimals, currency ($), and years.
"""

from __future__ import annotations

import re

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
         "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
         "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10**12, "trillion"), (10**9, "billion"), (10**6, "million"),
           (10**3, "thousand"), (10**2, "hundred")]

_ORDINAL_ONES = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, o = divmod(n, 10)
        return _TENS[t] + ("" if o == 0 else " " + _ONES[o])
    for scale, name in _SCALES:
        if n >= scale:
            major, rest = divmod(n, scale)
            out = number_to_words(major) + " " + name
            if rest:
                out += " " + number_to_words(rest)
            return out
    return _ONES[0]


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    if last in _ORDINAL_ONES:
        last = _ORDINAL_ONES[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return (head + " " + last).strip()


_comma_number_re = re.compile(r"([0-9][0-9,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9.,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _remove_commas(m: re.Match) -> str:
    return m.group(1).replace(",", "")


def _expand_decimal(m: re.Match) -> str:
    whole, frac = m.group(1).split(".")
    return number_to_words(int(whole)) + " point " + " ".join(
        _ONES[int(d)] for d in frac)


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1).replace(",", "")
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        d_unit = "dollar" if dollars == 1 else "dollars"
        c_unit = "cent" if cents == 1 else "cents"
        return (f"{number_to_words(dollars)} {d_unit}, "
                f"{number_to_words(cents)} {c_unit}")
    if dollars:
        return f"{number_to_words(dollars)} " + ("dollar" if dollars == 1 else "dollars")
    if cents:
        return f"{number_to_words(cents)} " + ("cent" if cents == 1 else "cents")
    return "zero dollars"


def _expand_ordinal(m: re.Match) -> str:
    return ordinal_to_words(int(m.group(0)[:-2]))


def _expand_number(m: re.Match) -> str:
    n = int(m.group(0))
    # year-style reading for 4-digit numbers (matching inflect year grouping)
    if 1000 < n < 3000:
        if n == 2000:
            return "two thousand"
        if 2000 < n < 2010:
            return "two thousand " + number_to_words(n % 100)
        if n % 100 == 0:
            return number_to_words(n // 100) + " hundred"
        head = number_to_words(n // 100)
        tail = number_to_words(n % 100)
        if n % 100 < 10:
            tail = "oh " + tail
        return f"{head} {tail}"
    return number_to_words(n)


def normalize_numbers(text: str) -> str:
    text = _comma_number_re.sub(_remove_commas, text)
    text = _pounds_re.sub(r"\1 pounds", text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_number_re.sub(_expand_decimal, text)
    text = _ordinal_re.sub(_expand_ordinal, text)
    text = _number_re.sub(_expand_number, text)
    return text
