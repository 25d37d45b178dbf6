"""Built-in English pronunciation lexicon (ARPAbet) for the no-espeak path.

The rule-based letter-to-sound fallback (phonemize.py) is weakest exactly on
the highest-frequency words — function words and irregulars whose spelling
diverged from pronunciation centuries ago ("one", "of", "was", "said").
This module ships a core ARPAbet lexicon consulted BEFORE the rules, in the
spirit of the reference's CMUDict path
(Mozilla TTS's TTS/tts/utils/text/cmudict.py:1-78); users can extend or
override it with a full cmudict file via ``load_user_lexicon``.

Entries use CMUdict conventions (stress digits on vowels)."""

from __future__ import annotations

from typing import Dict, List, Optional

from tts_tpu_torch.text.cmudict import CMUDict, arpabet_to_ipa

# fmt: off
_CORE = {
    # articles / pronouns / function words
    "a": "AH0", "an": "AE1 N", "the": "DH AH0", "of": "AH1 V",
    "to": "T UW1", "in": "IH0 N", "and": "AH0 N D", "is": "IH1 Z",
    "it": "IH1 T", "you": "Y UW1", "that": "DH AE1 T", "he": "HH IY1",
    "she": "SH IY1", "was": "W AA1 Z", "for": "F AO1 R", "on": "AA1 N",
    "are": "AA1 R", "as": "AE1 Z", "with": "W IH1 DH", "his": "HH IH1 Z",
    "they": "DH EY1", "i": "AY1", "at": "AE1 T", "be": "B IY1",
    "this": "DH IH1 S", "have": "HH AE1 V", "from": "F R AH1 M",
    "or": "AO1 R", "had": "HH AE1 D", "by": "B AY1", "but": "B AH1 T",
    "what": "W AH1 T", "some": "S AH1 M", "we": "W IY1", "can": "K AE1 N",
    "out": "AW1 T", "other": "AH1 DH ER0", "were": "W ER1",
    "all": "AO1 L", "there": "DH EH1 R", "when": "W EH1 N",
    "your": "Y AO1 R", "how": "HH AW1", "each": "IY1 CH",
    "which": "W IH1 CH", "do": "D UW1", "their": "DH EH1 R",
    "if": "IH1 F", "will": "W IH1 L", "up": "AH1 P", "about": "AH0 B AW1 T",
    "then": "DH EH1 N", "them": "DH EH1 M", "these": "DH IY1 Z",
    "so": "S OW1", "her": "HH ER1", "would": "W UH1 D",
    "like": "L AY1 K", "him": "HH IH1 M", "into": "IH1 N T UW0",
    "has": "HH AE1 Z", "more": "M AO1 R", "two": "T UW1",
    "go": "G OW1", "no": "N OW1", "way": "W EY1", "could": "K UH1 D",
    "my": "M AY1", "than": "DH AE1 N", "been": "B IH1 N",
    "who": "HH UW1", "its": "IH1 T S", "now": "N AW1",
    "did": "D IH1 D", "get": "G EH1 T", "come": "K AH1 M",
    "made": "M EY1 D", "may": "M EY1", "said": "S EH1 D",
    "also": "AO1 L S OW0", "does": "D AH1 Z", "any": "EH1 N IY0",
    "our": "AW1 ER0", "us": "AH1 S", "me": "M IY1", "here": "HH IY1 R",
    "should": "SH UH1 D", "because": "B IH0 K AO1 Z",
    "very": "V EH1 R IY0", "through": "TH R UW1", "just": "JH AH1 S T",
    "where": "W EH1 R", "much": "M AH1 CH", "before": "B IH0 F AO1 R",
    "too": "T UW1", "again": "AH0 G EH1 N", "once": "W AH1 N S",
    "why": "W AY1", "after": "AE1 F T ER0", "only": "OW1 N L IY0",
    "most": "M OW1 S T", "over": "OW1 V ER0", "such": "S AH1 CH",
    "many": "M EH1 N IY0", "both": "B OW1 TH", "down": "D AW1 N",
    "being": "B IY1 IH0 NG", "those": "DH OW1 Z", "while": "W AY1 L",
    "might": "M AY1 T", "every": "EH1 V ER0 IY0", "never": "N EH1 V ER0",
    "another": "AH0 N AH1 DH ER0", "between": "B IH0 T W IY1 N",
    "under": "AH1 N D ER0", "against": "AH0 G EH1 N S T",
    "during": "D UH1 R IH0 NG", "without": "W IH0 TH AW1 T",
    "toward": "T AH0 W AO1 R D", "towards": "T AH0 W AO1 R D Z",
    "around": "ER0 AW1 N D", "among": "AH0 M AH1 NG",
    "though": "DH OW1", "although": "AO0 L DH OW1",
    "enough": "IH0 N AH1 F", "always": "AO1 L W EY0 Z",
    "together": "T AH0 G EH1 DH ER0", "often": "AO1 F AH0 N",
    "however": "HH AW2 EH1 V ER0", "anything": "EH1 N IY0 TH IH2 NG",
    "nothing": "N AH1 TH IH0 NG", "something": "S AH1 M TH IH0 NG",
    "everything": "EH1 V R IY0 TH IH2 NG", "someone": "S AH1 M W AH2 N",
    "everyone": "EH1 V R IY0 W AH2 N", "anyone": "EH1 N IY0 W AH2 N",
    # numbers
    "zero": "Z IY1 R OW0", "one": "W AH1 N", "three": "TH R IY1",
    "four": "F AO1 R", "five": "F AY1 V", "six": "S IH1 K S",
    "seven": "S EH1 V AH0 N", "eight": "EY1 T", "nine": "N AY1 N",
    "ten": "T EH1 N", "eleven": "IH0 L EH1 V AH0 N",
    "twelve": "T W EH1 L V", "thirteen": "TH ER1 T IY1 N",
    "twenty": "T W EH1 N T IY0", "thirty": "TH ER1 T IY0",
    "forty": "F AO1 R T IY0", "fifty": "F IH1 F T IY0",
    "sixty": "S IH1 K S T IY0", "seventy": "S EH1 V AH0 N T IY0",
    "eighty": "EY1 T IY0", "ninety": "N AY1 N T IY0",
    "hundred": "HH AH1 N D R AH0 D", "thousand": "TH AW1 Z AH0 N D",
    "million": "M IH1 L Y AH0 N", "billion": "B IH1 L Y AH0 N",
    "first": "F ER1 S T", "second": "S EH1 K AH0 N D",
    "third": "TH ER1 D", "half": "HH AE1 F",
    # common verbs (incl. irregular forms)
    "say": "S EY1", "says": "S EH1 Z", "see": "S IY1", "saw": "S AO1",
    "seen": "S IY1 N", "know": "N OW1", "knew": "N UW1",
    "known": "N OW1 N", "take": "T EY1 K", "took": "T UH1 K",
    "taken": "T EY1 K AH0 N", "think": "TH IH1 NG K",
    "thought": "TH AO1 T", "make": "M EY1 K", "give": "G IH1 V",
    "gave": "G EY1 V", "given": "G IH1 V AH0 N", "find": "F AY1 N D",
    "found": "F AW1 N D", "tell": "T EH1 L", "told": "T OW1 L D",
    "become": "B IH0 K AH1 M", "became": "B IH0 K EY1 M",
    "show": "SH OW1", "leave": "L IY1 V", "left": "L EH1 F T",
    "feel": "F IY1 L", "felt": "F EH1 L T", "put": "P UH1 T",
    "bring": "B R IH1 NG", "brought": "B R AO1 T",
    "begin": "B IH0 G IH1 N", "began": "B IH0 G AE1 N",
    "keep": "K IY1 P", "kept": "K EH1 P T", "hold": "HH OW1 L D",
    "held": "HH EH1 L D", "write": "R AY1 T", "wrote": "R OW1 T",
    "written": "R IH1 T AH0 N", "stand": "S T AE1 N D",
    "stood": "S T UH1 D", "hear": "HH IY1 R", "heard": "HH ER1 D",
    "let": "L EH1 T", "mean": "M IY1 N", "meant": "M EH1 N T",
    "set": "S EH1 T", "meet": "M IY1 T", "met": "M EH1 T",
    "run": "R AH1 N", "ran": "R AE1 N", "pay": "P EY1",
    "paid": "P EY1 D", "sit": "S IH1 T", "sat": "S AE1 T",
    "speak": "S P IY1 K", "spoke": "S P OW1 K",
    "spoken": "S P OW1 K AH0 N", "lie": "L AY1", "lay": "L EY1",
    "lead": "L IY1 D", "led": "L EH1 D", "read": "R IY1 D",
    "grow": "G R OW1", "grew": "G R UW1", "grown": "G R OW1 N",
    "lose": "L UW1 Z", "lost": "L AO1 S T", "fall": "F AO1 L",
    "fell": "F EH1 L", "fallen": "F AA1 L AH0 N", "send": "S EH1 N D",
    "sent": "S EH1 N T", "build": "B IH1 L D", "built": "B IH1 L T",
    "understand": "AH2 N D ER0 S T AE1 N D",
    "understood": "AH2 N D ER0 S T UH1 D", "draw": "D R AO1",
    "drew": "D R UW1", "drawn": "D R AO1 N", "break": "B R EY1 K",
    "broke": "B R OW1 K", "broken": "B R OW1 K AH0 N",
    "spend": "S P EH1 N D", "spent": "S P EH1 N T", "cut": "K AH1 T",
    "rise": "R AY1 Z", "rose": "R OW1 Z", "risen": "R IH1 Z AH0 N",
    "drive": "D R AY1 V", "drove": "D R OW1 V",
    "driven": "D R IH1 V AH0 N", "buy": "B AY1", "bought": "B AO1 T",
    "wear": "W EH1 R", "wore": "W AO1 R", "worn": "W AO1 R N",
    "choose": "CH UW1 Z", "chose": "CH OW1 Z",
    "chosen": "CH OW1 Z AH0 N", "eat": "IY1 T", "ate": "EY1 T",
    "eaten": "IY1 T AH0 N", "catch": "K AE1 CH", "caught": "K AO1 T",
    "teach": "T IY1 CH", "taught": "T AO1 T", "throw": "TH R OW1",
    "threw": "TH R UW1", "thrown": "TH R OW1 N", "fly": "F L AY1",
    "flew": "F L UW1", "flown": "F L OW1 N", "fight": "F AY1 T",
    "fought": "F AO1 T", "sell": "S EH1 L", "sold": "S OW1 L D",
    "done": "D AH1 N", "gone": "G AO1 N", "went": "W EH1 N T",
    "came": "K EY1 M", "got": "G AA1 T", "gotten": "G AA1 T AH0 N",
    "move": "M UW1 V", "live": "L IH1 V", "lives": "L IH1 V Z",
    "give": "G IH1 V", "love": "L AH1 V", "have": "HH AE1 V",
    "having": "HH AE1 V IH0 NG", "doing": "D UW1 IH0 NG",
    "going": "G OW1 IH0 NG", "being": "B IY1 IH0 NG",
    "getting": "G EH1 T IH0 NG", "coming": "K AH1 M IH0 NG",
    "making": "M EY1 K IH0 NG", "taking": "T EY1 K IH0 NG",
    "using": "Y UW1 Z IH0 NG", "used": "Y UW1 Z D", "use": "Y UW1 Z",
    "called": "K AO1 L D", "call": "K AO1 L", "ask": "AE1 S K",
    "asked": "AE1 S K T", "need": "N IY1 D", "want": "W AA1 N T",
    "wanted": "W AA1 N T IH0 D", "turn": "T ER1 N",
    "turned": "T ER1 N D", "start": "S T AA1 R T", "help": "HH EH1 L P",
    "talk": "T AO1 K", "walk": "W AO1 K", "walked": "W AO1 K T",
    "look": "L UH1 K", "looked": "L UH1 K T", "work": "W ER1 K",
    "worked": "W ER1 K T", "seem": "S IY1 M", "seemed": "S IY1 M D",
    "listen": "L IH1 S AH0 N", "answer": "AE1 N S ER0",
    # common nouns / adjectives with irregular spelling
    "people": "P IY1 P AH0 L", "time": "T AY1 M", "year": "Y IH1 R",
    "years": "Y IH1 R Z", "day": "D EY1", "man": "M AE1 N",
    "men": "M EH1 N", "woman": "W UH1 M AH0 N", "women": "W IH1 M AH0 N",
    "child": "CH AY1 L D", "children": "CH IH1 L D R AH0 N",
    "world": "W ER1 L D", "life": "L AY1 F", "hand": "HH AE1 N D",
    "part": "P AA1 R T", "place": "P L EY1 S", "case": "K EY1 S",
    "week": "W IY1 K", "company": "K AH1 M P AH0 N IY0",
    "system": "S IH1 S T AH0 M", "program": "P R OW1 G R AE2 M",
    "question": "K W EH1 S CH AH0 N", "government": "G AH1 V ER0 M AH0 N T",
    "number": "N AH1 M B ER0", "night": "N AY1 T", "point": "P OY1 N T",
    "home": "HH OW1 M", "water": "W AO1 T ER0", "room": "R UW1 M",
    "mother": "M AH1 DH ER0", "father": "F AA1 DH ER0",
    "brother": "B R AH1 DH ER0", "daughter": "D AO1 T ER0",
    "area": "EH1 R IY0 AH0", "money": "M AH1 N IY0",
    "story": "S T AO1 R IY0", "fact": "F AE1 K T", "month": "M AH1 N TH",
    "lot": "L AA1 T", "right": "R AY1 T", "study": "S T AH1 D IY0",
    "book": "B UH1 K", "eye": "AY1", "eyes": "AY1 Z", "job": "JH AA1 B",
    "word": "W ER1 D", "words": "W ER1 D Z", "business": "B IH1 Z N AH0 S",
    "issue": "IH1 SH UW0", "side": "S AY1 D", "kind": "K AY1 N D",
    "head": "HH EH1 D", "house": "HH AW1 S", "friend": "F R EH1 N D",
    "friends": "F R EH1 N D Z", "hour": "AW1 ER0", "hours": "AW1 ER0 Z",
    "minute": "M IH1 N AH0 T", "heart": "HH AA1 R T",
    "door": "D AO1 R", "floor": "F L AO1 R", "body": "B AA1 D IY0",
    "music": "M Y UW1 Z IH0 K", "machine": "M AH0 SH IY1 N",
    "language": "L AE1 NG G W AH0 JH", "science": "S AY1 AH0 N S",
    "voice": "V OY1 S", "speech": "S P IY1 CH", "sound": "S AW1 N D",
    "earth": "ER1 TH", "ocean": "OW1 SH AH0 N", "island": "AY1 L AH0 N D",
    "mountain": "M AW1 N T AH0 N", "weather": "W EH1 DH ER0",
    "beautiful": "B Y UW1 T AH0 F AH0 L", "busy": "B IH1 Z IY0",
    "easy": "IY1 Z IY0", "early": "ER1 L IY0", "young": "Y AH1 NG",
    "great": "G R EY1 T", "good": "G UH1 D", "new": "N UW1",
    "old": "OW1 L D", "high": "HH AY1", "small": "S M AO1 L",
    "large": "L AA1 R JH", "long": "L AO1 NG", "little": "L IH1 T AH0 L",
    "own": "OW1 N", "sure": "SH UH1 R", "whole": "HH OW1 L",
    "different": "D IH1 F ER0 AH0 N T", "important": "IH0 M P AO1 R T AH0 N T",
    "certain": "S ER1 T AH0 N", "special": "S P EH1 SH AH0 L",
    "true": "T R UW1", "public": "P AH1 B L IH0 K",
    "able": "EY1 B AH0 L", "possible": "P AA1 S AH0 B AH0 L",
    "several": "S EH1 V R AH0 L", "national": "N AE1 SH AH0 N AH0 L",
    "real": "R IY1 L", "really": "R IH1 L IY0", "quite": "K W AY1 T",
    "today": "T AH0 D EY1", "tomorrow": "T AH0 M AA1 R OW2",
    "yesterday": "Y EH1 S T ER0 D EY2", "morning": "M AO1 R N IH0 NG",
    "evening": "IY1 V N IH0 NG", "please": "P L IY1 Z",
    "thank": "TH AE1 NG K", "thanks": "TH AE1 NG K S",
    "hello": "HH AH0 L OW1", "goodbye": "G UH2 D B AY1",
    "yes": "Y EH1 S", "maybe": "M EY1 B IY0", "okay": "OW2 K EY1",
    "mister": "M IH1 S T ER0", "misses": "M IH1 S IH0 Z",
    "doctor": "D AA1 K T ER0", "england": "IH1 NG G L AH0 N D",
    "english": "IH1 NG G L IH0 SH", "america": "AH0 M EH1 R AH0 K AH0",
    "english": "IH1 NG G L IH0 SH", "once": "W AH1 N S",
    "iron": "AY1 ER0 N", "answer": "AE1 N S ER0", "often": "AO1 F AH0 N",
    "colonel": "K ER1 N AH0 L", "wednesday": "W EH1 N Z D EY2",
    "february": "F EH1 B Y AH0 W EH2 R IY0", "clothes": "K L OW1 DH Z",
    "comfortable": "K AH1 M F T ER0 B AH0 L", "stomach": "S T AH1 M AH0 K",
    "recipe": "R EH1 S AH0 P IY0", "choir": "K W AY1 ER0",
    "queue": "K Y UW1", "debt": "D EH1 T", "doubt": "D AW1 T",
    "subtle": "S AH1 T AH0 L", "castle": "K AE1 S AH0 L",
    "listen": "L IH1 S AH0 N", "island": "AY1 L AH0 N D",
    "heights": "HH AY1 T S", "height": "HH AY1 T",
    "weight": "W EY1 T", "neighbor": "N EY1 B ER0",
    "through": "TH R UW1", "thorough": "TH ER1 OW0",
    "cough": "K AO1 F", "rough": "R AH1 F", "tough": "T AH1 F",
    "laugh": "L AE1 F", "daughter": "D AO1 T ER0",
    "honest": "AA1 N AH0 S T", "honor": "AA1 N ER0",
    "ghost": "G OW1 S T", "whom": "HH UW1 M", "whose": "HH UW1 Z",
}
# fmt: on


class Lexicon:
    """IPA lookup table: built-in core entries + optional user cmudict."""

    def __init__(self) -> None:
        self._ipa: Dict[str, str] = {
            w: arpabet_to_ipa(a.split()) for w, a in _CORE.items()}

    def lookup(self, word: str) -> Optional[str]:
        return self._ipa.get(word.lower())

    def load_cmudict(self, path: str) -> int:
        """Extend/override from a cmudict-format file; returns entry count."""
        cmu = CMUDict(path)
        n = 0
        for word, prons in cmu.entries.items():
            self._ipa[word.lower()] = arpabet_to_ipa(prons[0].split())
            n += 1
        return n

    def __len__(self) -> int:
        return len(self._ipa)


_default: Optional[Lexicon] = None


def default_lexicon() -> Lexicon:
    global _default
    if _default is None:
        _default = Lexicon()
    return _default


def load_user_lexicon(path: str) -> int:
    """Merge a user cmudict file into the default lexicon."""
    return default_lexicon().load_cmudict(path)
