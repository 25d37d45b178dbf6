"""The port's copied text frontend, config loader and numpy audio against
tts_tpu's originals: identical outputs (exact equality; same code, same
numpy)."""

import glob
import os

import numpy as np
import pytest
import torch

from tts_tpu import text as jtext
from tts_tpu.audio.processor import AudioProcessor as JAudioProcessor
from tts_tpu.audio.processor import wav_to_bytes as j_wav_to_bytes
from tts_tpu.config import load_config as j_load_config
from tts_tpu.infer.synthesis import bucket_text_length as j_bucket
from tts_tpu.infer.synthesis import text_to_seqvec as j_seqvec
from tts_tpu_torch import text as ttext
from tts_tpu_torch.audio.processor import AudioProcessor as TAudioProcessor
from tts_tpu_torch.audio.processor import wav_to_bytes as t_wav_to_bytes
from tts_tpu_torch.config import load_config as t_load_config
from tts_tpu_torch.infer.synthesis import bucket_text_length as t_bucket
from tts_tpu_torch.infer.synthesis import text_to_seqvec as t_seqvec

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SENTENCES = [
    "Hello, world!",
    "The quick brown fox jumps over the lazy dog.",
    "It cost $5.50 on the 2nd of May, 1984.",
    "Dr. Smith's {HH AH0 L OW1} test: 3 cats & 12 dogs?",
    "Glue the sheet to the dark blue paper.",
]


@pytest.mark.parametrize("sentence", SENTENCES)
@pytest.mark.parametrize("use_phonemes", [False, True])
def test_text_ids_match(sentence, use_phonemes):
    cfg = {"use_phonemes": use_phonemes,
           "text_cleaner": ("phoneme_cleaners" if use_phonemes
                            else "english_cleaners"),
           "phoneme_language": "en-us"}
    want = j_seqvec(sentence, cfg)
    got = t_seqvec(sentence, cfg)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(got) > 0


def test_symbol_tables_match():
    for phonemes in (False, True):
        assert ttext.num_symbols(phonemes) == jtext.num_symbols(phonemes)
    ids = jtext.text_to_sequence("speech on the card", ["english_cleaners"])
    assert (ttext.sequence_to_text(ids)
            == jtext.sequence_to_text(ids))


def test_bucketing_matches():
    for n in (1, 31, 32, 33, 200, 511, 600):
        assert t_bucket(n) == j_bucket(n)


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(ROOT, "configs", "*.json"))))
def test_config_loader_matches(path):
    assert t_load_config(path) == j_load_config(path)


def test_audio_processor_matches():
    cfg = j_load_config(os.path.join(ROOT, "configs",
                                     "glow_tts_ljspeech.json")).audio
    sr = cfg["sample_rate"]
    t = np.arange(sr // 4) / sr
    y = (0.4 * np.sin(2 * np.pi * 220 * t)
         + 0.05 * np.random.default_rng(0).standard_normal(len(t))
         ).astype(np.float32)
    jap, tap = JAudioProcessor(**cfg), TAudioProcessor(**cfg)
    np.testing.assert_array_equal(tap.melspectrogram(y), jap.melspectrogram(y))
    assert t_wav_to_bytes(y, sr) == j_wav_to_bytes(y, sr)
