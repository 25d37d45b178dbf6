"""Speaker-encoder dataset: an endless sampler of N speakers x M utterances
(≙ tts_tpu/data/speaker_dataset.py, a copy on the port's audio processor).

Per batch: speakers drawn without replacement, M utterances each, a
random crop of ``voice_len_seconds`` from each, additive Gaussian noise,
and the mel; a storage queue replays earlier batches with probability
``sample_from_storage_p``. numpy and ``random`` only, seeded, so the same
seed and files draw the same batches as tts_tpu.
"""

from __future__ import annotations

import random
from collections import deque
from typing import Dict, List, Sequence

import numpy as np


class SpeakerEncoderDataset:
    def __init__(
        self,
        ap,
        items: Sequence,  # [text|None, wav_path, speaker_name]
        *,
        voice_len_seconds: float = 1.6,
        num_speakers_in_batch: int = 4,
        num_utters_per_speaker: int = 4,
        skip_speakers: bool = True,
        storage_size: int = 8,
        sample_from_storage_p: float = 0.5,
        additive_noise: float = 1e-5,
        seed: int = 0,
    ):
        self.ap = ap
        self.seq_len = int(voice_len_seconds * ap.sample_rate)
        self.num_speakers_in_batch = num_speakers_in_batch
        self.num_utters_per_speaker = num_utters_per_speaker
        self.additive_noise = additive_noise
        self.sample_from_storage_p = sample_from_storage_p
        self.storage: deque = deque(maxlen=storage_size)
        self._rng = random.Random(seed)
        self._np_rng = np.random.default_rng(seed)

        self.speaker_to_utters: Dict[str, List[str]] = {}
        for it in items:
            self.speaker_to_utters.setdefault(it[2], []).append(it[1])
        if skip_speakers:
            self.speaker_to_utters = {
                k: v for k, v in self.speaker_to_utters.items()
                if len(v) >= num_utters_per_speaker}
        assert len(self.speaker_to_utters) >= num_speakers_in_batch, \
            "not enough speakers with sufficient utterances"
        self.speakers = sorted(self.speaker_to_utters)

    def _load_utter_mel(self, wav_path: str) -> np.ndarray:
        wav = self.ap.load_wav(wav_path)
        if len(wav) < self.seq_len:
            wav = np.pad(wav, (0, self.seq_len - len(wav)))
        offset = self._rng.randint(0, len(wav) - self.seq_len)
        wav = wav[offset: offset + self.seq_len]
        wav = wav + self.additive_noise * self._np_rng.standard_normal(
            len(wav)).astype(np.float32)
        return self.ap.melspectrogram(wav)

    def next_batch(self) -> Dict[str, np.ndarray]:
        """Returns {'mels': (N*M, T, n_mel), 'speaker_names': list}."""
        if (self.storage and
                self._rng.random() < self.sample_from_storage_p):
            batch = self._rng.choice(list(self.storage))
            return batch
        speakers = self._rng.sample(self.speakers, self.num_speakers_in_batch)
        mels, names = [], []
        for spk in speakers:
            utters = self.speaker_to_utters[spk]
            chosen = (self._rng.sample(utters, self.num_utters_per_speaker)
                      if len(utters) >= self.num_utters_per_speaker
                      else [self._rng.choice(utters)
                            for _ in range(self.num_utters_per_speaker)])
            for u in chosen:
                mels.append(self._load_utter_mel(u))
                names.append(spk)
        batch = {"mels": np.stack(mels).astype(np.float32),
                 "speaker_names": names}
        self.storage.append(batch)
        return batch

    def __iter__(self):
        while True:
            yield self.next_batch()
