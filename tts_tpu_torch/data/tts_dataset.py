"""TTS training dataset: phoneme caching, length bucketing, padded collate
(≙ tts_tpu/data/tts_dataset.py, a copy on the port's text frontend and
audio processor).

Capability parity with Mozilla TTS's TTS/tts/datasets/TTSDataset.py:12-288
for what single-device Glow-TTS and Tacotron2 training reads (phoneme .npy
caching l.83-113, length sort l.149-179, collate computing mels in the loader
l.187-288). Batches are padded to *bucketed* (text, frame) shapes (multiples
of ``SHAPE_PAD`` and the reduction factor), numpy and time-major, as in
tts_tpu; the trainer moves them to the device and to (B, C, T). With
``speaker_id_mapping`` (speaker name -> id) a batch carries
``speaker_ids``; with ``speaker_embedding_mapping`` (wav path -> d-vector,
from speakers.json) ``speaker_embeddings``; with ``compute_linear_spec``
(Tacotron v1) ``linear``, the normalized linear spectrogram (B, T_frames,
fft_size / 2 + 1), zero-padded as the mel. A data-parallel rank reads its
stride shard of the items (``num_shards`` / ``shard_id``, as tts_tpu's
Tacotron trainer) or its contiguous slice of every global batch (``part``
/ ``parts``, the rows tts_tpu's ``shard_batch`` gives a device).
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tts_tpu_torch.data.prefetch import prefetch
from tts_tpu_torch.data.sampler import shard_indices
from tts_tpu_torch.text import phoneme_to_sequence, text_to_sequence

SHAPE_PAD = 32      # text and frame lengths are padded to multiples of this


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class TTSDataset:
    def __init__(
        self,
        ap,
        items: Sequence[Sequence],
        *,
        outputs_per_step: int = 1,
        text_cleaner="english_cleaners",
        compute_linear_spec: bool = False,
        min_seq_len: int = 0,
        max_seq_len: int = float("inf"),
        use_phonemes: bool = True,
        phoneme_cache_path: Optional[str] = None,
        phoneme_language: str = "en-us",
        enable_eos_bos: bool = False,
        speaker_id_mapping: Optional[Dict[str, int]] = None,
        speaker_embedding_mapping: Optional[Dict[str, Sequence[float]]]
        = None,
    ):
        self.ap = ap
        self.items = [list(it) for it in items]
        self.r = outputs_per_step
        self.cleaners = text_cleaner
        self.compute_linear_spec = compute_linear_spec
        self.min_seq_len = min_seq_len
        self.max_seq_len = max_seq_len
        self.use_phonemes = use_phonemes
        self.phoneme_cache_path = phoneme_cache_path
        self.phoneme_language = phoneme_language
        self.enable_eos_bos = enable_eos_bos
        self.speaker_id_mapping = speaker_id_mapping
        self.speaker_embedding_mapping = speaker_embedding_mapping
        if phoneme_cache_path:
            os.makedirs(phoneme_cache_path, exist_ok=True)
        self.sort_items()

    # -- text --------------------------------------------------------------

    def _cache_key(self, text: str) -> str:
        return hashlib.md5(text.encode("utf-8")).hexdigest()

    def _load_or_generate_phoneme_sequence(self, text: str) -> np.ndarray:
        """Phoneme-id caching to .npy (≙ TTSDataset.py:83-113)."""
        if self.phoneme_cache_path:
            cache_file = os.path.join(
                self.phoneme_cache_path, self._cache_key(text) + "_phoneme.npy")
            if os.path.isfile(cache_file):
                try:
                    return np.load(cache_file)
                except (ValueError, OSError):
                    pass  # corrupt cache entry -> regenerate
        seq = np.asarray(
            phoneme_to_sequence(
                text, self.cleaners, language=self.phoneme_language,
                enable_eos_bos=self.enable_eos_bos),
            dtype=np.int32)
        if self.phoneme_cache_path:
            np.save(cache_file, seq)
        return seq

    def text_ids(self, text: str) -> np.ndarray:
        if self.use_phonemes:
            return self._load_or_generate_phoneme_sequence(text)
        return np.asarray(
            text_to_sequence(text, self.cleaners), dtype=np.int32)

    # -- ordering ----------------------------------------------------------

    def sort_items(self) -> None:
        """Sort by text length and keep those within [min, max]
        (≙ TTSDataset.py:149-179)."""
        lengths = np.array([len(it[0]) if it[0] else 0 for it in self.items])
        self.items = [self.items[i] for i in np.argsort(lengths)
                      if self.min_seq_len <= lengths[i] <= self.max_seq_len]

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> dict:
        text, wav_file, speaker_name = self.items[idx][:3]
        return {
            "text": self.text_ids(text),
            "wav": self.ap.load_wav(wav_file).astype(np.float32),
            "item_idx": wav_file,
            "speaker_name": speaker_name,
        }

    # -- collate -----------------------------------------------------------

    def collate(self, samples: List[dict]) -> Dict[str, np.ndarray]:
        """Batch samples into padded arrays with bucketed static shapes.

        Returns time-major features: mel (B, T_frames, n_mels), stop
        targets already grouped by r (B, T_frames // r).
        """
        B = len(samples)
        # sort batch desc by text length (keeps parity with the reference's
        # collate ordering so attention masks align with sorted lengths)
        samples = sorted(samples, key=lambda s: len(s["text"]), reverse=True)

        text_lens = np.array([len(s["text"]) for s in samples], dtype=np.int32)
        T_text = _round_up(int(text_lens.max()), SHAPE_PAD)

        mels = [self.ap.melspectrogram(s["wav"]) for s in samples]
        mel_lens = np.array([m.shape[0] for m in mels], dtype=np.int32)
        T_mel = _round_up(_round_up(int(mel_lens.max()), SHAPE_PAD), self.r)

        n_mels = mels[0].shape[1]
        text = np.zeros((B, T_text), dtype=np.int32)
        mel = np.zeros((B, T_mel, n_mels), dtype=np.float32)
        stop = np.zeros((B, T_mel), dtype=np.float32)
        for i, s in enumerate(samples):
            text[i, : text_lens[i]] = s["text"]
            mel[i, : mel_lens[i]] = mels[i]
            # pad frames repeat the last frame so stop prediction sees a
            # held frame (reference pads with zeros then marks stops)
            stop[i, mel_lens[i] - 1:] = 1.0
        # group stop targets by reduction factor: a decoder step stops when
        # any of its r frames is a stop frame (≙ train format_data reshape)
        stop = stop.reshape(B, T_mel // self.r, self.r).max(axis=-1)

        batch = {
            "text": text,
            "text_lengths": text_lens,
            "mel": mel,
            "mel_lengths": mel_lens,
            "stop_targets": stop,
            "item_idxs": [s["item_idx"] for s in samples],
        }
        if self.compute_linear_spec:
            linears = [self.ap.spectrogram(s["wav"]) for s in samples]
            linear = np.zeros((B, T_mel, linears[0].shape[1]), np.float32)
            for i, spec in enumerate(linears):
                linear[i, : spec.shape[0]] = spec
            batch["linear"] = linear
        if self.speaker_id_mapping is not None:
            batch["speaker_ids"] = np.array(
                [self.speaker_id_mapping[s["speaker_name"]] for s in samples],
                dtype=np.int32)
        if self.speaker_embedding_mapping is not None:
            batch["speaker_embeddings"] = np.stack(
                [np.asarray(self.speaker_embedding_mapping[s["item_idx"]],
                            dtype=np.float32) for s in samples])
        return batch

    # -- iteration ---------------------------------------------------------

    def batch_indices(self, batch_size: int, *, shuffle: bool = False,
                      seed: int = 0, num_shards: int = 1,
                      shard_id: int = 0) -> List[List[int]]:
        """The items of each full batch that ``batches`` yields, in order:
        the index list (shuffled with ``seed``), then this shard's
        stride-slice of it (``data/sampler.py::shard_indices``, as
        tts_tpu's), cut into batches of ``batch_size``."""
        idxs = list(range(len(self.items)))
        if shuffle:
            # an explicit generator seeded with ``seed`` (tts_tpu shuffles
            # with random.Random(seed): same seeding, another permutation)
            g = torch.Generator().manual_seed(seed)
            idxs = torch.randperm(len(idxs), generator=g).tolist()
        idxs = shard_indices(idxs, num_shards, shard_id)
        return [idxs[b * batch_size: (b + 1) * batch_size]
                for b in range(len(idxs) // batch_size)]

    def part_of_batch(self, sel: Sequence[int], part: int,
                      parts: int) -> List[int]:
        """The ``part``-th of ``parts`` contiguous slices of the batch of
        items ``sel`` in the order ``collate`` puts them (text length
        descending, ties in ``sel``'s order): the rows that tts_tpu's
        ``shard_batch`` hands a device of the data axis. Only the texts are
        read to order them."""
        if len(sel) % parts:
            raise ValueError(f"a batch of {len(sel)} does not split into "
                             f"{parts} equal parts")
        order = sorted(sel, key=lambda i: len(self.text_ids(self.items[i][0])),
                       reverse=True)
        n = len(sel) // parts
        return order[part * n: (part + 1) * n]

    def batches(self, batch_size: int, *, shuffle: bool = False,
                seed: int = 0, num_shards: int = 1, shard_id: int = 0,
                part: int = 0, parts: int = 1):
        """Yield the full batches of ``batch_indices``, collated by a
        background thread. With ``parts`` > 1 each is only its ``part``-th
        contiguous slice (``part_of_batch``), and only that slice's
        features are computed.

        The DataLoader-worker equivalent: one producer thread computes
        features (STFT on host) while the consumer feeds the device.
        """
        sels = self.batch_indices(batch_size, shuffle=shuffle, seed=seed,
                                  num_shards=num_shards, shard_id=shard_id)
        if parts > 1 and batch_size % parts:
            raise ValueError(f"batch size {batch_size} does not split into "
                             f"{parts} equal parts")

        def make_batch(b: int) -> Dict[str, np.ndarray]:
            sel = sels[b]
            if parts > 1:
                sel = self.part_of_batch(sel, part, parts)
            return self.collate([self[i] for i in sel])

        yield from prefetch(make_batch, len(sels))
