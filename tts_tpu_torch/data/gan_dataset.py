"""GAN vocoder dataset: random (mel, audio-segment) couples
(≙ tts_tpu/data/gan_dataset.py: ``load_wav_data`` and ``GANDataset``, with
its mels computed from the wavs).

Each item is a ``seq_len``-sample audio segment at a random frame-aligned
start with its mel frames, plus ``conv_pad`` edge-replicated context frames
on both sides; audio shorter than ``seq_len + pad_short`` is zero-padded
first. Every batch couples a
generator batch with a discriminator batch of other items
(``G_to_D_mappings``, reshuffled by ``shuffle_mapping``). A thread collates
the next batches while the caller trains. Mels are time-major
(frames, n_mels), as the ``AudioProcessor`` gives them.
"""

from __future__ import annotations

import glob
import os
import random
from typing import Dict, List, Sequence, Tuple

import numpy as np

from tts_tpu_torch.data.prefetch import prefetch
from tts_tpu_torch.data.sampler import shard_indices


def load_wav_data(data_path: str, eval_split_size: int
                  ) -> Tuple[List[str], List[str]]:
    """(eval wavs, train wavs): every wav under ``data_path``, sorted, then
    shuffled with seed 0."""
    wav_paths = sorted(glob.glob(os.path.join(data_path, "**", "*.wav"),
                                 recursive=True))
    random.Random(0).shuffle(wav_paths)
    return wav_paths[:eval_split_size], wav_paths[eval_split_size:]


class GANDataset:
    def __init__(self, ap, items: Sequence[str], *, seq_len: int = 8192,
                 hop_len: int = 256, pad_short: int = 2000,
                 conv_pad: int = 2):
        assert seq_len % hop_len == 0
        self.ap = ap
        self.items = list(items)
        self.seq_len = seq_len
        self.hop_len = hop_len
        self.pad_short = pad_short
        self.conv_pad = conv_pad
        self.feat_frames = seq_len // hop_len
        self._rng = np.random.default_rng(0)
        self.G_to_D_mappings = list(range(len(self.items)))
        self.shuffle_mapping()

    def __len__(self) -> int:
        return len(self.items)

    def shuffle_mapping(self) -> None:
        random.Random(int(self._rng.integers(1 << 30))).shuffle(
            self.G_to_D_mappings)

    def _load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        audio = self.ap.load_wav(self.items[idx])
        if len(audio) < self.seq_len + self.pad_short:
            audio = np.pad(audio, (0, self.seq_len + self.pad_short
                                   - len(audio)))
        mel = self.ap.melspectrogram(audio)
        n_frames = min(mel.shape[0], len(audio) // self.hop_len)
        return (audio[:n_frames * self.hop_len].astype(np.float32),
                mel[:n_frames].astype(np.float32))

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        """{'audio': (seq_len, 1), 'mel': (frames + 2 conv_pad, n_mels)}."""
        audio, mel = self._load(idx)
        max_start = mel.shape[0] - self.feat_frames
        start = int(self._rng.integers(0, max(max_start, 0) + 1))
        mel_seg = mel[start:start + self.feat_frames]
        audio_seg = audio[start * self.hop_len:
                          (start + self.feat_frames) * self.hop_len]
        if self.conv_pad:
            mel_seg = np.pad(mel_seg, ((self.conv_pad, self.conv_pad), (0, 0)),
                             mode="edge")
        return {"audio": audio_seg[:, None], "mel": mel_seg}

    @staticmethod
    def collate(samples: List[Dict]) -> Dict[str, np.ndarray]:
        return {"audio": np.stack([s["audio"] for s in samples]),
                "mel": np.stack([s["mel"] for s in samples])}

    def batches(self, batch_size: int, seed: int = 0, num_shards: int = 1,
                shard_id: int = 0):
        """Yields {'G': batch, 'D': batch} over the items shuffled with
        ``seed``, this shard's stride-slice of them (``shard_indices``, as
        tts_tpu's): the D batch holds the mapped items of the G batch's.
        Whole batches only."""
        idxs = list(range(len(self.items)))
        random.Random(seed).shuffle(idxs)
        idxs = shard_indices(idxs, num_shards, shard_id)
        n_batches = len(idxs) // batch_size
        if n_batches == 0:
            return

        def make_batch(b: int) -> Dict[str, Dict[str, np.ndarray]]:
            sel = idxs[b * batch_size:(b + 1) * batch_size]
            return {"G": self.collate([self[i] for i in sel]),
                    "D": self.collate([self[self.G_to_D_mappings[i]]
                                       for i in sel])}

        yield from prefetch(make_batch, n_batches)
