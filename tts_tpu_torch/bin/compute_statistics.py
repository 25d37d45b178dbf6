"""A corpus's mel and linear spectrogram statistics -> ``scale_stats.npy``
(≙ tts_tpu/bin/compute_statistics.py): the per-bin mean and standard
deviation of the unnormalized spectrograms of every item, and the audio
settings they were computed with, as one pickled dict that
``AudioProcessor(stats_path=...)`` reads.

Usage:
  python -m tts_tpu_torch.bin.compute_statistics --config_path c.json \
      --out_path scale_stats.npy

Runs on the host (numpy), as tts_tpu's does: no device is involved.
"""

from __future__ import annotations

import argparse

import numpy as np


def compute_statistics(config: dict, out_path: str,
                       max_items: int = 0) -> dict:
    from tts_tpu_torch.audio import AudioProcessor
    from tts_tpu_torch.data import load_meta_data

    # the statistics are of the unnormalized spectrograms
    audio_cfg = dict(config["audio"])
    audio_cfg.update(signal_norm=False, stats_path=None)
    ap = AudioProcessor(**audio_cfg)
    items, _ = load_meta_data(config["datasets"], eval_split_size=0.0)
    if max_items:
        items = items[:max_items]

    mel_sum = mel_sq = lin_sum = lin_sq = 0.0
    n_frames = 0
    for _, wav_path, _ in items:
        wav = ap.load_wav(wav_path)
        mel = ap.melspectrogram(wav)
        linear = ap.spectrogram(wav)
        mel_sum = mel_sum + mel.sum(axis=0)
        mel_sq = mel_sq + (mel ** 2).sum(axis=0)
        lin_sum = lin_sum + linear.sum(axis=0)
        lin_sq = lin_sq + (linear ** 2).sum(axis=0)
        n_frames += mel.shape[0]

    mel_mean = mel_sum / n_frames
    mel_std = np.sqrt(np.maximum(mel_sq / n_frames - mel_mean ** 2, 1e-8))
    lin_mean = lin_sum / n_frames
    lin_std = np.sqrt(np.maximum(lin_sq / n_frames - lin_mean ** 2, 1e-8))
    stats = {
        "mel_mean": mel_mean.astype(np.float32),
        "mel_std": mel_std.astype(np.float32),
        "linear_mean": lin_mean.astype(np.float32),
        "linear_std": lin_std.astype(np.float32),
        "audio_config": {k: config["audio"][k]
                         for k in ("sample_rate", "num_mels", "fft_size",
                                   "hop_length", "win_length")
                         if k in config["audio"]},
    }
    np.save(out_path, stats, allow_pickle=True)
    return stats


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--out_path", required=True)
    args = parser.parse_args(argv)
    from tts_tpu_torch.config import load_config
    stats = compute_statistics(load_config(args.config_path), args.out_path)
    print(f" > stats saved to {args.out_path}")
    return stats


if __name__ == "__main__":
    main()
