"""GAN vocoder training CLI (≙ tts_tpu/bin/train_vocoder.py, one device).

    python -m tts_tpu_torch.bin.train_vocoder --config_path C.json \
        --output_path runs/ [--device cpu]

Trains on CUDA unless ``--device`` names another device. The config's
``data_path`` is a folder of wavs. Resuming a run is not ported yet.
"""

from __future__ import annotations

import argparse

from tts_tpu_torch.config import load_config
from tts_tpu_torch.train.trainer_vocoder import VocoderTrainer
from tts_tpu_torch.utils.generic import create_experiment_folder


def main(argv=None) -> VocoderTrainer:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--output_path", default="")
    parser.add_argument("--device", default=None,
                        help="torch device to train on (default: cuda)")
    args = parser.parse_args(argv)

    c = load_config(args.config_path)
    root = args.output_path or c.get("output_path", "runs")
    output_path = create_experiment_folder(root, c.get("run_name", "vocoder"))
    trainer = VocoderTrainer(c, output_path, device=args.device)
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
