"""Speaker-encoder training CLI (≙ tts_tpu/bin/train_encoder.py).

    python -m tts_tpu_torch.bin.train_encoder \
        --config_path configs/speaker_encoder.json --output_path runs/ \
        [--num_steps N] [--device cpu]

Trains on CUDA unless ``--device`` names another device, then writes the
last checkpoint (the encoder and the loss's scale and offset).
"""

from __future__ import annotations

import argparse

from tts_tpu_torch.config import check_config_speaker_encoder, load_config
from tts_tpu_torch.train.trainer_encoder import SpeakerEncoderTrainer
from tts_tpu_torch.utils.generic import create_experiment_folder


def main(argv=None) -> SpeakerEncoderTrainer:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--output_path", default="")
    parser.add_argument("--num_steps", type=int, default=1000000)
    parser.add_argument("--device", default=None,
                        help="torch device to train on (default: cuda)")
    args = parser.parse_args(argv)

    c = load_config(args.config_path)
    check_config_speaker_encoder(c)
    root = args.output_path or c.get("output_path", "runs")
    output_path = create_experiment_folder(root, c.get("run_name", "encoder"))
    trainer = SpeakerEncoderTrainer(c, output_path, device=args.device)
    trainer.train(args.num_steps)
    trainer.save_checkpoint()
    return trainer


if __name__ == "__main__":
    main()
