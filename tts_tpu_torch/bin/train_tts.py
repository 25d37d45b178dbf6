"""Tacotron2 training CLI (≙ tts_tpu/bin/train_tts.py, one device).

    python -m tts_tpu_torch.bin.train_tts --config_path C.json \
        --output_path runs/ [--device cpu]

Trains on CUDA unless ``--device`` names another device. ``--continue_path``
resumes a run folder from its latest checkpoint; ``--restore_path`` starts a
new run folder from a checkpoint. The multi-host flags are not ported yet.
"""

from __future__ import annotations

import argparse

from tts_tpu_torch.config import load_config
from tts_tpu_torch.train.checkpoint import latest_checkpoint
from tts_tpu_torch.train.trainer_tts import TTSTrainer
from tts_tpu_torch.utils.generic import create_experiment_folder


def main(argv=None) -> TTSTrainer:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--restore_path", default="")
    parser.add_argument("--continue_path", default="")
    parser.add_argument("--output_path", default="")
    parser.add_argument("--device", default=None,
                        help="torch device to train on (default: cuda)")
    args = parser.parse_args(argv)

    c = load_config(args.config_path)
    if args.continue_path:
        output_path = args.continue_path
        restore = latest_checkpoint(output_path)
    else:
        root = args.output_path or c.get("output_path", "runs")
        output_path = create_experiment_folder(root,
                                               c.get("run_name", "tacotron2"))
        restore = args.restore_path or None

    trainer = TTSTrainer(c, output_path, device=args.device)
    if restore:
        trainer.restore(restore)
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
