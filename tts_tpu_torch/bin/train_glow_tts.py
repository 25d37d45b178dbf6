"""Glow-TTS training CLI (≙ tts_tpu/bin/train_glow_tts.py).

    python -m tts_tpu_torch.bin.train_glow_tts --config_path C.json \
        --output_path runs/ [--device cpu]

Trains on CUDA unless ``--device`` names another device. ``--continue_path``
resumes a run folder from its latest checkpoint; ``--restore_path`` starts a
new run folder from a checkpoint.

``--coordinator_address``, ``--num_processes`` and ``--process_id`` make
the process one rank of a ``torch.distributed`` group (``--backend``: NCCL
for CUDA ranks by default, gloo for CPU ranks or where ranks share a card);
``python -m tts_tpu_torch.bin.distribute --script <this module's name>``
starts the ranks. A config with ``use_data_parallel`` then trains
data-parallel; rank 0 alone creates the run folder and writes in it.
"""

from __future__ import annotations

import argparse

from tts_tpu_torch.config import load_config
from tts_tpu_torch.parallel import mesh
from tts_tpu_torch.train.checkpoint import latest_checkpoint
from tts_tpu_torch.train.trainer_glow import GlowTTSTrainer
from tts_tpu_torch.utils.generic import create_experiment_folder


def main(argv=None) -> GlowTTSTrainer:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--restore_path", default="")
    parser.add_argument("--continue_path", default="")
    parser.add_argument("--output_path", default="")
    parser.add_argument("--device", default=None,
                        help="torch device to train on (default: cuda; a "
                        "rank's default: cuda:{rank % device count})")
    mesh.add_arguments(parser)
    args = parser.parse_args(argv)

    device = mesh.initialize_multihost(
        args.coordinator_address, args.num_processes, args.process_id,
        backend=args.backend, device=args.device) or args.device
    c = load_config(args.config_path)
    if args.continue_path:
        output_path = args.continue_path
        restore = latest_checkpoint(output_path)
    else:
        root = args.output_path or c.get("output_path", "runs")
        output_path = mesh.broadcast_object(
            create_experiment_folder(root, c.get("run_name", "glow"))
            if mesh.is_primary() else None)
        restore = args.restore_path or None

    trainer = GlowTTSTrainer(c, output_path, device=device)
    if restore:
        trainer.restore(restore)
    try:
        trainer.fit()
    finally:
        mesh.finalize()
    return trainer


if __name__ == "__main__":
    main()
