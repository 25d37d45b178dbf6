"""GAN vocoder trainer (≙ tts_tpu/train/trainer_vocoder.py, on one device).

Alternating generator / discriminator steps (``train/gan.py``), the
discriminator joining after ``steps_to_start_discriminator`` steps, one
optimizer per network (``train/optim.py``: gradient clip + RAdam, no
decay, no schedule). Weights start from ``config["seed"]`` (54321 by
default), and so do the ``torch.Generator`` on the device that draws
ParallelWaveGAN's noise and the one on the host that draws the random
window discriminators' crop offsets. The dataset is built once, so the generator / discriminator item
mapping is reshuffled after every epoch and segment starts keep drawing
from one stream. Checkpoints come in pairs, ``checkpoint_<step>.pt`` (the
generator, which the ``Synthesizer`` serves as its vocoder) and
``checkpoint_disc_<step>.pt``. Resuming from them is not ported yet.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List

import numpy as np
import torch

from tts_tpu_torch import DeviceLike, resolve_device
from tts_tpu_torch.audio import AudioProcessor
from tts_tpu_torch.data.gan_dataset import GANDataset, load_wav_data
from tts_tpu_torch.models.vocoder.registry import (setup_discriminator,
                                                   setup_generator)
from tts_tpu_torch.train import checkpoint as ckpt_io
from tts_tpu_torch.train.gan import GANTrainStep
from tts_tpu_torch.train.optim import make_optimizer
from tts_tpu_torch.utils.generic import KeepAverage, StepTimer
from tts_tpu_torch.utils.loggers import ConsoleLogger, TensorboardLogger

GEN_LOSS_KEYS = ("use_stft_loss", "use_mse_gan_loss", "use_hinge_gan_loss",
                 "use_feat_match_loss", "stft_loss_weight",
                 "subband_stft_loss_weight", "mse_G_loss_weight",
                 "hinge_G_loss_weight", "feat_match_loss_weight")
DISC_LOSS_KEYS = ("use_mse_gan_loss", "use_hinge_gan_loss")


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """A collated numpy batch -> audio (B, 1, T) and mel (B, n_mels,
    frames) on ``device``."""
    return {"audio": torch.from_numpy(batch["audio"]).to(device)
            .transpose(1, 2).contiguous(),
            "mel": torch.from_numpy(batch["mel"]).to(device).transpose(1, 2)
            .contiguous()}


def make_gan_step(c: Dict[str, Any], gen: torch.nn.Module,
                  disc: torch.nn.Module, device: torch.device,
                  mesh=None) -> GANTrainStep:
    """The config's GAN step on ``gen`` and ``disc``: their optimizers, the
    loss switches and weights, the noise (on ``device``) and crop (host)
    generators seeded from ``config["seed"]``, bfloat16 forwards with
    ``mixed_precision``; data-parallel over ``mesh`` where given."""
    seed = c.get("seed", 54321)
    return GANTrainStep(
        gen, disc,
        make_optimizer(gen, lr=c.get("lr_gen", 1e-4),
                       grad_clip=c.get("grad_clip", 10.0)),
        make_optimizer(disc, lr=c.get("lr_disc", 1e-4),
                       grad_clip=c.get("grad_clip", 10.0)),
        hop_len=c["audio"].get("hop_length", 256),
        conv_pad=c.get("conv_pad", 0),
        use_pqmf="multiband" in c["generator_model"].lower(),
        generator=torch.Generator(device).manual_seed(seed),
        crop_generator=torch.Generator().manual_seed(seed),
        gen_loss_kwargs={k: c[k] for k in GEN_LOSS_KEYS if k in c},
        disc_loss_kwargs={k: c[k] for k in DISC_LOSS_KEYS if k in c},
        mixed_precision=c.get("mixed_precision", False), mesh=mesh)


class VocoderTrainer:
    def __init__(self, config: Dict[str, Any], output_path: str,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.c = c = config
        self.output_path = output_path
        os.makedirs(output_path, exist_ok=True)
        self.ap = AudioProcessor(**c["audio"])
        # the eval split is held out of training, as in tts_tpu
        _, self.train_items = load_wav_data(c["data_path"],
                                            c.get("eval_split_size", 10))

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(c.get("seed", 54321))
            gen = setup_generator(c)
            disc = setup_discriminator(c)
        self.gen = gen.to(self.device).train()
        self.disc = disc.to(self.device).train()
        self.step = make_gan_step(c, self.gen, self.disc, self.device)
        self.opt_G, self.opt_D = self.step.opt_G, self.step.opt_D
        self.generator = self.step.generator
        self.crop_generator = self.step.crop_generator
        self.dataset = GANDataset(
            self.ap, self.train_items, seq_len=c.get("seq_len", 8192),
            hop_len=c["audio"].get("hop_length", 256),
            pad_short=c.get("pad_short", 2000),
            conv_pad=c.get("conv_pad", 0))

        self.console = ConsoleLogger()
        self.tb = TensorboardLogger(output_path, "vocoder")
        self.global_step = 0
        self.epoch = 0
        self.best_loss = float("inf")
        self.step_stats: List[Dict[str, float]] = []

    def train_epoch(self) -> Dict[str, float]:
        c = self.c
        keep = KeepAverage()
        warmup = c.get("steps_to_start_discriminator", 0)
        start = time.time()
        timer = StepTimer()
        for batch in self.dataset.batches(c.get("batch_size", 8),
                                          seed=self.epoch):
            loader_time = timer.lap()
            train_disc = self.global_step >= warmup
            losses = self.step(batch_to_device(batch["G"], self.device),
                               batch_to_device(batch["D"], self.device),
                               train_disc)
            keep.update_values({f"avg_{k}": v for k, v in losses.items()})
            self.global_step += 1
            self.tb.tb_train_iter_stats(self.global_step, losses)
            self.step_stats.append(dict(losses, train_disc=train_disc,
                                        step_time=timer.lap(),
                                        loader_time=loader_time))
            if self.global_step % c.get("save_step", 10000) == 0:
                self.save_checkpoint()
        self.dataset.shuffle_mapping()      # re-pair G / D items each epoch
        self.console.print_train_epoch_end(self.global_step, self.epoch,
                                           time.time() - start,
                                           keep.avg_values)
        return keep.avg_values

    def fit(self) -> None:
        for self.epoch in range(self.epoch, self.c["epochs"]):
            self.console.print_epoch_start(self.epoch, self.c["epochs"])
            stats = self.train_epoch()
            self.best_loss = ckpt_io.save_best_model(
                stats.get("avg_G_loss", float("inf")), self.best_loss,
                self.output_path, model=self.gen, optimizer=self.opt_G,
                step=self.global_step, epoch=self.epoch)
        self.save_checkpoint()
        self.tb.close()

    def save_checkpoint(self) -> str:
        """The generator's checkpoint (with the config) and the
        discriminator's, at the current step; returns the generator's
        path."""
        path = ckpt_io.save_checkpoint(
            self.output_path, model=self.gen, optimizer=self.opt_G,
            step=self.global_step, epoch=self.epoch, config=self.c)
        ckpt_io.save_checkpoint(
            self.output_path, model=self.disc, optimizer=self.opt_D,
            step=self.global_step, epoch=self.epoch, prefix="checkpoint_disc")
        return path
