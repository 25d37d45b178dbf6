"""Glow-TTS trainer (≙ tts_tpu/train/trainer_glow.py, on one device).

Data-dependent ActNorm init on the first batch, then per batch: forward
(with monotonic alignment search, the CUDA kernel on the card), MLE +
duration loss, backward and the optimizer step (``train_step``). Weights
start from ``config["seed"]`` (54321 by default); dropout masks and the DDI
pass draw from the trainer's ``torch.Generator`` on its device; each
epoch's shuffle is seeded with the epoch number, as in tts_tpu.
With ``use_speaker_embedding`` the model learns one embedding per speaker
of the training split (sorted names -> ids), as tts_tpu's trainer does;
the batches carry ``speaker_ids``.

With ``use_data_parallel`` in a process group (``bin/distribute.py``) the
step is ``parallel.make_glow_dp_train_step``: each rank trains on the r-th
contiguous slice of every global batch of ``batch_size`` (the rows
tts_tpu's ``shard_batch`` gives device r), and its loader collates only
that slice. ActNorm's data-dependent init runs on the first global batch,
collated whole, and rank 0's parameters are then broadcast, so every rank
starts from the same init (as tts_tpu's init before replication). Rank 0
alone prints, logs and writes checkpoints.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from tts_tpu_torch import DeviceLike, resolve_device
from tts_tpu_torch.audio import AudioProcessor
from tts_tpu_torch.data import TTSDataset, load_meta_data
from tts_tpu_torch.data.formatters import get_speakers
from tts_tpu_torch.models.glow_tts import GlowTTS, apply_ddi, glow_tts_loss
from tts_tpu_torch.models.registry import setup_model
from tts_tpu_torch.parallel.data_parallel import rank_seed, replicate
from tts_tpu_torch.parallel.mesh import data_mesh, is_primary, rank_and_world
from tts_tpu_torch.text import num_symbols
from tts_tpu_torch.train import checkpoint as ckpt_io
from tts_tpu_torch.train.optim import RAdamW, make_optimizer
from tts_tpu_torch.utils.generic import KeepAverage, StepTimer
from tts_tpu_torch.utils.loggers import (ConsoleLogger, NullLogger,
                                        TensorboardLogger)


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """A collated numpy batch (time-major mel) -> tensors on ``device``,
    mel in (B, C, T); ``speaker_ids`` and ``speaker_embeddings`` where the
    batch has them."""
    out = {
        "text": torch.from_numpy(batch["text"]).long().to(device),
        "text_lengths": torch.from_numpy(batch["text_lengths"]).to(device),
        "mel": torch.from_numpy(batch["mel"]).to(device).transpose(1, 2)
        .contiguous(),
        "mel_lengths": torch.from_numpy(batch["mel_lengths"]).to(device),
    }
    for key in ("speaker_ids", "speaker_embeddings"):
        if key in batch:
            out[key] = torch.from_numpy(batch[key]).to(device)
    return out


def train_step(model: GlowTTS, optimizer: RAdamW,
               batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Forward, loss, backward and one optimizer step on a device batch, in
    the model's current mode. Returns the losses before the update."""
    optimizer.zero_grad()
    out = model(batch["text"], batch["text_lengths"], batch["mel"],
                batch["mel_lengths"], batch.get("speaker_ids"),
                batch.get("speaker_embeddings"))
    losses = glow_tts_loss(out, batch["text_lengths"])
    losses["loss"].backward()
    optimizer.step()
    values = torch.stack([v.detach() for v in losses.values()]).tolist()
    return dict(zip(losses.keys(), values))


class GlowTTSTrainer:
    def __init__(self, config: Dict[str, Any], output_path: str,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.mesh = data_mesh(config)
        self.rank, self.world = (rank_and_world() if self.mesh is not None
                                 else (0, 1))
        self.primary = is_primary()
        if config.get("batch_size", 32) % self.world:
            raise ValueError(f"batch_size {config.get('batch_size', 32)} "
                             f"does not split over {self.world} ranks")
        self.c = config
        self.output_path = output_path
        os.makedirs(output_path, exist_ok=True)
        self.ap = AudioProcessor(**config["audio"])
        # the eval split is held out of training, as in tts_tpu
        self.meta_train, _ = load_meta_data(config["datasets"])
        self.num_speakers = 1
        self.speaker_mapping = None
        if config.get("use_speaker_embedding", False):
            speakers = get_speakers(self.meta_train)
            self.speaker_mapping = {s: i for i, s in enumerate(speakers)}
            self.num_speakers = len(speakers)

        seed = config.get("seed", 54321)
        num_chars = num_symbols(config.get("use_phonemes", False))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = setup_model(num_chars, self.num_speakers, config)
        self.model = model.to(self.device)
        self.generator = torch.Generator(self.device).manual_seed(
            seed if self.mesh is None else rank_seed(seed, self.rank))
        self.model.set_generator(self.generator)
        self._dp_step = None
        if self.mesh is not None:
            replicate(self.model, self.mesh)
        self.optimizer = make_optimizer(
            self.model,
            lr=config.get("lr", 1e-3),
            grad_clip=config.get("grad_clip", 5.0),
            weight_decay=config.get("wd", 0.0),
            use_noam=config.get("noam_schedule", True),
            warmup_steps=config.get("warmup_steps", 4000))

        self.console = ConsoleLogger() if self.primary else NullLogger()
        self.tb = (TensorboardLogger(output_path, "glow_tts")
                   if self.primary else NullLogger())
        self.global_step = 0
        self.epoch = 0
        self.best_loss = float("inf")
        self.initialized = False        # DDI done (or weights restored)
        self.step_stats: List[Dict[str, float]] = []
        c = config
        self.dataset = TTSDataset(
            self.ap, self.meta_train,
            outputs_per_step=self.model.num_sqz,
            text_cleaner=c.get("text_cleaner", "english_cleaners"),
            use_phonemes=c.get("use_phonemes", False),
            phoneme_cache_path=c.get("phoneme_cache_path"),
            phoneme_language=c.get("phoneme_language", "en-us"),
            enable_eos_bos=c.get("enable_eos_bos_chars", False),
            speaker_id_mapping=self.speaker_mapping,
            min_seq_len=c.get("min_seq_len", 0),
            max_seq_len=c.get("max_seq_len", float("inf")))

    def train_epoch(self) -> Dict[str, float]:
        c = self.c
        ds = self.dataset
        keep = KeepAverage()
        self.model.train()
        start = time.time()
        timer = StepTimer()
        bs = c.get("batch_size", 32)
        for batch in ds.batches(bs, shuffle=True, seed=self.epoch,
                                part=self.rank, parts=self.world):
            loader_time = timer.lap()
            db = batch_to_device(batch, self.device)
            if not self.initialized:
                self.data_dependent_init(db)
            losses = self.step(db)
            losses["step_time"] = timer.lap()
            losses["loader_time"] = loader_time
            keep.update_values({f"avg_{k}": v for k, v in losses.items()})
            self.step_stats.append(losses)
            self.global_step += 1
            self.tb.tb_train_iter_stats(self.global_step, losses)
            if self.global_step % c.get("save_step", 10000) == 0:
                self.save_checkpoint()
        self.console.print_train_epoch_end(self.global_step, self.epoch,
                                           time.time() - start,
                                           keep.avg_values)
        return keep.avg_values

    def data_dependent_init(self, batch: Dict[str, torch.Tensor]) -> None:
        """ActNorm's data-dependent init on the first batch; data-parallel,
        on the first global batch collated whole, then rank 0's parameters
        on every rank."""
        if self.mesh is not None:
            ds = self.dataset
            sel = ds.batch_indices(self.c.get("batch_size", 32),
                                   shuffle=True, seed=self.epoch)[0]
            batch = batch_to_device(ds.collate([ds[i] for i in sel]),
                                    self.device)
        apply_ddi(self.model, batch)
        if self.mesh is not None:
            replicate(self.model, self.mesh)
        self.initialized = True

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        if self.mesh is None:
            return train_step(self.model, self.optimizer, batch)
        if self._dp_step is None:
            from tts_tpu_torch.parallel import make_glow_dp_train_step
            self._dp_step = make_glow_dp_train_step(
                self.model, self.optimizer, self.mesh,
                generator=self.generator)
        return self._dp_step(batch)

    def fit(self) -> None:
        for self.epoch in range(self.epoch, self.c["epochs"]):
            self.console.print_epoch_start(self.epoch, self.c["epochs"])
            stats = self.train_epoch()
            if not self.primary:
                continue
            self.best_loss = ckpt_io.save_best_model(
                stats.get("avg_loss", float("inf")), self.best_loss,
                self.output_path, model=self.model, optimizer=self.optimizer,
                step=self.global_step, epoch=self.epoch)
        if self.c.get("checkpoint", True):
            self.save_checkpoint()
        self.tb.close()

    def save_checkpoint(self) -> Optional[str]:
        """Rank 0 writes; with a process group every rank waits for it."""
        return ckpt_io.save_checkpoint_multihost(
            self.output_path, model=self.model, optimizer=self.optimizer,
            step=self.global_step, epoch=self.epoch, config=self.c)

    def restore(self, path: str) -> None:
        ckpt = ckpt_io.load_checkpoint(path)
        self.model.load_state_dict(ckpt["model"])
        if ckpt.get("optimizer") is not None:
            self.optimizer.load_state_dict(ckpt["optimizer"])
        self.global_step = ckpt.get("step", 0)
        self.epoch = ckpt.get("epoch", 0)
        self.initialized = True
